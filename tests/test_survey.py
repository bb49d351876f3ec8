"""Survey mode: scene-batched likelihood + per-scene SVI/HMC adaptation.

The survey drivers fit S independent systems in single device programs
(gigalens_tpu/inference/survey.py — beyond the reference, which fits one
system per process). These tests check (a) the scene-batched likelihood is
exactly the per-scene single-model likelihood, (b) the grouped HMC sampler
adapts per group and recovers per-group posteriors, and (c) the end-to-end
survey pipeline recovers both scenes' truths on a tiny two-scene problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference.hmc import sample_hmc
from gigalens_tpu.inference.survey import SurveySequence
from gigalens_tpu.model import ForwardProbModel, SurveyForwardProbModel
from gigalens_tpu.simulator import LensSimulator
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.profiles.mass.sie import SIE
from gigalens_tpu.prob import Prior
from gigalens_tpu.prob import distributions as gld


@pytest.fixture(scope="module")
def survey_setup():
    prior = Prior(
        dict(
            lens_mass=[
                dict(
                    theta_E=gld.LogNormal(jnp.log(1.0), 0.15),
                    e1=gld.Normal(0, 0.05),
                    e2=gld.Normal(0, 0.05),
                    center_x=gld.Normal(0, 0.05),
                    center_y=gld.Normal(0, 0.05),
                ),
                dict(gamma1=gld.Normal(0, 0.03), gamma2=gld.Normal(0, 0.03)),
            ],
            source_light=[
                dict(
                    R_sersic=gld.LogNormal(jnp.log(0.3), 0.15),
                    n_sersic=gld.Uniform(1, 3),
                    e1=gld.Normal(0, 0.1),
                    e2=gld.Normal(0, 0.1),
                    center_x=gld.Normal(0, 0.1),
                    center_y=gld.Normal(0, 0.1),
                    Ie=gld.LogNormal(jnp.log(100.0), 0.3),
                )
            ],
        )
    )
    phys = PhysicalModel([SIE(), Shear()], [], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=0.12, num_pix=24, supersample=1)
    truths = prior.sample(jax.random.PRNGKey(7), 2)  # two scenes
    sim2 = LensSimulator(phys, cfg, bs=2)
    imgs = np.asarray(jax.jit(sim2.simulate)(truths))
    rng = np.random.default_rng(0)
    bkg, exp_t = 0.1, 200.0
    obs = imgs + rng.normal(size=imgs.shape).astype(np.float32) * np.sqrt(
        bkg**2 + np.clip(imgs, 0, None) / exp_t
    )
    return prior, phys, cfg, truths, obs, bkg, exp_t


def test_survey_stats_match_single_scene(survey_setup):
    """Scene-batched stats == per-scene ForwardProbModel stats, row by row."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    K = 3
    z = prior.unconstrain(prior.sample(jax.random.PRNGKey(1), 2 * K))
    sim = LensSimulator(phys, cfg, bs=2 * K)
    lp_srv, chi_srv = jax.jit(lambda z: spm.log_prob(sim, z))(z)

    sim_k = LensSimulator(phys, cfg, bs=K)
    for s in range(2):
        pm = ForwardProbModel(prior, obs[s], background_rms=bkg, exp_time=exp_t)
        lp_one, chi_one = jax.jit(lambda z: pm.log_prob(sim_k, z))(
            z[s * K : (s + 1) * K]
        )
        np.testing.assert_allclose(
            np.asarray(lp_srv[s * K : (s + 1) * K]), np.asarray(lp_one),
            rtol=1e-6, atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(chi_srv[s * K : (s + 1) * K]), np.asarray(chi_one),
            rtol=1e-6,
        )


def test_survey_per_scene_error_arrays(survey_setup):
    """Per-scene background_rms/exp_time vectors broadcast correctly."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    bkgs, exps = np.asarray([0.1, 0.3]), np.asarray([200.0, 50.0])
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkgs, exp_time=exps)
    K = 2
    z = prior.unconstrain(prior.sample(jax.random.PRNGKey(2), 2 * K))
    sim = LensSimulator(phys, cfg, bs=2 * K)
    lp, chi = jax.jit(lambda z: spm.log_prob(sim, z))(z)
    sim_k = LensSimulator(phys, cfg, bs=K)
    for s in range(2):
        pm = ForwardProbModel(
            prior, obs[s], background_rms=float(bkgs[s]), exp_time=float(exps[s])
        )
        lp_one, _ = jax.jit(lambda z: pm.log_prob(sim_k, z))(z[s * K : (s + 1) * K])
        np.testing.assert_allclose(
            np.asarray(lp[s * K : (s + 1) * K]), np.asarray(lp_one),
            rtol=1e-6, atol=1e-4,
        )


def test_survey_laplace_matches_single_scene(survey_setup):
    """laplace_scale_trils (one scene-batched FD program) == per-scene
    laplace_scale_tril(method='fd')."""
    from gigalens_tpu.inference import ModellingSequence

    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    seq = SurveySequence(phys, spm, cfg)
    z_best = prior.unconstrain(prior.sample(jax.random.PRNGKey(3), 2))
    Ls = seq.laplace_scale_trils(z_best)
    assert Ls.shape == (2, prior.d, prior.d)
    for s in range(2):
        pm = ForwardProbModel(prior, obs[s], background_rms=bkg, exp_time=exp_t)
        one = ModellingSequence(phys, pm, cfg)
        L1 = one.laplace_scale_tril(z_best[s][None], method="fd")
        # rtol for the curvature scales; atol absorbs FD noise on near-zero
        # off-diagonal elements (observed ~2e-5 on otherwise exact factors)
        np.testing.assert_allclose(Ls[s], L1, rtol=2e-2, atol=1e-4)


def test_grouped_hmc_per_group_adaptation():
    """sample_hmc(n_groups=2) adapts each group to its own geometry and
    recovers per-group Gaussian posteriors (scales 30x apart)."""
    d, C = 3, 16
    scales_g = jnp.asarray([0.1, 3.0])

    def log_prob(z):
        s = jnp.repeat(scales_g, C)[:, None]
        return -0.5 * jnp.sum((z / s) ** 2, -1)

    z0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (2 * C, d))
    tril = jnp.stack([jnp.eye(d) * 0.1, jnp.eye(d) * 3.0])
    res = sample_hmc(
        log_prob, z0, jax.random.PRNGKey(1), step_size=0.2,
        num_leapfrog_steps=3, num_burnin_steps=200, num_results=400,
        momentum_covariance_tril=tril, trajectory_adaptation="chees",
        mass_adaptation=True, n_groups=2,
    )
    assert res.step_size.shape == (2,)
    assert res.trajectory_length.shape == (2,)
    assert res.divergences.shape == (2 * C,)
    s = np.asarray(res.samples)
    np.testing.assert_allclose(s[:, :C].reshape(-1, d).std(0), 0.1, rtol=0.2)
    np.testing.assert_allclose(s[:, C:].reshape(-1, d).std(0), 3.0, rtol=0.2)
    assert int(np.asarray(res.divergences).sum()) == 0


def test_survey_pipeline_recovers_truths(survey_setup):
    """Tiny 2-scene survey: MAP -> per-scene SVI -> grouped HMC; each scene's
    posterior concentrates near its own truth."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    seq = SurveySequence(phys, spm, cfg)

    sched = optax.polynomial_schedule(-5e-3, -1e-3, 1.0, 200)
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    z = seq.MAP(opt, n_starts=16, num_steps=200, seed=0)
    assert z.shape[0] == 2 * 16
    best = seq.best_per_scene(z)
    assert best.shape == (2, prior.d)

    means, trils, losses = seq.SVI(
        best, optax.adam(2e-3), n_vi=8, num_steps=60, init_scales=1e-2, seed=1
    )
    assert means.shape == (2, prior.d) and trils.shape == (2, prior.d, prior.d)
    assert losses.shape == (60, 2)
    assert np.isfinite(np.asarray(losses)).all()

    res = seq.HMC(
        means, trils, n_hmc=8, num_burnin_steps=60, num_results=100, seed=2
    )
    assert res.samples.shape == (100, 16, prior.d)
    assert res.step_size.shape == (2,)
    per_scene = seq.scene_samples(res)
    assert per_scene.shape == (2, 100 * 8, prior.d)

    # per-scene named summaries: one dict per scene with its own global block
    sums = seq.summarize(res)
    assert len(sums) == 2
    for s_dict in sums:
        assert "lens_mass/0/theta_E" in s_dict
        assert "max_rhat" in s_dict["_global"]
        assert "divergences" in s_dict["_global"]

    assert np.isfinite(np.asarray(per_scene)).all()
    # physical acceptance: each scene's posterior-mean parameters reproduce
    # that scene's data at reduced chi2 near 1, and NOT the other scene's
    # (scene identification under the scene-major contract)
    post_means = jnp.stack([per_scene[s].mean(0) for s in range(2)])  # (2, d)
    sim2 = LensSimulator(phys, cfg, bs=2)
    _, chi2_own = jax.jit(lambda z: spm.log_prob(sim2, z))(post_means)
    _, chi2_swap = jax.jit(lambda z: spm.log_prob(sim2, z))(post_means[::-1])
    chi2_own = np.asarray(chi2_own)
    chi2_swap = np.asarray(chi2_swap)
    assert (chi2_own < 1.5).all(), chi2_own
    assert (chi2_swap > 5 * chi2_own[::-1]).all(), (chi2_own, chi2_swap)


def test_survey_sharded_matches_single_device(survey_setup):
    """Survey MAP + grouped HMC on the 8-device mesh == 1-device mesh (same
    seeds); the scene-major flat batch shards like any sample axis."""
    from gigalens_tpu.parallel import default_mesh

    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    mesh8 = default_mesh()
    mesh1 = default_mesh(jax.devices()[:1])

    import optax

    res = {}
    for name, mesh in [("m8", mesh8), ("m1", mesh1)]:
        seq = SurveySequence(phys, spm, cfg, mesh=mesh)
        z = seq.MAP(optax.adam(1e-3), n_starts=8, num_steps=4, seed=0)
        best = seq.best_per_scene(z)
        means, trils, _ = seq.SVI(best, optax.adam(1e-3), n_vi=8, num_steps=3,
                                  init_scales=1e-2, seed=1)
        r = seq.HMC(means, trils, n_hmc=8, num_burnin_steps=4, num_results=4,
                    seed=2)
        res[name] = (np.asarray(z), np.asarray(means), np.asarray(r.samples),
                     np.asarray(r.step_size))
    for a, b in zip(res["m8"], res["m1"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_survey_error_map_validation(survey_setup):
    """A shared (H, W) error map broadcasts to all scenes; mismatched shapes
    raise (review finding: error_map[:, None] on a 2-D map silently
    mis-broadcast)."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    em = np.full(obs.shape[1:], 0.2, np.float32)
    spm = SurveyForwardProbModel(prior, obs, error_map=em)
    assert spm.error_map.shape == obs.shape
    K = 2
    z = prior.unconstrain(prior.sample(jax.random.PRNGKey(4), 2 * K))
    sim = LensSimulator(phys, cfg, bs=2 * K)
    lp, _ = jax.jit(lambda z: spm.log_prob(sim, z))(z)
    pm = ForwardProbModel(prior, obs[0], error_map=em)
    sim_k = LensSimulator(phys, cfg, bs=K)
    lp_one, _ = jax.jit(lambda z: pm.log_prob(sim_k, z))(z[:K])
    np.testing.assert_allclose(np.asarray(lp[:K]), np.asarray(lp_one),
                               rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="error_map"):
        SurveyForwardProbModel(prior, obs, error_map=em[:10])


def test_survey_svi_init_scales_shapes(survey_setup):
    """(S, d) per-scene diagonals accepted; bad 2-D shapes raise; S == d
    full-matrix ambiguity raises (review finding: silent garbage init)."""
    from gigalens_tpu.inference.svi import fit_svi_survey

    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    d = prior.d
    starts = prior.unconstrain(prior.sample(jax.random.PRNGKey(5), 2))
    sim = LensSimulator(phys, cfg, bs=2 * 8)
    diag = np.full((2, d), 0.05, np.float32)
    means, trils, _ = fit_svi_survey(spm, sim, starts, optax.adam(0.0),
                                     n_vi=8, num_steps=2, init_scales=diag)
    np.testing.assert_allclose(
        np.asarray(jax.vmap(jnp.diagonal)(trils)), 0.05, rtol=1e-3
    )
    with pytest.raises(ValueError, match="2-D init_scales"):
        fit_svi_survey(spm, sim, starts, optax.adam(0.0), n_vi=8,
                       num_steps=1, init_scales=np.ones((3, d + 1)))
    # S == d ambiguity: build a fake (d, d) with S == d scenes
    starts_d = prior.unconstrain(prior.sample(jax.random.PRNGKey(6), d))
    sim_d = LensSimulator(phys, cfg, bs=d * 8)
    with pytest.raises(ValueError, match="ambiguous"):
        fit_svi_survey(spm, sim_d, starts_d, optax.adam(0.0), n_vi=8,
                       num_steps=1, init_scales=np.eye(d, dtype=np.float32))


def test_checkpoint_roundtrips_divergences(tmp_path):
    """HMCResult.divergences survives save/load (review finding: dropped
    field reset to the 0-d default on resume)."""
    from gigalens_tpu.inference.hmc import HMCResult
    from gigalens_tpu.utils.checkpoint import load_hmc, save_hmc

    res = HMCResult(jnp.ones((5, 4, 3)), jnp.zeros(7), jnp.float32(0.1),
                    jnp.ones((4, 3)), jnp.float32(0.5),
                    jnp.asarray([0, 3, 0, 1], jnp.int32))
    p = str(tmp_path / "hmc.npz")
    save_hmc(p, res)
    back = load_hmc(p)
    np.testing.assert_array_equal(np.asarray(back.divergences), [0, 3, 0, 1])


class _DuckSurveyModel:
    """Scene-major duck model for the SMC adapter: 2 scenes, conjugate
    Gaussian likelihoods with different means (scene 0: N(1, 0.5^2)/dim,
    scene 1: N(-2, 0.5^2)/dim), prior N(0, 1)/dim."""

    n_scenes = 2
    include_pixels = True
    include_positions = False

    class _P:
        d = 2

        def log_prob_z(self, z):
            return -0.5 * jnp.sum(z**2, -1)

        def constrain(self, z):
            return z

        def unconstrain(self, x):
            return x

        def sample(self, key, shape):
            if isinstance(shape, int):
                shape = (shape,)
            return jax.random.normal(key, (*shape, self.d))

    prior = _P()

    def stats_pixels(self, sim, x):
        n = x.shape[0]
        K = n // 2
        mu = jnp.concatenate([jnp.full((K,), 1.0), jnp.full((K,), -2.0)])
        ll = jnp.sum(-0.5 * ((x - mu[:, None]) / 0.5) ** 2, -1)
        return ll, ll


def test_survey_smc_per_scene_posteriors_and_evidence():
    """One SMC ensemble per scene: the adapter's row permutation delivers
    each scene its own posterior (means +0.8 / -1.6) and per-scene
    log-evidence matching the conjugate analytics."""
    from gigalens_tpu.inference.smc import fit_smc
    from gigalens_tpu.inference.survey import _SceneEnsembleAdapter

    duck = _DuckSurveyModel()
    P = 400
    res = fit_smc(
        _SceneEnsembleAdapter(duck, P), simulator=None,
        num_particles=P, num_ensembles=2, num_leapfrog_steps=5,
        post_sampling_steps=0, max_stage=50, target="pixels",
        auxiliar="none", seed=0,
    )
    assert float(res.final_beta.min()) == 1.0
    parts = np.asarray(res.particles)  # (P, 2, d)
    # posterior: var = 0.2; mean = 0.2/0.25 * mu = 0.8 * mu
    np.testing.assert_allclose(parts[:, 0].mean(0), [0.8] * 2, atol=0.1)
    np.testing.assert_allclose(parts[:, 1].mean(0), [-1.6] * 2, atol=0.1)
    np.testing.assert_allclose(parts.var(0), 0.2, atol=0.08)
    # per-scene evidence: d * (0.5 log(0.25/1.25) - mu^2 / (2 * 1.25))
    lz_true = [2 * (0.5 * np.log(0.2) - 1.0 / 2.5),
               2 * (0.5 * np.log(0.2) - 4.0 / 2.5)]
    np.testing.assert_allclose(np.asarray(res.log_evidence), lz_true, atol=0.25)


def test_survey_smc_real_model_smoke(survey_setup):
    """SurveySequence.SMC advances per-scene temperatures on the real stack;
    MAP-start subsampling keeps scenes separated."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    seq = SurveySequence(phys, spm, cfg)
    z = seq.MAP(optax.adam(5e-3), n_starts=8, num_steps=30, seed=0)
    res = seq.SMC(start=z, num_particles=16, num_leapfrog_steps=2,
                  post_sampling_steps=2, max_stage=3, seed=0)
    assert res.particles.shape[1:] == (2, prior.d)
    assert np.isfinite(np.asarray(res.particles)).all()
    assert res.final_beta.shape == (2,)
    assert (np.asarray(res.final_beta) > 0).all()


def test_survey_smc_start_subsampling_no_replacement_crash(survey_setup):
    """K == P per scene (replace=False path) must subsample per scene, not
    crash on a flattened S*P no-replacement draw (review regression); and
    post_samples come back scene-major."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    seq = SurveySequence(phys, spm, cfg)
    K = P = 16
    z = prior.unconstrain(prior.sample(jax.random.PRNGKey(8), 2 * K))
    res = seq.SMC(start=z, num_particles=P, num_leapfrog_steps=1,
                  post_sampling_steps=2, max_stage=1, seed=0)
    assert res.particles.shape == (P, 2, prior.d)
    assert res.post_samples.shape == (2, 2 * P, prior.d)
    # scene-major post rows: scene s's block must track scene s's particles.
    # With max_stage=1 and 1-leapfrog moves, post draws stay in the start
    # cloud of their own scene — compare block means against the per-scene
    # particle means (scenes have well-separated parameter draws)
    post = np.asarray(res.post_samples[-1]).reshape(2, P, prior.d)
    parts = np.asarray(res.particles)  # (P, 2, d)
    for s in range(2):
        d_own = np.linalg.norm(post[s].mean(0) - parts[:, s].mean(0))
        d_other = np.linalg.norm(post[s].mean(0) - parts[:, 1 - s].mean(0))
        assert d_own < d_other, (s, d_own, d_other)


def test_survey_positions_match_single_scene(survey_setup):
    """Per-scene padded+masked position stats == single-scene
    ForwardProbModel.stats_positions, for scenes with DIFFERENT image
    counts (3 and 4)."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    cx = [np.asarray([0.9, -0.8, 0.1], np.float32),
          np.asarray([1.0, -0.9, 0.2, -0.3], np.float32)]
    cy = [np.asarray([-0.7, 0.8, 1.0], np.float32),
          np.asarray([0.6, -0.8, -1.1, 0.9], np.float32)]
    cex = [np.full(3, 0.05, np.float32), np.full(4, 0.08, np.float32)]
    cey = [np.full(3, 0.06, np.float32), np.full(4, 0.07, np.float32)]

    spm = SurveyForwardProbModel(
        prior, obs, background_rms=bkg, exp_time=exp_t,
        centroids_x=cx, centroids_y=cy,
        centroids_errors_x=cex, centroids_errors_y=cey,
    )
    assert spm.include_positions
    K = 3
    z = prior.unconstrain(prior.sample(jax.random.PRNGKey(9), 2 * K))
    x = prior.constrain(z)
    sim = LensSimulator(phys, cfg, bs=2 * K)
    ll, chi = jax.jit(lambda x: spm.stats_positions(sim, x))(x)

    sim_k = LensSimulator(phys, cfg, bs=K)
    for s in range(2):
        pm = ForwardProbModel(
            prior, obs[s], background_rms=bkg, exp_time=exp_t,
            centroids_x=[cx[s]], centroids_y=[cy[s]],
            centroids_errors_x=[cex[s]], centroids_errors_y=[cey[s]],
        )
        xs = prior.constrain(z[s * K : (s + 1) * K])
        ll_one, chi_one = jax.jit(lambda x: pm.stats_positions(sim_k, x))(xs)
        np.testing.assert_allclose(
            np.asarray(ll[s * K : (s + 1) * K]), np.asarray(ll_one),
            rtol=1e-4, atol=1e-3,
        )
        np.testing.assert_allclose(
            np.asarray(chi[s * K : (s + 1) * K]), np.asarray(chi_one),
            rtol=1e-4, atol=1e-5,
        )
    # full log_prob combines pixels + positions without shape errors
    lp, rc = jax.jit(lambda z: spm.log_prob(sim, z))(z)
    assert np.isfinite(np.asarray(lp)).all()


def test_survey_smc_combined_target_with_positions(survey_setup):
    """Survey SMC with target='pixels+positions' runs on a positions-enabled
    survey model (adapter delegates both terms)."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    cx = [np.asarray([0.9, -0.8], np.float32), np.asarray([1.0, -0.9, 0.2], np.float32)]
    cy = [np.asarray([-0.7, 0.8], np.float32), np.asarray([0.6, -0.8, -1.1], np.float32)]
    ce = [np.full(2, 0.3, np.float32), np.full(3, 0.3, np.float32)]
    spm = SurveyForwardProbModel(
        prior, obs, background_rms=bkg, exp_time=exp_t,
        centroids_x=cx, centroids_y=cy,
        centroids_errors_x=ce, centroids_errors_y=ce,
    )
    seq = SurveySequence(phys, spm, cfg)
    z = seq.MAP(optax.adam(5e-3), n_starts=8, num_steps=20, seed=0)
    res = seq.SMC(start=z, num_particles=8, num_leapfrog_steps=1,
                  post_sampling_steps=0, max_stage=2, seed=0,
                  target="pixels+positions")
    assert np.isfinite(np.asarray(res.particles)).all()
    assert (np.asarray(res.final_beta) > 0).all()


def test_survey_importance_evidence_conjugate():
    """Per-scene IS evidence with exact per-scene surrogates matches the
    conjugate analytics of the duck survey model (distinct per scene)."""
    from gigalens_tpu.inference.svi import importance_evidence_survey

    duck = _DuckSurveyModel()

    class _PM(_DuckSurveyModel):
        def log_prob(self, sim, z):
            ll, _ = self.stats_pixels(sim, z)
            lp = -0.5 * jnp.sum(z**2, -1) - 1.0 * jnp.log(2 * jnp.pi)
            return ll + lp, ll

    # exact per-scene posteriors: N(0.8, 0.2) and N(-1.6, 0.2) per dim
    means = jnp.asarray([[0.8, 0.8], [-1.6, -1.6]])
    trils = jnp.stack([jnp.eye(2), jnp.eye(2)]) * np.sqrt(0.2)
    log_z, n_eff = importance_evidence_survey(_PM(), None, means, trils,
                                              n_samples=2048, seed=0)
    lz_true = [2 * (0.5 * np.log(0.2) - 1.0 / 2.5),
               2 * (0.5 * np.log(0.2) - 4.0 / 2.5)]
    np.testing.assert_allclose(log_z, lz_true, atol=0.03)
    assert (n_eff > 1500).all(), n_eff


def test_grouped_hmc_with_multi_window_warmup():
    """n_groups=2 with mass_adaptation=2 (per-group repeated warmup windows)
    keeps shapes and per-group posterior scales correct."""
    d, C = 3, 16
    scales_g = jnp.asarray([0.2, 2.0])

    def log_prob(z):
        s = jnp.repeat(scales_g, C)[:, None]
        return -0.5 * jnp.sum((z / s) ** 2, -1)

    z0 = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (2 * C, d))
    tril = jnp.stack([jnp.eye(d) * 0.2, jnp.eye(d) * 2.0])
    res = sample_hmc(
        log_prob, z0, jax.random.PRNGKey(3), step_size=0.2,
        num_leapfrog_steps=3, num_burnin_steps=300, num_results=400,
        momentum_covariance_tril=tril, trajectory_adaptation="chees",
        mass_adaptation=2, n_groups=2,
    )
    assert res.step_size.shape == (2,)
    s = np.asarray(res.samples)
    np.testing.assert_allclose(s[:, :C].reshape(-1, d).std(0), 0.2, rtol=0.2)
    np.testing.assert_allclose(s[:, C:].reshape(-1, d).std(0), 2.0, rtol=0.2)


def test_survey_fit_one_call(survey_setup):
    """SurveySequence.fit(): whole pipeline in one call, per-scene outputs."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    seq = SurveySequence(phys, spm, cfg)
    phases = []
    out = seq.fit(
        n_starts=8, map_steps=10, n_vi=8, vi_steps=10, n_hmc=8,
        num_burnin_steps=8, num_results=12, seed=0,
        progress=lambda ph, st, v: phases.append(ph),
    )
    S = 2
    assert out["best"].shape == (S, prior.d)
    assert out["q_means"].shape == (S, prior.d)
    assert out["q_trils"].shape == (S, prior.d, prior.d)
    assert out["hmc"].samples.shape[0] == 12
    assert np.isfinite(np.asarray(out["hmc"].samples)).all()
    assert len(out["summaries"]) == S
    assert {"map", "svi", "hmc"} <= set(phases)
    assert set(out["times"]) == {"map", "svi", "hmc"}


def _gauss_kernel(size, sigma):
    g = np.exp(
        -((np.arange(size) - size // 2) ** 2
          + (np.arange(size)[:, None] - size // 2) ** 2) / (2 * sigma**2)
    )
    return (g / g.sum()).astype(np.float32)


@pytest.mark.parametrize("mode,pool", [("fft", 1), ("dft", 1), ("dft", 2)])
def test_per_scene_psf_conv_matches_single(mode, pool):
    """PSFConv with a stacked (S, kh, kw) kernel convolves each scene-major
    block with its own kernel, identically to S single-kernel convs."""
    from gigalens_tpu.ops.psf import PSFConv

    H = W = 24
    kernels = np.stack([_gauss_kernel(7, 1.0), _gauss_kernel(7, 2.5)])
    rng = np.random.default_rng(3)
    K = 5
    x = jnp.asarray(rng.normal(size=(2 * K, H, W)).astype(np.float32))

    conv_s = PSFConv(kernels, (H, W), mode=mode, pool=pool)
    out = np.asarray(jax.jit(conv_s)(x))
    for s in range(2):
        conv1 = PSFConv(kernels[s], (H, W), mode=mode, pool=pool)
        ref = np.asarray(jax.jit(conv1)(x[s * K : (s + 1) * K]))
        np.testing.assert_allclose(out[s * K : (s + 1) * K], ref,
                                   rtol=1e-5, atol=1e-5)


def test_per_scene_psf_batch_validation():
    from gigalens_tpu.ops.psf import PSFConv

    kernels = np.stack([_gauss_kernel(5, 1.0), _gauss_kernel(5, 2.0)])
    conv = PSFConv(kernels, (16, 16), mode="fft")
    with pytest.raises(ValueError, match="scene-major"):
        conv(jnp.zeros((3, 16, 16)))  # 3 not a multiple of S=2
    with pytest.raises(NotImplementedError):
        PSFConv(kernels, (16, 16), mode="direct")


def test_simulator_per_scene_psf_matches_single(survey_setup):
    """LensSimulator with a (S, kh, kw) kernel == per-scene simulators with
    their own kernels (supersampled subgrid path included)."""
    prior, phys, cfg, truths, obs, bkg, exp_t = survey_setup
    import dataclasses

    kernels = np.stack([_gauss_kernel(9, 1.2), _gauss_kernel(9, 3.0)])
    cfg_s = dataclasses.replace(cfg, kernel=kernels, supersample=2,
                                psf_mode="fft")
    K = 3
    params = prior.sample(jax.random.PRNGKey(5), 2 * K)
    sim = LensSimulator(phys, cfg_s, bs=2 * K)
    out = np.asarray(jax.jit(sim.simulate)(params))

    for s in range(2):
        cfg1 = dataclasses.replace(cfg, kernel=kernels[s], supersample=2,
                                   psf_mode="fft")
        sim1 = LensSimulator(phys, cfg1, bs=K)
        block = jax.tree_util.tree_map(
            lambda a: a[s * K : (s + 1) * K], params
        )
        ref = np.asarray(jax.jit(sim1.simulate)(block))
        np.testing.assert_allclose(out[s * K : (s + 1) * K], ref,
                                   rtol=1e-5, atol=1e-5)


def test_survey_fit_per_scene_psf_recovers_truths(survey_setup):
    """Two scenes observed through very different PSFs: the survey MAP with
    the per-scene kernel stack recovers each scene's truth (chi2 ~ 1 against
    that scene's data), which a shared-kernel fit cannot."""
    prior, phys, cfg, truths, _, bkg, exp_t = survey_setup
    import dataclasses

    kernels = np.stack([_gauss_kernel(9, 0.8), _gauss_kernel(9, 2.5)])
    cfg_s = dataclasses.replace(cfg, kernel=kernels, psf_mode="fft")
    sim2 = LensSimulator(phys, cfg_s, bs=2)
    imgs = np.asarray(jax.jit(sim2.simulate)(truths))
    rng = np.random.default_rng(11)
    obs = imgs + rng.normal(size=imgs.shape).astype(np.float32) * np.sqrt(
        bkg**2 + np.clip(imgs, 0, None) / exp_t
    )

    spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_t)
    seq = SurveySequence(phys, spm, cfg_s)
    sched = optax.polynomial_schedule(-5e-3, -1e-3, 1.0, 200)
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    z = seq.MAP(opt, n_starts=16, num_steps=200, seed=0)
    best = seq.best_per_scene(z)
    _, chi2 = jax.jit(lambda z: spm.log_prob(sim2, z))(
        prior.unconstrain(prior.constrain(prior.unconstrain(
            prior.sample(jax.random.PRNGKey(0), 2)))) * 0 + best
    )
    chi2 = np.asarray(chi2)
    assert (chi2 < 1.5).all(), chi2
