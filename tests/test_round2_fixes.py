"""Regression tests for the round-2 correctness fixes (VERDICT weak #4-8,
ADVICE items): silent-correctness traps and numerics hardening."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.model import BackwardProbModel, ForwardProbModel
from gigalens_tpu.prob import Prior
from gigalens_tpu.prob import distributions as gld
from gigalens_tpu.profiles.light.sersic import Sersic, SersicEllipse
from gigalens_tpu.profiles.mass.dpie import DPIE
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.series import MassSeries
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator


# ------------------------------------------------------ ellipticity angle
def test_ellipticity_to_polar_gradient_finite_at_origin():
    """ADVICE: the gradient of the ellipse angle and axis ratio at exactly
    e1=e2=0 must be finite (a user starting MAP/SVI from the prior mean
    hits this point exactly); the render kernel and the XLA profiles share
    this function."""
    from gigalens_tpu.profiles.base import ellipticity_to_polar

    def f(e):
        _, q, phi = ellipticity_to_polar(e[0], e[1], e_max=1.0)
        return q + jnp.cos(phi) + jnp.sin(phi)

    g = jax.grad(f)(jnp.zeros(2))
    assert np.all(np.isfinite(np.asarray(g)))
    # value is the identity rotation of a round profile
    _, q, phi = ellipticity_to_polar(jnp.zeros(()), jnp.zeros(()))
    assert np.allclose([q, phi], [1.0, 0.0])


# ------------------------------------------------------- TruncatedNormal tails
def test_truncated_normal_far_tail_normalization():
    """log(ndtr(b)-ndtr(a)) cancels for far-tail windows; the log_ndtr-based
    mass must match scipy.stats.truncnorm in both tails and the bulk."""
    from scipy import stats

    cases = [
        (0.0, 1.0, 8.0, 10.0),    # far right tail
        (0.0, 1.0, -10.0, -8.0),  # far left tail
        (0.0, 1.0, -1.0, 2.0),    # bulk
        (3.0, 0.5, 5.5, 6.0),     # right tail, shifted/scaled
    ]
    for loc, scale, low, high in cases:
        d = gld.TruncatedNormal(loc, scale, low, high)
        x = np.linspace(low, high, 7)[1:-1]
        a, b = (low - loc) / scale, (high - loc) / scale
        want = stats.truncnorm.logpdf(x, a, b, loc=loc, scale=scale)
        got = np.asarray(jax.vmap(d.log_prob)(jnp.asarray(x, jnp.float32)))
        assert np.all(np.isfinite(got)), (loc, scale, low, high)
        # float32 evaluation of the quadratic term limits the tolerance
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


# ----------------------------------------------------- Prior structure check
def test_prior_flatten_rejects_wrong_structure():
    prior = Prior(dict(a=gld.Normal(0, 1), b=dict(c=gld.Normal(0, 1))))
    ok = dict(a=jnp.zeros(3), b=dict(c=jnp.zeros(3)))
    assert np.asarray(prior.log_prob(ok)).shape == (3,)
    # same leaf count, different nesting -> must raise, not misalign columns
    bad = dict(a=dict(c=jnp.zeros(3)), b=jnp.zeros(3))
    with pytest.raises(ValueError, match="structure"):
        prior.log_prob(bad)
    bad2 = dict(a=jnp.zeros(3), wrong_key=dict(c=jnp.zeros(3)))
    with pytest.raises(ValueError, match="structure"):
        prior.unconstrain(bad2)


# ------------------------------------------------------- MassSeries grid guard
def _series_fixture():
    s = MassSeries(DPIE(), "r_cut", "theta_E", order=2)
    x = jnp.linspace(-1, 1, 16)
    y = jnp.linspace(-1, 1, 16)
    s.set_constants(dict(r_cut=1.0, r_core=0.1, e1=0.05, e2=0.08,
                         center_x=0.0, center_y=0.0))
    s.set_grid(x, y)
    s.set_deriv()
    return s, x, y


def test_series_same_shape_different_grid_raises():
    s, x, y = _series_fixture()
    fx, fy = s.deriv(x, y, r_cut=jnp.asarray([1.1]), theta_E=jnp.asarray([1.0]))
    assert np.all(np.isfinite(np.asarray(fx)))
    # same shape, different values: stale coefficients must NOT be applied
    with pytest.raises(ValueError, match="not its values"):
        s.deriv(x + 0.5, y, r_cut=jnp.asarray([1.1]), theta_E=jnp.asarray([1.0]))


def test_series_different_shape_uses_direct_path():
    s, x, y = _series_fixture()
    # off-grid points with a different shape: exact fallback, no error
    xs = jnp.asarray([0.3, -0.2, 0.7])
    ys = jnp.asarray([0.1, 0.4, -0.6])
    fx, fy = s.deriv(xs, ys, r_cut=jnp.asarray([1.0]), theta_E=jnp.asarray([1.0]))
    ex, ey = DPIE().deriv(xs, ys, r_cut=1.0, r_core=0.1, e1=0.05, e2=0.08,
                          center_x=0.0, center_y=0.0, theta_E=1.0)
    np.testing.assert_allclose(np.asarray(fx), np.asarray(ex), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(fy), np.asarray(ey), rtol=1e-5)


# ------------------------------------------- _render_selected re-entrancy
def test_render_selected_does_not_mutate_simulator(demo_prior, demo_physmodel):
    sim = LensSimulator(demo_physmodel, SimulatorConfig(delta_pix=0.1, num_pix=20), bs=2)
    params = demo_prior.sample(jax.random.PRNGKey(0), 2)
    pm_before = sim.phys_model
    src = sim.simulate_source(params)
    imgs = sim.simulate_images(params)
    ll = sim.simulate_lens_light(params)
    assert sim.phys_model is pm_before
    assert len(sim.phys_model.source_light) == 1
    assert len(sim.phys_model.lens_light) == 1
    # component renders sum to the full render (all light is additive and the
    # PSF/pooling postprocess is linear)
    full = sim.simulate(params)
    np.testing.assert_allclose(
        np.asarray(imgs + ll), np.asarray(full), rtol=1e-4, atol=1e-5
    )
    assert np.all(np.isfinite(np.asarray(src)))


# ------------------------------------------- BackwardProbModel SMC target
def test_backward_model_smc_pixels_target(demo_prior):
    from gigalens_tpu.inference.smc import fit_smc

    phys = PhysicalModel(
        [EPL(18), Shear()],
        [SersicEllipse(use_lstsq=True)],
        [SersicEllipse(use_lstsq=True)],
    )
    # drop Ie from the prior: lstsq solves the linear amplitudes
    tree = demo_prior.tree
    import copy

    tree2 = copy.deepcopy(tree)
    for d in (tree2["lens_light"][0], tree2["source_light"][0]):
        d.pop("Ie")
    prior = Prior(tree2)
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=10)
    obs = np.random.default_rng(0).normal(0, 0.1, (10, 10)).astype(np.float32)
    prob = BackwardProbModel(prior, obs, background_rms=0.1, exp_time=100.0)
    sim = LensSimulator(phys, cfg, bs=8)
    res = fit_smc(
        prob, sim, num_particles=8, num_ensembles=1, num_leapfrog_steps=2,
        post_sampling_steps=3, max_stage=2, target="pixels", seed=0,
    )
    assert np.all(np.isfinite(np.asarray(res.particles)))
    assert res.post_samples.shape == (3, 8, prior.d)

    # a positions target on a Backward model must fail clearly, not with
    # an AttributeError
    with pytest.raises((ValueError, NotImplementedError)):
        fit_smc(prob, sim, num_particles=8, max_stage=1, target="positions")


# ------------------------------------------------- SMC post chunking shapes
def test_smc_post_chain_segmented_equal_chunks(demo_prior, demo_physmodel):
    from gigalens_tpu.inference.smc import fit_smc

    cfg = SimulatorConfig(delta_pix=0.1, num_pix=10)
    obs = np.zeros((10, 10), np.float32)
    prob = ForwardProbModel(demo_prior, obs, background_rms=0.2, exp_time=100.0)
    sim = LensSimulator(demo_physmodel, cfg, bs=8)
    # segment_stages=1, max_sampling_per_stage=4 -> chunk 4; 10 steps -> 3
    # equal chunks of 4 with the surplus discarded
    res = fit_smc(
        prob, sim, num_particles=8, num_leapfrog_steps=2,
        post_sampling_steps=10, max_stage=2, segment_stages=1,
        max_sampling_per_stage=4, seed=0,
    )
    assert res.post_samples.shape == (10, 8, demo_prior.d)
    assert np.all(np.isfinite(np.asarray(res.post_samples)))


# ------------------------------------------------- fill_triangular ordering
def test_fill_triangular_documented_ordering():
    """The flat SVI parameter layout is row-major tril (documented as NOT the
    TFP packing order); this pins the documented behavior so saved SVI states
    stay portable across versions."""
    from gigalens_tpu.prob.bijectors import (
        fill_triangular,
        fill_triangular_inverse,
    )

    v = jnp.arange(1.0, 7.0)
    m = np.asarray(fill_triangular(v, 3))
    np.testing.assert_allclose(
        m, [[1, 0, 0], [2, 3, 0], [4, 5, 6]]
    )
    np.testing.assert_allclose(np.asarray(fill_triangular_inverse(m)), v)
    # round trip with batch dims
    vb = jnp.reshape(jnp.arange(12.0), (2, 6))
    np.testing.assert_allclose(
        np.asarray(fill_triangular_inverse(fill_triangular(vb, 3))), vb
    )


# ----------------------------------------- zero-ellipticity gradients (e2e)
def test_zero_ellipticity_gradients_finite_end_to_end():
    """The ellipse-angle guard alone was not enough: every consumer of
    sqrt(e1^2+e2^2) / arctan2(e2, e1) must also be guarded, or a MAP/SVI
    start from the prior mean (z = 0 -> e1 = e2 = 0 exactly) still produces
    NaN gradients. Checks the EPL+Shear / 2x SersicEllipse render and each
    elliptical profile through jax.grad."""
    from gigalens_tpu.profiles.light.sersic import SersicEllipse
    from gigalens_tpu.profiles.mass.dpie import DPIE, DPIEP
    from gigalens_tpu.profiles.mass.nfw import NFW_ELLIPSE
    from gigalens_tpu.profiles.mass.sie import SIE

    xs = jnp.asarray([0.3, -0.5, 0.8])
    ys = jnp.asarray([0.2, 0.6, -0.4])

    # the whole render, all ellipticities and centers zero
    sim = LensSimulator(
        PhysicalModel([EPL(12), Shear()], [SersicEllipse()], [SersicEllipse()]),
        SimulatorConfig(delta_pix=0.1, num_pix=4), bs=1)
    sim.img_x, sim.img_y = xs, ys

    def one(**kw):
        return {k: jnp.asarray([v], jnp.float32) for k, v in kw.items()}

    p0 = dict(
        lens_mass=[one(theta_E=1.2, gamma=2.0, e1=0.0, e2=0.0, center_x=0.0,
                       center_y=0.0), one(gamma1=0.0, gamma2=0.0)],
        lens_light=[one(R_sersic=1.0, n_sersic=4.0, e1=0.0, e2=0.0,
                        center_x=0.0, center_y=0.0, Ie=500.0)],
        source_light=[one(R_sersic=0.25, n_sersic=1.5, e1=0.0, e2=0.0,
                          center_x=0.0, center_y=0.0, Ie=150.0)],
    )
    g = jax.grad(lambda p: jnp.sum(sim._flat_light(p)))(p0)
    assert all(np.all(np.isfinite(np.asarray(l)))
               for l in jax.tree_util.tree_leaves(g)), "render grad NaN at e=0"

    def check(fn, params):
        grads = jax.grad(
            lambda pp: sum(jnp.sum(o) for o in jnp.atleast_1d(fn(**pp)))
        )(params)
        flat = jax.tree_util.tree_leaves(grads)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in flat), fn

    check(lambda **kw: jnp.stack(EPL(10).deriv(xs, ys, **kw)),
          dict(theta_E=jnp.float32(1.2), gamma=jnp.float32(2.0),
               e1=jnp.float32(0.0), e2=jnp.float32(0.0),
               center_x=jnp.float32(0.0), center_y=jnp.float32(0.0)))
    check(lambda **kw: jnp.stack(SIE().deriv(xs, ys, **kw)),
          dict(theta_E=jnp.float32(1.2), e1=jnp.float32(0.0),
               e2=jnp.float32(0.0), center_x=jnp.float32(0.0),
               center_y=jnp.float32(0.0)))
    check(lambda **kw: jnp.stack(NFW_ELLIPSE().deriv(xs, ys, **kw)),
          dict(Rs=jnp.float32(3.0), alpha_Rs=jnp.float32(1.0),
               e1=jnp.float32(0.0), e2=jnp.float32(0.0),
               center_x=jnp.float32(0.0), center_y=jnp.float32(0.0)))
    check(lambda **kw: jnp.stack(DPIE().deriv(xs, ys, **kw)),
          dict(theta_E=jnp.float32(1.0), r_core=jnp.float32(0.1),
               r_cut=jnp.float32(2.0), e1=jnp.float32(0.0),
               e2=jnp.float32(0.0), center_x=jnp.float32(0.0),
               center_y=jnp.float32(0.0)))
    check(lambda **kw: SersicEllipse().light(xs, ys, **kw),
          dict(R_sersic=jnp.float32(1.0), n_sersic=jnp.float32(4.0),
               e1=jnp.float32(0.0), e2=jnp.float32(0.0),
               center_x=jnp.float32(0.0), center_y=jnp.float32(0.0),
               Ie=jnp.float32(100.0)))


# --------------------------------------------------- Laplace FD vs exact
def test_laplace_fd_matches_exact(demo_prior, demo_physmodel, small_sim_config):
    """The FD-gradient Laplace Hessian (default, single first-order program
    on the host CPU) must reproduce the exact reverse-over-reverse
    scale_tril closely enough to serve as the same SVI initializer."""
    from gigalens_tpu.inference import ModellingSequence

    prior = demo_prior
    obs = np.zeros((20, 20), np.float32)
    pm = ForwardProbModel(prior, obs, background_rms=0.1, exp_time=100.0)
    seq = ModellingSequence(demo_physmodel, pm, small_sim_config)
    start = prior.unconstrain(prior.sample(jax.random.PRNGKey(3), 1))
    L_fd = np.asarray(seq.laplace_scale_tril(start, method="fd"))
    L_ex = np.asarray(seq.laplace_scale_tril(start, method="exact"))
    assert np.all(np.isfinite(L_fd))
    rel = np.linalg.norm(L_fd - L_ex) / np.linalg.norm(L_ex)
    assert rel < 0.15, f"FD laplace diverges from exact: rel fro {rel:.3f}"
    dr = np.diag(L_fd) / np.diag(L_ex)
    assert np.all(dr > 0.7) and np.all(dr < 1.4)


# ----------------------------------------- review fixes (round-2 code review)
def test_truncated_normal_right_tail_sampling():
    """Sampling a window deep in the right tail must not collapse to `high`:
    in f32 ndtr(8) == ndtr(10) == 1.0, so the naive inverse-CDF pins every
    draw at the upper bound; the mirrored form keeps full precision."""
    d = gld.TruncatedNormal(0.0, 1.0, 8.0, 10.0)
    x = np.asarray(d.sample(jax.random.PRNGKey(0), (512,)))
    assert np.all((x >= 8.0) & (x <= 10.0))
    assert not np.allclose(x, 10.0), "samples collapsed to the upper bound"
    assert x.std() > 1e-3
    # truncnorm(8, 10) has mean ~8.12; generous tolerance for f32 quantiles
    assert 8.0 < x.mean() < 8.35
    # left-tail and bulk windows keep their previous (well-conditioned) path
    d2 = gld.TruncatedNormal(2.0, 0.25, 1.0, 3.0)
    x2 = np.asarray(d2.sample(jax.random.PRNGKey(1), (512,)))
    assert np.all((x2 >= 1.0) & (x2 <= 3.0)) and 1.9 < x2.mean() < 2.1
    # log_prob is finite for in-window points of the tail case
    assert np.isfinite(np.asarray(d.log_prob(jnp.asarray(8.1))))


def test_series_traced_grid_falls_back_to_exact():
    """Traced coordinates cannot be value-matched against the precomputed
    grid; the series must fall back to the exact profile (correct result)
    rather than trusting the shape and applying stale coefficients."""
    s, x, y = _series_fixture()

    kw = dict(r_cut=jnp.asarray([1.1]), theta_E=jnp.asarray([1.0]))

    @jax.jit
    def traced_eval(xx, yy):
        return s.deriv(xx, yy, **kw)

    # same shape as the grid but shifted values, passed as jit ARGUMENTS
    fx, fy = traced_eval(x + 0.5, y)
    ex, ey = DPIE().deriv(x + 0.5, y, r_cut=1.1, r_core=0.1, e1=0.05, e2=0.08,
                          center_x=0.0, center_y=0.0, theta_E=1.0)
    np.testing.assert_allclose(np.asarray(fx).ravel(), np.asarray(ex).ravel(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fy).ravel(), np.asarray(ey).ravel(),
                               rtol=1e-4, atol=1e-6)


def test_cached_log_prob_invalidated_on_mutation(demo_prior, demo_physmodel,
                                                 small_sim_config):
    """Rebinding an attribute on the model or simulator must invalidate the
    cached posterior closure (identity+version key), not silently reuse
    compiled programs with the old data baked in."""
    from gigalens_tpu.inference.hmc import _cached_log_prob_fn

    obs = np.zeros((20, 20), np.float32)
    pm = ForwardProbModel(demo_prior, obs, background_rms=0.1, exp_time=100.0)
    sim = LensSimulator(demo_physmodel, small_sim_config, bs=2)
    f1 = _cached_log_prob_fn(pm, sim)
    assert _cached_log_prob_fn(pm, sim) is f1  # stable while unmutated
    v1 = pm._version
    pm.observed_image = jnp.ones((20, 20), jnp.float32)
    assert pm._version > v1  # attribute rebind bumps the version
    f2 = _cached_log_prob_fn(pm, sim)
    # fresh closure identity => jit caches keyed on it (e.g. _hmc_programs)
    # re-trace against the CURRENT attributes instead of replaying programs
    # with the old image baked in as a constant
    assert f2 is not f1
    # mutating the simulator invalidates too
    f3 = _cached_log_prob_fn(pm, sim)
    assert f3 is f2
    sim.conversion_factor = sim.conversion_factor
    assert _cached_log_prob_fn(pm, sim) is not f2


def test_sequence_sim_memo_respects_config_rebind(demo_prior, demo_physmodel,
                                                  small_sim_config):
    """Rebinding seq.sim_config after a phase call must rebuild simulators."""
    import dataclasses

    from gigalens_tpu.inference import ModellingSequence

    obs = np.zeros((20, 20), np.float32)
    pm = ForwardProbModel(demo_prior, obs, background_rms=0.1, exp_time=100.0)
    seq = ModellingSequence(demo_physmodel, pm, small_sim_config)
    s1 = seq._sim(4)
    assert seq._sim(4) is s1  # memo hit while config unchanged
    seq.sim_config = dataclasses.replace(small_sim_config, supersample=2)
    s2 = seq._sim(4)
    assert s2 is not s1
    assert s2.supersample == 2


def test_mean_field_init_uses_marginal_stddevs(demo_prior, demo_physmodel,
                                               small_sim_config):
    """A correlated Laplace factor's mean-field init must use the marginal
    stddevs (row norms of L), not |diag(L)|."""
    import optax

    from gigalens_tpu.inference.svi import fit_svi

    obs = np.zeros((20, 20), np.float32)
    pm = ForwardProbModel(demo_prior, obs, background_rms=0.1, exp_time=100.0)
    sim = LensSimulator(demo_physmodel, small_sim_config, bs=4)
    d = demo_prior.d
    # L with all scale in the off-diagonal for row 1
    L = np.eye(d, dtype=np.float32) * 0.1
    L[1, 0], L[1, 1] = 0.5, 1e-6
    start = demo_prior.unconstrain(demo_prior.sample(jax.random.PRNGKey(0), 1))
    q_z, _ = fit_svi(pm, sim, start, optax.scale(0.0), n_vi=4, num_steps=1,
                     init_scales=L, full_rank=False, seed=0)
    scale = np.asarray(q_z.scale_tril)
    # marginal sd of dim 1 is ~0.5 (row norm), not 1e-6 (diag)
    assert abs(scale[1, 1] - 0.5) < 0.01


def test_best_start_ignores_nan_rows(demo_prior, demo_physmodel, small_sim_config):
    """Diverged multi-start rows carry NaN log-posteriors; best_start must
    select the best FINITE row (argmax over raw lp would pick a NaN)."""
    from gigalens_tpu.inference.map import best_start

    obs = np.zeros((20, 20), np.float32)
    pm = ForwardProbModel(demo_prior, obs, background_rms=0.1, exp_time=100.0)
    sim = LensSimulator(demo_physmodel, small_sim_config, bs=4)
    z = np.array(demo_prior.unconstrain(demo_prior.sample(jax.random.PRNGKey(0), 4)))
    z[0, :] = np.nan  # a diverged start
    best = np.asarray(best_start(pm, sim, jnp.asarray(z)))
    assert np.all(np.isfinite(best)), "best_start returned a NaN row"


# ------------------------------------------------- signed-light noise model
def test_model_poisson_noise_clips_negative_pixels():
    """Profiles with signed components (shapelets) can render pixels below
    -background_rms^2 * exp_time; the model-based Poisson variance must clip
    at zero flux or sqrt goes NaN and poisons the posterior (first caught at
    full scale by scripts/bench_cluster_posterior.py, round 5). Reference
    clips its Poisson term the same way (jax/model.py:171)."""
    from gigalens_tpu.profiles.light.shapelets import Shapelets

    sh = Shapelets(n_max=1)
    prior = Prior(dict(
        lens_mass=[dict(theta_E=gld.LogNormal(jnp.log(1.0), 0.1),
                        center_x=gld.Normal(0, 0.05),
                        center_y=gld.Normal(0, 0.05))],
        source_light=[dict(
            beta=gld.LogNormal(jnp.log(0.4), 0.1),
            center_x=gld.Normal(0, 0.1), center_y=gld.Normal(0, 0.1),
            **{a: gld.Normal(0, 500.0) for a in sh._amp_names},
        )],
    ))
    from gigalens_tpu.profiles.mass.sie import SIS

    phys = PhysicalModel([SIS()], [], [sh])
    cfg = SimulatorConfig(delta_pix=0.2, num_pix=16, supersample=1)
    sim = LensSimulator(phys, cfg, bs=4)
    obs = np.zeros((16, 16), np.float32)
    pm = ForwardProbModel(prior, obs, background_rms=0.1, exp_time=500.0)
    # amps ~ N(0, 50): the rendered image has pixels far below
    # -bkg^2*exp_time = -5, which used to NaN the variance
    z = prior.unconstrain(prior.sample(jax.random.PRNGKey(0), 4))
    x = prior.constrain(z)
    img = np.asarray(sim.simulate(x))
    assert img.min() < -5.0, "test scene must actually render negative flux"
    lp, chi2 = pm.log_prob(sim, z)
    assert np.isfinite(np.asarray(lp)).all()
    assert np.isfinite(np.asarray(chi2)).all()
    g = jax.grad(lambda zz: jnp.sum(pm.log_prob(sim, zz)[0]))(z)
    assert np.isfinite(np.asarray(g)).all()


def test_positions_likelihood_finite_at_critical_curve():
    """A candidate lens that places an image centroid on its critical curve
    sends |magnification| -> inf; unclamped, the position term's err -> 0
    poisons mean-over-samples objectives (SVI elbo=nan, cluster posterior
    bench round 5). The clamp keeps log_prob and its gradient finite."""
    from gigalens_tpu.profiles.mass.sie import SIS

    prior = Prior(dict(
        lens_mass=[dict(theta_E=gld.LogNormal(0.0, 0.1),
                        center_x=gld.Normal(0, 0.01),
                        center_y=gld.Normal(0, 0.01))],
        source_light=[dict(R_sersic=gld.LogNormal(jnp.log(0.3), 0.1),
                           n_sersic=gld.Uniform(1, 2),
                           e1=gld.Normal(0, 0.05), e2=gld.Normal(0, 0.05),
                           center_x=gld.Normal(0, 0.1),
                           center_y=gld.Normal(0, 0.1),
                           Ie=gld.LogNormal(0.0, 0.2))],
    ))
    phys = PhysicalModel([SIS()], [], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=20, supersample=1)
    sim = LensSimulator(phys, cfg, bs=3)
    obs = np.zeros((20, 20), np.float32)
    # centroids on the unit circle: theta_E == 1 puts them exactly on the
    # tangential critical curve of the SIS (det A = 0, |mu| = inf)
    pm = ForwardProbModel(
        prior, obs, background_rms=0.1, exp_time=100.0,
        centroids_x=[np.array([1.0, -1.0], np.float32)],
        centroids_y=[np.array([0.0, 0.0], np.float32)],
        centroids_errors_x=[np.array([0.1, 0.1], np.float32)],
        centroids_errors_y=[np.array([0.1, 0.1], np.float32)],
    )
    z = prior.unconstrain(dict(
        lens_mass=[dict(theta_E=jnp.array([1.0, 0.9, 1.1]),
                        center_x=jnp.zeros(3), center_y=jnp.zeros(3))],
        source_light=[dict(R_sersic=jnp.full(3, 0.3), n_sersic=jnp.full(3, 1.5),
                           e1=jnp.zeros(3), e2=jnp.zeros(3),
                           center_x=jnp.zeros(3), center_y=jnp.zeros(3),
                           Ie=jnp.ones(3))],
    ))
    lp, _ = pm.log_prob(sim, z)
    assert np.isfinite(np.asarray(lp)).all()
    g = jax.grad(lambda zz: jnp.sum(pm.log_prob(sim, zz)[0]))(z)
    assert np.isfinite(np.asarray(g)).all()


def test_nfw_gradient_finite_at_branch_seam():
    """NFW special functions: gradient must be finite for x at/within one
    f32 ulp of the x=1 branch point. Clamping branch inputs only against the
    wrong side leaves 1/x rounding to exactly 1.0 inside the closed form,
    whose arccosh/arccos derivative is 1/0 = inf -> 0*inf = NaN through the
    selecting where's backward (found by the cluster posterior bench: a grid
    corner at R = Rs NaN'd a whole SVI run)."""
    from gigalens_tpu.profiles.mass import nfw as nfw_mod
    from gigalens_tpu.profiles.mass.nfw import NFW, NFW_ELLIPSE, TNFW

    one = np.float32(1.0)
    below = np.nextafter(one, np.float32(0.0), dtype=np.float32)
    above = np.nextafter(one, np.float32(2.0), dtype=np.float32)
    xs = jnp.asarray([below, one, above, 0.97, 1.03, 0.5, 2.0, 1e-6])
    # TNFW._F is only reached through TNFW._g's X_safe >= 0.05 clamp, so its
    # own small-x behavior is out of contract — probe it at the seam only
    xs_tnfw = xs[:-1]
    for fn, pts in ((nfw_mod._nfw_g, xs), (nfw_mod._nfw_h, xs),
                    (nfw_mod._nfw_f, xs), (lambda x: TNFW._F(x), xs_tnfw)):
        v = fn(pts)
        g = jax.vmap(jax.grad(lambda x: fn(x)))(pts)
        assert np.isfinite(np.asarray(v)).all(), fn
        assert np.isfinite(np.asarray(g)).all(), fn

    # end-to-end: full param gradient of the elliptical deflection with a
    # coordinate exactly at the stretched branch radius
    prof = NFW_ELLIPSE()

    def loss(p):
        ax, ay = prof.deriv(jnp.asarray([6.048, 1.0, 0.1]),
                            jnp.asarray([0.0, 0.0, 0.0]),
                            Rs=p[0], alpha_Rs=p[1], e1=p[2], e2=p[3],
                            center_x=p[4], center_y=p[5])
        return jnp.sum(ax) + jnp.sum(ay)

    # Rs chosen so one coordinate sits essentially on x = 1
    p0 = jnp.asarray([6.048, 3.43, 0.0, 0.0, 0.0, 0.0])
    g = jax.grad(loss)(p0)
    assert np.isfinite(np.asarray(g)).all()
    # and at exactly x == 1 for the spherical profile
    prof_s = NFW()

    def loss_s(p):
        ax, ay = prof_s.deriv(jnp.asarray([p[0]]), jnp.asarray([0.0]),
                              Rs=p[0], alpha_Rs=p[1],
                              center_x=jnp.zeros(()), center_y=jnp.zeros(()))
        return jnp.sum(ax) + jnp.sum(ay)

    g = jax.grad(loss_s)(jnp.asarray([2.0, 1.0]))
    assert np.isfinite(np.asarray(g)).all()
