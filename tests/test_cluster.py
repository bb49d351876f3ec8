"""Cluster machinery: scaling relations and jet-based Taylor series."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gigalens_tpu.profiles.mass.dpie import DPIE
from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhalo, DPIESubhaloSeries
from gigalens_tpu.profiles.mass.scaling import ScalingRelation
from gigalens_tpu.profiles.mass.series import MassSeries, taylor_derivs
from gigalens_tpu.profiles.mass.sie import SIS


@pytest.fixture
def catalogue(rng):
    g = 7
    return dict(
        lum=rng.uniform(0.3, 3.0, g).astype(np.float32),
        center_x=rng.normal(0, 1.0, g).astype(np.float32),
        center_y=rng.normal(0, 1.0, g).astype(np.float32),
        e1=rng.uniform(-0.2, 0.2, g).astype(np.float32),
        e2=rng.uniform(-0.2, 0.2, g).astype(np.float32),
    )


def test_taylor_derivs_polynomial():
    f = lambda r: jnp.stack([r**3, jnp.sin(r)])
    d = taylor_derivs(f, jnp.float32(2.0), 3)
    want = [
        [8.0, math.sin(2)],
        [12.0, math.cos(2)],
        [12.0, -math.sin(2)],
        [6.0, -math.cos(2)],
    ]
    np.testing.assert_allclose(np.stack(d), want, rtol=1e-4, atol=1e-5)


def test_scaling_relation_matches_manual_sum(catalogue, rng):
    """Scaled SIS stack == explicit per-galaxy loop."""
    prof = ScalingRelation(
        SIS(),
        scaling_params=["theta_E"],
        lum_star=1.0,
        scaling_params_power={"theta_E": 0.5},
        galaxy_catalogue=catalogue,
    )
    x = rng.normal(size=50).astype(np.float32)
    y = rng.normal(size=50).astype(np.float32)
    scales = dict(theta_E=jnp.array([[1.1], [0.7]]))  # bs=2
    fx, fy = prof.deriv(x, y, **scales)
    assert fx.shape == (2, 50)

    for b, te in enumerate([1.1, 0.7]):
        wx = np.zeros(50)
        wy = np.zeros(50)
        for g in range(len(catalogue["lum"])):
            theta = te * catalogue["lum"][g] ** 0.5
            gx, gy = SIS().deriv(
                x, y,
                theta_E=theta,
                center_x=catalogue["center_x"][g],
                center_y=catalogue["center_y"][g],
            )
            wx += np.asarray(gx)
            wy += np.asarray(gy)
        np.testing.assert_allclose(fx[b], wx, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(fy[b], wy, rtol=1e-4, atol=1e-4)


def test_scaling_relation_chunking_invariance(catalogue, rng):
    x = rng.normal(size=30).astype(np.float32)
    y = rng.normal(size=30).astype(np.float32)
    scales = dict(theta_E=jnp.array([[1.0]]))
    outs = []
    for chunk in [None, 3, 2]:
        prof = ScalingRelation(
            SIS(), ["theta_E"], 1.0, {"theta_E": 0.5}, catalogue, chunk_size=chunk
        )
        outs.append(np.asarray(prof.deriv(x, y, **scales)[0]))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-5)


def test_mass_series_dpie_matches_direct(rng):
    """Series eval at perturbed r_cut matches the direct dPIE profile."""
    x = rng.normal(size=40).astype(np.float32) * 2
    y = rng.normal(size=40).astype(np.float32) * 2
    consts = dict(r_core=0.15, center_x=0.1, center_y=-0.05, e1=0.1, e2=-0.08)
    r_cut0 = 2.0

    series = MassSeries(DPIE(), "r_cut", "theta_E", order=4)
    series.set_constants(dict(r_cut=r_cut0, **consts))
    series.set_grid(x, y)
    series.set_deriv()
    series.set_hessian()

    for dv in [0.0, 0.05, -0.1, 0.2]:
        r_cut = r_cut0 + dv
        amp = 1.3
        got = series.deriv(
            x, y, theta_E=jnp.array([amp]), r_cut=jnp.array([r_cut0 + dv])
        )
        want = DPIE().deriv(x, y, theta_E=amp, r_cut=r_cut, **consts)
        tol = 2e-4 + 10 * abs(dv) ** 5  # truncation + float32
        np.testing.assert_allclose(got[0][0], want[0], rtol=5e-3, atol=tol)
        np.testing.assert_allclose(got[1][0], want[1], rtol=5e-3, atol=tol)

    # hessian too
    got_h = series.hessian(
        x, y, theta_E=jnp.array([1.0]), r_cut=jnp.array([r_cut0 + 0.05])
    )
    from gigalens_tpu.profiles.base import MassProfile

    want_h = MassProfile.hessian(
        DPIE(), x, y, theta_E=1.0, r_cut=r_cut0 + 0.05, **consts
    )
    np.testing.assert_allclose(got_h[0][0], want_h[0], rtol=1e-2, atol=5e-3)
    np.testing.assert_allclose(got_h[3][0], want_h[3], rtol=1e-2, atol=5e-3)


def test_dpie_subhalo_series_matches_direct(catalogue, rng):
    """Series-accelerated member stack == direct stack at perturbed r_cut."""
    cat = dict(catalogue, r_core=np.full(7, 0.05, np.float32))
    x = rng.normal(size=25).astype(np.float32) * 2
    y = rng.normal(size=25).astype(np.float32) * 2

    direct = DPIESubhalo(lum_star=1.0, galaxy_catalogue=cat)
    series = DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat, order=4)

    r_cut0, theta0 = 1.5, 0.8
    series.set_constants(dict(r_cut=r_cut0, r_core=0.05))
    series.set_grid(x, y)
    series.set_deriv()

    for dv in [0.0, 0.1]:
        got = series.deriv(
            x, y, theta_E=jnp.array([theta0]), r_cut=jnp.array([r_cut0 + dv])
        )
        want = direct.deriv(
            x, y,
            theta_E=jnp.array([[theta0]]),
            r_core=jnp.array([[0.05]]),
            r_cut=jnp.array([[r_cut0 + dv]]),
        )
        np.testing.assert_allclose(got[0][0], want[0][0], rtol=5e-3, atol=2e-3)
        np.testing.assert_allclose(got[1][0], want[1][0], rtol=5e-3, atol=2e-3)


def test_dpie_degenerate_params_finite():
    """Zero-luminosity padded galaxies (all scaled params 0) and exactly
    circular members must produce finite (and for the padded case, zero)
    deflections — regression: the r_core=r_cut=0 corner made the sort guard
    emit hi == lo (0/0 scale) and e=0 hit the K&K formula's 1/sqrt(e)."""
    from gigalens_tpu.profiles.mass.dpie import DPIE

    d = DPIE()
    x = jnp.asarray([3.1, -2.8], jnp.float32)
    y = jnp.asarray([0.4, -0.6], jnp.float32)

    fx, fy = d.deriv(x, y, theta_E=0.0, r_core=0.0, r_cut=0.0,
                     e1=0.1, e2=-0.05, center_x=2.0, center_y=1.0)
    np.testing.assert_array_equal(np.asarray(fx), 0.0)
    np.testing.assert_array_equal(np.asarray(fy), 0.0)

    fx0, fy0 = d.deriv(x, y, theta_E=0.3, r_core=0.08, r_cut=1.5,
                       e1=0.0, e2=0.0, center_x=2.0, center_y=1.0)
    fx1, fy1 = d.deriv(x, y, theta_E=0.3, r_core=0.08, r_cut=1.5,
                       e1=1e-5, e2=0.0, center_x=2.0, center_y=1.0)
    # e = 0 must agree with the smooth e -> 0 limit (floored at e = 1e-6,
    # so comparing against e = 1e-5 carries ~delta-e * dalpha/de of slack)
    np.testing.assert_allclose(np.asarray(fx0), np.asarray(fx1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(fy0), np.asarray(fy1), atol=1e-4)

    h = d.hessian(x, y, theta_E=0.0, r_core=0.0, r_cut=0.0,
                  e1=0.1, e2=-0.05, center_x=2.0, center_y=1.0)
    assert all(bool(jnp.isfinite(v).all()) for v in h)


def test_scaling_relation_padded_chunk_finite(rng):
    """A catalogue size that forces zero-luminosity padding must not poison
    the member sum (the padded galaxy's dPIE params are all zero)."""
    from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhalo

    G = 5  # chunk_size 4 -> pads to 8 with 3 zero-lum galaxies
    cat = dict(
        lum=rng.uniform(0.5, 2.0, G).astype(np.float32),
        center_x=rng.normal(0, 2.0, G).astype(np.float32),
        center_y=rng.normal(0, 2.0, G).astype(np.float32),
        e1=rng.uniform(-0.2, 0.2, G).astype(np.float32),
        e2=rng.uniform(-0.2, 0.2, G).astype(np.float32),
    )
    members = DPIESubhalo(lum_star=1.0, galaxy_catalogue=cat, chunk_size=4)
    x = jnp.asarray(rng.normal(size=32) * 2, jnp.float32)
    y = jnp.asarray(rng.normal(size=32) * 2, jnp.float32)
    fx, fy = members.deriv(x, y, theta_E=jnp.float32(0.3),
                           r_core=jnp.float32(0.08), r_cut=jnp.float32(1.5))
    assert bool(jnp.isfinite(fx).all() and jnp.isfinite(fy).all())
    h = members.hessian(x, y, theta_E=jnp.float32(0.3),
                        r_core=jnp.float32(0.08), r_cut=jnp.float32(1.5))
    assert all(bool(jnp.isfinite(v).all()) for v in h)


def test_cluster_full_pipeline_smoke(rng):
    """Tiny end-to-end cluster fit: MAP -> Laplace -> SVI -> HMC all finite.

    Mirrors examples/demo_cluster.py --series --full (the configuration that
    produced NaNs from a diverged multi-start row on an accelerator, see
    inference/map.py::best_start) at smoke scale: series members + NFW halo
    + shapelet source with pixel AND position likelihoods.
    """
    import optax

    from gigalens_tpu import PhysicalModel, SimulatorConfig
    from gigalens_tpu.inference import ModellingSequence
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.prob import Prior
    from gigalens_tpu.prob import distributions as gld
    from gigalens_tpu.profiles.light.shapelets import Shapelets
    from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhaloSeries
    from gigalens_tpu.profiles.mass.nfw import NFW_ELLIPSE
    from gigalens_tpu.simulator import LensSimulator

    G = 6
    cat = dict(
        lum=rng.uniform(0.3, 3.0, G).astype(np.float32),
        center_x=rng.normal(0, 3.0, G).astype(np.float32),
        center_y=rng.normal(0, 3.0, G).astype(np.float32),
        e1=rng.uniform(-0.2, 0.2, G).astype(np.float32),
        e2=rng.uniform(-0.2, 0.2, G).astype(np.float32),
    )
    members = DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat, order=2)
    shapelet = Shapelets(n_max=2)
    phys = PhysicalModel([NFW_ELLIPSE(), members], [], [shapelet])
    amp_priors = {a: gld.Normal(0, 5.0) for a in shapelet._amp_names}
    prior = Prior(dict(
        lens_mass=[
            dict(Rs=gld.LogNormal(np.log(6.0), 0.2),
                 alpha_Rs=gld.LogNormal(np.log(2.0), 0.3),
                 e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
                 center_x=gld.Normal(0, 0.3), center_y=gld.Normal(0, 0.3)),
            dict(theta_E=gld.LogNormal(np.log(0.3), 0.3),
                 r_cut=gld.LogNormal(np.log(1.5), 0.2)),
        ],
        source_light=[dict(beta=gld.LogNormal(np.log(0.4), 0.2),
                           center_x=gld.Normal(0, 0.2),
                           center_y=gld.Normal(0, 0.2),
                           **amp_priors)],
    ))
    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    cfg = SimulatorConfig(delta_pix=0.3, num_pix=24, supersample=1,
                          kernel=(g / g.sum()).astype(np.float32))

    probe = LensSimulator(phys, cfg, bs=1)
    members.set_constants(dict(r_cut=1.5, r_core=0.08))
    members.set_grid(probe.img_x, probe.img_y)
    members.set_deriv()

    truth = prior.sample(jax.random.PRNGKey(3), 1)
    img = np.asarray(jax.jit(LensSimulator(phys, cfg, bs=1).simulate)(truth))
    obs = img + rng.normal(size=img.shape).astype(np.float32) * 0.1
    pm = ForwardProbModel(
        prior, obs, background_rms=0.1, exp_time=500.0,
        centroids_x=[np.array([1.2, -0.9], np.float32)],
        centroids_y=[np.array([0.3, -0.4], np.float32)],
        centroids_errors_x=[np.full(2, 0.1, np.float32)],
        centroids_errors_y=[np.full(2, 0.1, np.float32)],
    )
    seq = ModellingSequence(phys, pm, cfg)

    z = seq.MAP(optax.adam(5e-3), n_samples=8, num_steps=20, seed=0)
    best = seq.best_map_start(z)
    assert bool(jnp.isfinite(best).all())
    L0 = seq.laplace_scale_tril(best)
    assert np.isfinite(L0).all()
    q_z, losses = seq.SVI(best, optax.adam(2e-3), n_vi=8, num_steps=10,
                          init_scales=L0, seed=1)
    assert bool(jnp.isfinite(losses).all())
    res = seq.HMC(q_z, n_hmc=4, num_burnin_steps=8, num_results=12, seed=2)
    assert bool(jnp.isfinite(res.samples).all())
