"""Multi-plane lensing: cosmology distances vs published values, exact
single-plane limits, a float64 numpy oracle for the two-plane SIS recursion,
finite-difference magnification, and pipeline integration. (Beyond the
single-plane reference — see gigalens_tpu/cosmology.py.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.cosmology import FlatLambdaCDM, multiplane_factors
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.sie import SIE, SIS
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator


def test_comoving_distance_matches_published():
    """astropy FlatLambdaCDM(H0=70, Om0=0.3) values."""
    cosmo = FlatLambdaCDM(H0=70.0, Om0=0.3)
    np.testing.assert_allclose(cosmo.comoving_distance(1.0), 3303.83, rtol=2e-3)
    np.testing.assert_allclose(cosmo.comoving_distance(0.5), 1888.62, rtol=2e-3)
    np.testing.assert_allclose(
        cosmo.angular_diameter_distance(0.5), 1259.08, rtol=2e-3
    )
    assert cosmo.comoving_distance(0.0) == 0.0


def test_factor_validation():
    with pytest.raises(ValueError):
        multiplane_factors([0.8, 0.3], 1.5)  # not ascending
    with pytest.raises(ValueError):
        multiplane_factors([0.3, 1.6], 1.5)  # behind the source
    F = multiplane_factors([0.3, 0.3], 1.5)
    assert F[0, 1] == 0.0  # equal redshifts co-add


def _sis_params(theta_E, cx, cy):
    return dict(
        theta_E=jnp.array([theta_E]),
        center_x=jnp.array([cx]),
        center_y=jnp.array([cy]),
    )


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1.5, 1.5, 64).astype(np.float32))
    y = jnp.asarray(rng.uniform(-1.5, 1.5, 64).astype(np.float32))
    return x, y


def test_single_lens_multiplane_equals_single_plane(coords):
    x, y = coords
    p = [_sis_params(1.0, 0.05, -0.02)]
    pm_sp = PhysicalModel([SIS()], [], [])
    pm_mp = PhysicalModel([SIS()], [], [], lens_redshifts=[0.5], z_source=2.0)
    sim_sp = LensSimulator(pm_sp, SimulatorConfig(0.1, 8), bs=1)
    sim_mp = LensSimulator(pm_mp, SimulatorConfig(0.1, 8), bs=1)
    for a, b in zip(sim_sp.beta(x, y, p), sim_mp.beta(x, y, p)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_equal_redshifts_equal_single_plane(coords):
    x, y = coords
    p = [_sis_params(0.8, 0.0, 0.0), _sis_params(0.4, 0.3, -0.2)]
    pm_sp = PhysicalModel([SIS(), SIS()], [], [])
    pm_mp = PhysicalModel(
        [SIS(), SIS()], [], [], lens_redshifts=[0.5, 0.5], z_source=2.0
    )
    sim_sp = LensSimulator(pm_sp, SimulatorConfig(0.1, 8), bs=1)
    sim_mp = LensSimulator(pm_mp, SimulatorConfig(0.1, 8), bs=1)
    for a, b in zip(sim_sp.beta(x, y, p), sim_mp.beta(x, y, p)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    # hessian path (AD Jacobian vs per-profile sum) must agree too
    h_sp = sim_sp.hessian(x, y, p)
    h_mp = sim_mp.hessian(x, y, p)
    for a, b in zip(h_sp, h_mp):
        np.testing.assert_allclose(
            np.asarray(a + jnp.zeros_like(x)), np.asarray(b),
            rtol=1e-4, atol=1e-5,
        )


def test_two_plane_sis_matches_float64_oracle(coords):
    """Independent float64 recursion with the analytic SIS deflection."""
    x, y = coords
    z1, z2, zs = 0.4, 0.9, 2.5
    t1, t2 = (1.0, 0.1, -0.05), (0.7, -0.2, 0.15)
    pm = PhysicalModel(
        [SIS(), SIS()], [], [], lens_redshifts=[z1, z2], z_source=zs
    )
    sim = LensSimulator(pm, SimulatorConfig(0.1, 8), bs=1)
    p = [_sis_params(*t1), _sis_params(*t2)]
    bx, by = jax.jit(lambda pp: sim.beta(x, y, pp))(p)

    def sis64(xx, yy, theta_E, cx, cy):
        dx, dy = xx - cx, yy - cy
        r = np.sqrt(dx * dx + dy * dy)
        r = np.maximum(r, 1e-12)
        return theta_E * dx / r, theta_E * dy / r

    xx = np.asarray(x, np.float64)
    yy = np.asarray(y, np.float64)
    F = multiplane_factors([z1, z2], zs)
    a1 = sis64(xx, yy, *t1)
    x2 = xx - F[0, 1] * a1[0]
    y2 = yy - F[0, 1] * a1[1]
    a2 = sis64(x2, y2, *t2)
    want_x = xx - a1[0] - a2[0]
    want_y = yy - a1[1] - a2[1]
    np.testing.assert_allclose(np.asarray(bx)[0], want_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(by)[0], want_y, rtol=1e-5, atol=1e-5)
    # the foreground plane must actually matter (regression against silently
    # falling back to the single-plane sum)
    a2_sp = sis64(xx, yy, *t2)
    assert np.max(np.abs(a2[0] - a2_sp[0])) > 1e-3


def test_multiplane_magnification_matches_finite_differences(coords):
    x, y = coords
    pm = PhysicalModel(
        [SIE(), SIS()], [], [], lens_redshifts=[0.4, 0.9], z_source=2.5
    )
    p = [
        dict(
            theta_E=jnp.array([1.0]),
            e1=jnp.array([0.08]),
            e2=jnp.array([-0.05]),
            center_x=jnp.array([0.0]),
            center_y=jnp.array([0.0]),
        ),
        _sis_params(0.6, -0.25, 0.2),
    ]
    sim = LensSimulator(pm, SimulatorConfig(0.1, 8), bs=1)
    f_xx, f_xy, f_yx, f_yy = jax.jit(lambda pp: sim.hessian(x, y, pp))(p)

    eps = 1e-3
    bx_px, by_px = sim.beta(x + eps, y, p)
    bx_mx, by_mx = sim.beta(x - eps, y, p)
    bx_py, by_py = sim.beta(x, y + eps, p)
    bx_my, by_my = sim.beta(x, y - eps, p)
    fd_xx = 1.0 - (np.asarray(bx_px) - np.asarray(bx_mx)) / (2 * eps)
    fd_xy = -(np.asarray(bx_py) - np.asarray(bx_my)) / (2 * eps)
    fd_yx = -(np.asarray(by_px) - np.asarray(by_mx)) / (2 * eps)
    fd_yy = 1.0 - (np.asarray(by_py) - np.asarray(by_my)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(f_xx), fd_xx, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(np.asarray(f_xy), fd_xy, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(np.asarray(f_yx), fd_yx, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(np.asarray(f_yy), fd_yy, rtol=2e-2, atol=2e-3)
    mag = np.asarray(sim.magnification(x, y, p))
    assert np.all(np.isfinite(mag))


def test_multiplane_pipeline_smoke():
    """simulate + MAP on a two-plane model through the standard stack."""
    import optax

    from gigalens_tpu.inference import ModellingSequence
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.prob import Prior
    from gigalens_tpu.prob import distributions as gld

    kern = np.exp(
        -((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0
    )
    kern = (kern / kern.sum()).astype(np.float32)
    cfg = SimulatorConfig(delta_pix=0.08, num_pix=24, supersample=2, kernel=kern)
    phys = PhysicalModel(
        [SIE(), Shear(), SIS()],
        [],
        [SersicEllipse()],
        lens_redshifts=[0.4, 0.4, 0.9],
        z_source=2.0,
    )
    prior = Prior(
        dict(
            lens_mass=[
                dict(theta_E=gld.LogNormal(np.log(0.8), 0.1),
                     e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
                     center_x=gld.Normal(0, 0.05),
                     center_y=gld.Normal(0, 0.05)),
                dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
                dict(theta_E=gld.LogNormal(np.log(0.3), 0.2),
                     center_x=gld.Normal(0.4, 0.05),
                     center_y=gld.Normal(-0.3, 0.05)),
            ],
            source_light=[
                dict(R_sersic=gld.LogNormal(np.log(0.2), 0.2),
                     n_sersic=gld.Uniform(1, 3),
                     e1=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                     e2=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                     center_x=gld.Normal(0, 0.1), center_y=gld.Normal(0, 0.1),
                     Ie=gld.LogNormal(np.log(5.0), 0.3)),
            ],
        )
    )
    truth = prior.sample(jax.random.PRNGKey(1), 1)
    sim1 = LensSimulator(phys, cfg, bs=1)
    img = np.asarray(jax.jit(sim1.simulate)(truth))
    assert np.all(np.isfinite(img)) and img.max() > 0

    obs = img + np.random.default_rng(0).normal(size=img.shape).astype(
        np.float32
    ) * 0.05
    model = ForwardProbModel(prior, obs, background_rms=0.05, exp_time=1e3)
    seq = ModellingSequence(phys, model, cfg)
    z0 = prior.unconstrain(prior.sample(jax.random.PRNGKey(2), 8))
    z = seq.MAP(optax.adam(1e-2), start=z0, n_samples=8, num_steps=5, seed=0)
    assert np.all(np.isfinite(np.asarray(z)))
    assert np.max(np.abs(np.asarray(z) - np.asarray(z0))) > 1e-4
