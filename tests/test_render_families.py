"""The XLA render of every model composition against float64.

Each composition renders through ``LensSimulator._flat_light`` in float32,
and again in float64 (the same code under ``enable_x64``). The value must
match the float64 render; the float32 AD parameter gradient must match
float64 central finite differences of the float64 render. The stacked
least-squares render (one basis image per linear component) is checked the
same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import enable_x64

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.profiles.light.sersic import CoreSersic, Sersic, SersicEllipse
from gigalens_tpu.profiles.light.shapelets import Shapelets
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.nfw import NFW, NFW_ELLIPSE
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.profiles.mass.sie import SIE, SIS
from gigalens_tpu.simulator import LensSimulator

BS = 4
NPIX = 200

MODELS = {
    "epl_shear_2sersic": lambda: PhysicalModel(
        [EPL(18), Shear()], [SersicEllipse()], [SersicEllipse()]),
    "sie_sersic_shapelets": lambda: PhysicalModel(
        [SIE(), Shear()], [Sersic()], [Shapelets(4)]),
    "shapelet_source_only": lambda: PhysicalModel(
        [EPL(18), Shear()], [], [Shapelets(5)]),
    "sis_coresersic": lambda: PhysicalModel(
        [SIS()], [CoreSersic()], [SersicEllipse()]),
    "baked_constant_gamma": lambda: PhysicalModel(
        [EPL(18), Shear()], [SersicEllipse()], [SersicEllipse()],
        lenses_constants=[dict(gamma=2.0), {}]),
    "nfw_ellipse_halo": lambda: PhysicalModel(
        [NFW_ELLIPSE(), NFW(), Shear()], [], [SersicEllipse()]),
}

# float32 vs float64 of the same code: (value atol / max|ref|, gradient
# rtol). NFW's piecewise special functions lose a few more f32 digits
# than the closed forms.
TOL = {"nfw_ellipse_halo": (2e-4, 2e-2)}
DEFAULT_TOL = (2e-5, 5e-3)


def _rand_params(phys, bs, rng):
    out = {"lens_mass": [], "lens_light": [], "source_light": []}
    groups = [
        ("lens_mass", phys.lenses, phys.lenses_constants),
        ("lens_light", phys.lens_light, phys.lens_light_constants),
        ("source_light", phys.source_light, phys.source_light_constants),
    ]
    ranges = {"theta_E": (0.5, 1.5), "R_sersic": (0.5, 1.5), "beta": (0.15, 0.35),
              "e1": (-0.2, 0.2), "e2": (-0.2, 0.2), "gamma1": (-0.05, 0.05),
              "gamma2": (-0.05, 0.05), "n_sersic": (1.0, 4.0), "Rs": (5.0, 15.0),
              "alpha_Rs": (1.0, 4.0), "Rb": (0.05, 0.2), "alpha": (1.5, 3.0),
              "Ie": (50.0, 200.0)}
    for g, profs, consts in groups:
        for prof, cc in zip(profs, consts):
            d = {}
            for name in prof.params:
                if name in cc:
                    continue
                if name == "gamma" and g == "lens_mass":
                    lo, hi = 1.8, 2.2
                elif name.startswith("amp"):
                    lo, hi = -1.0, 1.0
                else:
                    lo, hi = ranges.get(name, (-0.3, 0.3))
                d[name] = rng.uniform(lo, hi, bs)
            out[g].append(d)
    return out


def _sim(phys, x, y, dtype):
    sim = LensSimulator(phys, SimulatorConfig(delta_pix=0.1, num_pix=4), bs=BS)
    sim.img_x = jnp.asarray(x, dtype)
    sim.img_y = jnp.asarray(y, dtype)
    return sim


def _cast(params, dtype):
    return jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), params)


def _setup(name):
    phys = MODELS[name]()
    rng = np.random.default_rng(0)
    params = _rand_params(phys, BS, rng)
    x = rng.uniform(-2, 2, NPIX)
    y = rng.uniform(-2, 2, NPIX)
    w = rng.normal(size=(BS, NPIX))
    return phys, params, x, y, w


def _render64(phys, params, x, y, stacked=False):
    with enable_x64():
        sim = _sim(phys, x, y, jnp.float64)
        out = sim._flat_light(_cast(params, jnp.float64),
                              stack_components=stacked)
        return np.asarray(out, np.float64)


@pytest.mark.parametrize("check", ["value", "grad"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_xla_render_matches_float64(name, check):
    phys, params, x, y, w = _setup(name)
    val_tol, grad_rtol = TOL.get(name, DEFAULT_TOL)
    sim = _sim(phys, x, y, jnp.float32)
    p32 = _cast(params, jnp.float32)
    if check == "value":
        got = np.asarray(jax.jit(sim._flat_light)(p32))
        want = _render64(phys, params, x, y)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=val_tol * np.abs(want).max())
        return

    w32 = jnp.asarray(w, jnp.float32)
    g32 = jax.jit(jax.grad(lambda p: jnp.sum(w32 * sim._flat_light(p))))(p32)
    leaves32, _ = jax.tree_util.tree_flatten(g32)
    leaves64, treedef = jax.tree_util.tree_flatten(params)

    def per_sample_loss(leaves):
        p = jax.tree_util.tree_unflatten(treedef, leaves)
        return (w * _render64(phys, p, x, y)).sum(axis=-1)  # (BS,)

    for i, (v, g) in enumerate(zip(leaves64, leaves32)):
        # samples are independent: perturbing one parameter in every sample
        # at once gives each sample's own partial derivative
        h = 1e-6 * np.maximum(np.abs(v), 1.0)
        up = list(leaves64)
        dn = list(leaves64)
        up[i], dn[i] = v + h, v - h
        fd = (per_sample_loss(up) - per_sample_loss(dn)) / (2 * h)
        scale = np.abs(fd).max() + 1e-12
        np.testing.assert_allclose(np.asarray(g), fd, rtol=grad_rtol,
                                   atol=grad_rtol * scale,
                                   err_msg=f"{name}: parameter leaf {i}")


def test_lstsq_component_stack_matches_float64():
    """The stacked least-squares render: one basis image per linear
    component, (depth, bs, npix), against float64."""
    phys = PhysicalModel(
        [EPL(18), Shear()], [SersicEllipse(use_lstsq=True)],
        [SersicEllipse(use_lstsq=True), Shapelets(3, use_lstsq=True)])
    rng = np.random.default_rng(1)
    params = _rand_params(phys, BS, rng)
    x = rng.uniform(-2, 2, NPIX)
    y = rng.uniform(-2, 2, NPIX)
    sim = _sim(phys, x, y, jnp.float32)
    got = np.asarray(jax.jit(
        lambda p: sim._flat_light(p, stack_components=True))(
            _cast(params, jnp.float32)))
    want = _render64(phys, params, x, y, stacked=True)
    assert got.shape == (sim.depth, BS, NPIX) == want.shape
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got - want) <= 2e-5 * scale)
