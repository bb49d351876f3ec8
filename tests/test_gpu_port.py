"""The GPU port's contracts that the CPU can check.

Compile-cache placement, the PSF path choice, the unchunked FFT
convolution, the fully unrolled EPL series, the benchmark's peak table and
failure exit, and explicit matmul precision in the inference drivers.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _gauss(size, sigma):
    c = np.arange(size) - size // 2
    g = np.exp(-(c[:, None] ** 2 + c[None, :] ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _eqns(jaxpr, name, out):
    """Every equation of primitive ``name`` in ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == name:
            out.append(eqn)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    _eqns(sub.jaxpr, name, out)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    _eqns(sub, name, out)
    return out


def _python(code, env_extra=None, cwd=None, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env,
                          cwd=cwd or ROOT)


_CACHE_PROBE = """
import pathlib, sys
import jax, jax.numpy as jnp
from gigalens_tpu.utils import aot
aot.cache_base = lambda: pathlib.Path({base!r})
path = aot.setup_compilation_cache()
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_placement(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and nowhere
    else; unset, it goes to <checkout>/.jax_cache/xla."""
    base = tmp_path / "checkout_cache"
    env_dir = tmp_path / "from_env"
    out = _python(_CACHE_PROBE.format(base=str(base)),
                  {"JAX_COMPILATION_CACHE_DIR": str(env_dir)} if env_set else None)
    assert out.returncode == 0, out.stderr
    path, config_dir = out.stdout.split()
    want = env_dir if env_set else base / "xla"
    assert pathlib.Path(path) == want
    assert pathlib.Path(config_dir) == want
    assert want.is_dir() and any(want.iterdir())
    other = base / "xla" if env_set else env_dir
    assert not other.exists()


def test_default_cache_dir_is_checkout_path():
    from gigalens_tpu.utils import aot

    assert aot.cache_base() == ROOT / ".jax_cache"


@pytest.fixture(scope="module")
def epl_phys():
    return PhysicalModel([EPL(12), Shear()], [SersicEllipse()], [SersicEllipse()])


@pytest.mark.parametrize("backend", ["cpu", "gpu", "unknown"])
def test_psf_auto_mode_is_fft_on_every_backend(monkeypatch, epl_phys, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=12, supersample=2,
                          kernel=_gauss(9, 1.5))
    assert LensSimulator(epl_phys, cfg, bs=2)._conv.mode == "fft"
    # tiny kernels keep the direct conv
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=12, kernel=_gauss(3, 0.8))
    assert LensSimulator(epl_phys, cfg, bs=2)._conv.mode == "direct"


def test_unchunked_fft_conv_matches_direct():
    """bs=1200 goes through one batched FFT (no batch chunking) and agrees
    with the direct conv at Precision.HIGHEST."""
    from gigalens_tpu.ops.psf import PSFConv

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((1200, 20, 20)).astype(np.float32))
    kern = _gauss(7, 1.3)
    fft = PSFConv(kern, (20, 20), mode="fft")
    ffts = _eqns(jax.make_jaxpr(fft)(x).jaxpr, "fft", [])
    assert len(ffts) == 2 and ffts[0].invars[0].aval.shape[0] == 1200
    got = np.asarray(jax.jit(fft)(x))
    want = np.asarray(jax.jit(PSFConv(kern, (20, 20), mode="direct"))(x))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_unchunked_per_scene_fft_conv_matches_direct():
    """Per-scene PSF stacks (survey mode): each scene's whole sample block
    goes through one FFT (no sub-chunks) and matches that scene's direct
    conv."""
    from gigalens_tpu.ops.psf import PSFConv

    S, K = 3, 600
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.random((S * K, 16, 16)).astype(np.float32))
    kerns = np.stack([_gauss(7, s) for s in (0.9, 1.3, 1.7)])
    conv = PSFConv(kerns, (16, 16), mode="fft")
    ffts = _eqns(jax.make_jaxpr(conv)(x).jaxpr, "fft", [])
    assert len(ffts) == 2 * S
    assert {e.invars[0].aval.shape[0] for e in ffts} == {K}
    got = np.asarray(jax.jit(conv)(x))
    for s in range(S):
        want = np.asarray(PSFConv(kerns[s], (16, 16), mode="direct")(
            x[s * K:(s + 1) * K]))
        assert np.abs(got[s * K:(s + 1) * K] - want).max() <= (
            1e-5 * np.abs(want).max())


@pytest.mark.parametrize("check", ["value", "grad"])
def test_epl_series_unroll_matches_rolled_loop(monkeypatch, check):
    """The fully unrolled series loops compute what the rolled loops do:
    the EPL deflection and its parameter gradient agree to f32 rounding."""
    from gigalens_tpu.profiles.mass import epl

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.uniform(-2, 2, (1, 300)), jnp.float32)
    y = jnp.asarray(rng.uniform(-2, 2, (1, 300)), jnp.float32)
    p = dict(theta_E=jnp.full((4, 1), 1.2), gamma=jnp.asarray([[1.8], [2.0], [2.1], [2.3]]),
             e1=jnp.asarray([[0.1], [-0.2], [0.0], [0.3]]),
             e2=jnp.asarray([[0.05], [0.1], [-0.25], [0.0]]),
             center_x=jnp.full((4, 1), 0.05), center_y=jnp.full((4, 1), -0.03))
    w = jnp.asarray(rng.normal(size=(2, 4, 300)), jnp.float32)

    def run():
        prof = epl.EPL(23)
        if check == "value":
            return jax.jit(lambda pp: jnp.stack(prof.deriv(x, y, **pp)))(p)
        return jax.jit(jax.grad(lambda pp: jnp.sum(
            w * jnp.stack(prof.deriv(x, y, **pp)))))(p)

    unrolled = run()
    monkeypatch.setattr(epl, "_UNROLL", 1)
    rolled = run()
    for a, b in zip(jax.tree_util.tree_leaves(unrolled),
                    jax.tree_util.tree_leaves(rolled)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def _bench():
    sys.path.insert(0, str(ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(ROOT))
    return bench


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_peak_table_raises_on_unknown_device():
    bench = _bench()
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks_for("cpu")
    for kind, row in bench.PEAKS.items():
        assert bench.peaks_for(kind) is row
        assert row["source"] and row["f32"] < row["tf32"] < row["bf16"]


def test_bench_run_phase_records_failure():
    bench = _bench()
    bench.failures.clear()
    try:
        assert bench.run_phase("ok", lambda: 3) == 3
        assert bench.run_phase("boom", lambda: 1 / 0) is None
        assert [f["phase"] for f in bench.failures] == ["boom"]
        assert "ZeroDivisionError" in bench.failures[0]["error"]
    finally:
        bench.failures.clear()


def test_bench_exits_nonzero_without_a_known_device():
    """On a device missing from the peak table (here the CPU) the benchmark
    prints a partial JSON line marked incomplete and exits non-zero."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["complete"] is False and row["value"] is None
    assert "no published peaks" in row["failed_phases"][-1]["error"]


def test_leapfrog_dot_generals_use_highest_precision():
    """Every d x d product of an HMC step (momentum draw, kinetic energy,
    leapfrog drift, ChEES velocity, mass adaptation) asks for
    Precision.HIGHEST, so a GPU never runs them in TF32."""
    from gigalens_tpu.inference.hmc import _hmc_programs

    d, n = 5, 8
    init, run = _hmc_programs(
        lambda z: -0.5 * jnp.sum(z**2, axis=-1), n, d, 0.1, 3, 20, (10,),
        True, True, 0.75, "mean", 5, 0.025, None)
    carry = init(jnp.zeros((n, d)), jnp.eye(d)[None])
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jaxpr = jax.make_jaxpr(run)(carry, keys, jnp.ones(4))
    dots = _eqns(jaxpr.jaxpr, "dot_general", [])
    assert len(dots) >= 5
    hi = jax.lax.Precision.HIGHEST
    for eqn in dots:
        assert eqn.params["precision"] == (hi, hi), eqn


def _jitted_dot_generals(monkeypatch, run):
    """Runs ``run()`` with ``jax.jit`` spied on: every program it jits is
    also traced at its call, and the dot_generals of all those jaxprs are
    returned."""
    real_jit, dots = jax.jit, []

    def spy(fn=None, **kw):
        if fn is None:
            return lambda f: spy(f, **kw)
        jitted = real_jit(fn, **kw)
        static = kw.get("static_argnums", ())

        def call(*args, **kwargs):
            jaxpr = jax.make_jaxpr(fn, static_argnums=static)(*args, **kwargs)
            _eqns(jaxpr.jaxpr, "dot_general", dots)
            return jitted(*args, **kwargs)

        return call

    monkeypatch.setattr(jax, "jit", spy)
    run()
    monkeypatch.setattr(jax, "jit", real_jit)
    return dots


@pytest.mark.parametrize("phase", ["svi", "smc", "laplace"])
def test_driver_dot_generals_use_highest_precision(monkeypatch, phase):
    """The d x d products of the SVI surrogate draw, the SMC move
    preconditioner and the Laplace covariance ask for Precision.HIGHEST in
    every program the phase compiles."""
    import optax

    from gigalens_tpu.inference import ModellingSequence

    scene = _chip_smoke().make_scene(8)
    seq = ModellingSequence(scene.phys, scene.prob_model, scene.cfg)
    z = scene.prior.unconstrain(scene.prior.sample(jax.random.PRNGKey(0), 1))
    run = {
        "svi": lambda: seq.SVI(z, optax.adam(1e-3), n_vi=4, num_steps=2),
        "smc": lambda: seq.SMC(num_particles=8, num_leapfrog_steps=2,
                               post_sampling_steps=1, max_stage=2, seed=0),
        "laplace": lambda: seq.laplace_scale_tril(z),
    }[phase]
    dots = _jitted_dot_generals(monkeypatch, run)
    assert dots
    hi = jax.lax.Precision.HIGHEST
    for eqn in dots:
        assert eqn.params["precision"] == (hi, hi), eqn
