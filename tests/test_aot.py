"""AOT export-cache tests (gigalens_tpu/utils/aot.py).

The cache's correctness contract is "a stale artifact is silently WRONG,
not slow", so these tests pin the two load-bearing properties: (1) the
data fingerprint distinguishes everything a phase program bakes in
(arrays, optimizer schedule constants hidden in closure cells), and
(2) a deserialized artifact reproduces the plain-jit results bitwise.
"""
import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from gigalens_tpu.utils import aot


@pytest.fixture(autouse=True)
def _isolated_store(tmp_path, monkeypatch):
    """Point the store tier away from the repo's aot_store/ for every test:
    a published artifact with a colliding name/key must never leak into test
    runs (tests that exercise the store override this with their own dir)."""
    monkeypatch.setenv("GIGALENS_AOT_STORE", str(tmp_path / "_no_store"))


def _mk_opt(lr, steps):
    sched = optax.polynomial_schedule(-lr, -lr / 3, 0.5, steps)
    return optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))


def test_fingerprint_sees_schedule_constants():
    # two optimizers built from identical code but different hyperparameters
    # MUST fingerprint differently: the constants live in closure cells, not
    # in package source
    a = aot.data_fingerprint(_mk_opt(1e-2, 100))
    b = aot.data_fingerprint(_mk_opt(3e-3, 100))
    c = aot.data_fingerprint(_mk_opt(1e-2, 200))
    a2 = aot.data_fingerprint(_mk_opt(1e-2, 100))
    assert a == a2
    assert a != b and a != c


def test_fingerprint_treedef_is_process_stable():
    """PyTreeDef must hash by structure, not by pointer: np.asarray on one
    yields a 0-d object array whose tobytes() is a raw per-process address
    (the bug that made every phase program miss its AOT cache every run)."""
    td1 = jax.tree_util.tree_structure({"a": [1, 2], "b": {"c": 3}})
    td2 = jax.tree_util.tree_structure({"a": [9, 9], "b": {"c": 0}})  # same
    td3 = jax.tree_util.tree_structure({"a": [1, 2, 3]})  # different
    assert aot.data_fingerprint(td1) == aot.data_fingerprint(td2)
    assert aot.data_fingerprint(td1) != aot.data_fingerprint(td3)
    # the hash must come from the structure string, not object identity
    import subprocess, sys
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.path.insert(0, %r);"
        "from gigalens_tpu.utils import aot;"
        "td = jax.tree_util.tree_structure({'a': [1, 2], 'b': {'c': 3}});"
        "print(aot.data_fingerprint(td))"
    ) % (str(__import__('pathlib').Path(__file__).resolve().parents[1]),)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == aot.data_fingerprint(td1)


def test_fingerprint_sees_array_content():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = x.copy()
    y[1, 2] += 1e-6
    assert aot.data_fingerprint(x) == aot.data_fingerprint(x.copy())
    assert aot.data_fingerprint(x) != aot.data_fingerprint(y)
    assert aot.data_fingerprint(x) != aot.data_fingerprint(x.astype(np.float64))


def test_fingerprint_object_graphs(demo_prior, demo_physmodel, small_sim_config):
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.simulator import LensSimulator

    obs = np.zeros((20, 20), np.float32)
    pm1 = ForwardProbModel(demo_prior, obs, background_rms=0.1, exp_time=100.0)
    pm2 = ForwardProbModel(demo_prior, obs + 0.1, background_rms=0.1,
                           exp_time=100.0)
    sim = LensSimulator(demo_physmodel, small_sim_config, bs=4)
    # different observed data -> different program fingerprint
    assert aot.data_fingerprint(pm1, sim) != aot.data_fingerprint(pm2, sim)
    # self-consistent
    assert aot.data_fingerprint(pm1, sim) == aot.data_fingerprint(pm1, sim)


def test_aot_program_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(aot, "cache_base", lambda: tmp_path)

    def f(x):
        return jnp.sin(x) * 2.0 + jnp.cumsum(x)

    x = jnp.arange(8, dtype=jnp.float32)
    p1 = aot.AOTProgram("t_round", f, "desc", enable=True)
    y1 = np.asarray(p1(x))
    files = list((tmp_path / "export").glob("t_round-*.jaxexport"))
    assert len(files) == 1

    # fresh AOTProgram == fresh process; exporting again would mean the
    # cache was missed, so make export itself an error
    from jax import export as jexport

    def boom(*a, **k):
        raise AssertionError("export called: disk cache was not hit")

    monkeypatch.setattr(jexport, "export", boom)
    p2 = aot.AOTProgram("t_round", f, "desc", enable=True)
    y2 = np.asarray(p2(x))
    np.testing.assert_array_equal(y1, y2)


def test_exec_tier_skips_export_load(tmp_path, monkeypatch):
    """Tier-1 serialized executables bypass even StableHLO deserialization:
    a fresh process skips tracing, lowering and the backend compile."""
    monkeypatch.setattr(aot, "cache_base", lambda: tmp_path)

    def f(x):
        return jnp.tanh(x) * 3.0

    x = jnp.arange(6, dtype=jnp.float32)
    y1 = np.asarray(aot.AOTProgram("t_exec", f, "d", enable=True)(x))
    execs = list((tmp_path / "export").glob("t_exec-*.jaxexec"))
    if not execs:  # backend without executable serialization support
        pytest.skip("serialize_executable unsupported on this backend")

    from jax import export as jexport

    def boom(*a, **k):
        raise AssertionError("export path used: exec tier was not hit")

    monkeypatch.setattr(jexport, "deserialize", boom)
    monkeypatch.setattr(jexport, "export", boom)
    p2 = aot.AOTProgram("t_exec", f, "d", enable=True)
    np.testing.assert_array_equal(y1, np.asarray(p2(x)))
    assert aot.events[-1][:2] == ("t_exec", "exec-hit")


def test_exec_tier_is_host_private(tmp_path, monkeypatch):
    """An executable written by a different host (different CPU features /
    runtime versions) must be unreachable: its filename carries the writing
    host's fingerprint, so this host's lookup never finds it and resolves
    through the portable export tier instead (round-4 crash defense)."""
    monkeypatch.setattr(aot, "cache_base", lambda: tmp_path)

    def f(x):
        return jnp.tanh(x) * 3.0

    x = jnp.arange(6, dtype=jnp.float32)
    y1 = np.asarray(aot.AOTProgram("t_host", f, "d", enable=True)(x))
    execs = list((tmp_path / "export").glob("t_host-*.jaxexec"))
    if not execs:
        pytest.skip("serialize_executable unsupported on this backend")
    assert aot.host_fingerprint() in execs[0].name
    # simulate "this process runs on a different machine"
    monkeypatch.setattr(aot, "host_fingerprint", lambda: "deadbeefdeadbeef")
    p2 = aot.AOTProgram("t_host", f, "d", enable=True)
    np.testing.assert_array_equal(y1, np.asarray(p2(x)))
    statuses = [e[1] for e in aot.events if e[0] == "t_host"]
    # resolved via the export tier (hit), not the foreign executable
    assert statuses[-1] == "hit"


def test_exec_never_loaded_from_store(tmp_path, monkeypatch):
    """.jaxexec artifacts in the git-tracked store are ignored (pickle from
    a repo is an arbitrary-code-execution vector; see _lookup)."""
    import shutil

    cache = tmp_path / "cache"
    store = tmp_path / "store"
    monkeypatch.setattr(aot, "cache_base", lambda: cache)
    monkeypatch.setenv("GIGALENS_AOT_STORE", str(store))

    def f(x):
        return x * 4.0 - 1.0

    x = jnp.ones((3,))
    y1 = np.asarray(aot.AOTProgram("t_sec", f, "d", enable=True)(x))
    execs = list((cache / "export").glob("t_sec-*.jaxexec"))
    if not execs:
        pytest.skip("serialize_executable unsupported on this backend")
    store.mkdir()
    for p in (cache / "export").glob("t_sec-*"):
        shutil.move(str(p), store / p.name)
    shutil.rmtree(cache)

    # poison-pill the store executable: if it were unpickled this would fail
    # loudly (truncated payload); the contract is it is never even read
    for p in store.glob("*.jaxexec"):
        p.write_bytes(b"not a pickle")

    p2 = aot.AOTProgram("t_sec", f, "d", enable=True)
    np.testing.assert_array_equal(y1, np.asarray(p2(x)))
    assert aot.events[-1][1] == "hit"  # export tier served it


def test_store_dir_fallback(tmp_path, monkeypatch):
    """Artifacts published to the git-tracked store are found when the
    working cache is cold (the driver's fresh-container scenario)."""
    import shutil

    cache = tmp_path / "cache"
    store = tmp_path / "store"
    monkeypatch.setattr(aot, "cache_base", lambda: cache)
    monkeypatch.setenv("GIGALENS_AOT_STORE", str(store))

    def f(x):
        return x * 2.0 + 1.0

    x = jnp.ones((5,))
    y1 = np.asarray(aot.AOTProgram("t_store", f, "d", enable=True)(x))
    # "publish": move every artifact into the store, wipe the cache
    store.mkdir()
    for p in (cache / "export").glob("t_store-*"):
        shutil.move(str(p), store / p.name)
    shutil.rmtree(cache)

    from jax import export as jexport

    def boom(*a, **k):
        raise AssertionError("re-export: store tier was not consulted")

    monkeypatch.setattr(jexport, "export", boom)
    p2 = aot.AOTProgram("t_store", f, "d", enable=True)
    np.testing.assert_array_equal(y1, np.asarray(p2(x)))
    assert aot.events[-1][1] in ("hit", "exec-hit")


def test_aot_program_key_separates_descs(tmp_path, monkeypatch):
    monkeypatch.setattr(aot, "cache_base", lambda: tmp_path)

    def f(x):
        return x + 1.0

    x = jnp.ones((4,))
    aot.AOTProgram("t_key", f, "A", enable=True)(x)
    aot.AOTProgram("t_key", f, "B", enable=True)(x)
    # different static_desc -> different artifacts (no false sharing)
    assert len(list((tmp_path / "export").glob("t_key-*.jaxexport"))) == 2
    # different arg signature re-resolves under the same program
    p = aot.AOTProgram("t_key", f, "A", enable=True)
    p(x)
    p(jnp.ones((7,)))
    assert len(list((tmp_path / "export").glob("t_key-*.jaxexport"))) == 3


def test_hmc_aot_matches_plain_jit(tmp_path, monkeypatch):
    """End-to-end: the exported+reloaded HMC program reproduces plain jit
    bitwise, including the custom pytree adaptation states (namedtuple
    registration round-trip)."""
    monkeypatch.setattr(aot, "cache_base", lambda: tmp_path)
    monkeypatch.setenv("GIGALENS_AOT_CACHE", "force")

    from gigalens_tpu.inference import hmc as hmc_mod

    def run(aot_desc):
        hmc_mod.clear_program_caches()
        z0 = jax.random.normal(jax.random.PRNGKey(0), (8, 3))
        res = hmc_mod.sample_hmc(
            lambda z: -0.5 * jnp.sum(z**2, axis=-1),
            z0,
            jax.random.PRNGKey(1),
            num_burnin_steps=25,
            num_results=25,
            trajectory_adaptation="chees",
            aot_desc=aot_desc,
        )
        return np.asarray(res.samples)

    plain = run(None)
    exported = run("gauss3")  # traces + exports + runs (plain jit this proc)
    n_files = len(list((tmp_path / "export").glob("hmc_*.jaxexport")))
    assert n_files == 2  # init + segment
    reloaded = run("gauss3")  # fresh programs -> deserializes from disk
    assert len(list((tmp_path / "export").glob("hmc_*.jaxexport"))) == n_files
    np.testing.assert_array_equal(plain, exported)
    np.testing.assert_array_equal(plain, reloaded)


@pytest.mark.parametrize("phase", ["map", "svi"])
def test_phase_aot_matches_plain_jit(tmp_path, monkeypatch, phase,
                                     demo_prior, demo_physmodel,
                                     small_sim_config):
    """MAP and SVI segment programs: forced AOT == plain jit bitwise."""
    from gigalens_tpu.inference.map import fit_map
    from gigalens_tpu.inference.svi import fit_svi
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.simulator import LensSimulator

    monkeypatch.setattr(aot, "cache_base", lambda: tmp_path)
    obs = np.zeros((20, 20), np.float32)
    prob_model = ForwardProbModel(demo_prior, obs, background_rms=0.1,
                                  exp_time=100.0)
    sim = LensSimulator(demo_physmodel, small_sim_config, bs=8)
    opt = _mk_opt(1e-2, 10)

    def run():
        if phase == "map":
            z, hist = fit_map(prob_model, sim, opt, n_samples=8, num_steps=10,
                              seed=0)
            return np.asarray(z)
        start = demo_prior.unconstrain(
            demo_prior.sample(jax.random.PRNGKey(0), 1)
        )
        q, losses = fit_svi(prob_model, sim, start, opt, n_vi=8, num_steps=10,
                            seed=0)
        return np.asarray(losses)

    monkeypatch.setenv("GIGALENS_AOT_CACHE", "0")
    plain = run()
    monkeypatch.setenv("GIGALENS_AOT_CACHE", "force")
    exported = run()
    assert list((tmp_path / "export").glob(f"{phase}_seg-*.jaxexport"))
    reloaded = run()
    np.testing.assert_array_equal(plain, exported)
    np.testing.assert_array_equal(plain, reloaded)


def test_smc_aot_matches_plain_jit(tmp_path, monkeypatch, demo_prior,
                                   demo_physmodel, small_sim_config):
    """SMC tempering + post-chain programs: forced AOT == plain jit bitwise
    (round 3: the P=1000 SMC wall was ~35% compile without this)."""
    from gigalens_tpu.inference.smc import fit_smc
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.simulator import LensSimulator

    monkeypatch.setattr(aot, "cache_base", lambda: tmp_path)
    monkeypatch.setenv("GIGALENS_AOT_CACHE", "force")
    obs = np.zeros((20, 20), np.float32)
    prob_model = ForwardProbModel(demo_prior, obs, background_rms=0.1,
                                  exp_time=100.0)
    sim = LensSimulator(demo_physmodel, small_sim_config, bs=16)

    def run(aot_desc):
        res = fit_smc(
            prob_model, sim, num_particles=16, num_ensembles=1,
            num_leapfrog_steps=3, post_sampling_steps=4, max_stage=6,
            target="pixels", auxiliar="none", seed=2, aot_desc=aot_desc,
        )
        return np.asarray(res.particles), np.asarray(res.post_samples)

    plain = run(None)
    exported = run("demo16")
    files = list((tmp_path / "export").glob("smc_*.jaxexport"))
    assert len(files) == 2  # stages + post
    reloaded = run("demo16")
    assert len(list((tmp_path / "export").glob("smc_*.jaxexport"))) == 2
    for a, b in zip(plain, exported):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(plain, reloaded):
        np.testing.assert_array_equal(a, b)
