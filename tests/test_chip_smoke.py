"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU and
outside the repo, and its pipeline and four-card phases run at a tiny size
(the rehearsals call them as functions). The card-only check carries the
``gpu`` marker and skips here."""
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_exits_nonzero_without_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=300, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_pipeline_rehearsal():
    """chip_smoke's pipeline phase at a tiny size on the CPU: every phase
    runs through ModellingSequence and every output is finite."""
    chip_smoke = _chip_smoke()
    from gigalens_tpu.parallel.mesh import default_mesh

    phases = chip_smoke.Phases(chip_smoke.CompileClock())
    out = chip_smoke.run_pipeline("tiny", default_mesh(jax.devices()[:1]),
                                  phases)
    n = chip_smoke.SIZES["tiny"]
    assert out["z_map"].shape == (n["map_n"], out["scene"].prior.d)
    assert out["hmc"].shape == (n["results"], n["hmc_n"], out["scene"].prior.d)
    assert out["smc"].shape[0] == n["smc_p"]
    assert phases.clock.total > 0.0


def test_chip_smoke_four_card_rehearsal():
    """chip_smoke's --four-cards path at a tiny size over 4 of the virtual
    CPU devices: 4-device and 1-device runs agree on per-sample log p."""
    cs = _chip_smoke()
    cs.four_cards(cs.Phases(cs.CompileClock()), size="tiny")


@pytest.mark.gpu
def test_fft_conv_on_card(gpu_device):
    """The unchunked FFT conv at bs=1200 against the direct conv on the
    card: one batched cuFFT call, no batch chunking."""
    cs = _chip_smoke()
    scene = cs.make_scene(20)
    z0 = scene.prior.unconstrain(scene.truth)
    z = z0 + 0.01 * jax.random.normal(jax.random.PRNGKey(1), (1200, z0.shape[-1]))
    cs.check_fft_conv(scene, z)
