#!/usr/bin/env python3
"""Smoke run of the MAP -> Laplace -> SVI -> HMC / SMC pipeline on one GPU.

    python chip_smoke.py               # one card: the pipeline and the checks
    python chip_smoke.py --four-cards  # only the sample-sharded path, 4 vs 1

Drives ``ModellingSequence`` once at the published GIGA-Lens width
(EPL + Shear lens, SersicEllipse lens light and source, 80x80 px at 0.065",
supersample 2 = 25,600 supersampled pixels, 25x25 PSF made from a seed) with
only a few steps per phase, then compares the unchunked FFT PSF convolution
with the direct convolution on the card. Any failed check
or phase exits non-zero. Without a GPU it exits non-zero before any phase:
there is no CPU fallback. Every result line carries the card's name and
power limit as ``nvidia-smi`` reports them. The last line of standard
output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# sizes: "full" is the published workload's width with few steps per phase;
# "tiny" is the CPU rehearsal of the same code path
SIZES = {
    "full": dict(num_pix=80, map_n=500, map_steps=20, vi_n=1000, vi_steps=20,
                 hmc_n=50, burnin=20, results=20, smc_p=1000, smc_stages=2,
                 smc_post=5, smc_leapfrog=5),
    "tiny": dict(num_pix=10, map_n=8, map_steps=3, vi_n=8, vi_steps=3,
                 hmc_n=4, burnin=2, results=2, smc_p=8, smc_stages=2,
                 smc_post=2, smc_leapfrog=2),
}
DELTA_PIX, SUPERSAMPLE = 0.065, 2
BKG_RMS, EXP_TIME = 0.2, 100.0

FFT_CONV_TOL = 1e-5      # max |delta| / max |image|, FFT vs direct conv
# 4 cards vs 1 card: the same program with another reduction order
SHARD_LOGP_RTOL = 1e-5   # |delta log p| <= SHARD_LOGP_RTOL * max(|log p|, 1)


class Tag:
    """Card name and power limit, printed beside every number."""

    text = "[no card]"


def say(msg):
    print(f"{Tag.text} {msg}", flush=True)


def card_info() -> str:
    """``nvidia-smi``'s name and power limit, one ``; ``-joined entry per
    card, so that the tag stays on one line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


class CompileClock:
    """Seconds JAX spent lowering jaxprs and compiling them with XLA, from
    its own monitoring events (tracing is left out: its events nest)."""

    EVENTS = (
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


class Phases:
    """Runs named phases, printing each one's wall and compile time."""

    def __init__(self, clock):
        self.clock = clock

    def run(self, name, fn):
        import jax

        c0, t0 = self.clock.total, time.perf_counter()
        out = fn()
        jax.block_until_ready([x for x in jax.tree_util.tree_leaves(out)
                               if isinstance(x, jax.Array)])
        wall = time.perf_counter() - t0
        say(f"phase {name}: wall {wall:.3f} s, compile {self.clock.total - c0:.3f} s")
        return out


def make_psf(seed: int, size: int = 25) -> np.ndarray:
    """A seeded elliptical Moffat PSF (HST-like core and wings), unit sum."""
    rng = np.random.default_rng(seed)
    fwhm = rng.uniform(2.0, 2.6)  # native pixels
    q, phi = rng.uniform(0.85, 1.0), rng.uniform(0, np.pi)
    beta = 3.0
    alpha = fwhm / (2 * np.sqrt(2 ** (1 / beta) - 1))
    c = np.arange(size) - size // 2
    X, Y = np.meshgrid(c, c)
    xr = X * np.cos(phi) + Y * np.sin(phi)
    yr = -X * np.sin(phi) + Y * np.cos(phi)
    r2 = xr**2 * q + yr**2 / q
    psf = (1 + r2 / alpha**2) ** (-beta)
    return (psf / psf.sum()).astype(np.float32)


def demo_prior():
    """The reference demo's EPL+Shear / SersicEllipse prior."""
    import jax.numpy as jnp

    from gigalens_tpu.prob import Prior
    from gigalens_tpu.prob import distributions as gld

    return Prior(dict(
        lens_mass=[
            dict(theta_E=gld.LogNormal(jnp.log(1.25), 0.25),
                 gamma=gld.TruncatedNormal(2, 0.25, 1, 3),
                 e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
                 center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05)),
            dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
        ],
        lens_light=[
            dict(R_sersic=gld.LogNormal(jnp.log(1.0), 0.15),
                 n_sersic=gld.Uniform(2, 6),
                 e1=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 e2=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05),
                 Ie=gld.LogNormal(jnp.log(500.0), 0.3)),
        ],
        source_light=[
            dict(R_sersic=gld.LogNormal(jnp.log(0.25), 0.15),
                 n_sersic=gld.Uniform(0.5, 4),
                 e1=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 e2=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 center_x=gld.Normal(0, 0.25), center_y=gld.Normal(0, 0.25),
                 Ie=gld.LogNormal(jnp.log(150.0), 0.5)),
        ],
    ))


@dataclasses.dataclass
class Scene:
    phys: object
    prior: object
    cfg: object
    prob_model: object
    truth: dict


def make_scene(num_pix: int, seed: int = 0, n_scenes: int = 0) -> Scene:
    """Seeded truth and noisy observation; ``n_scenes > 0`` makes a survey
    catalogue of that many scenes instead of one."""
    import jax

    from gigalens_tpu import PhysicalModel, SimulatorConfig
    from gigalens_tpu.model import ForwardProbModel, SurveyForwardProbModel
    from gigalens_tpu.profiles.light.sersic import SersicEllipse
    from gigalens_tpu.profiles.mass.epl import EPL
    from gigalens_tpu.profiles.mass.shear import Shear
    from gigalens_tpu.simulator import LensSimulator

    prior = demo_prior()
    niter = EPL.recommended_niter(q_min=0.43, tol=1e-8)
    phys = PhysicalModel([EPL(niter), Shear()], [SersicEllipse()],
                         [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=DELTA_PIX, num_pix=num_pix,
                          supersample=SUPERSAMPLE, kernel=make_psf(seed + 7))
    n = max(n_scenes, 1)
    truth = prior.sample(jax.random.PRNGKey(seed + 42), n)
    sim = LensSimulator(phys, cfg, bs=n)
    img = np.asarray(jax.jit(sim.simulate)(truth)).reshape(n, num_pix, num_pix)
    rng = np.random.default_rng(seed + 1)
    obs = img + rng.normal(size=img.shape).astype(np.float32) * np.sqrt(
        BKG_RMS**2 + np.clip(img, 0, None) / EXP_TIME)
    if n_scenes:
        pm = SurveyForwardProbModel(prior, obs, background_rms=BKG_RMS,
                                    exp_time=EXP_TIME)
    else:
        pm = ForwardProbModel(prior, obs[0], background_rms=BKG_RMS,
                              exp_time=EXP_TIME)
    return Scene(phys, prior, cfg, pm, truth)


def _adam(lr, steps):
    import optax

    sched = optax.polynomial_schedule(-lr, -lr / 3, 0.5, steps)
    return optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))


def _svi_opt(steps):
    import optax

    sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, max(steps // 5, 1))
    return optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))


def run_pipeline(size: str, mesh, phases) -> dict:
    """MAP -> Laplace -> SVI -> HMC, then SMC, through ``ModellingSequence``.

    Returns the phase outputs; raises if any output is not finite."""
    import jax
    import jax.numpy as jnp

    from gigalens_tpu.inference import ModellingSequence
    from gigalens_tpu.simulator import LensSimulator

    n = SIZES[size]
    scene = phases.run("setup", lambda: make_scene(n["num_pix"]))
    seq = ModellingSequence(scene.phys, scene.prob_model, scene.cfg, mesh=mesh)

    z_map = phases.run("MAP", lambda: seq.MAP(
        _adam(1e-2, n["map_steps"]), n_samples=n["map_n"],
        num_steps=n["map_steps"], seed=0))
    best = phases.run("best_map_start", lambda: seq.best_map_start(z_map))
    L0 = phases.run("Laplace", lambda: seq.laplace_scale_tril(best, method="fd"))
    q_z, losses = phases.run("SVI", lambda: seq.SVI(
        best, _svi_opt(n["vi_steps"]), n_vi=n["vi_n"],
        num_steps=n["vi_steps"], init_scales=np.asarray(L0), seed=1))
    hmc = phases.run("HMC", lambda: seq.HMC(
        q_z, n_hmc=n["hmc_n"], num_burnin_steps=n["burnin"],
        num_results=n["results"], seed=2))
    smc = phases.run("SMC", lambda: seq.SMC(
        num_particles=n["smc_p"], num_leapfrog_steps=n["smc_leapfrog"],
        post_sampling_steps=n["smc_post"], max_stage=n["smc_stages"],
        seed=3))

    post = hmc.samples[-1]
    sim_p = LensSimulator(scene.phys, scene.cfg, bs=post.shape[0])
    _, chi2 = jax.jit(lambda z: scene.prob_model.log_prob(sim_p, z))(post)
    out = dict(z_map=z_map, best=best, laplace=L0, q_mean=q_z.loc,
               q_tril=q_z.scale_tril, svi_loss=losses, hmc=hmc.samples,
               hmc_accept=hmc.accept_rate, smc=smc.particles,
               smc_beta=smc.final_beta, post_chi2=chi2)
    for k, v in out.items():
        if not np.isfinite(np.asarray(v)).all():
            raise FloatingPointError(f"pipeline output {k} is not finite")
    say(f"MAP best reduced chi2 ({n['map_n']} starts x {n['map_steps']} steps): "
        f"{float(jnp.nanmin(seq.prob_model.log_prob(seq._sim(n['map_n']), z_map)[1])):.4f}")
    say(f"SVI ELBO loss {float(losses[0]):.2f} -> {float(losses[-1]):.2f}")
    say(f"HMC accept (last step) {float(hmc.accept_rate[-1]):.4f}, "
        f"step size {float(hmc.step_size):.5f}, leapfrogs {int(hmc.total_leapfrogs)}")
    say(f"SMC stages {int(smc.num_stages)}, final beta {float(smc.final_beta[0]):.6f}")
    say(f"posterior reduced chi2 (mean over {post.shape[0]} chains): "
        f"{float(jnp.mean(chi2)):.4f}")
    out.update(scene=scene, q_z=q_z)
    return out


def check_fft_conv(scene, z) -> None:
    """The unchunked FFT PSF convolution at the SVI batch vs direct
    ``lax.conv`` at Precision.HIGHEST, on the supersampled renders."""
    import jax

    from gigalens_tpu.ops.psf import PSFConv, subgrid_kernel
    from gigalens_tpu.simulator import LensSimulator

    bs = z.shape[0]
    sim = LensSimulator(scene.phys, scene.cfg, bs=bs)
    imgs = jax.jit(lambda zz: sim._place(sim._flat_light(
        scene.prior.constrain(zz))))(z)
    kern = subgrid_kernel(np.asarray(scene.cfg.kernel), SUPERSAMPLE, odd=True)
    shape = (sim.h_ss, sim.w_ss)
    fft = np.asarray(jax.jit(PSFConv(kern, shape, mode="fft"))(imgs))
    direct = np.asarray(jax.jit(PSFConv(kern, shape, mode="direct"))(imgs))
    err = np.abs(fft - direct).max() / np.abs(direct).max()
    say(f"FFT conv vs direct conv bs={bs} ({shape[0]}x{shape[1]}, kernel "
        f"{kern.shape[0]}x{kern.shape[1]}): max|d|/max|img| {err:.3e} "
        f"(limit {FFT_CONV_TOL:g})")
    if not (np.isfinite(fft).all() and err <= FFT_CONV_TOL):
        raise AssertionError("FFT conv disagrees with direct conv")


def svi_memory(scene, bs: int) -> None:
    """Compiled memory of the SVI step's likelihood value-and-grad."""
    import jax
    import jax.numpy as jnp

    from gigalens_tpu.simulator import LensSimulator

    sim = LensSimulator(scene.phys, scene.cfg, bs=bs)
    z = jnp.zeros((bs, scene.prior.d))
    vg = jax.jit(jax.value_and_grad(
        lambda zz: jnp.sum(scene.prob_model.log_prob(sim, zz)[0])))
    say(f"SVI step value+grad bs={bs} memory_analysis: "
        f"{vg.lower(z).compile().memory_analysis()}")


def one_card(phases) -> None:
    import jax

    from gigalens_tpu.parallel.mesh import default_mesh

    mesh = default_mesh(jax.devices()[:1])
    out = run_pipeline("full", mesh, phases)
    scene = out["scene"]
    z_vi = out["q_z"].sample(jax.random.PRNGKey(11), (SIZES["full"]["vi_n"],))
    svi_memory(scene, SIZES["full"]["vi_n"])
    phases.run("FFT conv check", lambda: check_fft_conv(scene, z_vi))
    dev = jax.devices()[0]
    say(f"peak_bytes_in_use {dev.memory_stats()['peak_bytes_in_use']}")


def sharded_run(scene, mesh, n) -> dict:
    """MAP, SVI and HMC over ``mesh`` with fixed seeds."""
    from gigalens_tpu.inference import ModellingSequence

    seq = ModellingSequence(scene.phys, scene.prob_model, scene.cfg, mesh=mesh)
    z_map = seq.MAP(_adam(1e-2, n["map_steps"]), n_samples=n["map_n"],
                    num_steps=n["map_steps"], seed=0)
    best = seq.best_map_start(z_map)
    q_z, _ = seq.SVI(best, _svi_opt(n["vi_steps"]), n_vi=n["vi_n"],
                     num_steps=n["vi_steps"], init_scales=1e-2, seed=1)
    hmc = seq.HMC(q_z, n_hmc=n["hmc_n"], num_burnin_steps=n["burnin"],
                  num_results=n["results"], seed=2)
    return dict(z_map=z_map, hmc=hmc)


def _sharded_log_prob(scene, mesh, z):
    import jax

    from gigalens_tpu.parallel import mesh as pmesh
    from gigalens_tpu.simulator import LensSimulator

    sim = LensSimulator(scene.phys, scene.cfg, bs=z.shape[0])
    zs = pmesh.shard_samples(np.asarray(z), mesh)
    return np.asarray(jax.jit(lambda zz: scene.prob_model.log_prob(sim, zz)[0])(zs))


def _compare_logp(label, lp4, lp1):
    err = np.abs(lp4 - lp1) / np.maximum(np.abs(lp1), 1.0)
    say(f"4 vs 1 cards, {label}: per-sample log p max rel |d| {err.max():.3e} "
        f"(limit {SHARD_LOGP_RTOL:g}) over {lp1.shape[0]} samples")
    if not (np.isfinite(lp4).all() and err.max() <= SHARD_LOGP_RTOL):
        raise AssertionError(f"4-card log p differs from 1-card ({label})")


def four_cards(phases, size: str = "full") -> None:
    """The sample-sharded path over a 4-card ``samples`` mesh, against the
    same seeds on a 1-card mesh."""
    import jax
    import jax.numpy as jnp

    from gigalens_tpu.inference import SurveySequence
    from gigalens_tpu.parallel.mesh import default_mesh

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(jax.devices())}")
    n = dict(SIZES[size], map_steps=5, vi_steps=5, burnin=3, results=3)
    if size == "full":
        n["hmc_n"] = 48
    mesh4, mesh1 = default_mesh(jax.devices()[:4]), default_mesh(jax.devices()[:1])
    scene = make_scene(n["num_pix"])
    r4 = phases.run("4 cards MAP+SVI+HMC", lambda: sharded_run(scene, mesh4, n))
    r1 = phases.run("1 card MAP+SVI+HMC", lambda: sharded_run(scene, mesh1, n))
    for k, r in (("4 cards", r4), ("1 card", r1)):
        if not np.isfinite(np.asarray(r["hmc"].samples)).all():
            raise FloatingPointError(f"{k} HMC samples not finite")
    # identical inputs: the 1-card run's MAP batch and HMC states
    for label, z in (("MAP batch", r1["z_map"]),
                     ("HMC chains", r1["hmc"].final_state)):
        _compare_logp(label, _sharded_log_prob(scene, mesh4, z),
                      _sharded_log_prob(scene, mesh1, z))

    survey = make_scene(n["num_pix"], seed=3, n_scenes=4)

    def survey_fit(mesh):
        seq = SurveySequence(survey.phys, survey.prob_model, survey.cfg, mesh=mesh)
        z = seq.MAP(_adam(1e-2, n["map_steps"]), n_starts=8,
                    num_steps=n["map_steps"], seed=0)
        best = seq.best_per_scene(z)
        d = best.shape[-1]
        trils = jnp.broadcast_to(1e-2 * jnp.eye(d), (4, d, d))
        res = seq.HMC(best, trils, n_hmc=8, num_burnin_steps=n["burnin"],
                      num_results=n["results"], seed=2)
        return z, res

    _, s4 = phases.run("survey 4 scenes, 4 cards", lambda: survey_fit(mesh4))
    z1, s1 = phases.run("survey 4 scenes, 1 card", lambda: survey_fit(mesh1))
    if not (np.isfinite(np.asarray(s4.samples)).all()
            and np.isfinite(np.asarray(s1.samples)).all()):
        raise FloatingPointError("survey HMC samples not finite")
    _compare_logp("survey MAP batch", _sharded_log_prob(survey, mesh4, z1),
                  _sharded_log_prob(survey, mesh1, z1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sample-sharded path and its "
                         "1-card comparison")
    args = ap.parse_args(argv)

    import jax

    from gigalens_tpu.utils.aot import setup_compilation_cache

    setup_compilation_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "nothing runs without one", file=sys.stderr)
        return 1
    Tag.text = f"[{card_info()}]"
    say(f"card (nvidia-smi name, power.limit): {Tag.text[1:-1]}")
    say(f"devices: {len(devices)} x {devices[0].device_kind}")
    phases = Phases(CompileClock())
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(phases)
        count = 4
    else:
        one_card(phases)
        count = 1
    say(f"total wall {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
