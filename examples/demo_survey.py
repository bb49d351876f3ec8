"""Survey-mode demo: fit a catalogue of S lens systems in single programs.

Simulates S scenes from the demo prior (EPL+Shear, SersicEllipse source),
runs the scene-batched MAP -> per-scene SVI -> grouped HMC pipeline
(``SurveySequence``, docs/survey.md), and reports per-scene reduced chi2,
step sizes, and divergences. ``--loop`` additionally fits each scene with
an individual ``ModellingSequence`` at matched budgets, to measure the
batched-vs-looped throughput ratio (the batched path amortizes the chip's
per-gradient latency floor and per-dispatch overhead across scenes).

Usage:
    python examples/demo_survey.py [--cpu] [--scenes 8] [--quick] [--loop]
"""
import argparse
import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)
import time

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="force CPU backend")
parser.add_argument("--quick", action="store_true", help="small, fast config")
parser.add_argument("--scenes", type=int, default=8)
parser.add_argument("--loop", action="store_true",
                    help="also fit scenes one-by-one for a throughput A/B")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import optax

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference import ModellingSequence, SurveySequence
from gigalens_tpu.model import ForwardProbModel, SurveyForwardProbModel
from gigalens_tpu.prob import Prior
from gigalens_tpu.prob import distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator

S = args.scenes
prior = Prior(
    dict(
        lens_mass=[
            dict(
                theta_E=gld.LogNormal(jnp.log(1.25), 0.25),
                gamma=gld.TruncatedNormal(2, 0.25, 1, 3),
                e1=gld.Normal(0, 0.1),
                e2=gld.Normal(0, 0.1),
                center_x=gld.Normal(0, 0.05),
                center_y=gld.Normal(0, 0.05),
            ),
            dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
        ],
        # lens light included: galaxy-galaxy survey cutouts have it
        lens_light=[
            dict(
                R_sersic=gld.LogNormal(jnp.log(1.0), 0.15),
                n_sersic=gld.Uniform(2, 6),
                e1=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                e2=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                center_x=gld.Normal(0, 0.05),
                center_y=gld.Normal(0, 0.05),
                Ie=gld.LogNormal(jnp.log(500.0), 0.3),
            )
        ],
        source_light=[
            dict(
                R_sersic=gld.LogNormal(jnp.log(0.25), 0.15),
                n_sersic=gld.Uniform(0.5, 4),
                e1=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                e2=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                center_x=gld.Normal(0, 0.25),
                center_y=gld.Normal(0, 0.25),
                Ie=gld.LogNormal(jnp.log(150.0), 0.5),
            )
        ],
    )
)

if args.quick:
    num_pix, supersample = 32, 1
    map_n, map_steps = 16, 200
    vi_n, vi_steps = 16, 100
    hmc_n, burnin, results = 8, 80, 150
else:
    num_pix, supersample = 60, 2
    map_n, map_steps = 32, 300
    vi_n, vi_steps = 32, 200
    hmc_n, burnin, results = 16, 150, 400

niter = EPL.recommended_niter(q_min=0.43, tol=1e-8)
phys = PhysicalModel([EPL(niter), Shear()], [SersicEllipse()], [SersicEllipse()])
cfg = SimulatorConfig(delta_pix=0.065, num_pix=num_pix, supersample=supersample)

# --- synthesize the catalogue ---------------------------------------------
truths = prior.sample(jax.random.PRNGKey(42), S)
sim_s = LensSimulator(phys, cfg, bs=S)
truth_imgs = np.asarray(jax.jit(sim_s.simulate)(truths))
rng = np.random.default_rng(1)
bkg, exp_time = 0.2, 100.0
obs = truth_imgs + rng.normal(size=truth_imgs.shape).astype(np.float32) * np.sqrt(
    bkg**2 + np.clip(truth_imgs, 0, None) / exp_time
)
print(f"catalogue: {S} scenes of {num_pix}x{num_pix} @ supersample {supersample}")

spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_time)
seq = SurveySequence(phys, spm, cfg)

# --- batched survey fit ----------------------------------------------------
t0 = time.time()
sched = optax.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, map_steps)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
z = seq.MAP(opt, n_starts=map_n, num_steps=map_steps, seed=0)
best = seq.best_per_scene(z)
jax.block_until_ready(best)
t_map = time.time() - t0

t0 = time.time()
L0 = seq.laplace_scale_trils(best)  # per-scene curvature init (host CPU)
sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, max(vi_steps // 5, 1))
opt2 = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
means, trils, losses = seq.SVI(
    best, opt2, n_vi=vi_n, num_steps=vi_steps, init_scales=L0, seed=1
)
jax.block_until_ready(losses)
t_svi = time.time() - t0

t0 = time.time()
res = seq.HMC(means, trils, n_hmc=hmc_n, num_burnin_steps=burnin,
              num_results=results, seed=2)
jax.block_until_ready(res.samples)
t_hmc = time.time() - t0

draws = seq.scene_samples(res)
post_means = jnp.stack([draws[s].mean(0) for s in range(S)])
sim_post = LensSimulator(phys, cfg, bs=S)
_, chi2 = jax.jit(lambda z: spm.log_prob(sim_post, z))(post_means)
chi2 = np.asarray(chi2)
div = np.asarray(res.divergences).reshape(S, -1).sum(1)
total = t_map + t_svi + t_hmc
print(f"survey fit: MAP {t_map:.1f}s  SVI {t_svi:.1f}s  HMC {t_hmc:.1f}s  "
      f"total {total:.1f}s  ({total / S:.2f} s/scene)")
print(f"posterior-mean reduced chi2 per scene: {np.round(chi2, 3)}")
print(f"per-scene adapted eps: {np.round(np.asarray(res.step_size), 4)}")
print(f"per-scene divergent chains-steps: {div}")
# quick mode trades convergence for speed; judge it at a looser bar
thresh = 2.0 if args.quick else 1.5
ok = (chi2 < thresh).all() and np.isfinite(np.asarray(draws)).all()
print("SURVEY DEMO", "OK" if ok else "DEGRADED")

# --- optional looped A/B ---------------------------------------------------
if args.loop:
    t0 = time.time()
    for s in range(S):
        pm = ForwardProbModel(prior, obs[s], background_rms=bkg, exp_time=exp_time)
        one = ModellingSequence(phys, pm, cfg)
        z1 = one.MAP(opt, n_samples=map_n, num_steps=map_steps, seed=0)
        b1 = one.best_map_start(z1)
        q1, _ = one.SVI(b1, opt2, n_vi=vi_n, num_steps=vi_steps, init_scales=1e-2,
                        seed=1)
        r1 = one.HMC(q1, n_hmc=hmc_n, num_burnin_steps=burnin,
                     num_results=results, seed=2)
        jax.block_until_ready(r1.samples)
    t_loop = time.time() - t0
    print(f"looped fit: {t_loop:.1f}s total ({t_loop / S:.2f} s/scene) — "
          f"batched speedup {t_loop / total:.2f}x")
