"""Step-size-collapse A/B: multi-window mass adaptation as the rescue.

Reproduces the collapse observed in the survey demo at quick budgets with an
isotropic SVI init (scene 2: adapted eps 0.0038, posterior chi2 2.7 — the
same failure class as a cap-60 trajectory-budget seed seen earlier) and
measures whether extra Stan-style warmup windows (``mass_adaptation=k``)
recover it. Run on CPU or GPU:

    python scripts/bench_collapse_windows.py [--cpu] [--windows 1 2 3]
"""
import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax

import os
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)
from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference import SurveySequence
from gigalens_tpu.model import SurveyForwardProbModel
from gigalens_tpu.prob import Prior
from gigalens_tpu.prob import distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator

parser = argparse.ArgumentParser()
parser.add_argument("--windows", type=int, nargs="+", default=[1, 2, 3])
parser.add_argument("--cpu", action="store_true", help="force CPU backend")
args = parser.parse_args()

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

prior = Prior(
    dict(
        lens_mass=[
            dict(theta_E=gld.LogNormal(jnp.log(1.25), 0.25),
                 gamma=gld.TruncatedNormal(2, 0.25, 1, 3),
                 e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
                 center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05)),
            dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
        ],
        source_light=[
            dict(R_sersic=gld.LogNormal(jnp.log(0.25), 0.15),
                 n_sersic=gld.Uniform(0.5, 4),
                 e1=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 e2=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 center_x=gld.Normal(0, 0.25), center_y=gld.Normal(0, 0.25),
                 Ie=gld.LogNormal(jnp.log(150.0), 0.5))
        ],
    )
)
phys = PhysicalModel([EPL(23), Shear()], [], [SersicEllipse()])
cfg = SimulatorConfig(delta_pix=0.065, num_pix=32, supersample=1)
S = 4
truths = prior.sample(jax.random.PRNGKey(42), S)
sim_s = LensSimulator(phys, cfg, bs=S)
imgs = np.asarray(jax.jit(sim_s.simulate)(truths))
rng = np.random.default_rng(1)
bkg, exp_time = 0.2, 100.0
obs = imgs + rng.normal(size=imgs.shape).astype(np.float32) * np.sqrt(
    bkg**2 + np.clip(imgs, 0, None) / exp_time
)
spm = SurveyForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_time)
seq = SurveySequence(phys, spm, cfg)
sched = optax.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, 100)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
z = seq.MAP(opt, n_starts=8, num_steps=100, seed=0)
best = seq.best_per_scene(z)
sched2 = optax.polynomial_schedule(-1e-6, -3e-3, 2, 12)
opt2 = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched2))
# deliberately WEAK isotropic init (the collapse trigger) — not Laplace
means, trils, _ = seq.SVI(best, opt2, n_vi=8, num_steps=60,
                          init_scales=1e-2, seed=1)

for w in args.windows:
    res = seq.HMC(means, trils, n_hmc=8, num_burnin_steps=50,
                  num_results=100, seed=2, mass_adaptation=w)
    draws = seq.scene_samples(res)
    pm = jnp.stack([draws[s].mean(0) for s in range(S)])
    _, chi2 = jax.jit(lambda zz: spm.log_prob(sim_s, zz))(pm)
    print(f"windows={w}: eps={np.round(np.asarray(res.step_size), 4)} "
          f"chi2={np.round(np.asarray(chi2), 3)} "
          f"div={np.asarray(res.divergences).reshape(S, -1).sum(1)}")
