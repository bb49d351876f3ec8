"""End-to-end demo: simulate a lens, fit it, check the posterior.

The script equivalent of the reference's ``jax-demo.ipynb``: build the
canonical EPL+Shear / SersicEllipse system, generate a noisy synthetic
observation from a known truth, run MAP -> SVI -> HMC, and report
reduced-chi2 / R-hat / ESS. Runs on a GPU or the CPU (pass --cpu).

Usage:
    python examples/demo_pipeline.py [--cpu] [--quick]
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
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import optax

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference import ModellingSequence
from gigalens_tpu.model import ForwardProbModel
from gigalens_tpu.prob import Prior
from gigalens_tpu.prob import distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator
from gigalens_tpu.utils import effective_sample_size, potential_scale_reduction

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

q = args.quick
num_pix = 40 if q else 60
g = np.exp(-((np.arange(13) - 6) ** 2 + (np.arange(13)[:, None] - 6) ** 2) / 6.0)
psf = (g / g.sum()).astype(np.float32)

phys_model = PhysicalModel([EPL(30 if q else 50), Shear()],
                           [SersicEllipse()], [SersicEllipse()])
sim_config = SimulatorConfig(delta_pix=0.065, num_pix=num_pix, supersample=2, kernel=psf)

# ---- synthetic observation -------------------------------------------------
truth = prior.sample(jax.random.PRNGKey(42), 1)
sim1 = LensSimulator(phys_model, sim_config, bs=1)
truth_img = np.asarray(jax.jit(sim1.simulate)(truth))
rng = np.random.default_rng(1)
bkg, exp_time = 0.2, 100.0
observed = truth_img + rng.normal(size=truth_img.shape).astype(np.float32) * np.sqrt(
    bkg**2 + np.clip(truth_img, 0, None) / exp_time
)

prob_model = ForwardProbModel(prior, observed, background_rms=bkg, exp_time=exp_time)
seq = ModellingSequence(phys_model, prob_model, sim_config)

# ---- MAP --------------------------------------------------------------------
n_map, s_map = (50, 120) if q else (500, 350)
t0 = time.time()
sched = optax.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, s_map)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
z_map = seq.MAP(opt, n_samples=n_map, num_steps=s_map, seed=0,
                segment_steps=max(s_map // 4, 1),
                progress=lambda st, c: print(f"  MAP step {st}: min chi2 {c:.3f}"))
sim_b = LensSimulator(phys_model, sim_config, bs=z_map.shape[0])
lps, chi2 = jax.jit(lambda z: prob_model.log_prob(sim_b, z))(z_map)
print(f"MAP   {time.time()-t0:6.1f}s  best reduced chi2 = {float(jnp.nanmin(chi2)):.3f}")

# ---- SVI --------------------------------------------------------------------
n_vi, s_vi = (64, 200) if q else (1000, 1500)
t0 = time.time()
best = seq.best_map_start(z_map)
sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, s_vi // 5)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
q_z, elbo_hist = seq.SVI(best, opt, n_vi=n_vi, num_steps=s_vi, seed=1,
                         segment_steps=max(s_vi // 4, 1),
                         progress=lambda st, l: print(f"  SVI step {st}: -ELBO {l:.1f}"))
print(f"SVI   {time.time()-t0:6.1f}s  ELBO {float(elbo_hist[0]):.1f} -> {float(elbo_hist[-1]):.1f}")

# ---- HMC --------------------------------------------------------------------
n_hmc, burn, res_n = (10, 50, 100) if q else (50, 250, 750)
t0 = time.time()
res = seq.HMC(q_z, n_hmc=n_hmc, num_burnin_steps=burn, num_results=res_n, seed=2,
              segment_steps=max((burn + res_n) // 4, 1),
              progress=lambda st, a: print(f"  HMC step {st}: accept {a:.2f}"))
t_hmc = time.time() - t0
rhat = np.asarray(potential_scale_reduction(res.samples))
ess = np.asarray(effective_sample_size(res.samples))
print(
    f"HMC   {t_hmc:6.1f}s  accept {float(np.asarray(res.accept_rate)[-50:].mean()):.2f}"
    f"  max R-hat {rhat.max():.3f}  min ESS {ess.min():.0f} ({ess.min()/t_hmc:.1f}/s)"
)

# ---- posterior check vs truth ------------------------------------------------
sim_p = LensSimulator(phys_model, sim_config, bs=res.samples.shape[1])
_, chi2_post = jax.jit(lambda z: prob_model.log_prob(sim_p, z))(res.samples[-1])
print(f"posterior mean reduced chi2 = {float(jnp.mean(chi2_post)):.3f} (expect ~1)")

names = prior.column_names()
post = np.asarray(res.samples).reshape(-1, prior.d)
z_true = np.asarray(prior.unconstrain(truth))[0]
print("\nparameter            truth    post mean   post std   z-score")
for i, n in enumerate(names):
    m, s = post[:, i].mean(), post[:, i].std()
    print(f"{n:22s} {z_true[i]:8.3f} {m:10.3f} {s:10.3f} {abs(m-z_true[i])/max(s,1e-6):8.2f}")

from gigalens_tpu.utils import format_summary, summarize_posterior

print("\nphysical-space posterior summary:")
print(format_summary(summarize_posterior(prior, res.samples,
                                         divergences=res.divergences)))
