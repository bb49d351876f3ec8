"""HMC seed-variance probe on the published workload (GPU).

Runs MAP+SVI once, then the exact-path HMC phase at several seeds to
separate real per-gradient cost changes from ChEES/dual-averaging
adaptation noise in (eps, trajectory, min ESS).

    python scripts/bench_hmc_seeds.py [seeds ...]   # default: 2 3 4
"""
import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import dataclasses
import sys
import time

import numpy as np


def main():
    import jax

    from gigalens_tpu.utils.aot import setup_compilation_cache as _scc; _scc()
    import optax

    from __graft_entry__ import _demo_setup
    from gigalens_tpu import PhysicalModel
    from gigalens_tpu.inference import ModellingSequence
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.profiles.light.sersic import SersicEllipse
    from gigalens_tpu.profiles.mass.epl import EPL
    from gigalens_tpu.profiles.mass.shear import Shear
    from gigalens_tpu.simulator import LensSimulator
    from gigalens_tpu.utils import effective_sample_size, potential_scale_reduction

    seeds = [int(a) for a in sys.argv[1:]] or [2, 3, 4]

    prior, _, cfg, _, _ = _demo_setup(num_pix=80, bs=16, psf_size=25)
    phys = PhysicalModel([EPL(50), Shear()], [SersicEllipse()], [SersicEllipse()])
    psf_path = "/root/reference/src/gigalens/assets/psf.npy"
    if _os.path.exists(psf_path):
        cfg = dataclasses.replace(cfg, kernel=np.load(psf_path).astype(np.float32))

    truth = prior.sample(jax.random.PRNGKey(42), 1)
    sim1 = LensSimulator(phys, cfg, bs=1)
    timg = np.asarray(jax.jit(sim1.simulate)(truth))
    rng = np.random.default_rng(1)
    obs = timg + rng.normal(size=timg.shape).astype(np.float32) * np.sqrt(
        0.2**2 + np.clip(timg, 0, None) / 100.0
    )
    pm = ForwardProbModel(prior, obs, background_rms=0.2, exp_time=100.0)
    seq = ModellingSequence(phys, pm, cfg)

    t0 = time.time()
    sched = optax.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, 350)
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    z = seq.MAP(opt, n_samples=500, num_steps=350, seed=0, segment_steps=175)
    best = seq.best_map_start(z)
    sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, 300)
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    q_z, losses = seq.SVI(best, opt, n_vi=1000, num_steps=1500, seed=1,
                          segment_steps=150)
    jax.block_until_ready(losses)
    print(f"MAP+SVI: {time.time()-t0:.1f}s  elbo {float(losses[-1]):.1f}",
          flush=True)

    for seed in seeds:
        t0 = time.time()
        res = seq.HMC(q_z, n_hmc=50, num_burnin_steps=250, num_results=750,
                      max_leapfrog_steps=30, seed=seed, segment_steps=250)
        jax.block_until_ready(res.samples)
        dt = time.time() - t0
        ess = np.asarray(effective_sample_size(res.samples))
        rhat = np.asarray(potential_scale_reduction(res.samples))
        acc = float(np.asarray(res.accept_rate)[-100:].mean())
        print(
            f"seed={seed}: {dt:6.1f}s  accept {acc:.2f} "
            f"eps {float(res.step_size):.4f} traj {float(res.trajectory_length):.4f} "
            f"min ESS {ess.min():7.0f}  ESS/s {ess.min()/dt:6.1f}  "
            f"max rhat {rhat.max():.4f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
