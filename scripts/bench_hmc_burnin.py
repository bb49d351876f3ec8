"""HMC burn-in budget on the published workload (GPU).

Burn-in (250 steps) is 25% of the chain; with the Laplace-seeded SVI
surrogate the starting preconditioner is already good, so the windowed mass
re-estimation may converge in a shorter window. Runs fused 50x750 at
burnin in {250, 150, 100} x 3 seeds.

    python scripts/bench_hmc_burnin.py
"""
import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import dataclasses
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
    L0 = np.asarray(seq.laplace_scale_tril(best))
    sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, 60)
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    q_z, losses = seq.SVI(best, opt, n_vi=1000, num_steps=300,
                          init_scales=L0, seed=1, segment_steps=30)
    jax.block_until_ready(losses)
    print(f"MAP+laplace+SVI: {time.time()-t0:.1f}s elbo {float(losses[-1]):.1f}",
          flush=True)

    for burnin in (250, 150, 100):
        rows = []
        for seed in (2, 3, 4):
            t0 = time.time()
            res = seq.HMC(q_z, n_hmc=50, num_burnin_steps=burnin,
                          num_results=750, max_leapfrog_steps=30,
                          seed=seed, segment_steps=250)
            jax.block_until_ready(res.samples)
            dt = time.time() - t0
            ess = np.asarray(effective_sample_size(res.samples))
            rhat = np.asarray(potential_scale_reduction(res.samples))
            rows.append((dt, ess.min(), ess.min() / dt, rhat.max()))
            print(
                f"burnin={burnin} seed={seed}: {dt:6.1f}s "
                f"eps {float(res.step_size):.4f} minESS {ess.min():7.0f} "
                f"ESS/s {ess.min()/dt:6.1f} rhat {rhat.max():.4f}",
                flush=True,
            )
        med = np.median([r[2] for r in rows])
        print(f"== burnin={burnin}: median ESS/s {med:6.1f} "
              f"worst rhat {max(r[3] for r in rows):.4f}", flush=True)


if __name__ == "__main__":
    main()
