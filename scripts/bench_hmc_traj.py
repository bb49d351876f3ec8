"""HMC trajectory-budget experiment on the benchmark scene (GPU).

Runs MAP+SVI once (round-2 production recipe: Laplace-initialized surrogate,
300 SVI steps, one dispatch per phase), then the published HMC workload
(50 chains x 250+750) at several ``max_leapfrog_steps`` caps, each over the
bench's three seeds, reporting wall-clock, min ESS, ESS/sec, max split-R-hat,
and the adapted step size / trajectory. ChEES maximizes ESS per iteration;
capping the trajectory trades ESS for proportionally fewer gradients — this
measures where ESS/sec peaks, and (via the 3 seeds) whether large caps are
still adaptation-fragile now that chains start from the Laplace-quality
surrogate (round-1 observed one step-size collapse at cap=60 with the
isotropic-init 1500-step surrogate).

    python scripts/bench_hmc_traj.py [caps ...]   # default: 30 45 60
"""
import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import sys
import time

import numpy as np


def main():
    import jax

    from gigalens_tpu.utils.aot import setup_compilation_cache as _scc; _scc()
    import jax.numpy as jnp
    import optax

    from __graft_entry__ import _demo_setup
    from gigalens_tpu.inference import ModellingSequence
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.simulator import LensSimulator
    from gigalens_tpu.utils import effective_sample_size, potential_scale_reduction

    caps = [int(a) for a in sys.argv[1:]] or [30, 45, 60]
    seeds = [int(s) for s in _os.environ.get(
        "GIGALENS_TRAJ_SEEDS", "2,3,4").split(",")]

    # benchmark scene with the HST PSF when present
    prior, phys, cfg, _, _ = _demo_setup(num_pix=80, bs=16, psf_size=25)
    psf_path = "/root/reference/src/gigalens/assets/psf.npy"
    if _os.path.exists(psf_path):
        import dataclasses

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
    z = seq.MAP(opt, n_samples=500, num_steps=350, seed=0)
    best = seq.best_map_start(z)
    L0 = seq.laplace_scale_tril(best, method="fd")
    sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, 60)
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    q_z, losses = seq.SVI(best, opt, n_vi=1000, num_steps=300,
                          init_scales=np.asarray(L0), seed=1)
    jax.block_until_ready(losses)
    print(f"MAP+SVI: {time.time()-t0:.1f}s  elbo {float(losses[-1]):.1f}",
          flush=True)

    for cap in caps:
        for seed in seeds:
            t0 = time.time()
            res = seq.HMC(q_z, n_hmc=50, num_burnin_steps=250, num_results=750,
                          max_leapfrog_steps=cap, seed=seed)
            jax.block_until_ready(res.samples)
            dt = time.time() - t0
            ess = np.asarray(effective_sample_size(res.samples))
            rhat = np.asarray(potential_scale_reduction(res.samples))
            acc = float(np.asarray(res.accept_rate)[-100:].mean())
            print(
                f"cap={cap:3d} seed={seed}: {dt:6.1f}s  accept {acc:.2f} "
                f"eps {float(res.step_size):.4f} "
                f"traj {float(res.trajectory_length):.4f} "
                f"min ESS {ess.min():7.0f}  ESS/s {ess.min()/dt:6.1f}  "
                f"max rhat {rhat.max():.4f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
