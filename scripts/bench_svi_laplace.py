"""SVI budget with Laplace initialization (GPU).

The published SVI config (n_vi=1000 x 1500 steps from an isotropic 1e-3
scale) was tuned for a cold covariance start. `laplace_scale_tril` seeds the
surrogate with the curvature at the MAP, so most of those steps should be
unnecessary. Measures final ELBO (mean of last 50 losses) and the quality of
the resulting HMC preconditioner (min ESS of a 1-seed run) for several
(init, steps) combinations.

    python scripts/bench_svi_laplace.py
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
    print(f"MAP: {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    L0 = np.asarray(seq.laplace_scale_tril(best))
    print(f"laplace: {time.time()-t0:.1f}s", flush=True)

    variants = [
        ("iso1500", dict(init_scales=1e-3, num_steps=1500)),
        ("lap500", dict(init_scales=L0, num_steps=500)),
        ("lap300", dict(init_scales=L0, num_steps=300)),
        ("lap150", dict(init_scales=L0, num_steps=150)),
    ]
    for name, kw in variants:
        steps = kw["num_steps"]
        # same terminal lr; ramp scaled to the budget
        sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, max(steps // 5, 1))
        opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
        t0 = time.time()
        q_z, losses = seq.SVI(best, opt, n_vi=1000, seed=1,
                              segment_steps=max(steps // 10, 1), **kw)
        jax.block_until_ready(losses)
        t_svi = time.time() - t0
        elbo = float(np.mean(np.asarray(losses)[-50:]))
        t0 = time.time()
        res = seq.HMC(q_z, n_hmc=100, num_burnin_steps=250, num_results=375,
                      seed=3, segment_steps=250)
        jax.block_until_ready(res.samples)
        t_hmc = time.time() - t0
        ess = np.asarray(effective_sample_size(res.samples))
        rhat = np.asarray(potential_scale_reduction(res.samples))
        print(
            f"{name:8s}: svi {t_svi:6.1f}s  -elbo {elbo:8.1f}  |  hmc {t_hmc:5.1f}s "
            f"eps {float(res.step_size):.4f} minESS {ess.min():7.0f} "
            f"rhat {rhat.max():.4f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
