"""Component breakdown of the SVI step cost on the benchmark scene (GPU).

Times, at the published SVI workload size (n_vi=1000, 80x80 @ ss=2, HST PSF):
  - the full ELBO value_and_grad step (what fit_svi scans)
  - ELBO forward only
  - log_prob forward at fixed z
  - render (_flat_light) forward and forward+vjp
  - PSF convolution (+pool) forward and forward+vjp on a fixed image batch

Usage: python scripts/bench_svi_breakdown.py [n_vi]
"""
import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import sys

import numpy as np


def main():
    import jax

    from gigalens_tpu.utils.aot import setup_compilation_cache as _scc; _scc()
    import jax.numpy as jnp

    from gigalens_tpu import PhysicalModel, SimulatorConfig
    from gigalens_tpu.model import ForwardProbModel
    from gigalens_tpu.prob import Prior
    from gigalens_tpu.prob import distributions as gld
    from gigalens_tpu.profiles.light.sersic import SersicEllipse
    from gigalens_tpu.profiles.mass.epl import EPL
    from gigalens_tpu.profiles.mass.shear import Shear
    from gigalens_tpu.simulator import LensSimulator
    from gigalens_tpu.utils.profiling import timed

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000

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
    psf = np.load("/root/reference/src/gigalens/assets/psf.npy").astype(np.float32)
    phys = PhysicalModel([EPL(50), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=0.065, num_pix=80, supersample=2, kernel=psf)
    sim = LensSimulator(phys, cfg, bs=n)
    print(f"n={n} psf_mode={sim._conv.mode} "
          f"fshape={getattr(sim._conv, 'fshape', None)}", flush=True)

    truth = prior.sample(jax.random.PRNGKey(42), 1)
    sim1 = LensSimulator(phys, cfg, bs=1)
    obs = np.asarray(jax.jit(sim1.simulate)(truth))
    pm = ForwardProbModel(prior, obs, background_rms=0.2, exp_time=100.0)

    d = prior.d
    key = jax.random.PRNGKey(0)
    z0 = prior.unconstrain(prior.sample(key, n))
    mean = jnp.mean(z0, 0)
    tril_flat = 0.05 * jnp.eye(d)

    def elbo(mean, key):
        eps = jax.random.normal(key, (n, d))
        z = mean + eps @ tril_flat.T
        lp_model, _ = pm.log_prob(sim, z)
        return jnp.mean(-lp_model)

    t, _ = timed(jax.jit(jax.value_and_grad(elbo)), mean, key, repeats=5)
    print(f"ELBO value_and_grad : {t*1e3:8.1f} ms", flush=True)
    t, _ = timed(jax.jit(elbo), mean, key, repeats=5)
    print(f"ELBO forward        : {t*1e3:8.1f} ms", flush=True)

    lp = jax.jit(lambda z: pm.log_prob(sim, z)[0])
    t, _ = timed(lp, z0, repeats=5)
    print(f"log_prob fwd (z)    : {t*1e3:8.1f} ms", flush=True)

    params = jax.jit(prior.constrain)(z0)
    flat = jax.jit(lambda p: sim._flat_light(p))
    t, flat_out = timed(flat, params, repeats=5)
    print(f"render fwd          : {t*1e3:8.1f} ms  out={flat_out.shape}", flush=True)

    def render_sum(p):
        return jnp.sum(sim._flat_light(p) ** 2)

    t, _ = timed(jax.jit(jax.grad(render_sum)), params, repeats=5)
    print(f"render fwd+grad     : {t*1e3:8.1f} ms", flush=True)

    img = flat_out.reshape(n, sim.h_ss, sim.w_ss)

    post = jax.jit(lambda im: sim._postprocess(im))
    t, _ = timed(post, img, repeats=5)
    print(f"conv+pool fwd       : {t*1e3:8.1f} ms", flush=True)

    def post_sum(im):
        return jnp.sum(sim._postprocess(im) ** 2)

    t, _ = timed(jax.jit(jax.grad(post_sum)), img, repeats=5)
    print(f"conv+pool fwd+grad  : {t*1e3:8.1f} ms", flush=True)

    def like_only(z):
        params = prior.constrain(z)
        flat = sim._flat_light(params)
        img = sim._postprocess(flat.reshape(n, sim.h_ss, sim.w_ss))
        return jnp.sum(img**2)

    t, _ = timed(jax.jit(jax.grad(like_only)), z0, repeats=5)
    print(f"constrain+render+conv fwd+grad: {t*1e3:8.1f} ms", flush=True)


if __name__ == "__main__":
    main()
