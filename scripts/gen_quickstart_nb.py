"""Generate examples/quickstart.ipynb — the notebook twin of docs/quickstart.md.

Mirrors the reference's ``jax-demo.ipynb`` flow (simulate truth -> MAP ->
SVI -> HMC -> diagnostics; reference cells 3-9) on the gigalens_tpu API.
Cells are left unexecuted (the demo scripts are the executable form; this
is the interactive on-ramp). Rerun after API changes:

    python scripts/gen_quickstart_nb.py
"""
import hashlib
import os

import nbformat as nbf

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_cell_counter = [0]


def _cell_id(source):
    # deterministic cell ids: see scripts/gen_gallery_nbs.py
    _cell_counter[0] += 1
    return hashlib.sha1(f"{_cell_counter[0]}:{source}".encode()).hexdigest()[:16]


def MD(s):
    s = s.strip()
    return nbf.v4.new_markdown_cell(s, id=_cell_id(s))


def PY(s):
    s = s.strip()
    return nbf.v4.new_code_cell(s, id=_cell_id(s))


cells = [
    MD("""
# gigalens_tpu quickstart

The GIGA-Lens workflow (simulate → multi-start MAP → SVI → preconditioned
HMC → diagnostics), in JAX. This notebook mirrors the reference's
`jax-demo.ipynb` cells 3–9; see `docs/quickstart.md` for the prose version
and `examples/demo_pipeline.py` for the script form.
"""),
    PY("""
import os

import jax
if os.environ.get("GIGALENS_NB_PLATFORM"):  # CI executes gallery runs on CPU
    jax.config.update("jax_platforms", os.environ["GIGALENS_NB_PLATFORM"])
import jax.numpy as jnp, numpy as np, optax

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference import ModellingSequence
from gigalens_tpu.model import ForwardProbModel
from gigalens_tpu.prob import Prior, distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator

print(jax.devices())
"""),
    MD("""
## 1. Model and prior

Priors are plain nested dicts of distributions — they double as the model
configuration (one entry per profile, in physical units).
"""),
    PY("""
prior = Prior(dict(
    lens_mass=[
        dict(theta_E=gld.LogNormal(jnp.log(1.25), 0.25),
             gamma=gld.TruncatedNormal(2, 0.25, 1, 3),
             e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
             center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05)),
        dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
    ],
    lens_light=[
        dict(R_sersic=gld.LogNormal(jnp.log(1.0), 0.15), n_sersic=gld.Uniform(2, 6),
             e1=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
             e2=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
             center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05),
             Ie=gld.LogNormal(jnp.log(500.0), 0.3)),
    ],
    source_light=[
        dict(R_sersic=gld.LogNormal(jnp.log(0.25), 0.15), n_sersic=gld.Uniform(0.5, 4),
             e1=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
             e2=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
             center_x=gld.Normal(0, 0.25), center_y=gld.Normal(0, 0.25),
             Ie=gld.LogNormal(jnp.log(150.0), 0.5)),
    ],
))
phys = PhysicalModel([EPL(EPL.recommended_niter(0.43, 1e-8)), Shear()],
                     [SersicEllipse()], [SersicEllipse()])
cfg = SimulatorConfig(delta_pix=0.065, num_pix=60, supersample=2)
"""),
    MD("""
## 2. Simulate a synthetic observation

(Substitute your own image + PSF here: `SimulatorConfig(kernel=psf)` and
`ForwardProbModel(prior, observed_image, ...)` — see
`examples/demo_reference_data.py` for fitting the reference's shipped data.)
"""),
    PY("""
truth = prior.sample(jax.random.PRNGKey(42), 1)
sim1 = LensSimulator(phys, cfg, bs=1)
truth_img = np.asarray(jax.jit(sim1.simulate)(truth))

rng = np.random.default_rng(1)
bkg, exp_time = 0.2, 100.0
obs = truth_img + rng.normal(size=truth_img.shape).astype(np.float32) * np.sqrt(
    bkg**2 + np.clip(truth_img, 0, None) / exp_time)

import matplotlib.pyplot as plt
plt.imshow(obs, origin="lower"); plt.title("observation"); plt.colorbar();
"""),
    MD("## 3. Multi-start MAP (one jitted Adam program)"),
    PY("""
prob_model = ForwardProbModel(prior, obs, background_rms=bkg, exp_time=exp_time)
seq = ModellingSequence(phys, prob_model, cfg)

sched = optax.polynomial_schedule(-1e-2, -1e-2/3, 0.5, 350)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
z_map = seq.MAP(opt, n_samples=500, num_steps=350, seed=0)
best = seq.best_map_start(z_map)

sim_b = LensSimulator(phys, cfg, bs=z_map.shape[0])
_, chi2 = jax.jit(lambda z: prob_model.log_prob(sim_b, z))(z_map)
print("best reduced chi2:", float(jnp.nanmin(chi2)))  # expect ~1
"""),
    MD("""
## 4. SVI, Laplace-initialized

The Laplace covariance at the MAP seeds the surrogate with the local
curvature — 300 steps instead of the published 1500 at equal-or-better
preconditioner quality (measured in an earlier round).
"""),
    PY("""
L0 = seq.laplace_scale_tril(best)
sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, 60)
opt2 = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
q_z, elbo = seq.SVI(best, opt2, n_vi=1000, num_steps=300,
                    init_scales=np.asarray(L0), seed=1)
print("ELBO:", float(elbo[0]), "->", float(elbo[-1]))
"""),
    MD("## 5. Preconditioned HMC (ChEES trajectories, windowed mass warmup)"),
    PY("""
res = seq.HMC(q_z, n_hmc=50, num_burnin_steps=250, num_results=750, seed=2)
print("accept:", float(np.asarray(res.accept_rate)[-100:].mean()),
      " eps:", float(res.step_size),
      " divergent chain-steps:", int(np.asarray(res.divergences).sum()))
"""),
    MD("## 6. Diagnostics and physical-space posterior summary"),
    PY("""
from gigalens_tpu.utils import summarize_posterior, format_summary
print(format_summary(summarize_posterior(prior, res.samples,
                                         divergences=res.divergences)))
"""),
    PY("""
# posterior-mean goodness of fit (the reference's acceptance criterion)
sim_p = LensSimulator(phys, cfg, bs=res.samples.shape[1])
_, chi2_post = jax.jit(lambda z: prob_model.log_prob(sim_p, z))(res.samples[-1])
print("posterior mean reduced chi2:", float(jnp.mean(chi2_post)))  # ~1
"""),
    PY("""
# residual panel at a posterior sample — the reference's acceptance
# evidence (jax-demo.ipynb cells 3-9): structureless +-3 sigma noise
model_img = np.asarray(
    jax.jit(sim_p.simulate)(prior.constrain(res.samples[-1])))[0]
sigma = np.sqrt(bkg**2 + np.clip(model_img, 0, None) / exp_time)
fig, axs = plt.subplots(1, 3, figsize=(12.5, 3.6), constrained_layout=True)
for ax, im, title, kw in zip(
        axs, [obs, model_img, (obs - model_img) / sigma],
        ["observation", "posterior model", "residual / sigma"],
        [{}, {}, dict(cmap="RdBu_r", vmin=-3, vmax=3)]):
    h = ax.imshow(im, origin="lower", **kw)
    ax.set_title(title); fig.colorbar(h, ax=ax, shrink=0.85)
"""),
    MD("""
## Going further

- **SMC** for multimodal posteriors + **log-evidence** for model comparison:
  `seq.SMC(...)`, `examples/demo_model_comparison.py`.
- **Catalogues**: fit S systems in single device programs —
  `SurveySequence` (`docs/survey.md`, `examples/demo_survey.py`).
- **Cluster-scale lenses** (dPIE members, scaling relations, Taylor series):
  `examples/demo_cluster.py`, `docs/scaling.md`.
- **Multi-chip**: pass a bigger `mesh=`; every phase shards the
  sample/chain/particle axis over ICI (`docs/scaling.md`).
"""),
]

nb = nbf.v4.new_notebook(cells=cells, metadata={
    "kernelspec": {"display_name": "Python 3", "language": "python",
                   "name": "python3"},
    "language_info": {"name": "python"},
})
out = os.path.join(_REPO_ROOT, "examples", "quickstart.ipynb")
with open(out, "w") as f:
    nbf.write(nb, f)
print("wrote", out)
