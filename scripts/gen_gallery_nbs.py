"""Generate the notebook gallery: cluster, inversion, and shapelets
walkthroughs (examples/*.ipynb).

Mirrors the reference's notebook set — ``jax-demo.ipynb`` (covered by
``quickstart.ipynb``, see gen_quickstart_nb.py), ``shapelets-demo.ipynb``
(-> shapelets.ipynb) — and adds the two flagship capabilities the reference
documents only in code: cluster-scale modeling (-> cluster.ipynb) and
pixelated-source inversion (-> inversion.ipynb). Cells are left unexecuted;
the examples/demo_*.py scripts are the executable twins.

    python scripts/gen_gallery_nbs.py
"""
import hashlib
import os

import nbformat as nbf

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_cell_counter = [0]


def _cell_id(source):
    # deterministic cell ids (hash of source + a counter for duplicates):
    # nbformat's default random ids would make every regeneration diff
    # against the committed notebooks, defeating drift checks
    _cell_counter[0] += 1
    h = hashlib.sha1(f"{_cell_counter[0]}:{source}".encode())
    return h.hexdigest()[:16]


def MD(s):
    s = s.strip()
    return nbf.v4.new_markdown_cell(s, id=_cell_id(s))


def PY(s):
    s = s.strip()
    return nbf.v4.new_code_cell(s, id=_cell_id(s))


def write(name, cells):
    nb = nbf.v4.new_notebook(
        cells=cells,
        metadata={
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python"},
        },
    )
    path = os.path.join(_REPO_ROOT, "examples", name)
    with open(path, "w") as f:
        nbf.write(nb, f)
    print("wrote", path)


# ---------------------------------------------------------------------------
# cluster.ipynb
# ---------------------------------------------------------------------------
cluster = [
    MD("""
# Cluster-scale lens modeling

A strong-lensing **galaxy cluster**: one smooth dark-matter halo
(`NFW_ELLIPSE`) plus a population of member galaxies tied together by a
luminosity **scaling relation** (`DPIESubhalo`), lensing a background source
expanded in **shapelets**. Two global parameters (`theta_E*`, `r_cut*`)
control all members — the cluster-lensing parameterization of
Jullo et al. 2007, the workflow the reference's cluster branch
(`dpie.py`, `scaling_relation.py`, `series/`) exists for.

The script twin is `examples/demo_cluster.py` (`--full` runs
MAP → SVI → HMC; `--smc` samples with tempered SMC instead). See
`docs/scaling.md` for the member-stack design and the Taylor-series
acceleration.
"""),
    PY("""
import os
import time

import jax
if os.environ.get("GIGALENS_NB_PLATFORM"):  # CI executes gallery runs on CPU
    jax.config.update("jax_platforms", os.environ["GIGALENS_NB_PLATFORM"])
import jax.numpy as jnp, numpy as np, optax

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference import ModellingSequence
from gigalens_tpu.model import ForwardProbModel
from gigalens_tpu.prob import Prior, distributions as gld
from gigalens_tpu.profiles.light.shapelets import Shapelets
from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhalo, DPIESubhaloSeries
from gigalens_tpu.profiles.mass.nfw import NFW_ELLIPSE
from gigalens_tpu.simulator import LensSimulator

print(jax.devices())
"""),
    MD("""
## 1. The member catalogue

Member positions, ellipticities and luminosities come from photometry and
are **constants** of the model; only the two scaling amplitudes are fit.
"""),
    PY("""
rng = np.random.default_rng(0)
G = 20  # member galaxies
catalogue = dict(
    lum=rng.uniform(0.3, 3.0, G).astype(np.float32),
    center_x=rng.normal(0, 8.0, G).astype(np.float32),
    center_y=rng.normal(0, 8.0, G).astype(np.float32),
    e1=rng.uniform(-0.2, 0.2, G).astype(np.float32),
    e2=rng.uniform(-0.2, 0.2, G).astype(np.float32),
)
members = DPIESubhalo(lum_star=1.0, galaxy_catalogue=catalogue,
                      chunk_size=min(G, 16))

shapelet = Shapelets(n_max=4)   # 15 basis functions
phys_model = PhysicalModel([NFW_ELLIPSE(), members], [], [shapelet])
"""),
    MD("""
## 2. Priors

The halo gets standard NFW priors; the member population is controlled by
`theta_E` (Einstein radius of an L* member) and `r_cut` (its truncation
radius), scaled to each member by the Faber–Jackson exponents baked into
`DPIESubhalo`. Shapelet amplitudes are linear parameters with wide normal
priors.
"""),
    PY("""
amp_priors = {a: gld.Normal(0, 5.0) for a in shapelet._amp_names}
prior = Prior(dict(
    lens_mass=[
        dict(Rs=gld.LogNormal(np.log(10.0), 0.2),
             alpha_Rs=gld.LogNormal(np.log(4.0), 0.3),
             e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
             center_x=gld.Normal(0, 0.5), center_y=gld.Normal(0, 0.5)),
        dict(theta_E=gld.LogNormal(np.log(0.3), 0.3),
             r_core=gld.LogNormal(np.log(0.08), 0.2),
             r_cut=gld.LogNormal(np.log(1.5), 0.2)),
    ],
    source_light=[dict(beta=gld.LogNormal(np.log(0.4), 0.2),
                       center_x=gld.Normal(0, 0.3),
                       center_y=gld.Normal(0, 0.3), **amp_priors)],
))
"""),
    MD("""
## 3. Simulate an observation
"""),
    PY("""
g = np.exp(-((np.arange(9) - 4) ** 2 + (np.arange(9)[:, None] - 4) ** 2) / 4.0)
psf = (g / g.sum()).astype(np.float32)
sim_config = SimulatorConfig(delta_pix=0.2, num_pix=48, supersample=2, kernel=psf)

truth = prior.sample(jax.random.PRNGKey(5), 1)
sim1 = LensSimulator(phys_model, sim_config, bs=1)
truth_img = np.asarray(jax.jit(sim1.simulate)(truth))
bkg, exp_time = 0.1, 500.0
obs = truth_img + rng.normal(size=truth_img.shape).astype(np.float32) * np.sqrt(
    bkg**2 + np.clip(truth_img, 0, None) / exp_time)
"""),
    MD("""
## 4. Multiple-image positions

Cluster fits are driven by the positions of multiply-imaged background
sources. `find_images` solves the lens equation (grid scan + Newton
refinement) for the true source center; the traced images feed the
magnification-scaled position likelihood alongside the pixel data.
"""),
    PY("""
from gigalens_tpu.utils import find_images

src_cx = float(np.asarray(truth["source_light"][0]["center_x"])[0])
src_cy = float(np.asarray(truth["source_light"][0]["center_y"])[0])
img_x, img_y, _ = find_images(sim1, truth["lens_mass"], src_cx, src_cy,
                              search_window=4.0)
print(f"{len(img_x)} images:",
      ", ".join(f"({x:+.2f},{y:+.2f})" for x, y in zip(img_x, img_y)))

kw = {}
if len(img_x) >= 2:
    kw = dict(centroids_x=[img_x], centroids_y=[img_y],
              centroids_errors_x=[np.full(len(img_x), 0.1, np.float32)],
              centroids_errors_y=[np.full(len(img_y), 0.1, np.float32)])
prob_model = ForwardProbModel(prior, obs, background_rms=bkg,
                              exp_time=exp_time, **kw)
seq = ModellingSequence(phys_model, prob_model, sim_config)
"""),
    MD("""
## 5. Multi-start MAP
"""),
    PY("""
t0 = time.time()
n_map, s_map = 32, 150
sched = optax.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, s_map)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
z_map = seq.MAP(opt, n_samples=n_map, num_steps=s_map, seed=0)
sim_b = LensSimulator(phys_model, sim_config, bs=n_map)
lps, chi2 = jax.jit(lambda z: prob_model.log_prob(sim_b, z))(z_map)
print(f"MAP: {time.time()-t0:.1f}s best red-chi2 {float(jnp.nanmin(chi2)):.3f}")
"""),
    MD("""
## 6. Posterior sampling

Galaxy-scale posteriors use SVI → HMC (`seq.fit()`); cluster posteriors are
often multimodal, for which tempered **SMC** with the combined
pixels+positions target is the robust choice (and what the reference added
SMC for). Both are one call:
"""),
    PY("""
# SVI -> HMC (see demo_cluster.py --full for tuned settings):
# q = seq.SVI(seq.best_map_start(z_map), opt_svi, n_vi=256, num_steps=400)
# res = seq.HMC(q, n_hmc=50, num_burnin_steps=500, num_results=750)

# Tempered SMC (multimodal-robust; start=None also estimates log-evidence):
res = seq.SMC(start=z_map, num_particles=128, num_ensembles=1,
              num_leapfrog_steps=5, post_sampling_steps=30,
              target="pixels+positions" if kw else "pixels",
              auxiliar="none", seed=1)
pts = res.particles.reshape(-1, res.particles.shape[-1])
sim_p = LensSimulator(phys_model, sim_config, bs=pts.shape[0])
# gate on the PIXEL reduced chi2: log_prob's red_chi2 averages in the
# n_img-point position term, whose ~0 value over a couple of points says
# nothing about fit quality and drags the mean below the gate band
_, chi2_pix = jax.jit(
    lambda z: prob_model.stats_pixels(sim_p, prior.constrain(z)))(pts)
chi2_val = float(jnp.mean(chi2_pix))
gate_ok = 0.85 <= chi2_val <= 1.15
print(f"stages {int(res.num_stages)}  posterior pixel red-chi2 "
      f"{chi2_val:.3f}  gate[0.85, 1.15]: {'PASS' if gate_ok else 'FAIL'}")
assert gate_ok, "posterior chi2 outside the acceptance band"
"""),
    MD("""
## 7. Series acceleration

For big member populations, `DPIESubhaloSeries` replaces the per-member
deflection sums with a **Taylor expansion in the two scaling parameters**
(coefficients computed once by `jax.experimental.jet`, evaluated as one
matmul). Precompute once, then fits run ~2× faster at `G≈100`+:

```python
members = DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=catalogue, order=3)
members.set_constants(dict(r_cut=1.5, r_core=0.08))
members.set_grid(sim1.img_x, sim1.img_y)
members.set_deriv()      # jet Taylor coefficients, one-time
```

`tests/test_cluster.py` pins series == direct to float32 accuracy inside
the trust region. See `docs/scaling.md` for accuracy-vs-order tables.
"""),
]

# ---------------------------------------------------------------------------
# inversion.ipynb
# ---------------------------------------------------------------------------
inversion = [
    MD("""
# Pixelated source reconstruction

Recover a lensed source **non-parametrically** on a pixel grid by
semilinear inversion (Warren & Dye 2003): for every lens-parameter sample
the linear source pixels are solved in closed form and **marginalized
analytically**, so MAP/HMC run over lens parameters only. Script twin:
`examples/demo_inversion.py`; design notes: `docs/inversion.md`.
"""),
    PY("""
import os
import time

import jax
if os.environ.get("GIGALENS_NB_PLATFORM"):  # CI executes gallery runs on CPU
    jax.config.update("jax_platforms", os.environ["GIGALENS_NB_PLATFORM"])
import jax.numpy as jnp, numpy as np, optax

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference import ModellingSequence
from gigalens_tpu.inversion import PixelatedSourceProbModel, SourceGrid
from gigalens_tpu.model import ForwardProbModel
from gigalens_tpu.prob import Prior, distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.sie import SIE
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator

print(jax.devices())
"""),
    MD("""
## 1. Simulate: SIE+Shear lensing a Sersic source
"""),
    PY("""
num_pix, n_side = 40, 12   # image pixels, source-grid side (quick config)
kern = np.exp(-((np.arange(9) - 4) ** 2 + (np.arange(9)[:, None] - 4) ** 2) / 4.0)
kern = (kern / kern.sum()).astype(np.float32)
cfg = SimulatorConfig(delta_pix=0.05, num_pix=num_pix, supersample=2, kernel=kern)

truth_phys = PhysicalModel([SIE(), Shear()], [], [SersicEllipse()])
truth = dict(
    lens_mass=[
        dict(theta_E=jnp.array([0.85]), e1=jnp.array([0.07]),
             e2=jnp.array([-0.04]), center_x=jnp.array([0.01]),
             center_y=jnp.array([-0.02])),
        dict(gamma1=jnp.array([0.02]), gamma2=jnp.array([-0.01])),
    ],
    source_light=[dict(R_sersic=jnp.array([0.15]), n_sersic=jnp.array([1.2]),
                       e1=jnp.array([0.15]), e2=jnp.array([-0.05]),
                       center_x=jnp.array([0.06]), center_y=jnp.array([-0.04]),
                       Ie=jnp.array([10.0]))],
)
sim_t = LensSimulator(truth_phys, cfg, bs=1)
truth_img = np.asarray(jax.jit(sim_t.simulate)(truth))
rng = np.random.default_rng(0)
bkg, exp_time = 0.1, 1e3
obs = truth_img + rng.normal(size=truth_img.shape).astype(np.float32) * np.sqrt(
    bkg**2 + np.clip(truth_img, 0, None) / exp_time)
"""),
    MD("""
## 2. Stage 1 — parametric warm-up

Fit a parametric (Sersic) source first: the marginal-likelihood landscape
over lens parameters is much better conditioned near a good lens model,
and the parametric stage is far cheaper per step.
"""),
    PY("""
lens_groups = [
    dict(theta_E=gld.LogNormal(np.log(0.8), 0.15),
         e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
         center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05)),
    dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
]
prior_param = Prior(dict(
    lens_mass=lens_groups,
    source_light=[dict(R_sersic=gld.LogNormal(np.log(0.15), 0.3),
                       n_sersic=gld.Uniform(0.5, 4),
                       e1=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                       e2=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                       center_x=gld.Normal(0, 0.15),
                       center_y=gld.Normal(0, 0.15),
                       Ie=gld.LogNormal(np.log(10.0), 0.5))],
))
phys_param = PhysicalModel([SIE(), Shear()], [], [SersicEllipse()])
model_param = ForwardProbModel(prior_param, obs, background_rms=bkg,
                               exp_time=exp_time)
seq_param = ModellingSequence(phys_param, model_param, cfg)

sched = optax.polynomial_schedule(-1e-2, -3e-3, 0.5, 120)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
z1 = seq_param.MAP(opt, n_samples=8, num_steps=120, seed=0)
z1_best = seq_param.best_map_start(z1)
print("stage 1 done")
"""),
    MD("""
## 3. Stage 2 — joint lens + pixelated source

`PixelatedSourceProbModel` carries the **lens** prior plus one extra
parameter `lam` (the regularization strength, fit jointly — the marginal
likelihood's Occam term sets it); the source pixel amplitudes are solved
and marginalized inside the likelihood.
"""),
    PY("""
prior_pix = Prior(dict(
    lens_mass=lens_groups,
    source_pixelated=[dict(lam=gld.LogNormal(2.0, 2.0))],
))
phys_lens = PhysicalModel([SIE(), Shear()], [], [])
pix_model = PixelatedSourceProbModel(
    prior_pix, obs, background_rms=bkg, exp_time=exp_time,
    grid=SourceGrid(n_side=n_side, extent=0.4), lam=None)
seq_pix = ModellingSequence(phys_lens, pix_model, cfg)

# start every chain from the stage-1 lens parameters (+ jitter);
# lam starts at its prior median
d_lens, n_starts = 7, 8
z1b = np.asarray(z1_best).ravel()  # (d,): lens params lead the packing order
rng2 = np.random.default_rng(1)
lam_dist = prior_pix.tree["source_pixelated"][0]["lam"]
z_lam0 = float(np.asarray(lam_dist.bijector.inverse(jnp.array(3.0))))
z0 = np.concatenate([
    np.tile(z1b[:d_lens], (n_starts, 1))
    + 0.03 * rng2.standard_normal((n_starts, d_lens)).astype(np.float32),
    z_lam0 + 0.3 * rng2.standard_normal((n_starts, 1)).astype(np.float32),
], axis=1).astype(np.float32)

t0 = time.time()
z2 = seq_pix.MAP(opt, start=z0, n_samples=n_starts, num_steps=120, seed=1)
print(f"stage 2 joint MAP: {time.time()-t0:.1f}s")
"""),
    MD("""
## 4. Inspect the reconstruction

`solve` returns the regularized source solution, the model image, and the
per-sample reduced chi²; the `source` entry is the reconstruction on its
grid.
"""),
    PY("""
sim2 = LensSimulator(phys_lens, cfg, bs=1)
zb = jnp.asarray(np.asarray(seq_pix.best_map_start(z2)))  # already (1, d)
x2 = pix_model.prior.constrain(zb)
out = jax.jit(lambda p: pix_model.solve(sim2, p))(x2)
print("joint red-chi2:", float(out["red_chi2"][0]))
src = np.asarray(out["source"][0])
print("source grid:", src.shape)
"""),
    MD("""
## 5. Sampling

The same `seq_pix` drives SVI → HMC over the lens parameters with the
source still marginalized — posterior lens uncertainties that account for
all source configurations the data allows:

```python
q = seq_pix.SVI(zb, opt, n_vi=64, num_steps=300)
res = seq_pix.HMC(q, n_hmc=16, num_burnin_steps=200, num_results=500)
```

At `n_side=24`+ run on a GPU — each step is `bs` inversions (basis-image
convolutions + a Gram matmul). Measured costs: `docs/inversion.md`.
"""),
]

# ---------------------------------------------------------------------------
# shapelets.ipynb
# ---------------------------------------------------------------------------
shapelets = [
    MD("""
# Shapelet sources

The reference's `shapelets-demo.ipynb` on the gigalens_tpu API: model a
structured source as a **Gauss–Hermite shapelet expansion**
(Refregier 2003) instead of a single Sersic. `n_max=8` gives 45 basis
functions — enough for clumpy, multi-component sources.
"""),
    PY("""
import os
import time

import jax
if os.environ.get("GIGALENS_NB_PLATFORM"):  # CI executes gallery runs on CPU
    jax.config.update("jax_platforms", os.environ["GIGALENS_NB_PLATFORM"])
import jax.numpy as jnp, numpy as np, optax

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.inference import ModellingSequence
from gigalens_tpu.model import ForwardProbModel
from gigalens_tpu.prob import Prior, distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.light.shapelets import Shapelets
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.shear import Shear
from gigalens_tpu.simulator import LensSimulator

print(jax.devices())
"""),
    MD("""
## 1. A clumpy truth

Simulate a two-component source (offset Sersics) — structure a single
Sersic fit cannot capture.
"""),
    PY("""
kern = np.exp(-((np.arange(13) - 6) ** 2 + (np.arange(13)[:, None] - 6) ** 2) / 5.0)
kern = (kern / kern.sum()).astype(np.float32)
cfg = SimulatorConfig(delta_pix=0.065, num_pix=60, supersample=2, kernel=kern)

truth_phys = PhysicalModel([EPL(), Shear()], [],
                           [SersicEllipse(), SersicEllipse()])
truth = dict(
    lens_mass=[
        dict(theta_E=jnp.array([1.1]), gamma=jnp.array([2.0]),
             e1=jnp.array([0.05]), e2=jnp.array([-0.03]),
             center_x=jnp.array([0.0]), center_y=jnp.array([0.0])),
        dict(gamma1=jnp.array([0.02]), gamma2=jnp.array([0.01])),
    ],
    source_light=[
        dict(R_sersic=jnp.array([0.12]), n_sersic=jnp.array([1.0]),
             e1=jnp.array([0.1]), e2=jnp.array([0.0]),
             center_x=jnp.array([0.05]), center_y=jnp.array([0.0]),
             Ie=jnp.array([12.0])),
        dict(R_sersic=jnp.array([0.08]), n_sersic=jnp.array([0.8]),
             e1=jnp.array([-0.05]), e2=jnp.array([0.1]),
             center_x=jnp.array([-0.12]), center_y=jnp.array([0.1]),
             Ie=jnp.array([8.0])),
    ],
)
sim_t = LensSimulator(truth_phys, cfg, bs=1)
truth_img = np.asarray(jax.jit(sim_t.simulate)(truth))
rng = np.random.default_rng(3)
bkg, exp_time = 0.1, 500.0
obs = truth_img + rng.normal(size=truth_img.shape).astype(np.float32) * np.sqrt(
    bkg**2 + np.clip(truth_img, 0, None) / exp_time)
"""),
    MD("""
## 2. Shapelet model with linear amplitudes

With `use_lstsq=True` the 45 amplitudes are solved by weighted least
squares inside the likelihood (`BackwardProbModel` /
`sim.lstsq_simulate`) — only the nonlinear parameters (lens, `beta`,
center) are sampled, exactly the reference's shapelet workflow.
"""),
    PY("""
src = Shapelets(n_max=8, use_lstsq=True)
phys = PhysicalModel([EPL(), Shear()], [], [src])
prior = Prior(dict(
    lens_mass=[
        dict(theta_E=gld.LogNormal(np.log(1.0), 0.2),
             gamma=gld.TruncatedNormal(2, 0.25, 1.2, 2.8),
             e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
             center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05)),
        dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
    ],
    source_light=[dict(beta=gld.LogNormal(np.log(0.12), 0.3),
                       center_x=gld.Normal(0, 0.15),
                       center_y=gld.Normal(0, 0.15))],
))

from gigalens_tpu.model import BackwardProbModel
prob_model = BackwardProbModel(prior, obs, background_rms=bkg,
                               exp_time=exp_time)
err_map = prob_model.err_map
seq = ModellingSequence(phys, prob_model, cfg)
"""),
    MD("""
## 3. Fit
"""),
    PY("""
t0 = time.time()
sched = optax.polynomial_schedule(-8e-3, -2e-3, 0.5, 200)
opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
z_map = seq.MAP(opt, n_samples=64, num_steps=200, seed=0)
sim_b = LensSimulator(phys, cfg, bs=64)
lps, chi2 = jax.jit(lambda z: prob_model.log_prob(sim_b, z))(z_map)
print(f"MAP {time.time()-t0:.1f}s  best red-chi2 {float(jnp.nanmin(chi2)):.3f}")
"""),
    MD("""
## 4. Reconstruct and compare

`lstsq_simulate` returns the best-fit image (amplitudes re-solved); with
`return_coeffs=True` it returns the 45 shapelet coefficients — the source
reconstruction.
"""),
    PY("""
best = seq.best_map_start(z_map)
x_best = prior.constrain(best[None] if best.ndim == 1 else best)
sim1 = LensSimulator(phys, cfg, bs=1)
model_img = sim1.lstsq_simulate(x_best, obs, err_map)
coeffs = sim1.lstsq_simulate(x_best, obs, err_map, return_coeffs=True)
resid = (np.asarray(model_img) - obs.squeeze()) / err_map.squeeze()
print("coeffs:", np.asarray(coeffs).shape,
      " resid rms:", float(np.sqrt((resid**2).mean())))
"""),
    MD("""
## 5. Posterior

Sampling works unchanged — the lstsq amplitudes are re-solved at every
likelihood evaluation, so HMC explores only the 11 nonlinear dimensions:

```python
q = seq.SVI(best, opt, n_vi=200, num_steps=400)
res = seq.HMC(q, n_hmc=50, num_burnin_steps=250, num_results=750)
```

For fully-Bayesian amplitudes (sampled, not profiled), construct
`Shapelets(n_max, use_lstsq=False)` and give each `amp*` a prior — see
`examples/demo_cluster.py`.
"""),
]

if __name__ == "__main__":
    write("cluster.ipynb", cluster)
    write("inversion.ipynb", inversion)
    write("shapelets.ipynb", shapelets)
