"""Cluster-path micro-benchmark: XLA scaling relation vs jet series.

Measures the dPIE member deflection sum (the cluster hot loop) forward and
forward+gradient, at configurable scale. Run on a GPU for real numbers; CPU
works for sanity with --cpu.

    python scripts/bench_cluster.py [--galaxies 200] [--pixels 28800] [--bs 64]
"""
import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import argparse
import time

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--galaxies", type=int, default=200)
parser.add_argument("--pixels", type=int, default=160 * 160)
parser.add_argument("--bs", type=int, default=64)
parser.add_argument("--order", type=int, default=3)
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--repeats", type=int, default=20)
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
from gigalens_tpu.utils.aot import setup_compilation_cache as _scc; _scc()
import jax.numpy as jnp

from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhalo, DPIESubhaloSeries

G, P, BS = args.galaxies, args.pixels, args.bs
rng = np.random.default_rng(0)
cat = dict(
    lum=rng.uniform(0.3, 3.0, G).astype(np.float32),
    center_x=rng.normal(0, 20.0, G).astype(np.float32),
    center_y=rng.normal(0, 20.0, G).astype(np.float32),
    e1=rng.uniform(-0.3, 0.3, G).astype(np.float32),
    e2=rng.uniform(-0.3, 0.3, G).astype(np.float32),
)
side = int(np.sqrt(P))
xs = np.linspace(-30, 30, side, dtype=np.float32)
X, Y = np.meshgrid(xs, xs)
x = jnp.asarray(X.reshape(-1))
y = jnp.asarray(Y.reshape(-1))
scales = jnp.asarray(
    np.stack([rng.uniform(0.5, 1.5, BS), np.full(BS, 0.08), np.full(BS, 1.6)], 1)
    .astype(np.float32)
)

xla_prof = DPIESubhalo(lum_star=1.0, galaxy_catalogue=cat, chunk_size=min(G, 32))
series_prof = DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat,
                                order=args.order, chunk_size=min(G, 32))


def timed(name, fn, *a):
    fn(*a)  # compile
    jax.block_until_ready(fn(*a))
    t0 = time.time()
    for _ in range(args.repeats):
        out = fn(*a)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / args.repeats * 1e3
    print(f"{name:34s} {dt:9.2f} ms")
    return dt


flops = 2 * BS * x.shape[0] * G * 60  # fwd+grad rough count
print(f"G={G} P={x.shape[0]} bs={BS}  (~{flops/1e9:.1f} GFLOP per fwd+bwd)")

# ---- forward ----------------------------------------------------------------
xla_fwd = jax.jit(lambda s: xla_prof.deriv(
    x, y, theta_E=s[:, 0:1], r_core=s[:, 1:2], r_cut=s[:, 2:3])[0].sum())
timed("XLA scaling fwd", xla_fwd, scales)

# ---- forward + grad ----------------------------------------------------------
xla_fg = jax.jit(jax.grad(lambda s: xla_prof.deriv(
    x, y, theta_E=s[:, 0:1], r_core=s[:, 1:2], r_cut=s[:, 2:3])[0].sum()))
timed("XLA scaling fwd+grad", xla_fg, scales)

# ---- series (precompute once, then O(order) eval) ----------------------------
series_prof.set_constants(dict(r_cut=1.6, r_core=0.08))
series_prof.set_grid(x, y)
t0 = time.time()
series_prof.set_deriv()
jax.block_until_ready(series_prof._deriv_coefs)
print(f"{'series precompute (once)':34s} {(time.time()-t0)*1e3:9.2f} ms")

ser_fwd = jax.jit(lambda s: series_prof.deriv(
    x, y, theta_E=s[:, 0:1], r_cut=s[:, 2:3])[0].sum())
timed("series eval fwd", ser_fwd, scales)
ser_fg = jax.jit(jax.grad(lambda s: series_prof.deriv(
    x, y, theta_E=s[:, 0:1], r_cut=s[:, 2:3])[0].sum()))
timed("series eval fwd+grad", ser_fg, scales)
