"""Scaling-relation profile stacks (cluster member galaxies).

Reference: ``src/gigalens/jax/profiles/mass/scaling_relation.py``. A catalogue
of member galaxies shares one profile family; each galaxy's parameters scale
with its luminosity, ``p_g = scale * (L_g / L_star) ** power[p]``, and the
total field is the sum over galaxies.

Design:
  * the galaxy axis is a leading broadcast axis ``(bs, g, npix)`` so pixels
    stay the contiguous dimension;
  * the sum over galaxies runs as a ``lax.scan`` over fixed-size chunks
    (static shapes; memory bounded by ``chunk_size * npix``), with the
    catalogue padded by zero-luminosity galaxies — a padded galaxy's
    scaled parameters are all 0, so profiles built on amplitude-scaled
    deflections contribute exactly zero.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gigalens_tpu.profiles.base import MassProfile


class ScalingRelation(MassProfile):
    def __init__(
        self,
        profile: MassProfile,
        scaling_params: List[str],
        lum_star: float,
        scaling_params_power: Dict[str, float],
        galaxy_catalogue: Dict[str, List],
        chunk_size: Optional[int] = None,
        **kwargs,
    ):
        self.profile = profile
        self._name = f"Scaled-{profile.name}"
        if not hasattr(self, "_params") or self._params is None:
            self._params = list(scaling_params)
        self.scaling_params = list(scaling_params)
        super().__init__(**kwargs)

        lums = np.asarray(galaxy_catalogue["lum"], np.float32)
        self.n_galaxy = int(lums.size)
        self.lum_star = float(lum_star)
        self.power = {k: float(v) for k, v in scaling_params_power.items()}
        self.galaxy_cat = galaxy_catalogue

        if chunk_size is None or chunk_size >= self.n_galaxy:
            self.chunk_size = self.n_galaxy
        else:
            self.chunk_size = int(chunk_size)
        self.n_chunks = -(-self.n_galaxy // self.chunk_size)
        pad = self.n_chunks * self.chunk_size - self.n_galaxy

        constants = list(getattr(self.profile, "constants", []))
        self.not_scaling_params = [
            p for p in list(self.profile.params) + constants
            if p not in self.scaling_params
        ]

        def _padded(arr, value):
            arr = np.asarray(arr, np.float32)
            if pad:
                arr = np.concatenate([arr, np.full(pad, value, np.float32)])
            return arr.reshape(self.n_chunks, self.chunk_size)

        # per-chunk unscaled multipliers (lum/L*)^power; padded with 0 so the
        # amplitude of padded galaxies vanishes
        self._unscaled = {
            k: jnp.asarray(_padded((lums / lum_star) ** self.power[k], 0.0))
            for k in self.scaling_params
        }
        # per-chunk per-galaxy constants; padded with a copy of the last entry
        # (benign values; the zero amplitude kills the contribution)
        self._galaxy_constants = {
            k: jnp.asarray(
                _padded(galaxy_catalogue[k], float(np.asarray(galaxy_catalogue[k])[-1]))
            )
            for k in self.not_scaling_params
        }

    # ------------------------------------------------------------------
    def _chunked_sum(self, fn, x, y, scales: Dict):
        """scan over galaxy chunks of sum_g fn(x, y, params_g).

        ``scales``: dict of (bs, 1)-broadcastable global scaling factors.
        fn is called with parameters shaped (..., chunk, 1) against
        coordinates (npix,), producing (..., chunk, npix); the chunk axis is
        summed immediately, and lax.scan accumulates across chunks.
        """
        # remat: without it, reverse-mode through the chunk scan stores every
        # (bs, chunk, npix) profile intermediate per chunk — OOM at cluster
        # scale; recomputing the chunk forward during backward is cheap
        @jax.checkpoint
        def chunk_out(chunk_idx, scale_vals):
            p = {
                k: jnp.expand_dims(scale_vals[k], -1)
                * self._unscaled[k][chunk_idx][:, None]
                for k in self.scaling_params
            }  # (bs, chunk, 1) each
            c = {
                k: self._galaxy_constants[k][chunk_idx][:, None]
                for k in self.not_scaling_params
            }  # (chunk, 1)
            out = fn(x, y, **p, **c)
            return tuple(jnp.sum(o, axis=-2) for o in out)

        def body(acc, chunk_idx):
            out = chunk_out(chunk_idx, scales)
            acc = tuple(a + o for a, o in zip(acc, out))
            return acc, None

        # probe output structure with zeros of the right rank
        bs_shape = jnp.broadcast_shapes(
            *[jnp.shape(s) for s in scales.values()]
        )  # (bs, 1)
        npix_shape = jnp.shape(x)[-1:] if jnp.ndim(x) else ()
        out_shape = (*bs_shape[:-1], *npix_shape)
        n_out = self._n_outputs(fn)
        acc0 = tuple(jnp.zeros(out_shape) for _ in range(n_out))
        acc, _ = lax.scan(body, acc0, jnp.arange(self.n_chunks))
        return acc

    @staticmethod
    def _n_outputs(fn):
        name = getattr(fn, "__name__", "")
        return {"deriv": 2, "hessian": 4, "shear": 2, "convergence": 1}.get(name, 1)

    # ------------------------------------------------------------------
    def deriv(self, x, y, **scales):
        fx, fy = self._chunked_sum(self.profile.deriv, x, y, scales)
        return fx, fy

    def hessian(self, x, y, **scales):
        return self._chunked_sum(self.profile.hessian, x, y, scales)

    def convergence(self, x, y, **scales):
        def conv(x, y, **p):
            return (self.profile.convergence(x, y, **p),)

        conv.__name__ = "convergence"
        return self._chunked_sum(conv, x, y, scales)[0]

    def shear(self, x, y, **scales):
        def sh(x, y, **p):
            return self.profile.shear(x, y, **p)

        sh.__name__ = "shear"
        return self._chunked_sum(sh, x, y, scales)
