"""Cartesian shapelet light profiles (Refregier 2003).

Reference: ``src/gigalens/jax/profiles/light/shapelets.py``. The reference has
two evaluation paths — interpolation of lenstronomy-tabulated basis functions,
and a Hermite recurrence; only the recurrence survives here (no tables, no
gather, pure elementwise arithmetic), evaluated with a
``lax.scan`` over polynomial order.

Basis convention matches the reference: B_i(x, y) = phi_{n1}(u) phi_{n2}(v)
with u = (x - cx)/beta (no extra 1/beta normalization), amplitudes named
``amp00, amp01, ...`` in the triangular (n1, n2) ordering.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from jax import lax

from gigalens_tpu.profiles.base import LightProfile


def _triangular_order(n_max):
    """(n1, n2) pairs in the reference's ordering."""
    n1, n2 = 0, 0
    pairs = []
    for _ in range((n_max + 1) * (n_max + 2) // 2):
        pairs.append((n1, n2))
        if n1 == 0:
            n1, n2 = n2 + 1, 0
        else:
            n1, n2 = n1 - 1, n2 + 1
    return pairs


def hermite_stack(u, n_max):
    """Physicists' Hermite polynomials H_0..H_nmax at u, stacked on axis 0."""
    h_prev = jnp.ones_like(u)
    if n_max == 0:
        return h_prev[None]
    h_curr = 2 * u

    def step(carry, n):
        h_nm1, h_n = carry
        h_np1 = 2 * (u * h_n - n * h_nm1)
        return (h_n, h_np1), h_np1

    ns = jnp.arange(1, n_max, dtype=u.dtype)
    _, rest = lax.scan(step, (h_prev, h_curr), ns)
    return jnp.concatenate([h_prev[None], h_curr[None], rest], axis=0)


class Shapelets(LightProfile):
    _name = "SHAPELETS"
    _params = ["beta", "center_x", "center_y"]
    _amp = ""  # amplitudes are the numbered amp params below

    def __init__(self, n_max, use_lstsq=False, interpolate=False):
        if interpolate:
            raise NotImplementedError(
                "table-interpolation path intentionally dropped; the Hermite "
                "recurrence is exact and needs no gather"
            )
        self.n_max = int(n_max)
        self.n_layers = (self.n_max + 1) * (self.n_max + 2) // 2
        pairs = _triangular_order(self.n_max)
        self._n1 = np.array([p[0] for p in pairs])
        self._n2 = np.array([p[1] for p in pairs])
        width = len(str(self.n_layers))
        self._amp_names = [f"amp{str(i).zfill(width)}" for i in range(self.n_layers)]

        super().__init__(use_lstsq=use_lstsq)
        self.depth = self.n_layers
        if not use_lstsq:
            self.params.extend(self._amp_names)

        n = np.arange(self.n_max + 1, dtype=np.float64)
        self._prefactor = jnp.asarray(
            1.0 / np.sqrt(2.0**n * np.sqrt(np.pi) * np.array([math.factorial(int(k)) for k in n])),
            jnp.float32,
        )

    # amplitude bookkeeping overrides (LightProfile assumes a single _amp)
    @LightProfile.use_lstsq.setter
    def use_lstsq(self, use_lstsq: bool):
        if use_lstsq and not self._use_lstsq:
            for a in self._amp_names:
                self.params.remove(a)
        elif not use_lstsq and self._use_lstsq:
            self.params.extend(self._amp_names)
        self._use_lstsq = bool(use_lstsq)

    def light(self, x, y, beta, center_x, center_y, **amps):
        u = (x - center_x) / beta
        v = (y - center_y) / beta
        hu = self._prefactor.reshape((-1,) + (1,) * jnp.ndim(u)) * hermite_stack(u, self.n_max)
        hv = self._prefactor.reshape((-1,) + (1,) * jnp.ndim(v)) * hermite_stack(v, self.n_max)
        gauss = jnp.exp(-(u**2 + v**2) / 2.0)
        basis = gauss[None] * hu[self._n1] * hv[self._n2]  # (n_layers, ...)
        if self.use_lstsq:
            return basis
        amp = jnp.stack([jnp.asarray(amps[k]) for k in self._amp_names])  # (L, ...)
        while amp.ndim < basis.ndim:
            amp = amp[..., None]
        return jnp.sum(amp * basis, axis=0)
