"""Elliptical power-law (EPL) deflector.

Angular-series solution of Tessore & Metcalf (2015), as used by the reference
(``src/gigalens/jax/profiles/mass/epl.py:9-53``). The deflection in the
ellipse-aligned frame is

    alpha(R, theta) = (2 b)/(1+q) (b/R)^(t-1) * Omega(theta),
    Omega = sum_n a_n,   a_n = [prod_k ratio_k(f, t)] e^{i(2n+1)theta},

computed with ``lax.scan``. Naive reverse-mode through the scan stores every
per-iteration carry — niter * (bs, npix) * 4 arrays, ~10 GB at the benchmark
scale — so :func:`_omega_cs` carries a **custom VJP** exploiting the series
structure for O(1)-memory exact gradients:

    d a_n / d theta = i (2n+1) a_n
    d a_n / d f     = (n / f) a_n                     (each ratio_k ∝ f)
    d a_n / d t     = [sum_k 1/(2k-2+t) + 1/(2k+2-t)] a_n

The backward pass is one fresh scan that regenerates a_n on the fly and
accumulates the three contractions — ~1x forward cost, no stored residuals.

The reference's TF substrate truncates the series adaptively
(``src/gigalens/tf/profiles/mass/epl.py:37-54``); ``EPL.recommended_niter``
exposes the same convergence bound so callers can pick a static depth with the
same guarantee (static shapes are required under jit).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

from gigalens_tpu.profiles.base import MassProfile, ellipticity_to_polar, rotate

# The series loops run fully unrolled: unrolled, XLA fuses the whole series
# into one kernel instead of sending its (bs, npix) carries through device
# memory on every iteration (likelihood value-and-grad at bs=1000 about 3x
# faster than unroll=1 on an H100; see docs/kernels.md).
_UNROLL = True


def _omega_cs_impl(cos_t, sin_t, f, t, niter):
    """Raw angular series from (cos theta, sin theta) — see :func:`_omega_cs`.

    Taking cos/sin directly (they are algebraic in the ellipse-frame
    coordinates: cos = q x / R, sin = y / R) keeps the series free of
    inverse-trig evaluations.
    """
    cos_2t = cos_t * cos_t - sin_t * sin_t
    sin_2t = 2.0 * cos_t * sin_t

    def step(i, carry):
        ax, ay, ox, oy = carry
        n = i.astype(cos_t.dtype)
        ratio = -f * (2 * n - (2 - t)) / (2 * n + (2 - t))
        ax, ay = ratio * (cos_2t * ax - sin_2t * ay), ratio * (sin_2t * ax + cos_2t * ay)
        return (ax, ay, ox + ax, oy + ay)

    _, _, ox, oy = lax.fori_loop(
        1, niter, step, (cos_t, sin_t, cos_t, sin_t), unroll=_UNROLL
    )
    return ox, oy


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def _omega_cs(cos_t, sin_t, f, t, niter):
    """Angular series Omega = sum_n a_n from (cos theta, sin theta).

    cos_t/sin_t: ellipse-frame polar direction (q x / R, y / R); f:
    ellipticity ratio (1-q)/(1+q); t: 2D log-slope (gamma - 1); niter:
    static series depth. Returns (Re Omega, Im Omega).
    """
    return _omega_cs_impl(cos_t, sin_t, f, t, niter)


def _omega_cs_fwd(cos_t, sin_t, f, t, niter):
    return _omega_cs(cos_t, sin_t, f, t, niter), (cos_t, sin_t, f, t)


def _reduce_to(g, x):
    extra = g.ndim - jnp.ndim(x)
    if extra:
        g = jnp.sum(g, axis=tuple(range(extra)))
    for i, (gs, xs) in enumerate(zip(g.shape, jnp.shape(x))):
        if xs == 1 and gs != 1:
            g = jnp.sum(g, axis=i, keepdims=True)
    return g


def _omega_cs_bwd(niter, res, ct):
    """O(1)-memory exact VJP: one fresh loop regenerating a_n on the fly.

    a_n is homogeneous of degree 2n+1 in (cos_t, sin_t) — a_n(rho e^{i
    theta}) = rho^{2n+1} a_n(e^{i theta}) for the implementation's own
    off-circle extension (a_0 linear, the rotation matrix quadratic) — so
    the input cotangents decompose exactly into radial and tangential
    parts:

        d a_n / d theta = i (2n+1) a_n        d a_n / d rho = (2n+1) a_n
        g_c = cos_t * g_rho - sin_t * g_th    g_s = sin_t * g_rho + cos_t * g_th

    plus the parameter partials (each ratio_k proportional to f; the
    digamma-like partial sum for t):

        d a_n / d f = (n / f) a_n
        d a_n / d t = [sum_k 1/(2k-2+t) + 1/(2k+2-t)] a_n
    """
    cos_t, sin_t, f, t = res
    ct_x, ct_y = ct
    # f32 rounds f = (1-q)/(1+q) to exactly 0 at zero ellipticity, and the
    # (n / f) parameter partial below would then produce inf * 0 = NaN
    # (poisoning every gradient column of a MAP/SVI start from the prior
    # mean). Floor it: a_n regenerated with f=1e-20 is ~0 for n >= 1, so
    # g_f comes out 0 — consistent with the zero chain-rule factor de/de1
    # at the guarded origin of ellipticity_to_polar/half_angle.
    f = jnp.maximum(f, 1e-20)
    cos_2t = cos_t * cos_t - sin_t * sin_t
    sin_2t = 2.0 * cos_t * sin_t

    shape = jnp.broadcast_shapes(
        jnp.shape(cos_t), jnp.shape(f), jnp.shape(t), jnp.shape(ct_x)
    )
    zero = jnp.zeros(shape)

    # s_t (the digamma partial sum) depends only on t — carry it at t's
    # (bs, 1) shape so the two per-iteration divisions don't run per-pixel
    s_t0 = jnp.zeros(jnp.broadcast_shapes(jnp.shape(t), jnp.shape(f)))

    def step(i, carry):
        ax, ay, s_t, g_th, g_rho, g_f, g_t = carry
        n = i.astype(cos_t.dtype)
        ratio = -f * (2 * n - (2 - t)) / (2 * n + (2 - t))
        ax, ay = ratio * (cos_2t * ax - sin_2t * ay), ratio * (sin_2t * ax + cos_2t * ay)
        s_t = s_t + 1.0 / (2 * n - 2 + t) + 1.0 / (2 * n + 2 - t)
        dot = ct_x * ax + ct_y * ay
        g_th = g_th + (2 * n + 1) * (-ct_x * ay + ct_y * ax)
        g_rho = g_rho + (2 * n + 1) * dot
        g_f = g_f + (n / f) * dot
        g_t = g_t + s_t * dot
        return (ax, ay, s_t, g_th, g_rho, g_f, g_t)

    # n = 0 term: a_0 = (cos_t, sin_t)
    g_th0 = -ct_x * sin_t + ct_y * cos_t
    g_rho0 = ct_x * cos_t + ct_y * sin_t
    _, _, _, g_th, g_rho, g_f, g_t = lax.fori_loop(
        1, niter, step, (cos_t, sin_t, s_t0, g_th0, g_rho0, zero, zero),
        unroll=_UNROLL,
    )
    g_c = cos_t * g_rho - sin_t * g_th
    g_s = sin_t * g_rho + cos_t * g_th
    return (
        _reduce_to(g_c, cos_t), _reduce_to(g_s, sin_t),
        _reduce_to(g_f, f), _reduce_to(g_t, t),
    )


_omega_cs.defvjp(_omega_cs_fwd, _omega_cs_bwd)


class EPL(MassProfile):
    _name = "EPL"
    _params = ["theta_E", "gamma", "e1", "e2", "center_x", "center_y"]

    def __init__(self, niter: int = 18):
        super().__init__()
        self.niter = int(niter)

    @staticmethod
    def recommended_niter(q_min: float, tol: float = 1e-12) -> int:
        """Series depth giving truncation error < tol for axis ratios >= q_min.

        The series converges geometrically with ratio f = (1-q)/(1+q); this is
        the static-shape analogue of the reference TF substrate's adaptive
        ``log(tol)/log(f) + 2`` bound.
        """
        f = (1 - q_min) / (1 + q_min)
        if f <= 0:
            return 2
        return int(math.ceil(math.log(tol) / math.log(f))) + 2

    def deriv(self, x, y, theta_E, gamma, e1, e2, center_x, center_y):
        _, q, phi = ellipticity_to_polar(e1, e2, e_max=1.0)
        # Convert theta_E (intermediate-axis convention) to the scale length b.
        b = theta_E * jnp.sqrt(2 * q / (1 + q**2)) * jnp.sqrt((1 + q**2) / 2)
        t = gamma - 1  # 2D log-slope

        x, y = rotate(x - center_x, y - center_y, phi)
        R = jnp.clip(jnp.sqrt((q * x) ** 2 + y**2), 1e-10, 1e10)
        # polar direction algebraically — no arctan2 (the series only needs
        # cos/sin, and dividing by the clipped R is exact and smooth)
        cos_t, sin_t = q * x / R, y / R

        f = (1 - q) / (1 + q)
        omega_x, omega_y = _omega_cs(cos_t, sin_t, f, t, self.niter)

        prefac = (2 * b) / (1 + q) * (b / R) ** (t - 1)
        return rotate(prefac * omega_x, prefac * omega_y, -phi)

    def potential(self, x, y, theta_E, gamma, e1, e2, center_x, center_y):
        """Euler identity for the power-law family: the deflection is
        homogeneous of degree ``2 - gamma`` in the centered coords, so
        ``psi = x~ . alpha / (3 - gamma)`` exactly (Tessore & Metcalf 2015)."""
        fx, fy = self.deriv(x, y, theta_E, gamma, e1, e2, center_x, center_y)
        return ((x - center_x) * fx + (y - center_y) * fy) / (3.0 - gamma)

    def hessian(self, x, y, **params):
        # forward-mode cannot cross _omega_cs's custom_vjp; use the reverse basis
        return self.hessian_vjp(x, y, **params)
