"""NFW-family deflectors: spherical NFW, elliptical NFW, truncated NFW.

Formulas from Wright & Brainerd (2000) (NFW g/F special functions) and
Baltz, Marshall & Oguri (2009) (truncated NFW), as used by the reference
(``src/gigalens/jax/profiles/mass/nfw.py``, ``tnfw.py``).

Difference from the reference: the reference evaluates the piecewise special functions
with boolean-indexed ``.at[].set`` updates (``nfw.py:38-66``) which are
shape-dynamic and unsafe under ``pjit``; here every piecewise function is a
total ``jnp.where`` with branch-safe inputs (the "double-where" pattern), so
the functions are differentiable and partitionable everywhere.
"""
from __future__ import annotations

import jax.numpy as jnp

from gigalens_tpu.profiles.base import MassProfile, ellipticity_to_polar, rotate

_R_MIN = 1e-7
_X_MIN = 1e-6


# Near the branch point x = 1 both closed forms cancel catastrophically in
# float32 (the reference inherits this, nfw.py:38-66). Within |x-1| < delta we
# switch to the (two-sided analytic) Taylor series at x=1, coefficients from
# sympy: F = 1/3 - 2/5 t + 13/35 t^2 - 20/63 t^3 + 61/231 t^4 (t = x-1);
# g = (1 - log 2) + t/3 - t^2/30 - t^3/105 + 17 t^4/1260.
_BRANCH_DELTA = 0.03
_SMALL_X = 0.05
_F_SERIES = (1 / 3, -2 / 5, 13 / 35, -20 / 63, 61 / 231)
_G_SERIES = (0.30685281944005469, 1 / 3, -1 / 30, -1 / 105, 17 / 1260)


def _horner(t, coeffs):
    acc = jnp.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _branch_inputs(x):
    """Branch-safe inputs for the two closed forms, clamped at the SERIES
    window edges, not at x = 1.

    Clamping only against the wrong side (``where(x < 1, x, 0.5)``) still
    lets x within one f32 ulp of 1 reach the closed form, where ``1/x``
    rounds to exactly 1.0 and ``arccosh/arccos`` differentiate to 1/0 = inf;
    the selecting ``where`` zeroes that branch's cotangent, and 0 * inf = NaN
    leaks through the backward pass (caught by the cluster posterior bench:
    one SVI draw with the grid corner at R = Rs NaN'd the whole ELBO).
    Since the series is always selected for |x-1| < delta, the closed forms'
    inputs can be kept strictly outside the window, making both value AND
    gradient finite everywhere."""
    x_lo = jnp.where(x < 1.0 - _BRANCH_DELTA, x, 0.5)
    x_hi = jnp.where(x > 1.0 + _BRANCH_DELTA, x, 2.0)
    return x_lo, x_hi


def _nfw_g(x):
    """g(x) such that alpha = 4 rho0 Rs g(x)/x * x_hat; g(1) = 1 + log(1/2).

    Two series regions: around the x = 1 branch point (closed forms cancel),
    and x -> 0 where ``log(x/2) + arccosh(1/x)/sqrt(1-x^2)`` cancels
    catastrophically in float32 (both terms ~ |log x| while g ~ x^2 |log x|;
    relative error blows up ~1/x^2). The small-x expansion
    g = x^2 (L/2 - 1/4) + x^4 (3L/8 - 7/32) + O(x^6 L), L = log(2/x),
    is exact to f32 below x = 0.05."""
    x = jnp.maximum(x, _X_MIN)
    near = jnp.abs(x - 1.0) < _BRANCH_DELTA
    small = x < _SMALL_X
    x_lo, x_hi = _branch_inputs(x)
    lo = jnp.log(x / 2.0) + jnp.arccosh(1.0 / x_lo) / jnp.sqrt(1.0 - x_lo**2)
    hi = jnp.log(x / 2.0) + jnp.arccos(1.0 / x_hi) / jnp.sqrt(x_hi**2 - 1.0)
    series = _horner(x - 1.0, _G_SERIES)
    L = jnp.log(2.0 / x)
    small_series = x**2 * (0.5 * L - 0.25) + x**4 * (0.375 * L - 7.0 / 32.0)
    return jnp.where(
        small, small_series, jnp.where(near, series, jnp.where(x < 1, lo, hi))
    )


def _nfw_h(x):
    """h(x) with dh/dx = g(x)/x; the NFW potential shape (W&B 2000 eq. 9).

    h(1) = ln^2(1/2)/2; the near-branch series integrates the g series
    term-by-term (coefficients of g(u)/u around u=1, then antiderivative).
    """
    x = jnp.maximum(x, _X_MIN)
    near = jnp.abs(x - 1.0) < _BRANCH_DELTA
    x_lo, x_hi = _branch_inputs(x)
    lo = 0.5 * jnp.log(x / 2.0) ** 2 - 0.5 * jnp.arccosh(1.0 / x_lo) ** 2
    hi = 0.5 * jnp.log(x / 2.0) ** 2 + 0.5 * jnp.arccos(1.0 / x_hi) ** 2
    series = _horner(x - 1.0, _H_SERIES)
    return jnp.where(near, series, jnp.where(x < 1, lo, hi))


# h(1) = ln^2(2)/2, then cumulative integral of the g(u)/u Cauchy product
_H_SERIES = (
    0.2402265069591007,
    0.30685281944005469,
    0.013240256946639322,
    -0.019937975181398853,
    0.012572504860063681,
)


def _nfw_f(x):
    """F(x) = convergence shape function; F(1) = 1/3."""
    x = jnp.maximum(x, _X_MIN)
    near = jnp.abs(x - 1.0) < _BRANCH_DELTA
    x_lo, x_hi = _branch_inputs(x)
    lo = (
        1.0
        / (x_lo**2 - 1.0)
        * (1.0 - 2.0 / jnp.sqrt(1.0 - x_lo**2) * jnp.arctanh(jnp.sqrt((1.0 - x_lo) / (1.0 + x_lo))))
    )
    hi = (
        1.0
        / (x_hi**2 - 1.0)
        * (1.0 - 2.0 / jnp.sqrt(x_hi**2 - 1.0) * jnp.arctan(jnp.sqrt((x_hi - 1.0) / (1.0 + x_hi))))
    )
    series = _horner(x - 1.0, _F_SERIES)
    return jnp.where(near, series, jnp.where(x < 1, lo, hi))


class NFW(MassProfile):
    _name = "NFW"
    _params = ["Rs", "alpha_Rs", "center_x", "center_y"]

    @staticmethod
    def _rho0(Rs, alpha_Rs):
        """Characteristic density from the deflection at Rs."""
        return alpha_Rs / (4.0 * Rs**2 * (1.0 - jnp.log(2.0)))

    def _alpha_radial(self, R, Rs, rho0, ax_x, ax_y):
        R = jnp.maximum(R, _R_MIN)
        Rs = jnp.maximum(Rs, _R_MIN)
        x = R / Rs
        a = 4.0 * rho0 * Rs * _nfw_g(x) / x**2
        return a * ax_x, a * ax_y

    def deriv(self, x, y, Rs, alpha_Rs, center_x, center_y):
        rho0 = self._rho0(Rs, alpha_Rs)
        dx, dy = x - center_x, y - center_y
        R = jnp.sqrt(dx**2 + dy**2)
        return self._alpha_radial(R, Rs, rho0, dx, dy)

    def potential(self, x, y, Rs, alpha_Rs, center_x, center_y):
        rho0 = self._rho0(Rs, alpha_Rs)
        Rs = jnp.maximum(Rs, _R_MIN)
        dx, dy = x - center_x, y - center_y
        R = jnp.maximum(jnp.sqrt(dx**2 + dy**2), _R_MIN)
        return 4.0 * rho0 * Rs**3 * _nfw_h(R / Rs)

    def hessian(self, x, y, Rs, alpha_Rs, center_x, center_y):
        rho0 = self._rho0(Rs, alpha_Rs)
        Rs = jnp.maximum(Rs, _R_MIN)
        dx, dy = x - center_x, y - center_y
        R = jnp.maximum(jnp.sqrt(dx**2 + dy**2), _X_MIN)
        X = R / Rs
        gx = _nfw_g(X)
        fx = _nfw_f(X)
        kappa = 2.0 * rho0 * Rs * fx
        a = 2.0 * rho0 * Rs * (2.0 * gx / X**2 - fx)
        gamma1 = a * (dy**2 - dx**2) / R**2
        gamma2 = -a * 2.0 * dx * dy / R**2
        return kappa + gamma1, gamma2, gamma2, kappa - gamma1


class NFW_ELLIPSE(MassProfile):
    """Ellipticity introduced by stretching coordinates around spherical NFW
    (reference: ``nfw.py:87-124``)."""

    _name = "NFW_ELLIPSE"
    _params = ["Rs", "alpha_Rs", "e1", "e2", "center_x", "center_y"]

    def __init__(self):
        super().__init__()
        self._nfw = NFW()

    def deriv(self, x, y, Rs, alpha_Rs, e1, e2, center_x, center_y):
        rho0 = NFW._rho0(Rs, alpha_Rs)
        _, q, phi = ellipticity_to_polar(e1, e2)
        e = jnp.abs(1 - q**2) / (1 + q**2)

        x, y = rotate(x - center_x, y - center_y, phi)
        xs, ys = x * jnp.sqrt(1 - e), y * jnp.sqrt(1 + e)
        R = jnp.sqrt(xs**2 + ys**2)
        fx, fy = self._nfw._alpha_radial(R, Rs, rho0, xs, ys)
        fx = fx * jnp.sqrt(1 - e)
        fy = fy * jnp.sqrt(1 + e)
        return rotate(fx, fy, -phi)


class TNFW(MassProfile):
    """Truncated NFW (Baltz, Marshall & Oguri 2009), truncation tau = r_trunc/Rs."""

    _name = "TNFW"
    _params = ["Rs", "alpha_Rs", "r_trunc", "center_x", "center_y"]

    # Taylor series of atanh(sqrt(1-x^2))/sqrt(1-x^2) at x=1 (sympy)
    _F_SERIES = (1.0, -2 / 3, 7 / 15, -12 / 35, 83 / 315)

    @classmethod
    def _F(cls, x):
        x = jnp.maximum(x, _X_MIN)
        near = jnp.abs(x - 1.0) < _BRANCH_DELTA
        x_lo, x_hi = _branch_inputs(x)
        lo = jnp.arctanh(jnp.sqrt(1.0 - x_lo**2)) / jnp.sqrt(1.0 - x_lo**2)
        hi = jnp.arctan(jnp.sqrt(x_hi**2 - 1.0)) / jnp.sqrt(x_hi**2 - 1.0)
        series = _horner(x - 1.0, cls._F_SERIES)
        return jnp.where(near, series, jnp.where(x < 1, lo, hi))

    @staticmethod
    def _g(X, tau):
        """Baltz+ 2009 lensing mass shape function, float32-stable.

        The closed form cancels ~tau^2*log(x)-sized terms down to O(x^2 log x)
        as x -> 0, losing all float32 digits; below X_SWITCH the exact
        small-x series (sympy-derived; log-x terms resummed to 0.5*ln(2/x)
        and (3 tau^2 - 1)/(8 tau^2) * ln(2/x)) is used instead.
        """
        X_SWITCH = 0.1
        X_safe = jnp.maximum(X, X_SWITCH / 2)  # branch-safe input for closed form

        L = jnp.log(X_safe / (tau + jnp.sqrt(tau**2 + X_safe**2)))
        F = TNFW._F(X_safe)
        closed = (
            tau**2
            / (tau**2 + 1.0) ** 2
            * (
                (tau**2 + 1.0 + 2.0 * (X_safe**2 - 1.0)) * F
                + tau * jnp.pi
                + (tau**2 - 1.0) * jnp.log(tau)
                + jnp.sqrt(tau**2 + X_safe**2) * (-jnp.pi + L * (tau**2 - 1.0) / tau)
            )
        )

        ln2x = jnp.log(2.0 / X)
        ltau = jnp.log(tau)
        t2 = tau**2
        denom = 4.0 * (t2 + 1.0) ** 2
        a2 = 0.5 * ln2x + (1.0 - t2**2 + 2.0 * (1.0 - t2) * ltau - 2.0 * jnp.pi * tau) / denom
        a4 = (3.0 * t2 - 1.0) / (8.0 * t2) * ln2x + (
            -7.0 * t2**3 - 9.0 * t2**2 - t2 + 1.0 + 4.0 * (t2 - 1.0) * ltau + 4.0 * jnp.pi * tau
        ) / (8.0 * t2 * denom)
        series = X**2 * a2 + X**4 * a4

        return jnp.where(X < X_SWITCH, series, closed)

    def deriv(self, x, y, Rs, alpha_Rs, r_trunc, center_x, center_y):
        rho0 = alpha_Rs / (4.0 * Rs**2 * (1.0 + jnp.log(0.5)))
        dx, dy = x - center_x, y - center_y
        R = jnp.maximum(jnp.sqrt(dx**2 + dy**2), 1e-4 * Rs)
        X = R / Rs
        tau = r_trunc / Rs
        a = 4.0 * rho0 * Rs * self._g(X, tau) / X**2
        return a * dx, a * dy
