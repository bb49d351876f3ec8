"""Hernquist-profile deflectors: spherical and elliptical.

Beyond the reference's profile set (no counterpart under
``src/gigalens/jax/profiles/mass/``): the Hernquist (1990) sphere is the
standard model for the *stellar* mass of the lens galaxy in composite
(stars + dark-halo) lens models, complementing the NFW family already in
the package. Projected-lensing closed forms follow Keeton (2001,
astro-ph/0102341 §4); same conventions as lenstronomy's ``HERNQUIST``:
``sigma0`` is the characteristic convergence, ``Rs`` the scale radius.

The structure mirrors :mod:`.nfw`: every piecewise special function is
a total ``jnp.where`` with branch-safe inputs, and the x = 1 branch point is
covered by a two-sided Taylor series (coefficients from sympy), so ``deriv``
and ``hessian`` are float32-stable and differentiable everywhere — safe
under ``pjit``.
"""
from __future__ import annotations

import jax.numpy as jnp

from gigalens_tpu.profiles.base import MassProfile, ellipticity_to_polar, rotate

_R_MIN = 1e-7
_X_MIN = 1e-6

# Two-sided Taylor series at the x = 1 branch point (t = x - 1), sympy-derived
# from the analytic continuation of F(x) = arctan(sqrt(x^2-1))/sqrt(x^2-1):
#   F        = 1 - 2t/3 + 7t^2/15 - 12t^3/35 + 83t^4/315 - 146t^5/693
#   alpha/x' = x(1-F)/(x^2-1)          (deflection shape, alpha = 2 sigma0 Rs *)
#            = 1/3 - t/15 - t^2/35 + 17t^3/315 - 37t^4/693
#   kappa    = ((2+x^2)F - 3)/(x^2-1)^2  (convergence shape, kappa = sigma0 *)
#            = 4/15 - 16t/35 + 8t^2/15 - 368t^3/693 + 1468t^4/3003
_BRANCH_DELTA = 0.03
_ALPHA_SERIES = (1 / 3, -1 / 15, -1 / 35, 17 / 315, -37 / 693)
_KAPPA_SERIES = (4 / 15, -16 / 35, 8 / 15, -368 / 693, 1468 / 3003)


def _horner(t, coeffs):
    acc = jnp.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _hern_f(x):
    """F(x): arctanh/arctan special function; F(1) = 1."""
    x = jnp.maximum(x, _X_MIN)
    x_lo = jnp.where(x < 1, x, 0.5)
    x_hi = jnp.where(x > 1, x, 2.0)
    lo = jnp.arctanh(jnp.sqrt(1.0 - x_lo**2)) / jnp.sqrt(1.0 - x_lo**2)
    hi = jnp.arctan(jnp.sqrt(x_hi**2 - 1.0)) / jnp.sqrt(x_hi**2 - 1.0)
    return jnp.where(x < 1, lo, hi)


def _alpha_shape(x):
    """x (1 - F(x)) / (x^2 - 1), series-patched at x = 1; alpha(1) shape 1/3."""
    x = jnp.maximum(x, _X_MIN)
    near = jnp.abs(x - 1.0) < _BRANCH_DELTA
    x_safe = jnp.where(near, 2.0, x)
    closed = x_safe * (1.0 - _hern_f(x_safe)) / (x_safe**2 - 1.0)
    return jnp.where(near, _horner(x - 1.0, _ALPHA_SERIES), closed)


def _kappa_shape(x):
    """((2 + x^2) F(x) - 3) / (x^2 - 1)^2, series-patched; kappa(1) shape 4/15."""
    x = jnp.maximum(x, _X_MIN)
    near = jnp.abs(x - 1.0) < _BRANCH_DELTA
    x_safe = jnp.where(near, 2.0, x)
    closed = ((2.0 + x_safe**2) * _hern_f(x_safe) - 3.0) / (x_safe**2 - 1.0) ** 2
    return jnp.where(near, _horner(x - 1.0, _KAPPA_SERIES), closed)


class Hernquist(MassProfile):
    """Spherical Hernquist lens: alpha(x) = 2 sigma0 Rs x (1-F(x))/(x^2-1)."""

    _name = "HERNQUIST"
    _params = ["sigma0", "Rs", "center_x", "center_y"]

    def deriv(self, x, y, sigma0, Rs, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        R = jnp.maximum(jnp.sqrt(dx * dx + dy * dy), _R_MIN)
        Rs = jnp.maximum(Rs, _R_MIN)
        X = R / Rs
        # alpha / R = 2 sigma0 Rs shape(X) / R = 2 sigma0 shape(X) / X
        a_over_r = 2.0 * sigma0 * _alpha_shape(X) / X
        return a_over_r * dx, a_over_r * dy

    def hessian(self, x, y, sigma0, Rs, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        R = jnp.maximum(jnp.sqrt(dx * dx + dy * dy), _R_MIN)
        Rs = jnp.maximum(Rs, _R_MIN)
        X = R / Rs
        kappa = sigma0 * _kappa_shape(X)
        # mean convergence inside R is alpha/R; shear = kbar - kappa
        kbar = 2.0 * sigma0 * _alpha_shape(X) / X
        gamma = kbar - kappa
        c1 = (dy * dy - dx * dx) / (R * R)
        c2 = -2.0 * dx * dy / (R * R)
        return kappa + gamma * c1, gamma * c2, gamma * c2, kappa - gamma * c1

    def convergence(self, x, y, sigma0, Rs, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        R = jnp.maximum(jnp.sqrt(dx * dx + dy * dy), _R_MIN)
        X = R / jnp.maximum(Rs, _R_MIN)
        return sigma0 * _kappa_shape(X)


class HernquistEllipse(MassProfile):
    """Ellipticity by coordinate stretch around the spherical Hernquist,
    the same construction as :class:`.nfw.NFW_ELLIPSE`."""

    _name = "HERNQUIST_ELLIPSE"
    _params = ["sigma0", "Rs", "e1", "e2", "center_x", "center_y"]

    def __init__(self):
        super().__init__()
        self._sphere = Hernquist()

    def deriv(self, x, y, sigma0, Rs, e1, e2, center_x, center_y):
        _, q, phi = ellipticity_to_polar(e1, e2)
        e = jnp.abs(1 - q**2) / (1 + q**2)
        dx, dy = rotate(x - center_x, y - center_y, phi)
        xs, ys = dx * jnp.sqrt(1 - e), dy * jnp.sqrt(1 + e)
        fx, fy = self._sphere.deriv(xs, ys, sigma0, Rs, 0.0, 0.0)
        fx = fx * jnp.sqrt(1 - e)
        fy = fy * jnp.sqrt(1 + e)
        return rotate(fx, fy, -phi)
