"""Dual pseudo-isothermal deflectors (dPIS / dPIE / dPIEP).

The cluster-scale workhorses (Lenstool-compatible), after Kassiola & Kovner
(1993) §4.1 and Eliasdottir et al. (2007); reference:
``src/gigalens/jax/profiles/mass/piemd.py``, ``piep.py``.

Model: difference of two pseudo-isothermal profiles with core radius
``r_core`` and cut radius ``r_cut``,

    kappa(R) = theta_E/2 * r_cut/(r_cut - r_core)
               * (1/sqrt(R^2 + r_core^2) - 1/sqrt(R^2 + r_cut^2)).

The elliptical dPIE deflection is the Kassiola & Kovner complex formula
J = A * log(u_core/u_cut) evaluated here with explicit (re, im) float pairs —
complex64 lowers to the same real arithmetic but can block XLA fusions,
and float pairs keep the whole pipeline in plain f32 vector ops.

Runtime Hessians for the elliptical dPIE use the package-default forward-mode
AD of ``deriv`` (exact, and fused by XLA into the same pass); the spherical
dPIS keeps its cheap closed form.
"""
from __future__ import annotations

import jax.numpy as jnp

from gigalens_tpu.profiles.base import MassProfile, ellipticity_to_polar, rotate

_R_MIN = 1e-4


def _sort_core_cut(r_core, r_cut):
    """Enforces r_core < r_cut (reference guard, ``piemd.py:55-63``).

    ``hi`` is floored at ``lo + _R_MIN`` so the ``r_cut/(r_cut - r_core)``
    scale never divides by zero — with both radii 0 (e.g. a zero-luminosity
    padded galaxy in a scaling relation) the old ``hi + _R_MIN`` form made
    hi == lo and produced 0/0 = NaN, which poisoned whole member sums."""
    lo = jnp.minimum(r_core, r_cut)
    hi = jnp.maximum(r_core, r_cut)
    lo = jnp.maximum(_R_MIN, lo)
    hi = jnp.maximum(hi, lo + _R_MIN)
    return lo, hi


class DPIS(MassProfile):
    """Dual pseudo-isothermal sphere (Eliasdottir 2007 eq. A20)."""

    _name = "dPIS"
    _params = ["theta_E", "r_core", "r_cut", "center_x", "center_y"]

    def deriv(self, x, y, theta_E, r_core, r_cut, center_x, center_y):
        r_core, r_cut = _sort_core_cut(r_core, r_cut)
        dx, dy = x - center_x, y - center_y
        r2 = dx**2 + dy**2
        scale = theta_E * r_cut / (r_cut - r_core)
        # f_A20 * r == sqrt(r^2+a^2) - a - sqrt(r^2+s^2) + s
        f = jnp.sqrt(r2 + r_core**2) - r_core - jnp.sqrt(r2 + r_cut**2) + r_cut
        alpha_over_r = scale * f / jnp.maximum(r2, _R_MIN**2)
        return alpha_over_r * dx, alpha_over_r * dy

    def hessian(self, x, y, theta_E, r_core, r_cut, center_x, center_y):
        r_core, r_cut = _sort_core_cut(r_core, r_cut)
        dx, dy = x - center_x, y - center_y
        r = jnp.maximum(jnp.sqrt(dx**2 + dy**2), _R_MIN)
        scale = theta_E * r_cut / (r_cut - r_core)
        sq_core = jnp.sqrt(r_core**2 + r**2)
        sq_cut = jnp.sqrt(r_cut**2 + r**2)
        gamma = (
            scale
            / 2
            * (
                2 * (1.0 / (r_core + sq_core) - 1.0 / (r_cut + sq_cut))
                - (1.0 / sq_core - 1.0 / sq_cut)
            )
        )
        # kappa = div(alpha)/2 = scale/2 (1/sq_core - 1/sq_cut); the reference
        # multiplies by an extra (r_core+r_cut)/r_cut (piemd.py:78-79) which is
        # inconsistent with AD of its own deriv — not replicated here.
        kappa = scale / 2 * (1.0 / sq_core - 1.0 / sq_cut)
        cos_2phi = (dy**2 - dx**2) / r**2
        sin_2phi = -2 * dx * dy / r**2
        gamma1 = cos_2phi * gamma
        gamma2 = sin_2phi * gamma
        return kappa + gamma1, gamma2, gamma2, kappa - gamma1

    def convergence(self, x, y, theta_E, r_core, r_cut, center_x=0.0, center_y=0.0):
        r_core, r_cut = _sort_core_cut(r_core, r_cut)
        dx, dy = x - center_x, y - center_y
        r = jnp.maximum(jnp.sqrt(dx**2 + dy**2), _R_MIN)
        scale = theta_E * r_cut / (r_cut - r_core)
        return (
            scale
            / 2
            * (1.0 / jnp.sqrt(r_core**2 + r**2) - 1.0 / jnp.sqrt(r_cut**2 + r**2))
        )


def _dpie_complex_alpha(x, y, r_core, r_cut, e, q):
    """K&K 4.1.2 dual-radius complex deflection in the ellipse frame.

    Evaluates I = -(1-e^2)/(2 sqrt(e)) * log(u_core / u_cut) with
    u_w = (q x + i (2 sqrt(e) sqrt(w^2 + rem2) - y/q)) / (x + i (2 w sqrt(e) - y)),
    as (re, im) float pairs. Returns (alpha_x, alpha_y) = (Re, Im) of i*I's
    conjugate arrangement, i.e. (-Im, +Re) of the log times the prefactor.
    """
    sqe = jnp.sqrt(e)
    rem2 = x**2 / (1.0 + e) ** 2 + y**2 / (1.0 - e) ** 2

    # u_w numerator/denominator components for w = r_core and w = r_cut
    a = q * x                                   # Re(num), shared
    b_core = 2.0 * sqe * jnp.sqrt(r_core**2 + rem2) - y / q  # Im(num_core)
    b_cut = 2.0 * sqe * jnp.sqrt(r_cut**2 + rem2) - y / q    # Im(num_cut)
    c = x                                       # Re(den), shared
    d_core = 2.0 * r_core * sqe - y             # Im(den_core)
    d_cut = 2.0 * r_cut * sqe - y               # Im(den_cut)

    # ratio = (num_core/den_core) / (num_cut/den_cut)
    #       = (num_core * den_cut) / (den_core * num_cut)
    top_re = a * c - b_core * d_cut
    top_im = a * d_cut + b_core * c
    bot_re = a * c - b_cut * d_core
    bot_im = a * d_core + b_cut * c

    # complex division (top / bot)
    bot2 = bot_re**2 + bot_im**2
    z_re = (top_re * bot_re + top_im * bot_im) / bot2
    z_im = (top_im * bot_re - top_re * bot_im) / bot2

    # complex log
    log_re = 0.5 * jnp.log(z_re**2 + z_im**2)
    log_im = jnp.arctan2(z_im, z_re)

    pref = -0.5 * (1.0 - e**2) / sqe
    # alpha_x + i alpha_y = pref * i * log(z)
    return -pref * log_im, pref * log_re


class DPIE(MassProfile):
    """Elliptical dPIE (Lenstool PIEMD convention, r_cut = s of Eliasdottir)."""

    _name = "dPIE"
    _params = ["theta_E", "r_core", "r_cut", "center_x", "center_y", "e1", "e2"]

    # the K&K complex formula divides by sqrt(e): floor the ellipticity at
    # a level (1e-6) far below f32 resolution of the deflection — the e -> 0
    # limit is smooth (verified: values converge by e ~ 1e-5) but e = 0
    # exactly is 0/0
    _E_MIN = 1e-6

    def deriv(self, x, y, theta_E, r_core, r_cut, e1, e2, center_x=0.0, center_y=0.0):
        e, q, phi = ellipticity_to_polar(e1, e2)
        e = jnp.maximum(e, self._E_MIN)
        q = (1.0 - e) / (1.0 + e)
        x, y = rotate(x - center_x, y - center_y, phi)
        r_core, r_cut = _sort_core_cut(r_core, r_cut)
        scale = theta_E * r_cut / (r_cut - r_core)
        ax, ay = _dpie_complex_alpha(x, y, r_core, r_cut, e, q)
        ax, ay = rotate(ax, ay, -phi)
        return scale * ax, scale * ay

    def convergence(self, x, y, theta_E, r_core, r_cut, e1, e2, center_x=0.0, center_y=0.0):
        e, q, phi = ellipticity_to_polar(e1, e2)
        x, y = rotate(x - center_x, y - center_y, phi)
        r_core, r_cut = _sort_core_cut(r_core, r_cut)
        scale = theta_E * r_cut / (r_cut - r_core)
        rem2 = x**2 / (1.0 + e) ** 2 + y**2 / (1.0 - e) ** 2
        return scale / 2 * (
            1.0 / jnp.sqrt(rem2 + r_core**2) - 1.0 / jnp.sqrt(rem2 + r_cut**2)
        )


class DPIEP(MassProfile):
    """dPIE with ellipticity in the *potential* (pseudo-elliptical mass),
    built by coordinate stretch around the spherical dPIS
    (reference: ``piep.py:21-60``). Parameter names (Ra, Rs) kept for
    Lenstool familiarity."""

    _name = "dPIEP"
    _params = ["theta_E", "Ra", "Rs", "center_x", "center_y", "e1", "e2"]

    def __init__(self):
        super().__init__()
        self._sph = DPIS()

    def deriv(self, x, y, theta_E, Ra, Rs, e1, e2, center_x=0.0, center_y=0.0):
        _, q, phi = ellipticity_to_polar(e1, e2)
        e = jnp.abs(1 - q**2) / (1 + q**2)
        x, y = rotate(x - center_x, y - center_y, phi)
        xs, ys = x * jnp.sqrt(1 - e), y * jnp.sqrt(1 + e)
        fx, fy = self._sph.deriv(
            xs, ys, theta_E, Ra, Rs, jnp.zeros(()), jnp.zeros(())
        )
        fx = fx * jnp.sqrt(1 - e)
        fy = fy * jnp.sqrt(1 + e)
        return rotate(fx, fy, -phi)
