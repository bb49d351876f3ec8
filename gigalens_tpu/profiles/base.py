"""Profile base classes.

API surface mirrors the reference interfaces (``src/gigalens/profile.py:5-82``,
``src/gigalens/jax/profile.py:9-45``): mass profiles expose
``deriv(x, y, **params) -> (alpha_x, alpha_y)`` plus ``hessian``,
``convergence`` and ``shear``; light profiles expose ``light(x, y, **params)``.

Differences from the reference:
  * No per-method ``jit(static_argnums=(0,))`` — methods are pure functions of
    their inputs and the *caller* compiles the whole step, so there is a single
    trace per training step instead of one cache entry per profile method.
  * The default ``hessian`` uses two forward-mode JVPs instead of the
    reference's vmapped reverse-mode VJP basis (``jax/profile.py:25-32``):
    forward mode needs no transpose pass and fuses cleanly under XLA.
  * All functions are total (``jnp.where``-guarded), never shape-dynamic, so
    they are safe under ``pjit``/``shard_map`` and Pallas.

Broadcasting convention: coordinates and per-sample parameters only need to be
mutually broadcastable. The simulator calls profiles with coordinates shaped
``(npix,)`` and parameters shaped ``(bs, 1)`` giving batch-leading ``(bs, npix)``
outputs (pixels last, the contiguous dimension).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import jax
import jax.numpy as jnp


class Parameterized(ABC):
    """A named profile with an ordered list of learnable parameter names."""

    _name: str
    _params: List[str]

    def __init__(self, *args, **kwargs):
        self.name = self._name
        self.params = list(self._params)

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class MassProfile(Parameterized, ABC):
    """Interface for a mass (deflector) profile."""

    @abstractmethod
    def deriv(self, x, y, **params):
        """Deflection angle (alpha_x, alpha_y) at image-plane coords (x, y)."""

    def hessian(self, x, y, **params):
        """Deflection Jacobian (f_xx, f_xy, f_yx, f_yy) via forward-mode AD.

        Profiles with cheap closed forms override this (SIS, Shear, NFW, dPIE);
        profiles whose ``deriv`` carries a custom VJP (EPL) override with
        :meth:`hessian_vjp` since forward-mode cannot cross a custom_vjp.
        """
        x = jnp.asarray(x)
        y = jnp.asarray(y)

        def f(xy):
            return jnp.stack(self.deriv(xy[0], xy[1], **params))

        xy = jnp.stack([x, y])
        ex = jnp.stack([jnp.ones_like(x), jnp.zeros_like(y)])
        ey = jnp.stack([jnp.zeros_like(x), jnp.ones_like(y)])
        _, (f_xx, f_yx) = jax.jvp(f, (xy,), (ex,))
        _, (f_xy, f_yy) = jax.jvp(f, (xy,), (ey,))
        return f_xx, f_xy, f_yx, f_yy

    def hessian_vjp(self, x, y, **params):
        """Reverse-mode hessian (the reference's vmapped-VJP basis trick,
        ``jax/profile.py:25-32``) — works through custom_vjp derivs."""
        x = jnp.asarray(x)
        y = jnp.asarray(y)

        def f(xy):
            return jnp.stack(self.deriv(xy[0], xy[1], **params))

        out, vjp_f = jax.vjp(f, jnp.stack([x, y]))
        ones = jnp.ones(out.shape[1:])
        zeros = jnp.zeros(out.shape[1:])
        (row_x,) = vjp_f(jnp.stack([ones, zeros]))
        (row_y,) = vjp_f(jnp.stack([zeros, ones]))
        f_xx, f_yx = row_x[0], row_x[1]
        f_xy, f_yy = row_y[0], row_y[1]
        return f_xx, f_xy, f_yx, f_yy

    def potential(self, x, y, **params):
        """Lensing potential ``psi`` with ``grad(psi) == deriv``.

        Needed only for time delays (Fermat potential); implemented on the
        profiles with closed forms or exact Euler identities (isothermal and
        power-law families, shear, point mass, mass sheet). Consistency with
        ``deriv`` is autodiff-tested for every implementation
        (tests/test_pointsource.py).
        """
        raise NotImplementedError(
            f"{self.name} does not implement the lensing potential; time "
            "delays require potential() on every deflector in the model"
        )

    def convergence(self, x, y, **params):
        f_xx, _, _, f_yy = self.hessian(x, y, **params)
        return (f_xx + f_yy) / 2

    def shear(self, x, y, **params):
        f_xx, f_xy, _, f_yy = self.hessian(x, y, **params)
        return (f_xx - f_yy) / 2, f_xy


class LightProfile(Parameterized, ABC):
    """Interface for a light (surface-brightness) profile.

    ``use_lstsq`` marks the amplitude(s) as linear parameters solved by the
    simulator's weighted least squares instead of being sampled; ``depth`` is
    the number of linear components this profile contributes.
    """

    _amp = "Ie"

    def __init__(self, use_lstsq: bool = False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._use_lstsq = bool(use_lstsq)
        self.depth = 1
        # Profiles with multiple/numbered amplitudes (shapelets) set _amp = ""
        # and manage their own amplitude params.
        if self._amp and not self._use_lstsq and self._amp not in self.params:
            self.params.append(self._amp)

    @property
    def use_lstsq(self) -> bool:
        return self._use_lstsq

    @use_lstsq.setter
    def use_lstsq(self, use_lstsq: bool):
        if self._amp:
            if use_lstsq and not self._use_lstsq:
                self.params.remove(self._amp)
            elif not use_lstsq and self._use_lstsq:
                self.params.append(self._amp)
        self._use_lstsq = bool(use_lstsq)

    @abstractmethod
    def light(self, x, y, **params):
        """Surface brightness at (x, y).

        Returns brightness broadcast over (batch..., pixels); in lstsq mode a
        leading component axis of size ``depth`` is prepended instead of
        multiplying by the amplitude.
        """


def rotate(x, y, phi):
    """Rotates coordinates by angle -phi (the lensing-standard frame change)."""
    cos_phi, sin_phi = jnp.cos(phi), jnp.sin(phi)
    return x * cos_phi + y * sin_phi, -x * sin_phi + y * cos_phi


def hessian_rotate(f_xx, f_xy, f_yy, phi):
    """Transforms a symmetric Hessian back through ``rotate``: R H R^T."""
    cos_2phi = jnp.cos(2 * phi)
    sin_2phi = jnp.sin(2 * phi)
    a = 0.5 * (f_xx + f_yy)
    b = 0.5 * (f_xx - f_yy) * cos_2phi
    c = f_xy * sin_2phi
    d = f_xy * cos_2phi
    e = 0.5 * (f_xx - f_yy) * sin_2phi
    return a + b + c, d - e, a - b - c


def ellipticity_to_polar(e1, e2, e_max=0.9999):
    """(e1, e2) -> (modulus e, axis ratio q, position angle phi).

    Hardened at exactly e1 = e2 = 0 (a MAP/SVI start from the prior mean
    lands there): the raw ``sqrt`` has an infinite derivative at the origin
    and ``arctan2``'s gradient is 0/0, so both are guarded — the epsilon
    goes inside the sqrt, and the angle's arguments are swapped for the
    constant (0, 1) in the degenerate region so phi = 0 with zero gradient.
    """
    degenerate = (e1 * e1 + e2 * e2) < 1e-24
    phi = jnp.arctan2(
        jnp.where(degenerate, 0.0, e2), jnp.where(degenerate, 1.0, e1)
    ) / 2
    e = jnp.minimum(jnp.sqrt(e1**2 + e2**2 + 1e-24), e_max)
    q = (1 - e) / (1 + e)
    return e, q, phi
