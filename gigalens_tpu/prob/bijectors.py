"""Unconstraining bijectors (pure JAX).

The reference (furcelay/gigalens) relies on TFP's event-space bijectors
(``src/gigalens/jax/model.py:71``) to map unconstrained optimization space onto
each prior's support. This module is a minimal, jit-friendly replacement: every
bijector is a stateless object with ``forward`` (unconstrained -> constrained),
``inverse`` and ``forward_log_det_jacobian`` evaluated elementwise.

Conventions match TFP so posterior densities agree:
  log p(z) = log p(x=forward(z)) + fldj(z)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


class Bijector:
    """Elementwise bijector base class."""

    def forward(self, z):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError

    def forward_log_det_jacobian(self, z):
        """Elementwise log|d forward / dz|."""
        raise NotImplementedError

    # short alias used throughout the package
    def fldj(self, z):
        return self.forward_log_det_jacobian(z)

    def __repr__(self):
        return type(self).__name__


class Identity(Bijector):
    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def forward_log_det_jacobian(self, z):
        return jnp.zeros_like(z)


class Exp(Bijector):
    def forward(self, z):
        return jnp.exp(z)

    def inverse(self, x):
        return jnp.log(x)

    def forward_log_det_jacobian(self, z):
        return z


class Softplus(Bijector):
    def __init__(self, shift: float = 0.0):
        self.shift = shift

    def forward(self, z):
        return jax.nn.softplus(z) + self.shift

    def inverse(self, x):
        x = x - self.shift
        # log(exp(x) - 1) computed stably
        return x + jnp.log(-jnp.expm1(-x))

    def forward_log_det_jacobian(self, z):
        return -jax.nn.softplus(-z)


class Sigmoid(Bijector):
    """Maps the real line onto the open interval (low, high)."""

    def __init__(self, low=0.0, high=1.0):
        self.low = low
        self.high = high

    def forward(self, z):
        return self.low + (self.high - self.low) * jax.nn.sigmoid(z)

    def inverse(self, x):
        u = (x - self.low) / (self.high - self.low)
        return jnp.log(u) - jnp.log1p(-u)

    def forward_log_det_jacobian(self, z):
        # log(high-low) + log sigmoid(z) + log sigmoid(-z)
        return (
            jnp.log(self.high - self.low)
            - jax.nn.softplus(-z)
            - jax.nn.softplus(z)
        )


class Scale(Bijector):
    def __init__(self, scale):
        self.scale = scale

    def forward(self, z):
        return z * self.scale

    def inverse(self, x):
        return x / self.scale

    def forward_log_det_jacobian(self, z):
        return jnp.broadcast_to(jnp.log(jnp.abs(self.scale)), jnp.shape(z))


class Shift(Bijector):
    def __init__(self, shift):
        self.shift = shift

    def forward(self, z):
        return z + self.shift

    def inverse(self, x):
        return x - self.shift

    def forward_log_det_jacobian(self, z):
        return jnp.zeros_like(z)


class Chain(Bijector):
    """Applies bijectors right-to-left (TFP convention): Chain([a, b]) == a(b(z))."""

    def __init__(self, bijectors):
        self.bijectors = tuple(bijectors)

    def forward(self, z):
        for b in reversed(self.bijectors):
            z = b.forward(z)
        return z

    def inverse(self, x):
        for b in self.bijectors:
            x = b.inverse(x)
        return x

    def forward_log_det_jacobian(self, z):
        total = jnp.zeros_like(z)
        for b in reversed(self.bijectors):
            total = total + b.forward_log_det_jacobian(z)
            z = b.forward(z)
        return total


def fill_triangular(vec, d):
    """Packs a length d(d+1)/2 vector into a lower-triangular (d, d) matrix.

    Row-major over the lower triangle, matching ``tril_indices`` ordering, so
    ``fill_triangular(matrix[tril_indices(d)], d) == tril(matrix)``.
    Supports arbitrary leading batch dimensions on ``vec``.

    .. note:: this ordering is **not** TFP's: ``tfp.math.fill_triangular``
       packs the vector in a rotated concat-reshape order (its doc example:
       ``[1..6] -> [[4, 0, 0], [6, 5, 0], [3, 2, 1]]``), whereas here
       ``[1..6] -> [[1, 0, 0], [2, 3, 0], [4, 5, 6]]``. Saved SVI variational
       vectors are therefore portable between gigalens_tpu versions but not
       bit-interchangeable with TFP-format checkpoints; convert via the
       matrix form (``fill_triangular_inverse(tfp_matrix)``). The resulting
       MultivariateNormalTriL distributions are identical either way — only
       the flat parameter layout differs.
    """
    rows, cols = jnp.tril_indices(d)
    out = jnp.zeros((*vec.shape[:-1], d, d), vec.dtype)
    return out.at[..., rows, cols].set(vec)


def fill_triangular_inverse(mat):
    d = mat.shape[-1]
    rows, cols = jnp.tril_indices(d)
    return mat[..., rows, cols]


class FillScaleTriL(Bijector):
    """Vector of length d(d+1)/2 -> lower-triangular scale matrix.

    Off-diagonal entries pass through; diagonal entries go through ``diag_bij``
    (default Exp) plus ``diag_shift`` so the result is positive-definite. This is
    the parameterization the reference uses for the SVI covariance factor
    (``src/gigalens/jax/inference.py:105``).
    """

    def __init__(self, d, diag_bij: Bijector | None = None, diag_shift: float = 1e-6):
        self.d = d
        self.diag_bij = Exp() if diag_bij is None else diag_bij
        self.diag_shift = diag_shift

    def forward(self, z):
        m = fill_triangular(z, self.d)
        diag = self.diag_bij.forward(jnp.diagonal(m, axis1=-2, axis2=-1)) + self.diag_shift
        i = jnp.arange(self.d)
        return m.at[..., i, i].set(diag)

    def inverse(self, x):
        diag = jnp.diagonal(x, axis1=-2, axis2=-1) - self.diag_shift
        i = jnp.arange(self.d)
        m = x.at[..., i, i].set(self.diag_bij.inverse(diag))
        return fill_triangular_inverse(m)

    def forward_log_det_jacobian(self, z):
        # Only diagonal entries have a nontrivial Jacobian.
        m = fill_triangular(z, self.d)
        diag_z = jnp.diagonal(m, axis1=-2, axis2=-1)
        return jnp.sum(self.diag_bij.forward_log_det_jacobian(diag_z), axis=-1)
