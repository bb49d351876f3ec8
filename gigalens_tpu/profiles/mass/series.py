"""Taylor-series mass profiles (fast cluster-member evaluation).

The reference implements this with 2x2,625 lines of sympy-generated
derivative kernels (``src/gigalens/jax/series/profiles/dpie.py``) wired into a
stateful ``MassSeries`` (``jax/series/series_profile.py``). Here the
coefficients come from **Taylor-mode automatic differentiation**
(``jax.experimental.jet``) applied to the ordinary profile implementation —
no code generation, works for any profile, and is exact to float precision.

Runtime evaluation is a single matmul: with coefficients precomputed as a
``(order+1, 2*npix)`` matrix and per-sample powers ``(bs, order+1)``,

    alpha = amplitude * (powers @ coefs)

which XLA runs as one matmul — the replacement for the reference's
broadcast-multiply-reduce (``series_profile.py:98-103``).

For cluster scaling relations (:class:`ScalingRelationSeries`) the chain rule
in the *global* series variable z (galaxy value r_g = z * u_g) gives

    coef_n = sum_g u_amp_g * u_ser_g^n * f^(n)(x; r = z0 * u_g) ,

so the entire galaxy population collapses into order+1 coefficient grids at
precompute time; per-step cost is O(order), not O(galaxies) — same asymptotic
trick as the reference (``scaling_series.py``), including the fix of its
``precompute_deriv`` f_x/f_y mix-up (``scaling_series.py:39-40``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import jet

from gigalens_tpu.profiles.base import MassProfile
from gigalens_tpu.profiles.mass.scaling import ScalingRelation


def taylor_derivs(f, var0, order: int):
    """[f(var0), f'(var0), ..., f^(order)(var0)] for array-valued f via jet.

    ``f`` maps an array to one array (stack multiple outputs before calling).
    """
    var0 = jnp.asarray(var0)
    if order == 0:
        return [f(var0)]
    ones = jnp.ones_like(var0)
    zeros = jnp.zeros_like(var0)
    primal, series = jet.jet(f, (var0,), ((ones,) + (zeros,) * (order - 1),))
    return [primal] + list(series)


class MassSeries(MassProfile):
    """Taylor expansion of ``profile`` in one parameter, linear amplitude.

    Stateful precompute API mirroring the reference (``set_constants`` /
    ``set_grid`` / ``set_deriv`` / ``set_hessian``), with functional
    ``precompute_*`` methods usable directly.
    """

    _name = "SeriesExpansion"

    def __init__(
        self,
        profile: MassProfile,
        series_param: Optional[str] = None,
        amplitude_param: Optional[str] = None,
        order: int = 3,
    ):
        self.profile = profile
        self.series_param = series_param or getattr(self, "_series_param")
        self.amplitude_param = amplitude_param or getattr(self, "_amplitude_param")
        self._name = f"SeriesExpansion-{profile.name}"
        self._params = [self.series_param, self.amplitude_param]
        self.constants = [
            p for p in profile.params
            if p not in (self.series_param, self.amplitude_param)
        ]
        self._order = int(order)
        super().__init__()

        self._series_var_0 = None
        self._constants_dict = {}
        self._x = self._y = None
        self._deriv_coefs = None   # (order+1, 2, npix)
        self._hessian_coefs = None  # (order+1, 3, npix): xx, xy, yy
        self._warned_traced_grid = False

    # ----------------------------------------------------------- state API
    @property
    def order(self):
        return self._order

    @property
    def series_var_0(self):
        return self._series_var_0

    def set_constants(self, params: Dict):
        self._constants_dict = dict(params)
        self._series_var_0 = jnp.asarray(params[self.series_param])

    def set_grid(self, x, y):
        self._x, self._y = jnp.asarray(x), jnp.asarray(y)

    def set_deriv(self):
        self._deriv_coefs = self.precompute_deriv(
            self._order, self._x, self._y, **self._constants_dict
        )

    def set_hessian(self):
        self._hessian_coefs = self.precompute_hessian(
            self._order, self._x, self._y, **self._constants_dict
        )

    # --------------------------------------------------------- precompute
    def _base_kwargs(self, params: Dict, var):
        kw = {k: v for k, v in params.items() if k != self.series_param}
        kw[self.series_param] = var
        kw[self.amplitude_param] = jnp.ones(())  # amplitude factored out
        return kw

    def precompute_deriv(self, order, x, y, **params):
        """(order+1, 2, ...) stack of d^n(alpha_x, alpha_y)/d series^n."""
        var0 = jnp.asarray(params[self.series_param], jnp.float32)

        # One jitted program instead of eagerly dispatched jet arithmetic:
        # the precompute is one-time, and op-by-op dispatch is slow
        @jax.jit
        def _compute(var0, params):
            def f(var):
                fx, fy = self.profile.deriv(x, y, **self._base_kwargs(params, var))
                return jnp.stack(jnp.broadcast_arrays(fx, fy))

            return jnp.stack(taylor_derivs(f, var0, order))

        return _compute(var0, dict(params))

    def precompute_hessian(self, order, x, y, **params):
        """(order+1, 3, ...) stack of d^n(f_xx, f_xy, f_yy)/d series^n."""
        var0 = jnp.asarray(params[self.series_param], jnp.float32)

        @jax.jit
        def _compute(var0, params):
            def f(var):
                f_xx, f_xy, _, f_yy = self.profile.hessian(
                    x, y, **self._base_kwargs(params, var)
                )
                return jnp.stack(jnp.broadcast_arrays(f_xx, f_xy, f_yy))

            return jnp.stack(taylor_derivs(f, var0, order))

        return _compute(var0, dict(params))

    # --------------------------------------------------------- evaluation
    def _powers(self, var):
        """(bs, order+1) scaled powers (var - var0)^n / n!."""
        n = jnp.arange(self._order + 1)
        fact = jnp.asarray(
            [math.factorial(int(k)) for k in range(self._order + 1)], jnp.float32
        )
        dv = jnp.reshape(jnp.asarray(var), (-1,))[:, None]  # (bs, 1)
        return dv ** n / fact

    def _poly_eval(self, coefs, var):
        """powers (bs, k) @ coefs (k, c, npix) -> (c, bs, npix) via one matmul."""
        k, c = coefs.shape[0], coefs.shape[1]
        flat = coefs.reshape(k, -1)  # (k, c*npix)
        out = self._powers(var - self._series_var_0) @ flat  # (bs, c*npix)
        out = out.reshape(-1, c, *coefs.shape[2:])
        return jnp.moveaxis(out, 1, 0)  # (c, bs, npix)

    def _on_grid(self, x):
        """True when x IS the precomputed grid, so the coefficients apply.

        Shape mismatch -> off-grid (the exact-evaluation fallback, e.g. for
        multiple-image centroids). Shape match with *different values* is
        almost certainly a stale-coefficient bug (same-size grid at a
        different supersampling or region) and raises rather than silently
        returning wrong deflections. Traced x cannot be value-checked, so it
        falls back to exact evaluation (correct, just without the series
        speedup) — the simulator passes its grid as a closure constant, so
        the fast path stays concrete; keep the grid out of jit arguments to
        use the series.
        """
        if self._x is None:
            return False
        if x is self._x:
            return True
        if tuple(jnp.shape(x)) != tuple(jnp.shape(self._x)):
            return False
        if isinstance(x, jax.core.Tracer):
            if not self._warned_traced_grid:
                self._warned_traced_grid = True
                import warnings

                warnings.warn(
                    "MassSeries: coordinates are traced, so they cannot be "
                    "matched against the precomputed grid; evaluating the "
                    "underlying profile exactly instead of the series. Pass "
                    "the grid as a closure constant (not a jit argument) to "
                    "use the precomputed coefficients."
                )
            return False
        if not np.array_equal(np.asarray(x), np.asarray(self._x)):
            raise ValueError(
                "MassSeries: coordinates match the precomputed grid's shape "
                f"{tuple(jnp.shape(x))} but not its values — the stored series "
                "coefficients do not apply to this grid. Re-run set_grid/"
                "set_deriv/set_hessian on the new coordinates (or reshape "
                "off-grid points so the shapes differ and the exact fallback "
                "is used)."
            )
        return True

    def _direct_kwargs(self, kwargs):
        """Full parameter set for exact evaluation off the precomputed grid."""
        kw = {
            k: v for k, v in self._constants_dict.items()
            if k not in (self.series_param,)
        }
        kw.update(kwargs)
        return kw

    def deriv(self, x, y, **kwargs):
        if not self._on_grid(x) or self._deriv_coefs is None:
            # off-grid points (e.g. multiple-image centroids): evaluate the
            # underlying profile exactly — cheap for a handful of points
            return self._direct_deriv(x, y, **kwargs)
        amp = jnp.reshape(jnp.asarray(kwargs[self.amplitude_param]), (-1, 1))
        var = kwargs[self.series_param]
        fx, fy = self._poly_eval(self._deriv_coefs, var)
        return amp * fx, amp * fy

    def _direct_deriv(self, x, y, **kwargs):
        return self.profile.deriv(x, y, **self._direct_kwargs(kwargs))

    def hessian(self, x, y, **kwargs):
        if not self._on_grid(x) or self._hessian_coefs is None:
            return self._direct_hessian(x, y, **kwargs)
        amp = jnp.reshape(jnp.asarray(kwargs[self.amplitude_param]), (-1, 1))
        var = kwargs[self.series_param]
        f_xx, f_xy, f_yy = self._poly_eval(self._hessian_coefs, var)
        return amp * f_xx, amp * f_xy, amp * f_xy, amp * f_yy

    def _direct_hessian(self, x, y, **kwargs):
        return self.profile.hessian(x, y, **self._direct_kwargs(kwargs))


class ScalingRelationSeries(MassSeries):
    """Series expansion + scaling-relation galaxy sum (see module docstring).

    Parameters at inference time are the *global* (amplitude, series) pair;
    everything else, including the galaxy catalogue, is folded into the
    precomputed coefficients.
    """

    def __init__(
        self,
        profile: MassProfile,
        series_param: str,
        amplitude_param: str,
        scaling_params: List[str],
        lum_star: float,
        scaling_params_power: Dict[str, float],
        galaxy_catalogue: Dict[str, List],
        order: int = 3,
        chunk_size: Optional[int] = None,
    ):
        super().__init__(profile, series_param, amplitude_param, order=order)
        # reuse ScalingRelation's catalogue bookkeeping via composition
        self._rel = ScalingRelation(
            profile,
            scaling_params=scaling_params,
            lum_star=lum_star,
            scaling_params_power=scaling_params_power,
            galaxy_catalogue=galaxy_catalogue,
            chunk_size=chunk_size,
        )
        self.scaling_params = list(scaling_params)
        self.n_galaxy = self._rel.n_galaxy

    def _precompute_scaled(self, order, x, y, component_fn, n_comp, **params):
        rel = self._rel
        var0 = jnp.asarray(params[self.series_param], jnp.float32)
        n = jnp.arange(order + 1, dtype=jnp.float32)

        # One jitted program per chunk shape (chunks are uniform, so it
        # compiles once and is reused across the chunk loop): the jet
        # arithmetic dispatched op by op is slow
        @jax.jit
        def chunk_contrib(var0_g, u_amp, u_ser, galaxy_params):
            def f(var):
                kw = dict(galaxy_params)
                kw[self.series_param] = var
                kw[self.amplitude_param] = jnp.ones(())
                out = component_fn(x, y, **kw)
                return jnp.stack(jnp.broadcast_arrays(*out))  # (n_comp, chunk, npix)

            derivs = taylor_derivs(f, var0_g, order)  # list of (n_comp, chunk, npix)
            stack = jnp.stack(derivs)  # (order+1, n_comp, chunk, npix)
            # chain rule in the global variable + amplitude scaling weights
            w = u_amp[None, :] * u_ser[None, :] ** n[:, None]  # (order+1, chunk)
            return jnp.einsum("kc,kncp->knp", w, stack)

        total = None
        for ci in range(rel.n_chunks):
            u_amp = rel._unscaled[self.amplitude_param][ci]   # (chunk,)
            u_ser = rel._unscaled[self.series_param][ci]      # (chunk,)
            galaxy_params = {}
            for k in self.scaling_params:
                if k in (self.series_param, self.amplitude_param):
                    continue
                galaxy_params[k] = jnp.asarray(params[k]) * rel._unscaled[k][ci][:, None]
            for k in rel.not_scaling_params:
                galaxy_params[k] = rel._galaxy_constants[k][ci][:, None]

            var0_g = var0 * u_ser[:, None]  # (chunk, 1)
            contrib = chunk_contrib(var0_g, u_amp, u_ser, galaxy_params)
            total = contrib if total is None else total + contrib
        return total  # (order+1, n_comp, npix)

    def _direct_deriv(self, x, y, **kwargs):
        return self._rel.deriv(x, y, **self._scales_for_direct(kwargs))

    def _direct_hessian(self, x, y, **kwargs):
        return self._rel.hessian(x, y, **self._scales_for_direct(kwargs))

    def _scales_for_direct(self, kwargs):
        """Global scaling values for every scaling param (constants filled in)."""
        out = {}
        for k in self._rel.scaling_params:
            if k in kwargs:
                out[k] = kwargs[k]
            elif k in self._constants_dict:
                out[k] = jnp.asarray(self._constants_dict[k])
            else:
                raise KeyError(f"missing scaling parameter {k}")
        return out

    def precompute_deriv(self, order, x, y, **params):
        def comp(x, y, **kw):
            return self.profile.deriv(x, y, **kw)

        return self._precompute_scaled(order, x, y, comp, 2, **params)

    def precompute_hessian(self, order, x, y, **params):
        def comp(x, y, **kw):
            f_xx, f_xy, _, f_yy = self.profile.hessian(x, y, **kw)
            return f_xx, f_xy, f_yy

        return self._precompute_scaled(order, x, y, comp, 3, **params)
