"""Batched differentiable lens simulator.

Batch-leading redesign of the reference ``LensSimulator``
(``src/gigalens/jax/simulator.py:19-195``):

  * **Batch-leading layout** ``(bs, npix)`` / ``(bs, H, W)`` everywhere — the
    pixel axis is the contiguous one and there is no transpose dance
    (the reference renders ``(H*ss, W*ss, bs)`` then transposes, ``:123-130``).
  * **FFT PSF convolution** with a precomputed kernel transform instead of
    direct ``lax.conv`` (``:133``) — orders of magnitude fewer flops at the
    benchmark scene sizes; a direct path remains for tiny kernels.
  * **Reshape-mean downsampling** instead of a pooling convolution (``:138``).
  * **No scatter when unmasked**: with no ``pix_region`` the flat render is a
    plain reshape; with a mask a single batched scatter places all light
    components at once.
  * Methods are pure (no ``jit(static_argnums=0)``) — the enclosing training
    step is what gets compiled, giving one trace per step.

Parameter convention: ``params`` is a dict with keys ``lens_mass``,
``lens_light``, ``source_light``, each a list of per-profile dicts whose leaves
are shaped ``(bs,)`` (or scalars). Leaves are broadcast against coordinates
``(npix,)`` as ``(bs, 1)``.
"""
from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

import gigalens_tpu.model as gmodel
from gigalens_tpu.config import LensWCS, SimulatorConfig
from gigalens_tpu.ops.psf import PSFConv, average_pool, subgrid_kernel


def _batched(p: Dict):
    """Appends a broadcast axis to each (bs,)-shaped leaf: (bs,) -> (bs, 1)."""
    return {k: jnp.asarray(v)[..., None] for k, v in p.items()}


class LensSimulator(gmodel.VersionedAttrs):
    """Batched differentiable lens simulator for a fixed camera and batch size.

    Renders ``(bs, H, W)`` observed-frame images from batch-leading parameter
    pytrees: ray-shoot the supersampled masked grid through the mass profiles,
    evaluate the light profiles in the source plane, PSF-convolve, pool to
    native pixels (reference counterpart: ``src/gigalens/jax/simulator.py:19-195``,
    redesigned batch-leading with FFT/DFT/direct convolution paths).
    """

    def __init__(
        self,
        phys_model: "gmodel.PhysicalModel",
        sim_config: SimulatorConfig,
        bs: int,
    ):
        self.phys_model = phys_model
        self.sim_config = sim_config
        self.bs = int(bs)
        self.supersample = int(sim_config.supersample)
        self.wcs = LensWCS(
            n=sim_config.num_pix,
            supersample=sim_config.supersample,
            transform_pix2angle=sim_config.transform_pix2angle,
            pix_scale=sim_config.delta_pix,
        )

        t = (
            np.eye(2) * sim_config.delta_pix
            if sim_config.transform_pix2angle is None
            else np.asarray(sim_config.transform_pix2angle, np.float64)
        )
        # Pixel-area Jacobian: rendered surface brightness -> native-pixel flux.
        self.conversion_factor = jnp.float32(np.linalg.det(t))

        nx, ny = self.wcs.n_x, self.wcs.n_y
        ss = self.supersample
        self.h_ss, self.w_ss = nx * ss, ny * ss

        # ---- pixel region mask -------------------------------------------
        # n_live_pix is computed host-side in both branches, so the
        # constructor never waits on a device->host readback
        if sim_config.pix_region is None:
            self.img_region = jnp.ones((nx, ny), jnp.float32)
            self._rows = self._cols = None
            X, Y = self.wcs.pixel_grid()  # (h_ss, w_ss) each
            img_x = X.reshape(-1)
            img_y = Y.reshape(-1)
            self.n_live_pix = int(nx) * int(ny)
        else:
            img_region = np.asarray(sim_config.pix_region).astype(bool)
            self.img_region = jnp.asarray(img_region.astype(np.float32))
            region = np.repeat(np.repeat(img_region, ss, axis=0), ss, axis=1)
            rows, cols = np.where(region)
            self._rows = jnp.asarray(rows)
            self._cols = jnp.asarray(cols)
            img_x, img_y = self.wcs.pix2angle(cols, rows)
            self.n_live_pix = int(np.count_nonzero(img_region))
        self.img_x = jnp.asarray(img_x, jnp.float32)  # (npix,)
        self.img_y = jnp.asarray(img_y, jnp.float32)

        # ---- linear (lstsq) component count ------------------------------
        self.depth = sum(x.depth for x in phys_model.lens_light) + sum(
            x.depth for x in phys_model.source_light
        )

        # ---- PSF ----------------------------------------------------------
        self._conv = None
        if sim_config.kernel is not None:
            kernel = np.asarray(sim_config.kernel)
            if kernel.ndim == 3:
                # per-scene PSF stack (survey mode): supersample each scene's
                # kernel; PSFConv broadcasts the scene axis over scene-major
                # sample batches
                kern = np.stack(
                    [subgrid_kernel(k, ss, odd=True) for k in kernel]
                )
            else:
                kern = subgrid_kernel(kernel, ss, odd=True)
            mode = sim_config.psf_mode
            if mode is None and sim_config.use_fft is not None:
                mode = "fft" if sim_config.use_fft else "direct"
            if mode == "direct" and kern.ndim == 3:
                mode = "fft"  # per-scene kernels: no direct path
            if mode is None:
                # tiny kernels: plain conv wins; otherwise XLA's FFT
                small = kern.ndim == 2 and kern.shape[0] * kern.shape[1] <= 81
                mode = "direct" if small else "fft"
            # dft modes fold the supersample average-pool into the inverse
            # transform (the conv emits native resolution directly)
            self._conv = PSFConv(
                kern, (self.h_ss, self.w_ss), mode=mode,
                pool=self.supersample if mode in ("dft", "dft_hi") else 1,
            )

    # ------------------------------------------------------------------
    # field quantities (lens_params: list of per-profile dicts, (bs,) leaves)
    # ------------------------------------------------------------------
    def beta(self, x, y, lens_params: List[Dict]):
        """Ray-shoots image-plane coords to the source plane.

        Single-plane: subtract every deflector's reduced deflection at the
        image-plane coords. Multi-plane (``phys_model.mp_factors`` set): the
        standard recursion — each deflector is evaluated at the ray's angular
        position *on its own plane*, displaced by the scaled deflections of
        all foreground planes (coefficients from
        :func:`gigalens_tpu.cosmology.multiplane_factors`; equal-redshift
        deflectors have factor 0 between them and co-add as one plane).
        """
        F = getattr(self.phys_model, "mp_factors", None)
        if F is None:
            beta_x, beta_y = x, y
            for lens, p, c in zip(
                self.phys_model.lenses, lens_params,
                self.phys_model.lenses_constants,
            ):
                fx, fy = lens.deriv(x, y, **_batched(p), **c)
                beta_x, beta_y = beta_x - fx, beta_y - fy
            return beta_x, beta_y

        ax, ay = [], []
        for j, (lens, p, c) in enumerate(
            zip(self.phys_model.lenses, lens_params,
                self.phys_model.lenses_constants)
        ):
            tx, ty = x, y
            for k in range(j):
                # baked float constants; F[k, j] == 0 for equal redshifts
                fkj = float(F[k, j])
                if fkj != 0.0:
                    tx = tx - fkj * ax[k]
                    ty = ty - fkj * ay[k]
            fx, fy = lens.deriv(tx, ty, **_batched(p), **c)
            ax.append(fx)
            ay.append(fy)
        beta_x, beta_y = x, y
        for fx, fy in zip(ax, ay):
            beta_x, beta_y = beta_x - fx, beta_y - fy
        return beta_x, beta_y

    def hessian(self, x, y, lens_params: List[Dict]):
        """Effective deflection Jacobian entries (f_xx, f_xy, f_yx, f_yy).

        Single-plane: sum of per-profile hessians (symmetric). Multi-plane:
        the composed Jacobian ``d alpha_eff / d theta`` via reverse-mode AD
        of :meth:`beta` (works through custom-VJP profiles) — generally
        asymmetric (``f_xy != f_yx``; the antisymmetric part is the
        multi-plane rotation), which the downstream ``magnification``
        determinant handles since it never assumes symmetry.
        """
        F = getattr(self.phys_model, "mp_factors", None)
        if F is None:
            f_xx = f_xy = f_yx = f_yy = jnp.zeros(())
            for lens, p, c in zip(
                self.phys_model.lenses, lens_params,
                self.phys_model.lenses_constants,
            ):
                a, b, c2, d = lens.hessian(x, y, **_batched(p), **c)
                f_xx, f_xy, f_yx, f_yy = f_xx + a, f_xy + b, f_yx + c2, f_yy + d
            return f_xx, f_xy, f_yx, f_yy

        # broadcast coords to the output batch shape so the coordinate
        # Jacobian is elementwise-diagonal and rows are exact per sample
        bx0, _ = self.beta(x, y, lens_params)
        xb = jnp.broadcast_to(x, bx0.shape)
        yb = jnp.broadcast_to(y, bx0.shape)

        def g(xy):
            bx, by = self.beta(xy[0], xy[1], lens_params)
            return jnp.stack([bx, by])

        out, vjp_g = jax.vjp(g, jnp.stack([xb, yb]))
        ones = jnp.ones(out.shape[1:])
        zeros = jnp.zeros(out.shape[1:])
        (row_x,) = vjp_g(jnp.stack([ones, zeros]))  # d beta_x / d(x, y)
        (row_y,) = vjp_g(jnp.stack([zeros, ones]))  # d beta_y / d(x, y)
        # beta = theta - alpha_eff  =>  J = I - d beta / d theta
        f_xx = 1.0 - row_x[0]
        f_xy = -row_x[1]
        f_yx = -row_y[0]
        f_yy = 1.0 - row_y[1]
        return f_xx, f_xy, f_yx, f_yy

    def potential(self, x, y, lens_params: List[Dict]):
        """Total lensing potential (single-plane; profiles must implement
        ``potential`` — see ``MassProfile.potential``)."""
        if getattr(self.phys_model, "mp_factors", None) is not None:
            raise NotImplementedError(
                "lensing potential / time delays are single-plane only"
            )
        psi = jnp.zeros(())
        for lens, p, c in zip(
            self.phys_model.lenses, lens_params, self.phys_model.lenses_constants
        ):
            psi = psi + lens.potential(x, y, **_batched(p), **c)
        return psi

    def fermat_potential(self, x, y, lens_params: List[Dict],
                         beta_x=None, beta_y=None):
        """Fermat potential ``tau = |theta - beta|^2 / 2 - psi(theta)``
        [arcsec^2]. With ``beta_*`` omitted each point uses its own
        ray-traced source position (then ``|theta - beta| = |alpha|``);
        time-delay likelihoods pass a shared source position."""
        if beta_x is None or beta_y is None:
            beta_x, beta_y = self.beta(x, y, lens_params)
        psi = self.potential(x, y, lens_params)
        return 0.5 * ((x - beta_x) ** 2 + (y - beta_y) ** 2) - psi

    def magnification(self, x, y, lens_params: List[Dict]):
        f_xx, f_xy, f_yx, f_yy = self.hessian(x, y, lens_params)
        det_A = (1 - f_xx) * (1 - f_yy) - f_xy * f_yx
        return 1.0 / det_A  # diverges on critical curves, as in the reference

    def convergence(self, x, y, lens_params: List[Dict]):
        f_xx, _, _, f_yy = self.hessian(x, y, lens_params)
        return (f_xx + f_yy) / 2

    def shear(self, x, y, lens_params: List[Dict]):
        f_xx, f_xy, _, f_yy = self.hessian(x, y, lens_params)
        return (f_xx - f_yy) / 2, f_xy

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    @staticmethod
    def _get(params, key, profiles):
        return params.get(key, [{} for _ in profiles]) if isinstance(params, dict) else params

    def _flat_light(self, params, no_deflection=False, stack_components=False):
        """Total surface brightness on the live supersampled pixels.

        Returns (bs, npix), or (depth, bs, npix) when ``stack_components``.
        """
        lens_params = self._get(params, "lens_mass", self.phys_model.lenses)
        lens_light_params = self._get(params, "lens_light", self.phys_model.lens_light)
        source_light_params = self._get(
            params, "source_light", self.phys_model.source_light
        )

        x, y = self.img_x, self.img_y
        beta_x, beta_y = self.beta(x, y, lens_params)
        if no_deflection:
            beta_x, beta_y = x, y

        values = []
        for prof, p, c in zip(
            self.phys_model.lens_light,
            lens_light_params,
            self.phys_model.lens_light_constants,
        ):
            values.append(prof.light(x, y, **_batched(p), **c))
        for prof, p, c in zip(
            self.phys_model.source_light,
            source_light_params,
            self.phys_model.source_light_constants,
        ):
            values.append(prof.light(beta_x, beta_y, **_batched(p), **c))

        npix = x.shape[0]
        if stack_components:
            # lstsq mode: each profile contributes (depth_i, bs, npix)
            return jnp.concatenate(
                [jnp.broadcast_to(v, (v.shape[0], self.bs, npix)) for v in values],
                axis=0,
            )
        total = sum(values) if values else jnp.zeros((self.bs, npix))
        return jnp.broadcast_to(total, (self.bs, npix))

    def _place(self, flat):
        """(..., npix) flat live-pixel values -> (..., h_ss, w_ss) image."""
        lead = flat.shape[:-1]
        if self._rows is None:
            return flat.reshape(*lead, self.h_ss, self.w_ss)
        img = jnp.zeros((*lead, self.h_ss, self.w_ss), flat.dtype)
        return img.at[..., self._rows, self._cols].set(
            flat, unique_indices=True, mode="drop"
        )

    def _postprocess(self, img):
        """nan guard -> PSF -> downsample -> pixel-area scale."""
        img = jnp.nan_to_num(img)
        pooled = False
        if self._conv is not None:
            img = self._conv(img)
            pooled = self._conv.pool > 1
        if not pooled:
            img = average_pool(img, self.supersample)
        return img * self.conversion_factor

    def simulate(self, params, no_deflection=False):
        """Renders observed-frame images; returns (bs, H, W) squeezed."""
        flat = self._flat_light(params, no_deflection=no_deflection)
        img = self._postprocess(self._place(flat))
        return jnp.squeeze(img)

    def _render_selected(self, params, lens_light: bool, source_light: bool,
                         no_deflection: bool = False):
        """Renders a subset of light components (convenience views; the
        reference TF substrate exposes these as ``simulate_source`` /
        ``simulate_lens_light`` / ``simulate_images``, tf/simulator.py:242-328)."""
        import copy

        sub = gmodel.PhysicalModel.__new__(gmodel.PhysicalModel)
        sub.lenses = self.phys_model.lenses
        sub.mp_factors = getattr(self.phys_model, "mp_factors", None)
        sub.lenses_constants = self.phys_model.lenses_constants
        sub.lens_light = self.phys_model.lens_light if lens_light else []
        sub.lens_light_constants = (
            self.phys_model.lens_light_constants if lens_light else []
        )
        sub.source_light = self.phys_model.source_light if source_light else []
        sub.source_light_constants = (
            self.phys_model.source_light_constants if source_light else []
        )
        # Render through a shallow-copied view, never by mutating self: a
        # traced function capturing this simulator concurrently must keep
        # seeing the full model (re-entrancy).
        view = copy.copy(self)
        view.phys_model = sub
        flat = view._flat_light(params, no_deflection=no_deflection)
        return jnp.squeeze(self._postprocess(self._place(flat)))

    def simulate_source(self, params):
        """Unlensed source render (no deflection applied)."""
        return self._render_selected(params, lens_light=False, source_light=True,
                                     no_deflection=True)

    def simulate_lens_light(self, params):
        return self._render_selected(params, lens_light=True, source_light=False)

    def simulate_images(self, params):
        """Lensed source only (no lens light)."""
        return self._render_selected(params, lens_light=False, source_light=True)

    def lstsq_simulate(
        self,
        params,
        observed_image,
        err_map,
        return_stacked=False,
        return_coeffs=False,
        no_deflection=False,
    ):
        """Renders with linear amplitudes solved by weighted least squares.

        Solves, per sample, ``argmin_a || (sum_k a_k X_k - Y) / err ||^2`` via
        the normal equations with a pseudo-inverse (rcond=1e-6), matching the
        reference (``jax/simulator.py:187-191``).

        Survey mode: an ``observed_image``/``err_map`` of shape (S, H, W)
        solves each scene-major sample (``bs = S * K``) against its own
        scene's data.
        """
        stacked = self._flat_light(
            params, no_deflection=no_deflection, stack_components=True
        )  # (depth, bs, npix)
        imgs = self._postprocess(self._place(stacked))  # (depth, bs, H, W)
        ret = jnp.transpose(imgs, (1, 2, 3, 0))  # (bs, H, W, depth)
        if return_stacked:
            return ret

        if jnp.ndim(observed_image) == 3:  # scene-batched data
            S = observed_image.shape[0]
            K = self.bs // S
            Wm = (1.0 / err_map)[:, None, ..., None]  # (S, 1, H, W, 1)
            Y = jnp.reshape(observed_image / err_map, (S, 1, -1, 1))
            X = jnp.reshape(
                ret.reshape(S, K, *ret.shape[1:]) * Wm, (S, K, -1, self.depth)
            )
            Xt = jnp.swapaxes(X, -1, -2)
            coeffs = (jnp.linalg.pinv(Xt @ X, rcond=1e-6) @ (Xt @ Y))[..., 0]
            coeffs = coeffs.reshape(self.bs, self.depth)  # (bs, depth)
        else:
            W = (1.0 / err_map)[..., None]  # (H, W, 1)
            Y = jnp.reshape(observed_image * jnp.squeeze(W, -1), (1, -1, 1))
            X = jnp.reshape(ret * W, (self.bs, -1, self.depth))
            Xt = jnp.swapaxes(X, -1, -2)
            coeffs = (jnp.linalg.pinv(Xt @ X, rcond=1e-6) @ (Xt @ Y))[..., 0]
        if return_coeffs:
            return coeffs
        out = jnp.sum(ret * coeffs[:, None, None, :], axis=-1)
        return jnp.squeeze(out)
