"""Pixelated source reconstruction (semilinear inversion).

Reconstructs the source surface brightness on a regular source-plane grid as
the analytic solution of a Gaussian linear system, with the pixel amplitudes
marginalized out of the likelihood (Warren & Dye 2003; Suyu et al. 2006).
This is a model family the reference does not offer (its sources are always
parametric — ``src/gigalens/profile.py:24-60`` light profiles); it is the
standard tool for lenses whose sources are too structured for Sersic-like
models, and it composes with every inference phase here (MAP/SVI/HMC/SMC run
unchanged on the marginal posterior over the nonlinear parameters).

Dense, batched design
---------------------
The classic implementations build sparse CSR mapping matrices on the host per
likelihood call (CPU-bound, unvectorizable). Here everything is dense,
batched, and runs as matmuls on the device:

  * Ray-traced supersampled image pixels are mapped onto the source grid with
    separable bilinear hat weights — two ``(bs, npix, n_side)`` tensors; the
    mapping matrix is their per-pixel outer product, built in source-row
    chunks to bound memory.
  * Each chunk of source-pixel "basis images" runs through the simulator's
    native place -> PSF-convolve -> pool pipeline (the same FFT/DFT machinery
    as the forward renders), yielding the blurred mapping matrix
    ``C`` of shape ``(bs, n_src, n_native_pix)``.
  * The normal-equations Gram ``C W C^T`` is one batched ``(n_src, npix,
    n_src)`` matmul; the solve + log-determinant is a batched Cholesky.
    Gradients of the marginal likelihood w.r.t. the nonlinear (lens) params
    flow through the whole chain, so the VI/HMC machinery applies as-is.

Regularization is a quadratic source prior ``s ~ N(0, (lam * H)^{-1})`` with
``H`` the source-grid gradient Gram with zero-Dirichlet boundaries (positive
definite, and charging the flat pedestal modes the data cannot see — see
:func:`gradient_regularizer`). ``lam`` may be fixed, or sampled as a model
parameter (add a
``source_pixelated=[dict(lam=...)]`` group to the prior) — it enters the
marginal likelihood analytically, so "fitting the regularization strength"
costs nothing extra.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

import gigalens_tpu.model as gmodel
from gigalens_tpu.prob.prior import Prior
from gigalens_tpu.simulator import _batched


@dataclasses.dataclass(frozen=True)
class SourceGrid:
    """Regular source-plane grid: ``n_side`` x ``n_side`` pixels spanning
    ``[center - extent, center + extent]`` on each axis."""

    n_side: int = 24
    extent: float = 1.0
    center_x: float = 0.0
    center_y: float = 0.0

    @property
    def n_src(self) -> int:
        return self.n_side * self.n_side

    @property
    def delta(self) -> float:
        return 2.0 * self.extent / (self.n_side - 1)

    @property
    def centers_x(self) -> np.ndarray:
        return self.center_x + np.linspace(
            -self.extent, self.extent, self.n_side
        ).astype(np.float32)

    @property
    def centers_y(self) -> np.ndarray:
        return self.center_y + np.linspace(
            -self.extent, self.extent, self.n_side
        ).astype(np.float32)


def gradient_regularizer(n_side: int, ridge: float = 0.0):
    """Gradient-Gram regularization matrix with zero-Dirichlet boundaries.

    ``H = Gx^T Gx + Gy^T Gy (+ ridge*I)`` where ``G{x,y}`` are
    forward-difference operators on the ``n_side^2`` grid (row-major,
    y-major flat index ``j = iy * n_side + ix``), **including differences
    against an implicit zero ring outside the grid**. The boundary terms
    matter twice over: (a) they make ``H`` positive definite on their own
    (a pure-interior gradient Gram has a free constant mode, so ``log|H|``
    would need a ridge), and (b) they charge flat pedestals. Measured
    without them: the solved source rides a constant offset ~80% of its
    peak — a flat source is gradient-free, and through the pixel-area
    factor it adds only ~0.3 sigma/pixel to the model image, so the data
    barely objects. With Dirichlet boundaries the pedestal costs
    ``lam * sum(s_edge^2)`` and the reconstruction decays to zero at the
    grid edge, as a real source must (choose ``extent`` with margin).

    Returns ``(H, logdet_H)`` with ``H`` float32 ``(n_src, n_src)`` and the
    log-determinant computed in float64.
    """
    n = int(n_side)
    k = n * n
    idx = np.arange(k).reshape(n, n)  # [iy, ix]

    def diff_gram(lo, hi):
        """Gram of rows (s[hi] - s[lo]); index -1 means the zero exterior."""
        lo, hi = lo.reshape(-1), hi.reshape(-1)
        g = np.zeros((lo.size, k), np.float64)
        r = np.arange(lo.size)
        m = lo >= 0
        g[r[m], lo[m]] = -1.0
        m = hi >= 0
        g[r[m], hi[m]] = 1.0
        return g.T @ g

    edge = np.full(n, -1)
    H = (
        diff_gram(idx[:, :-1], idx[:, 1:])
        + diff_gram(idx[:-1, :], idx[1:, :])
        + diff_gram(edge, idx[:, 0]) + diff_gram(idx[:, -1], edge)
        + diff_gram(edge, idx[0, :]) + diff_gram(idx[-1, :], edge)
        + ridge * np.eye(k)
    )
    sign, logdet = np.linalg.slogdet(H)
    assert sign > 0
    return H.astype(np.float32), float(logdet)


def _pick_chunk(n_side: int, max_cols: int = 256) -> int:
    """Largest divisor of ``n_side`` whose chunk (chunk * n_side source
    columns) stays under ``max_cols`` basis images per scan step."""
    best = 1
    for c in range(1, n_side + 1):
        if n_side % c == 0 and c * n_side <= max_cols:
            best = c
    return best


# Per-scan-step byte budget for the placed basis-image block
# (chunk * n_side, bs, h_ss, w_ss) — the peak live intermediate of the
# mapping build. 128 MB keeps the block cache-resident on CPU; measured: a
# bs-blind chunk at bs=32 cost 6x per-sample over bs=8 under reverse-mode
# AD (the chunk intermediates outgrew memory).
_CHUNK_BYTE_BUDGET = 128 * 2**20


class PixelatedSourceProbModel(gmodel.VersionedAttrs):
    """Marginal likelihood over nonlinear params with a pixelated source.

    Drop-in :class:`~gigalens_tpu.model.ForwardProbModel` replacement for the
    inference stack (same ``log_prob(simulator, z) -> (lp, red_chi2)``
    contract): the ``prior`` covers the lens mass (and optional parametric
    lens light) parameters; the source is an ``n_side^2``-pixel grid whose
    amplitudes are solved and marginalized analytically inside every
    likelihood evaluation.

    The physical model used with this prob model must have
    ``source_light=[]`` (the pixelated grid IS the source). Noise follows the
    Backward-model convention (reference ``src/gigalens/jax/model.py:170-172``):
    a fixed error map, either supplied or built from the observed image as
    ``sqrt(background_rms^2 + max(obs, 0) / exp_time)`` — the weights must not
    depend on the linear amplitudes for the marginalization to stay Gaussian.

    ``lam`` is the regularization strength: a float pins it; ``None`` reads it
    from ``params["source_pixelated"][0]["lam"]`` (add that group to the
    prior, e.g. ``source_pixelated=[dict(lam=LogNormal(0., 2.))]``).
    """

    def __init__(
        self,
        prior: Prior,
        observed_image,
        background_rms=None,
        exp_time=None,
        error_map=None,
        grid: Optional[SourceGrid] = None,
        lam: Optional[float] = None,
        reg_ridge: float = 0.0,
        chunk: Optional[int] = None,
    ):
        self.prior = prior
        self.grid = grid if grid is not None else SourceGrid()
        self.lam = None if lam is None else float(lam)
        self.include_pixels = True
        self.include_positions = False

        obs = np.asarray(observed_image, np.float32)
        if obs.ndim != 2:
            raise ValueError(f"observed_image must be (H, W); got {obs.shape}")
        self.observed_image = jnp.asarray(obs)
        if error_map is not None:
            err = np.asarray(error_map, np.float32)
        else:
            err = np.sqrt(
                float(background_rms) ** 2
                + np.clip(obs, 0, None) / float(exp_time)
            ).astype(np.float32)
        self.error_map = jnp.asarray(err)

        H_reg, self.logdet_H = gradient_regularizer(self.grid.n_side, reg_ridge)
        self.H_reg = jnp.asarray(H_reg)
        # None = adaptive: chosen per simulator batch size in mapping_matrix
        self.chunk = int(chunk) if chunk else None
        if self.chunk and self.grid.n_side % self.chunk:
            raise ValueError(
                f"chunk={self.chunk} must divide n_side={self.grid.n_side}"
            )

    # ------------------------------------------------------- API compat
    def init_centroids(self, bs):
        return None

    def event_size(self, simulator) -> int:
        return simulator.n_live_pix

    @property
    def bij(self):
        prior = self.prior

        class _Bij:
            forward = staticmethod(prior.constrain)
            inverse = staticmethod(prior.unconstrain)

        return _Bij()

    # ------------------------------------------------------------------
    def _weights_and_consts(self, simulator):
        """Flat per-native-pixel inverse variances (masked) + likelihood
        normalization constant over live pixels."""
        mask = simulator.img_region
        w = (mask / self.error_map**2).reshape(-1)
        norm = jnp.sum(
            jnp.log(2 * np.pi * self.error_map**2) * mask
        )
        return w, norm

    def _lam_of(self, params):
        if self.lam is not None:
            return jnp.float32(self.lam)
        try:
            lam = params["source_pixelated"][0]["lam"]
        except (KeyError, IndexError, TypeError):
            raise ValueError(
                "lam=None requires a source_pixelated=[dict(lam=...)] prior "
                "group (or pass a fixed lam to PixelatedSourceProbModel)"
            )
        return jnp.reshape(lam, (-1,))

    def mapping_matrix(self, simulator, lens_params):
        """Blurred mapping matrix ``C``: (bs, n_src, n_native_pix).

        Column block ``C[:, j]`` is source pixel j's basis image — the hat
        footprint of its bilinear support ray-traced into the image plane,
        PSF-convolved and pooled by the simulator's standard pipeline —
        flattened over native pixels (masked pixels zeroed).
        """
        sim = simulator
        g = self.grid
        npix = sim.img_x.shape[0]
        bx, by = sim.beta(sim.img_x, sim.img_y, lens_params)
        bx = jnp.broadcast_to(bx, (sim.bs, npix))
        by = jnp.broadcast_to(by, (sim.bs, npix))
        inv_d = jnp.float32(1.0 / g.delta)
        cx = jnp.asarray(g.centers_x)
        cy = jnp.asarray(g.centers_y)
        # separable bilinear hat weights: (bs, npix, n_side)
        wx = jnp.maximum(0.0, 1.0 - jnp.abs(bx[..., None] - cx) * inv_d)
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(by[..., None] - cy) * inv_d)

        n = g.n_side
        m = self.chunk
        if m is None:
            max_cols = max(
                1, _CHUNK_BYTE_BUDGET // (sim.bs * sim.h_ss * sim.w_ss * 4)
            )
            m = _pick_chunk(n, min(256, int(max_cols)))
        n_chunks = n // m
        mask_flat = sim.img_region.reshape(-1)
        # chunk over source rows iy (flat index j = iy * n + ix)
        wy_chunks = jnp.moveaxis(
            wy.reshape(sim.bs, npix, n_chunks, m), 2, 0
        )  # (n_chunks, bs, npix, m)

        def body(wyc):
            A = wyc[..., :, None] * wx[..., None, :]  # (bs, npix, m, n)
            A = jnp.moveaxis(A.reshape(sim.bs, npix, m * n), -1, 0)
            img = sim._postprocess(sim._place(A))  # (m*n, bs, H, W)
            return img.reshape(m * n, sim.bs, -1) * mask_flat

        # remat: the backward pass rebuilds each chunk's basis images instead
        # of holding every conv intermediate for all n_src columns at once
        C = jax.lax.map(jax.checkpoint(body), wy_chunks)
        C = C.reshape(g.n_src, sim.bs, -1)
        return jnp.moveaxis(C, 0, 1)  # (bs, n_src, n_nat)

    def _lens_light_flat(self, simulator, params):
        """Parametric lens light on native pixels: (bs, n_nat), or None."""
        sim = simulator
        profs = sim.phys_model.lens_light
        if not profs:
            return None
        total = 0.0
        for prof, p, c in zip(
            profs, params["lens_light"], sim.phys_model.lens_light_constants
        ):
            total = total + prof.light(sim.img_x, sim.img_y, **_batched(p), **c)
        total = jnp.broadcast_to(total, (sim.bs, sim.img_x.shape[0]))
        img = sim._postprocess(sim._place(total))
        return (img * sim.img_region).reshape(sim.bs, -1)

    def solve(self, simulator, params):
        """Full inversion at constrained ``params``.

        Returns a dict: ``source`` (bs, n_side, n_side) MAP source amplitudes,
        ``model_image`` (bs, H, W), ``log_marginal`` (bs,) the marginalized
        pixel log-likelihood, ``red_chi2`` (bs,) at the solved source.
        """
        sim = simulator
        g = self.grid
        C = self.mapping_matrix(sim, params["lens_mass"])
        w, norm = self._weights_and_consts(sim)
        d = (self.observed_image * sim.img_region).reshape(-1)

        ll = self._lens_light_flat(sim, params)
        d_eff = d - ll if ll is not None else jnp.broadcast_to(
            d, (sim.bs, d.shape[0])
        )

        lam = self._lam_of(params)
        lam_b = jnp.broadcast_to(jnp.reshape(lam, (-1,)), (sim.bs,))

        Cw = C * w  # (bs, k, n)
        F = jnp.einsum("bkn,bjn->bkj", Cw, C)
        F = F + lam_b[:, None, None] * self.H_reg
        b = jnp.einsum("bkn,bn->bk", Cw, d_eff)

        L = jnp.linalg.cholesky(F)
        s = jax.scipy.linalg.cho_solve((L, True), b[..., None])[..., 0]
        logdet_F = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
        )

        # E_min = (d - C^T s)^T W (d - C^T s) + lam s^T H s  at  s = F^{-1} b
        quad = jnp.sum(w * d_eff * d_eff, axis=-1) - jnp.sum(b * s, axis=-1)
        k = g.n_src
        log_marginal = -0.5 * (
            quad
            + logdet_F
            - k * jnp.log(lam_b)
            - self.logdet_H
            + norm
        )

        model = jnp.einsum("bkn,bk->bn", C, s)
        if ll is not None:
            model = model + ll
        resid = d - model
        chi2 = jnp.sum(w * resid * resid, axis=-1)
        H_img, W_img = self.observed_image.shape
        return dict(
            source=s.reshape(sim.bs, g.n_side, g.n_side),
            model_image=model.reshape(sim.bs, H_img, W_img),
            log_marginal=log_marginal,
            red_chi2=chi2 / sim.n_live_pix,
        )

    # ------------------------------------------------------------------
    def stats_pixels(self, simulator, params):
        out = self.solve(simulator, params)
        return out["log_marginal"], out["red_chi2"]

    def stats_positions(self, simulator, params):
        raise NotImplementedError(
            "PixelatedSourceProbModel has no position likelihood; use "
            "ForwardProbModel for multiple-image position terms"
        )

    def log_prob(self, simulator, z):
        """Unconstrained marginal log posterior and reduced chi2; z (bs, d)."""
        x = self.prior.constrain(z)
        log_like, red_chi2 = self.stats_pixels(simulator, x)
        log_prior = self.prior.log_prob(x) + self.prior.fldj(z)
        return log_like + log_prior, red_chi2

    def log_like(self, simulator, z):
        return self.stats_pixels(simulator, self.prior.constrain(z))[0]

    def log_prior(self, z):
        return self.prior.log_prob_z(z)
