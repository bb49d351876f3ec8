"""Lens-equation image finding: predict multiple-image positions.

Solves ``beta(theta) = beta_src`` for all images of a source position —
the tool that builds position-likelihood inputs consistent with the pixel
data (``examples/demo_cluster.py`` measured: synthetic fixed points that
contradict the pixel likelihood push HMC split-R-hat to ~3; traced images
restore ~1). Grid-scan candidates (local minima of the source-plane
distance over the simulator's supersampled grid) are Newton-refined on the
lens equation with the analytic/AD Jacobian ``A = I - hessian``.

Host-side (numpy + a jitted beta/hessian probe): image finding is a setup
step, not part of any hot loop.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def find_images(
    simulator,
    lens_params,
    src_x: float,
    src_y: float,
    search_window: float = 4.0,
    newton_iters: int = 20,
    residual_tol: float = 1e-8,
    dedupe_scale: float = None,
):
    """All image-plane solutions of the lens equation for one source point.

    ``simulator``: a ``LensSimulator`` (its supersampled grid seeds the
    search); ``lens_params``: list of per-profile dicts with length-1 leaves
    (one lens model). ``search_window`` (in pixels) bounds how far a grid
    candidate may sit from the source-plane target; ``residual_tol`` is the
    squared source-plane residual accepted as an image; ``dedupe_scale``
    (default: one pixel) merges duplicate convergence basins.

    Returns ``(img_x, img_y, magnifications)`` float32 numpy arrays (sorted
    by |magnification|, brightest first).
    """
    wcs = simulator.wcs
    delta_pix = float(
        np.sqrt(abs(np.linalg.det(wcs.transform_pix2angle))) * wcs.supersample
    )  # native pixel scale
    dedupe = delta_pix if dedupe_scale is None else float(dedupe_scale)

    # Pin the probe programs to the host CPU backend: the Newton loop below
    # is a host-driven sequence of tiny (O(candidates)) evaluations, each of
    # which would otherwise be one device dispatch and one readback.
    # Uncommitted (numpy/python) arguments follow jax.default_device, so
    # lens_params and the seed grid are materialized host-side first.
    cpu = jax.devices("cpu")[0]
    lens_params = jax.tree_util.tree_map(
        lambda a: jax.device_put(np.asarray(a), cpu), lens_params
    )
    grid_x = jax.device_put(np.asarray(simulator.img_x), cpu)
    grid_y = jax.device_put(np.asarray(simulator.img_y), cpu)

    _beta_jit = jax.jit(
        lambda x, y: simulator.beta(jnp.atleast_1d(x), jnp.atleast_1d(y),
                                    lens_params)
    )
    _hess_jit = jax.jit(
        lambda x, y: simulator.hessian(jnp.atleast_1d(x), jnp.atleast_1d(y),
                                       lens_params)
    )

    def beta_fn(x, y):
        with jax.default_device(cpu):
            return _beta_jit(x, y)

    def hess_fn(x, y):
        with jax.default_device(cpu):
            return _hess_jit(x, y)

    from scipy.ndimage import minimum_filter

    bx, by = beta_fn(grid_x, grid_y)
    d2 = (np.asarray(bx)[0] - src_x) ** 2 + (np.asarray(by)[0] - src_y) ** 2
    d2 = d2.reshape(simulator.h_ss, simulator.w_ss)
    cand = (d2 == minimum_filter(d2, size=5)) & (
        d2 < (search_window * delta_pix) ** 2
    )
    rr, cc = np.where(cand)
    gx = np.asarray(simulator.img_x).reshape(simulator.h_ss, simulator.w_ss)
    gy = np.asarray(simulator.img_y).reshape(simulator.h_ss, simulator.w_ss)

    found = []
    for r0, c0 in zip(rr, cc):
        x, y = float(gx[r0, c0]), float(gy[r0, c0])
        for _ in range(newton_iters):
            bxi, byi = beta_fn(x, y)
            fxx, fxy, fyx, fyy = hess_fn(x, y)
            res = np.array([float(bxi[0, 0]) - src_x, float(byi[0, 0]) - src_y])
            a = np.array(
                [[1 - float(fxx[0, 0]), -float(fxy[0, 0])],
                 [-float(fyx[0, 0]), 1 - float(fyy[0, 0])]]
            )
            if abs(np.linalg.det(a)) < 1e-8 or not np.isfinite(res).all():
                break
            step = np.linalg.solve(a, res)
            x, y = x - step[0], y - step[1]
            if float(res @ res) < 1e-12:
                break
        bxi, byi = beta_fn(x, y)
        res2 = (float(bxi[0, 0]) - src_x) ** 2 + (float(byi[0, 0]) - src_y) ** 2
        if res2 < residual_tol and all(
            (x - px) ** 2 + (y - py) ** 2 > dedupe**2 for px, py, _ in found
        ):
            fxx, fxy, fyx, fyy = hess_fn(x, y)
            det = (1 - float(fxx[0, 0])) * (1 - float(fyy[0, 0])) - float(
                fxy[0, 0]
            ) * float(fyx[0, 0])
            mag = 1.0 / det if det != 0 else np.inf
            found.append((x, y, mag))

    found.sort(key=lambda t: -abs(t[2]))
    img_x = np.asarray([t[0] for t in found], np.float32)
    img_y = np.asarray([t[1] for t in found], np.float32)
    mags = np.asarray([t[2] for t in found], np.float32)
    return img_x, img_y, mags
