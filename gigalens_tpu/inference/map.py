"""Multi-start MAP optimization.

Device-resident redesign of the reference MAP driver
(``src/gigalens/jax/inference.py:24-80``). The reference pays a host
round-trip every Adam step (``jnp.split`` -> pmap -> ``jnp.concatenate`` ->
host optax, ``:64-79``); here the entire optimization is ONE jitted
``lax.scan`` over steps with the sample batch sharded across the mesh, so the
only host sync is at the end. Loss convention matches the reference: mean over
samples of ``-log_prob / event_size``.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import optax

from gigalens_tpu.parallel import mesh as pmesh


def fit_map(
    prob_model,
    simulator,
    optimizer: optax.GradientTransformation,
    start=None,
    n_samples: int = 500,
    num_steps: int = 350,
    seed: int = 0,
    mesh=None,
    return_history: bool = True,
    segment_steps: int = 0,
    progress=None,
):
    """Runs multi-start Adam; returns (z, chi2_history).

    ``z`` is the (n_samples, d) unconstrained parameter matrix after
    ``num_steps`` updates; ``chi2_history`` is the per-step minimum reduced
    chi2 across samples (useful as a convergence trace).

    ``progress``, if given, is called after every dispatched segment with
    ``(steps_done, min_reduced_chi2)`` — the live-feedback parity point for
    the reference's tqdm postfix (``src/gigalens/jax/inference.py:74-79``).
    Pass ``segment_steps`` to control the reporting granularity (the reference
    pays a host round-trip per step; here the granularity is explicit).
    """
    event_size = float(prob_model.event_size(simulator))
    key = jax.random.PRNGKey(seed)

    if start is None:
        @jax.jit
        def _init(key):
            return prob_model.prior.unconstrain(prob_model.prior.sample(key, n_samples))

        z0 = _init(key)
    else:
        z0 = jnp.asarray(start)

    if mesh is not None and mesh.size > 1:
        z0 = pmesh.shard_samples(z0, mesh)

    def loss_fn(z):
        lp, chisq = prob_model.log_prob(simulator, z)
        return -jnp.mean(lp) / event_size, chisq

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def step(carry, _):
        z, opt_state = carry
        (_, chisq), grads = grad_fn(z)
        updates, opt_state = optimizer.update(grads, opt_state, z)
        z = optax.apply_updates(z, updates)
        z = pmesh.constrain_samples(z, mesh)
        return (z, opt_state), jnp.nanmin(chisq)

    n_seg = segment_steps if segment_steps > 0 else num_steps

    # cross-process AOT reuse of the phase program (utils/aot.py): the
    # fingerprint covers everything `step` closes over — observed data +
    # priors (prob_model), grids/PSF factors (simulator), and the optimizer's
    # schedule constants (closure-cell hashing)
    from gigalens_tpu.utils import aot

    desc = aot.phase_desc(prob_model, simulator, optimizer, mesh=mesh,
                          extra=event_size)

    def make_runner(length):
        def run_segment(carry):
            return jax.lax.scan(step, carry, None, length=length)

        if desc is not None:
            return aot.aot_jit("map_seg", run_segment,
                               static_desc=f"{desc}|{length}")
        return jax.jit(run_segment)

    run_full = make_runner(n_seg)

    @jax.jit
    def init_opt(z0):
        return optimizer.init(z0)

    carry = (z0, init_opt(z0))
    hists = []
    steps_done = 0

    def _report(hist):
        if progress is not None:
            jax.block_until_ready(hist)
            progress(steps_done, float(jnp.nanmin(hist)))

    for _ in range(num_steps // n_seg):
        carry, hist = run_full(carry)
        hists.append(hist)
        steps_done += n_seg
        _report(hist)
    rem = num_steps % n_seg
    if rem:
        carry, hist = make_runner(rem)(carry)
        hists.append(hist)
        steps_done += rem
        _report(hist)
    z = carry[0]
    hist = jnp.concatenate(hists)
    return (z, hist) if return_history else z


def _floored_inv_chol(h, d, floor_ratio):
    """chol(H^{-1}) with the |eigenvalue| floor (shared by both methods)."""
    h = 0.5 * (h + h.T)
    lam, vec = jnp.linalg.eigh(h)
    # |lam|: at an approximate optimum the Hessian can be indefinite; the
    # magnitude still measures curvature scale in that direction
    lam = jnp.maximum(jnp.abs(lam), jnp.max(jnp.abs(lam)) * floor_ratio)
    cov = jnp.matmul(vec / lam, vec.T, precision=jax.lax.Precision.HIGHEST)
    cov = 0.5 * (cov + cov.T)
    return jnp.linalg.cholesky(
        cov + jnp.trace(cov) / d * 1e-6 * jnp.eye(d, dtype=cov.dtype)
    )


def laplace_scale_tril(prob_model, simulator, z_best, floor_ratio: float = 1e-6,
                       method: str = "exact"):
    """Cholesky factor of the Laplace covariance at the MAP point.

    Computes the Hessian of the unconstrained log posterior at ``z_best``
    (shape (1, d) or (d,)), eigen-floors it for positive-definiteness, and
    returns ``chol(H^{-1})``.

    ``method="exact"``: reverse-over-reverse AD (compatible with custom_vjp
    profiles). ``method="fd"``: central differences of the *gradient*,
    batched over one bs=2d first-order program — the simulator must then be
    built with ``bs = 2 * d``. The FD Hessian's floored ``scale_tril``
    matched the exact one to ~5%% Frobenius (diag within 1-3%%) on the
    benchmark scene, well inside what an SVI initializer / HMC
    preconditioner needs, and its single-reverse program compiles an order
    of magnitude faster than the double-reverse one.

    The reference avoids the Hessian because it "can become unstable in high
    dimensions" as a sampler mass matrix; as an SVI *initializer* and HMC
    preconditioner the floored inverse is far more reliable than a
    half-converged VI covariance — it is deterministic and captures the
    data-dominated tiny scales exactly.
    """
    z_best = jnp.reshape(jnp.asarray(z_best), (1, -1))
    d = z_best.shape[-1]

    if method == "fd":
        def grads_at(zb):
            f = lambda z: -jnp.sum(prob_model.log_prob(simulator, z)[0])
            return jax.grad(f)(zb)

        @jax.jit
        def _laplace_fd(z):
            z = z[0]
            # per-dimension step ~ curvature-scale-agnostic relative h
            hstep = 1e-3 * jnp.maximum(jnp.abs(z), 1.0)
            zp = z[None, :] + jnp.diag(hstep)
            zm = z[None, :] - jnp.diag(hstep)
            g = grads_at(jnp.concatenate([zp, zm], axis=0))
            h = (g[:d] - g[d:]) / (2.0 * hstep[:, None])
            return _floored_inv_chol(h, d, floor_ratio)

        return _laplace_fd(z_best)

    def neg_lp(zrow):
        return -prob_model.log_prob(simulator, zrow[None, :])[0][0]

    @jax.jit
    def _laplace(z):
        h = jax.jacrev(jax.grad(neg_lp))(z[0])
        return _floored_inv_chol(h, d, floor_ratio)

    return _laplace(z_best)


def laplace_scale_trils_survey(prob_model, simulator, z_best,
                               floor_ratio: float = 1e-6):
    """Per-scene Laplace factors for survey mode: FD Hessians of all S scenes
    from ONE scene-major gradient batch.

    ``z_best``: (S, d) per-scene MAP points (``SurveySequence.best_per_scene``);
    ``prob_model`` must be scene-batched (``SurveyForwardProbModel``) and
    ``simulator`` built with ``bs = S * 2d`` (the per-scene central-difference
    batch, K = 2d rows per scene). Returns (S, d, d) Cholesky factors of the
    floored inverse Hessians — per-scene ``init_scales`` for
    :func:`gigalens_tpu.inference.svi.fit_svi_survey` and the HMC
    preconditioners of last resort. Same math per scene as
    :func:`laplace_scale_tril` with ``method="fd"``.
    """
    z_best = jnp.asarray(z_best)
    S, d = z_best.shape

    def grads_at(zb):
        f = lambda z: -jnp.sum(prob_model.log_prob(simulator, z)[0])
        return jax.grad(f)(zb)

    @jax.jit
    def _go(zs):
        hstep = 1e-3 * jnp.maximum(jnp.abs(zs), 1.0)  # (S, d)
        pert = hstep[:, :, None] * jnp.eye(d, dtype=zs.dtype)  # (S, d, d)
        zp = zs[:, None, :] + pert
        zm = zs[:, None, :] - pert
        batch = jnp.concatenate([zp, zm], axis=1).reshape(S * 2 * d, d)
        g = grads_at(batch).reshape(S, 2 * d, d)
        h = (g[:, :d] - g[:, d:]) / (2.0 * hstep[:, :, None])  # (S, d, d)
        return jax.vmap(_floored_inv_chol, in_axes=(0, None, None))(
            h, d, floor_ratio
        )

    return _go(z_best)


def best_start(prob_model, simulator, z) -> jnp.ndarray:
    """Selects the highest-posterior sample; returns it shaped (1, d)."""

    @jax.jit
    def _best(z):
        lp, _ = prob_model.log_prob(simulator, z)
        # diverged starts carry NaN log-posteriors; argmax would select a
        # NaN (it propagates as the max), poisoning everything downstream
        lp = jnp.where(jnp.isnan(lp), -jnp.inf, lp)
        return z[jnp.argmax(lp)][None, :]

    return _best(z)
