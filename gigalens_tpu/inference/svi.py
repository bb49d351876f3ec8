"""Stochastic variational inference with a full-rank MVN surrogate.

Mirrors the reference SVI (``src/gigalens/jax/inference.py:82-144``): the
variational family is MultivariateNormalTriL parameterized by
``[mean, FillScaleTriL^{-1}(scale)]`` and the ELBO is a reparameterized
Monte-Carlo estimate over ``n_vi`` samples. Unlike the reference (pmap +
``lax.pmean`` + host optax each step, ``:123-139``), the whole fit is one
jitted ``lax.scan``; the ELBO sample batch is sharded over the mesh so the
gradient reduction compiles to a single ICI all-reduce.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from gigalens_tpu.parallel import mesh as pmesh
from gigalens_tpu.prob.bijectors import FillScaleTriL
from gigalens_tpu.prob.distributions import MultivariateNormalTriL

# d x d products of the surrogate run in full f32, never TF32: the
# surrogate preconditions HMC, whose acceptance sees rounding noise
_HI = jax.lax.Precision.HIGHEST


def _run_adam_scan(loss_and_grad, params0, optimizer, num_steps, seed,
                   segment_steps, polyak_fraction, progress, progress_value,
                   aot_desc=None):
    """Segmented device-resident Adam scan with Polyak tail averaging —
    the driver loop shared by :func:`fit_svi` and :func:`fit_svi_survey`.

    ``loss_and_grad(params, key) -> (recorded_loss, grads)``;
    ``progress_value(seg_losses)`` extracts the float handed to the
    ``progress`` callback. Returns ``(final_params, concatenated_losses)``.
    """
    avg_start = (int(num_steps * (1.0 - polyak_fraction))
                 if polyak_fraction > 0 else num_steps)

    def step(carry, key):
        params, opt_state, avg, n_avg, t = carry
        loss_out, grads = loss_and_grad(params, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        take = (t >= avg_start).astype(params.dtype)
        avg = avg + take * params
        n_avg = n_avg + take
        return (params, opt_state, avg, n_avg, t + 1), loss_out

    n_seg = segment_steps if segment_steps > 0 else num_steps

    def make_runner(length):
        def run_segment(carry, key):
            keys = jax.random.split(key, length)
            return jax.lax.scan(step, carry, keys)

        if aot_desc is not None:
            from gigalens_tpu.utils import aot

            return aot.aot_jit(
                "svi_seg", run_segment,
                static_desc=f"{aot_desc}|{length}|{avg_start}",
            )
        return jax.jit(run_segment)

    run_full = make_runner(n_seg)
    carry = (params0, jax.jit(optimizer.init)(params0),
             jnp.zeros_like(params0), jnp.zeros((), params0.dtype),
             jnp.asarray(0))
    key = jax.random.PRNGKey(seed)
    losses, steps_done = [], 0

    def _report(seg_losses):
        # per-segment live feedback — parity with the reference's tqdm ELBO
        # postfix (jax/inference.py:132-139)
        if progress is not None:
            jax.block_until_ready(seg_losses)
            progress(steps_done, progress_value(seg_losses))

    for _ in range(num_steps // n_seg):
        key, k_seg = jax.random.split(key)
        carry, seg_losses = run_full(carry, k_seg)
        losses.append(seg_losses)
        steps_done += n_seg
        _report(seg_losses)
    rem = num_steps % n_seg
    if rem:
        key, k_seg = jax.random.split(key)
        carry, seg_losses = make_runner(rem)(carry, k_seg)
        losses.append(seg_losses)
        steps_done += rem
        _report(seg_losses)
    params, _, avg, n_avg, _ = carry
    if polyak_fraction > 0:
        params = jax.jit(
            lambda a, n, q: jnp.where(n > 0, a / jnp.maximum(n, 1), q)
        )(avg, n_avg, params)
    return params, jnp.concatenate(losses)


def fit_svi(
    prob_model,
    simulator,
    start,
    optimizer: optax.GradientTransformation,
    n_vi: int = 250,
    init_scales=1e-3,
    num_steps: int = 500,
    seed: int = 0,
    mesh=None,
    segment_steps: int = 0,
    polyak_fraction: float = 0.25,
    full_rank: bool = True,
    progress=None,
):
    """Returns (q_z: MultivariateNormalTriL, elbo_loss_history).

    ``segment_steps > 0`` splits the optimization into multiple device calls
    of that many scan steps (state stays device-resident between calls) — for
    environments that cap single-program execution time, and for progress
    reporting; 0 runs everything in one call.

    ``polyak_fraction > 0`` returns the surrogate at the average of the
    variational parameters over the last fraction of steps instead of the
    final iterate — the stochastic ELBO has a noise floor at a constant
    learning rate and the averaged covariance is markedly more reliable as
    an HMC preconditioner.

    ``full_rank=False`` selects the mean-field ansatz: a diagonal scale with
    d free parameters instead of the d(d+1)/2 lower-triangular factor —
    parity with the reference TF substrate's ``full_rank=False`` option
    (``src/gigalens/tf/inference.py:62-66``, built on TFP's
    ``build_factored_surrogate_posterior``). Useful for high-dimensional
    cluster models where the TriL parameter count dominates; the returned
    surrogate is still a :class:`MultivariateNormalTriL` (with a diagonal
    factor), so the HMC preconditioning path is unchanged. A matrix
    ``init_scales`` (e.g. ``laplace_scale_tril``) contributes its diagonal."""
    d = prob_model.prior.d
    import numpy as np

    # init_scales: scalar -> isotropic, (d,) vector -> diagonal (the
    # canonical mean-field initializer), (d, d) matrix -> used as-is
    # (e.g. laplace_scale_tril).
    scale0 = np.asarray(init_scales, np.float32)
    if scale0.size == 1:
        scale0 = np.eye(d, dtype=np.float32) * float(scale0)
    elif scale0.ndim == 1:
        scale0 = np.diag(scale0)
    cov_bij = FillScaleTriL(d, diag_shift=1e-6)

    if full_rank:
        @jax.jit
        def _init(start, scale0):
            start = jnp.reshape(start, (d,))
            return jnp.concatenate([start, cov_bij.inverse(scale0)], axis=0)

        def unpack(qz_params):
            mean = qz_params[:d]
            tril = cov_bij.forward(qz_params[d:])
            return mean, tril

    else:
        # mean-field: d log-scale parameters, scale = exp(raw) + diag_shift
        @jax.jit
        def _init(start, scale0):
            start = jnp.reshape(start, (d,))
            # marginal stddevs sqrt(diag(L L^T)) = row norms of L — NOT
            # |diag(L)|, which underestimates dimensions whose scale is
            # carried by off-diagonal Cholesky entries (correlated Laplace
            # factors); identical for diagonal/vector init_scales
            diag0 = jnp.maximum(
                jnp.sqrt(jnp.sum(scale0**2, axis=-1)), 1e-8
            )
            return jnp.concatenate([start, jnp.log(diag0)], axis=0)

        def unpack(qz_params):
            mean = qz_params[:d]
            tril = jnp.diag(jnp.exp(qz_params[d:]) + 1e-6)
            return mean, tril

    qz_params = _init(jnp.asarray(start), jnp.asarray(scale0))

    half_log_2pi_d = 0.5 * d * jnp.log(2 * jnp.pi)

    def elbo_loss(qz_params, key):
        mean, tril = unpack(qz_params)
        eps = jax.random.normal(key, (n_vi, d))
        eps = pmesh.constrain_samples(eps, mesh)
        z = mean + jnp.matmul(eps, tril.T, precision=_HI)
        # Pathwise log q(z(eps)) = -|eps|^2/2 - log det L - d/2 log 2pi.
        # Algebraically identical to q.log_prob(z) but avoids the triangular
        # solve of q's own samples, which is catastrophically ill-conditioned
        # once L picks up large off-diagonal entries mid-optimization.
        lp_q = (
            -0.5 * jnp.sum(eps**2, axis=-1)
            - jnp.sum(jnp.log(jnp.abs(jnp.diagonal(tril))))
            - half_log_2pi_d
        )
        lp_model, _ = prob_model.log_prob(simulator, z)
        val = lp_q - lp_model
        # finite-draw masking: one pathological draw (a numerical cliff in a
        # profile or likelihood term) must not NaN the whole fit — a mean is
        # poisoned permanently through Adam state, unlike MAP's nan-robust
        # per-sample selection or HMC's NaN -> reject. Masked draws simply
        # contribute no gradient (identical to the plain mean when all draws
        # are finite, which the other phases' NaN hygiene makes the norm).
        finite = jnp.isfinite(val)
        val = jnp.where(finite, val, 0.0)
        return jnp.sum(val) / jnp.maximum(jnp.sum(finite), 1)

    from gigalens_tpu.utils import aot

    qz_params, losses = _run_adam_scan(
        jax.value_and_grad(elbo_loss), qz_params, optimizer, num_steps, seed,
        segment_steps, polyak_fraction, progress,
        progress_value=lambda seg: float(seg[-1]),
        aot_desc=aot.phase_desc(prob_model, simulator, optimizer, mesh=mesh,
                                extra=f"{n_vi}|{full_rank}"),
    )
    mean, tril = jax.jit(unpack)(qz_params)
    return MultivariateNormalTriL(mean, tril), losses


def importance_evidence(prob_model, simulator, q_z, n_samples=4096, seed=0,
                        batch=None):
    """Importance-sampled log-evidence using the SVI surrogate as proposal.

    ``log Z = logsumexp(log p(data, z) - log q(z)) - log n`` over draws
    ``z ~ q``. A near-free cross-check of ``SMCResult.log_evidence`` once
    SVI has run (one batched posterior eval vs a full tempering bridge).
    Only trustworthy when the surrogate covers the posterior: check the
    returned ``n_eff`` (effective sample size of the importance weights,
    ``(sum w)^2 / sum w^2``) — an ``n_eff`` of a few or less means the
    estimate is dominated by single draws and is biased low; prefer the SMC
    bridge then.

    ``simulator`` must be built with ``bs = batch`` (default: ``n_samples``).
    Returns ``(log_z, n_eff)`` (floats).
    """
    import numpy as np

    batch = batch or n_samples
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def _one(key):
        z = q_z.sample(key, (batch,))
        lp, _ = prob_model.log_prob(simulator, z)
        return lp - q_z.log_prob(z)  # (batch,) log importance weights

    logw = []
    for k in jax.random.split(key, -(-n_samples // batch)):
        logw.append(np.asarray(_one(k)))
    logw = jnp.asarray(np.concatenate(logw)[:n_samples])
    n = logw.shape[0]
    log_z = jax.scipy.special.logsumexp(logw) - jnp.log(n * 1.0)
    n_eff = jnp.exp(
        2 * jax.scipy.special.logsumexp(logw)
        - jax.scipy.special.logsumexp(2 * logw)
    )
    return float(log_z), float(n_eff)


def importance_evidence_survey(prob_model, simulator, means, trils,
                               n_samples=1024, seed=0):
    """Per-scene importance-sampled log-evidence from the survey surrogates.

    ``means (S, d)`` / ``trils (S, d, d)`` from :func:`fit_svi_survey`;
    ``simulator`` must be built with ``bs = S * n_samples``. One batched
    posterior eval yields S evidence estimates — the survey twin of
    :func:`importance_evidence`, with the same trust gate: per-scene weight
    ESS below a few means that scene's surrogate misses posterior mass.

    Returns ``(log_z (S,), n_eff (S,))`` numpy arrays.
    """
    import numpy as np

    means = jnp.asarray(means)
    trils = jnp.asarray(trils)
    S, d = means.shape
    half_log_2pi_d = 0.5 * d * jnp.log(2 * jnp.pi)

    @jax.jit
    def _logw(key):
        eps = jax.random.normal(key, (S, n_samples, d))
        z = means[:, None] + jnp.einsum("snd,sed->sne", eps, trils, precision=_HI)
        lp_q = (
            -0.5 * jnp.sum(eps**2, axis=-1)
            - jnp.sum(
                jnp.log(jnp.abs(jnp.diagonal(trils, axis1=-2, axis2=-1))),
                axis=-1,
            )[:, None]
            - half_log_2pi_d
        )  # (S, n)
        lp, _ = prob_model.log_prob(simulator, z.reshape(S * n_samples, d))
        return lp.reshape(S, n_samples) - lp_q

    logw = _logw(jax.random.PRNGKey(seed))
    lse1 = jax.scipy.special.logsumexp(logw, axis=1)
    lse2 = jax.scipy.special.logsumexp(2 * logw, axis=1)
    log_z = lse1 - jnp.log(n_samples * 1.0)
    n_eff = jnp.exp(2 * lse1 - lse2)
    return np.asarray(log_z), np.asarray(n_eff)


def fit_svi_survey(
    prob_model,
    simulator,
    starts,
    optimizer: optax.GradientTransformation,
    n_vi: int = 64,
    init_scales=1e-3,
    num_steps: int = 300,
    seed: int = 0,
    mesh=None,
    segment_steps: int = 0,
    polyak_fraction: float = 0.25,
    full_rank: bool = True,
    progress=None,
):
    """Per-scene SVI for survey mode: S independent MVN surrogates optimized
    jointly in ONE device program.

    ``starts``: (S, d) per-scene initial means (e.g. per-scene MAP);
    ``prob_model`` must score scene-major batches (S * n_vi rows — see
    :class:`gigalens_tpu.model.SurveyForwardProbModel`); ``simulator`` must
    be built with ``bs = S * n_vi``. ``init_scales`` may be a scalar, (d,)
    diagonal, one (d, d) factor shared by all scenes, or per-scene (S, d, d)
    (e.g. stacked ``laplace_scale_tril`` outputs). Returns
    ``(means (S, d), trils (S, d, d), losses (num_steps, S))`` — per-scene
    ELBO loss histories; the scenes' gradients are independent, so joint
    optimization matches S separate fits at the same step budget while
    keeping the device batch full.
    """
    import numpy as np

    starts = jnp.asarray(starts)
    S, d = starts.shape
    scale0 = np.asarray(init_scales, np.float32)
    if scale0.size == 1:
        scale0 = np.broadcast_to(np.eye(d, dtype=np.float32) * float(scale0), (S, d, d))
    elif scale0.ndim == 1:
        if scale0.shape != (d,):
            raise ValueError(f"1-D init_scales must be ({d},); got {scale0.shape}")
        scale0 = np.broadcast_to(np.diag(scale0), (S, d, d))
    elif scale0.ndim == 2:
        # (d, d): one factor shared by all scenes; (S, d): per-scene
        # diagonals. With S == d the two readings collide — demand the
        # unambiguous 3-D form rather than guessing (a mis-read here is a
        # silent garbage initialization, not an error).
        if S == d and scale0.shape == (d, d):
            raise ValueError(
                f"init_scales shape {scale0.shape} is ambiguous with "
                f"S == d == {d}: pass (S, d, d) per-scene factors or "
                "np.broadcast_to(diag, (S, d, d))"
            )
        if scale0.shape == (d, d):
            scale0 = np.broadcast_to(scale0, (S, d, d))
        elif scale0.shape == (S, d):
            scale0 = np.stack([np.diag(r) for r in scale0])
        else:
            raise ValueError(
                f"2-D init_scales must be (d, d) shared or (S, d) per-scene "
                f"diagonals; got {scale0.shape} with S={S}, d={d}"
            )
    elif scale0.shape != (S, d, d):
        raise ValueError(
            f"3-D init_scales must be ({S}, {d}, {d}); got {scale0.shape}"
        )
    cov_bij = FillScaleTriL(d, diag_shift=1e-6)

    if full_rank:
        @jax.jit
        def _init(starts, scale0):
            raw = jax.vmap(cov_bij.inverse)(scale0)  # (S, d(d+1)/2)
            return jnp.concatenate([starts, raw], axis=1)

        def unpack(qz_params):
            return qz_params[:, :d], jax.vmap(cov_bij.forward)(qz_params[:, d:])

    else:
        @jax.jit
        def _init(starts, scale0):
            diag0 = jnp.maximum(jnp.sqrt(jnp.sum(scale0**2, axis=-1)), 1e-8)
            return jnp.concatenate([starts, jnp.log(diag0)], axis=1)

        def unpack(qz_params):
            tril = jax.vmap(jnp.diag)(jnp.exp(qz_params[:, d:]) + 1e-6)
            return qz_params[:, :d], tril

    qz_params = _init(starts, jnp.asarray(scale0))
    half_log_2pi_d = 0.5 * d * jnp.log(2 * jnp.pi)

    def elbo_loss(qz_params, key):
        mean, tril = unpack(qz_params)  # (S, d), (S, d, d)
        eps = jax.random.normal(key, (S, n_vi, d))
        z = mean[:, None] + jnp.einsum("snd,sed->sne", eps, tril, precision=_HI)
        z = pmesh.constrain_samples(z.reshape(S * n_vi, d), mesh)
        lp_q = (
            -0.5 * jnp.sum(eps**2, axis=-1)  # (S, n_vi)
            - jnp.sum(
                jnp.log(jnp.abs(jnp.diagonal(tril, axis1=-2, axis2=-1))), axis=-1
            )[:, None]
            - half_log_2pi_d
        )
        lp_model, _ = prob_model.log_prob(simulator, z)
        val = lp_q - lp_model.reshape(S, n_vi)
        # finite-draw masking per scene (see fit_svi.elbo_loss): one bad draw
        # must not NaN its scene's surrogate for the rest of the fit
        finite = jnp.isfinite(val)
        val = jnp.where(finite, val, 0.0)
        per_scene = jnp.sum(val, axis=1) / jnp.maximum(
            jnp.sum(finite, axis=1), 1)  # (S,)
        # sum of independent per-scene ELBO losses: each scene's surrogate
        # receives exactly the gradient of its own ELBO
        return jnp.sum(per_scene), per_scene

    grad_fn = jax.value_and_grad(elbo_loss, has_aux=True)

    def loss_and_grad(params, key):
        (_, per_scene), grads = grad_fn(params, key)
        return per_scene, grads

    from gigalens_tpu.utils import aot

    qz_params, losses = _run_adam_scan(
        loss_and_grad, qz_params, optimizer, num_steps, seed, segment_steps,
        polyak_fraction, progress,
        # worst scene's current loss — a stalled scene stays visible
        progress_value=lambda seg: float(jnp.max(seg[-1])),
        aot_desc=aot.phase_desc(prob_model, simulator, optimizer, mesh=mesh,
                                extra=f"{S}|{n_vi}|{full_rank}"),
    )
    mean, tril = jax.jit(unpack)(qz_params)
    return mean, tril, losses
