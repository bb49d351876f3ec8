"""Preconditioned Hamiltonian Monte Carlo, pure JAX.

Replaces the reference's TFP kernel stack
(``tfe.mcmc.PreconditionedHamiltonianMonteCarlo`` wrapped in
``GradientBasedTrajectoryLengthAdaptation`` and
``DualAveragingStepSizeAdaptation``, ``src/gigalens/jax/inference.py:179-193``)
with a single ``lax.scan`` chain that runs entirely on device:

  * momentum ~ N(0, M) with mass matrix M = Sigma_VI^{-1}, so the leapfrog
    drift is ``z += eps * (Sigma @ p)`` — the VI covariance preconditions the
    dynamics exactly as in the reference (``:166-169``);
  * scalar step size adapted by Nesterov dual averaging on a cross-chain
    reduction of the acceptance probability (mean by default, like the
    reference/TFP; a "median" option exists but measured WORSE on the
    benchmark — eps tuned to the median chain leaves slow chains stuck,
    halving min-ESS — the mean's sensitivity to low-acceptance chains is
    load-bearing) during the first ``num_adaptation_steps`` (0.8 * burn-in,
    the reference's ratio);
  * trajectory length either static (``init_l`` leapfrog steps — the published
    GIGA-Lens configuration) or adapted by the ChEES criterion (Hoffman,
    Radul & Sountsov 2021), the algorithm behind the reference's
    GradientBasedTrajectoryLengthAdaptation: jittered trajectories, Adam
    ascent on the Change-in-Estimator-of-Expected-Square gradient estimate,
    capped at ``max_leapfrog_steps``.

The chain state never leaves the device; chains are sharded over the mesh's
``samples`` axis and the only cross-chain communication is the scalar
reductions used by adaptation.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gigalens_tpu.parallel import mesh as pmesh

# d x d products feed Metropolis acceptance: never TF32
_HI = jax.lax.Precision.HIGHEST


class DualAveragingState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_bar: jnp.ndarray
    h_bar: jnp.ndarray
    mu: jnp.ndarray       # shrinkage anchor log(10 * eps at (re)start)
    t_start: jnp.ndarray  # step at which this adaptation (re)started


class ChEESState(NamedTuple):
    log_t: jnp.ndarray   # log total trajectory length T
    adam_m: jnp.ndarray
    adam_v: jnp.ndarray


class HMCResult(NamedTuple):
    samples: jnp.ndarray        # (num_results, n_chains, d)
    accept_rate: jnp.ndarray    # (total_steps,) mean accept prob per step
    step_size: jnp.ndarray      # final (adapted) step size; (G,) when grouped
    final_state: jnp.ndarray    # (n_chains, d)
    trajectory_length: jnp.ndarray = jnp.zeros(())  # final T (chees) or L*eps
    # (n_chains,) count of post-adaptation proposals with |dH| > 25 (endpoint
    # energy-error divergence indicator, the batched-HMC analogue of NUTS
    # divergence counting). A nonzero rate flags chains stuck in
    # high-curvature regions whose samples are untrustworthy.
    divergences: jnp.ndarray = jnp.zeros((), jnp.int32)
    # total leapfrog steps integrated over the whole run (sum over chain
    # steps of the per-step trajectory length, max across groups) — the
    # per-gradient cost divisor for wall-clock accounting
    total_leapfrogs: jnp.ndarray = jnp.zeros((), jnp.int32)


def _da_init(eps0, t_start=0):
    """eps0 may be a scalar or a (G,) per-group vector; state matches it."""
    eps0 = jnp.asarray(eps0)
    log_eps = jnp.log(eps0)
    return DualAveragingState(
        log_eps, log_eps, jnp.zeros_like(log_eps),
        jnp.log(10.0 * eps0),
        jnp.broadcast_to(jnp.asarray(t_start, jnp.float32), log_eps.shape),
    )


def _da_update(state: DualAveragingState, t, accept_prob,
               target=0.75, gamma=0.05, t0=10.0, kappa=0.75):
    tf = jnp.maximum(t.astype(jnp.float32) - state.t_start, 0.0) + 1.0
    w = 1.0 / (tf + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_eps = state.mu - jnp.sqrt(tf) / gamma * h_bar
    eta = tf ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, state.mu, state.t_start)


def _halton(n, base=2):
    """Van der Corput sequence in (0, 1) — deterministic trajectory jitter."""
    seq = np.zeros(n)
    for i in range(n):
        f, r, idx = 1.0, 0.0, i + 1
        while idx > 0:
            f /= base
            r += f * (idx % base)
            idx //= base
        seq[i] = r
    return np.clip(seq, 0.05, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _hmc_programs(
    log_prob_fn,
    n_chains,
    d,
    step_size,
    num_leapfrog_steps,
    num_adaptation_steps,
    switch_ts,
    do_mass,
    chees,
    target_accept,
    accept_reduction,
    max_leapfrog_steps,
    chees_lr,
    mesh,
    n_groups=1,
    aot_desc=None,
):
    """Build (init_carry, run_segment) jitted programs for one HMC config.

    Memoized on the full static configuration (``log_prob_fn`` hashes by
    identity — callers must pass a stable function object, see
    ``_cached_log_prob_fn``). Both programs here are large (the render
    gradient under a scan), so re-creating them per ``fit_hmc`` call would
    make every extra HMC seed pay a retrace and recompile. With the cache,
    repeat fits at the same configuration reuse the compiled executables
    and run at pure compute cost.

    ``n_groups > 1`` partitions the (group-major-ordered) chains into G
    independent groups, each with its own preconditioner, step size,
    trajectory length, and windowed mass re-estimate — the survey mode
    (many lens systems sampled in ONE device program, each adapting to its
    own posterior geometry). All adaptation reductions become per-group;
    the only whole-batch operation left is the posterior gradient itself,
    which is what makes the batching profitable. ``G = 1``
    reproduces the single-fit path up to 1-ulp reduction-shape reordering
    (means over ``(1, C)`` vs flat ``(C,)``), which amplifies chaotically
    along trajectories — cross-refactor comparison must be statistical, not
    bitwise; scripts/check_hmc_refout.py checks posterior moments.
    """
    G = n_groups
    C = n_chains // G
    assert n_chains == G * C, "n_chains must divide evenly into n_groups"

    def grp(a):  # (n, ...) -> (G, C, ...)
        return a.reshape(G, C, *a.shape[1:])

    def flat(a):  # (G, C, ...) -> (n, ...)
        return a.reshape(n_chains, *a.shape[2:])

    def lp_and_grad(z):
        lp, vjp = jax.vjp(log_prob_fn, z)
        (g,) = vjp(jnp.ones_like(lp))
        return lp, g

    def kinetic(p, tril):
        # 0.5 p^T Sigma p computed as |L^T p|^2 / 2 (never forms Sigma^{-1});
        # p: (G, C, d), tril: (G, d, d) -> (G, C)
        return 0.5 * jnp.sum(jnp.einsum("gcd,gdi->gci", p, tril, precision=_HI) ** 2, axis=-1)

    def leapfrog(z, p, grad, eps, n_steps, m_inv):
        """z/p/grad: (G, C, d); eps: (G, 1, 1); n_steps: per-group (G,) when
        trajectory lengths differ (survey chees), else a scalar. Groups with
        shorter trajectories freeze once their step count is exhausted; the
        frozen groups' lp/grad recomputation is a no-op on their state (same
        z in, same values out) so the final half-step stays consistent."""
        p = p + 0.5 * eps * grad
        per_group = chees and G > 1
        n_max = jnp.max(n_steps) if chees else n_steps

        def body(i, carry):
            z, p, _, _ = carry
            z_new = z + eps * jnp.einsum("gcd,gde->gce", p, m_inv, precision=_HI)
            if per_group:
                z_new = jnp.where((i < n_steps)[:, None, None], z_new, z)
            lp, g = lp_and_grad(flat(z_new))
            lp, g = grp(lp), grp(g)
            p_new = p + eps * g
            if per_group:
                p_new = jnp.where((i < n_steps)[:, None, None], p_new, p)
            return z_new, p_new, lp, g

        z, p, lp, g = jax.lax.fori_loop(
            0, n_max, body, (z, p, jnp.zeros(z.shape[:2], z.dtype), grad)
        )
        p = p - 0.5 * eps * g  # undo the extra half step from the last body
        return z, p, lp, g

    def _chees_grad(z, z_new, p_new, accept_prob_c, m_inv):
        """ChEES criterion gradient estimate w.r.t. trajectory length, per
        group: (G, C, d) inputs -> (G,)."""
        zc = z - jnp.mean(z, axis=1, keepdims=True)
        zc_new = z_new - jnp.mean(z_new, axis=1, keepdims=True)
        delta = jnp.sum(zc_new**2, -1) - jnp.sum(zc**2, -1)  # (G, C)
        v_new = jnp.einsum("gcd,gde->gce", p_new, m_inv, precision=_HI)  # final velocity
        proj = jnp.sum(zc_new * v_new, -1)
        w = accept_prob_c
        return jnp.sum(w * delta * proj, axis=1) / jnp.maximum(
            jnp.sum(w, axis=1), 1e-6
        )

    def step(carry, inp):
        z, lp, grad, da, ch, t, tril, s1, s2, cnt, z_ref, div, nlf = carry
        key, h = inp
        k_mom, k_acc = jax.random.split(key)

        # Sigma per group (G x d x d, negligible vs the renders)
        m_inv = jnp.matmul(tril, jnp.swapaxes(tril, -1, -2), precision=_HI)
        inv_l = jax.scipy.linalg.solve_triangular(
            tril, jnp.broadcast_to(jnp.eye(d, dtype=tril.dtype), tril.shape),
            lower=True,
        )

        eps = jnp.where(
            t < num_adaptation_steps, jnp.exp(da.log_eps), jnp.exp(da.log_eps_bar)
        )  # (G,)
        if chees:
            traj = h * jnp.exp(ch.log_t)
            n_steps = jnp.clip(
                jnp.ceil(traj / eps).astype(jnp.int32), 1, max_leapfrog_steps
            )  # (G,)
        else:
            n_steps = num_leapfrog_steps

        eps_n = jax.random.normal(k_mom, (n_chains, d), z.dtype)
        p0 = jnp.einsum("gcd,gdi->gci", grp(eps_n), inv_l, precision=_HI)
        eps_b = eps[:, None, None]
        z_g, lp_g, grad_g = grp(z), grp(lp), grp(grad)
        z_new, p_new, lp_new, grad_new = leapfrog(
            z_g, p0, grad_g, eps_b, n_steps, m_inv
        )

        log_accept = (lp_new - kinetic(p_new, tril)) - (lp_g - kinetic(p0, tril))
        log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
        accept_prob_c = jnp.minimum(1.0, jnp.exp(log_accept))  # (G, C)
        u = jax.random.uniform(k_acc, (n_chains,), z.dtype, minval=1e-10)
        accept = grp(jnp.log(u)) < log_accept  # (G, C)

        if chees:
            g = _chees_grad(z_g, z_new, p_new, accept_prob_c, m_inv)  # (G,)
            b1, b2, eps_a = 0.9, 0.999, 1e-8
            adam_m = b1 * ch.adam_m + (1 - b1) * g
            adam_v = b2 * ch.adam_v + (1 - b2) * g**2
            tf = t.astype(jnp.float32) + 1.0
            m_hat = adam_m / (1 - b1**tf)
            v_hat = adam_v / (1 - b2**tf)
            log_t = ch.log_t + chees_lr * m_hat / (jnp.sqrt(v_hat) + eps_a)
            # keep trajectories within [eps, max_leapfrog * eps]
            log_t = jnp.clip(
                log_t, jnp.log(eps), jnp.log(max_leapfrog_steps * eps)
            )
            ch_new = ChEESState(log_t, adam_m, adam_v)
            ch = jax.tree_util.tree_map(
                lambda new, old: jnp.where(t < num_adaptation_steps, new, old),
                ch_new, ch,
            )

        z = flat(jnp.where(accept[..., None], z_new, z_g))
        lp = flat(jnp.where(accept, lp_new, lp_g))
        grad = flat(jnp.where(accept[..., None], grad_new, grad_g))
        z = pmesh.constrain_samples(z, mesh)

        # Endpoint-energy divergence count (post-adaptation only): a proposal
        # whose |dH| exceeds 25 nats marks a chain in pathological curvature —
        # both signs count (large energy LOSS is equally broken integration,
        # it just happens to be accepted); NaN energies arrive here as -inf
        div = div + jnp.where(
            (t >= num_adaptation_steps) & (jnp.abs(flat(log_accept)) > 25.0), 1, 0
        ).astype(jnp.int32)

        # Cross-chain reduction feeding dual averaging, per group. Mean
        # (default): its sensitivity to a low-acceptance minority is
        # load-bearing — it slows the step size until even high-curvature
        # chains can move. The "median" alternative was measured on the
        # benchmark and is worse: eps tunes to the median chain, stuck chains
        # never recover, and min-ESS halves (54.7 vs 88.6 ESS/s at 50 chains,
        # one rhat=2.4 blow-up at 100).
        if accept_reduction == "median":
            accept_prob = jnp.median(accept_prob_c, axis=1)
        else:
            accept_prob = jnp.mean(accept_prob_c, axis=1)  # (G,)
        da_new = _da_update(da, t, accept_prob, target=target_accept)
        da = jax.tree_util.tree_map(
            lambda new, old: jnp.where(t < num_adaptation_steps, new, old), da_new, da
        )

        if do_mass:
            # pool chain states for the covariance re-estimate; moments are
            # accumulated CENTERED on the window-start chain mean z_ref —
            # with z ~ O(10) and small moves, raw E[zz^T] - mm^T cancels
            # catastrophically in float32 and goes non-PD
            in_window = t < switch_ts[-1]
            zc = grp(z) - z_ref[:, None]  # (G, C, d)
            s1 = jnp.where(in_window, s1 + jnp.sum(zc, axis=1), s1)
            s2 = jnp.where(in_window, s2 + jnp.einsum("gcd,gce->gde", zc, zc, precision=_HI), s2)
            cnt = jnp.where(in_window, cnt + C, cnt)

            def _switch(args):
                tril, da, ch, s1, s2, cnt, z_ref = args
                m = s1 / cnt[:, None]
                cov_est = s2 / cnt[:, None, None] - jnp.einsum("gd,ge->gde", m, m, precision=_HI)
                # shrink toward the current preconditioner's covariance,
                # Stan-style (= the initial VI/Laplace covariance at the
                # first window, the previous window's estimate afterwards)
                w = (cnt / (cnt + 5.0 * d))[:, None, None]
                cov = w * cov_est + (1.0 - w) * jnp.matmul(tril, jnp.swapaxes(tril, -1, -2), precision=_HI)
                tr = jnp.trace(cov, axis1=-2, axis2=-1)[:, None, None]
                cov = cov + 1e-3 * (tr / d) * jnp.eye(d, dtype=cov.dtype)
                tril_new = jnp.linalg.cholesky(cov)
                # keep a group's old preconditioner if its estimate is unusable
                bad = jnp.any(jnp.isnan(tril_new), axis=(-2, -1))[:, None, None]
                tril_new = jnp.where(bad, tril, tril_new)
                # restart step-size adaptation at the current step size; the
                # trajectory length is in preconditioned time units, so reset
                # it too (ChEES re-adapts in the remaining window). Moment
                # accumulators restart, re-centered on the current state —
                # each window estimates from its own (better-mixed) samples
                eps_cur = jnp.exp(da.log_eps)
                ch_new = ChEESState(
                    jnp.log(num_leapfrog_steps * eps_cur),
                    jnp.zeros_like(eps_cur), jnp.zeros_like(eps_cur),
                )
                return (tril_new, _da_init(eps_cur, t_start=t), ch_new,
                        jnp.zeros_like(s1), jnp.zeros_like(s2),
                        jnp.zeros_like(cnt), jnp.mean(grp(z), axis=1))

            is_switch = jnp.asarray(False)
            for st in switch_ts:
                is_switch = is_switch | (t == st)
            tril, da, ch, s1, s2, cnt, z_ref = jax.lax.cond(
                is_switch, _switch, lambda args: args,
                (tril, da, ch, s1, s2, cnt, z_ref),
            )
        nlf = nlf + jnp.max(jnp.asarray(n_steps)).astype(jnp.int32)
        return (
            (z, lp, grad, da, ch, t + 1, tril, s1, s2, cnt, z_ref, div, nlf),
            (z, jnp.mean(accept_prob_c)),
        )

    def init_carry(z0, tril0):
        lp0, grad0 = lp_and_grad(z0)
        da0 = _da_init(jnp.full((G,), step_size, z0.dtype))
        ch0 = ChEESState(
            jnp.full((G,), jnp.log(num_leapfrog_steps * step_size), z0.dtype),
            jnp.zeros((G,)),
            jnp.zeros((G,)),
        )
        return (z0, lp0, grad0, da0, ch0, jnp.asarray(0),
                tril0, jnp.zeros((G, d)), jnp.zeros((G, d, d)),
                jnp.zeros((G,)), jnp.mean(grp(z0), axis=1),
                jnp.zeros((n_chains,), jnp.int32), jnp.zeros((), jnp.int32))

    def run_segment(carry, keys, hs):
        return jax.lax.scan(step, carry, (keys, hs))

    if aot_desc is not None:
        # cross-process program reuse: the whole chain program (and its init)
        # is serialized via jax.export, skipping trace+lowering on reruns —
        # see gigalens_tpu/utils/aot.py for the invalidation contract
        from gigalens_tpu.utils import aot

        static = "|".join(
            str(x) for x in (
                aot_desc, n_chains, d, step_size, num_leapfrog_steps,
                num_adaptation_steps, switch_ts, do_mass, chees,
                target_accept, accept_reduction, max_leapfrog_steps,
                chees_lr, n_groups,
            )
        )
        return (
            aot.aot_jit("hmc_init", init_carry, static_desc=static),
            aot.aot_jit("hmc_seg", run_segment, static_desc=static),
        )
    return jax.jit(init_carry), jax.jit(run_segment)


def sample_hmc(
    log_prob_fn,
    z0,
    key,
    *,
    step_size: float = 0.3,
    num_leapfrog_steps: int = 3,
    num_burnin_steps: int = 250,
    num_results: int = 750,
    num_adaptation_steps: Optional[int] = None,
    momentum_covariance: Optional[jnp.ndarray] = None,
    momentum_covariance_tril: Optional[jnp.ndarray] = None,
    target_accept: float = 0.75,
    accept_reduction: str = "mean",        # "mean" | "median"
    trajectory_adaptation: str = "none",   # "none" | "chees"
    max_leapfrog_steps: int = 30,
    chees_lr: float = 0.025,
    mass_adaptation: bool = True,
    mesh=None,
    segment_steps: int = 0,
    progress=None,
    n_groups: int = 1,
    aot_desc: Optional[str] = None,
):
    """Batched preconditioned HMC. ``z0``: (n_chains, d); ``log_prob_fn``
    maps (n_chains, d) -> (n_chains,).

    ``n_groups > 1`` runs G independent per-group adaptations over
    group-major-ordered chains (survey mode): pass a per-group
    ``momentum_covariance_tril`` of shape (G, d, d) (a single (d, d) factor
    is broadcast) and read back ``step_size``/``trajectory_length`` as (G,)
    vectors. The posterior gradient still evaluates the whole (n_chains, d)
    batch in one program.

    ``progress``, if given, is called after every dispatched segment with
    ``(steps_done, mean_accept_prob_of_segment)`` — live-feedback parity with
    the reference TF substrate's ``ProgressBarReducer``
    (``src/gigalens/tf/inference.py:166-169``).

    The mass matrix is M = Sigma^{-1} where Sigma is the (VI) covariance,
    given either as ``momentum_covariance`` or, preferably, by its Cholesky
    factor ``momentum_covariance_tril`` (L with Sigma = L L^T). All
    preconditioning is done through L — momentum sampling uses L^{-T} (one
    triangular solve), kinetic energy is |L^T p|^2 / 2 and the leapfrog drift
    is Sigma p — so an ill-conditioned Sigma is never inverted (float32-safe
    even when VI has not fully converged).

    ``mass_adaptation`` adds Stan-style windowed warmup: the momentum
    covariance is re-estimated from the pooled chain samples (shrunk toward
    the current preconditioner) and step-size adaptation restarts — this
    rescues runs where the VI covariance overestimates some direction, which
    otherwise collapses the step size for every direction. Pass an int for
    multiple warmup windows (True == 1 switch halfway through adaptation;
    ``k`` switches sit at fractions 1/(k+1)..k/(k+1)); extra windows give a
    collapsed step size additional recovery points."""
    n_chains, d = z0.shape
    if n_chains % n_groups:
        raise ValueError(f"{n_chains} chains do not divide into {n_groups} groups")
    if num_adaptation_steps is None:
        num_adaptation_steps = int(0.8 * num_burnin_steps)
    total_steps = num_burnin_steps + num_results
    chees = trajectory_adaptation == "chees"
    # mass_adaptation: False, or the number of Stan-style warmup windows
    # (True == 1, the round-1 behavior: one covariance re-estimate halfway
    # through adaptation). More windows give a collapsed step size more
    # chances to recover: each switch re-estimates from the latest window's
    # samples, restarts dual averaging at the current eps with a fresh
    # shrinkage anchor, and re-centers the moment accumulators.
    windows = int(mass_adaptation)
    switch_ts = tuple(
        num_adaptation_steps * (k + 1) // (windows + 1) for k in range(windows)
    )
    switch_ts = tuple(sorted({st for st in switch_ts if st >= 10}))
    do_mass = bool(switch_ts) and num_adaptation_steps >= 20
    if not do_mass:
        switch_ts = (-1,)

    if momentum_covariance_tril is not None:
        tril = jnp.asarray(momentum_covariance_tril, z0.dtype)
    elif momentum_covariance is not None:
        tril = jax.jit(jnp.linalg.cholesky)(
            jnp.asarray(momentum_covariance, z0.dtype)
        )
    else:
        tril = jnp.eye(d, dtype=z0.dtype)
    if tril.ndim == 2:
        tril = jnp.broadcast_to(tril, (n_groups, d, d))
    elif tril.shape[0] != n_groups:
        raise ValueError(
            f"per-group tril has leading dim {tril.shape[0]}, expected {n_groups}"
        )
    tril0 = tril

    init_carry, run_segment = _hmc_programs(
        log_prob_fn, n_chains, d, float(step_size), num_leapfrog_steps,
        num_adaptation_steps, switch_ts, do_mass, chees, target_accept,
        accept_reduction, max_leapfrog_steps, chees_lr, mesh, n_groups,
        aot_desc,
    )

    halton = jnp.asarray(_halton(total_steps)) if chees else jnp.ones(total_steps)
    keys = jax.random.split(key, total_steps)
    n_seg = segment_steps if segment_steps > 0 else total_steps
    carry = init_carry(z0, tril0)
    zs_parts, acc_parts = [], []
    for lo in range(0, total_steps, n_seg):
        hi = min(lo + n_seg, total_steps)
        carry, (zs, acc) = run_segment(carry, keys[lo:hi], halton[lo:hi])
        zs_parts.append(zs)
        acc_parts.append(acc)
        if progress is not None:
            jax.block_until_ready(acc)
            progress(hi, float(jnp.mean(acc)))
    zf, _, _, da, ch, _, _, _, _, _, _, div, nlf = carry
    zs = jnp.concatenate(zs_parts)
    acc = jnp.concatenate(acc_parts)
    final_eps = jnp.exp(da.log_eps_bar)
    final_t = jnp.exp(ch.log_t) if chees else num_leapfrog_steps * final_eps
    if n_groups == 1:  # preserve the scalar API of the single-fit path
        final_eps, final_t = final_eps[0], final_t[0]
    return HMCResult(zs[num_burnin_steps:], acc, final_eps, zf, final_t, div, nlf)


@functools.lru_cache(maxsize=8)
def _cached_log_prob_fn_impl(prob_model, pm_version, simulator, sim_version):
    # pm_version/sim_version participate only in the cache key: rebinding an
    # attribute on either object bumps its counter (model.VersionedAttrs),
    # so a mutated model/simulator gets a fresh closure -> fresh programs
    # instead of silently reusing executables with stale baked-in data
    del pm_version, sim_version

    def log_prob_fn(z):
        return prob_model.log_prob(simulator, z)[0]

    return log_prob_fn


def _cached_log_prob_fn(prob_model, simulator):
    """Stable posterior closure keyed on (identity, attribute-version) of the
    model and simulator, so repeat ``fit_hmc`` calls with the same objects hit
    the ``_hmc_programs`` cache instead of recompiling (see that factory's
    docstring) while attribute rebinds correctly invalidate it."""
    return _cached_log_prob_fn_impl(
        prob_model, getattr(prob_model, "_version", 0),
        simulator, getattr(simulator, "_version", 0),
    )


def _aot_desc(prob_model, simulator, mesh=None):
    """Data fingerprint enabling cross-process AOT program reuse, or None.

    See :func:`gigalens_tpu.utils.aot.phase_desc` for the gating contract."""
    from gigalens_tpu.utils import aot

    return aot.phase_desc(prob_model, simulator, mesh=mesh)


def clear_program_caches():
    """Drop all cached posterior closures and compiled HMC programs.

    The caches hold strong references to up to 8 (model, simulator) pairs and
    16 compiled program sets (device buffers included); survey-style loops
    fitting many scenes can call this between scenes to release them."""
    _cached_log_prob_fn_impl.cache_clear()
    _hmc_programs.cache_clear()


def fit_hmc(
    prob_model,
    simulator,
    q_z,
    init_eps: float = 0.3,
    init_l: int = 3,
    n_hmc: int = 50,
    num_burnin_steps: int = 250,
    num_results: int = 750,
    max_leapfrog_steps: int = 30,
    trajectory_adaptation: str = "chees",
    mass_adaptation: bool = True,
    accept_reduction: str = "mean",
    init_spread: float = 0.2,
    seed: int = 0,
    seeds=None,
    mesh=None,
    segment_steps: int = 0,
    progress=None,
):
    """VI-preconditioned posterior sampling (reference signature parity).

    ``q_z`` is the fitted SVI surrogate; its covariance becomes M^{-1} and its
    samples initialize the chains. Trajectory length adapts by ChEES (like the
    reference's GradientBasedTrajectoryLengthAdaptation) capped at
    ``max_leapfrog_steps``; pass ``trajectory_adaptation="none"`` for the
    static-L kernel. Returns :class:`HMCResult`.

    ``seeds`` (a sequence) runs all replicas in ONE grouped device program:
    each seed initializes its own ``n_hmc``-chain group and every group
    adapts independently (step size, trajectory length, mass windows), but
    the posterior gradient evaluates the whole ``len(seeds) * n_hmc`` batch
    together, and the program compiles once instead of G times. Whether G
    replicas cost less wall than G serial runs depends on how the
    per-chain gradient cost grows with the batch on the device.
    The result's ``samples`` are group-major: ``samples[:, g*n_hmc:(g+1)*n_hmc]``
    is seed ``seeds[g]``'s posterior; ``step_size``/``trajectory_length``
    come back as (G,) vectors.
    """
    if seeds is not None and len(seeds) > 1:
        n_groups = len(seeds)
    else:
        n_groups = 1
        if seeds:
            seed = seeds[0]

    # start chains in a contracted cloud around the surrogate mean: samples
    # from an overdispersed q land in high-curvature tails, whose early
    # divergences trap dual averaging at a collapsed step size
    @jax.jit
    def _init(k):
        z = q_z.sample(k, (n_hmc,))
        return q_z.mean()[None, :] + init_spread * (z - q_z.mean()[None, :])

    if n_groups > 1:
        z0 = jnp.concatenate(
            [_init(jax.random.split(jax.random.PRNGKey(s))[0]) for s in seeds]
        )  # group-major (G * n_hmc, d)
        k_chain = jax.random.split(jax.random.PRNGKey(seeds[0]))[1]
    else:
        key = jax.random.PRNGKey(seed)
        k_init, k_chain = jax.random.split(key)
        z0 = _init(k_init)
    if mesh is not None and mesh.size > 1:
        z0 = pmesh.shard_samples(z0, mesh)

    return sample_hmc(
        _cached_log_prob_fn(prob_model, simulator),
        z0,
        k_chain,
        aot_desc=_aot_desc(prob_model, simulator, mesh),
        step_size=init_eps,
        num_leapfrog_steps=init_l,
        num_burnin_steps=num_burnin_steps,
        num_results=num_results,
        momentum_covariance_tril=getattr(q_z, "scale_tril", None),
        momentum_covariance=None if hasattr(q_z, "scale_tril") else q_z.covariance(),
        trajectory_adaptation=trajectory_adaptation,
        max_leapfrog_steps=max_leapfrog_steps,
        mass_adaptation=mass_adaptation,
        accept_reduction=accept_reduction,
        mesh=mesh,
        segment_steps=segment_steps,
        progress=progress,
        n_groups=n_groups,
    )
