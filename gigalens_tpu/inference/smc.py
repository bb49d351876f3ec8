"""Sequential Monte Carlo with adaptive tempering.

Pure-JAX replacement for the reference's
``tfe.mcmc.sample_sequential_monte_carlo`` driver
(``src/gigalens/jax/inference.py:210-324``), keeping its semantics:

  * tempered target ``prior + aux + (like - aux) * beta`` where ``like`` and
    ``aux`` are selectable among {pixels, positions, none} — the auxiliary
    likelihood stays on at full strength while the target likelihood is
    annealed in (``:314-324``);
  * per-ensemble adaptive temperature steps chosen by bisection so the
    effective sample size of the incremental weights stays at
    ``ess_threshold_ratio * num_particles``;
  * systematic resampling;
  * HMC move kernels with per-particle step-size scalings tuned toward an
    0.651 acceptance rate, and a per-stage move count chosen like TFP's
    ``simple_heuristic_tuning`` (enough moves for ~95% probability that a
    particle moves at least once, capped at ``max_sampling_per_stage``).

The tempering loop runs as a ``lax.while_loop`` on device, optionally
dispatched in bounded segments (``segment_stages``, off by default); each
segment is a single host round-trip.

Degeneracy caveat (matches the reference's semantics, so it is documented
rather than silently "fixed"): the incremental weights are
``exp(delta * (like - aux))``. With ``auxiliar="positions"``, prior draws
that land near a critical curve carry position log-likelihoods of order
``-1e9`` (the position errors are magnification-scaled), so such a particle
has a huge POSITIVE increment, absorbs all weight at the first stage,
and systematic resampling clones it across the ensemble — after which the
within-ensemble increment spread is ~0, the ESS criterion reads perfect,
and beta jumps to 1 around a degenerate cloud. Pass ``start=`` a MAP
subsample (the reference's own cluster workflow) when using a position
auxiliary; ``start=None`` prior initialization is safe only for
``auxiliar="none"`` targets.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gigalens_tpu.parallel import mesh as pmesh

# d x d products feed Metropolis acceptance: never TF32
_HI = jax.lax.Precision.HIGHEST


class SMCResult(NamedTuple):
    particles: jnp.ndarray       # (P, E, d) final particles at beta = 1
    num_stages: jnp.ndarray      # scalar int
    log_scalings: jnp.ndarray    # (P, E) final per-particle step-size logs
    post_samples: jnp.ndarray    # (post_steps, P*E, d) optional HMC chain
    final_beta: jnp.ndarray      # (E,) 1.0 unless max_stage was hit first
    # (E,) per-ensemble log model evidence (marginal likelihood) estimate:
    # sum over tempering stages of log mean incremental weight. Estimates
    # log E_{prior * aux}[exp(like - aux)] — with auxiliar="none" and prior
    # initialization this is the standard SMC estimate of log p(data), the
    # quantity Bayes-factor model comparison needs (a capability the
    # reference's TFP SMC driver does not expose). Only meaningful when
    # ``start=None`` (particles begin as exact prior draws) and
    # ``final_beta == 1``; with a MAP-subsample start the bridge does not
    # begin at the prior and the estimate is biased.
    log_evidence: jnp.ndarray = jnp.zeros(())


def _systematic_resample(key, logw, z_extra):
    """Systematic resampling along axis 0. logw: (P,), z_extra: pytree of (P, ...)."""
    p = logw.shape[0]
    w = jax.nn.softmax(logw, axis=0)
    cdf = jnp.cumsum(w)
    u = jax.random.uniform(key, ())
    pts = (jnp.arange(p) + u) / p
    idx = jnp.searchsorted(cdf, pts)
    idx = jnp.clip(idx, 0, p - 1)
    return jax.tree_util.tree_map(lambda a: a[idx], z_extra)


class _Particles(NamedTuple):
    """Particles with their cached log-density parts AND part-gradients.

    The tempered target is ``lp + aux + (like - aux) * beta`` — affine in
    ``beta`` — so caching the three parts and their three gradients lets
    any stage's density/gradient at any temperature be formed
    algebraically. That removes the per-stage ``like_parts`` re-eval and
    the leading gradient eval of every HMC move (the dominant per-eval
    cost, the simulator render backward, is identical whether the parts
    are differentiated jointly or separately: their graphs are disjoint
    above ``constrain``). Measured ~10% off the P=1000 benchmark's
    tempering loop at bitwise-identical RNG decisions.
    """

    z: jnp.ndarray        # (P, E, d)
    like: jnp.ndarray     # (P, E)
    aux: jnp.ndarray      # (P, E)
    lp: jnp.ndarray       # (P, E) prior
    g_like: jnp.ndarray   # (P, E, d)
    g_aux: jnp.ndarray    # (P, E, d)
    g_lp: jnp.ndarray     # (P, E, d)


class _State(NamedTuple):
    key: jnp.ndarray
    part: _Particles          # particles + cached parts/gradients
    beta: jnp.ndarray         # (E,)
    log_scalings: jnp.ndarray  # (P, E)
    num_steps: jnp.ndarray    # () int
    stage: jnp.ndarray        # () int
    log_z: jnp.ndarray        # (E,) accumulated log-evidence estimate



def fit_smc(
    prob_model,
    simulator,
    start=None,
    num_particles: int = 1000,
    num_ensembles: int = 1,
    num_leapfrog_steps: int = 10,
    post_sampling_steps: int = 100,
    ess_threshold_ratio: float = 0.8,
    max_sampling_per_stage: int = 8,
    min_sampling_per_stage: int = 1,
    max_stage: int = 100,
    target: str = "pixels",
    auxiliar: str = "positions",
    optimal_accept: float = 0.651,
    precondition_moves: bool = True,
    seed: int = 1,
    mesh=None,
    segment_stages: int = 0,
    progress=None,
    aot_desc=None,
):
    P, E = num_particles, num_ensembles
    n = P * E
    d = prob_model.prior.d
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)

    if start is None:
        @jax.jit
        def _init(key):
            return prob_model.prior.unconstrain(prob_model.prior.sample(key, (P, E)))

        z0 = _init(k_init)
    elif jnp.ndim(start) == 3:
        # pre-shaped (P, E, d) starts — the caller controls which rows seed
        # which ensemble (survey mode: each scene's ensemble must start from
        # that scene's own MAP subsample, not a global scramble)
        start = jnp.asarray(start)
        if start.shape != (P, E, d):
            raise ValueError(
                f"3-D start must be ({P}, {E}, {d}); got {start.shape}"
            )
        z0 = start
    else:
        # subsample the provided starts (e.g. MAP output); with fewer starts
        # than particles, duplicates are fine — the HMC moves re-diversify
        replace = int(jnp.shape(start)[0]) < n  # rank/shape only: no transfer

        @jax.jit
        def _pick(key, start):
            idx = jax.random.choice(key, start.shape[0], (P, E), replace=replace)
            return start[idx]

        z0 = _pick(k_init, jnp.asarray(start))

    if mesh is not None and mesh.size > 1:
        # particles ride the mesh's sample axis; the only cross-device
        # traffic is the resampling gather and the scalar stage reductions
        z0 = pmesh.shard_samples(z0, mesh)

    def _stats(name, required=False):
        # a callable is used directly: signature (constrained params pytree
        # for n = P*E rows) -> (n,) log-likelihood — custom science terms
        # (e.g. a magnification prior, external datasets) without touching
        # the driver
        if callable(name):
            return name
        # degrade the *auxiliary* term gracefully when the model lacks it
        # (the default auxiliar="positions" on a pixels-only model means "no
        # auxiliary likelihood", matching the reference's intent at
        # src/gigalens/jax/inference.py:234-240); a missing *target* term
        # would silently sample the prior, so that raises instead
        missing = (
            "pixels" in name and not getattr(prob_model, "include_pixels", True)
        ) or (
            "positions" in name
            and not getattr(prob_model, "include_positions", True)
        )
        if missing:
            if required:
                raise ValueError(
                    f"SMC target likelihood {name!r} is not configured on "
                    "this probabilistic model"
                )
            name = "none"
        if name == "pixels":
            return lambda x: prob_model.stats_pixels(simulator, x)[0]
        if name == "positions":
            return lambda x: prob_model.stats_positions(simulator, x)[0]
        if name == "pixels+positions":
            # combined-likelihood tempering (beyond the reference's
            # {pixels, positions, none} menu): annealing BOTH terms from the
            # prior is the robust choice when the position term's
            # magnification-scaled errors produce huge log-likelihood
            # magnitudes — as the tempered target, a pathological particle's
            # increment is hugely NEGATIVE (weight -> 0, harmless) instead
            # of hugely positive (weight -> 1, ensemble collapse) as it is
            # on the auxiliary side. Use with auxiliar="none".
            return lambda x: (
                prob_model.stats_pixels(simulator, x)[0]
                + prob_model.stats_positions(simulator, x)[0]
            )
        if name == "none":
            return lambda x: jnp.zeros((n,))
        raise ValueError(f"unknown likelihood selector: {name}")

    target_fn = _stats(target, required=True)
    aux_fn = _stats(auxiliar)

    def eval_particles(z):
        """Full forward + the three part-gradients at z."""
        ones = jnp.ones((P, E))
        like, vjp_l = jax.vjp(
            lambda zz: target_fn(prob_model.prior.constrain(zz.reshape(n, d))).reshape(P, E), z
        )
        (g_like,) = vjp_l(ones)
        aux, vjp_a = jax.vjp(
            lambda zz: aux_fn(prob_model.prior.constrain(zz.reshape(n, d))).reshape(P, E), z
        )
        (g_aux,) = vjp_a(ones)
        lp, vjp_p = jax.vjp(
            lambda zz: prob_model.prior.log_prob_z(zz.reshape(n, d)).reshape(P, E), z
        )
        (g_lp,) = vjp_p(ones)
        return _Particles(z, like, aux, lp, g_like, g_aux, g_lp)

    def tempered_of(p: _Particles, beta):
        return p.lp + p.aux + (p.like - p.aux) * beta[None, :]

    def grad_of(p: _Particles, beta):
        b = beta[None, :, None]
        return p.g_lp + p.g_aux + (p.g_like - p.g_aux) * b

    def find_delta(incr, beta):
        """Per-ensemble bisection for the temperature increment.

        incr: (P, E) = like - aux. Chooses delta in (0, 1-beta] with
        ESS(exp(delta * incr)) ~= ess_threshold_ratio * P.
        """
        target_log_ess = jnp.log(ess_threshold_ratio * P)

        def log_ess(delta):  # delta: (E,)
            logw = delta[None, :] * incr
            return 2 * jax.scipy.special.logsumexp(logw, axis=0) - \
                jax.scipy.special.logsumexp(2 * logw, axis=0)

        lo = jnp.zeros((E,))
        hi = 1.0 - beta

        def body(_, carry):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            # step too big when ESS drops below target; written as a negated
            # >= so a NaN log-ESS (e.g. a non-finite increment) also counts
            # as too big instead of silently inflating the temperature jump
            too_small_ess = ~(log_ess(mid) >= target_log_ess)
            hi = jnp.where(too_small_ess, mid, hi)
            lo = jnp.where(too_small_ess, lo, mid)
            return lo, hi

        lo, hi = jax.lax.fori_loop(0, 30, body, (lo, hi))
        # If even the full remaining step keeps ESS above target, jump to 1.
        full_ok = log_ess(1.0 - beta) >= target_log_ess
        return jnp.where(full_ok, 1.0 - beta, 0.5 * (lo + hi))

    def move_tril(z):
        """Per-ensemble preconditioner for the HMC moves: the Cholesky factor
        of the (ridged) particle covariance. The particle cloud at each stage
        IS a sample of the current tempered target, so its covariance is the
        natural mass matrix — the same role the VI covariance plays for the
        main HMC driver. Ridge keeps a collapsed cloud decomposable."""
        zc = z - jnp.mean(z, axis=0, keepdims=True)  # (P, E, d)
        cov = jnp.einsum("ped,pef->edf", zc, zc, precision=_HI) / P
        tr = jnp.trace(cov, axis1=-2, axis2=-1)[:, None, None]
        cov = cov + (1e-3 * tr / d + 1e-10) * jnp.eye(d, dtype=cov.dtype)
        return jnp.linalg.cholesky(cov)

    def hmc_move(key, part: _Particles, beta, log_scalings, tril=None):
        """One HMC step per particle at the tempered target.

        ``tril``: optional (E, d, d) per-ensemble mass preconditioner
        (momentum ~ N(0, Sigma^{-1}), drift = eps * Sigma p — identical
        conventions to ``inference.hmc``); None = identity mass.

        Consumes and returns cached part values/gradients: the leading
        gradient comes from the carry (no eval) and the proposal's parts are
        accept-selected back into the carry for the next move or stage."""
        eps = jnp.exp(log_scalings)[..., None]  # (P, E, 1)

        if tril is None:
            drift = kinetic_t = lambda p: p
        else:
            m = jnp.matmul(tril, jnp.swapaxes(tril, -1, -2), precision=_HI)  # Sigma (E, d, d)
            inv_l = jax.scipy.linalg.solve_triangular(
                tril, jnp.broadcast_to(jnp.eye(d, dtype=tril.dtype), tril.shape),
                lower=True,
            )
            drift = lambda p: jnp.einsum("ped,edf->pef", p, m, precision=_HI)
            kinetic_t = lambda p: jnp.einsum("ped,edi->pei", p, tril, precision=_HI)

        lp_val = tempered_of(part, beta)
        k_mom, k_acc = jax.random.split(key)
        eps_n = jax.random.normal(k_mom, part.z.shape, part.z.dtype)
        p0 = eps_n if tril is None else jnp.einsum("ped,edi->pei", eps_n, inv_l, precision=_HI)
        p = p0 + 0.5 * eps * grad_of(part, beta)

        def leap(_, carry):
            prt, p = carry
            prt = eval_particles(prt.z + eps * drift(p))
            p = p + eps * grad_of(prt, beta)
            return prt, p

        part_new, p_new = jax.lax.fori_loop(
            0, num_leapfrog_steps, leap, (part, p)
        )
        p_new = p_new - 0.5 * eps * grad_of(part_new, beta)
        lp_new = tempered_of(part_new, beta)

        kin0 = 0.5 * jnp.sum(kinetic_t(p0) ** 2, -1)
        kin1 = 0.5 * jnp.sum(kinetic_t(p_new) ** 2, -1)
        log_accept = (lp_new - kin1) - (lp_val - kin0)
        log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
        u = jax.random.uniform(k_acc, log_accept.shape, minval=1e-10)
        accept = jnp.log(u) < log_accept
        acc_v = accept[..., None]
        part = jax.tree_util.tree_map(
            lambda new, old: jnp.where(acc_v if new.ndim == 3 else accept, new, old),
            part_new, part,
        )
        return part, jnp.minimum(1.0, jnp.exp(log_accept))

    init_log_scaling = float(np.log(min(1.0, 2.38**2 / d)))

    def cond(s: _State):
        return (jnp.min(s.beta) < 1.0) & (s.stage < max_stage)

    def stage_body(s: _State):
        key, k_res, k_move = jax.random.split(s.key, 3)

        incr = s.part.like - s.part.aux  # cached — no re-eval
        delta = find_delta(incr, s.beta)
        beta_new = jnp.minimum(1.0, s.beta + delta)
        logw = (beta_new - s.beta)[None, :] * incr  # (P, E)

        # Evidence accumulator: particles enter each stage equally weighted
        # (the previous stage resampled), so log mean(w) estimates
        # log Z(beta_new)/Z(beta), and the sum over stages telescopes to
        # log Z(1)/Z(0) = the log marginal likelihood (Del Moral et al. 2006)
        log_z = s.log_z + jax.scipy.special.logsumexp(logw, axis=0) - jnp.log(
            jnp.asarray(P, logw.dtype)
        )

        # systematic resampling per ensemble (vmap over E on axis 1); the
        # cached parts/gradients ride the same gather as the positions
        res_keys = jax.random.split(k_res, E)
        to_e = lambda a: jnp.swapaxes(a, 0, 1)
        part_t, ls_t = jax.vmap(
            lambda k, lw, prt, ls: _systematic_resample(k, lw, (prt, ls))
        )(
            res_keys, to_e(logw),
            jax.tree_util.tree_map(to_e, s.part), to_e(s.log_scalings),
        )
        part = jax.tree_util.tree_map(to_e, part_t)
        log_scalings = to_e(ls_t)

        # MCMC moves at the new temperature. With preconditioning, the mass
        # is FIXED for the stage (computed from the post-resampling cloud):
        # a per-move state-dependent mass would break the kernel's
        # invariance; one particle's O(1/P) influence on the shared
        # covariance is the standard adaptive-SMC approximation.
        tril = move_tril(part.z) if precondition_moves else None

        def move(i, carry):
            part, acc_sum, k = carry
            k, k_step = jax.random.split(k)
            part, acc = hmc_move(k_step, part, beta_new, log_scalings, tril)
            return part, acc_sum + acc, k

        part, acc_sum, _ = jax.lax.fori_loop(
            0, s.num_steps, move, (part, jnp.zeros((P, E)), k_move)
        )
        avg_accept = acc_sum / s.num_steps.astype(jnp.float32)  # (P, E)

        # --- heuristic tuning (TFP simple_heuristic_tuning analogue) -------
        mean_accept = jnp.mean(avg_accept, axis=0, keepdims=True)  # (1, E)
        log_scalings = log_scalings + (mean_accept - optimal_accept)
        log_scalings = jnp.clip(log_scalings, -10.0, 2.0)
        p_move = jnp.clip(jnp.mean(avg_accept), 1e-3, 1 - 1e-4)
        num_steps = jnp.ceil(jnp.log1p(-0.95) / jnp.log1p(-p_move)).astype(jnp.int32)
        num_steps = jnp.clip(num_steps, min_sampling_per_stage, max_sampling_per_stage)

        part = part._replace(z=pmesh.constrain_samples(part.z, mesh))
        return _State(key, part, beta_new, log_scalings, num_steps, s.stage + 1,
                      log_z)

    def run_stages(s, seg_end):
        """Advance the tempering while_loop up to ``seg_end`` stages.

        Segmenting bounds the wall-time of a single device dispatch (as
        ``segment_steps`` does for MAP/SVI/HMC)."""
        def seg_cond(s):
            return cond(s) & (s.stage < seg_end)

        return jax.lax.while_loop(seg_cond, stage_body, s)

    # post-SMC HMC chain at beta = 1 reusing tuned scalings, dispatched in
    # the same bounded segments as the tempering loop
    def post_chunk(part, log_scalings, keys, tril):
        def post_step(part, key):
            part, _ = hmc_move(key, part, jnp.ones((E,)), log_scalings, tril)
            return part, part.z.reshape(n, d)

        part, post = jax.lax.scan(post_step, part, keys)
        return part, post

    def run_post(s):
        if post_sampling_steps <= 0:
            return (s.part.z, s.stage, s.log_scalings, jnp.zeros((0, n, d)),
                    s.beta, s.log_z)
        chunk = post_sampling_steps
        if segment_stages > 0:
            # bound each post dispatch by one tempering segment's move count;
            # raising segment_stages scales both dispatch budgets
            chunk = max(segment_stages * max_sampling_per_stage, 1)
        # Equal-length chunks so post_chunk compiles exactly once: ceil-divide
        # into n_chunks segments of identical size, run the few surplus steps,
        # and slice the extra samples away after concatenation.
        n_chunks = -(-post_sampling_steps // chunk)
        size = -(-post_sampling_steps // n_chunks)
        keys = jax.random.split(s.key, size * n_chunks)
        # fixed mass for the whole post chain, from the final particle cloud
        tril = jax.jit(move_tril)(s.part.z) if precondition_moves else None
        part, parts = s.part, []
        for lo in range(0, size * n_chunks, size):
            part, post = post_chunk(part, s.log_scalings, keys[lo : lo + size],
                                    tril)
            jax.block_until_ready(post)
            parts.append(post)
        # particles stay the beta=1 tempering output (the post chain is a
        # separate sample stream), matching the unsegmented behavior
        return (s.part.z, s.stage, s.log_scalings,
                jnp.concatenate(parts)[:post_sampling_steps], s.beta, s.log_z)

    # cross-process AOT program reuse (see utils/aot.py): the tempering and
    # post-chain programs are the two big compiles (~35% of the round-2
    # P=1000 wall was compile). Callable target/auxiliar terms cannot be
    # fingerprinted -> plain jit.
    if aot_desc is not None and not (callable(target) or callable(auxiliar)):
        from gigalens_tpu.utils import aot

        # stage_body closes over the mesh (constrain_samples / z0 sharding),
        # so the mesh topology must be part of the key: a direct fit_smc call
        # with a multi-device mesh must not collide with a mesh=None export
        mesh_desc = "mesh=none" if mesh is None else (
            f"mesh={mesh.shape}/{','.join(mesh.axis_names)}"
        )
        static = "|".join(str(x) for x in (
            aot_desc, P, E, num_leapfrog_steps, post_sampling_steps,
            ess_threshold_ratio, max_sampling_per_stage,
            min_sampling_per_stage, max_stage, target, auxiliar,
            optimal_accept, precondition_moves, mesh_desc,
        ))
        run_stages = aot.aot_jit("smc_stages", run_stages, static_desc=static)
        post_chunk = aot.aot_jit("smc_post", post_chunk, static_desc=static)
    else:
        run_stages = jax.jit(run_stages)
        post_chunk = jax.jit(post_chunk)

    s = _State(
        key=key,
        part=jax.jit(eval_particles)(z0),
        beta=jnp.zeros((E,)),
        log_scalings=jnp.full((P, E), init_log_scaling),
        num_steps=jnp.asarray(max_sampling_per_stage, jnp.int32),
        stage=jnp.asarray(0, jnp.int32),
        log_z=jnp.zeros((E,)),
    )
    seg = segment_stages if segment_stages > 0 else max_stage
    while True:
        stage0 = int(s.stage)
        s = run_stages(s, jnp.asarray(stage0 + seg, jnp.int32))
        jax.block_until_ready(s.part.z)
        if progress is not None:
            progress(int(s.stage), float(jnp.min(s.beta)))
        if float(jnp.min(s.beta)) >= 1.0 or int(s.stage) >= max_stage:
            break
    z, stages, log_scalings, post, beta, log_z = run_post(s)
    return SMCResult(z, stages, log_scalings, post, beta, log_z)
