"""Survey mode: fit S independent lens systems in single device programs.

Beyond the reference (which fits one system per process,
``src/gigalens/jax/inference.py``), this drives the same MAP -> SVI -> HMC
pipeline over a whole *catalogue* of observations at once:

  * one scene-batched likelihood (:class:`gigalens_tpu.model.SurveyForwardProbModel`)
    scores ``S * K`` scene-major rows in one render batch;
  * MAP is the ordinary multi-start fit — the starts of all scenes share one
    Adam program;
  * SVI optimizes S independent MVN surrogates jointly
    (:func:`gigalens_tpu.inference.svi.fit_svi_survey`);
  * HMC runs all scenes' chains in one program with per-scene adaptation
    (``sample_hmc(n_groups=S)``: per-scene preconditioner, step size,
    ChEES trajectory length, and windowed mass re-estimate).

Why batch scenes instead of looping: a single 80x80 system at 50 chains is
a small program for one device, and every per-scene program dispatch pays
host round-trips. Survey batching fills the device and shards the flat
scene-major sample axis over the mesh like any other batch.

All scenes share the camera geometry (one ``SimulatorConfig``) and the model
family + prior; what differs per scene is the observation (and optionally
per-scene noise). This matches the survey use case: uniform cutouts from one
imaging survey, one modeling configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from gigalens_tpu.inference.hmc import HMCResult, _cached_log_prob_fn, sample_hmc
from gigalens_tpu.inference.map import fit_map
from gigalens_tpu.inference.sequence import phase_simulator
from gigalens_tpu.inference.smc import SMCResult, fit_smc
from gigalens_tpu.inference.svi import fit_svi_survey
from gigalens_tpu.model import SurveyForwardProbModel
from gigalens_tpu.parallel import mesh as pmesh
from gigalens_tpu.simulator import LensSimulator


class _SceneEnsembleAdapter:
    """Adapts a scene-major survey model to SMC's (P, E) particle order.

    ``fit_smc`` flattens particles (P, E, d) to rows ``p * E + e``
    (ensemble-minor); :class:`SurveyForwardProbModel` scores scene-major
    blocks ``s * K + k``. With one SMC ensemble per scene (E = S, K = P),
    the two orders are a transpose: permute rows to scene-major, evaluate,
    permute the per-row stats back. The permutation is a reshape+swap —
    free at the XLA level relative to the renders it brackets.
    """

    def __init__(self, survey_model, num_particles: int):
        self._m = survey_model
        self._P = num_particles
        self.prior = survey_model.prior
        self.include_pixels = survey_model.include_pixels
        self.include_positions = survey_model.include_positions

    def _to_scene_major(self, x):
        P, S = self._P, self._m.n_scenes

        def perm(a):
            return jnp.swapaxes(
                a.reshape(P, S, *a.shape[1:]), 0, 1
            ).reshape(P * S, *a.shape[1:])

        return jax.tree_util.tree_map(perm, x)

    def _from_scene_major(self, y):
        P, S = self._P, self._m.n_scenes
        return jnp.swapaxes(y.reshape(S, P), 0, 1).reshape(P * S)

    def stats_pixels(self, simulator, x):
        ll, chi = self._m.stats_pixels(simulator, self._to_scene_major(x))
        return self._from_scene_major(ll), self._from_scene_major(chi)

    def stats_positions(self, simulator, x):
        ll, chi = self._m.stats_positions(simulator, self._to_scene_major(x))
        return self._from_scene_major(ll), self._from_scene_major(chi)


class SurveySequence:
    """MAP -> SVI -> HMC over a catalogue of observations.

    ``prob_model`` must be a :class:`SurveyForwardProbModel`; its
    ``n_scenes`` fixes S. Method batch sizes are *per scene*.
    """

    def __init__(self, phys_model, prob_model, sim_config, mesh=None):
        from gigalens_tpu.model import SurveyBackwardProbModel

        if not isinstance(
            prob_model, (SurveyForwardProbModel, SurveyBackwardProbModel)
        ):
            raise TypeError(
                "SurveySequence requires a SurveyForwardProbModel or "
                "SurveyBackwardProbModel"
            )
        self.phys_model = phys_model
        self.prob_model = prob_model
        self.sim_config = sim_config
        self.mesh = mesh if mesh is not None else pmesh.default_mesh()
        self.n_scenes = prob_model.n_scenes
        self._sims = {}

    def _sim(self, bs: int, exact: bool = False) -> LensSimulator:
        """Shared exact/fast PSF-path policy — see
        :func:`gigalens_tpu.inference.sequence.phase_simulator`."""
        return phase_simulator(self._sims, self.sim_config, self.phys_model,
                               bs, exact)

    def _per_scene(self, k: int, what: str) -> int:
        """Round the per-scene batch so the flat scene-major batch divides
        the mesh."""
        return pmesh.round_to_multiple(k, self.mesh.size, what)

    def MAP(
        self,
        optimizer: optax.GradientTransformation,
        n_starts: int = 32,
        num_steps: int = 350,
        seed: int = 0,
        segment_steps: int = 0,
        progress=None,
    ):
        """Multi-start Adam with ``n_starts`` starts per scene; returns the
        (S * n_starts, d) scene-major unconstrained parameter matrix."""
        k = self._per_scene(n_starts, "n_starts")
        sim = self._sim(self.n_scenes * k)
        z, _ = fit_map(
            self.prob_model, sim, optimizer,
            n_samples=self.n_scenes * k, num_steps=num_steps, seed=seed,
            mesh=self.mesh, segment_steps=segment_steps, progress=progress,
        )
        return z

    def best_per_scene(self, z):
        """Highest-posterior start of each scene; (S, d)."""
        sim = self._sim(z.shape[0])
        S = self.n_scenes
        k = z.shape[0] // S

        @jax.jit
        def _best(z):
            lp, _ = self.prob_model.log_prob(sim, z)
            lp = jnp.where(jnp.isnan(lp), -jnp.inf, lp).reshape(S, k)
            return z.reshape(S, k, -1)[jnp.arange(S), jnp.argmax(lp, axis=1)]

        return _best(z)

    def laplace_scale_trils(self, z_best):
        """Per-scene Laplace factors at the per-scene MAPs — the recommended
        ``init_scales`` for :meth:`SVI` (same measured rationale as
        ``ModellingSequence.laplace_scale_tril``: a deterministic
        curvature-based initializer cuts the SVI step budget ~5x and removes
        the step-size-collapse seeds that a half-converged isotropic-init
        surrogate produces). Runs on the default device; one FD gradient
        batch covers all scenes (``laplace_scale_trils_survey``), on the
        FFT conv as in ``ModellingSequence.laplace_scale_tril``."""
        import numpy as np

        from gigalens_tpu.inference.map import laplace_scale_trils_survey

        cfg = dataclasses.replace(self.sim_config, psf_mode="fft")
        z_best = np.asarray(z_best)
        d = z_best.shape[-1]
        sim = LensSimulator(self.phys_model, cfg, bs=self.n_scenes * 2 * d)
        L = laplace_scale_trils_survey(
            self.prob_model, sim, jnp.asarray(z_best)
        )
        return np.asarray(L)

    def SVI(
        self,
        starts,
        optimizer: optax.GradientTransformation,
        n_vi: int = 64,
        init_scales=1e-3,
        num_steps: int = 300,
        seed: int = 0,
        segment_steps: int = 0,
        full_rank: bool = True,
        progress=None,
    ):
        """Per-scene surrogates; ``starts`` is (S, d) (e.g. ``best_per_scene``).
        Returns ``(means (S, d), trils (S, d, d), losses (num_steps, S))``."""
        n_vi = self._per_scene(n_vi, "n_vi")
        sim = self._sim(self.n_scenes * n_vi)
        return fit_svi_survey(
            self.prob_model, sim, starts, optimizer, n_vi=n_vi,
            init_scales=init_scales, num_steps=num_steps, seed=seed,
            mesh=self.mesh, segment_steps=segment_steps, full_rank=full_rank,
            progress=progress,
        )

    def HMC(
        self,
        q_means,
        q_trils,
        init_eps: float = 0.3,
        init_l: int = 3,
        n_hmc: int = 16,
        num_burnin_steps: int = 250,
        num_results: int = 750,
        max_leapfrog_steps: int = 30,
        trajectory_adaptation: str = "chees",
        mass_adaptation: bool = True,
        init_spread: float = 0.2,
        seed: int = 0,
        segment_steps: int = 0,
        progress=None,
    ) -> HMCResult:
        """Sample all scenes in one program: ``n_hmc`` chains per scene,
        per-scene preconditioning/adaptation via ``sample_hmc(n_groups=S)``.

        ``q_means (S, d)`` / ``q_trils (S, d, d)`` come from :meth:`SVI`.
        Returns an :class:`HMCResult` whose ``samples`` are
        (num_results, S * n_hmc, d) scene-major — reshape with
        :meth:`scene_samples` — and whose ``step_size`` /
        ``trajectory_length`` are per-scene (S,) vectors."""
        S = self.n_scenes
        n_hmc = self._per_scene(n_hmc, "n_hmc chains")
        sim = self._sim(S * n_hmc, exact=True)
        key = jax.random.PRNGKey(seed)
        k_init, k_chain = jax.random.split(key)
        q_means = jnp.asarray(q_means)
        q_trils = jnp.asarray(q_trils)
        d = q_means.shape[-1]

        # contracted per-scene chain starts (same rationale as fit_hmc)
        @jax.jit
        def _init(k):
            eps = jax.random.normal(k, (S, n_hmc, d))
            z = q_means[:, None] + init_spread * jnp.einsum(
                "scd,sed->sce", eps, q_trils
            )
            return z.reshape(S * n_hmc, d)

        z0 = _init(k_init)
        if self.mesh is not None and self.mesh.size > 1:
            z0 = pmesh.shard_samples(z0, self.mesh)

        return sample_hmc(
            _cached_log_prob_fn(self.prob_model, sim),
            z0,
            k_chain,
            step_size=init_eps,
            num_leapfrog_steps=init_l,
            num_burnin_steps=num_burnin_steps,
            num_results=num_results,
            momentum_covariance_tril=q_trils,
            trajectory_adaptation=trajectory_adaptation,
            max_leapfrog_steps=max_leapfrog_steps,
            mass_adaptation=mass_adaptation,
            mesh=self.mesh,
            segment_steps=segment_steps,
            progress=progress,
            n_groups=S,
        )

    def SMC(
        self,
        start=None,
        num_particles: int = 500,
        num_leapfrog_steps: int = 10,
        post_sampling_steps: int = 100,
        ess_threshold_ratio: float = 0.8,
        max_sampling_per_stage: int = 8,
        max_stage: int = 100,
        target: Optional[str] = None,
        seed: int = 1,
        segment_stages: int = 0,
        progress=None,
    ) -> SMCResult:
        """Tempered SMC over the catalogue: one ensemble per scene in one
        program. Each scene gets its own adaptive temperature schedule
        (per-ensemble bisection), per-particle step-size tuning, and —
        prior-initialized — its own ``log_evidence`` entry: S Bayes-factor
        numerators from a single run.

        ``start``: None (prior init, required for evidence) or the survey
        MAP output (S*K, d) scene-major — each scene's ensemble subsamples
        its own scene's starts. ``res.particles`` is (P, S, d) with axis 1
        the scene axis; ``res.final_beta`` / ``res.log_evidence`` are (S,);
        ``res.post_samples`` rows are scene-major (``s * P + p``, reordered
        from the single-system driver's particle-major flatten).
        The stage loop runs until the SLOWEST scene reaches beta = 1
        (finished scenes keep making beta=1 moves — pure posterior sampling,
        harmless); the per-stage move count adapts to the global mean
        acceptance."""
        S = self.n_scenes
        P = self._per_scene(num_particles, "num_particles")
        sim = self._sim(P * S, exact=True)
        model = _SceneEnsembleAdapter(self.prob_model, P)

        if start is not None:
            start = jnp.asarray(start)
            K = start.shape[0] // S
            key = jax.random.PRNGKey(seed)

            @jax.jit
            def _pick(key):
                scenes = start.reshape(S, K, -1)

                # per-scene independent subsampling (a single flattened
                # (S, P) choice either crashes for P <= K < S*P or couples
                # the scenes' no-repeat pools)
                def pick_one(k, sc):
                    idx = jax.random.choice(k, K, (P,), replace=K < P)
                    return sc[idx]

                picked = jax.vmap(pick_one)(jax.random.split(key, S), scenes)
                return jnp.swapaxes(picked, 0, 1)  # (P, S, d)

            start = _pick(key)

        res = fit_smc(
            model,
            sim,
            start=start,
            num_particles=P,
            num_ensembles=S,
            num_leapfrog_steps=num_leapfrog_steps,
            post_sampling_steps=post_sampling_steps,
            ess_threshold_ratio=ess_threshold_ratio,
            max_sampling_per_stage=max_sampling_per_stage,
            max_stage=max_stage,
            # default target follows the configured data so SMC samples the
            # SAME posterior as MAP/SVI/HMC: combined tempering when the
            # model has position terms (the robust form near critical
            # curves — fit_smc's degeneracy caveat), pixels-only otherwise.
            # The auxiliary side stays off in survey mode.
            target=target if target is not None else (
                "pixels+positions" if self.prob_model.include_positions
                else "pixels"
            ),
            auxiliar="none",
            seed=seed,
            mesh=self.mesh,
            segment_stages=segment_stages,
            progress=progress,
        )
        if res.post_samples.shape[0]:
            # fit_smc's post chain flattens (P, E) particle-major (rows
            # p*S + s); every survey output is documented scene-major, so
            # reorder to rows s*P + p before handing it back
            T, n, d = res.post_samples.shape
            post = jnp.swapaxes(
                res.post_samples.reshape(T, P, S, d), 1, 2
            ).reshape(T, n, d)
            res = res._replace(post_samples=post)
        return res

    def scene_samples(self, res: HMCResult):
        """(num_results, S * C, d) -> (S, num_results * C, d) per-scene draws."""
        T, n, d = res.samples.shape
        C = n // self.n_scenes
        return (
            jnp.swapaxes(res.samples.reshape(T, self.n_scenes, C, d), 0, 1)
            .reshape(self.n_scenes, T * C, d)
        )

    def summarize(self, res: HMCResult):
        """Per-scene named posterior summaries (physical space).

        Returns a length-S list of :func:`gigalens_tpu.utils.summarize_posterior`
        dicts — each scene's chains are summarized separately (R-hat/ESS per
        scene, that scene's divergence count in ``_global``), the catalogue
        fit report in one call."""
        from gigalens_tpu.utils import summarize_posterior

        T, n, d = res.samples.shape
        S = self.n_scenes
        C = n // S
        chains = res.samples.reshape(T, S, C, d)
        div = jnp.asarray(res.divergences).reshape(S, C)
        return [
            summarize_posterior(
                self.prob_model.prior, chains[:, s], divergences=div[s]
            )
            for s in range(S)
        ]

    def fit(
        self,
        n_starts: int = 32,
        map_steps: int = 350,
        n_vi: int = 64,
        vi_steps: int = 300,
        n_hmc: int = 16,
        num_burnin_steps: int = 250,
        num_results: int = 750,
        map_lr: float = 1e-2,
        svi_lr: float = 3e-3,
        seed: int = 0,
        progress=None,
    ):
        """One-call survey pipeline: MAP -> per-scene Laplace -> SVI -> HMC.

        The survey analogue of :meth:`ModellingSequence.fit` with the same
        measured-best recipe, run scene-batched: every phase is a single
        device program over all S scenes, with per-scene surrogates and
        per-scene HMC adaptation. Returns a dict with ``z_map, best,
        q_means, q_trils, losses, hmc, summaries`` (one per scene) and
        ``times``.
        """
        import time as _time

        import numpy as np

        def _progress(phase):
            if progress is None:
                return None
            return lambda step, value: progress(phase, step, value)

        times = {}

        t0 = _time.time()
        sched = optax.polynomial_schedule(-map_lr, -map_lr / 3, 0.5, map_steps)
        opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
        z_map = self.MAP(opt, n_starts=n_starts, num_steps=map_steps,
                         seed=seed, progress=_progress("map"))
        jax.block_until_ready(z_map)
        best = self.best_per_scene(z_map)
        times["map"] = _time.time() - t0

        t0 = _time.time()
        L0 = self.laplace_scale_trils(best)
        sched = optax.polynomial_schedule(-1e-6, -svi_lr, 2, max(vi_steps // 5, 1))
        opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
        q_means, q_trils, losses = self.SVI(
            best, opt, n_vi=n_vi, num_steps=vi_steps,
            init_scales=np.asarray(L0), seed=seed + 1,
            progress=_progress("svi"),
        )
        jax.block_until_ready(losses)
        times["svi"] = _time.time() - t0

        t0 = _time.time()
        res = self.HMC(q_means, q_trils, n_hmc=n_hmc,
                       num_burnin_steps=num_burnin_steps,
                       num_results=num_results, seed=seed + 2,
                       progress=_progress("hmc"))
        jax.block_until_ready(res.samples)
        times["hmc"] = _time.time() - t0

        return dict(z_map=z_map, best=best, q_means=q_means, q_trils=q_trils,
                    losses=losses, hmc=res, summaries=self.summarize(res),
                    times=times)
