"""ModellingSequence: the MAP -> SVI -> HMC (/ SMC) pipeline facade.

API parity with the reference ``ModellingSequence``
(``src/gigalens/jax/inference.py:23-311``), with every phase running as a
device-resident jitted program over a sample-sharded mesh. Each phase method
builds its own ``LensSimulator`` with the right batch size, like the reference.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import optax

from gigalens_tpu.inference.hmc import _aot_desc, fit_hmc
from gigalens_tpu.inference.map import best_start, fit_map
from gigalens_tpu.inference.smc import fit_smc
from gigalens_tpu.inference.svi import fit_svi
from gigalens_tpu.parallel import mesh as pmesh
from gigalens_tpu.simulator import LensSimulator


def phase_simulator(cache: dict, sim_config, phys_model, bs: int,
                    exact: bool = False) -> LensSimulator:
    """Memoized phase simulator, shared by ``ModellingSequence`` and
    ``SurveySequence``. ``exact=True`` (HMC/SMC) pins the auto PSF path to
    the f32 FFT convolution. A DFT-by-matmul conv at default precision
    rounds its inputs (bf16 or TF32 matmuls), and likelihood noise of a
    few tenths of a nat is harmless to the stochastic optimizers but
    collapses Metropolis-Hastings step-size adaptation; ``dft_hi``
    (Precision.HIGHEST matmuls) was measured rougher than the FFT along
    leapfrog trajectories as well. Explicit sim_config choices are always
    respected.

    Memo hit requires the SAME config/model objects (identity, plus the
    model's attribute version): rebinding seq.sim_config or seq.phys_model
    (or an attribute on the model) after a phase call must not silently
    reuse a simulator built from the old configuration. The value pins the
    keyed objects so a hit can verify identity (no id-recycling false
    positives)."""
    key = (bs, exact, getattr(phys_model, "_version", 0))
    hit = cache.get(key)
    if hit is not None and hit[0] is sim_config and hit[1] is phys_model:
        return hit[2]
    cfg = sim_config
    if exact:
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            psf_mode="fft" if (cfg.psf_mode is None and cfg.use_fft is None)
            else cfg.psf_mode,
        )
    sim = LensSimulator(phys_model, cfg, bs=bs)
    cache[key] = (sim_config, phys_model, sim)
    return sim


class ModellingSequence:
    def __init__(self, phys_model, prob_model, sim_config, mesh=None):
        self.phys_model = phys_model
        self.prob_model = prob_model
        self.sim_config = sim_config
        self.mesh = mesh if mesh is not None else pmesh.default_mesh()
        # memoized per (bs, exact): a stable simulator object lets repeat
        # phase calls (e.g. multi-seed HMC) reuse compiled programs instead
        # of recompiling (see inference/hmc.py::_hmc_programs)
        self._sims = {}

    def _sim(self, bs: int, exact: bool = False) -> LensSimulator:
        """See :func:`phase_simulator` for the exact/fast PSF-path policy."""
        return phase_simulator(self._sims, self.sim_config, self.phys_model,
                               bs, exact)

    def MAP(
        self,
        optimizer: optax.GradientTransformation,
        start=None,
        n_samples: int = 500,
        num_steps: int = 350,
        seed: int = 0,
        segment_steps: int = 0,
        progress=None,
    ):
        n_samples = pmesh.round_to_multiple(n_samples, self.mesh.size, "n_samples")
        sim = self._sim(n_samples)
        z, _ = fit_map(
            self.prob_model,
            sim,
            optimizer,
            start=start,
            n_samples=n_samples,
            num_steps=num_steps,
            seed=seed,
            mesh=self.mesh,
            segment_steps=segment_steps,
            progress=progress,
        )
        return z

    def best_map_start(self, z):
        """Highest-posterior MAP sample, shaped (1, d) for SVI."""
        sim = self._sim(z.shape[0])
        return best_start(self.prob_model, sim, z)

    def summarize(self, res):
        """Named physical-space posterior summary of an :class:`HMCResult`
        (see :func:`gigalens_tpu.utils.summarize_posterior`)."""
        from gigalens_tpu.utils import summarize_posterior

        return summarize_posterior(
            self.prob_model.prior, res.samples,
            divergences=getattr(res, "divergences", None),
        )

    def laplace_scale_tril(self, z_best, method: str = "fd"):
        """chol of the Laplace covariance at the MAP — the recommended
        ``init_scales`` for SVI (and a robust HMC preconditioner on its own).

        Runs on the default device. The default ``method="fd"`` (central
        differences of the gradient: one first-order batch of ``2d``
        samples) needs only first-order AD and its floored scale_tril agrees
        with the exact reverse-over-reverse AD Hessian (``method="exact"``)
        to ~5% Frobenius; the two were interchangeable as an SVI initializer
        and HMC preconditioner (equal ESS/sec medians).

        The simulator is pinned to the FFT conv, whose ``jnp.fft``
        primitives are differentiable to any order, as ``method="exact"``'s
        reverse-over-reverse Hessian needs."""
        import dataclasses

        import numpy as np

        from gigalens_tpu.inference.map import laplace_scale_tril

        cfg = dataclasses.replace(self.sim_config, psf_mode="fft")
        d = int(np.asarray(z_best).size)
        bs = 2 * d if method == "fd" else 1
        sim = LensSimulator(self.phys_model, cfg, bs=bs)
        L = laplace_scale_tril(
            self.prob_model, sim, jnp.asarray(z_best), method=method
        )
        return np.asarray(L)

    def SVI(
        self,
        start,
        optimizer: optax.GradientTransformation,
        n_vi: int = 250,
        init_scales=1e-3,
        num_steps: int = 500,
        seed: int = 0,
        segment_steps: int = 0,
        full_rank: bool = True,
        progress=None,
    ):
        n_vi = pmesh.round_to_multiple(n_vi, self.mesh.size, "n_vi")
        sim = self._sim(n_vi)
        return fit_svi(
            self.prob_model,
            sim,
            start,
            optimizer,
            n_vi=n_vi,
            init_scales=init_scales,
            num_steps=num_steps,
            seed=seed,
            mesh=self.mesh,
            segment_steps=segment_steps,
            full_rank=full_rank,
            progress=progress,
        )

    def HMC(
        self,
        q_z,
        init_eps: float = 0.3,
        init_l: int = 3,
        n_hmc: int = 50,
        num_burnin_steps: int = 250,
        num_results: int = 750,
        max_leapfrog_steps: int = 30,
        trajectory_adaptation: str = "chees",
        mass_adaptation: bool = True,
        seed: int = 0,
        seeds=None,
        segment_steps: int = 0,
        progress=None,
    ):
        """``seeds`` (sequence) runs all replicas as ONE grouped device
        program (see :func:`gigalens_tpu.inference.hmc.fit_hmc`): G
        independent ``n_hmc``-chain posteriors for ~1x (not Gx) the wall."""
        n_hmc = pmesh.round_to_multiple(n_hmc, self.mesh.size, "n_hmc chains")
        n_total = n_hmc * (len(seeds) if seeds is not None and len(seeds) > 1
                           else 1)
        sim = self._sim(n_total, exact=True)
        return fit_hmc(
            self.prob_model,
            sim,
            q_z,
            init_eps=init_eps,
            init_l=init_l,
            n_hmc=n_hmc,
            num_burnin_steps=num_burnin_steps,
            num_results=num_results,
            max_leapfrog_steps=max_leapfrog_steps,
            trajectory_adaptation=trajectory_adaptation,
            mass_adaptation=mass_adaptation,
            seed=seed,
            seeds=seeds,
            mesh=self.mesh,
            segment_steps=segment_steps,
            progress=progress,
        )

    def SMC(
        self,
        start=None,
        num_particles: int = 1000,
        num_ensembles: int = 1,
        num_leapfrog_steps: int = 10,
        post_sampling_steps: int = 100,
        ess_threshold_ratio: float = 0.8,
        max_sampling_per_stage: int = 8,
        max_stage: int = 100,
        target: str = "pixels",
        auxiliar: str = "positions",
        precondition_moves: bool = True,
        seed: int = 1,
        segment_stages: int = 0,
        progress=None,
    ):
        num_particles = pmesh.round_to_multiple(num_particles, self.mesh.size, "num_particles")
        n = num_particles * num_ensembles
        sim = self._sim(n, exact=True)
        return fit_smc(
            self.prob_model,
            sim,
            start=start,
            num_particles=num_particles,
            num_ensembles=num_ensembles,
            num_leapfrog_steps=num_leapfrog_steps,
            post_sampling_steps=post_sampling_steps,
            ess_threshold_ratio=ess_threshold_ratio,
            max_sampling_per_stage=max_sampling_per_stage,
            max_stage=max_stage,
            target=target,
            auxiliar=auxiliar,
            precondition_moves=precondition_moves,
            seed=seed,
            mesh=self.mesh,
            segment_stages=segment_stages,
            progress=progress,
            aot_desc=_aot_desc(self.prob_model, sim, self.mesh),
        )

    def fit(
        self,
        n_samples: int = 500,
        map_steps: int = 350,
        n_vi: int = 1000,
        vi_steps: int = 300,
        n_hmc: int = 50,
        num_burnin_steps: int = 250,
        num_results: int = 750,
        map_lr: float = 1e-2,
        svi_lr: float = 3e-3,
        laplace_method: str = "fd",
        seed: int = 0,
        checkpoint_dir=None,
        progress=None,
    ):
        """One-call pipeline: MAP -> Laplace init -> SVI -> HMC.

        The sequence every demo/benchmark hand-rolls, with the measured-best
        recipe baked in (measured in an earlier round): multi-start Adam MAP under a
        polynomial-decay schedule, SVI initialized from the finite-difference
        Laplace covariance at the best MAP point (which cut the published
        1500-step budget to ~300 at equal-or-better preconditioner quality),
        and ChEES-adapted preconditioned HMC started from the surrogate.

        ``checkpoint_dir`` makes the run resumable per phase
        (:class:`gigalens_tpu.utils.PipelineCheckpointer`) — a preempted
        job rerun with the same directory skips finished phases.
        ``progress(phase, step, value)`` receives live per-phase feedback.

        Returns a dict with the per-phase artifacts and wall-clock times:
        ``z_map, best, q_z, losses, hmc, summary, times``.
        """
        import time as _time

        import numpy as np

        ckpt = None
        if checkpoint_dir is not None:
            from gigalens_tpu.utils.checkpoint import PipelineCheckpointer

            ckpt = PipelineCheckpointer(checkpoint_dir)

        def _progress(phase):
            if progress is None:
                return None
            return lambda step, value: progress(phase, step, value)

        times = {}

        t0 = _time.time()
        # transition_steps == map_steps exactly: optax 0.2.6's
        # polynomial_schedule with power=0.5 returns NaN for count >
        # transition_steps under jit ((1 - count/T)^0.5 of a negative
        # number; the eager path clips) — never run it past its transition
        sched = optax.polynomial_schedule(-map_lr, -map_lr / 3, 0.5, map_steps)
        opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))

        def _map():
            z = self.MAP(opt, n_samples=n_samples, num_steps=map_steps,
                         seed=seed, progress=_progress("map"))
            return z, None

        z_map, _ = ckpt.run_map(_map) if ckpt else _map()
        jax.block_until_ready(z_map)
        best = self.best_map_start(z_map)
        times["map"] = _time.time() - t0

        t0 = _time.time()
        sched = optax.polynomial_schedule(
            -1e-6, -svi_lr, 2, max(vi_steps // 5, 1)
        )
        opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))

        def _svi():
            L0 = self.laplace_scale_tril(best, method=laplace_method)
            return self.SVI(best, opt, n_vi=n_vi, num_steps=vi_steps,
                            init_scales=np.asarray(L0), seed=seed + 1,
                            progress=_progress("svi"))

        q_z, losses = ckpt.run_svi(_svi) if ckpt else _svi()
        jax.block_until_ready(losses)
        times["svi"] = _time.time() - t0

        t0 = _time.time()

        def _hmc():
            return self.HMC(q_z, n_hmc=n_hmc,
                            num_burnin_steps=num_burnin_steps,
                            num_results=num_results, seed=seed + 2,
                            progress=_progress("hmc"))

        res = ckpt.run_hmc(_hmc) if ckpt else _hmc()
        jax.block_until_ready(res.samples)
        times["hmc"] = _time.time() - t0

        return dict(z_map=z_map, best=best, q_z=q_z, losses=losses, hmc=res,
                    summary=self.summarize(res), times=times)
