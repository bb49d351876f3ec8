"""Phase checkpointing for the inference pipeline.

The reference keeps all phase hand-offs in memory (MAP matrix -> SVI -> HMC,
SURVEY §5.4); a long job can be preempted, so each phase result can be
persisted and the pipeline resumed. Plain ``.npz`` files — the payloads are a
few small arrays, orbax would be overkill (and its async machinery is for
sharded model states, not (n, d) matrices).
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from gigalens_tpu.prob.distributions import MultivariateNormalTriL


def save_map(path: str, z, chi2_history=None):
    np.savez(path, z=np.asarray(z),
             chi2_history=np.asarray(chi2_history) if chi2_history is not None else np.zeros(0))


def load_map(path: str):
    d = np.load(path)
    return jnp.asarray(d["z"]), jnp.asarray(d["chi2_history"])


def save_svi(path: str, q_z: MultivariateNormalTriL, losses=None):
    np.savez(path, loc=np.asarray(q_z.loc), scale_tril=np.asarray(q_z.scale_tril),
             losses=np.asarray(losses) if losses is not None else np.zeros(0))


def load_svi(path: str):
    d = np.load(path)
    return (
        MultivariateNormalTriL(jnp.asarray(d["loc"]), jnp.asarray(d["scale_tril"])),
        jnp.asarray(d["losses"]),
    )


def save_hmc(path: str, result):
    np.savez(path, samples=np.asarray(result.samples),
             accept_rate=np.asarray(result.accept_rate),
             step_size=np.asarray(result.step_size),
             final_state=np.asarray(result.final_state),
             trajectory_length=np.asarray(result.trajectory_length),
             divergences=np.asarray(result.divergences))


def load_hmc(path: str):
    from gigalens_tpu.inference.hmc import HMCResult

    d = np.load(path)
    traj = d["trajectory_length"] if "trajectory_length" in d else np.zeros(())
    # pre-divergence-field checkpoints: per-chain zeros, NOT the 0-d default
    # (consumers reshape per scene / sum per chain)
    div = (d["divergences"] if "divergences" in d
           else np.zeros((d["samples"].shape[1],), np.int32))
    return HMCResult(
        jnp.asarray(d["samples"]), jnp.asarray(d["accept_rate"]),
        jnp.asarray(d["step_size"]), jnp.asarray(d["final_state"]),
        jnp.asarray(traj), jnp.asarray(div),
    )


def save_smc(path: str, result):
    np.savez(path, particles=np.asarray(result.particles),
             num_stages=np.asarray(result.num_stages),
             log_scalings=np.asarray(result.log_scalings),
             post_samples=np.asarray(result.post_samples),
             final_beta=np.asarray(result.final_beta),
             log_evidence=np.asarray(result.log_evidence))


def load_smc(path: str):
    from gigalens_tpu.inference.smc import SMCResult

    d = np.load(path)
    lz = d["log_evidence"] if "log_evidence" in d else np.zeros(())
    return SMCResult(
        jnp.asarray(d["particles"]), jnp.asarray(d["num_stages"]),
        jnp.asarray(d["log_scalings"]), jnp.asarray(d["post_samples"]),
        jnp.asarray(d["final_beta"]), jnp.asarray(lz),
    )


class PipelineCheckpointer:
    """Resumable MAP -> SVI -> HMC (/ SMC) runner: skips phases with saved
    results."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _p(self, name):
        return os.path.join(self.dir, f"{name}.npz")

    def has(self, name: str) -> bool:
        return os.path.exists(self._p(name))

    def run_map(self, fn):
        if self.has("map"):
            return load_map(self._p("map"))
        z, hist = fn()
        save_map(self._p("map"), z, hist)
        return z, hist

    def run_svi(self, fn):
        if self.has("svi"):
            return load_svi(self._p("svi"))
        q_z, losses = fn()
        save_svi(self._p("svi"), q_z, losses)
        return q_z, losses

    def run_hmc(self, fn):
        if self.has("hmc"):
            return load_hmc(self._p("hmc"))
        res = fn()
        save_hmc(self._p("hmc"), res)
        return res

    def run_smc(self, fn):
        if self.has("smc"):
            return load_smc(self._p("smc"))
        res = fn()
        save_smc(self._p("smc"), res)
        return res
