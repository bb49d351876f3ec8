"""gigalens_tpu — Bayesian strong-lensing inference in JAX.

A ground-up JAX/XLA rebuild of the capabilities of furcelay/gigalens
(cluster-lens branch): differentiable batched lens simulation, a probabilistic
model over images and multiple-image positions, and a MAP -> SVI -> HMC / SMC
inference pipeline — designed for one accelerator substrate (device-resident
optimization loops, mesh sharding over the sample batch, FFT PSF convolution).
"""

__version__ = "0.1.0"

from gigalens_tpu.config import SimulatorConfig
from gigalens_tpu.model import PhysicalModel

__all__ = ["SimulatorConfig", "PhysicalModel", "__version__"]
