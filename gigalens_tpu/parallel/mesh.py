"""Device mesh and sharding helpers.

The reference parallelizes with ``jax.pmap`` plus per-step host ``split`` /
``concatenate`` (``src/gigalens/jax/inference.py:62-68,109,123-128``). The
replacement here is a single :class:`jax.sharding.Mesh` with a
``samples`` axis: inputs carry a :class:`NamedSharding` and every jitted step
is partitioned by XLA's SPMD pass, so cross-device communication (the SVI
gradient all-reduce) compiles to device collectives (NCCL on GPUs) with no
host round-trips.

The workload is embarrassingly parallel over candidate samples/chains, so a
1-D mesh is the right default; the helpers accept any mesh whose first axis is
the sample axis.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SAMPLE_AXIS = "samples"


def default_mesh(devices: Optional[Sequence] = None, axis_name: str = SAMPLE_AXIS) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_samples(arr, mesh: Mesh, axis_name: str = SAMPLE_AXIS):
    """Places ``arr`` with its leading axis sharded over the mesh."""
    spec = P(axis_name, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(arr, mesh: Mesh):
    return jax.device_put(arr, NamedSharding(mesh, P()))


def sample_spec(mesh: Mesh, ndim: int, axis_name: str = SAMPLE_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def constrain_samples(x, mesh: Optional[Mesh], axis_name: str = SAMPLE_AXIS):
    """``with_sharding_constraint`` on the leading axis (no-op for 1 device)."""
    if mesh is None or mesh.size == 1:
        return x
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def round_to_multiple(n: int, m: int, what: str = "samples") -> int:
    """Largest multiple of ``m`` <= n (at least ``m``), reference rounding.

    Warns when the count actually changes — result shapes (e.g. SMC particle
    arrays) differ from what the caller asked for, which should not pass
    silently."""
    rounded = max((n // m) * m, m)
    if rounded != n:
        import warnings

        warnings.warn(
            f"rounding {what} {n} -> {rounded} (multiple of the {m}-device "
            "mesh); result shapes follow the rounded count",
            stacklevel=2,
        )
    return rounded
