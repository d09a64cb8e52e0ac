"""Array placement helpers that work in BOTH single-process and
multi-process (multi-controller) runs.

The reference is single-node shared-memory (SURVEY.md §2.9: OpenMP only,
"no MPI/NCCL/Gloo/UCX anywhere"), so it never needed this layer; this
library does: a mesh may span processes (GPU hosts over NCCL, or the CPU
gloo backend used by the multi-process tests), and
`jax.device_put` cannot place host data onto devices another process owns.
`put()` hides the difference:

- single-process mesh  -> plain `jax.device_put` (fast path, unchanged)
- mesh spanning processes -> `jax.make_array_from_callback`, where every
  process contributes the shards it can address. Callers pass the SAME
  host value on every process (the framework's host-planner model already
  replicates matrix structure on every controller).

`fetch()` is the inverse: numpy value on every process, all-gathering
across processes only when the array is not fully addressable locally.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["put", "fetch", "mesh_is_multiprocess"]


def mesh_is_multiprocess(mesh: Mesh) -> bool:
    """True when `mesh` contains devices owned by another process."""
    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def put(arr, mesh: Mesh, spec: P):
    """Place `arr` on `mesh` with PartitionSpec `spec` (NamedSharding).

    Accepts host numpy data or an existing jax.Array. If `arr` already has
    exactly the requested sharding it is returned as-is (no copy)."""
    sh = NamedSharding(mesh, spec)
    if isinstance(arr, jax.Array):
        if arr.sharding == sh:
            return arr
        if not arr.is_fully_addressable:
            # already global (e.g. output of a previous dist op): let jax
            # reshard device-to-device
            return jax.device_put(arr, sh)
    if not mesh_is_multiprocess(mesh):
        return jax.device_put(arr, sh)
    host = np.asarray(arr)
    return jax.make_array_from_callback(host.shape, sh, lambda idx: host[idx])


def fetch(arr) -> np.ndarray:
    """Full numpy value of `arr` on every process (cross-process all-gather
    only when some shards are remote)."""
    if not isinstance(arr, jax.Array) or arr.is_fully_addressable:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
