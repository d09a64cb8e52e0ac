"""Multi-process (multi-controller) execution.

The reference's only parallelism is single-node OpenMP (SURVEY.md §2.9:
"no MPI/NCCL/Gloo/UCX anywhere; multi-instance use is shown only as
independent processes", tests/examples/sample_spmv_multi_instance.c). This
library upgrades that to a real multi-host backend per
SURVEY.md §5.8: N controller processes, each owning a slice of the device
mesh, running the SAME dist ops (parallel/spmv.py, parallel/cg.py) over a
GLOBAL mesh — collectives ride NCCL between GPUs, or gloo TCP between CPU
processes in tests.

Usage (every process runs the same program):

    from aoclsparse_tpu.parallel import multiproc as mp
    mp.init_multiprocess("host0:9999", num_processes=4, process_id=rank)
    mesh = mp.global_mesh()                       # spans all processes
    y = dist_spmv_bwd_halo(mesh, form, mp.put(x, mesh, P("x")))
    y_host = mp.fetch(y)                          # numpy on every process

Every run passes the coordinator address, process count and process id
explicitly; on CPU (tests, development) the collectives are routed through
gloo.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .placement import fetch, mesh_is_multiprocess, put

__all__ = [
    "init_multiprocess",
    "global_mesh",
    "put",
    "fetch",
    "mesh_is_multiprocess",
    "process_count",
    "process_index",
]


def init_multiprocess(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
) -> None:
    """Join this process to a multi-controller JAX run.

    CPU runs: forces the gloo TCP collectives backend (the CPU transport
    for cross-process psum/all_gather/ppermute) and, when
    `local_device_count` is given, that many local CPU devices — so an
    N-process × D-device global mesh can be exercised without GPUs.
    GPUs: plain `jax.distributed.initialize` with the given coordinator;
    collectives ride NCCL.
    Must be called before any other JAX API touches the backend."""
    platform = None
    try:
        platform = jax.config.jax_platforms
    except AttributeError:  # very old jax — leave as None
        pass
    if platform is None or "cpu" in str(platform):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # single-platform builds without gloo: initialize may still work
        if local_device_count is not None:
            jax.config.update("jax_num_cpu_devices", int(local_device_count))
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "x", n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over ALL devices in the run (every process's), in device-id
    order, so shard d of a row partition lives on global device d."""
    devs = sorted(jax.devices(), key=lambda d: d.id)
    n = n_devices if n_devices is not None else len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()
