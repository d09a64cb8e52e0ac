"""Multi-process (multi-controller) execution — the counterpart of the
reference's sample_spmv_multi_instance.c, upgraded from "independent
processes" to a REAL distributed run (SURVEY.md §2.9: the reference has no
distributed backend; this framework adds one over jax.distributed).

Run standalone, this demonstrates the placement-transparent API on the
single-process mesh — the SAME code spans processes unchanged. To see it
cross real process boundaries, either run tests/test_multiprocess.py (a
2-process gloo run) or launch N copies yourself:

    # shell 1                                   # shell 2
    python sample_multiprocess.py 0 2 &         python sample_multiprocess.py 1 2

On a GPU cluster, pass the coordinator address, process count and
process id the same way; collectives then ride NCCL.
"""

import sys

from _common import check, np  # forces CPU in-process

import jax
from jax.sharding import PartitionSpec as P

import aoclsparse_tpu as asp
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.parallel import (
    dist_cg_pipelined,
    dist_spmv_ell,
    fetch,
    global_mesh,
    mesh_is_multiprocess,
    put,
    shard_ell,
)
from aoclsparse_tpu.planner.plan import get_plan

if len(sys.argv) == 3 and all(a.isdigit() for a in sys.argv[1:]):
    # joined as one rank of an N-process run
    from aoclsparse_tpu.parallel import init_multiprocess

    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    init_multiprocess(
        coordinator_address="localhost:47901",
        num_processes=nproc,
        process_id=pid,
        local_device_count=4,
    )
    print(f"rank {pid}: {len(jax.local_devices())} local / {len(jax.devices())} global devices")

# every controller builds the same problem (host structure is replicated)
rng = np.random.default_rng(11)
m = 256
dense = np.zeros((m, m))
for d in range(-2, 3):
    v = rng.standard_normal(m - abs(d))
    dense += np.diag(v, d)
dense = (dense + dense.T) / 2 + np.eye(m) * 6
ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
ind = np.nonzero(dense)[1].astype(np.int32)
A = asp.create_csr(m, m, ptr, ind, dense[dense != 0])

mesh = global_mesh()  # spans every process's devices
print(f"mesh: {mesh.shape} multiprocess={mesh_is_multiprocess(mesh)}")

# row-sharded SpMV: put() places host data across ALL controllers' devices
plan = get_plan(A)
form = plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="ell")
ind_s, val_s, m_pad = shard_ell(mesh, form.ell_ind, form.ell_val)
x = rng.standard_normal(m)
y = dist_spmv_ell(mesh, ind_s, val_s, x)
check("multi-controller SpMV", fetch(y)[:m], dense @ x, tol=1e-9)

# pipelined Jacobi-PCG: ppermute halos + ONE fused psum per iteration,
# crossing process boundaries when the mesh does
bwd = plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
b = dense @ np.ones(m)
xs, iters, rnorm = dist_cg_pipelined(
    mesh, bwd, b, rtol=1e-12, maxit=300, dinv=1.0 / np.diag(dense)
)
check("multi-controller pipelined PCG", fetch(xs), np.ones(m), tol=1e-7)
print(f"  PCG iterations: {iters}, ||r|| = {rnorm:.3e}")

# put/fetch round-trip with an explicit replicated spec
yr = put(np.asarray(fetch(y)), mesh, P())
check("put/fetch round-trip", fetch(yr)[:m], dense @ x, tol=1e-9)
