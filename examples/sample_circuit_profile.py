"""Circuit-simulation profile walkthrough: the engines that exist for
IRREGULAR (non-banded) sparsity — the scircuit/rajat class of the
reference's own benchmark suite (tests/benchmarks/matrices/matrixlist).

1. SpMV picks the planner's general composite automatically (hub slabs +
   RCM band + bounded spill; docs/formats.md).
2. TRSV: the dependency DAG of a circuit triangle is SHALLOW, so the
   level-scheduled wavefront engine (KID 1) beats the blocked scan —
   autotune_trsv measures both and pins the winner.
3. SpGEMM: three numeric engines (band / device expansion / threaded host
   Gustavson) — autotune_spgemm times them and pins per plan.
"""

from _common import check, np

import aoclsparse_tpu as asp
from aoclsparse_tpu import MatrixDescriptor, Operation, Request
from aoclsparse_tpu.core.types import DiagType, FillMode, MatrixType
from aoclsparse_tpu.kernels.autotune import autotune_spgemm, autotune_trsv

rng = np.random.default_rng(5)
m = 160

# power-law-ish circuit structure: a few hub columns + random local couplings
dense = np.zeros((m, m))
hubs = rng.choice(m, 3, replace=False)
dense[:, hubs] = rng.standard_normal((m, 3)) * (rng.random((m, 3)) < 0.7)
mask = rng.random((m, m)) < 0.03
dense[mask] = rng.standard_normal(mask.sum())
np.fill_diagonal(dense, 5.0 + rng.random(m))
ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
ind = np.nonzero(dense)[1].astype(np.int32)
A = asp.create_csr(m, m, ptr, ind, dense[dense != 0])

# 1) SpMV through the planner (a gather form by default)
x = rng.standard_normal(m)
y = asp.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0)
check("circuit SpMV", y, dense @ x, tol=1e-9)

# 2) TRSV engine choice: measure blocked vs wavefront, then solve
tri = MatrixDescriptor(
    type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.non_unit
)
timings = autotune_trsv(A, tri, Operation.none, iters=3, chunks=2)
print("TRSV engine timings (s):", {k: f"{v:.2e}" for k, v in timings.items()})
b = rng.standard_normal(m)
xs = asp.trsv(1.0, A, tri, Operation.none, b)  # dispatch follows the pin
check("circuit TRSV", np.tril(dense) @ np.asarray(xs), b, tol=1e-8)

# 3) SpGEMM engine choice + staged finalize (reference request protocol)
C, engines = autotune_spgemm(A, A)
print("SpGEMM engine timings (s):", {k: f"{v:.2e}" for k, v in engines.items()})
C = asp.sp2m(
    Operation.none,
    MatrixDescriptor(),
    A,
    Operation.none,
    MatrixDescriptor(),
    A,
    request=Request.finalize,
    C=C,
)
_, _, _, cp, ci, cv = asp.export_csr(C)
got = np.zeros((m, m))
for i in range(m):
    got[i, ci[cp[i] : cp[i + 1]]] = cv[cp[i] : cp[i + 1]]
check("circuit SpGEMM (pinned engine)", got, dense @ dense, tol=1e-8)

# 4) SpMM on the same operand (mm picks a gather form)
K = 128
B = rng.standard_normal((m, K)).astype(np.float32)
Cmm = asp.mm(1.0, A, MatrixDescriptor(), Operation.none, B, 0.0)
check("circuit SpMM", np.asarray(Cmm), dense @ B, tol=1e-2)

# 5) Fused CG: the whole preconditioned solve is one compiled program
from aoclsparse_tpu.solvers.fused import pcg_solve

spd = dense @ dense.T + m * np.eye(m)
Aspd = asp.create_csr(
    m, m,
    np.concatenate([[0], np.cumsum((spd != 0).sum(1))]),
    np.nonzero(spd)[1],
    spd[spd != 0],
)
bs = rng.standard_normal(m)
xs2, iters, rnorm = pcg_solve(Aspd, bs, rtol=1e-8, maxit=400)
check("circuit fused CG", spd @ np.asarray(xs2), bs, tol=1e-5)
print(f"fused CG: {iters} iterations, final residual {rnorm:.2e}")
