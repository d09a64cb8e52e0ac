"""Host latency engines: tiny operands where a device dispatch is pure
overhead.

Every device round-trip pays a dispatch and a fetch; on a 48-row stencil
that is far more than the arithmetic. The library therefore carries whole-call HOST engines — mv KID 11, trsv KID 2,
trsm KID 2 (native C++; the reference's scalar kernels play this role on
small inputs, level2/aoclsparse_csrmv_kr.hpp:450) — selected explicitly by
KID or pinned by an autotune measurement. They are never the default and
never run under jit; a pinned plan silently falls back to the device form
inside traced programs.
"""

import numpy as np

from _common import check

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, MatrixType, Operation

rng = np.random.default_rng(0)
m = 48
L = np.tril(rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.2), -1) + np.diag(
    3.0 + rng.random(m)
)
mask = L != 0
ptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
A = ast.create_csr(m, m, ptr, np.nonzero(mask)[1], L[mask])
tri = MatrixDescriptor(type=MatrixType.triangular)
gen = MatrixDescriptor()
b = rng.standard_normal(m)
B = rng.standard_normal((m, 4))

# explicit KIDs: the whole call runs in numpy / native C++ (np.ndarray out)
y = ast.mv(1.0, A, gen, Operation.none, b, 0.0, kid=11)
check("host mv (KID 11)", y, L @ b)
x = ast.trsv(1.0, A, tri, Operation.none, b, kid=2)
check("host trsv (KID 2)", x, np.linalg.solve(L, b))
X = ast.trsm(1.0, A, tri, Operation.none, B, kid=2)
check("host trsm (KID 2)", X, np.linalg.solve(L, B))
print("host results stay host-resident:", type(y).__name__, type(x).__name__)

# autotune: measure the engines and pin the winner on the plan — subsequent
# plain trsv calls route to whatever won (host, level, or a blocked size)
res = ast.autotune_trsv(A, tri, iters=5, chunks=1)
print("autotune_trsv candidates (us):", {k: round(v * 1e6, 1) for k, v in res.items()})
x2 = ast.trsv(1.0, A, tri, Operation.none, b)
check("trsv after autotune pin", x2, np.linalg.solve(L, b))

# pins never hijack traced programs: the jitted call uses the device form
import jax

x3 = jax.jit(lambda bb: ast.trsv(1.0, A, tri, Operation.none, bb))(b)
check("jitted trsv (device fallback)", np.asarray(x3), np.linalg.solve(L, b), tol=1e-8)
