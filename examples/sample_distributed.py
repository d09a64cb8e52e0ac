"""Additions with no reference counterpart: row-sharded SpMV,
distributed CG over a device mesh, and the fused one-dispatch
preconditioned solver — run here on an 8-device virtual CPU mesh exactly
like tests/ and the driver's multichip dryrun (parallel/, solvers/fused.py)."""

import os

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"

import numpy as np
from _common import check

import jax
import jax.numpy as jnp

import aoclsparse_tpu as asp
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.parallel import dist_cg, dist_spmv_ell, make_mesh, shard_ell
from aoclsparse_tpu.planner.plan import get_plan

print("devices:", len(jax.devices()))

rng = np.random.default_rng(5)
m = 256
rows = np.repeat(np.arange(m), 5)
offs = np.tile(np.array([-8, -1, 0, 1, 8]), m)
cols = np.clip(rows + offs, 0, m - 1)
order = np.lexsort((cols, rows))
rows, cols = rows[order], cols[order]
keep = np.ones(rows.size, bool)
keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
rows, cols = rows[keep], cols[keep]
val = rng.standard_normal(rows.size) + np.where(cols[np.arange(rows.size)] == rows, 8.0, 0.0)
ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))])
dense = np.zeros((m, m))
dense[rows, cols] = val
dense = (dense + dense.T) / 2 + 8 * np.eye(m)  # SPD for CG
mask = dense != 0
ptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
cols = np.nonzero(mask)[1]
val = dense[mask]

A = asp.create_csr(m, m, ptr, cols, val)
plan = get_plan(A)
form = plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="ell")

mesh = make_mesh(8)
ind_s, val_s, m_pad = shard_ell(mesh, form.ell_ind, form.ell_val)
x = rng.standard_normal(m)
y = dist_spmv_ell(mesh, ind_s, val_s, jnp.asarray(x))
check("dist_spmv (row-sharded)", np.asarray(y)[:m], dense @ x, tol=1e-9)

b = dense @ np.ones(m)
sol, iters, res = dist_cg(mesh, ind_s, val_s, jnp.asarray(np.pad(b, (0, m_pad - m))), rtol=1e-10)
print(f"dist_cg: {iters} iterations, residual {res:.2e}")
check("dist_cg", np.asarray(sol)[:m], np.linalg.solve(dense, b), tol=1e-5)

# fused single-dispatch preconditioned CG on the handle API (solvers/fused.py)
xf, it_f, r_f = asp.pcg_solve(A, b, precond="ilu0", rtol=1e-10)
print(f"pcg_solve(ilu0): {it_f} iterations, residual {r_f:.2e}")
check("pcg fused", np.asarray(xf), np.linalg.solve(dense, b), tol=1e-5)

# distributed preconditioner sweeps (§5.8(iii)): SymGS + ILU0 apply composed
# from the row-sharded SpMVs and the pipelined solves
from aoclsparse_tpu.parallel import dist_ilu_apply, dist_symgs

x_gs = dist_symgs(mesh, A, MatrixDescriptor(), 1.0, b)
check("dist_symgs vs local sweep", x_gs,
      asp.symgs(Operation.none, A, MatrixDescriptor(), 1.0, b), tol=1e-9)
x_ilu = dist_ilu_apply(mesh, A, b)
check("dist_ilu_apply vs local smoother", x_ilu,
      asp.ilu_smoother(A, MatrixDescriptor(), b), tol=1e-8)
