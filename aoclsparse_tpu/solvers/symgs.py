"""Symmetric Gauss-Seidel smoother (aoclsparse_?symgs / ?symgs_mv).

Reference: symgs_ref (solvers/aoclsparse_symgs.hpp:88-...), built exactly
from two SpMV + two TRSV steps over the L/D/U splitting:

    1. q = alpha*U_s*x0 ; r = b - q ; (L+D) x1 = r
    2. r = L_s*x1 ; q = b - r ; (U+D) x = q
    3. (fused) y = A x

Triangular descriptors quick-exit to a single TRSV (symgs.hpp:130-149).
We compose the same steps from this library's mv/trsv, which already run as
device kernels (padded gathers + blocked scans).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from ..core.descr import MatrixDescriptor
from ..core.matrix import SparseMatrix
from ..core.types import (
    AoclSparseError,
    DiagType,
    FillMode,
    MatrixType,
    Operation,
    Status,
    is_complex_dtype,
)
from ..ops.level2.mv import mv
from ..ops.level2.trsv import trsv

__all__ = ["symgs", "symgs_mv"]


def _tri(fill, diag):
    return MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill, diag_type=diag)


def lu_view_selection(mtype: MatrixType, descr: MatrixDescriptor, trans: Operation):
    """Which stored triangle feeds the L and U views of the GS splitting,
    and with which op (symgs.hpp:150-190). Shared by the single-device and
    distributed sweeps so the two can never diverge."""
    lower, upper = FillMode.lower, FillMode.upper
    if mtype == MatrixType.general:
        if trans == Operation.none:
            return lower, Operation.none, upper, Operation.none
        return upper, Operation.transpose, lower, Operation.transpose
    if mtype == MatrixType.symmetric:
        if FillMode(descr.fill_mode) == FillMode.lower:
            return lower, Operation.none, lower, Operation.transpose
        return upper, Operation.transpose, upper, Operation.none
    # hermitian
    if FillMode(descr.fill_mode) == FillMode.lower:
        return lower, Operation.none, lower, Operation.conjugate_transpose
    return upper, Operation.conjugate_transpose, upper, Operation.none


def symgs(
    trans: Operation,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    alpha,
    b,
    x0=None,
    kid: Optional[int] = None,
):
    """One symmetric GS sweep; returns x (aoclsparse_?symgs)."""
    x, _ = _symgs_core(trans, A, descr, alpha, b, x0, fuse_mv=False, kid=kid)
    return x


def symgs_mv(
    trans: Operation,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    alpha,
    b,
    x0=None,
    kid: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused sweep + y = A x (aoclsparse_?symgs_mv); returns (x, y)."""
    return _symgs_core(trans, A, descr, alpha, b, x0, fuse_mv=True, kid=kid)


def _symgs_core(trans, A, descr, alpha, b, x0, fuse_mv, kid):
    if A is None or descr is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to symgs")
    descr.validate()
    from ..core.validate import check_base_match

    check_base_match(A, descr)
    trans = Operation(trans)
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "symgs requires square A")
    if DiagType(descr.diag_type) == DiagType.unit:
        raise AoclSparseError(Status.not_implemented, "unit diagonal unsupported (parity)")
    b = jnp.asarray(b).astype(A.dtype)
    if b.shape != (m,):
        raise AoclSparseError(Status.invalid_size, f"b must be ({m},)")
    mtype = MatrixType(descr.type)
    cplx = is_complex_dtype(A.dtype)
    alpha = jnp.asarray(alpha, A.dtype)

    # Triangular quick exit: single TRSV (+ optional final SpMV), symgs.hpp:130
    if mtype == MatrixType.triangular:
        x = trsv(1.0, A, descr, trans, b, kid=kid)
        y = mv(1.0, A, descr, trans, x, 0.0) if fuse_mv else None
        return x, y

    if mtype == MatrixType.general and trans == Operation.conjugate_transpose:
        raise AoclSparseError(
            Status.not_implemented, "general + conjugate_transpose unsupported (parity)"
        )

    # pick which stored triangle feeds L and U views (symgs.hpp:150-190)
    l_fm, l_op, u_fm, u_op = lu_view_selection(mtype, descr, trans)

    tri_l = _tri(l_fm, DiagType.non_unit)  # L + D view
    tri_ls = _tri(l_fm, DiagType.zero)  # strict L
    tri_u = _tri(u_fm, DiagType.non_unit)  # U + D view
    tri_us = _tri(u_fm, DiagType.zero)  # strict U

    x0 = jnp.zeros((m,), A.dtype) if x0 is None else jnp.asarray(x0).astype(A.dtype)
    if kid is None:
        # fused path: the whole sweep (2 SpMV + 2 TRSV [+ final SpMV]) is
        # ONE compiled program instead of 4-5 dispatches. The per-step
        # unfused path stays reachable via an explicit kid.
        return _symgs_fused(
            A, descr, trans, tri_l, tri_ls, tri_u, tri_us, l_op, u_op,
            fuse_mv, alpha, b, x0,
        )
    # step 1: q = alpha*U_s*x0 ; r = b - q ; (L+D) x1 = r
    q = mv(alpha, A, tri_us, u_op, x0, 0.0)
    x1 = trsv(1.0, A, tri_l, l_op, b - q, kid=kid)
    # step 2: r = L_s*x1 ; q = b - r ; (U+D) x = q
    r = mv(1.0, A, tri_ls, l_op, x1, 0.0)
    x = trsv(1.0, A, tri_u, u_op, b - r, kid=kid)
    y = None
    if fuse_mv:
        y = mv(1.0, A, descr, trans, x, 0.0)
    return x, y


def _symgs_fused(
    A, descr, trans, tri_l, tri_ls, tri_u, tri_us, l_op, u_op, fuse_mv, alpha, b, x0
):
    """One-dispatch sweep over the planner's cached forms. The sweep is
    traced once and the form arrays it reads are passed to the compiled
    program as ARGUMENTS: closed over, they would be baked in as constants
    (GB-scale for FEM operands, which made the compile take a minute).
    The traced program lives in plan._fused_cache, dropped by
    refresh_values on update_values."""
    import jax

    from ..ops.level2.mv import _run_exec_form
    from ..planner.plan import get_plan
    from ..planner.triangular import trsv_form_for

    plan = get_plan(A)
    if not hasattr(plan, "_fused_cache"):
        plan._fused_cache = {}
    key = ("symgs", descr.type, descr.fill_mode, Operation(trans), bool(fuse_mv))
    fn = plan._fused_cache.get(key)
    if fn is None:
        lf = trsv_form_for(plan, tri_l, l_op)
        uf = trsv_form_for(plan, tri_u, u_op)
        us_form = plan.exec_form_for(tri_us, u_op, dtype=A.dtype)
        ls_form = plan.exec_form_for(tri_ls, l_op, dtype=A.dtype)
        a_form = plan.exec_form_for(descr, Operation(trans), dtype=A.dtype) if fuse_mv else None

        def _solve(form, r):
            from .fused import _pad_solve

            return _pad_solve(form, r)

        def run(alpha, b, x0):
            q = alpha * _run_exec_form(us_form, x0, None)
            x1 = _solve(lf, b - q)
            r = _run_exec_form(ls_form, x1, None)
            x = _solve(uf, b - r)
            y = _run_exec_form(a_form, x, None) if fuse_mv else x
            return x, y

        closed = jax.make_jaxpr(run)(alpha, b, x0)
        consts = [jnp.asarray(c) for c in closed.consts]

        @jax.jit
        def sweep(alpha_, b_, x0_, *cs):
            return jax.core.eval_jaxpr(closed.jaxpr, list(cs), alpha_, b_, x0_)

        fn = (sweep, consts)
        plan._fused_cache[key] = fn
    sweep, consts = fn
    x, y = sweep(alpha, b, x0, *consts)
    return x, (y if fuse_mv else None)
