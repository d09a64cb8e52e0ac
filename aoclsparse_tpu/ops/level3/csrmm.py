"""Level-3 SpMM: ``mm`` — C = alpha * op(descr(A)) @ B + beta * C.

Reference: aoclsparse_?csrmm (level3/aoclsparse_csrmm.cpp:32-46 wrappers over
aoclsparse_csrmm_t, .hpp 795 LoC) with row-/column-major B and C.

Redesign: descriptor/op resolve through the planner exactly like mv
(DOID general-form copies keep kernels uniform); the registry picks a padded
or segment-sum kernel. The reference's `order` argument selects raw-pointer
layout; jnp arrays carry logical (rows, cols) shape, so `order` here only
selects whether B/C are interpreted transposed (column-major callers pass
B_T/C_T), matching aoclsparse.hpp's C++ overloads semantically.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.descr import MatrixDescriptor
from ...core.matrix import SparseMatrix
from ...core.types import (
    AoclSparseError,
    MatrixType,
    MemoryPolicy,
    Operation,
    Order,
    Status,
)
from ...kernels.registry import KernelEntry, registry
from ...kernels.xla import spmm as K
from ...planner.plan import get_plan

__all__ = ["mm"]

registry.register("mm", KernelEntry(0, "xla_segsum", K.spmm_segsum, "segsum", "any", 0))
registry.register("mm", KernelEntry(1, "xla_ell", K.spmm_ell, "ell", "any", 0))
registry.register("mm", KernelEntry(2, "xla_ellhyb", K.spmm_ellhyb, "ellhyb", "any", 0))
registry.register("mm", KernelEntry(3, "xla_bwdg", K.spmm_bwd, "bwdg", "any", 1))

# diag-form SpMM (mm KID 7): fused static-slice shifts over the dense RHS
# (kernels/xla/spmm.py spmm_diag) for operands pinned to the diag form
registry.register("mm", KernelEntry(7, "diag_shift", K.spmm_diag, "diag", "any", 1))

#: execution forms with an mm kernel row
_MM_FORMS = ("segsum", "ell", "ellhyb", "bwdg", "diag")


@jax.jit
def _epilogue(c_new, alpha, beta, c_old):
    return alpha * c_new + beta * c_old


def _mixed_requested(dtype) -> bool:
    """Precision policy for the band/diag SpMM forms (docs/precision.md)."""
    import os

    return (
        os.environ.get("AOCLSPARSE_TPU_MIXED_PRECISION", "0") in ("1", "true")
        and jnp.dtype(dtype) == jnp.dtype(jnp.float32)
    )


def mm(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    B,
    beta,
    C=None,
    order: Order = Order.row,
    kid: Optional[int] = None,
):
    """C = alpha * op(descr(A)) @ B + beta * C (aoclsparse_?csrmm)."""
    if A is None or descr is None or B is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to mm")
    descr.validate()
    from ...core.validate import check_base_match

    check_base_match(A, descr)
    op = Operation(op)
    order = Order(order)
    B = jnp.asarray(B)
    if order == Order.column:
        B = B.T
    if B.ndim != 2:
        raise AoclSparseError(Status.invalid_size, "B must be 2-D")
    m, n = A.shape
    ma, na = (m, n) if op == Operation.none else (n, m)
    if B.shape[0] != na:
        raise AoclSparseError(Status.invalid_size, f"B rows {B.shape[0]} != op(A) cols {na}")
    k = B.shape[1]
    if C is not None:
        C = jnp.asarray(C)
        if order == Order.column:
            C = C.T
        if C.shape != (ma, k):
            raise AoclSparseError(Status.invalid_size, f"C must be ({ma},{k}), got {C.shape}")
    if MatrixType(descr.type) != MatrixType.general and m != n:
        raise AoclSparseError(Status.invalid_size, f"{descr.type.name} requires square A")

    from ...core.validate import check_dtype_compat

    check_dtype_compat(A.dtype, B.dtype, "B")
    dtype = jnp.result_type(A.dtype, B.dtype)
    # beta == 0: C is NOT read (reference overwrites even NaN/Inf C,
    # csrmv_kr.hpp:54-56 semantics shared by csrmm); NaN/Inf beta falls
    # through to the full epilogue
    beta_is_zero = np.isscalar(beta) and beta == 0
    if A.nnz == 0 or (np.isscalar(alpha) and alpha == 0):
        if beta_is_zero:
            out = jnp.zeros((ma, k), dtype=dtype)
            return out.T if order == Order.column else out
        c_old = jnp.zeros((ma, k), dtype=dtype) if C is None else C.astype(dtype)
        alpha_c = jnp.asarray(alpha, dtype=dtype)
        beta_c = jnp.asarray(beta, dtype=dtype)
        out = _epilogue(jnp.zeros((ma, k), dtype=dtype), alpha_c * 0, beta_c, c_old)
        return out.T if order == Order.column else out

    plan = get_plan(A)
    kind = "segsum" if A.mem_policy == MemoryPolicy.restricted else None
    if kid is not None:
        for e in registry.table("mm"):
            if e.kid == kid:
                kind = e.fmt
                break
        else:
            raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for 'mm'")
    if kind is None:
        # empirical pin from autotune_mm (keyed by RHS width)
        tuned = getattr(plan, "_mm_tuned", None)
        if tuned is not None:
            kind = tuned.get((descr.type, descr.fill_mode, descr.diag_type, op, k))
    form = plan.exec_form_for(descr, op, kind=kind, dtype=A.dtype)
    if form.kind not in _MM_FORMS:
        # the kind=None plan slot can hold an mv-selected/mv-autotuned form
        # (bwd, gen, sell, host) that has no mm kernel row: rebuild with a
        # gather form mm can dispatch instead of failing the registry lookup
        from ...planner.plan import choose_mv_format

        eff = plan.effective_for(descr, op, A.dtype)
        form = plan.exec_form_for(descr, op, kind=choose_mv_format(eff), dtype=A.dtype)
    e = registry.select("mm", fmt=form.kind, kid=kid)
    Bc = B.astype(A.dtype)
    if form.kind == "diag":
        dv = form.dia_val
        if _mixed_requested(Bc.dtype):
            if getattr(form, "_dia_val_bf16", None) is None:
                form._dia_val_bf16 = dv.astype(jnp.bfloat16)
            dv = form._dia_val_bf16
        c_new = e.fn(
            dv, form.dia_offs, Bc, form.m, form.dia_L, form.dia_n_pad,
            offs_static=form.dia_offs_static,
        ).astype(Bc.dtype)
    elif form.kind == "segsum":
        c_new = e.fn(form.ind, form.val, form.row_ids, Bc, form.m)
    elif form.kind == "ell":
        c_new = e.fn(form.ell_ind, form.ell_val, Bc)
    elif form.kind == "bwdg":
        Bp = jnp.pad(
            Bc, ((form.bwd_padL, form.bwd_n_pad - form.bwd_padL - form.n), (0, 0))
        )
        mixed = _mixed_requested(Bc.dtype)
        wv = form.bwd_val
        if mixed:
            if getattr(form, "_bwd_val_bf16", None) is None:
                form._bwd_val_bf16 = wv.astype(jnp.bfloat16)
            wv = form._bwd_val_bf16
        c_new = e.fn(wv, Bp, form.bwd_G, form.bwd_W, form.bwd_base8, form.bwd_n_pad, mixed)[
            : form.m
        ]
    else:
        c_new = e.fn(
            form.ell_ind, form.ell_val, form.sp_ind, form.sp_val, form.sp_rows, Bc, form.m
        )
    # finite zero beta: C is not read at all (nan/inf != 0, so IEEE
    # beta*0 = NaN propagation keeps the full epilogue): alpha*C_new
    # directly — also skips the zeros panel + scalar transfers (cf. mv)
    if beta_is_zero:
        from ..level2.mv import _scale

        if np.isscalar(alpha) and alpha == 1.0:
            out = c_new.astype(dtype)
        else:
            out = _scale(c_new.astype(dtype), jnp.asarray(alpha, dtype=dtype))
        return out.T if order == Order.column else out
    out = _epilogue(
        c_new.astype(dtype),
        jnp.asarray(alpha, dtype=dtype),
        jnp.asarray(beta, dtype=dtype),
        jnp.zeros((ma, k), dtype=dtype) if C is None else C.astype(dtype),
    )
    return out.T if order == Order.column else out
