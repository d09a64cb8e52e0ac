"""Level-3 multi-RHS triangular solve: ``trsm`` (aoclsparse_?trsm/_kid,
level3/aoclsparse_trsm.{cpp,hpp}; the reference parallelizes TRSV column-wise
across RHS with OpenMP, trsm.hpp:149).

Redesign: the blocked lax.scan solve (kernels/xla/trsv.py) is natively
multi-RHS — the (nb, k) block solves batch over RHS columns — so
trsm is the same kernel as trsv with a matrix right-hand side.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ...core.descr import MatrixDescriptor
from ...core.matrix import SparseMatrix
from ...core.types import AoclSparseError, Operation, Order, Status
from ..level2.trsv import _solve

__all__ = ["trsm"]


def trsm(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    B,
    order: Order = Order.row,
    kid: Optional[int] = None,
):
    """X = op(tri(A))^{-1} (alpha * B), B dense (m, k) (aoclsparse_?trsm).

    KID 2 = sequential host engine (native C++, RHS columns threaded like
    the reference's OpenMP split): whole-call numpy for latency-bound small
    solves; never default, never traced — same policy as trsv KID 2."""
    if A is None or descr is None or B is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    from ..level2.trsv import _host_route

    hform = _host_route(A, descr, op, B, kid, alpha, allow_pin=False)
    if hform is not None:
        from ...core.validate import check_dtype_compat

        Bh = np.asarray(B)
        if Order(order) == Order.column:
            Bh = Bh.T
        if Bh.ndim != 2 or Bh.shape[0] != A.shape[0]:
            raise AoclSparseError(
                Status.invalid_size, f"B must be ({A.shape[0]}, k), got {Bh.shape}"
            )
        check_dtype_compat(A.dtype, Bh.dtype, "B")
        dtype = np.result_type(np.dtype(A.dtype), Bh.dtype)
        adt = np.dtype(A.dtype)
        if np.isscalar(alpha) and alpha == 1.0:
            rhs = Bh.astype(adt, copy=False)
        else:
            rhs = (np.asarray(alpha, dtype) * Bh).astype(adt, copy=False)
        X = hform.solve_mat(rhs).astype(dtype, copy=False)
        return X.T if Order(order) == Order.column else X
    B = jnp.asarray(B)
    order = Order(order)
    if order == Order.column:
        B = B.T
    if B.ndim != 2 or B.shape[0] != A.shape[0]:
        raise AoclSparseError(
            Status.invalid_size, f"B must be ({A.shape[0]}, k), got {B.shape}"
        )
    from ...core.validate import check_dtype_compat

    check_dtype_compat(A.dtype, B.dtype, "B")
    dtype = jnp.result_type(A.dtype, B.dtype)
    if np.isscalar(alpha) and alpha == 1.0:
        rhs = B.astype(A.dtype)  # skip the scalar transfer + scale dispatch
    else:
        rhs = (jnp.asarray(alpha, dtype) * B).astype(A.dtype)
    X = _solve(A, descr, op, rhs, kid).astype(dtype)
    return X.T if order == Order.column else X
