"""SOR preconditioner (aoclsparse_?sorv, solvers/aoclsparse_sorv.{cpp,hpp}).

One forward sweep of successive over-relaxation:

    (D + omega*L) x1 = omega*b - (omega*U + (omega-1)*D) x0,
    x0 = alpha*x  (or 0 when alpha == 0)

Reference supports forward sweep on general matrices and needs a full
nonzero diagonal (aoclsparse_csr_check_full_diag, sorv.hpp:36-79);
backward/symmetric return not_implemented (mirrored here). The reference
declares csorv/zsorv wrappers (aoclsparse_sorv.cpp:54-81) but its template
stubs complex with not_implemented (aoclsparse_sorv.hpp:130-133); here the
complex sweep is implemented (a strict superset of the reference surface,
complex omega/alpha included).

Device form: the (D + omega*L) solve is a blocked triangular solve over a
value-scaled copy of the lower triangle (off-diagonal entries scaled by
omega — a jitted elementwise pass over the cached triangle values).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.descr import MatrixDescriptor
from ..core.matrix import SparseMatrix
from ..core.types import (
    AoclSparseError,
    DiagType,
    FillMode,
    MatrixType,
    Operation,
    SorType,
    Status,
    is_complex_dtype,
)
from ..ops.level2.mv import mv
from ..planner.plan import build_effective_csr, get_plan
from ..planner.triangular import adaptive_nb, build_trsv_form

__all__ = ["sorv"]


def sorv(
    sor_type: SorType,
    descr: MatrixDescriptor,
    A: SparseMatrix,
    omega,
    alpha,
    x,
    b,
):
    """One SOR iteration; returns the updated x (aoclsparse_?sorv)."""
    if A is None or descr is None or x is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to sorv")
    if SorType(sor_type) != SorType.forward:
        raise AoclSparseError(Status.not_implemented, "only forward SOR (parity)")
    if MatrixType(descr.type) != MatrixType.general:
        raise AoclSparseError(Status.not_implemented, "only general matrices (parity)")
    from ..core.validate import check_base_match

    check_base_match(A, descr)
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "sorv requires square A")
    b = jnp.asarray(b).astype(A.dtype)
    x = jnp.asarray(x).astype(A.dtype)
    if b.shape != (m,) or x.shape != (m,):
        raise AoclSparseError(Status.invalid_size, "x/b size mismatch")

    plan = get_plan(A)
    if not plan.clean.fulldiag:
        raise AoclSparseError(Status.invalid_value, "sorv requires a full nonzero diagonal")
    # complex omega/alpha are first-class like the reference's csorv/zsorv
    # wrappers (aoclsparse_sorv.cpp:54-81)
    omega = complex(omega) if is_complex_dtype(A.dtype) else float(omega)
    dtype = A.dtype
    x0 = jnp.zeros((m,), dtype) if (np.isscalar(alpha) and alpha == 0) else (
        jnp.asarray(alpha, dtype) * x
    )

    # cached scaled lower form: diag + omega*strict-lower
    key = ("sorv", omega)
    if plan.levels is None:
        plan.levels = {}
    form = plan.levels.get(key)
    tri_l = MatrixDescriptor(type=MatrixType.triangular, fill_mode=FillMode.lower)
    if form is None:
        eff = build_effective_csr(plan.clean, tri_l, Operation.none)
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
        is_diag = eff.ind.astype(np.int64) == rows
        eff.val = jnp.where(
            jnp.asarray(is_diag), eff.val, jnp.asarray(omega, dtype) * eff.val
        )
        form = build_trsv_form(
            plan.clean, tri_l, Operation.none, ("sorv", omega), eff, adaptive_nb(m, dtype=dtype)
        )
        plan.levels[key] = form

    # diagonal values
    dkey = ("sorv", "diag")
    diag = plan.levels.get(dkey)
    if diag is None:
        idx = plan.clean.idiag
        diag = plan.clean.val[jnp.asarray(idx)]
        plan.levels[dkey] = diag

    tri_us = MatrixDescriptor(
        type=MatrixType.triangular,
        fill_mode=FillMode.upper,
        diag_type=DiagType.zero,
        base=A.base,  # internal mv call must carry the handle's base
    )
    u_x0 = mv(1.0, A, tri_us, Operation.none, x0, 0.0)
    rhs = omega * b - (omega * u_x0 + (omega - 1.0) * diag * x0)

    m_pad = form.nblk * form.nb
    r = rhs[:, None]
    if m_pad != m:
        r = jnp.pad(r, ((0, m_pad - m), (0, 0)))
    return form.solve(r)[:m, 0]
