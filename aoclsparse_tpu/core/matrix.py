"""SparseMatrix handle: creation, export, copy, value updates, hints.

Analog of `_aoclsparse_matrix` (aoclsparse_mat_structures.hpp:747-783)
and the creation/auxiliary API (library/src/create/aoclsparse_create.cpp:35,
src/extra/aoclsparse_auxiliary.cpp:366-1014). Differences by design:

- The user-facing *data* is an immutable pytree (core/formats.py); the handle
  is a thin mutable Python object that owns the hint list and the cached Plan
  (the analog of the reference's `mats` vector of optimized copies + optim_data).
- Index-base conversion to zero-base happens at creation; `export_*` restores
  the requested base, like the reference's zero-basing clean-CSR builder.
- `destroy` is garbage collection; provided as a no-op for API parity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .descr import GENERAL, MatrixDescriptor
from .formats import BSR, COO, CSC, CSR, DIA, ELL, TCSR
from .types import (
    AoclSparseError,
    FormatType,
    IndexBase,
    MatrixSort,
    MemoryPolicy,
    Operation,
    Status,
    check_value_dtype,
)
from .validate import check_csr_arrays, check_sizes, require

__all__ = [
    "SparseMatrix",
    "create_csr",
    "create_csc",
    "create_coo",
    "create_bsr",
    "create_ell",
    "create_dia",
    "create_tcsr",
    "export_csr",
    "export_csc",
    "export_coo",
    "copy",
    "order_mat",
    "set_value",
    "update_values",
    "destroy",
]


@dataclasses.dataclass
class Hint:
    """One registered optimization hint (analog of aoclsparse_optimize_data,
    aoclsparse_mat_structures.hpp:54-81)."""

    action: str  # "mv" | "sv" | "mm" | "2m" | "dotmv" | "sm" | "symgs" | "sorv" | "lu_smoother" | "memory"
    trans: Operation = Operation.none
    descr: MatrixDescriptor = GENERAL
    kid: Optional[int] = None
    nop: int = 1
    done: bool = False


class SparseMatrix:
    """Mutable handle around an immutable format pytree.

    Values may be LAZY: a SpGEMM product computed on the band engine keeps
    its CSR values as a pending extraction thunk (`_lazy`), because chained
    mv/sp2m consumption runs straight on the seeded device band and never
    needs the extraction gather. Any access to
    ``.data`` materializes the values first, so every existing consumer
    stays correct; shape/nnz/dtype answer from the lazy structure without
    paying the gather."""

    def __init__(self, data, input_format: FormatType, base: IndexBase = IndexBase.zero):
        self._lazy = None  # (ptr, ind, shape, dtype, thunk) | None
        self.data = data  # format pytree, zero-based
        self.input_format = FormatType(input_format)
        self.base = IndexBase(base)
        self.hints: List[Hint] = []
        self.mem_policy = MemoryPolicy.unrestricted
        self.sort = MatrixSort.unknown
        self.fulldiag: Optional[bool] = None
        self.plan = None  # planner.Plan once optimize() ran
        self.ilu_state = None  # solvers.ilu0 factorization cache
        #: precision policy opt-in ("full" | "mixed"); see docs/precision.md
        #: and set_precision_mode (ops consult it via _mixed_enabled)
        self.precision_mode = "full"

    # -- lazy-values protocol -----------------------------------------------------
    @property
    def data(self):
        if self._lazy is not None:
            from .formats import CSR

            ptr, ind, shape, _dtype, thunk = self._lazy
            self._lazy = None
            self._data = CSR(ptr, ind, thunk(), shape=shape)
            # the seeded band form was created together with the thunk; seat
            # its staleness key now that a concrete value array exists
            if getattr(self, "_seed_bwdg", None) is not None and (
                getattr(self, "_seed_bwdg_val", None) is None
            ):
                self._seed_bwdg_val = self._data.val
        return self._data

    @data.setter
    def data(self, v) -> None:
        self._lazy = None
        self._data = v

    def set_lazy_values(self, ptr, ind, shape, dtype, thunk) -> None:
        """Install a pending value extraction: structure is final, values
        materialize on first ``.data`` access (kernels/xla/spgemm_band.py)."""
        self._data = None
        self._lazy = (ptr, ind, shape, dtype, thunk)

    @property
    def values_pending(self) -> bool:
        return self._lazy is not None

    # -- convenience passthroughs -------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        if self._lazy is not None:
            return self._lazy[2]
        return self._data.shape

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        if self._lazy is not None:
            return int(np.asarray(self._lazy[0])[-1])
        from .formats import nnz_of

        return nnz_of(self._data)

    @property
    def dtype(self):
        if self._lazy is not None:
            return self._lazy[3]
        return self._data.dtype

    def add_hint(self, hint: Hint) -> None:
        self.hints.insert(0, hint)  # reference prepends (csr_util.cpp:47)

    def invalidate(self) -> None:
        """Drop cached plan/factorizations after a structural change."""
        self.plan = None
        self.ilu_state = None

    def __repr__(self):
        return (
            f"SparseMatrix({self.input_format.name}, shape={self.shape}, "
            f"nnz={self.nnz}, dtype={self.dtype}, plan={'yes' if self.plan else 'no'})"
        )


# ---------------------------------------------------------------------------
# creation (aoclsparse_create_(s/d/c/z)csr etc. — dtype suffixes become the
# dtype of the arrays themselves)
# ---------------------------------------------------------------------------


def _rebase(arr, base: IndexBase):
    a = np.asarray(arr)
    if int(base) != 0:
        a = a - int(base)
    return a


def create_csr(m, n, ptr, ind, val, base: IndexBase = IndexBase.zero) -> SparseMatrix:
    check_value_dtype(np.asarray(val).dtype)
    srt, full = check_csr_arrays(m, n, ptr, ind, val, base)
    A = CSR(_rebase(ptr, base), _rebase(ind, base), jnp.asarray(val), shape=(int(m), int(n)))
    h = SparseMatrix(A, FormatType.csr, base)
    h.sort = MatrixSort.fully_sorted if srt else MatrixSort.unsorted
    h.fulldiag = full
    return h


def create_csc(m, n, ptr, ind, val, base: IndexBase = IndexBase.zero) -> SparseMatrix:
    check_value_dtype(np.asarray(val).dtype)
    # CSC with shape (m, n) is structurally CSR of the (n, m) transpose
    srt, _ = check_csr_arrays(n, m, ptr, ind, val, base)
    A = CSC(_rebase(ptr, base), _rebase(ind, base), jnp.asarray(val), shape=(int(m), int(n)))
    h = SparseMatrix(A, FormatType.csc, base)
    h.sort = MatrixSort.fully_sorted if srt else MatrixSort.unsorted
    return h


def create_coo(m, n, row, col, val, base: IndexBase = IndexBase.zero) -> SparseMatrix:
    check_value_dtype(np.asarray(val).dtype)
    row = np.asarray(row)
    col = np.asarray(col)
    val_np = np.asarray(val)
    check_sizes(m, n, val_np.shape[0])
    require(row.shape == col.shape == val_np.shape[:1], Status.invalid_size, "coo array mismatch")
    b = int(base)
    if row.size:
        require(
            bool(row.min() >= b and row.max() < m + b), Status.invalid_index_value, "row range"
        )
        require(
            bool(col.min() >= b and col.max() < n + b), Status.invalid_index_value, "col range"
        )
    A = COO(_rebase(row, base), _rebase(col, base), jnp.asarray(val), shape=(int(m), int(n)))
    return SparseMatrix(A, FormatType.coo, base)


def create_bsr(
    mb, nb, block_dim, ptr, ind, val, base: IndexBase = IndexBase.zero
) -> SparseMatrix:
    check_value_dtype(np.asarray(val).dtype)
    require(block_dim > 0, Status.invalid_size, "block_dim must be > 0")
    ptr = _rebase(ptr, base)
    ind = _rebase(ind, base)
    val = np.asarray(val)
    nnzb = int(ptr[-1])
    require(val.size == nnzb * block_dim * block_dim, Status.invalid_size, "bsr val size")
    A = BSR(
        ptr,
        ind,
        jnp.asarray(val).reshape(nnzb, block_dim, block_dim),
        block_dim=int(block_dim),
        shape=(int(mb * block_dim), int(nb * block_dim)),
    )
    return SparseMatrix(A, FormatType.bsr, base)


def create_tcsr(
    m, n, nnz, ptr_L, ptr_U, ind_L, ind_U, val_L, val_U, base: IndexBase = IndexBase.zero
) -> SparseMatrix:
    """Triangular-CSR ingestion (aoclsparse_create_?tcsr,
    include/aoclsparse_auxiliary.h:516-598). Both triangles arrive CSR-like
    with the diagonal stored in each: per row, L part = strictly-lower
    entries (possibly unsorted among themselves) then the diagonal LAST;
    U part = diagonal FIRST then strictly-upper entries. Square with a full
    non-zero-structure diagonal required; violations of the part ordering
    surface unsorted_input, misplaced entries invalid_value — matching the
    reference's documented status table."""
    for v in (ptr_L, ptr_U, ind_L, ind_U, val_L, val_U):
        require(v is not None, Status.invalid_pointer, "null tcsr array")
    check_value_dtype(np.asarray(val_L).dtype)
    require(
        np.asarray(val_L).dtype == np.asarray(val_U).dtype,
        Status.wrong_type,
        "val_L/val_U dtype mismatch",
    )
    m, n = int(m), int(n)
    require(m == n, Status.invalid_size, "TCSR supports square matrices only")
    check_sizes(m, n, int(nnz))
    b = int(base)
    pL = _rebase(ptr_L, base).astype(np.int64)
    pU = _rebase(ptr_U, base).astype(np.int64)
    iL = _rebase(ind_L, base).astype(np.int64)
    iU = _rebase(ind_U, base).astype(np.int64)
    vL = np.asarray(val_L)
    vU = np.asarray(val_U)
    for p, i, v, nm in ((pL, iL, vL, "L"), (pU, iU, vU, "U")):
        require(p.shape == (m + 1,), Status.invalid_size, f"ptr_{nm} must be (m+1,)")
        require(p[0] == 0, Status.invalid_value, f"ptr_{nm}[0] must equal base")
        require(bool(np.all(np.diff(p) >= 0)), Status.invalid_value, f"ptr_{nm} non-decreasing")
        require(int(p[-1]) == i.shape[0], Status.invalid_size, f"ptr_{nm}[-1] != len(ind_{nm})")
        require(i.shape[0] == v.shape[0], Status.invalid_size, f"ind_{nm}/val_{nm} mismatch")
        if i.size:
            require(
                bool(i.min() >= 0 and i.max() < n),
                Status.invalid_index_value,
                f"ind_{nm} out of range",
            )
    # total distinct nnz: diagonal counted once
    require(
        int(pL[-1]) + int(pU[-1]) - m == int(nnz),
        Status.invalid_size,
        "nnz != nnz(L+D) + nnz(D+U) - m",
    )
    rows_L = np.repeat(np.arange(m, dtype=np.int64), np.diff(pL))
    rows_U = np.repeat(np.arange(m, dtype=np.int64), np.diff(pU))
    # part membership: L array must hold only lower-or-diagonal entries, U only
    # upper-or-diagonal (else the input is mis-partitioned -> unsorted_input)
    require(bool(np.all(iL <= rows_L)), Status.unsorted_input, "U element in the L part")
    require(bool(np.all(iU >= rows_U)), Status.unsorted_input, "L element in the U part")
    # full diagonal, stored exactly once per part, in the fixed position:
    # last of the row's L segment, first of the row's U segment
    require(bool(np.all(np.diff(pL) >= 1)), Status.invalid_value, "missing diagonal in L")
    require(bool(np.all(np.diff(pU) >= 1)), Status.invalid_value, "missing diagonal in U")
    dposL = pL[1:] - 1
    dposU = pU[:-1]
    require(
        bool(np.all(iL[dposL] == np.arange(m))),
        Status.unsorted_input,
        "diagonal must be the last entry of each L row segment",
    )
    require(
        bool(np.all(iU[dposU] == np.arange(m))),
        Status.unsorted_input,
        "diagonal must be the first entry of each U row segment",
    )
    ndiag_L = np.bincount(rows_L[iL == rows_L], minlength=m)
    ndiag_U = np.bincount(rows_U[iU == rows_U], minlength=m)
    require(
        bool(np.all(ndiag_L == 1) and np.all(ndiag_U == 1)),
        Status.invalid_value,
        "duplicate diagonal entries",
    )
    A = TCSR(
        pL.astype(np.int32),
        iL.astype(np.int32),
        jnp.asarray(vL),
        pU.astype(np.int32),
        iU.astype(np.int32),
        jnp.asarray(vU),
        shape=(m, n),
    )
    h = SparseMatrix(A, FormatType.tcsr, base)
    h.fulldiag = True
    return h


def create_ell(m, n, width, ind, val, base: IndexBase = IndexBase.zero) -> SparseMatrix:
    check_value_dtype(np.asarray(val).dtype)
    ind = np.asarray(ind).reshape(m, width)
    val = np.asarray(val).reshape(m, width)
    if int(base) != 0:
        ind = np.where(ind >= 0, ind - int(base), -1)
    A = ELL(jnp.asarray(ind), jnp.asarray(val), width=int(width), shape=(int(m), int(n)))
    return SparseMatrix(A, FormatType.ell, base)


def create_dia(m, n, dist, val, base: IndexBase = IndexBase.zero) -> SparseMatrix:
    check_value_dtype(np.asarray(val).dtype)
    dist = np.asarray(dist)
    val = np.asarray(val).reshape(dist.shape[0], m)
    A = DIA(jnp.asarray(dist), jnp.asarray(val), shape=(int(m), int(n)))
    return SparseMatrix(A, FormatType.dia, base)


# ---------------------------------------------------------------------------
# export (aoclsparse_export_(s/d/c/z)csr etc., auxiliary.cpp:552-651)
# ---------------------------------------------------------------------------


def _require_handle(h) -> None:
    """Reference contract: every handle-taking entry point returns
    invalid_pointer on a null matrix (e.g. auxiliary.cpp:840)."""
    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")


def _to_csr_data(h: SparseMatrix) -> CSR:
    _require_handle(h)
    from ..convert import conversions as cv

    return cv.to_csr(h.data)


def export_csr(h: SparseMatrix, base: Optional[IndexBase] = None):
    """Return (m, n, nnz, ptr, ind, val) numpy views in the requested base."""
    _require_handle(h)
    A = _to_csr_data(h)
    b = int(base if base is not None else h.base)
    ptr = np.asarray(A.ptr) + b
    ind = np.asarray(A.ind) + b
    return A.m, A.n, A.nnz, ptr, ind, np.asarray(A.val)


def export_csc(h: SparseMatrix, base: Optional[IndexBase] = None):
    _require_handle(h)
    from ..convert import conversions as cv

    A = cv.to_csc(h.data)
    b = int(base if base is not None else h.base)
    return A.m, A.n, A.nnz, np.asarray(A.ptr) + b, np.asarray(A.ind) + b, np.asarray(A.val)


def export_coo(h: SparseMatrix, base: Optional[IndexBase] = None):
    _require_handle(h)
    from ..convert import conversions as cv

    A = cv.to_coo(h.data)
    b = int(base if base is not None else h.base)
    return A.m, A.n, A.nnz, np.asarray(A.row) + b, np.asarray(A.col) + b, np.asarray(A.val)


# ---------------------------------------------------------------------------
# auxiliary mutators (aoclsparse_copy/order_mat/set_value/update_values)
# ---------------------------------------------------------------------------


def copy(h: SparseMatrix) -> SparseMatrix:
    """Independent handle over the same immutable data (aoclsparse_copy);
    later update_values on either handle does not affect the other."""
    _require_handle(h)
    out = SparseMatrix(h.data, h.input_format, h.base)  # pytrees are immutable: share
    out.sort = h.sort
    out.fulldiag = h.fulldiag
    out.mem_policy = h.mem_policy
    return out


def order_mat(h: SparseMatrix) -> SparseMatrix:
    """In-place sort of column indices within each row (auxiliary.cpp:837).

    Reference contract: null handle -> invalid_pointer; ordering is
    implemented only for the CSR input format (auxiliary.cpp:846-848) —
    other formats return not_implemented."""
    from ..convert import conversions as cv

    _require_handle(h)
    if h.input_format != FormatType.csr:
        raise AoclSparseError(
            Status.not_implemented, "order_mat supports CSR input only (reference parity)"
        )
    A = _to_csr_data(h)
    h.data = cv.sort_csr(A)
    h.input_format = FormatType.csr
    h.sort = MatrixSort.fully_sorted
    h.invalidate()
    return h


def set_value(h: SparseMatrix, row: int, col: int, value) -> SparseMatrix:
    """Point-update one stored entry; invalid_index_value if not in pattern
    (auxiliary.cpp:529-548)."""
    A = _to_csr_data(h)
    ptr = np.asarray(A.ptr)
    ind = np.asarray(A.ind)
    lo, hi = int(ptr[row]), int(ptr[row + 1])
    pos = np.nonzero(ind[lo:hi] == col)[0]
    require(pos.size > 0, Status.invalid_index_value, f"({row},{col}) not in sparsity pattern")
    k = lo + int(pos[0])
    val = A.val.at[k].set(value)
    h.data = dataclasses.replace(A, val=val)
    h.input_format = FormatType.csr
    h.ilu_state = None
    # pattern unchanged: keep the plan but re-run value gathers (same
    # contract as update_values — a cached exec form would otherwise keep
    # serving the old value)
    if h.plan is not None:
        h.plan.refresh_values(h.data)
    return h


def update_values(h: SparseMatrix, values) -> SparseMatrix:
    """Replace all values keeping the pattern (auxiliary.cpp:674-706)."""
    _require_handle(h)
    if values is None:
        raise AoclSparseError(Status.invalid_pointer, "null values")
    # keep a host twin when the caller handed numpy: the plan's host engines
    # (mv KID 11, trsv KID 2) then refresh with zero device traffic
    values_host = np.asarray(values) if not isinstance(values, jax.Array) else None
    values = jnp.asarray(values)
    if h.values_pending:
        # pending lazy extraction (band-engine SpGEMM product): the old
        # values are being replaced wholesale — skip materializing them
        ptr, ind, shape, _dtype, _thunk = h._lazy
        require(
            values.shape[0] == int(np.asarray(ptr)[-1]),
            Status.invalid_size,
            "update_values length mismatch",
        )
        h.data = CSR(ptr, ind, values, shape=shape)
        h.ilu_state = None
        if h.plan is not None:
            h.plan.refresh_values(h.data, host_values=values_host)
        return h
    A = h.data
    if isinstance(A, TCSR):
        # parity: the reference's update_values handles csr/coo only
        # (auxiliary.hpp:217-241, default -> not_implemented)
        require(False, Status.not_implemented, "update_values on TCSR")
    require(
        values.shape[0] == (A.val.size if hasattr(A, "val") else 0),
        Status.invalid_size,
        "update_values length mismatch",
    )
    h.data = dataclasses.replace(A, val=values.reshape(A.val.shape))
    h.ilu_state = None
    # pattern unchanged: plan stays valid except value-derived caches
    if h.plan is not None:
        h.plan.refresh_values(h.data, host_values=values_host)
    return h


def destroy(h: SparseMatrix) -> None:
    """API-parity release (GC owns memory). A null handle is a success
    no-op, exactly the reference (auxiliary.cpp:654-658 `if(A && *A)`)."""
    if h is None:
        return
    h.data = None
    h.plan = None
    h.ilu_state = None
