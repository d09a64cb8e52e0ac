"""Format conversions (reference: library/src/conversion/aoclsparse_convert.cpp).

Design split, per the XLA static-shape model (SURVEY.md §7 "Dynamic shapes"):
structure (ptr/ind layouts, widths, permutations) is computed host-side with
numpy — it is data-dependent-shape work the reference also does eagerly in
`optimize`/convert — while *values* move through device-side gathers keyed by
a precomputed permutation, so repeated conversions after `update_values`
re-run as a single jitted gather.

Covers csr2csc (:817), csr2ell/ellt/ellthyb (:307-505), csr2dia (:506),
csr2bsr (:592), csr2blkcsr's role via SELL, csr2dense (:933), and handle-level
convert_csr (:1004) via `to_csr` on every format.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.formats import BSR, COO, CSC, CSR, DIA, ELL, SELL, TCSR
from ..core.types import AoclSparseError, Operation, Status

__all__ = [
    "to_csr",
    "to_csc",
    "to_coo",
    "sort_csr",
    "csr_transpose",
    "csr_apply_operation",
    "csr_to_ell",
    "csr_to_ellhyb",
    "csr_to_dia",
    "csr_to_bsr",
    "csr_to_sell",
    "bsr_to_csr",
    "csr_to_dense",
    "dense_to_csr",
    "coo_to_csr",
    "csr2ell_width",
    "csr2ellthyb_width",
    "csr2dia_ndiag",
    "csr2bsr_nnz",
    "opt_blksize",
    "csr2blkcsr",
]


def _np(a):
    return np.asarray(a)


# ---------------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------------


def coo_to_csr(A: COO, sum_duplicates: bool = False) -> CSR:
    row = _np(A.row)
    col = _np(A.col)
    order = np.lexsort((col, row))
    row_s, col_s = row[order], col[order]
    if sum_duplicates and row_s.size:
        keep = np.ones(row_s.size, dtype=bool)
        keep[1:] = (row_s[1:] != row_s[:-1]) | (col_s[1:] != col_s[:-1])
        seg = np.cumsum(keep) - 1
        val = jnp.zeros((int(seg[-1]) + 1,), dtype=A.val.dtype).at[jnp.asarray(seg)].add(
            A.val[jnp.asarray(order)]
        )
        row_s, col_s = row_s[keep], col_s[keep]
    else:
        val = A.val[jnp.asarray(order)] if row_s.size else A.val
    ptr = np.zeros(A.m + 1, dtype=np.int64)
    np.add.at(ptr, row_s + 1, 1)
    ptr = np.cumsum(ptr)
    return CSR(ptr.astype(np.int32), col_s.astype(np.int32), val, shape=A.shape)


def sort_csr(A: CSR) -> CSR:
    """Sort column indices within each row (aoclsparse_sort_idx_val analog,
    csr_util.hpp:103). Values permuted on device."""
    ptr = _np(A.ptr)
    ind = _np(A.ind)
    m = A.m
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    order = np.lexsort((ind, rows))
    if np.array_equal(order, np.arange(order.size)):
        return A
    return CSR(A.ptr, ind[order].astype(ind.dtype), A.val[jnp.asarray(order)], shape=A.shape)


def csr_transpose(A: CSR, conj: bool = False) -> CSR:
    """CSR of A^T (the csr2csc engine, aoclsparse_convert.hpp template)."""
    ptr = _np(A.ptr)
    ind = _np(A.ind)
    m, n = A.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    order = np.lexsort((rows, ind))  # sort by (col, row)
    new_ind = rows[order]
    tptr = np.zeros(n + 1, dtype=np.int64)
    if ind.size:
        np.add.at(tptr, ind + 1, 1)
    tptr = np.cumsum(tptr)
    val = A.val[jnp.asarray(order)]
    if conj:
        val = jnp.conj(val)
    return CSR(tptr.astype(np.int32), new_ind.astype(np.int32), val, shape=(n, m))


def csr_apply_operation(A: CSR, op: Operation) -> CSR:
    op = Operation(op)
    if op == Operation.none:
        return A
    return csr_transpose(A, conj=(op == Operation.conjugate_transpose))


def tcsr_to_csr(data) -> CSR:
    """Merge the two TCSR triangles into sorted CSR (diagonal taken from the
    L copy; the create API guarantees both copies agree structurally)."""
    m, n = data.shape
    pL = _np(data.ptr_L).astype(np.int64)
    pU = _np(data.ptr_U).astype(np.int64)
    iL = _np(data.ind_L).astype(np.int64)
    iU = _np(data.ind_U).astype(np.int64)
    vL = _np(data.val_L)
    vU = _np(data.val_U)
    rows_L = np.repeat(np.arange(m, dtype=np.int64), np.diff(pL))
    rows_U = np.repeat(np.arange(m, dtype=np.int64), np.diff(pU))
    keep_U = iU != rows_U  # strictly-upper only (diag comes from L)
    r = np.concatenate([rows_L, rows_U[keep_U]])
    c = np.concatenate([iL, iU[keep_U]])
    v = np.concatenate([vL, vU[keep_U]])
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ptr, r + 1, 1)
    ptr = np.cumsum(ptr)
    return CSR(ptr.astype(np.int32), c.astype(np.int32), jnp.asarray(v), shape=(m, n))


def to_csr(data) -> CSR:
    if isinstance(data, CSR):
        return data
    if isinstance(data, TCSR):
        return tcsr_to_csr(data)
    if isinstance(data, CSC):
        # CSC(m,n) arrays are CSR of the (n,m) transpose; transpose back
        as_csr_t = CSR(data.ptr, data.ind, data.val, shape=(data.n, data.m))
        return csr_transpose(as_csr_t)
    if isinstance(data, COO):
        return coo_to_csr(data)
    if isinstance(data, BSR):
        return bsr_to_csr(data)
    if isinstance(data, ELL):
        return _ell_to_csr(data)
    if isinstance(data, DIA):
        return _dia_to_csr(data)
    raise AoclSparseError(Status.wrong_type, f"to_csr: unsupported {type(data)}")


def to_csc(data) -> CSC:
    A = to_csr(data)
    T = csr_transpose(A)
    return CSC(T.ptr, T.ind, T.val, shape=A.shape)


def to_coo(data) -> COO:
    A = to_csr(data)
    ptr = _np(A.ptr)
    rows = np.repeat(np.arange(A.m, dtype=np.int64), np.diff(ptr))
    return COO(rows.astype(np.int32), A.ind, A.val, shape=A.shape)


# ---------------------------------------------------------------------------
# CSR -> padded/blocked execution formats
# ---------------------------------------------------------------------------


def _row_lengths(A: CSR) -> np.ndarray:
    return np.diff(_np(A.ptr))


def csr_to_ell(A: CSR, width: Optional[int] = None) -> ELL:
    """Pad every row to `width` (default: max row length). Gather-permutation
    built host-side; values gathered on device (csr2ell, convert.cpp:307)."""
    ptr = _np(A.ptr)
    lens = np.diff(ptr)
    w = int(width if width is not None else (lens.max() if lens.size else 0))
    m = A.m
    # position k in row i maps from csr offset ptr[i]+k
    offs = ptr[:-1, None] + np.arange(w)[None, :]
    valid = np.arange(w)[None, :] < lens[:, None]
    src = np.where(valid, offs, 0).astype(np.int64)
    ind_np = _np(A.ind)
    ell_ind = np.where(valid, ind_np[np.minimum(src, max(ind_np.size - 1, 0))], -1)
    gathered = A.val[jnp.asarray(src.reshape(-1))].reshape(m, w)
    ell_val = jnp.where(jnp.asarray(valid), gathered, jnp.zeros((), dtype=A.val.dtype))
    return ELL(ell_ind.astype(np.int32), ell_val, width=w, shape=A.shape)


def csr_to_ellhyb(A: CSR, width: Optional[int] = None) -> Tuple[ELL, CSR]:
    """Hybrid split: rows' first `width` entries in ELL, spill in a CSR
    remainder (csr2ellthyb, convert.cpp:406). Default width mirrors the
    reference heuristic: min(max_width, mean + stddev?) — we use the nnz/row
    mean rounded up, clamped like aoclsparse_analysis.cpp (ell_width<=30 there;
    widths rounded to multiples of 8)."""
    lens = _row_lengths(A)
    if width is None:
        mean = float(lens.mean()) if lens.size else 0.0
        width = int(min(max(8, int(np.ceil(mean / 8.0) * 8)), 64))
    w = int(width)
    ptr = _np(A.ptr)
    ind = _np(A.ind)
    head = np.minimum(lens, w)
    # ELL part
    offs = ptr[:-1, None] + np.arange(w)[None, :]
    valid = np.arange(w)[None, :] < head[:, None]
    src = np.where(valid, offs, 0).astype(np.int64)
    ell_ind = np.where(valid, ind[np.minimum(src, max(ind.size - 1, 0))], -1)
    gathered = A.val[jnp.asarray(src.reshape(-1))].reshape(A.m, w)
    ell_val = jnp.where(jnp.asarray(valid), gathered, jnp.zeros((), dtype=A.val.dtype))
    ell = ELL(ell_ind.astype(np.int32), ell_val, width=w, shape=A.shape)
    # CSR spill
    tail = lens - head
    sptr = np.concatenate([[0], np.cumsum(tail)]).astype(np.int64)
    tot = int(sptr[-1])
    src2 = np.zeros(tot, dtype=np.int64)
    for i in np.nonzero(tail)[0]:
        src2[sptr[i] : sptr[i + 1]] = np.arange(ptr[i] + w, ptr[i + 1])
    spill = CSR(
        sptr.astype(np.int32),
        ind[src2].astype(np.int32) if tot else np.zeros(0, np.int32),
        A.val[jnp.asarray(src2)] if tot else A.val[:0],
        shape=A.shape,
    )
    return ell, spill


def csr_to_dia(A: CSR, max_diags: Optional[int] = None) -> DIA:
    ptr = _np(A.ptr)
    ind = _np(A.ind)
    m, n = A.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    diags = ind.astype(np.int64) - rows
    dist = np.unique(diags)
    if max_diags is not None and dist.size > max_diags:
        raise AoclSparseError(Status.invalid_size, f"{dist.size} diagonals > cap {max_diags}")
    val = np.zeros((dist.size, m), dtype=np.asarray(A.val).dtype)
    slot = np.searchsorted(dist, diags)
    val[slot, rows] = _np(A.val)
    return DIA(dist.astype(np.int32), jnp.asarray(val), shape=A.shape)


def csr_to_bsr(A: CSR, block_dim: int) -> BSR:
    bs = int(block_dim)
    m, n = A.shape
    mb, nb = -(-m // bs), -(-n // bs)
    ptr = _np(A.ptr)
    ind = _np(A.ind)
    vnp = _np(A.val)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    brow, bcol = rows // bs, ind // bs
    keys = brow * nb + bcol
    ukeys, inv = np.unique(keys, return_inverse=True)
    nnzb = ukeys.size
    bptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(bptr, (ukeys // nb) + 1, 1)
    bptr = np.cumsum(bptr)
    bind = (ukeys % nb).astype(np.int32)
    bval = np.zeros((nnzb, bs, bs), dtype=vnp.dtype)
    bval[inv, rows % bs, ind % bs] = vnp
    # keep the element-level shape; partial edge blocks are zero-padded
    # (reference csr2bsr pads edge blocks too, convert.cpp:592)
    return BSR(bptr.astype(np.int32), bind, jnp.asarray(bval), block_dim=bs, shape=(m, n))


def bsr_to_csr(A: BSR) -> CSR:
    """Expand stored blocks to element CSR (vectorized — host structure work
    must not be per-element Python loops on this box). Every in-band entry of
    a stored block is kept, including zeros: filtering on value would change
    the stored pattern and break value-path refresh assumptions."""
    bs = A.block_dim
    mb = A.mb
    bptr = _np(A.ptr).astype(np.int64)
    bind = _np(A.ind).astype(np.int64)
    bval = _np(A.val)
    m, n = A.shape
    nnzb = bind.shape[0]
    brow = np.repeat(np.arange(mb, dtype=np.int64), np.diff(bptr))
    r = np.arange(bs, dtype=np.int64)
    i = np.broadcast_to(brow[:, None, None] * bs + r[None, :, None], (nnzb, bs, bs)).ravel()
    j = np.broadcast_to(bind[:, None, None] * bs + r[None, None, :], (nnzb, bs, bs)).ravel()
    v = bval.reshape(nnzb * bs * bs)
    keep = (i < m) & (j < n)
    i, j, v = i[keep], j[keep], v[keep]
    order = np.lexsort((j, i))
    i, j, v = i[order], j[order], v[order]
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ptr, i + 1, 1)
    ptr = np.cumsum(ptr)
    return CSR(ptr.astype(np.int32), j.astype(np.int32), jnp.asarray(v), shape=(m, n))


def csr_to_sell(A: CSR, slice_rows: int = 8, lane: int = 128) -> SELL:
    """Build the sliced-ELL execution format: per 8-row slice, width is the
    slice's max row length rounded up to a lane multiple."""
    ptr = _np(A.ptr)
    ind = _np(A.ind)
    m = A.m
    lens = np.diff(ptr)
    nsl = -(-m // slice_rows) if m else 0
    widths = np.zeros(nsl, dtype=np.int64)
    for s in range(nsl):
        chunk = lens[s * slice_rows : (s + 1) * slice_rows]
        w = int(chunk.max()) if chunk.size else 0
        widths[s] = max(lane, -(-w // lane) * lane) if w else lane
    sp = np.concatenate([[0], np.cumsum(widths * slice_rows)])
    tot = int(sp[-1])
    src = np.zeros(tot, dtype=np.int64)
    valid = np.zeros(tot, dtype=bool)
    out_ind = np.full(tot, -1, dtype=np.int32)
    for s in range(nsl):
        w = int(widths[s])
        for r in range(slice_rows):
            i = s * slice_rows + r
            if i >= m:
                continue
            o = int(sp[s]) + r * w
            L = int(lens[i])
            src[o : o + L] = np.arange(ptr[i], ptr[i + 1])
            valid[o : o + L] = True
            out_ind[o : o + L] = ind[ptr[i] : ptr[i + 1]]
    gathered = A.val[jnp.asarray(src)]
    vals = jnp.where(jnp.asarray(valid), gathered, jnp.zeros((), dtype=A.val.dtype))
    return SELL(
        sp.astype(np.int32),
        widths.astype(np.int32),
        jnp.asarray(out_ind),
        vals,
        slice_rows=slice_rows,
        shape=A.shape,
    )


# ---------------------------------------------------------------------------
# dense interop
# ---------------------------------------------------------------------------


def csr_to_dense(A: CSR, order: str = "row") -> jnp.ndarray:
    """csr2dense (convert.cpp:933) as a jittable scatter. Accepts the CSR
    struct or a CSR-format matrix handle (unwrapped to its struct)."""
    if not hasattr(A, "ptr") and hasattr(A, "data") and hasattr(A.data, "ptr"):
        A = A.data  # SparseMatrix handle in CSR format
    m, n = A.shape
    ptr = _np(A.ptr)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    out = jnp.zeros((m, n), dtype=A.val.dtype)
    out = out.at[jnp.asarray(rows), A.ind].add(A.val)
    return out.T if order == "column" else out


def _ell_to_csr(E: ELL) -> CSR:
    ind = _np(E.ind)
    val = _np(E.val)
    m = E.m
    mask = ind >= 0
    lens = mask.sum(axis=1)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    out_ind = ind[mask].astype(np.int32)
    out_val = val[mask]
    return CSR(ptr, out_ind, jnp.asarray(out_val), shape=E.shape)


def _dia_to_csr(D: DIA) -> CSR:
    dist = _np(D.dist)
    val = _np(D.val)
    m, n = D.shape
    entries = []
    for i in range(m):
        for di, d in enumerate(dist):
            j = i + int(d)
            if 0 <= j < n and val[di, i] != 0:
                entries.append((i, j, val[di, i]))
    entries.sort()
    ptr = np.zeros(m + 1, dtype=np.int32)
    for i, _, _ in entries:
        ptr[i + 1] += 1
    ptr = np.cumsum(ptr).astype(np.int32)
    ind = np.asarray([j for _, j, _ in entries], dtype=np.int32)
    v = np.asarray([v for _, _, v in entries], dtype=val.dtype)
    return CSR(ptr, ind, jnp.asarray(v), shape=D.shape)


def dense_to_csr(dense, tol: float = 0.0) -> CSR:
    d = np.asarray(dense)
    m, n = d.shape
    mask = np.abs(d) > tol
    lens = mask.sum(axis=1)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = np.nonzero(mask)[1].astype(np.int32)
    vals = d[mask]
    return CSR(ptr, cols, jnp.asarray(vals), shape=(m, n))


# ---------------------------------------------------------------------------
# Reference-parity query helpers: the reference's two-phase conversion API
# sizes output buffers with a query call before the conversion proper
# (aoclsparse_csr2ell_width, csr2ellthyb_width, csr2dia_ndiag, csr2bsr_nnz,
# opt_blksize — include/aoclsparse_convert.h:39-634). Our converters return
# ready objects, so these helpers exist for API parity and for callers that
# want the planning numbers without materializing the target format.
# ---------------------------------------------------------------------------


def csr2ell_width(m: int, nnz: int, csr_row_ptr) -> int:
    """Max per-row nnz = the ELL width (aoclsparse_csr2ell_width,
    convert.h:60, convert.cpp:300-335). The null check precedes any m==0
    quick exit — the reference has no m==0 early-out here (unlike
    csr2ellthyb_width, which does)."""
    if m < 0 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative size")
    if csr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null row_ptr")
    lens = np.diff(np.asarray(csr_row_ptr))
    return int(lens.max()) if lens.size else 0


def csr2ellthyb_width(m: int, nnz: int, csr_row_ptr) -> Tuple[int, int]:
    """Hybrid split sizing: returns (ell_m, ell_width)
    (aoclsparse_csr2ellthyb_width, convert.cpp:340-404). The width is the
    reference's majority-side pivot around the mean row length; ell_m counts
    rows that fit."""
    if m < 0 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative size")
    if m == 0:
        return 0, 0
    if csr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null row_ptr")
    lens = np.diff(np.asarray(csr_row_ptr)).astype(np.int64)
    nnza = nnz // m
    le = lens[lens <= nnza]
    gt = lens[lens > nnza]
    mx_le = int(le.max()) if le.size else 0
    mn_gt = int(gt.min()) if gt.size else nnz
    width = mx_le if le.size >= gt.size else mn_gt
    ell_m = int((lens <= width).sum())
    return ell_m, width


def csr2dia_ndiag(m: int, n: int, nnz: int, csr_row_ptr, csr_col_ind) -> int:
    """Number of distinct non-empty diagonals (aoclsparse_csr2dia_ndiag,
    convert.h:215, convert.cpp)."""
    if m < 0 or n < 0 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative size")
    if csr_row_ptr is None or csr_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    ptr = np.asarray(csr_row_ptr)
    ind = np.asarray(csr_col_ind).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    return int(np.unique(ind - rows).size)


def csr2bsr_nnz(m: int, n: int, csr_row_ptr, csr_col_ind, block_dim: int) -> Tuple[np.ndarray, int]:
    """BSR sizing: returns (bsr_row_ptr, bsr_nnz) — the number of nonzero
    (block_dim x block_dim) blocks per block row and in total
    (aoclsparse_csr2bsr_nnz, convert.h:324)."""
    if m < 0 or n < 0 or block_dim <= 0:
        raise AoclSparseError(Status.invalid_size, "bad dimension/block_dim")
    if csr_row_ptr is None or csr_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    bs = int(block_dim)
    mb, nb = -(-m // bs), -(-n // bs)
    ptr = np.asarray(csr_row_ptr)
    ind = np.asarray(csr_col_ind).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    keys = np.unique((rows // bs) * nb + (ind // bs))
    counts = np.bincount((keys // nb).astype(np.int64), minlength=mb)
    bptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return bptr, int(keys.size)


def opt_blksize(m: int, nnz: int, csr_row_ptr, csr_col_ind) -> Tuple[int, int]:
    """Pick the blkcsr row-group size (aoclsparse_opt_blksize,
    conversion/aoclsparse_convert.cpp:36-143). Returns (nRowsblk, total_blks)
    with nRowsblk == 0 when block compression isn't worthwhile (the
    reference's empirically tuned utilization cutoffs, reproduced exactly)."""
    if m <= 0 or nnz <= 0 or csr_row_ptr is None or csr_col_ind is None:
        return 0, 0
    from .. import native

    ptr = np.asarray(csr_row_ptr).astype(np.int64)
    ind = np.asarray(csr_col_ind).astype(np.int64)
    n_cols = int(ind.max()) + 1 if ind.size else 0
    factors = (1, 2, 4)
    # first counting pass gates the rest (the reference early-returns inside
    # the i==0 iteration, skipping the factor-2/4 scans); nnzpr is integer
    # division there (aoclsparse_int nnz/m assigned to double)
    t1 = native.blkcsr_count(m, n_cols, ptr, ind, 1)
    util1 = (nnz / t1 if t1 else 0.0) / 8 * 100
    nnzpr = nnz // m
    if (nnzpr < 30 and util1 < 40) or (nnzpr > 30 and util1 < 50):
        return 0, 0
    total = [t1] + [native.blkcsr_count(m, n_cols, ptr, ind, f) for f in factors[1:]]
    per_blk = [nnz / t if t else 0.0 for t in total]
    blk_util = [per_blk[i] / (factors[i] * 8) * 100 for i in range(3)]
    inc1 = (per_blk[1] - per_blk[0]) / per_blk[0] * 100 if per_blk[0] else 0.0
    inc2 = (per_blk[2] - per_blk[1]) / per_blk[1] * 100 if per_blk[1] else 0.0
    if (
        blk_util[2] > 24
        and (abs(inc1 - inc2) < 12.5 or abs(blk_util[1] - blk_util[2]) < 12.5)
        and inc2 > 51
    ):
        return 4, total[2]
    if blk_util[1] > 28:
        return 2, total[1]
    return 0, 0


def csr2blkcsr(m: int, n: int, nnz: int, csr_row_ptr, csr_col_ind, csr_val, nRowsblk: int):
    """Greedy masked-block compression (aoclsparse_csr2blkcsr,
    conversion/aoclsparse_convert.cpp:145-290). Returns
    (blk_row_ptr, blk_col_ind, blk_csr_val, masks): blocks of nRowsblk x 8
    columns starting at the first unconsumed column of the row group (clamped
    to n-8 at the right edge), per-subrow uint8 column masks, values reordered
    subrow-sequential in mask-bit order. Requires sorted, duplicate-free CSR.
    The scan runs in native C++ (host_kernels.cpp blkcsr_build); feeds
    ops.blkcsrmv."""
    if m < 0 or n < 8 or nnz < 0:
        raise AoclSparseError(Status.invalid_size, "need m >= 0, n >= 8")
    if nRowsblk not in (1, 2, 4):
        raise AoclSparseError(Status.invalid_size, "nRowsblk must be 1, 2 or 4")
    if csr_row_ptr is None or csr_col_ind is None or csr_val is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    from .. import native

    ptr = np.asarray(csr_row_ptr).astype(np.int64)
    ind = np.asarray(csr_col_ind).astype(np.int64)
    brow_ptr, bcol, masks, perm = native.blkcsr_build(m, n, ptr, ind, int(nRowsblk))
    val = jnp.asarray(csr_val)[jnp.asarray(perm)] if perm.size else jnp.asarray(csr_val)[:0]
    return brow_ptr, bcol, val, masks
