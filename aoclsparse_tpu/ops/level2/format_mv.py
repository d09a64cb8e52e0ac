"""Format-direct SpMV entry points (legacy reference API parity).

The reference exposes raw-array SpMV per storage format alongside the
handle-based ``aoclsparse_mv``:

- ``aoclsparse_?csrmv``      (level2/aoclsparse_csrmv.cpp:31-62, csrmv.hpp:34+)
- ``aoclsparse_?ellmv``      (level2/aoclsparse_ellmv.hpp:35-89, row-major ELL)
- ``aoclsparse_?elltmv``     (ellmv.hpp:318-361, slot-major "transposed" ELL)
- ``aoclsparse_?ellthybmv``  (ellmv.hpp:555-700, ELLT head + CSR heavy rows)
- ``aoclsparse_?diamv``      (level2/aoclsparse_diamv.hpp:72+)
- ``aoclsparse_?bsrmv``      (level2/aoclsparse_bsrmv.cpp)
- ``aoclsparse_?blkcsrmv``   (level2/aoclsparse_blkcsrmv.cpp:35+, masked 8-col
  blocks — an AVX512 layout we accept and decode, see convert csr2blkcsr)

These are compatibility shims over the same XLA kernels the dispatcher uses
(kernels/xla/spmv.py); the optimized path remains the handle API
(``create_csr`` + hints + ``mv``). Validation mirrors the reference: the
legacy format kernels accept only *general* matrices and ``Operation.none``
(ellmv_t:237-247 returns not_implemented otherwise); ``csrmv`` additionally
supports symmetric types and transposition like csrmv_t:188-295.

Arrays follow this package's layout conventions (the shapes produced by
convert/conversions.py): ELL is (m, width) with -1 padding, ELLT is
(width, m), DIA is (ndiag, m) + offsets, BSR blocks are (nnzb, bs, bs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...core.types import (
    AoclSparseError,
    DiagType,
    FillMode,
    IndexBase,
    MatrixType,
    Operation,
    Status,
    is_complex_dtype,
)
from ...kernels.xla.spmv import spmv_bsr, spmv_dia, spmv_ell, spmv_segsum


@partial(jax.jit, static_argnames=("m",))
def _segsum_unsorted(vals, seg, m: int):
    """segment-sum with unsorted segment ids (transpose paths: the segment is
    the column index, which is not monotone in CSR order)."""
    return jax.ops.segment_sum(vals, seg, num_segments=m)


__all__ = [
    "csrmv",
    "ellmv",
    "elltmv",
    "ellthybmv",
    "diamv",
    "bsrmv",
    "blkcsrmv",
]


def _common_checks(descr, op, m, n, x, y_needed_len, x_arr, general_only: bool):
    if descr is None:
        raise AoclSparseError(Status.invalid_pointer, "null descriptor")
    descr.validate()
    op = Operation(op)
    mt = MatrixType(descr.type)
    if general_only:
        if mt != MatrixType.general:
            raise AoclSparseError(
                Status.not_implemented, f"matrix type {mt.name} not supported here"
            )
        if op != Operation.none:
            raise AoclSparseError(Status.not_implemented, "transposed op not supported here")
    if m < 0 or n < 0:
        raise AoclSparseError(Status.invalid_size, "negative dimension")
    if x_arr is None:
        raise AoclSparseError(Status.invalid_pointer, "null x")
    return op, mt


def _check_vec(name: str, v, want: int):
    """Unlike the reference's raw-pointer C API, the array shims can (and
    must) validate operand lengths — JAX clamps out-of-range gathers, so an
    undersized x would silently compute garbage instead of faulting."""
    if np.asarray(v).shape[0] < want:
        raise AoclSparseError(Status.invalid_size, f"{name} needs {want} entries")


def _epilogue(ax, alpha, beta, y, ny, dtype):
    if y is not None:
        _check_vec("y", y, ny)
        y0 = jnp.asarray(y)[:ny].astype(dtype)
    else:
        y0 = jnp.zeros((ny,), dtype=dtype)
    return jnp.asarray(alpha, dtype) * ax.astype(dtype) + jnp.asarray(beta, dtype) * y0


def _zero_base(ind, base):
    ind = np.asarray(ind)
    if IndexBase(base) == IndexBase.one:
        ind = ind - 1
    return ind


def csrmv(op, alpha, m, n, nnz, csr_val, csr_col_ind, csr_row_ptr, descr, x, beta, y=None):
    """Direct CSR SpMV on raw arrays (aoclsparse_?csrmv, csrmv.cpp:31-62).

    Supports general (any op) and symmetric (fill-mode triangle + its
    transpose, diagonal once) like csrmv_t:188-295; other matrix types
    return not_implemented. No planner/optimize round-trip — this is the
    reference's legacy no-analysis path."""
    op, mt = _common_checks(descr, op, m, n, x, m, x, general_only=False)
    if mt not in (MatrixType.general, MatrixType.symmetric):
        raise AoclSparseError(Status.not_implemented, f"csrmv: type {mt.name}")
    if mt == MatrixType.symmetric and m != n:
        raise AoclSparseError(Status.invalid_size, "symmetric matrix must be square")
    if nnz < 0:
        raise AoclSparseError(Status.invalid_size, "negative nnz")
    if csr_val is None or csr_col_ind is None or csr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null CSR array")
    ptr = np.asarray(csr_row_ptr)
    if ptr.shape[0] != m + 1:
        raise AoclSparseError(Status.invalid_size, "row_ptr must have m+1 entries")
    ind = _zero_base(csr_col_ind, descr.base)
    val = jnp.asarray(csr_val)
    xs = jnp.asarray(x)
    _check_vec("x", xs, n if op == Operation.none or mt == MatrixType.symmetric else m)
    dtype = jnp.result_type(val.dtype, xs.dtype)
    row_ids = np.repeat(np.arange(m, dtype=np.int32), np.diff(ptr))
    if ind.shape[0] and (ind.min() < 0 or ind.max() >= n):
        raise AoclSparseError(Status.invalid_index_value, "column index out of range")

    if mt == MatrixType.symmetric:
        # triangle selected by fill_mode, applied as T + strict(T)^op with the
        # diagonal counted once (csrmv_symm_kt semantics)
        lower = FillMode(descr.fill_mode) == FillMode.lower
        keep = (ind <= row_ids) if lower else (ind >= row_ids)
        strict = (ind < row_ids) if lower else (ind > row_ids)
        tri_rows, tri_cols = row_ids[keep], ind[keep]
        tri_val = val[np.flatnonzero(keep)]
        s_rows, s_cols = row_ids[strict], ind[strict]
        s_val = val[np.flatnonzero(strict)]
        if op == Operation.conjugate_transpose and is_complex_dtype(val.dtype):
            tri_val = jnp.conj(tri_val)
            s_val = jnp.conj(s_val)
        ax = spmv_segsum(jnp.asarray(tri_cols), tri_val, jnp.asarray(tri_rows), xs, m)
        ax = ax + _segsum_unsorted(s_val * xs[jnp.asarray(s_rows)], jnp.asarray(s_cols), m)
        dt = DiagType(descr.diag_type)
        if dt in (DiagType.unit, DiagType.zero):
            diag_mask = tri_rows == tri_cols
            ax = ax - _segsum_unsorted(
                tri_val[np.flatnonzero(diag_mask)] * xs[jnp.asarray(tri_cols[diag_mask])],
                jnp.asarray(tri_rows[diag_mask]),
                m,
            )
            if dt == DiagType.unit:
                ax = ax + xs[:m]
        return _epilogue(ax, alpha, beta, y, m, dtype)

    # general
    if op == Operation.none:
        ax = spmv_segsum(jnp.asarray(ind), val, jnp.asarray(row_ids), xs, m)
        ny = m
    else:
        v = jnp.conj(val) if (op == Operation.conjugate_transpose and is_complex_dtype(val.dtype)) else val
        ax = _segsum_unsorted(v * xs[jnp.asarray(row_ids)], jnp.asarray(ind), n)
        ny = n
    return _epilogue(ax, alpha, beta, y, ny, dtype)


def ellmv(op, alpha, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, x, beta, y=None):
    """Row-major ELL SpMV (aoclsparse_?ellmv, ellmv.hpp:35-89). ell_val /
    ell_col_ind are (m, ell_width) with col = -1 padding. General + none only
    (ellmv_t:237-247)."""
    op, _ = _common_checks(descr, op, m, n, x, m, x, general_only=True)
    if ell_val is None or ell_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null ELL array")
    ind = _zero_base(ell_col_ind, descr.base).reshape(m, ell_width) if m else np.zeros(
        (0, ell_width), np.int32
    )
    # restore the -1 sentinel clobbered by one-base correction (-1-1 = -2)
    ind = np.where(ind < 0, -1, ind)
    val = jnp.asarray(ell_val).reshape(m, ell_width)
    xs = jnp.asarray(x)
    _check_vec("x", xs, n)
    dtype = jnp.result_type(val.dtype, xs.dtype)
    ax = spmv_ell(jnp.asarray(ind), val, xs)
    return _epilogue(ax, alpha, beta, y, m, dtype)


def elltmv(op, alpha, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, x, beta, y=None):
    """Slot-major ("transposed") ELL SpMV (aoclsparse_?elltmv,
    ellmv.hpp:318-361): element (slot p, row i) lives at p*m + i. Padding
    entries carry val = 0 with a valid column index, exactly like the
    reference's csr2ellt output — no sentinel check is applied."""
    op, _ = _common_checks(descr, op, m, n, x, m, x, general_only=True)
    if ell_val is None or ell_col_ind is None:
        raise AoclSparseError(Status.invalid_pointer, "null ELL array")
    ind = _zero_base(ell_col_ind, descr.base).reshape(ell_width, m)
    ind = np.where(ind < 0, 0, ind)  # sentinel-padded inputs: val is 0 there
    val = jnp.asarray(ell_val).reshape(ell_width, m)
    xs = jnp.asarray(x)
    _check_vec("x", xs, n)
    dtype = jnp.result_type(val.dtype, xs.dtype)
    ax = spmv_ell(jnp.asarray(ind.T), val.T, xs)
    return _epilogue(ax, alpha, beta, y, m, dtype)


def ellthybmv(
    op,
    alpha,
    m,
    n,
    nnz,
    ell_val,
    ell_col_ind,
    ell_width,
    ell_m,
    csr_val,
    csr_row_ind,
    csr_col_ind,
    row_idx_map,
    csr_row_idx_map,
    descr,
    x,
    beta,
    y=None,
):
    """Hybrid ELLT + CSR SpMV (aoclsparse_?ellthybmv, ellmv.hpp:555-700).

    The ELLT part covers all m rows at width ``ell_width``; rows listed in
    ``csr_row_idx_map`` (m - ell_m of them) are then recomputed from the
    full CSR arrays and overwrite the ELLT result for those rows, exactly
    as the reference saves/restores y around the CSR pass."""
    op, _ = _common_checks(descr, op, m, n, x, m, x, general_only=True)
    if ell_m == m:
        return elltmv(op, alpha, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, x, beta, y)
    if csr_val is None or csr_row_ind is None or csr_col_ind is None or csr_row_idx_map is None:
        raise AoclSparseError(Status.invalid_pointer, "null hybrid CSR array")
    xs = jnp.asarray(x)
    _check_vec("x", xs, n)
    vall = jnp.asarray(ell_val)
    dtype = jnp.result_type(vall.dtype, xs.dtype)
    ax = elltmv(op, 1.0, m, n, nnz, ell_val, ell_col_ind, ell_width, descr, x, 0.0)
    # heavy rows from the original CSR
    heavy = np.asarray(csr_row_idx_map)
    ptr = np.asarray(csr_row_ind)
    one = 1 if IndexBase(descr.base) == IndexBase.one else 0
    cind = _zero_base(csr_col_ind, descr.base)
    cval = jnp.asarray(csr_val)
    starts, ends = ptr[heavy] - one, ptr[heavy + 1] - one
    counts = (ends - starts).astype(np.int64)
    # vectorized range-concatenation (no per-row Python loop; repo rule:
    # host-side structure work must be vectorized numpy)
    total = int(counts.sum())
    seg = np.repeat(np.arange(len(heavy), dtype=np.int32), counts)
    take = np.repeat(starts, counts) + (np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(counts[:-1])]), counts))
    hvals = jax.ops.segment_sum(
        cval[np.asarray(take)] * xs[np.asarray(cind[take])], jnp.asarray(seg), num_segments=len(heavy)
    )
    ax = ax.at[jnp.asarray(heavy)].set(hvals.astype(ax.dtype))
    return _epilogue(ax, alpha, beta, y, m, dtype)


def diamv(op, alpha, m, n, nnz, dia_val, dia_offset, dia_num_diag, descr, x, beta, y=None):
    """DIA SpMV (aoclsparse_?diamv, diamv.hpp:72+). dia_val is (ndiag, m)
    with offsets in ``dia_offset`` (negative = below the main diagonal),
    the layout csr_to_dia produces. General + none only."""
    op, _ = _common_checks(descr, op, m, n, x, m, x, general_only=True)
    if dia_val is None or dia_offset is None:
        raise AoclSparseError(Status.invalid_pointer, "null DIA array")
    offs = np.asarray(dia_offset).reshape(-1)
    if offs.shape[0] != dia_num_diag:
        raise AoclSparseError(Status.invalid_size, "dia_offset length != dia_num_diag")
    val = jnp.asarray(dia_val).reshape(dia_num_diag, m)
    xs = jnp.asarray(x)
    _check_vec("x", xs, n)
    dtype = jnp.result_type(val.dtype, xs.dtype)
    ax = spmv_dia(tuple(int(d) for d in offs), val, xs, m, n)
    return _epilogue(ax, alpha, beta, y, m, dtype)


def bsrmv(op, alpha, mb, nb, bsr_dim, bsr_val, bsr_col_ind, bsr_row_ptr, descr, x, beta, y=None):
    """BSR SpMV (aoclsparse_?bsrmv, bsrmv.cpp). bsr_val is (nnzb, bs, bs)
    dense blocks; y has mb*bsr_dim rows. General + none only."""
    op, _ = _common_checks(descr, op, mb, nb, x, mb * bsr_dim, x, general_only=True)
    if bsr_val is None or bsr_col_ind is None or bsr_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null BSR array")
    if bsr_dim <= 0:
        raise AoclSparseError(Status.invalid_size, "bsr_dim must be positive")
    ptr = np.asarray(bsr_row_ptr)
    if ptr.shape[0] != mb + 1:
        raise AoclSparseError(Status.invalid_size, "bsr_row_ptr must have mb+1 entries")
    ind = _zero_base(bsr_col_ind, descr.base)
    val = jnp.asarray(bsr_val).reshape(-1, bsr_dim, bsr_dim)
    xs = jnp.asarray(x)
    if xs.shape[0] < nb * bsr_dim:
        # pad the tail block's x (callers pass an n-length x when n is not a
        # block multiple); shorter than n is an error
        if xs.shape[0] < nb * bsr_dim - (bsr_dim - 1):
            raise AoclSparseError(Status.invalid_size, f"x needs at least {nb * bsr_dim - (bsr_dim - 1)} entries")
        xs = jnp.pad(xs, (0, nb * bsr_dim - xs.shape[0]))
    dtype = jnp.result_type(val.dtype, xs.dtype)
    brow = np.repeat(np.arange(mb, dtype=np.int32), np.diff(ptr))
    ax = spmv_bsr(jnp.asarray(brow), jnp.asarray(ind), val, xs, mb, bsr_dim)
    return _epilogue(ax[: mb * bsr_dim], alpha, beta, y, mb * bsr_dim, dtype)


def blkcsrmv(
    op,
    alpha,
    m,
    n,
    nnz,
    masks,
    blk_csr_val,
    blk_col_ind,
    blk_row_ptr,
    descr,
    x,
    beta,
    y=None,
    nRowsblk: int = 4,
):
    """Masked-block CSR SpMV (aoclsparse_?blkcsrmv, blkcsrmv.cpp:35+).

    Accepts the reference's blkcsr layout (produced by csr2blkcsr): blocks of
    nRowsblk x 8 columns, per-subrow uint8 column masks, values stored
    subrow-sequential in mask-bit order. The AVX512 mask expansion has no
    device analog, so the shim decodes (vectorized numpy) back to COO triples
    and runs the segment-sum kernel; the optimized path is the handle API."""
    op, _ = _common_checks(descr, op, m, n, x, m, x, general_only=True)
    if masks is None or blk_csr_val is None or blk_col_ind is None or blk_row_ptr is None:
        raise AoclSparseError(Status.invalid_pointer, "null blkcsr array")
    if nRowsblk not in (1, 2, 4):
        raise AoclSparseError(Status.invalid_size, "nRowsblk must be 1, 2 or 4")
    masks = np.asarray(masks, dtype=np.uint8)
    bptr = np.asarray(blk_row_ptr)
    bcol = _zero_base(blk_col_ind, descr.base)
    total_blks = int(bptr[-1]) - int(bptr[0])
    if masks.shape[0] != total_blks * nRowsblk:
        raise AoclSparseError(Status.invalid_size, "masks length != total_blks * nRowsblk")
    # bits[b*nRowsblk + s, c] = 1 iff block b, subrow s has a value at col
    # offset c. unpackbits is MSB-first; bit k of the mask = col offset k.
    bits = np.unpackbits(masks[:, None], axis=1, bitorder="little")  # (B*nr, 8)
    counts = bits.sum(axis=1)
    nvals = int(counts.sum())
    val = jnp.asarray(blk_csr_val)
    if val.shape[0] < nvals:
        raise AoclSparseError(Status.invalid_size, "blk_csr_val shorter than mask population")
    subrow_flat = np.nonzero(bits)  # values in (block,subrow)-major, bit order
    blk_of = subrow_flat[0] // nRowsblk
    sub_of = subrow_flat[0] % nRowsblk
    coloff = subrow_flat[1]
    # block b belongs to row-group g where bptr[g*...]: blk_row_ptr is per
    # matrix row (every subrow of a group shares the group's running offset);
    # reconstruct group of each block from the coarse row pointer
    group_starts = bptr[::nRowsblk] - bptr[0]
    grp = np.searchsorted(group_starts, blk_of, side="right") - 1
    rows = grp * nRowsblk + sub_of
    cols = bcol[blk_of] + coloff
    order = np.argsort(rows, kind="stable")
    xs = jnp.asarray(x)
    _check_vec("x", xs, n)
    dtype = jnp.result_type(val.dtype, xs.dtype)
    ax = spmv_segsum(
        jnp.asarray(cols[order]),
        val[:nvals][jnp.asarray(order)],
        jnp.asarray(rows[order].astype(np.int32)),
        xs,
        m,
    )
    return _epilogue(ax, alpha, beta, y, m, dtype)
