"""Sparse storage formats as JAX pytrees.

Redesign of the reference's format-object hierarchy
(library/src/include/aoclsparse_mat_structures.hpp:148-724: csr/bsr/blk_csr/
tcsr/ell/ell_csr_hyb/coo). Instead of heap-owned C arrays inside a polymorphic
handle, each format is an immutable dataclass pytree of JAX arrays with static
shape metadata, so any op over it is jit/vmap/shard_map-compatible.

x86-specific formats (BLKCSR mask-compression, CSR-BR4, TCSR) are replaced by
the tile-padded internal form :class:`SELL` (sliced-ELL: rows padded per
8-row block to a 128-wide grid), which plays the role BLKCSR/BR4 play for AVX
(see SURVEY.md §7).

All index arrays are **zero-based** internally; IndexBase conversion happens
in create/export (core/matrix.py), exactly as the reference zero-bases in its
clean-CSR builder (aoclsparse_csr_util.hpp:764-945).
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .types import AoclSparseError, Status, index_dtype

__all__ = ["CSR", "CSC", "COO", "ELL", "DIA", "BSR", "SELL", "TCSR", "nnz_of"]


def _static(**kw):
    return field(metadata=dict(static=True), **kw)


def _as_idx(a):
    a = jnp.asarray(a)
    if not jnp.issubdtype(a.dtype, jnp.integer):
        raise AoclSparseError(Status.wrong_type, f"index array has dtype {a.dtype}")
    if a.dtype not in (jnp.dtype(jnp.int32), jnp.dtype(jnp.int64)):
        a = a.astype(index_dtype)
    return a


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row. Canonical compute format (docs/storage.rst:29-47).

    ptr: (m+1,) int — row start offsets; ind: (nnz,) int — column indices;
    val: (nnz,) — values. shape is static (m, n).
    """

    ptr: jax.Array
    ind: jax.Array
    val: jax.Array
    shape: Tuple[int, int] = _static(default=(0, 0))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.ind.shape[0])

    @property
    def dtype(self):
        return self.val.dtype

    def __post_init__(self):
        object.__setattr__(self, "ptr", _as_idx(self.ptr))
        object.__setattr__(self, "ind", _as_idx(self.ind))
        object.__setattr__(self, "val", jnp.asarray(self.val))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column: CSR of the transpose. The reference stores
    CSC as transposed CSR dispatched with doid::gt (aoclsparse_auxiliary.cpp:366);
    we keep an explicit type whose arrays are column-compressed."""

    ptr: jax.Array  # (n+1,)
    ind: jax.Array  # (nnz,) row indices
    val: jax.Array
    shape: Tuple[int, int] = _static(default=(0, 0))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.ind.shape[0])

    @property
    def dtype(self):
        return self.val.dtype

    def __post_init__(self):
        object.__setattr__(self, "ptr", _as_idx(self.ptr))
        object.__setattr__(self, "ind", _as_idx(self.ind))
        object.__setattr__(self, "val", jnp.asarray(self.val))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate format (docs/storage.rst COO)."""

    row: jax.Array  # (nnz,)
    col: jax.Array  # (nnz,)
    val: jax.Array  # (nnz,)
    shape: Tuple[int, int] = _static(default=(0, 0))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def dtype(self):
        return self.val.dtype

    def __post_init__(self):
        object.__setattr__(self, "row", _as_idx(self.row))
        object.__setattr__(self, "col", _as_idx(self.col))
        object.__setattr__(self, "val", jnp.asarray(self.val))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: every row padded to ``width``; padding entries carry col = -1
    and val = 0 (reference pads with -1 sentinel too, aoclsparse_convert.hpp).

    The (m, width) layout vectorizes SpMV as gather+multiply+row-sum — the
    analog of the reference's ELL AVX path.
    """

    ind: jax.Array  # (m, width) int, -1 padding
    val: jax.Array  # (m, width)
    width: int = _static(default=0)
    shape: Tuple[int, int] = _static(default=(0, 0))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.val.dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage: dist (ndiag,) diagonal offsets, val (ndiag, m) padded
    (docs/storage.rst DIA; csr2dia at conversion/aoclsparse_convert.cpp:506)."""

    dist: jax.Array  # (ndiag,) offsets (negative = below main)
    val: jax.Array  # (ndiag, m)
    shape: Tuple[int, int] = _static(default=(0, 0))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return int(self.dist.shape[0])

    @property
    def dtype(self):
        return self.val.dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block sparse row with dense (bs x bs) blocks (docs/storage.rst BSR;
    csr2bsr at conversion/aoclsparse_convert.cpp:592). bsrmv/bsrmm run the
    dense blocks as a batched matmul."""

    ptr: jax.Array  # (mb+1,)
    ind: jax.Array  # (nnzb,) block-column indices
    val: jax.Array  # (nnzb, bs, bs) — row-major inside blocks
    block_dim: int = _static(default=1)
    shape: Tuple[int, int] = _static(default=(0, 0))  # element-level shape

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def mb(self) -> int:
        return int(self.ptr.shape[0]) - 1

    @property
    def nnzb(self) -> int:
        return int(self.ind.shape[0])

    @property
    def dtype(self):
        return self.val.dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SELL:
    """Sliced-ELL, an internal execution format the planner builds.

    Rows are grouped into slices of ``slice_rows`` (a multiple of 8); each
    slice is padded to its own width rounded up to ``lane`` (128) columns.
    This plays the role of the reference's BLKCSR/CSR-BR4 AVX layouts
    (aoclsparse_analysis.cpp:35-385) with tile geometry instead of AVX
    registers.

    ind/val are stored flattened as (total_padded,) with slice offsets in
    ``slice_ptr`` ((nslices+1,), multiples of slice_rows*width_s).
    """

    slice_ptr: jax.Array  # (nslices+1,) offsets into ind/val
    slice_width: jax.Array  # (nslices,) per-slice padded width
    ind: jax.Array  # (total,) int, -1 padding
    val: jax.Array  # (total,)
    slice_rows: int = _static(default=8)
    shape: Tuple[int, int] = _static(default=(0, 0))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nslices(self) -> int:
        return int(self.slice_width.shape[0])

    @property
    def dtype(self):
        return self.val.dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TCSR:
    """Triangular CSR: both triangles stored CSR-style with the diagonal
    duplicated in each (reference tcsr class,
    aoclsparse_mat_structures.hpp:434-456; public ingestion API
    aoclsparse_create_?tcsr, include/aoclsparse_auxiliary.h:516-598).
    Square, full non-zero diagonal required. L part = strictly-lower entries
    then D per row; U part = D then strictly-upper entries per row."""

    ptr_L: jax.Array  # (m+1,)
    ind_L: jax.Array  # (nnz_lower + m,)
    val_L: jax.Array
    ptr_U: jax.Array  # (m+1,)
    ind_U: jax.Array  # (nnz_upper + m,)
    val_U: jax.Array
    shape: Tuple[int, int] = _static(default=(0, 0))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        # diagonal stored in both triangles, counted once
        return int(self.ind_L.shape[0]) + int(self.ind_U.shape[0]) - self.m

    @property
    def dtype(self):
        return self.val_L.dtype


def nnz_of(A) -> int:
    if isinstance(A, (CSR, CSC, COO)):
        return A.nnz
    if isinstance(A, TCSR):
        return A.nnz
    if isinstance(A, ELL):
        return int(np.sum(np.asarray(A.ind) >= 0))
    if isinstance(A, BSR):
        return A.nnzb * A.block_dim * A.block_dim
    if isinstance(A, DIA):
        return int(np.count_nonzero(np.asarray(A.val)))
    if isinstance(A, SELL):
        return int(np.sum(np.asarray(A.ind) >= 0))
    raise AoclSparseError(Status.wrong_type, f"nnz_of: unsupported {type(A)}")
