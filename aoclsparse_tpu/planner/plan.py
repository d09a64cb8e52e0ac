"""Trace-time planner: the JAX redesign of hint/optimize.

Reference analogs:
- clean-CSR builder `aoclsparse_csr_csc_optimize` (analysis/aoclsparse_csr_util.hpp:764-945):
  validate, sort, detect/fill diagonal, build idiag/iurow triangle splits.
- DOID matrix copies `aoclsparse_matrix_transform` (csr_util.hpp:516-759):
  explicit general-form / transposed / conjugated copies cached per doid.
- SpMV auto-format selection `aoclsparse_optimize_mv` (analysis/aoclsparse_analysis.cpp:35-385):
  nnz/row statistics choose BLKCSR / ELLT-HYB / BR4 there; here the same
  statistics choose segsum / padded-ELL / hybrid.

Everything data-dependent-shape (sorting, padding maps, triangle splits) runs
host-side once per structure; every *value* path is a jitted gather so
`update_values` refreshes any plan with one device pass (the analog of the
reference's value-only recompute, functions.h:2184-2201).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.descr import MatrixDescriptor
from ..core.formats import CSR
from ..core.types import (
    AoclSparseError,
    DiagType,
    FillMode,
    MatrixType,
    Operation,
    Status,
)
from ..core.matrix import SparseMatrix

__all__ = [
    "CleanCSR",
    "EffectiveCSR",
    "ExecForm",
    "Plan",
    "build_clean_csr",
    "build_effective_csr",
    "choose_mv_format",
    "optimize",
    "get_plan",
]

LANE = 128
SUBLANE = 8


# ---------------------------------------------------------------------------
# clean CSR (validated, sorted, zero-based, triangle-split)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CleanCSR:
    """Sorted zero-based CSR + triangle split pointers.

    idiag[i] = offset of the diagonal entry of row i (or the position where it
    would be, if missing); iurow[i] = offset of the first strictly-upper entry.
    Mirrors aoclsparse_csr_csc_indices (csr_util.cpp:389).
    """

    ptr: np.ndarray  # (m+1,) int32 host copy (planner uses it for structure)
    ind: np.ndarray  # (nnz,) int32 host copy
    val: jax.Array  # (nnz,) device values (sorted order)
    perm: np.ndarray  # (nnz_in,) int64: sorted-order source positions
    idiag: np.ndarray  # (m,)
    iurow: np.ndarray  # (m,)
    has_diag: np.ndarray  # (m,) bool: row i stores its diagonal entry
    fulldiag: bool
    shape: Tuple[int, int]
    #: set when the input had duplicate (row, col) entries: maps each sorted
    #: input entry to its merged slot (values accumulate, matching the dense
    #: oracle's duplicate-summing semantics)
    merge_seg: Optional[np.ndarray] = None
    #: cached host copy of `val` (see host_val); None = not materialized
    val_host: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.ind.size)

    def host_val(self) -> np.ndarray:
        """Host copy of the sorted values, cached: host engines (mv KID 11,
        trsv KID 2) must not pay a device->host fetch per form build when
        one fetch (or a numpy update_values, which fills the cache for
        free) can serve them all."""
        if self.val_host is None:
            self.val_host = np.asarray(self.val)
        return self.val_host

    def refresh(self, new_val, host_input=None) -> None:
        self.val_host = None
        if host_input is None and isinstance(new_val, np.ndarray):
            host_input = new_val
        if host_input is not None:
            # numpy update: keep the host twin current without any device
            # round-trip (host engines rebuild from it)
            v_h = np.asarray(host_input).reshape(-1)[self.perm]
            if self.merge_seg is not None:
                u = np.zeros(self.nnz, dtype=v_h.dtype)
                np.add.at(u, self.merge_seg, v_h)
                v_h = u
            self.val_host = v_h
        v = jnp.asarray(new_val)[jnp.asarray(self.perm)]
        if self.merge_seg is not None:
            v = jnp.zeros((self.nnz,), dtype=v.dtype).at[jnp.asarray(self.merge_seg)].add(v)
        self.val = v


def _triangle_split(m, ptr, ind_s, rows):
    """Vectorized idiag/iurow/has_diag over a sorted CSR
    (aoclsparse_csr_csc_indices analog, csr_util.cpp:389)."""
    ptr64 = np.asarray(ptr, dtype=np.int64)
    idiag = np.empty(m, dtype=np.int64)
    iurow = np.empty(m, dtype=np.int64)
    has_diag = np.zeros(m, dtype=bool)
    if ind_s.size == 0 or m == 0:
        idiag[:] = ptr64[:-1]
        iurow[:] = ptr64[:-1]
        return idiag, iurow, has_diag
    below = (ind_s < rows).astype(np.int64)  # strictly-lower entries
    on = ind_s == rows
    # per-row counts via reduceat (empty rows handled by diff==0 rule)
    lens = np.diff(ptr64)
    csum_below = np.concatenate([[0], np.cumsum(below)])
    csum_on = np.concatenate([[0], np.cumsum(on.astype(np.int64))])
    nbelow = csum_below[ptr64[1:]] - csum_below[ptr64[:-1]]
    non = csum_on[ptr64[1:]] - csum_on[ptr64[:-1]]
    idiag[:] = ptr64[:-1] + nbelow
    has_diag[:] = non > 0
    iurow[:] = idiag + non
    return idiag, iurow, has_diag


def _ranges_concat(starts, stops):
    """Vectorized concatenate([arange(s, e) for s, e in zip(starts, stops)])."""
    starts = np.asarray(starts, dtype=np.int64)
    stops = np.asarray(stops, dtype=np.int64)
    lens = stops - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), lens
    firsts = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=firsts[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(firsts, lens)
    return np.repeat(starts, lens) + within, lens


def build_clean_csr(A: CSR) -> CleanCSR:
    """Validate + sort + split (aoclsparse_csr_csc_optimize analog). Unlike the
    reference we do NOT inject missing diagonal zeros into the general matrix;
    triangle views inject unit/zero diagonals lazily in build_effective_csr."""
    ptr = np.asarray(A.ptr)
    ind = np.asarray(A.ind)
    m, n = A.shape
    lens = np.diff(ptr)
    if np.any(lens < 0) or (ind.size and (ind.min() < 0 or ind.max() >= n)):
        raise AoclSparseError(Status.invalid_index_value, "corrupt CSR structure")
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    # fast sortedness probe before paying an O(nnz log nnz) lexsort: within
    # rows, NON-decreasing suffices — for equal (row, col) keys any stable
    # order is valid (identity included) and the duplicate-merge pass below
    # sums them regardless. The old STRICT (>) probe sent every
    # sorted-with-duplicates operand through a full lexsort (~30 s at 16.7M
    # nnz on this throttled host; measured in the r4 ILU prep probe).
    if ind.size > 1:
        nondec = ind[1:] >= ind[:-1]
        row_start = rows[1:] != rows[:-1]
        sorted_already = bool(np.all(nondec | row_start))
    else:
        sorted_already = True
    perm = (
        np.arange(ind.size, dtype=np.int64) if sorted_already else np.lexsort((ind, rows))
    )
    ind_s = ind[perm].astype(np.int32)
    val = A.val if sorted_already else A.val[jnp.asarray(perm)]
    # merge duplicate (row, col) entries by summation (dense-oracle semantics;
    # the scatter-based execution forms require unique slots)
    merge_seg = None
    if ind_s.size > 1:
        same = (ind_s[1:] == ind_s[:-1]) & (rows[perm][1:] == rows[perm][:-1])
        if same.any():
            first = np.concatenate([[True], ~same])
            merge_seg = (np.cumsum(first) - 1).astype(np.int64)
            nuniq = int(merge_seg[-1]) + 1
            val = jnp.zeros((nuniq,), dtype=val.dtype).at[jnp.asarray(merge_seg)].add(val)
            rows_u = rows[perm][first]
            ind_s = ind_s[first]
            lens_u = np.bincount(rows_u, minlength=m).astype(np.int64)
            ptr = np.concatenate([[0], np.cumsum(lens_u)])
            rows = rows_u
            lens = lens_u
    # triangle split (vectorized): idiag = first k in row with ind >= i
    idiag, iurow, has_diag = _triangle_split(m, ptr, ind_s, rows)
    return CleanCSR(
        ptr=ptr.astype(np.int32),
        ind=ind_s,
        val=jnp.asarray(val),
        perm=perm.astype(np.int64),
        idiag=idiag,
        iurow=iurow,
        has_diag=has_diag,
        fulldiag=bool(has_diag[: min(m, n)].all()) if m and n else True,
        shape=(m, n),
        merge_seg=merge_seg,
    )


# ---------------------------------------------------------------------------
# effective CSR for (descriptor, operation) — the DOID copy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EffectiveCSR:
    """CSR of the matrix the (descr, op) pair denotes, expressed as a
    structure + a value-map over the clean CSR's values:

        val_out = conj? conj(v) : v,  v = src>=0 ? clean.val[src] : const_val

    so refresh-after-update_values is a single jitted gather
    (aoclsparse_matrix_transform analog, csr_util.hpp:516-759)."""

    ptr: np.ndarray
    ind: np.ndarray
    src: np.ndarray  # (nnz,) int64, -1 => const_val
    conj: bool
    const_val: float
    shape: Tuple[int, int]
    val: jax.Array = None  # materialized values

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.ind.size)

    def materialize(self, clean_val: jax.Array) -> None:
        self.val = _gather_vals(
            clean_val, jnp.asarray(self.src), self.conj, self.const_val
        )


@jax.jit
def _gather_vals_jit(val, src, const):
    v = jnp.where(src >= 0, val[jnp.clip(src, 0)], jnp.asarray(const, dtype=val.dtype))
    return v


def _gather_vals(val, src, conj: bool, const):
    v = _gather_vals_jit(val, src, const)
    return jnp.conj(v) if conj and jnp.iscomplexobj(v) else v


def _transpose_structure(ptr, ind, src, m, n):
    """Transpose a (structure, src-map) pair host-side."""
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    order = np.lexsort((rows, ind))
    tptr = np.zeros(n + 1, dtype=np.int64)
    if ind.size:
        np.add.at(tptr, ind.astype(np.int64) + 1, 1)
    tptr = np.cumsum(tptr)
    return (
        tptr.astype(np.int32),
        rows[order].astype(np.int32),
        src[order],
    )


def build_effective_csr(
    clean: CleanCSR, descr: MatrixDescriptor, op: Operation, dtype=None
) -> EffectiveCSR:
    """Build the general-form CSR for (descr, op) over the clean structure.

    symmetric/hermitian -> mirrored general copy; triangular -> triangle
    extraction honoring diag_type; op -> structural transpose (+conj).
    Matches the descriptor semantics of aoclsparse_mv.cpp:52-176 and the
    copies of aoclsparse_matrix_transform."""
    descr.validate()
    op = Operation(op)
    m, n = clean.shape
    ptr, ind = clean.ptr, clean.ind
    mtype = MatrixType(descr.type)
    lower = FillMode(descr.fill_mode) == FillMode.lower
    dt = DiagType(descr.diag_type)
    src_all = np.arange(ind.size, dtype=np.int64)
    conj_whole = False

    if mtype == MatrixType.general:
        eptr, eind, esrc = ptr, ind, src_all
        const = 0.0
        if op == Operation.none:
            pass
        else:
            eptr, eind, esrc = _transpose_structure(eptr, eind, esrc, m, n)
            m, n = n, m
            conj_whole = op == Operation.conjugate_transpose
        out = EffectiveCSR(eptr, eind, esrc, conj_whole, const, (m, n))
        out.materialize(clean.val)
        return out

    if m != n:
        raise AoclSparseError(Status.invalid_size, f"{mtype.name} requires square matrix")

    # triangle extraction over the split pointers
    lo_r = clean.ptr[:-1].astype(np.int64)
    hi_r = clean.ptr[1:].astype(np.int64)
    if lower:
        tri_lo, tri_hi = lo_r, clean.iurow  # L including diagonal
        strict_lo, strict_hi = lo_r, clean.idiag  # strictly-L
    else:
        tri_lo, tri_hi = clean.idiag, hi_r  # U including diagonal
        strict_lo, strict_hi = clean.iurow, hi_r  # strictly-U

    def _extract(starts, stops):
        src, lens = _ranges_concat(starts, stops)
        eptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        return eptr, ind[src].astype(np.int32), src

    if mtype == MatrixType.triangular:
        if dt == DiagType.non_unit:
            eptr, eind, esrc = _extract(tri_lo, tri_hi)
        else:
            # strict triangle; unit diag injects const 1.0 entries
            eptr, eind, esrc = _extract(strict_lo, strict_hi)
            if dt == DiagType.unit:
                eptr, eind, esrc = _inject_diag(eptr, eind, esrc, m, lower)
        const = 1.0
        if op != Operation.none:
            eptr, eind, esrc = _transpose_structure(eptr, eind, esrc, m, n)
            conj_whole = op == Operation.conjugate_transpose
        out = EffectiveCSR(eptr, eind, esrc, conj_whole, const, (m, n))
        out.materialize(clean.val)
        return out

    # symmetric / hermitian: tri (with diag) + mirrored strict triangle.
    # For hermitian the mirror is conjugated; for symmetric plain. op handling:
    #   sym: none/transpose identical; conj-transpose = conj(A).
    #   herm: none/conj-transpose identical; transpose = conj(A).
    tptr, tind, tsrc = _extract(tri_lo, tri_hi)
    sptr, sind, ssrc = _extract(strict_lo, strict_hi)
    mptr, mind, msrc = _transpose_structure(sptr, sind, ssrc, m, n)
    # merge rows of (t) and (mirror), vectorized via global (row, col) lexsort
    trows = np.repeat(np.arange(m, dtype=np.int64), np.diff(tptr.astype(np.int64)))
    mrows = np.repeat(np.arange(m, dtype=np.int64), np.diff(mptr.astype(np.int64)))
    allrows = np.concatenate([trows, mrows])
    allind = np.concatenate([tind.astype(np.int64), mind.astype(np.int64)])
    allsrc = np.concatenate([tsrc, msrc])
    allmir = np.concatenate([np.zeros(trows.size, bool), np.ones(mrows.size, bool)])
    order = np.lexsort((allind, allrows))
    tot = order.size
    eind = allind[order].astype(np.int32)
    esrc = allsrc[order]
    mirror_mask = allmir[order]
    lens = np.bincount(allrows, minlength=m).astype(np.int64)
    eptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    herm = mtype == MatrixType.hermitian
    conj_all = (mtype == MatrixType.symmetric and op == Operation.conjugate_transpose) or (
        herm and op == Operation.transpose
    )
    # conjugation pattern over the merged structure:
    #   herm, op in {none, conj_transpose} -> conjugate MIRROR entries
    #   sym + conj_transpose              -> conjugate ALL
    #   herm + transpose (= conj(A))      -> conjugate NON-mirror entries
    if herm and not conj_all:
        conj_mode = "mirror"
    elif conj_all and not herm:
        conj_mode = "all"
    elif conj_all and herm:
        conj_mode = "nonmirror"
    else:
        conj_mode = "none"
    out = EffectiveCSR(eptr, eind, esrc, False, 0.0, (m, n))
    out._mirror_mask = mirror_mask  # type: ignore[attr-defined]
    out._conj_mode = conj_mode  # type: ignore[attr-defined]
    if herm:
        out._herm_diag_mask = eind == np.arange(m).repeat(  # type: ignore[attr-defined]
            np.diff(eptr.astype(np.int64))
        )
    out.val = _apply_conj_pattern(out, _gather_vals_jit(clean.val, jnp.asarray(esrc), 0.0))
    return out


def _apply_conj_pattern(eff: EffectiveCSR, v):
    """Apply the stored conjugation pattern + hermitian-diagonal realification
    (shared by build and refresh so update_values stays consistent)."""
    if not jnp.iscomplexobj(v):
        return v
    mode = getattr(eff, "_conj_mode", "all" if eff.conj else "none")
    mm = getattr(eff, "_mirror_mask", None)
    if mode == "all":
        v = jnp.conj(v)
    elif mode == "mirror" and mm is not None:
        v = jnp.where(jnp.asarray(mm), jnp.conj(v), v)
    elif mode == "nonmirror" and mm is not None:
        v = jnp.where(jnp.asarray(mm), v, jnp.conj(v))
    dm = getattr(eff, "_herm_diag_mask", None)
    if dm is not None:
        v = jnp.where(jnp.asarray(dm), jnp.real(v).astype(v.dtype), v)
    return v


def _inject_diag(eptr, eind, esrc, m, lower):
    """Insert a const-valued diagonal entry into every row (unit diag).
    Vectorized: concatenate the diagonal entries then (row, col)-lexsort."""
    lens0 = np.diff(eptr.astype(np.int64))
    rows0 = np.repeat(np.arange(m, dtype=np.int64), lens0)
    allrows = np.concatenate([rows0, np.arange(m, dtype=np.int64)])
    allind = np.concatenate([eind.astype(np.int64), np.arange(m, dtype=np.int64)])
    allsrc = np.concatenate([esrc, np.full(m, -1, dtype=np.int64)])
    order = np.lexsort((allind, allrows))
    nptr = np.concatenate([[0], np.cumsum(lens0 + 1)]).astype(np.int32)
    return nptr, allind[order].astype(np.int32), allsrc[order]


# ---------------------------------------------------------------------------
# execution-format selection (aoclsparse_optimize_mv analog)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecForm:
    """Device-ready SpMV operand in the chosen format. All index arrays are
    device jnp arrays; `*_src` keep host gather maps for value refresh."""

    kind: str  # "segsum" | "ell" | "ellhyb" | "bwd"
    m: int
    n: int
    # segsum
    ind: Optional[jax.Array] = None
    val: Optional[jax.Array] = None
    row_ids: Optional[jax.Array] = None
    # ell
    ell_ind: Optional[jax.Array] = None
    ell_val: Optional[jax.Array] = None
    ell_src: Optional[np.ndarray] = None  # (m, w) int64 into effective val, -1 pad
    # spill (ellhyb)
    sp_ind: Optional[jax.Array] = None
    sp_val: Optional[jax.Array] = None
    sp_rows: Optional[jax.Array] = None
    sp_src: Optional[np.ndarray] = None
    # bwd (banded-window dense; see kernels/xla/spmv.py spmv_bwd)
    bwd_val: Optional[jax.Array] = None  # (ngrp, G, W)
    bwd_dest: Optional[np.ndarray] = None  # (kept,) flat positions into bwd_val
    bwd_srcpos: Optional[np.ndarray] = None  # (kept,) positions into eff val (None = all)
    bwd_W: int = 0
    bwd_base8: int = 0
    bwd_padL: int = 0
    bwd_n_pad: int = 0
    bwd_G: int = 8
    bwd_rel: int = 0  # bwdg: group-relative window start (spmv_bwdg)
    # diag (scan-over-diagonals; see kernels/xla/spmv.py spmv_diag_scan)
    dia_val: Optional[jax.Array] = None  # (ndiag, m)
    dia_offs: Optional[jax.Array] = None  # (ndiag,) int32
    dia_dest: Optional[np.ndarray] = None  # (nnzE,) flat positions into dia_val
    dia_offs_static: Optional[Tuple] = None  # static copy for unrolled kernel
    dia_L: int = 0
    dia_n_pad: int = 0
    # gen (RCM-permuted band + hub slab + spill; see kernels/xla/spmv.py
    # spmv_gen): band/spill fields above are in PERMUTED coordinates
    gen_perm: Optional[jax.Array] = None  # (nblk,) int32 block perm: xp blocks
    gen_out: Optional[jax.Array] = None  # (nblk,) int32 inverse block perm
    gen_flip: Optional[jax.Array] = None  # (nblk,) bool: reverse block's elements
    gen_B: int = 128  # permutation block granularity
    gen_m_pad: int = 0  # permuted/padded dimension (nblk * B)
    hub_cols: Optional[jax.Array] = None  # (k,) int32 ORIGINAL col ids
    hub_slab: Optional[jax.Array] = None  # (m_pad, k) dense, permuted rows
    hub_dest: Optional[np.ndarray] = None  # flat positions into hub_slab
    hub_src: Optional[np.ndarray] = None  # positions into eff val
    hubr_rows: Optional[jax.Array] = None  # (kr,) int32 PERMUTED row positions
    hubr_slab: Optional[jax.Array] = None  # (kr, m_pad) dense, permuted cols
    hubr_dest: Optional[np.ndarray] = None  # flat positions into hubr_slab
    hubr_src: Optional[np.ndarray] = None  # positions into eff val
    # sell (flattened sliced-ELL; reuses ind/val/row_ids device fields)
    sell_dest: Optional[np.ndarray] = None  # (nnzE,) flat positions into padded val
    sell_total: int = 0  # padded buffer length
    # host (numpy CSR for the latency-bound host engine, kernels/host.py):
    # everything stays host-resident; never the default, never traced
    host_ptr: Optional[np.ndarray] = None
    host_ind: Optional[np.ndarray] = None
    host_val: Optional[np.ndarray] = None
    def host_values(self) -> np.ndarray:
        """Lazy host value vector: refresh must not pay a device->host fetch
        for a form that may never run again (update_values in a serving
        loop); the fetch lands on the first host-engine call after the
        refresh instead."""
        if self.host_val is None:
            self.host_val = np.asarray(self._host_pending)
            self._host_pending = None
        return self.host_val

    def refresh(self, eff_val: jax.Array) -> None:
        self._bwd_val_bf16 = None  # derived bf16 operand (mixed-precision path)
        self._dia_val_bf16 = None  # derived bf16 diag operand (mm KID 7 mixed path)
        self._sharded_band = None  # mesh-sharded band copies (parallel/spmv.py)
        if self.kind == "host":
            self.host_val = None  # materialized lazily, see host_values
            self._host_pending = eff_val
        elif self.kind == "segsum":
            self.val = eff_val
        elif self.kind == "sell":
            vh = np.asarray(eff_val)
            buf = np.zeros(self.sell_total, dtype=vh.dtype)
            buf[self.sell_dest] = vh
            self.val = jnp.asarray(buf)
        elif self.kind == "diag":
            vh = np.asarray(eff_val)
            ndiag = int(self.dia_offs.shape[0])
            buf = np.zeros(ndiag * self.m, dtype=vh.dtype)
            buf[self.dia_dest] = vh
            self.dia_val = jnp.asarray(buf.reshape(ndiag, self.m))
        elif self.kind in ("bwd", "bwdg", "gen"):
            # host-side scatter + device_put: a dense int64 source map
            # would cost 8x the operand itself in host RAM
            rows_dim = self.gen_m_pad if self.kind == "gen" else self.m
            ngrp = -(-rows_dim // self.bwd_G)
            vh = np.asarray(eff_val)
            buf = np.zeros(ngrp * self.bwd_G * self.bwd_W, dtype=vh.dtype)
            buf[self.bwd_dest] = vh if self.bwd_srcpos is None else vh[self.bwd_srcpos]
            self.bwd_val = jnp.asarray(buf.reshape(ngrp, self.bwd_G, self.bwd_W))
            if self.sp_src is not None and self.sp_src.size:
                self.sp_val = jnp.asarray(vh[self.sp_src])
            if self.kind == "gen" and self.hub_src is not None:
                k = int(self.hub_cols.shape[0])
                slab = np.zeros(self.gen_m_pad * k, dtype=vh.dtype)
                slab[self.hub_dest] = vh[self.hub_src]
                self.hub_slab = jnp.asarray(slab.reshape(self.gen_m_pad, k))
            if self.kind == "gen" and self.hubr_src is not None:
                kr = int(self.hubr_rows.shape[0])
                slab = np.zeros(kr * self.gen_m_pad, dtype=vh.dtype)
                slab[self.hubr_dest] = vh[self.hubr_src]
                self.hubr_slab = jnp.asarray(slab.reshape(kr, self.gen_m_pad))
        else:
            src = jnp.asarray(self.ell_src)
            v = jnp.where(
                src >= 0,
                eff_val[jnp.clip(src, 0)],
                jnp.zeros((), dtype=eff_val.dtype),
            )
            self.ell_val = v
            if self.kind == "ellhyb" and self.sp_src is not None and self.sp_src.size:
                self.sp_val = eff_val[jnp.asarray(self.sp_src)]


#: widest band window the gen composite and the band SpGEMM accept
BWD_MAX_W = 4096


def choose_mv_format(eff: EffectiveCSR) -> str:
    """Execution-format selection — the re-derivation of the reference's
    nnz/row heuristics (aoclsparse_optimize_mv, aoclsparse_analysis.cpp:71-213)
    over the gather forms (segsum / padded ELL / ELL + spill), which every
    consumer can dispatch (mv, mm, distributed paths). The dense
    band forms (bwd, diag, gen, bwdg) are reached by an explicit KID, kind
    or autotune pin: on the GPU the gather forms are the default (PERF.md
    records the form comparison that keeps them)."""
    m = eff.m
    if m == 0 or eff.nnz == 0:
        return "segsum"
    lens = np.diff(eff.ptr.astype(np.int64))
    w_max = int(lens.max())
    mean = float(lens.mean())
    if w_max == 0:
        return "segsum"
    fill = eff.nnz / float(m * w_max)
    if fill >= 0.5 or w_max <= 2 * max(mean, 1.0):
        return "ell"
    # long-tail distribution: hybrid with width covering ~p75 of rows
    return "ellhyb"


def _build_ell_map(eff: EffectiveCSR, width: int):
    """(m, width) gather map into effective values; -1 = padding."""
    ptr = eff.ptr.astype(np.int64)
    lens = np.diff(ptr)
    m = eff.m
    cols = np.arange(width)[None, :]
    valid = cols < np.minimum(lens, width)[:, None]
    offs = ptr[:-1, None] + cols
    src = np.where(valid, offs, -1)
    ind = np.where(valid, eff.ind[np.clip(src, 0, max(eff.nnz - 1, 0))], -1).astype(np.int32)
    return src, ind, valid


def _build_bwd_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    src: Optional[np.ndarray],
    m: int,
    n: int,
    G: int = 8,
    kind: str = "bwd",
    peel_pcts: Tuple[float, float] = (0.25, 99.75),
    spill_budget_frac: float = 0.01,
    max_w: Optional[int] = None,
    window: Optional[Tuple[int, int]] = None,
):
    """Banded-window geometry from a (row, col)-sorted COO triple.

    `src` maps each entry to its position in the effective value vector
    (None = identity). Returns the ExecForm WITHOUT values (caller must
    .refresh(eff.val)), or None when max_w is given and even the peeled
    window exceeds it.

    Edge peel: entries outside the [peel_pcts] percentile window of the
    group-relative column offsets spill to a COO segment-sum instead of
    paying dense width for everyone (the budget stays a small fraction of
    nnz)."""
    ngrp = -(-m // G)
    blk = rows // G
    rel = cols - G * blk
    if rel.size == 0:
        W, rel_lo = G, 0
        spill_mask = np.zeros(0, dtype=bool)
    elif window is not None:
        # caller pre-selected the (rel_lo, W) window (cost-model ladder)
        rel_lo, W = window
        spill_mask = (rel < rel_lo) | (rel >= rel_lo + W)
    else:
        rel_lo = (int(rel.min()) // G) * G
        W = -(-(int(rel.max()) - rel_lo + 1) // 8) * 8
        spill_mask = None
        if kind in ("bwd", "gen") and rel.size > 4096:
            lo_c = (int(np.percentile(rel, peel_pcts[0])) // G) * G
            hi_c = int(np.percentile(rel, peel_pcts[1]))
            W_core = -(-(hi_c - lo_c + 1) // 8) * 8
            outside = (rel < lo_c) | (rel >= lo_c + W_core)
            n_out = int(outside.sum())
            if W_core <= W - 16 and n_out <= max(1024, int(rel.size * spill_budget_frac)):
                spill_mask = outside
                W, rel_lo = W_core, lo_c
        if spill_mask is None:
            spill_mask = np.zeros(rel.size, dtype=bool)
    if max_w is not None and W > max_w:
        return None
    keep = ~spill_mask
    t = (rel - rel_lo)[keep]  # position within the group's window
    dest = ((blk * G + rows % G)[keep]) * W + t  # flat scatter positions
    # padded x geometry: window of group g starts at column G*g + rel_lo;
    # after left-padding by L the start is G*(g + base) with L mult of G
    L = max(0, -rel_lo)
    base = (rel_lo + L) // G
    nslice = -(-W // G)
    need = G * (base + nslice - 1 + ngrp)  # last slice end in padded coords
    n_pad = max(-(-(L + n) // G) * G, need)
    spilled = bool(spill_mask.any())
    identity_src = src is None
    kept_src = None if (identity_src and not spilled) else (
        np.nonzero(keep)[0] if identity_src else src[keep]
    )
    return ExecForm(
        kind=kind,
        m=m,
        n=n,
        bwd_dest=dest,
        bwd_srcpos=kept_src,
        bwd_W=int(W),
        bwd_base8=int(base),
        bwd_padL=int(L),
        bwd_n_pad=int(n_pad),
        bwd_G=G,
        bwd_rel=int(rel_lo),
        sp_src=(np.nonzero(spill_mask)[0] if identity_src else src[spill_mask])
        if spilled
        else None,
        sp_ind=jnp.asarray(cols[spill_mask].astype(np.int32)) if spilled else None,
        sp_rows=jnp.asarray(rows[spill_mask].astype(np.int32)) if spilled else None,
    )


def _build_bwd(eff: EffectiveCSR, G: int = 8, kind: str = "bwd") -> ExecForm:
    """Materialize the G-row-group banded-window dense operand
    (see kernels/xla/spmv.py spmv_bwd and spmm.py spmm_bwd)."""
    m, n = eff.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    cols = eff.ind.astype(np.int64)
    form = _build_bwd_coo(rows, cols, None, m, n, G=G, kind=kind)
    form.refresh(eff.val)
    return form


#: gen-form tuning. The rates below are the composite's cost-model weights
#: (relative cost of a dense stream, a scalar gather and a panel gather);
#: they are not calibrated on the GPU (PERF.md, open questions)
GEN_B = 128  # block-permutation granularity (panel-gather width)
GEN_MAX_HUB = 512  # dense hub-slab width cap
GEN_HUB_MIN = 32  # min entries for a column to be hub-eligible
GEN_MEM_CAP = 6e9  # band operand byte cap
GEN_SPILL_FRAC = 0.30  # max fraction of nnz routed to the COO spill; the
# cost model (n_spill * GEN_GATHER_NS vs GEN_MARGIN * fallback) is the real
# gate — this cap only keeps the ladder from degenerate all-spill windows,
# and the post-pass promotes heavy spill rows/cols into dense slabs anyway
GEN_STREAM_BPS = 250e9  # dense-stream rate
GEN_GATHER_NS = 13e-9  # per-element irregular gather cost (ell/segsum rate)
GEN_PANEL_NS = 0.33e-9  # per-element 128-wide panel-gather cost
GEN_MARGIN = 0.6  # accept gen only when est. time <= margin * fallback


def _gen_cost_model(m_pad, W, B, k_hub, n_spill, itemsize):
    """Estimated per-call time of the gen composite (seconds)."""
    band = m_pad * W * itemsize / GEN_STREAM_BPS
    hub = k_hub * m_pad * itemsize / GEN_STREAM_BPS
    perm = 2 * m_pad * (GEN_PANEL_NS if B >= 8 else GEN_GATHER_NS)
    return band + hub + perm + n_spill * GEN_GATHER_NS


def _block_flips(pb_r, pb_c, pos_r, pos_c, nblk: int, B: int):
    """Per-block orientation (reverse the B elements of a block, or not)
    minimizing the |rel| mass of entries that cross CONSECUTIVE permuted
    blocks. Returns a (nblk,) bool array by permuted position, or None.

    Why: block-granular RCM orders coupled blocks adjacently, but keeps
    each block's internal element order. When the chain runs opposite to
    the original index direction (Cuthill-McKee's final Reverse does
    exactly this), an entry coupling the END of one original block to the
    START of the next lands at permuted offset ~±2B instead of ~±1 — on a
    circuit/FEM-class matrix that is nearly ALL of the window spill
    (measured ~6% of nnz at B=128). Choosing a per-block reversal turns
    those crossings back into near-diagonal entries at zero traffic cost
    (the runtime flip is a dense where-reverse on the already-permuted x).
    Exact for chain-structured quotient graphs (the common case after
    RCM); a no-worse heuristic otherwise. Solved by an O(nblk) two-state
    chain DP over boundary crossing costs."""
    d = pb_c - pb_r
    fwd = d == 1  # row in block p, col in block p+1 (boundary p)
    bwd = d == -1  # col in block p, row in block p+1 (boundary p)
    if not (fwd.any() or bwd.any()) or nblk < 2:
        return None
    # cost[p, fp, fq]: |rel| mass crossing boundary p under orientations
    # (fp, fq) of permuted blocks (p, p+1); |rel| saturates at 4B (beyond
    # the window either way)
    cost = np.zeros((nblk - 1, 2, 2), dtype=np.float64)
    cap = 4.0 * B
    for fp in (0, 1):
        for fq in (0, 1):
            if fwd.any():
                pr = (B - 1 - pos_r[fwd]) if fp else pos_r[fwd]
                pc = (B - 1 - pos_c[fwd]) if fq else pos_c[fwd]
                np.add.at(
                    cost[:, fp, fq], pb_r[fwd], np.minimum(np.abs(B + pc - pr), cap)
                )
            if bwd.any():
                pc2 = (B - 1 - pos_c[bwd]) if fp else pos_c[bwd]
                pr2 = (B - 1 - pos_r[bwd]) if fq else pos_r[bwd]
                np.add.at(
                    cost[:, fp, fq], pb_c[bwd], np.minimum(np.abs(pc2 - pr2 - B), cap)
                )
    back = np.zeros((nblk, 2), dtype=np.int8)
    prev = np.zeros(2)
    for p in range(nblk - 1):
        cand = prev[:, None] + cost[p]  # (fp, fq)
        back[p + 1] = np.argmin(cand, axis=0)  # ties -> 0 (prefer no flip)
        prev = cand.min(axis=0)
    fP = np.zeros(nblk, dtype=bool)
    f = int(np.argmin(prev))
    for p in range(nblk - 1, 0, -1):
        fP[p] = bool(f)
        f = int(back[p][f])
    fP[0] = bool(f)
    return fP if fP.any() else None


def _build_gen(eff: EffectiveCSR) -> Optional[ExecForm]:
    """General-sparsity band execution form (mv KID 7): hub-column
    extraction + block-granular RCM + banded window + COO spill (see
    spmv_gen).

    General structure is *made* band-compressible: dense columns (power-law
    hubs) leave for a dense slab, the remainder is reordered by reverse
    Cuthill-McKee at B=128 block granularity (runtime x/y permutes are then
    panel gathers, not scalar gathers), and what still falls outside the
    peeled window spills to a bounded segment-sum. Returns None when the
    resulting band would still blow past the traffic caps (caller falls
    back to the gather forms)."""
    from .. import native

    m, n = eff.shape
    if m != n or eff.nnz == 0 or m < 2 * GEN_B:
        return None
    B = GEN_B
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    cols = eff.ind.astype(np.int64)
    idx = np.arange(cols.size, dtype=np.int64)
    # --- hub columns: dense columns ruin any bandwidth ordering; peel them
    # into a dense (m_pad, k) slab (blowup m/cnt each, capped by budget)
    cnt = np.bincount(cols, minlength=n)
    cand = np.nonzero(cnt >= max(GEN_HUB_MIN, m // 1024))[0]
    if cand.size:
        cand = cand[np.argsort(cnt[cand])[::-1]]
        budget = max(8.0 * eff.nnz, 4.0 * m)  # total slab entries
        take = np.cumsum(np.full(cand.size, float(m))) <= budget
        hub = np.sort(cand[take][:GEN_MAX_HUB])
    else:
        hub = cand
    has_hub = hub.size > 0
    if has_hub:
        hub_mark = np.zeros(n, dtype=bool)
        hub_mark[hub] = True
        is_hub = hub_mark[cols]
    else:
        is_hub = np.zeros(cols.size, dtype=bool)
    r2, c2, s2 = rows[~is_hub], cols[~is_hub], idx[~is_hub]
    # --- hub ROWS: dense rows (hub columns of the transpose) equally ruin
    # any bandwidth ordering; extract into a (kr, m_pad) slab against the
    # permuted x, results scattered at kr positions of yp
    rcnt = np.bincount(r2, minlength=m)
    rcand = np.nonzero(rcnt >= max(GEN_HUB_MIN, m // 1024))[0]
    if rcand.size:
        rcand = rcand[np.argsort(rcnt[rcand])[::-1]]
        budget = max(8.0 * eff.nnz, 4.0 * m)
        rtake = np.cumsum(np.full(rcand.size, float(m))) <= budget
        hubr = np.sort(rcand[rtake][:GEN_MAX_HUB])
    else:
        hubr = rcand
    has_hubr = hubr.size > 0
    if has_hubr:
        hubr_mark = np.zeros(m, dtype=bool)
        hubr_mark[hubr] = True
        is_hubr = hubr_mark[r2]
        hr_r, hr_c, hr_s = r2[is_hubr], c2[is_hubr], s2[is_hubr]
        r2, c2, s2 = r2[~is_hubr], c2[~is_hubr], s2[~is_hubr]
    nnz_r = r2.size
    itemsize = np.dtype(np.asarray(eff.val).dtype).itemsize if eff.val is not None else 4

    k_hub_total = hub.size + (hubr.size if has_hubr else 0)
    fallback_t = eff.nnz * GEN_GATHER_NS  # gather-form estimate to beat

    def _try_granularity(B: int):
        """RCM at block granularity B: the quotient graph over B-element
        blocks is reordered, so runtime x/y permutes are width-B panel
        gathers. B=1 is exact element RCM (slow scalar permutes at runtime
        — only worth it when nnz >> m). Window choice: evaluate the peel
        ladder analytically on the rel-offset distribution (no rebuilds)
        and keep the minimum-cost window under the measured-rate model."""
        nblk = -(-m // B)
        m_pad = nblk * B
        if nnz_r:
            qkey_all = (r2 // B) * nblk + (c2 // B)
            qkey, qcnt = np.unique(qkey_all, return_counts=True)
            if B > 1:
                # prune weak block couplings before RCM: a handful of
                # uniform-random entries per block pair would otherwise turn
                # the quotient graph into an expander and hide the real
                # cluster structure; their entries end up in the spill
                strong = qcnt >= 4
                if strong.any():
                    qkey = qkey[strong]
            q_r, q_c = qkey // nblk, qkey % nblk
            qptr = np.zeros(nblk + 1, dtype=np.int64)
            np.add.at(qptr, q_r + 1, 1)
            qptr = np.cumsum(qptr)
            bperm, _qbw = native.rcm_permutation(nblk, qptr, q_c)
        else:
            bperm = np.arange(nblk, dtype=np.int64)
        bpos = np.empty(nblk, dtype=np.int64)
        bpos[bperm] = np.arange(nblk)
        fP = None
        if B > 1 and nnz_r:
            fP = _block_flips(bpos[r2 // B], bpos[c2 // B], r2 % B, c2 % B, nblk, B)

        def ppos(i):
            """Original index -> permuted position (flip-aware)."""
            pb, off = bpos[i // B], i % B
            if fP is None:
                return pb * B + off
            return pb * B + np.where(fP[pb], B - 1 - off, off)

        prows = ppos(r2)
        pcols = ppos(c2)
        rel = pcols - 8 * (prows // 8)
        if rel.size == 0:
            return None
        rel_s = np.sort(rel)
        nmax = rel.size - 1
        best = None  # (cost, rel_lo, W, n_out)
        # every rung is capped at the global GEN_SPILL_FRAC; the cost model
        # (spill enters _gen_cost_model via n_out) arbitrates between rungs,
        # so no per-rung tightening is applied
        for plo, phi in (
            (0.0, 100.0),
            (0.25, 99.75),
            (1.0, 99.0),
            (2.5, 97.5),
            (5.0, 95.0),
            (7.5, 92.5),
            (12.5, 87.5),
        ):
            lo_c = (int(rel_s[int(plo / 100 * nmax)]) // 8) * 8
            hi_c = int(rel_s[int(phi / 100 * nmax)])
            W = -(-(hi_c - lo_c + 1) // 8) * 8
            if W > BWD_MAX_W or m_pad * W * itemsize > GEN_MEM_CAP:
                continue
            n_out = int(np.searchsorted(rel_s, lo_c)) + int(
                rel.size - np.searchsorted(rel_s, lo_c + W)
            )
            if n_out > max(4096, int(rel.size * GEN_SPILL_FRAC)):
                continue
            cost = _gen_cost_model(m_pad, W, B, k_hub_total, n_out, itemsize)
            if best is None or cost < best[0]:
                best = (cost, lo_c, W, n_out)
        if best is None or best[0] > GEN_MARGIN * fallback_t:
            return None
        order = np.lexsort((pcols, prows))
        pr_s, pc_s, src_s = prows[order], pcols[order], s2[order]
        rel_lo8, W8 = best[1], best[2]
        rel8 = pc_s - 8 * (pr_s // 8)
        spill = (rel8 < rel_lo8) | (rel8 >= rel_lo8 + W8)
        cand = _build_bwd_coo(
            pr_s,
            pc_s,
            src_s,
            m_pad,
            m_pad,
            G=8,
            kind="gen",
            window=(rel_lo8, W8),
        )
        return cand, bperm, bpos, m_pad, fP, ppos

    got = _try_granularity(B)
    if got is None:
        B = 1
        got = _try_granularity(B)
    if got is None:
        return None
    core, bperm, bpos, m_pad, fP, ppos = got
    core.m = m  # logical size; band geometry lives in m_pad space
    core.n = n
    core.gen_m_pad = m_pad
    core.gen_B = B
    core.gen_perm = jnp.asarray(bperm.astype(np.int32))
    core.gen_out = jnp.asarray(bpos.astype(np.int32))
    core.gen_flip = jnp.asarray(fP) if fP is not None else None
    # hub entries as (permuted row, ORIGINAL col, src) triples; hubr entries
    # as (permuted row, permuted col, src)
    ei = np.zeros(0, dtype=np.int64)
    if has_hub:
        hrows, hcols, hsrc = rows[is_hub], cols[is_hub], idx[is_hub]
        h_pr, h_oc, h_src = ppos(hrows), hcols, hsrc
    else:
        h_pr, h_oc, h_src = ei, ei, ei
    if has_hubr:
        r_pr, r_pc, r_src = ppos(hr_r), ppos(hr_c), hr_s
    else:
        r_pr, r_pc, r_src = ei, ei, ei
    # --- spill -> slab promotion: a spill column (or row) with cnt entries
    # costs cnt * GEN_GATHER_NS as scalar gathers but only one dense slab
    # lane (m_pad * itemsize / stream) as a hub — promote past breakeven.
    # Catches structure below the first-pass hub threshold (mid-degree
    # power-law columns) and anything the window happened to orphan.
    thresh = max(
        GEN_HUB_MIN, int((m_pad * itemsize / GEN_STREAM_BPS) / GEN_GATHER_NS) + 1
    )
    if core.sp_src is not None and core.sp_src.size:
        sp_src = core.sp_src
        sp_pr = np.asarray(core.sp_rows).astype(np.int64)
        sp_pc = np.asarray(core.sp_ind).astype(np.int64)
        sp_oc = cols[sp_src]  # original column of each spill entry
        hist = np.bincount(sp_oc, minlength=n)
        room = max(0, GEN_MAX_HUB - hub.size)
        cand_p = np.nonzero(hist >= thresh)[0]
        if cand_p.size > room:
            cand_p = cand_p[np.argsort(hist[cand_p])[::-1][:room]]
        if cand_p.size:
            pmark = np.zeros(n, dtype=bool)
            pmark[cand_p] = True
            mvq = pmark[sp_oc]
            h_pr = np.concatenate([h_pr, sp_pr[mvq]])
            h_oc = np.concatenate([h_oc, sp_oc[mvq]])
            h_src = np.concatenate([h_src, sp_src[mvq]])
            hub = np.union1d(hub, cand_p)
            has_hub = True
            keepq = ~mvq
            sp_src, sp_pr, sp_pc = sp_src[keepq], sp_pr[keepq], sp_pc[keepq]
        if sp_src.size:
            rhist = np.bincount(sp_pr, minlength=m_pad)
            roomr = max(0, GEN_MAX_HUB - (np.unique(r_pr).size if r_pr.size else 0))
            cand_r = np.nonzero(rhist >= thresh)[0]
            if cand_r.size > roomr:
                cand_r = cand_r[np.argsort(rhist[cand_r])[::-1][:roomr]]
            if cand_r.size:
                rmark = np.zeros(m_pad, dtype=bool)
                rmark[cand_r] = True
                mvr = rmark[sp_pr]
                r_pr = np.concatenate([r_pr, sp_pr[mvr]])
                r_pc = np.concatenate([r_pc, sp_pc[mvr]])
                r_src = np.concatenate([r_src, sp_src[mvr]])
                has_hubr = True
                keepr = ~mvr
                sp_src, sp_pr, sp_pc = sp_src[keepr], sp_pr[keepr], sp_pc[keepr]
        if sp_src.size:
            order_sp = np.argsort(sp_pr, kind="stable")
            core.sp_src = sp_src[order_sp]
            core.sp_ind = jnp.asarray(sp_pc[order_sp].astype(np.int32))
            core.sp_rows = jnp.asarray(sp_pr[order_sp].astype(np.int32))
        else:
            core.sp_src = core.sp_ind = core.sp_rows = None
    if has_hub:
        k = hub.size
        slot = np.searchsorted(hub, h_oc)
        core.hub_cols = jnp.asarray(hub.astype(np.int32))
        core.hub_dest = h_pr * k + slot
        core.hub_src = h_src
    if has_hubr:
        slabrows = np.unique(r_pr)
        rslot = np.searchsorted(slabrows, r_pr)
        core.hubr_rows = jnp.asarray(slabrows.astype(np.int32))
        core.hubr_dest = rslot * m_pad + r_pc
        core.hubr_src = r_src
    core.refresh(eff.val)
    return core


def _diag_stats(eff: EffectiveCSR):
    """Distinct generalized diagonals (j - i) of the effective matrix."""
    if eff.nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rows = np.repeat(np.arange(eff.m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    d = eff.ind.astype(np.int64) - rows
    offs = np.unique(d)
    return offs, d


def _build_diag(eff: EffectiveCSR) -> ExecForm:
    """Scan-over-diagonals operand (see spmv_diag_scan)."""
    m, n = eff.shape
    offs, d = _diag_stats(eff)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    didx = np.searchsorted(offs, d)
    dest = didx * m + rows
    L = int(max(0, -(offs.min() if offs.size else 0)))
    max_off = int(offs.max()) if offs.size else 0
    n_pad = max(L + n, L + max_off + m)
    form = ExecForm(
        kind="diag",
        m=m,
        n=n,
        dia_offs=jnp.asarray(offs.astype(np.int32)),
        dia_dest=dest,
        dia_offs_static=tuple(int(o) for o in offs),
        dia_L=L,
        dia_n_pad=int(n_pad),
    )
    form.refresh(eff.val)
    return form


def _build_sell(eff: EffectiveCSR) -> ExecForm:
    """Sliced-ELL execution form (explicit-KID alternative to ell/ellhyb):
    SUBLANE-row slices, each padded to its own LANE-multiple width, flattened.
    All structure work is vectorized numpy (throttled-Python rule). Padding
    entries get column 0 and value 0 so the kernel needs no mask."""
    m, n = eff.shape
    ptr64 = eff.ptr.astype(np.int64)
    lens = np.diff(ptr64)
    nsl = -(-m // SUBLANE) if m else 0
    if nsl == 0 or eff.nnz == 0:
        # degenerate: empty buffer, kernel returns zeros via segment_sum
        return ExecForm(
            kind="sell",
            m=m,
            n=n,
            ind=jnp.zeros((0,), jnp.int32),
            val=jnp.zeros((0,), eff.val.dtype),
            row_ids=jnp.zeros((0,), jnp.int32),
            sell_dest=np.zeros(0, np.int64),
            sell_total=0,
        )
    lens_pad = np.zeros(nsl * SUBLANE, dtype=np.int64)
    lens_pad[:m] = lens
    wmax = lens_pad.reshape(nsl, SUBLANE).max(axis=1)
    widths = np.maximum(LANE, -(-wmax // LANE) * LANE)  # per-slice padded width
    base = np.concatenate([[0], np.cumsum(widths * SUBLANE)])  # slice offsets
    total = int(base[-1])
    # flat destination of each stored entry: row start + offset within row
    row_off = base[np.arange(m) // SUBLANE] + (np.arange(m) % SUBLANE) * widths[
        np.arange(m) // SUBLANE
    ]
    nnzE = int(ptr64[-1])
    dest = np.repeat(row_off, lens) + (np.arange(nnzE) - np.repeat(ptr64[:-1], lens))
    ind_buf = np.zeros(total, dtype=np.int32)
    ind_buf[dest] = eff.ind
    # per-position destination row (sorted by construction: row-major slices)
    pos = np.arange(total, dtype=np.int64)
    sl = np.searchsorted(base, pos, side="right") - 1
    row_ids = np.minimum(sl * SUBLANE + (pos - base[sl]) // widths[sl], m - 1)
    form = ExecForm(
        kind="sell",
        m=m,
        n=n,
        ind=jnp.asarray(ind_buf),
        row_ids=jnp.asarray(row_ids.astype(np.int32)),
        sell_dest=dest,
        sell_total=total,
    )
    form.refresh(eff.val)
    return form


def build_exec_form(eff: EffectiveCSR, kind: Optional[str] = None) -> ExecForm:
    if kind is None:
        kind = choose_mv_format(eff)
    m, n = eff.shape
    if kind == "gen":
        form = _build_gen(eff)
        if form is not None:
            return form
        # composite rejected (band still too wide): gather-form fallback
        kind = choose_mv_format(eff)
    if kind == "diag":
        return _build_diag(eff)
    if kind == "bwd":
        return _build_bwd(eff, G=8, kind="bwd")
    if kind == "bwdg":
        # G=512: the SpMM scan of 2-D matmuls wants few, large groups
        # (kernels/xla/spmm.py)
        return _build_bwd(eff, G=512, kind="bwdg")
    if kind == "host":
        form = ExecForm(
            kind="host",
            m=m,
            n=n,
            host_ptr=np.asarray(eff.ptr, dtype=np.int64),
            host_ind=np.asarray(eff.ind),
        )
        form.refresh(eff.val)
        return form
    if kind == "segsum":
        rows = np.repeat(
            np.arange(m, dtype=np.int32), np.diff(eff.ptr.astype(np.int64))
        )
        return ExecForm(
            kind="segsum",
            m=m,
            n=n,
            ind=jnp.asarray(eff.ind),
            val=eff.val,
            row_ids=jnp.asarray(rows),
        )
    if kind == "sell":
        return _build_sell(eff)
    lens = np.diff(eff.ptr.astype(np.int64))
    w_max = int(lens.max()) if lens.size else 0
    if kind == "ell":
        width = max(1, w_max)
        src, ind, valid = _build_ell_map(eff, width)
        form = ExecForm(
            kind="ell", m=m, n=n, ell_ind=jnp.asarray(ind), ell_src=src
        )
        form.refresh(eff.val)
        return form
    # ellhyb: width = p75 row length rounded up to SUBLANE, spill to segsum
    p75 = int(np.percentile(lens, 75)) if lens.size else 1
    width = max(SUBLANE, int(-(-p75 // SUBLANE) * SUBLANE))
    width = min(width, max(1, w_max))
    src, ind, valid = _build_ell_map(eff, width)
    # spill entries: per row, offsets beyond width (vectorized range concat)
    tail = np.maximum(lens - width, 0)
    sp_rows = np.repeat(np.arange(m, dtype=np.int32), tail)
    ptr64 = eff.ptr.astype(np.int64)
    sp_src, _ = _ranges_concat(np.minimum(ptr64[:-1] + width, ptr64[1:]), ptr64[1:])
    form = ExecForm(
        kind="ellhyb",
        m=m,
        n=n,
        ell_ind=jnp.asarray(ind),
        ell_src=src,
        sp_ind=jnp.asarray(eff.ind[sp_src] if sp_src.size else np.zeros(0, np.int32)),
        sp_rows=jnp.asarray(sp_rows),
        sp_src=sp_src,
    )
    form.refresh(eff.val)
    return form


# ---------------------------------------------------------------------------
# Plan: the handle's cached optimized state (the `A->mats` + optim_data analog)
# ---------------------------------------------------------------------------


class Plan:
    def __init__(self, clean: CleanCSR):
        self.clean = clean
        self.effective: Dict[Tuple, EffectiveCSR] = {}
        self.exec_forms: Dict[Tuple, ExecForm] = {}
        self.levels = None  # trsv/ilu level schedule cache (set by solvers)

    def effective_for(
        self, descr: MatrixDescriptor, op: Operation, dtype=None
    ) -> EffectiveCSR:
        key = (descr.type, descr.fill_mode, descr.diag_type, Operation(op))
        eff = self.effective.get(key)
        if eff is None:
            # Form construction is compile-time planner work: the value
            # gathers must produce CONCRETE arrays even when the caller is
            # mid-trace (a cold plan inside jit) — without this the plan
            # cache would capture tracers (UnexpectedTracerError on reuse).
            with jax.ensure_compile_time_eval():
                eff = build_effective_csr(self.clean, descr, op, dtype)
            self.effective[key] = eff
        return eff

    def exec_form_for(
        self, descr: MatrixDescriptor, op: Operation, kind: Optional[str] = None, dtype=None
    ) -> ExecForm:
        eff = self.effective_for(descr, op, dtype)
        key = (descr.type, descr.fill_mode, descr.diag_type, Operation(op), kind)
        form = self.exec_forms.get(key)
        if form is None:
            with jax.ensure_compile_time_eval():  # see effective_for
                form = build_exec_form(eff, kind)
            self.exec_forms[key] = form
        return form

    def seed_bwdg(self, form: ExecForm) -> None:
        """Pre-seat a ready band-group exec form for (general, none) — the
        SpGEMM band engine's C output (kernels/xla/spgemm_band.py): chained
        mv on a product result reuses the band the numeric stage already
        computed on-device, skipping the host relayout AND the CSR
        extraction gather. The form carries the
        extraction map as its scatter list, so refresh-after-update_values
        follows the normal path."""
        from ..core.descr import GENERAL

        self.effective_for(GENERAL, Operation.none)
        key = (
            GENERAL.type,
            GENERAL.fill_mode,
            GENERAL.diag_type,
            Operation.none,
            None,
        )
        self.exec_forms[key] = form

    def refresh_values(self, data, host_values=None) -> None:
        """After update_values: re-run every value gather (structure reused).
        `host_values` is the caller's numpy copy when one exists — CleanCSR
        fills its host twin from it, so host engines refresh with zero
        device traffic."""
        new_val = data.val if hasattr(data, "val") else data
        if not isinstance(new_val, (np.ndarray, jax.Array)):
            new_val = np.asarray(new_val)
        if host_values is None and isinstance(new_val, np.ndarray):
            host_values = new_val
        self.clean.refresh(new_val, host_input=host_values)
        for eff in self.effective.values():
            v = _gather_vals_jit(self.clean.val, jnp.asarray(eff.src), eff.const_val)
            eff.val = _apply_conj_pattern(eff, v)
        for key, form in self.exec_forms.items():
            ekey = key[:4]
            form.refresh(self.effective[ekey].val)
        self.levels = None
        # jitted fused-solver closures (solvers/fused.py) trace the exec/trsv
        # form arrays as baked constants — a refreshed form does NOT flow into
        # an already-traced program, so the cache must drop with the values
        if hasattr(self, "_fused_cache"):
            self._fused_cache = {}
        # distributed sweep operands (parallel/sweeps.py) hold device-put
        # sharded COPIES of the ELL/solve arrays — same staleness, same drop
        if hasattr(self, "_dist_sweep_cache"):
            self._dist_sweep_cache = {}


# ---------------------------------------------------------------------------
# public optimize() entry (aoclsparse_optimize, analysis.cpp:426-593)
# ---------------------------------------------------------------------------


def optimize(A: SparseMatrix) -> Plan:
    """Walk the hint list and prebuild what the hints ask for.

    With AOCLSPARSE_TPU_AUTOTUNE=1, heavily-hinted mv operations
    (nop >= AOCLSPARSE_TPU_AUTOTUNE_NOP, default 1000) are additionally
    measured empirically: every buildable execution form is timed through
    the live dispatch and the winner pinned (kernels/autotune.py) — the
    measurement amortizes over the hinted call count, exactly the trade
    the reference's nop hint expresses."""
    if A is None:
        from ..core.types import AoclSparseError, Status

        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    import os

    plan = get_plan(A)
    tune = os.environ.get("AOCLSPARSE_TPU_AUTOTUNE", "0") in ("1", "true")
    if tune:
        try:
            tune_nop = int(os.environ.get("AOCLSPARSE_TPU_AUTOTUNE_NOP", "1000"))
        except ValueError:
            tune_nop = 1000
    for h in A.hints:
        if h.done:
            continue
        if h.action in ("mv", "dotmv", "mm"):
            if tune and h.action == "mv" and h.nop >= tune_nop:
                from ..kernels.autotune import autotune_mv

                try:
                    autotune_mv(A, h.descr, h.trans)
                except Exception as e:
                    import warnings

                    warnings.warn(
                        f"AOCLSPARSE_TPU_AUTOTUNE requested but measurement failed "
                        f"({type(e).__name__}: {e}); using the cost model",
                        RuntimeWarning,
                    )
                    plan.exec_form_for(h.descr, h.trans)
            else:
                plan.exec_form_for(h.descr, h.trans)
        elif h.action in ("sv", "sm", "symgs", "sorv", "lu_smoother", "2m"):
            # solvers build their level schedules lazily; ensure clean csr + copies
            plan.effective_for(h.descr, h.trans)
        h.done = True
    return plan


def get_plan(A: SparseMatrix) -> Plan:
    """Return (building if needed) the matrix's plan — the on-the-fly
    optimize path every op falls back to (aoclsparse_mv.cpp:149-163)."""
    if A.plan is None:
        from ..convert import conversions as cv

        A.plan = Plan(build_clean_csr(cv.to_csr(A.data)))
        seed = getattr(A, "_seed_bwdg", None)
        if seed is not None and getattr(A, "_seed_bwdg_val", None) is A.data.val:
            A.plan.seed_bwdg(seed)
    return A.plan
