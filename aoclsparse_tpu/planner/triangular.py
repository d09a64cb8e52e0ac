"""Blocked triangular-solve planning.

The reference's TRSV is a strictly sequential per-row sweep vectorized only
within each row (level2/aoclsparse_trsv_kt.cpp:65-..., loop-carried dependency
noted at SURVEY.md §3.3). That leaves an accelerator idle, so the planner
re-architects it: rows are partitioned into fixed-size blocks; the solve
becomes a `lax.scan` over blocks where each step is

    x_k = D_k^{-1} (alpha*b_k - L_k @ x_{<k})

with D_k the dense (nb, nb) diagonal block solved by
`lax.linalg.triangular_solve` and L_k the
block's left-of-diagonal entries in a padded ELL gather (the same layout the
SpMV path uses). Upper solves are reduced to lower solves by the reversal
permutation P (reverse rows+cols turns U into L), applied host-side to the
structure only. Semantics remain the exact substitution order of the
reference within working precision.

All value-dependent arrays keep host gather maps into the effective CSR so
`update_values` refreshes a TrsvForm without re-planning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.descr import MatrixDescriptor
from ..core.types import AoclSparseError, DiagType, FillMode, MatrixType, Operation, Status
from .plan import CleanCSR, EffectiveCSR, Plan, build_effective_csr

__all__ = ["TrsvForm", "build_trsv_form", "trsv_form_for"]

DEFAULT_BLOCK = 64


def adaptive_nb(m: int, dtype=None) -> int:
    """Block size targeting ~512 scan steps: fewer, larger blocks cut the
    per-step overhead of the scan until the dense diagonal blocks dominate
    memory (see trsv_form_for)."""
    return int(min(512, max(DEFAULT_BLOCK, 1 << int(np.ceil(np.log2(max(m / 512, 1)))))))


@dataclasses.dataclass
class TrsvForm:
    """Blocked lower-triangular operand (post reversal-permutation if the
    effective triangle was upper). kind="gather" keeps the left part as a
    padded-ELL gather; kind="win" stores it as a dense (nb, WL) window ending
    at the block start (zero gathers in the scan)."""

    nb: int  # block size
    nblk: int  # number of blocks (m_pad = nblk*nb)
    m: int  # true dimension
    reversed_: bool  # True -> solve on reversed indices (upper source)
    unit_diag: bool
    # device arrays
    D: jax.Array  # (nblk, nb, nb) dense diagonal blocks
    Lind: jax.Array  # (nblk, nb, W) left-part column indices (into padded x)
    Lval: jax.Array  # (nblk, nb, W) — or (nblk, nb, WL) dense window if "win"
    # host refresh maps (scatter lists — dense int64 maps would cost 8x the
    # operand in host RAM)
    _D_dest: np.ndarray  # flat positions into D
    _D_srcpos: np.ndarray  # positions into eff values
    _D_paddest: np.ndarray  # flat positions that get identity 1.0
    _L_dest: np.ndarray
    _L_srcpos: np.ndarray
    _L_shape: Tuple
    _eff_key: Tuple  # key of the effective CSR this form derives from
    kind: str = "gather"
    WL: int = 0
    # "dwin": static element-diagonal offsets of the left part (wide-band
    # few-diagonal triangles; kernels/xla/trsv.py trsv_blocked_dwin)
    dwin_offs: Optional[Tuple] = None

    def refresh(self, eff_val: jax.Array) -> None:
        self._Dinv = None  # inverse blocks (distributed pipeline) derive from D
        vh = np.asarray(eff_val)
        D = np.zeros(self.nblk * self.nb * self.nb, dtype=vh.dtype)
        D[self._D_dest] = vh[self._D_srcpos]
        D[self._D_paddest] = 1.0
        self.D = jnp.asarray(D.reshape(self.nblk, self.nb, self.nb))
        L = np.zeros(int(np.prod(self._L_shape)), dtype=vh.dtype)
        L[self._L_dest] = vh[self._L_srcpos]
        self.Lval = jnp.asarray(L.reshape(self._L_shape))

    def solve(self, r2) -> jax.Array:
        """Run the blocked solve on a padded (m_pad, k) rhs: exact
        substitution on each dense diagonal block."""
        from ..kernels.xla.trsv import trsv_blocked, trsv_blocked_dwin, trsv_blocked_win

        m_pad = self.nblk * self.nb
        if self.kind == "win":
            return trsv_blocked_win(self.D, self.Lval, r2, self.nb, m_pad, self.WL)
        if self.kind == "dwin":
            return trsv_blocked_dwin(
                self.D, self.Lval, r2, self.nb, m_pad, self.WL, self.dwin_offs, False
            )
        return trsv_blocked(self.D, self.Lind, self.Lval, r2, self.nb, m_pad)


def _reverse_structure(eff: EffectiveCSR) -> EffectiveCSR:
    """Apply the reversal permutation to rows and cols (host-side): the
    upper triangle becomes lower. Entries within each new row re-sorted.

    Lexsort-free: effective-CSR rows are already column-sorted, and
    reversing rows + cols maps row r ascending-by-col onto row m-1-r
    DESCENDING-by-col — so the sorted order of new row r' = m-1-r is the
    entry-reversed slice of old row r. Pure index arithmetic; the old
    np.lexsort cost seconds at 8M nnz on this host (ILU0 prep, VERDICT r3
    item 4)."""
    m = eff.m
    ptr = eff.ptr.astype(np.int64)
    lens = np.diff(ptr)
    rlens = lens[::-1]
    nptr = np.concatenate([[0], np.cumsum(rlens)])
    nnz = int(ptr[-1])
    # new entry k in new row r' came from old row r = m-1-r', old position
    # (row end - 1 - offset): order[k] = ptr[r+1]-1 - (k - nptr[r'])
    rows_new = np.repeat(np.arange(m, dtype=np.int64), rlens) if nnz else np.zeros(0, np.int64)
    off = np.arange(nnz, dtype=np.int64) - np.repeat(nptr[:-1], rlens)
    old_row = (m - 1) - rows_new
    order = ptr[old_row + 1] - 1 - off
    new_cols = (m - 1) - eff.ind.astype(np.int64)[order]
    out = EffectiveCSR(
        nptr.astype(np.int32),
        new_cols.astype(np.int32),
        order.astype(np.int64),  # src: position in eff.val
        False,
        eff.const_val,
        (m, m),
    )
    return out


def build_trsv_form(
    clean: CleanCSR,
    descr: MatrixDescriptor,
    op: Operation,
    eff_key: Tuple,
    eff: EffectiveCSR,
    nb: int = DEFAULT_BLOCK,
    val_override=None,
) -> TrsvForm:
    """val_override: host value vector over the effective structure to fill
    the form with instead of eff.val — refresh() fetches its argument to
    host, so callers whose values already live in host memory (ILU0's
    native-factored LU) pass them here and skip a device->host round trip
    (VERDICT r3 item 4)."""
    m = eff.m
    dt = DiagType(descr.diag_type)
    lower = FillMode(descr.fill_mode) == FillMode.lower
    op = Operation(op)
    # orientation after op
    eff_lower = lower if op == Operation.none else not lower
    # indirection chain: maybe reverse (upper -> lower), then maybe compose
    if not eff_lower:
        rev = _reverse_structure(eff)
        ptr, ind, src = rev.ptr, rev.ind, rev.src
        src_chain = lambda s: np.where(s >= 0, s, -1)  # src already indexes eff vals
        reversed_ = True
    else:
        ptr, ind, src = eff.ptr, eff.ind, np.arange(eff.nnz, dtype=np.int64)
        reversed_ = False

    nb = int(min(nb, max(8, m)))
    nblk = -(-m // nb) if m else 1
    m_pad = nblk * nb
    ptr64 = ptr.astype(np.int64)
    lens = np.diff(ptr64)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = ind.astype(np.int64)

    # structural diagonal check for non-unit solves (reference requires
    # full diag: trsv.cpp:130-134 -> invalid_value)
    if dt == DiagType.zero:
        raise AoclSparseError(Status.invalid_value, "cannot solve with zero diagonal")
    if dt == DiagType.non_unit:
        ndiag = np.bincount(rows[cols == rows], minlength=m) if rows.size else np.zeros(m)
        missing = np.nonzero(ndiag == 0)[0]
        if missing.size:
            raise AoclSparseError(
                Status.invalid_value, f"missing diagonal entry in row {int(missing[0])}"
            )

    # split each entry at its row's block boundary (vectorized)
    blk_of_row = rows // nb
    blk0 = blk_of_row * nb
    is_left = cols < blk0
    # left entries are a prefix of each (sorted) row
    csum_left = np.concatenate([[0], np.cumsum(is_left.astype(np.int64))])
    left_counts = csum_left[ptr64[1:]] - csum_left[ptr64[:-1]]
    W = max(int(left_counts.max()) if m else 0, 1)

    pos_in_row = np.arange(cols.size, dtype=np.int64) - np.repeat(ptr64[:-1], lens)
    r_in_blk = (rows % nb).astype(np.int64)
    lmask = is_left

    # dense-left-window variant ("win"): left entries within [blk0-WL, blk0)
    # become a dense window so the scan step is slice+matvec, no gather —
    # chosen when the band blowup is acceptable.
    WL_need = int((blk0 - cols)[lmask].max()) if lmask.any() else 0
    WL = max(8, -(-WL_need // 8) * 8)
    use_win = (nblk * nb * WL) <= max(8 * cols.size, 64 * nb * nb) and WL <= 8192
    dwin_offs = None
    if use_win:
        Lw = WL
        t_l = (cols - blk0 + WL)[lmask]
        L_ind = jnp.zeros((1,), dtype=jnp.int32)  # unused in win mode
        L_dest = ((blk_of_row[lmask] * nb + r_in_blk[lmask]) * Lw + t_l).astype(np.int64)
        L_shape = (nblk, nb, Lw)
    else:
        import os as _os

        # diagonal-window variant first: WIDE windows whose left part
        # carries few distinct element diagonals (pwtk-class 6x6-dof FEM
        # stencils: half-bw ~2729, ~50 lower diagonals). Gather-free scan
        # with O(ndiag*m_pad) storage where the dense window would be GBs
        # (VERDICT r4 item 3); the padded ELL below is the gather path.
        offs_left = (rows - cols)[lmask]
        uoff = np.unique(offs_left) if offs_left.size else np.zeros(0, np.int64)
        dwin_max = int(_os.environ.get("AOCLSPARSE_TPU_TRSV_DWIN_MAX", "192"))
        _cap = float(_os.environ.get("AOCLSPARSE_TPU_TRSV_WIN_CAP", "1.2e9"))
        dwin_ok = (
            offs_left.size > 0
            and uoff.size <= dwin_max
            and int(uoff[-1]) <= 65536
            and float(uoff.size * nblk * nb) * np.dtype(eff.val.dtype).itemsize <= _cap
        )
        if dwin_ok:
            ndg = int(uoff.size)
            d_idx = np.searchsorted(uoff, offs_left)
            L_ind = jnp.zeros((1,), dtype=jnp.int32)  # unused in dwin mode
            L_dest = (
                (blk_of_row[lmask] * ndg + d_idx) * nb + r_in_blk[lmask]
            ).astype(np.int64)
            L_shape = (nblk, ndg, nb)
            WL = max(8, -(-int(uoff[-1]) // 8) * 8)
            dwin_offs = tuple(int(v) for v in uoff)
        else:
            # padded-ELL left window: (nblk, nb, W) with W = MAX left count
            # per row — one hub row blows this up (webbase stand-in: W=4699
            # at m=1M is a 37 GB pair of arrays). Guard with the TRUE
            # allocation size; callers fall back (default trsv: level
            # engine for shallow DAGs, host engine eagerly; kid=0 surfaces
            # this error)
            _bytes = float(nblk * nb * W) * (4 + np.dtype(eff.val.dtype).itemsize)
            if _bytes > _cap:
                raise AoclSparseError(
                    Status.memory_error,
                    f"padded-ELL left window would need ~{_bytes / 1e9:.1f} GB"
                    f" ((nblk,nb,W)=({nblk},{nb},{W})); use the level engine"
                    " (kid=1) or the host engine (kid=2), or raise"
                    " AOCLSPARSE_TPU_TRSV_WIN_CAP",
                )
            Lw = W
            t_l = pos_in_row[lmask]
            L_ind_np = np.zeros((nblk, nb, W), dtype=np.int32)
            if lmask.any():
                L_ind_np[blk_of_row[lmask], r_in_blk[lmask], t_l] = cols[lmask].astype(
                    np.int32
                )
            L_ind = jnp.asarray(L_ind_np)
            L_dest = ((blk_of_row[lmask] * nb + r_in_blk[lmask]) * Lw + t_l).astype(
                np.int64
            )
            L_shape = (nblk, nb, Lw)
    L_srcpos = src[lmask].astype(np.int64)
    # diagonal block fill (cols within [blk0, blk0+nb))
    dmask = (cols >= blk0) & (cols < blk0 + nb)
    D_dest = ((blk_of_row[dmask] * nb + r_in_blk[dmask]) * nb + (cols - blk0)[dmask]).astype(
        np.int64
    )
    D_srcpos = src[dmask].astype(np.int64)
    # identity-pad rows beyond m (+ missing unit diagonals)
    pad_rows = np.arange(m, m_pad, dtype=np.int64)
    if dt == DiagType.unit:
        have = np.zeros(m, dtype=bool)
        have[rows[dmask & (cols == rows)]] = True
        miss = np.nonzero(~have)[0].astype(np.int64)
        pad_rows = np.concatenate([pad_rows, miss])
    D_paddest = ((pad_rows // nb) * nb + pad_rows % nb) * nb + pad_rows % nb

    form = TrsvForm(
        nb=nb,
        nblk=nblk,
        m=m,
        reversed_=reversed_,
        unit_diag=(dt == DiagType.unit),
        D=None,
        Lind=L_ind,
        Lval=None,
        _D_dest=D_dest,
        _D_srcpos=D_srcpos,
        _D_paddest=D_paddest,
        _L_dest=L_dest,
        _L_srcpos=L_srcpos,
        _L_shape=L_shape,
        _eff_key=eff_key,
        kind="win" if use_win else ("dwin" if dwin_offs is not None else "gather"),
        WL=WL if (use_win or dwin_offs is not None) else 0,
        dwin_offs=dwin_offs,
    )
    form.refresh(eff.val if val_override is None else val_override)
    return form


def build_trsv_form_native(
    clean: CleanCSR,
    descr: MatrixDescriptor,
    op: Operation,
    eff_key: Tuple,
    nb: int,
    values: np.ndarray,
) -> Optional[TrsvForm]:
    """Native (C++) fast path for the win-kind blocked form: partitions the
    triangle straight off the CLEAN structure's split pointers
    (idiag/iurow) — no effective-triangle materialization, no numpy mask
    passes, no host scatter (native.trsv_win_build fills D/Lw and the
    refresh maps in one O(nnz) sweep; the numpy build cost ~9 s at 16.7M
    nnz on this host, VERDICT r3 item 4). `values` is the HOST value
    vector over clean positions (e.g. ILU0's native-factored lu); the
    form's scatter maps are in the same space, so refresh(values_new)
    works unchanged. Returns None when unsupported (op != none, dtype,
    window cap, native lib missing) — callers fall back to
    build_trsv_form."""
    from .. import native

    if Operation(op) != Operation.none:
        return None
    dt = DiagType(descr.diag_type)
    if dt == DiagType.zero:
        raise AoclSparseError(Status.invalid_value, "cannot solve with zero diagonal")
    m = clean.m
    if m == 0 or clean.shape[0] != clean.shape[1]:
        return None
    values = np.asarray(values)
    if values.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    lower = FillMode(descr.fill_mode) == FillMode.lower
    ptr64 = clean.ptr.astype(np.int64)
    if lower:
        lo = ptr64[:-1]
        hi = (clean.iurow if dt == DiagType.non_unit else clean.idiag).astype(np.int64)
        reversed_ = False
    else:
        lo = (clean.idiag if dt == DiagType.non_unit else clean.iurow).astype(np.int64)
        hi = ptr64[1:]
        reversed_ = True
    if dt == DiagType.non_unit and not clean.fulldiag:
        missing = np.nonzero(~clean.has_diag)[0]
        if missing.size:
            raise AoclSparseError(
                Status.invalid_value, f"missing diagonal entry in row {int(missing[0])}"
            )
    nb = int(min(nb, max(8, m)))
    # NOTE: no pre-build memory guard here — the native wrapper applies the
    # numpy builder's use_win cap after its analyze pass (real WL, not a
    # bandwidth overestimate) and returns None; the numpy path then builds
    # the padded-ELL left-window variant with bounded memory.
    got = native.trsv_win_build(m, lo, hi, clean.ind, values, nb, reversed_)
    if got is None:
        return None
    nblk, WL = got["nblk"], got["WL"]
    m_pad = nblk * nb
    pad_rows = np.arange(m, m_pad, dtype=np.int64)
    if dt == DiagType.unit:
        # strict slices never store the diagonal: every row takes the
        # implicit 1.0 (matches the numpy path's miss-detection result)
        pad_rows = np.concatenate([pad_rows, np.arange(m, dtype=np.int64)])
    D_paddest = ((pad_rows // nb) * nb + pad_rows % nb) * nb + pad_rows % nb
    D = got["D"]
    D[D_paddest] = 1.0
    # concrete device arrays even when called mid-trace (cold plan inside a
    # user jit): without the compile-time-eval scope these become tracers
    # cached on the plan (measured: UnexpectedTracerError on the next call)
    with jax.ensure_compile_time_eval():
        D_dev = jnp.asarray(D.reshape(nblk, nb, nb))
        Lval_dev = jnp.asarray(got["Lw"].reshape(nblk, nb, WL))
        Lind_dev = jnp.zeros((1,), dtype=jnp.int32)
    form = TrsvForm(
        nb=nb,
        nblk=nblk,
        m=m,
        reversed_=reversed_,
        unit_diag=(dt == DiagType.unit),
        D=D_dev,
        Lind=Lind_dev,
        Lval=Lval_dev,
        _D_dest=got["D_dest"],
        _D_srcpos=got["D_srcpos"],
        _D_paddest=D_paddest,
        _L_dest=got["L_dest"],
        _L_srcpos=got["L_srcpos"],
        _L_shape=(nblk, nb, WL),
        _eff_key=eff_key,
        kind="win",
        WL=WL,
    )
    form._src_space = "clean"  # maps index clean positions, not an eff copy
    return form


def trsv_form_for(
    plan: Plan, descr: MatrixDescriptor, op: Operation, nb: Optional[int] = None
) -> TrsvForm:
    """Cached TrsvForm lookup on the matrix plan. The descriptor is coerced
    to triangular semantics (the reference treats symmetric descriptors as
    triangular in trsv, aoclsparse_trsv.cpp:141-151).

    nb=None picks an adaptive block size targeting ~512 scan steps (each
    step pays a fixed scan overhead, so fewer/larger blocks win until the
    dense diagonal blocks dominate memory), unless
    autotune_trsv measured and pinned one for this (fill, diag, op)."""
    if nb is None:
        tuned = getattr(plan, "_trsv_tuned", None)
        if tuned is not None:
            nb = tuned.get((descr.fill_mode, descr.diag_type, Operation(op)))
    if nb is None:
        nb = adaptive_nb(plan.clean.m, dtype=np.asarray(plan.clean.val).dtype)
    tri_descr = MatrixDescriptor(
        type=MatrixType.triangular,
        fill_mode=descr.fill_mode,
        diag_type=descr.diag_type,
        base=descr.base,
    )
    if plan.levels is None:
        plan.levels = {}
    key = ("trsv", tri_descr.fill_mode, tri_descr.diag_type, Operation(op), nb)
    form = plan.levels.get(key)
    if form is None:
        # native C++ fast path first (win forms straight off the clean
        # split pointers, O(nnz) one-sweep build); numpy path otherwise
        if Operation(op) == Operation.none:
            form = build_trsv_form_native(
                plan.clean,
                tri_descr,
                Operation.none,
                (tri_descr.type, tri_descr.fill_mode, tri_descr.diag_type, Operation.none),
                nb,
                plan.clean.host_val(),
            )
    if form is None:
        # Form construction is compile-time planner work: value gathers must
        # produce CONCRETE arrays even when the caller is mid-trace (a cold
        # plan inside jit), hence ensure_compile_time_eval.
        with jax.ensure_compile_time_eval():
            form = _build_trsv_form_for(plan, tri_descr, op, nb)
    plan.levels[key] = form
    return form


def _build_trsv_form_for(plan, tri_descr, op, nb):
    # IMPORTANT: effective CSR is built WITHOUT op (we fold op into the
    # orientation/reversal instead) except for conjugation, which must
    # come from the values. conj-transpose == transpose of conj(A).
    op_ = Operation(op)
    if op_ == Operation.conjugate_transpose:
        # build conjugated non-transposed triangle: use transpose of the
        # conj-transposed structure == conj values with same structure
        eff = build_effective_csr(plan.clean, tri_descr, Operation.none)
        eff = EffectiveCSR(
            eff.ptr, eff.ind, eff.src, True, eff.const_val, eff.shape
        )
        eff.materialize(plan.clean.val)
    else:
        eff = build_effective_csr(plan.clean, tri_descr, Operation.none)
    ekey = (tri_descr.type, tri_descr.fill_mode, tri_descr.diag_type, Operation.none)
    if op_ != Operation.none:
        # transpose solve: op(T) x = b. T^T's lower/upper flips; instead of
        # materializing T^T we transpose the structure host-side.
        eff_t = _transpose_eff(eff)
        form = build_trsv_form(plan.clean, tri_descr, Operation.transpose, ekey, eff_t, nb)
        form._eff = eff_t  # keep for refresh
    else:
        form = build_trsv_form(plan.clean, tri_descr, Operation.none, ekey, eff, nb)
        form._eff = eff
    return form


def _transpose_eff(eff: EffectiveCSR) -> EffectiveCSR:
    m, n = eff.shape
    ptr = eff.ptr.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    ind = eff.ind.astype(np.int64)
    order = np.lexsort((rows, ind))
    tptr = np.zeros(n + 1, dtype=np.int64)
    if ind.size:
        np.add.at(tptr, ind + 1, 1)
    tptr = np.cumsum(tptr)
    out = EffectiveCSR(
        tptr.astype(np.int32),
        rows[order].astype(np.int32),
        np.arange(eff.nnz, dtype=np.int64)[order],
        False,
        eff.const_val,
        (n, m),
    )
    # values of transposed effective = permutation of eff.val
    out.val = eff.val[jnp.asarray(order)]
    # chain refresh through eff
    out._parent = eff  # type: ignore[attr-defined]
    out._order = order  # type: ignore[attr-defined]
    return out


@dataclasses.dataclass
class TrsvHostForm:
    """Host-resident triangle for the sequential host TRSV engine (KID 2,
    native.trsv_seq). Everything stays numpy — the engine exists to keep
    sub-ms solves off the device dispatch and fetch path, the same role the host mv engine (KID 11) serves for SpMV. Reference role:
    the scalar substitution kernel (level2/aoclsparse_trsv_kr.hpp) — host
    sequential by construction. Refreshability: cached under plan.levels,
    which drops on update_values (same policy as the level form)."""

    m: int
    ptr: np.ndarray  # (m+1,) int64
    ind: np.ndarray  # (nnz,) int64
    val: np.ndarray  # (nnz,) host values, diagonal materialized
    lower: bool

    def solve(self, b: np.ndarray) -> np.ndarray:
        from .. import native

        return native.trsv_seq(self.m, self.ptr, self.ind, self.val, b, self.lower)

    def solve_mat(self, B: np.ndarray) -> np.ndarray:
        """Multi-RHS twin (trsm KID 2): columns threaded in C++ like the
        reference's OpenMP RHS split (level3/aoclsparse_trsm.hpp:149)."""
        from .. import native

        return native.trsm_seq(self.m, self.ptr, self.ind, self.val, B, self.lower)


def _host_eff_vals(eff: EffectiveCSR, clean: CleanCSR) -> np.ndarray:
    """Materialize an effective triangle's values on the HOST (the device
    twin is EffectiveCSR.materialize): val[src] with src=-1 entries taking
    const_val, then the conj flag. Values come from the clean CSR's cached
    host copy (zero device traffic after a numpy update_values)."""
    cv = clean.host_val()
    src = np.asarray(eff.src, dtype=np.int64)
    v = np.where(
        src >= 0, cv[np.maximum(src, 0)], np.asarray(eff.const_val, dtype=cv.dtype)
    )
    if eff.conj and np.iscomplexobj(v):
        v = np.conj(v)
    return v


def trsv_host_form_for(plan: Plan, descr: MatrixDescriptor, op: Operation) -> TrsvHostForm:
    """Cached host-engine TRSV form — TRSV KID 2. Orientation rules match
    trsv_form_for (transpose ops solve the host-transposed structure;
    conj-transpose folds conjugation into the values), but no reversal is
    needed: the sequential kernel sweeps either direction natively."""
    tri_descr = MatrixDescriptor(
        type=MatrixType.triangular,
        fill_mode=descr.fill_mode,
        diag_type=descr.diag_type,
        base=descr.base,
    )
    dt = DiagType(tri_descr.diag_type)
    if dt == DiagType.zero:
        raise AoclSparseError(Status.invalid_value, "cannot solve with zero diagonal")
    if plan.levels is None:
        plan.levels = {}
    op_ = Operation(op)
    key = ("trsv_host", tri_descr.fill_mode, tri_descr.diag_type, op_)
    form = plan.levels.get(key)
    if form is not None:
        return form
    conj = op_ == Operation.conjugate_transpose
    eff = build_effective_csr(plan.clean, tri_descr, Operation.none)
    hval = _host_eff_vals(eff, plan.clean)
    if conj and np.iscomplexobj(hval):
        hval = np.conj(hval)
    ptr, ind = eff.ptr, eff.ind
    lower = FillMode(tri_descr.fill_mode) == FillMode.lower
    if op_ != Operation.none:
        t = _transpose_eff(eff)
        ptr, ind = t.ptr, t.ind
        hval = hval[t._order]
        lower = not lower
    form = TrsvHostForm(
        m=eff.m,
        ptr=np.ascontiguousarray(ptr, dtype=np.int64),
        ind=np.ascontiguousarray(ind, dtype=np.int64),
        val=np.ascontiguousarray(hval),
        lower=lower,
    )
    plan.levels[key] = form
    return form


def trsv_level_form_for(plan: Plan, descr: MatrixDescriptor, op: Operation):
    """Cached level-scheduled (wavefront) TRSV form — TRSV KID 1
    (kernels/xla/trsv_level.py). Same orientation rules as trsv_form_for
    (upper triangles solve on the reversed structure; transpose ops on the
    host-transposed structure; conj-transpose folds conjugation into the
    values). Rebuilt after update_values (plan.levels drops)."""
    from ..kernels.xla.trsv_level import build_level_form

    tri_descr = MatrixDescriptor(
        type=MatrixType.triangular,
        fill_mode=descr.fill_mode,
        diag_type=descr.diag_type,
        base=descr.base,
    )
    dt = DiagType(tri_descr.diag_type)
    if dt == DiagType.zero:
        raise AoclSparseError(Status.invalid_value, "cannot solve with zero diagonal")
    if plan.levels is None:
        plan.levels = {}
    op_ = Operation(op)
    key = ("trsv_level", tri_descr.fill_mode, tri_descr.diag_type, op_)
    form = plan.levels.get(key)
    if form is not None:
        return form
    with jax.ensure_compile_time_eval():  # concrete builds mid-trace, see trsv_form_for
        form = _build_trsv_level_form_for(plan, tri_descr, op_, dt)
    plan.levels[key] = form
    return form


def trsv_level_stats_for(plan: Plan, descr: MatrixDescriptor, op: Operation):
    """(nlev, padded_run_entries) of the wavefront form WITHOUT building
    it (routing check — building uploads run arrays to the device)."""
    from ..kernels.xla.trsv_level import level_form_stats

    tri_descr = MatrixDescriptor(
        type=MatrixType.triangular,
        fill_mode=descr.fill_mode,
        diag_type=descr.diag_type,
        base=descr.base,
    )
    op_ = Operation(op)
    eff = build_effective_csr(plan.clean, tri_descr, Operation.none)
    if op_ != Operation.none:
        eff = _transpose_eff(eff)
    lower = FillMode(tri_descr.fill_mode) == FillMode.lower
    eff_lower = lower if op_ == Operation.none else not lower
    if eff_lower:
        ptr, ind = eff.ptr, eff.ind
    else:
        rev = _reverse_structure(eff)
        ptr, ind = rev.ptr, rev.ind
    return level_form_stats(ptr, ind, eff.m)


def _build_trsv_level_form_for(plan: Plan, tri_descr, op_, dt):
    from ..kernels.xla.trsv_level import build_level_form

    if op_ == Operation.conjugate_transpose:
        eff = build_effective_csr(plan.clean, tri_descr, Operation.none)
        eff = EffectiveCSR(eff.ptr, eff.ind, eff.src, True, eff.const_val, eff.shape)
        eff.materialize(plan.clean.val)
    else:
        eff = build_effective_csr(plan.clean, tri_descr, Operation.none)
    if op_ != Operation.none:
        eff = _transpose_eff(eff)
    lower = FillMode(tri_descr.fill_mode) == FillMode.lower
    eff_lower = lower if op_ == Operation.none else not lower
    m = eff.m
    if eff_lower:
        ptr, ind, src = eff.ptr, eff.ind, np.arange(eff.nnz, dtype=np.int64)
        reversed_ = False
    else:
        rev = _reverse_structure(eff)
        ptr, ind, src = rev.ptr, rev.ind, rev.src
        reversed_ = True
    form = build_level_form(
        ptr, ind, src, m, reversed_, dt == DiagType.unit, eff.val
    )
    form._eff = eff
    return form
