"""ILU(0) preconditioner.

Reference: sequential IKJ factorization in-place on a value copy
(aoclsparse_ilu0_factorization, solvers/aoclsparse_ilu0.hpp:37-112), L/U
substitution solve (:115-162), entry aoclsparse_?ilu_smoother
(aoclsparse_ilu.cpp); factorization runs once and is cached
(ilu0.hpp:180-195).

Split: the one-time factorization is host-side planner work (numpy now,
native C++ kernel slot in native/); the per-iteration APPLY — the part that
runs inside every preconditioned Krylov step — is two blocked triangular
solves on device (kernels/xla/trsv.py) over the cached LU values, exactly the
reference's L/U substitution but wavefront-blocked.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    Status,
)
from ..planner.plan import CleanCSR, build_effective_csr, get_plan
from ..planner.triangular import adaptive_nb, build_trsv_form

__all__ = ["IluState", "ilu0_factorize", "ilu_smoother"]


@dataclasses.dataclass
class IluState:
    lu: jnp.ndarray  # (nnz,) LU values on the clean structure
    lu_clean: CleanCSR  # clean structure with LU values
    l_form: object = None  # TrsvForm for unit-L solve
    u_form: object = None  # TrsvForm for U solve
    l_level: object = None  # LevelForm twins (built lazily on kid=1)
    u_level: object = None
    _eff_l: object = None
    _eff_u: object = None


def _ilu0_host(m, ptr, ind, val):
    """IKJ ILU(0) on the sorted CSR pattern (ilu0.hpp:37-112). One-time
    planner work, dispatched to the native C++ kernel
    (native/src/host_kernels.cpp ilu0_*) with a numpy fallback; raises the
    reference's statuses on missing diagonal / zero pivot
    (ilu0.hpp:76-77,97-101)."""
    from .. import native

    try:
        lu, _diag = native.ilu0_factor(m, ptr, ind, np.asarray(val))
    except ValueError as e:
        kind, _, row = str(e).partition(":")
        if kind == "missing_diag":
            raise AoclSparseError(
                Status.invalid_value, f"ILU0: missing diagonal in row {row}"
            ) from None
        raise AoclSparseError(Status.numerical_error, f"ILU0: zero pivot at row {row}") from None
    return lu


def ilu0_factorize(A: SparseMatrix) -> IluState:
    """Factorize once; cached on the handle (the reference's working-copy
    model, aoclsparse_optimize_ilu analysis.cpp:390-425)."""
    if A.ilu_state is not None:
        return A.ilu_state
    if A.shape[0] != A.shape[1]:
        raise AoclSparseError(Status.invalid_size, "ILU0 requires square A")
    plan = get_plan(A)
    clean = plan.clean
    lu = _ilu0_host(clean.m, clean.ptr, clean.ind, np.asarray(clean.val))
    lu_d = jnp.asarray(lu)
    lu_clean = CleanCSR(
        ptr=clean.ptr,
        ind=clean.ind,
        val=lu_d,
        perm=np.arange(lu.size, dtype=np.int64),
        idiag=clean.idiag,
        iurow=clean.iurow,
        has_diag=clean.has_diag,
        fulldiag=clean.fulldiag,
        shape=clean.shape,
    )
    st = IluState(lu=lu_d, lu_clean=lu_clean)
    # blocked solve forms over the LU values
    l_descr = MatrixDescriptor(
        type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.unit
    )
    u_descr = MatrixDescriptor(
        type=MatrixType.triangular, fill_mode=FillMode.upper, diag_type=DiagType.non_unit
    )
    nb = adaptive_nb(lu_clean.m, dtype=lu.dtype)

    # native C++ fast path: forms built straight off the clean split
    # pointers with the HOST lu (no effective-triangle materialization, no
    # device->host value fetch — those two were the bulk of the 21 s prep
    # gap of VERDICT r3 item 4). Fallback: the numpy build below.
    from ..planner.triangular import build_trsv_form_native

    # L and U builds are independent: run them concurrently — the native
    # fill releases the GIL (ctypes) and the two device uploads overlap
    import threading

    _res = {}

    def _build(slot, descr):
        try:
            _res[slot] = build_trsv_form_native(
                lu_clean, descr, Operation.none, ("ilu", slot), nb, lu
            )
        except Exception as e:  # surface on the caller thread
            _res[slot] = e

    th = threading.Thread(target=_build, args=("u", u_descr))
    th.start()
    _build("l", l_descr)
    th.join()
    for slot in ("l", "u"):
        err = _res[slot]
        if isinstance(err, AoclSparseError) and err.status == Status.memory_error:
            # structurally oversized blocked window (scircuit-class rail
            # reach): serve the apply from the level-scheduled sweeps
            # instead — circuit factor DAGs are shallow, exactly their
            # class (same routing as the default trsv fallback)
            st.l_form = st.u_form = None
            A.ilu_state = st
            return st
        if isinstance(err, Exception):
            raise err
    st.l_form = _res["l"]
    st.u_form = _res["u"]
    if st.l_form is None or st.u_form is None:
        try:
            return _ilu_numpy_forms(A, st, lu_clean, lu, l_descr, u_descr, nb)
        except AoclSparseError as e:
            if e.status != Status.memory_error:
                raise
            # both blocked variants oversized (hub-row ELL width): level
            # sweeps / host substitution serve the apply (built lazily by
            # the first consumer — eager builds here uploaded run arrays
            # the deep-DAG host route never touches)
            st.l_form = st.u_form = None
            A.ilu_state = st
            return st
    A.ilu_state = st
    return st


def _ilu_numpy_forms(A, st, lu_clean, lu, l_descr, u_descr, nb):
    """Numpy-builder fallback forms (win or padded-ELL left window; may
    raise memory_error on hub-row ELL widths — caller falls to levels)."""
    eff_l = build_effective_csr(lu_clean, l_descr, Operation.none)
    eff_u = build_effective_csr(lu_clean, u_descr, Operation.none)

    # host-side effective values over the native-factored lu: refresh()
    # fetches its argument to host, so passing the DEVICE eff.val here
    # paid two ~nnz/2 device->host fetches per factorization
    def _hv(eff):
        src = np.asarray(eff.src, dtype=np.int64)
        return np.where(
            src >= 0, lu[np.maximum(src, 0)], np.asarray(eff.const_val, dtype=lu.dtype)
        )

    st.l_form = build_trsv_form(
        lu_clean, l_descr, Operation.none, ("ilu", "l"), eff_l, nb, val_override=_hv(eff_l)
    )
    st.u_form = build_trsv_form(
        lu_clean, u_descr, Operation.none, ("ilu", "u"), eff_u, nb, val_override=_hv(eff_u)
    )
    st._eff_l = eff_l
    st._eff_u = eff_u
    A.ilu_state = st
    return st


def _ilu_eff_triangles(st: IluState):
    """Effective L/U triangle structures of the factor (cached on the
    state) — the shared input of the level-form builds AND the
    structure-only routing stats (no device uploads happen here)."""
    eff_l, eff_u = st._eff_l, st._eff_u
    if eff_l is None or eff_u is None:
        # checkpoint-restored states carry lu_clean but not the
        # effective triangles (io/checkpoint.py): rebuild them
        l_descr = MatrixDescriptor(
            type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.unit
        )
        u_descr = MatrixDescriptor(
            type=MatrixType.triangular,
            fill_mode=FillMode.upper,
            diag_type=DiagType.non_unit,
        )
        eff_l = build_effective_csr(st.lu_clean, l_descr, Operation.none)
        eff_u = build_effective_csr(st.lu_clean, u_descr, Operation.none)
        st._eff_l, st._eff_u = eff_l, eff_u
    return eff_l, eff_u


def _ilu_level_stats(st: IluState) -> int:
    """Total factor-DAG depth nlev(L)+nlev(U), computed STRUCTURE-ONLY
    via level_form_stats — the routing check before deciding between the
    wavefront sweeps and the sequential host substitution. Building the
    level forms just to read nlev would upload every run array to the
    device (the build-before-routing cost trsv avoids the same way,
    planner/triangular.py trsv_level_stats_for)."""
    from ..kernels.xla.trsv_level import level_form_stats
    from ..planner.triangular import _reverse_structure

    eff_l, eff_u = _ilu_eff_triangles(st)
    nlev_l, _ = level_form_stats(eff_l.ptr, eff_l.ind, eff_l.m)
    rev = _reverse_structure(eff_u)
    nlev_u, _ = level_form_stats(rev.ptr, rev.ind, eff_u.m)
    return nlev_l + nlev_u


def _ilu_level_forms(st: IluState):
    """Lazily build the level-scheduled twins of the factor sweeps
    (kernels/xla/trsv_level.py; the ILU0 analog of TRSV KID 1 — wins on
    shallow circuit-class factor DAGs)."""
    if st.l_level is None:
        from ..kernels.xla.trsv_level import build_level_form
        from ..planner.triangular import _reverse_structure

        eff_l, eff_u = _ilu_eff_triangles(st)
        st.l_level = build_level_form(
            eff_l.ptr,
            eff_l.ind,
            np.arange(eff_l.nnz, dtype=np.int64),
            eff_l.m,
            False,
            True,  # unit lower
            eff_l.val,
        )
        rev = _reverse_structure(eff_u)
        st.u_level = build_level_form(
            rev.ptr, rev.ind, rev.src, eff_u.m, True, False, eff_u.val
        )
    return st.l_level, st.u_level


def _apply_form(form, rhs):
    m_pad = form.nblk * form.nb
    r = rhs[:, None] if rhs.ndim == 1 else rhs
    if form.reversed_:
        r = r[::-1]
    if m_pad != form.m:
        r = jnp.pad(r, ((0, m_pad - form.m), (0, 0)))
    x = form.solve(r)[: form.m]
    if form.reversed_:
        x = x[::-1]
    return x[:, 0] if rhs.ndim == 1 else x


def ilu_smoother(
    A: SparseMatrix,
    descr: Optional[MatrixDescriptor] = None,
    b=None,
    op: Operation = Operation.none,
    kid: Optional[int] = None,
):
    """x = U^{-1} L^{-1} b over the cached ILU0 factors
    (aoclsparse_?ilu_smoother). Returns x; the LU working values are
    inspectable via ``A.ilu_state.lu`` (the precond_csr_val analog).
    kid selects the sweep engine like trsv: 0/None = blocked scan,
    1 = level-scheduled wavefront (shallow factor DAGs)."""
    if A is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    if Operation(op) != Operation.none:
        raise AoclSparseError(Status.not_implemented, "ilu_smoother supports op=none (parity)")
    if kid not in (None, 0, 1):
        raise AoclSparseError(Status.invalid_kid, f"ilu_smoother kid {kid}")
    st = ilu0_factorize(A)
    b = jnp.asarray(b).astype(A.dtype)
    if b.shape[0] != A.shape[0]:
        raise AoclSparseError(Status.invalid_size, "b size mismatch")
    if kid == 1 or st.l_form is None:
        # explicit level request, or the blocked windows were refused as
        # structurally oversized (factorize fell back to level sweeps).
        # Deep factor DAGs (scircuit-class: 20k+ levels) cost ~8 us/level
        # per sweep on device — eager callers take the sequential host
        # substitution instead (the reference's own apply, ilu0.hpp:115).
        import jax as _jax

        if kid is None and not isinstance(b, _jax.core.Tracer):
            # stats-first routing: read the DAG depth from structure
            # alone; the level forms are only built on the branch that
            # solves with them (ADVICE r4)
            if _ilu_level_stats(st) > 8192:
                bh = np.asarray(b)
                if bh.ndim == 1:
                    return jnp.asarray(_host_lu_apply(st, bh))
                # native trsv_seq is single-vector: sweep columns (the
                # host path is latency-, not throughput-, motivated)
                cols = [
                    _host_lu_apply(st, np.ascontiguousarray(bh[:, j]))
                    for j in range(bh.shape[1])
                ]
                return jnp.asarray(np.stack(cols, axis=1))
        l_lvl, u_lvl = _ilu_level_forms(st)
        return u_lvl.solve(l_lvl.solve(b))
    yz = _apply_form(st.l_form, b)
    return _apply_form(st.u_form, yz)


def _host_lu_apply(st: IluState, b: np.ndarray) -> np.ndarray:
    """Sequential host substitution over the cached LU values — the
    reference's own apply loop (ilu0.hpp:115-162), used for factor DAGs
    too deep for the wavefront engine. Triangle CSRs built once per
    factor state (value-refresh drops the state, so no staleness)."""
    from .. import native

    tri = getattr(st, "_host_tri", None)
    if tri is None:
        cl = st.lu_clean
        ptr = np.asarray(cl.ptr, dtype=np.int64)
        ind = np.asarray(cl.ind, dtype=np.int64)
        lu = np.asarray(st.lu)
        idiag = np.asarray(cl.idiag, dtype=np.int64)
        iurow = np.asarray(cl.iurow, dtype=np.int64)
        m = cl.m
        # unit-lower triangle: strict lower + explicit 1.0 diagonal
        lo_cnt = idiag - ptr[:-1]
        lptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(lo_cnt + 1, out=lptr[1:])
        lind = np.empty(int(lptr[-1]), dtype=np.int64)
        lval = np.empty(int(lptr[-1]), dtype=lu.dtype)
        take = _ranges_concat(ptr[:-1], idiag)
        ins = lptr[1:] - 1  # diagonal slot at each row end
        keep_mask = np.ones(lind.size, dtype=bool)
        keep_mask[ins] = False
        lind[keep_mask] = ind[take]
        lval[keep_mask] = lu[take]
        lind[ins] = np.arange(m)
        lval[ins] = 1.0
        # upper triangle incl. diagonal
        up_cnt = ptr[1:] - idiag
        uptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(up_cnt, out=uptr[1:])
        take_u = _ranges_concat(idiag, ptr[1:])
        uind = ind[take_u]
        uval = lu[take_u]
        tri = st._host_tri = (lptr, lind, lval, uptr, uind, uval, m)
    lptr, lind, lval, uptr, uind, uval, m = tri
    y = native.trsv_seq(m, lptr, lind, lval, b.astype(lval.dtype), True)
    return native.trsv_seq(m, uptr, uind, uval, y, False)


def _ranges_concat(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenate [lo_i, hi_i) index ranges (vectorized)."""
    cnt = (hi - lo).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(lo.size, dtype=np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    out = np.arange(total, dtype=np.int64)
    out += np.repeat(lo - starts, cnt)
    return out
