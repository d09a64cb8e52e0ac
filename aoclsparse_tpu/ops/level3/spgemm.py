"""SpGEMM family: sp2m / csr2m / spmm / sp2md / spmmd / syrk / syrkd /
sypr / syprd and sparse add.

Reference: two-stage Gustavson engine (level3/aoclsparse_csr2m.cpp:45-1125 —
symbolic nnz count with per-thread dense markers, then numeric with dense
accumulators), convenience spmm (aoclsparse_spmm.cpp:28), dense-out sp2md/
spmmd (aoclsparse_sp2md.{cpp,hpp}:130,223), syrk/syrkd, sypr/syprd
(aoclsparse_sypr.{cpp,hpp}), add (aoclsparse_csradd.{cpp,hpp}).

Redesign — *product expansion*: the request-stage split of the reference
maps cleanly onto XLA's static-shape model:

- SYMBOLIC (host, once per structure): enumerate every scalar product
  A[i,k]*B[k,j] as an index triple (pa, pb, pc) where pc is the position of
  C[i,j] in the output pattern. Fully vectorized numpy (sort/unique) — this
  is the nnz_count stage, and P = len(pa) is exactly the FLOP count the
  reference's Gustavson visits.
- NUMERIC (device, repeatable): Cval = segment_sum(Aval[pa]*Bval[pb], pc) —
  one jitted gather-multiply-reduce at the algorithm's arithmetic intensity.
  Re-runs after update_values without re-planning (the finalize stage,
  functions.h:2184-2201).

Descriptors/operations resolve through the planner's EffectiveCSR copies, so
symmetric/hermitian/triangular inputs and op(A) are handled uniformly.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...core.descr import GENERAL, MatrixDescriptor
from ...core.formats import CSR
from ...core.matrix import SparseMatrix
from ...core.types import (
    AoclSparseError,
    FormatType,
    MatrixType,
    Operation,
    Order,
    Request,
    Status,
    is_complex_dtype,
)
from ...planner.plan import get_plan

__all__ = [
    "sp2m",
    "csr2m",
    "spmm",
    "sp2md",
    "spmmd",
    "syrk",
    "syrkd",
    "sypr",
    "syprd",
    "add",
]


# ---------------------------------------------------------------------------
# symbolic engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpgemmPlan:
    """Product-expansion plan (the cached symbolic stage)."""

    shape: Tuple[int, int]
    ptr: np.ndarray  # (m+1,) C row pointers
    ind: np.ndarray  # (nnzC,) C column indices
    pa: Optional[jax.Array]  # (P,) into A values (None: pattern-only plan)
    pb: Optional[jax.Array]  # (P,) into B values
    pc: Optional[jax.Array]  # (P,) into C values (sorted)
    nnz: int
    conj_a: bool = False
    conj_b: bool = False
    band: object = None  # BandGemmPlan when both operands band-compress
    P: Optional[int] = None  # product count (populated even without pa/pb/pc)


def _effective(h: SparseMatrix, descr: MatrixDescriptor, op: Operation):
    """Resolve (handle, descr, op) to an EffectiveCSR via the planner."""
    return get_plan(h).effective_for(descr, op, h.dtype)


def _expand(Aptr, Aind, Bptr, Bind, mA) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized product enumeration: returns (rows, pa, pb)."""
    Aptr = Aptr.astype(np.int64)
    Bptr = Bptr.astype(np.int64)
    a_rows = np.repeat(np.arange(mA, dtype=np.int64), np.diff(Aptr))
    b_counts = np.diff(Bptr)[Aind.astype(np.int64)]  # products per A entry
    P = int(b_counts.sum())
    if P == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    pa = np.repeat(np.arange(Aind.size, dtype=np.int64), b_counts)
    # within-group offsets 0..count-1
    firsts = np.zeros(Aind.size + 1, dtype=np.int64)
    np.cumsum(b_counts, out=firsts[1:])
    within = np.arange(P, dtype=np.int64) - firsts[:-1][pa]
    pb = Bptr[Aind.astype(np.int64)][pa] + within
    rows = a_rows[pa]
    return rows, pa, pb


def _symbolic(
    effA, effB, upper_only: bool = False, conj_a=False, conj_b=False
) -> SpgemmPlan:
    mA, nA = effA.shape
    mB, nB = effB.shape
    if nA != mB:
        raise AoclSparseError(Status.invalid_size, f"inner dims mismatch {nA} vs {mB}")
    # native C++ Gustavson expansion (~100x the numpy sort path)
    from ... import native

    nat = native.spgemm_expand(mA, effA.ptr, effA.ind, effB.ptr, effB.ind, upper_only)
    if nat is not None:
        pa, pb, pc, Cptr, Cind = nat
        # triples stay HOST-side: the host numeric engine is the large-P
        # default and consumes numpy; the device expansion engine uploads
        # lazily (FEM-scale products are multi-GB — pwtk A@A: 7 GB)
        return SpgemmPlan(
            shape=(mA, nB),
            ptr=Cptr.astype(np.int32),
            ind=Cind.astype(np.int32),
            pa=pa,
            pb=pb,
            pc=pc,
            nnz=int(Cind.size),
            conj_a=conj_a,
            conj_b=conj_b,
            P=int(pa.size),
        )
    rows, pa, pb = _expand(effA.ptr, effA.ind, effB.ptr, effB.ind, mA)
    cols = effB.ind.astype(np.int64)[pb] if pb.size else pb
    if upper_only:
        keep = cols >= rows
        rows, cols, pa, pb = rows[keep], cols[keep], pa[keep], pb[keep]
    keys = rows * nB + cols
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    uniq_mask = np.ones(keys_s.size, dtype=bool)
    if keys_s.size:
        uniq_mask[1:] = keys_s[1:] != keys_s[:-1]
    pc = np.cumsum(uniq_mask) - 1 if keys_s.size else keys_s
    ukeys = keys_s[uniq_mask] if keys_s.size else keys_s
    nnzC = int(ukeys.size)
    Cind = (ukeys % nB).astype(np.int32)
    Crows = (ukeys // nB).astype(np.int64)
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    if nnzC:
        np.add.at(Cptr, Crows + 1, 1)
    Cptr = np.cumsum(Cptr)
    return SpgemmPlan(
        shape=(mA, nB),
        ptr=Cptr.astype(np.int32),
        ind=Cind,
        pa=np.asarray(pa[order]),
        pb=np.asarray(pb[order]),
        pc=np.asarray(pc),
        nnz=nnzC,
        conj_a=conj_a,
        conj_b=conj_b,
        P=int(pa.size),
    )


@partial(jax.jit, static_argnames=("nnz", "conj_a", "conj_b"))
def _numeric(Aval, Bval, pa, pb, pc, nnz: int, conj_a: bool, conj_b: bool):
    a = Aval[pa]
    b = Bval[pb]
    if conj_a and jnp.iscomplexobj(a):
        a = jnp.conj(a)
    if conj_b and jnp.iscomplexobj(b):
        b = jnp.conj(b)
    return jax.ops.segment_sum(a * b, pc, num_segments=nnz, indices_are_sorted=True)


def _operand_seed(H: SparseMatrix, descr: MatrixDescriptor, op) -> Optional[object]:
    """A band-engine product handle's seeded bwdg form, reusable as a
    chained-GEMM operand band iff the operand is consumed untransformed
    (general descriptor, op none — the band holds plain unconjugated
    values) and the handle's values haven't been swapped since seeding."""
    seed = getattr(H, "_seed_bwdg", None)
    if seed is None:
        return None
    # values_pending certifies freshness without materializing the lazy
    # extraction (seed and thunk were created by the same numeric pass)
    if not H.values_pending and getattr(H, "_seed_bwdg_val", None) is not H.data.val:
        return None
    if Operation(op) != Operation.none:
        return None
    if MatrixType(descr.type) != MatrixType.general:
        return None
    return seed


def _attach_band_plan(plan: "SpgemmPlan", effA, effB, seedA=None, seedB=None) -> None:
    """Attach the band x band numeric plan when both operands compress and
    AOCLSPARSE_TPU_FORCE_BANDGEMM=1 asks for it (the default numeric is
    the host Gustavson above 2^17 products and the device segment-sum
    below). seedA/seedB: ready device bands of operands that are
    themselves band-engine products (chained GEMM — no host relayout, no
    first refresh)."""
    import os

    if os.environ.get("AOCLSPARSE_TPU_NO_BANDGEMM", "0") in ("1", "true"):
        return
    force = os.environ.get("AOCLSPARSE_TPU_FORCE_BANDGEMM", "0") in ("1", "true")
    if not force:
        return
    from ...kernels.xla.spgemm_band import build_band_gemm_plan

    if plan.conj_a:
        seedA = None  # band holds unconjugated values
    if plan.conj_b:
        seedB = None
    G = 32
    band = build_band_gemm_plan(
        effA, effB, plan.ptr, plan.ind, G=G, force=force,
        formA_pre=seedA, formB_pre=seedB,
    )
    if band is None and (seedA is not None or seedB is not None):
        # seeded windows can be wider than tight ones and overflow the
        # stream/cost limits — retry with host-built tight operands
        seedA = seedB = None
        band = build_band_gemm_plan(effA, effB, plan.ptr, plan.ind, G=G, force=force)
    if band is not None:
        if band.formA is seedA:
            band._valA_src = effA.val  # band already holds these values
        if band.formB is seedB:
            band._valB_src = effB.val
        plan.band = band


def _band_estimate(effA, effB, G: int = 512):
    """Cheap band-vs-expansion cost estimate WITHOUT building anything:
    the same cost model as build_band_gemm_plan, computed from the raw
    window statistics. Returns (est_band_s, est_exp_s) or None
    when the operands don't band-compress."""
    from ...planner.plan import BWD_MAX_W

    mA, nA = effA.shape
    mB, nB = effB.shape
    if mA == 0 or effA.nnz == 0 or effB.nnz == 0:
        return None
    if -(-mA // G) != -(-mB // G):
        return None

    def win(eff):
        rows = np.repeat(np.arange(eff.m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
        rel = eff.ind.astype(np.int64) - G * (rows // G)
        lo = (int(rel.min()) // 8) * 8
        return -(-(int(rel.max()) - lo + 1) // 8) * 8, lo

    WA, relA = win(effA)
    WB, relB = win(effB)
    if WA > 2 * BWD_MAX_W or WB > 2 * BWD_MAX_W:
        return None
    d0 = relA // G
    sl0 = relA - G * d0
    nstream = -(-(sl0 + WA) // G)
    if nstream > 6:
        return None
    WC = G * (nstream - 1) + WB
    nblk = -(-mA // G)
    if nblk * G * WC * 4 > 8e9:
        return None
    P = float(np.diff(effB.ptr.astype(np.int64))[effA.ind.astype(np.int64)].sum())
    est_exp = 3.0 * P * 13e-9
    est_band = (
        (mA * WA + (1.0 + nstream) * mB * WB + 2.0 * nblk * G * WC) * 4 / 250e9
        + (nblk * G * WA * WB * 2.0) / 20e12
    )
    return est_band, est_exp


def _symbolic_auto(effA, effB, seedA=None, seedB=None) -> "SpgemmPlan":
    """Band-first symbolic stage: when the cost model predicts the band
    numeric engine, build ONLY C's pattern (native spgemm_pattern) and skip
    the O(P) product-expansion triples — at FEM-scale products (cant A@A:
    285M) the triples cost ~7 GB of host memory plus a device upload the
    band engine never reads (round-4 real-matrix sweep measured 72 s
    end-to-end; pattern-only lands in seconds). Falls back to the full
    expansion when the band plan doesn't attach."""
    import os

    force = os.environ.get("AOCLSPARSE_TPU_FORCE_BANDGEMM", "0") in ("1", "true")
    no_band = os.environ.get("AOCLSPARSE_TPU_NO_BANDGEMM", "0") in ("1", "true")
    if force and not no_band:
        est = _band_estimate(effA, effB, G=32)
        if est is not None:
            from ... import native

            pat = native.spgemm_pattern(
                effA.shape[0], effA.ptr, effA.ind, effB.ptr, effB.ind
            )
            if pat is not None:
                Cptr, Cind, P = pat
                plan = SpgemmPlan(
                    shape=(effA.shape[0], effB.shape[1]),
                    ptr=Cptr.astype(np.int32),
                    ind=Cind,
                    pa=None,
                    pb=None,
                    pc=None,
                    nnz=int(Cind.size),
                    P=P,
                )
                _attach_band_plan(plan, effA, effB, seedA=seedA, seedB=seedB)
                if plan.band is not None:
                    return plan
    plan = _symbolic(effA, effB)
    _attach_band_plan(plan, effA, effB, seedA=seedA, seedB=seedB)
    return plan


def _ensure_expansion(plan: "SpgemmPlan", effA, effB) -> None:
    """Backfill the product-expansion triples on a pattern-only plan (the
    band engine was dropped or an expansion engine was explicitly
    requested)."""
    if plan.pa is not None:
        return
    full = _symbolic(effA, effB, conj_a=plan.conj_a, conj_b=plan.conj_b)
    plan.pa, plan.pb, plan.pc = full.pa, full.pb, full.pc
    plan.P = full.P


def _seed_cband(out: SparseMatrix, plan: "SpgemmPlan", dtype) -> None:
    """Band-form C output: when the numeric stage ran on the band engine,
    hand its device-resident (nblk, G, WC) C band to the result handle as a
    pre-seeded ``bwdg`` exec form — a chained mv on the product then runs
    straight on the band (no CSR extraction gather, no host relayout).
    Applied lazily at the handle's first get_plan."""
    band = plan.band
    cb = getattr(band, "_last_cband", None) if band is not None else None
    if cb is None:
        return
    from ...kernels.xla.spgemm_band import cband_exec_form

    out._seed_bwdg = cband_exec_form(band, cb, plan.shape[0], plan.shape[1], dtype)
    # tie the seed to the value array it extracts to: set_value/update_values
    # swap data.val, making a pending (not yet planted) band stale. With lazy
    # values there is no concrete array yet — the data property seats the key
    # at materialization (core/matrix.py), and values_pending itself certifies
    # freshness meanwhile (seed + thunk were created together).
    out._seed_bwdg_val = None if out.values_pending else out.data.val


def _lazy_values_enabled() -> bool:
    """Lazy band-product values (skip the CSR extraction gather until
    someone actually reads CSR values): off unless
    AOCLSPARSE_TPU_LAZY_SPGEMM=1."""
    import os

    return os.environ.get("AOCLSPARSE_TPU_LAZY_SPGEMM", "0") in ("1", "true")


def _numeric_auto(plan: "SpgemmPlan", effA, effB, conj_a: bool, conj_b: bool, lazy=False):
    """Run the numeric stage through the band fast path when attached.

    With ``lazy=True`` (band engine only) the C band is computed but the
    CSR extraction gather is deferred: returns ``("lazy", thunk)`` where
    the thunk yields the CSR-ordered values on demand."""
    import os

    use_host = getattr(plan, "_host_engine", False) or os.environ.get(
        "AOCLSPARSE_TPU_SPGEMM_HOST", "0"
    ) in ("1", "true")
    if plan.band is not None and not use_host:
        from ...kernels.xla.spgemm_band import band_gemm_cband

        # cache the conjugated value arrays on the plan keyed by the source
        # array reference: a fresh jnp.conj per call would defeat the band
        # cache's is-identity staleness check (full refresh every finalize)
        def _conj_cached(tag, v, want_conj):
            if not (want_conj and jnp.iscomplexobj(v)):
                return v
            src_key, out_key = f"_conj_src_{tag}", f"_conj_out_{tag}"
            if getattr(plan, src_key, None) is not v:
                setattr(plan, out_key, jnp.conj(v))
                setattr(plan, src_key, v)
            return getattr(plan, out_key)

        va = _conj_cached("a", effA.val, conj_a)
        vb = _conj_cached("b", effB.val, conj_b)
        band = plan.band
        cband = band_gemm_cband(band, va, vb)
        band._last_cband = cband
        if lazy:
            # extraction route: the CSR-order extraction is a device gather
            # while the native host numeric writes ind/val directly
            # (reference csr2m.cpp:305 style). autotune_spgemm
            # measures both and pins plan._extract_route; chained mv on the
            # product still rides the band either way (_seed_cband).
            if getattr(plan, "_extract_route", "gather") == "host":

                def _host_extract(va=va, vb=vb):
                    from ... import native as _nat

                    _ensure_expansion(plan, effA, effB)
                    av_h = np.asarray(va)
                    bv_h = np.asarray(vb)
                    cv = _nat.spgemm_numeric_host(
                        np.asarray(plan.pa), np.asarray(plan.pb),
                        np.asarray(plan.pc), av_h, bv_h, plan.nnz,
                    )
                    if cv is not None:
                        return jnp.asarray(cv)
                    return cband.reshape(-1)[jnp.asarray(band.extract_idx)]

                return ("lazy", _host_extract)
            return ("lazy", lambda: cband.reshape(-1)[jnp.asarray(band.extract_idx)])
        return cband.reshape(-1)[jnp.asarray(band.extract_idx)]
    _ensure_expansion(plan, effA, effB)  # pattern-only plan, band dropped
    # HOST engine: the reference's threaded numeric Gustavson
    # (csr2m.cpp:405-545) on the expansion plan — race-free output-range
    # threading over the sorted pc. autotune_spgemm pins it per plan, or
    # AOCLSPARSE_TPU_SPGEMM_HOST=1 forces it (the env override beats an
    # attached band plan, checked above). Without a band plan, the host
    # engine is the DEFAULT above 2^17 products when the native library is
    # present; the device expansion pays three gathers per product. The
    # crossover has not been re-timed on the GPU (PERF.md).
    if (
        not use_host
        and plan.P
        and plan.P > (1 << 17)
        and os.environ.get("AOCLSPARSE_TPU_SPGEMM_DEVICE", "0") not in ("1", "true")
    ):
        from ... import native as _nat_probe

        use_host = _nat_probe.available()
    if use_host and plan.nnz:
        from ... import native

        av = np.asarray(effA.val)
        bv = np.asarray(effB.val)
        if conj_a and np.iscomplexobj(av):
            av = np.conj(av)
        if conj_b and np.iscomplexobj(bv):
            bv = np.conj(bv)
        cv = native.spgemm_numeric_host(
            np.asarray(plan.pa), np.asarray(plan.pb), np.asarray(plan.pc), av, bv, plan.nnz
        )
        if cv is not None:
            return jnp.asarray(cv)
    # device expansion engine: upload the triples once and cache (plans are
    # reused across finalize calls; the triples are host numpy by default)
    trip = getattr(plan, "_dev_triples", None)
    if trip is None:
        trip = plan._dev_triples = (
            jnp.asarray(plan.pa),
            jnp.asarray(plan.pb),
            jnp.asarray(plan.pc),
        )
    return _numeric(effA.val, effB.val, trip[0], trip[1], trip[2], plan.nnz, conj_a, conj_b)


# ---------------------------------------------------------------------------
# sp2m / csr2m / spmm (sparse out)
# ---------------------------------------------------------------------------


def _check_handles(*hs):
    for h in hs:
        if h is None:
            raise AoclSparseError(Status.invalid_pointer, "null matrix handle")


def sp2m(
    opA: Operation,
    descrA: MatrixDescriptor,
    A: SparseMatrix,
    opB: Operation,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    request: Request = Request.full_computation,
    C: Optional[SparseMatrix] = None,
) -> SparseMatrix:
    """C = op(descrA(A)) @ op(descrB(B))  (aoclsparse_sp2m, csr2m.cpp:546).

    Two-stage protocol: request=nnz_count builds the structure (values zero),
    request=finalize recomputes values on the cached plan (C from a prior
    call), request=full_computation does both.
    """
    _check_handles(A, B)
    descrA.validate()
    descrB.validate()
    request = Request(request)
    if request == Request.finalize:
        if C is None or getattr(C, "_spgemm_plan", None) is None:
            raise AoclSparseError(
                Status.invalid_value, "finalize requires C from a prior nnz_count stage"
            )
        plan: SpgemmPlan = C._spgemm_plan
        effA = _effective(A, descrA, opA)
        effB = _effective(B, descrB, opB)
        lazy = plan.band is not None and _lazy_values_enabled()
        val = _numeric_auto(plan, effA, effB, plan.conj_a, plan.conj_b, lazy=lazy)
        dtype = jnp.result_type(effA.val.dtype, effB.val.dtype)
        if lazy:
            thunk = val[1]
            C.set_lazy_values(
                plan.ptr, plan.ind, plan.shape, dtype, lambda: thunk().astype(dtype)
            )
        else:
            C.data = CSR(plan.ptr, plan.ind, val, shape=plan.shape)
        # the handle's cached plan (if any) holds pre-finalize values
        C.invalidate()
        _seed_cband(C, plan, dtype)
        return C
    effA = _effective(A, descrA, Operation(opA))
    effB = _effective(B, descrB, Operation(opB))
    plan = _symbolic_auto(
        effA,
        effB,
        seedA=_operand_seed(A, descrA, opA),
        seedB=_operand_seed(B, descrB, opB),
    )
    dtype = jnp.result_type(A.dtype, B.dtype)
    if request == Request.nnz_count:
        val = jnp.zeros((plan.nnz,), dtype=dtype)
    else:
        lazy = plan.band is not None and _lazy_values_enabled()
        val = _numeric_auto(plan, effA, effB, False, False, lazy=lazy)
        if lazy:
            thunk = val[1]
            out = SparseMatrix(None, FormatType.csr)
            out.set_lazy_values(
                plan.ptr, plan.ind, plan.shape, dtype, lambda: thunk().astype(dtype)
            )
            out._spgemm_plan = plan
            _seed_cband(out, plan, dtype)
            return out
    out = SparseMatrix(CSR(plan.ptr, plan.ind, val.astype(dtype), shape=plan.shape), FormatType.csr)
    out._spgemm_plan = plan
    if request == Request.full_computation:
        _seed_cband(out, plan, dtype)
    return out


def csr2m(
    opA: Operation,
    descrA: MatrixDescriptor,
    A: SparseMatrix,
    opB: Operation,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    request: Request = Request.full_computation,
    C: Optional[SparseMatrix] = None,
) -> SparseMatrix:
    """Legacy two-matrix product on the same engine (aoclsparse_?csr2m,
    level3/aoclsparse_csr2m.cpp:45; wrapper csr2m_wrapper.cpp:26)."""
    return sp2m(opA, descrA, A, opB, descrB, B, request, C)


def spmm(A: SparseMatrix, B: SparseMatrix, op: Operation = Operation.none) -> SparseMatrix:
    """Convenience C = op(A) @ B (aoclsparse_spmm, level3/aoclsparse_spmm.cpp:28)."""
    return sp2m(op, GENERAL, A, Operation.none, GENERAL, B, Request.full_computation)


# ---------------------------------------------------------------------------
# dense-out: sp2md / spmmd
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("shape", "conj_a", "conj_b"))
def _numeric_dense(Aval, Bval, pa, pb, rows, cols, alpha, beta, C0, shape, conj_a, conj_b):
    a = Aval[pa]
    b = Bval[pb]
    if conj_a and jnp.iscomplexobj(a):
        a = jnp.conj(a)
    if conj_b and jnp.iscomplexobj(b):
        b = jnp.conj(b)
    acc = jnp.zeros(shape, dtype=C0.dtype).at[rows, cols].add((a * b).astype(C0.dtype))
    return alpha * acc + beta * C0


def sp2md(
    opA: Operation,
    descrA: MatrixDescriptor,
    A: SparseMatrix,
    opB: Operation,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    alpha,
    beta=0.0,
    C=None,
    order: Order = Order.row,
):
    """Dense C = alpha*op(A)op(B) + beta*C (aoclsparse_?sp2md,
    level3/aoclsparse_sp2md.cpp:130)."""
    _check_handles(A, B)
    effA = _effective(A, descrA, Operation(opA))
    effB = _effective(B, descrB, Operation(opB))
    mA, nA = effA.shape
    mB, nB = effB.shape
    if nA != mB:
        raise AoclSparseError(Status.invalid_size, f"inner dims mismatch {nA} vs {mB}")
    rows, pa, pb = _expand(effA.ptr, effA.ind, effB.ptr, effB.ind, mA)
    cols = effB.ind.astype(np.int64)[pb] if pb.size else pb
    dtype = jnp.result_type(A.dtype, B.dtype)
    if C is None:
        C0 = jnp.zeros((mA, nB), dtype=dtype)
    else:
        C0 = (jnp.asarray(C).T if Order(order) == Order.column else jnp.asarray(C)).astype(dtype)
        if C0.shape != (mA, nB):
            raise AoclSparseError(
                Status.invalid_size, f"C must be ({mA},{nB}), got {tuple(C0.shape)}"
            )
        if np.isscalar(beta) and beta == 0:
            # beta == 0: C is not read (overwrite even NaN/Inf C; the
            # csrmv_kr.hpp:54-56 convention shared across the reference)
            C0 = jnp.zeros((mA, nB), dtype=dtype)
    out = _numeric_dense(
        effA.val,
        effB.val,
        jnp.asarray(pa),
        jnp.asarray(pb),
        jnp.asarray(rows),
        jnp.asarray(cols),
        jnp.asarray(alpha, dtype),
        jnp.asarray(beta, dtype),
        C0,
        (mA, nB),
        False,
        False,
    )
    return out.T if Order(order) == Order.column else out


def spmmd(
    A: SparseMatrix,
    B: SparseMatrix,
    op: Operation = Operation.none,
    order: Order = Order.row,
):
    """Dense C = op(A) @ B (aoclsparse_?spmmd)."""
    return sp2md(op, GENERAL, A, Operation.none, GENERAL, B, 1.0, 0.0, None, order)


# ---------------------------------------------------------------------------
# syrk / syrkd — C = A op(A) or op(A) A, upper-triangle result
# ---------------------------------------------------------------------------


def _syrk_plan(A: SparseMatrix, opA: Operation):
    opA = Operation(opA)
    cplx = is_complex_dtype(A.dtype)
    if cplx and opA == Operation.transpose:
        raise AoclSparseError(
            Status.not_implemented, "syrk: transpose unsupported for complex (reference parity)"
        )
    effA = _effective(A, GENERAL, Operation.none)
    effAt = _effective(A, GENERAL, Operation.transpose)
    if opA == Operation.none:
        # C = A * op(A): op(A) = A^T (real) or A^H (complex) = conj on values
        return effA, effAt, False, cplx
    # C = op(A) * A
    return effAt, effA, cplx, False


def syrk(opA: Operation, A: SparseMatrix) -> SparseMatrix:
    """C = A·op(A) (none) or op(A)·A; upper-triangle sparse sym/herm result
    (aoclsparse_syrk, level3/aoclsparse_syrk.cpp)."""
    _check_handles(A)
    effL, effR, conj_a, conj_b = _syrk_plan(A, opA)
    plan = _symbolic(effL, effR, upper_only=True, conj_a=conj_a, conj_b=conj_b)
    _attach_band_plan(plan, effL, effR)
    val = _numeric_auto(plan, effL, effR, conj_a, conj_b)
    out = SparseMatrix(CSR(plan.ptr, plan.ind, val, shape=plan.shape), FormatType.csr)
    out._spgemm_plan = plan
    # no band seeding here: the band holds the FULL product while the stored
    # pattern is upper-only, so an mv over the band would add the lower triangle
    return out


def syrkd(opA: Operation, A: SparseMatrix, alpha, beta=0.0, C=None, order: Order = Order.row):
    """Dense C = alpha·A·op(A) + beta·C upper triangle (aoclsparse_?syrkd).
    For complex dtypes only the real parts of alpha/beta are used to keep C
    Hermitian (reference note)."""
    _check_handles(A)
    effL, effR, conj_a, conj_b = _syrk_plan(A, opA)
    m = effL.shape[0]
    rows, pa, pb = _expand(effL.ptr, effL.ind, effR.ptr, effR.ind, m)
    cols = effR.ind.astype(np.int64)[pb] if pb.size else pb
    keep = cols >= rows
    rows, cols, pa, pb = rows[keep], cols[keep], pa[keep], pb[keep]
    dtype = A.dtype
    if is_complex_dtype(dtype):
        alpha = complex(np.real(alpha))
        beta = complex(np.real(beta))
    if C is None:
        C0 = jnp.zeros((m, m), dtype=dtype)
    else:
        C0 = (jnp.asarray(C).T if Order(order) == Order.column else jnp.asarray(C)).astype(dtype)
        if C0.shape != (m, m):
            raise AoclSparseError(
                Status.invalid_size, f"C must be ({m},{m}), got {tuple(C0.shape)}"
            )
    # beta == 0: the accumulate must not read C (NaN/Inf overwrite,
    # csrmv_kr.hpp:54-56 convention); the strict-lower passthrough below
    # still returns the caller's C verbatim
    C0_acc = (
        jnp.zeros((m, m), dtype=dtype) if (np.isscalar(beta) and beta == 0) else C0
    )
    out = _numeric_dense(
        effL.val,
        effR.val,
        jnp.asarray(pa),
        jnp.asarray(pb),
        jnp.asarray(rows),
        jnp.asarray(cols),
        jnp.asarray(alpha, dtype),
        jnp.asarray(beta, dtype),
        C0_acc,
        (m, m),
        conj_a,
        conj_b,
    )
    # the reference's beta loops only touch j >= i (aoclsparse_syrkd.hpp):
    # the caller's strict lower triangle passes through unscaled
    triu = jnp.arange(m)[:, None] <= jnp.arange(m)[None, :]
    out = jnp.where(triu, out, C0)
    return out.T if Order(order) == Order.column else out


# ---------------------------------------------------------------------------
# sypr / syprd — symmetric triple products
# ---------------------------------------------------------------------------


def sypr(
    opA: Operation,
    A: SparseMatrix,
    descrB: MatrixDescriptor,
    B: SparseMatrix,
    request: Request = Request.full_computation,
    C: Optional[SparseMatrix] = None,
) -> SparseMatrix:
    """C = A·B·A^{T/H} (op none) or op(A)·B·A, B sym/herm; upper-tri sparse
    result (aoclsparse_sypr, functions.h:2150-2258)."""
    _check_handles(A, B)
    opA = Operation(opA)
    cplx = is_complex_dtype(A.dtype)
    if cplx and opA == Operation.transpose:
        raise AoclSparseError(Status.not_implemented, "sypr: transpose only for real dtypes")
    if MatrixType(descrB.type) not in (MatrixType.symmetric, MatrixType.hermitian):
        raise AoclSparseError(Status.invalid_value, "sypr requires symmetric/hermitian B")
    effB = _effective(B, descrB, Operation.none)
    effA = _effective(A, GENERAL, Operation.none)
    effAt = _effective(A, GENERAL, Operation.transpose)
    if opA == Operation.none:
        # C = A · B · A^{T or H}
        L, M_, R = effA, effB, effAt
        conj_r = cplx
        conj_l = False
    else:
        # C = op(A) · B · A
        L, M_, R = effAt, effB, effA
        conj_l = cplx
        conj_r = False
    if request == Request.finalize and C is not None and getattr(C, "_sypr_plan", None):
        plan1, plan2 = C._sypr_plan
        t_val = _numeric(L.val, M_.val, plan1.pa, plan1.pb, plan1.pc, plan1.nnz, conj_l, False)
        val = _numeric(t_val, R.val, plan2.pa, plan2.pb, plan2.pc, plan2.nnz, False, conj_r)
        C.data = CSR(plan2.ptr, plan2.ind, val, shape=plan2.shape)
        return C
    # stage 1: T = L @ M
    plan1 = _symbolic(L, M_)
    t_val = _numeric(L.val, M_.val, plan1.pa, plan1.pb, plan1.pc, plan1.nnz, conj_l, False)
    from ...planner.plan import EffectiveCSR

    effT = EffectiveCSR(plan1.ptr, plan1.ind, np.arange(plan1.nnz), False, 0.0, plan1.shape)
    effT.val = t_val
    # stage 2: C = T @ R, upper triangle
    plan2 = _symbolic(effT, R, upper_only=True)
    if request == Request.nnz_count:
        val = jnp.zeros((plan2.nnz,), dtype=A.dtype)
    else:
        val = _numeric(t_val, R.val, plan2.pa, plan2.pb, plan2.pc, plan2.nnz, False, conj_r)
    out = SparseMatrix(CSR(plan2.ptr, plan2.ind, val, shape=plan2.shape), FormatType.csr)
    out._sypr_plan = (plan1, plan2)
    return out


def syprd(
    op: Operation,
    A: SparseMatrix,
    B,
    alpha,
    beta=0.0,
    C=None,
    order: Order = Order.row,
):
    """Dense C = alpha·A·B·op(A) + beta·C with dense sym/herm B
    (aoclsparse_?syprd, functions.h:2766-2890). Dense B is taken as stored
    (full), computations use it directly; C returned full with the upper
    triangle authoritative like the reference."""
    _check_handles(A)
    op = Operation(op)
    B = jnp.asarray(B)
    if Order(order) == Order.column:
        B = B.T
    cplx = is_complex_dtype(A.dtype)
    if cplx and op == Operation.transpose:
        raise AoclSparseError(Status.not_implemented, "syprd: transpose only for real dtypes")
    if (not cplx) and op == Operation.conjugate_transpose:
        op = Operation.transpose
    m, n = A.shape
    if op == Operation.none:
        if B.shape != (n, n):
            raise AoclSparseError(Status.invalid_size, f"B must be ({n},{n})")
    else:
        if B.shape != (m, m):
            raise AoclSparseError(Status.invalid_size, f"B must be ({m},{m})")
    from ..level3.csrmm import mm as _mm

    dtype = jnp.result_type(A.dtype, B.dtype)
    if cplx:
        alpha = complex(np.real(alpha))
        beta = complex(np.real(beta))
    # stage 1: T = op(A) @ B (mm keeps the sparse operand on the left)
    T = _mm(1.0, A, GENERAL, op, B.astype(dtype), 0.0)
    # stage 2: right-multiply by the remaining A factor, re-using mm by
    # computing the (conjugate-)transpose of the result instead:
    if op == Operation.none:
        # C = T @ A^{T or H}; C^H = A @ T^H (complex) / C^T = A @ T^T (real)
        rhs = jnp.conj(T).T if cplx else T.T
        Ct = _mm(1.0, A, GENERAL, Operation.none, rhs, 0.0)
        Cnew = jnp.conj(Ct).T if cplx else Ct.T
    else:
        # C = T @ A; C^T = A^T @ T^T
        Ct = _mm(1.0, A, GENERAL, Operation.transpose, T.T, 0.0)
        Cnew = Ct.T
    mC = Cnew.shape[0]
    if C is None:
        C0 = jnp.zeros((mC, mC), dtype=dtype)
    else:
        C0 = (jnp.asarray(C).T if Order(order) == Order.column else jnp.asarray(C)).astype(dtype)
        if C0.shape != (mC, mC):
            raise AoclSparseError(
                Status.invalid_size, f"C must be ({mC},{mC}), got {tuple(C0.shape)}"
            )
    if np.isscalar(beta) and beta == 0:
        # beta == 0: C not read (NaN/Inf overwrite, csrmv_kr.hpp:54-56)
        out = jnp.asarray(alpha, dtype) * Cnew.astype(dtype)
    else:
        out = jnp.asarray(alpha, dtype) * Cnew.astype(dtype) + jnp.asarray(beta, dtype) * C0
    return out.T if Order(order) == Order.column else out


# ---------------------------------------------------------------------------
# add — C = alpha*op(A) + B
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("nnz",))
def _add_numeric(Aval, Bval, srcA, srcB, alpha, nnz: int):
    a = jnp.where(srcA >= 0, Aval[jnp.clip(srcA, 0)], jnp.zeros((), Aval.dtype))
    b = jnp.where(srcB >= 0, Bval[jnp.clip(srcB, 0)], jnp.zeros((), Bval.dtype))
    return alpha * a + b


def add(op: Operation, alpha, A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    """C = alpha*op(A) + B (aoclsparse_?add, level3/aoclsparse_csradd.hpp:50,226
    two-pass merge)."""
    _check_handles(A, B)
    effA = _effective(A, GENERAL, Operation(op))
    effB = _effective(B, GENERAL, Operation.none)
    if effA.shape != effB.shape:
        raise AoclSparseError(Status.invalid_size, f"{effA.shape} + {effB.shape}")
    m, n = effA.shape
    rowsA = np.repeat(np.arange(m, dtype=np.int64), np.diff(effA.ptr.astype(np.int64)))
    rowsB = np.repeat(np.arange(m, dtype=np.int64), np.diff(effB.ptr.astype(np.int64)))
    keysA = rowsA * n + effA.ind.astype(np.int64)
    keysB = rowsB * n + effB.ind.astype(np.int64)
    allk = np.concatenate([keysA, keysB])
    ukeys = np.unique(allk)
    nnzC = ukeys.size
    srcA = np.full(nnzC, -1, dtype=np.int64)
    srcB = np.full(nnzC, -1, dtype=np.int64)
    srcA[np.searchsorted(ukeys, keysA)] = np.arange(keysA.size)
    srcB[np.searchsorted(ukeys, keysB)] = np.arange(keysB.size)
    Cind = (ukeys % n).astype(np.int32)
    Crows = ukeys // n
    Cptr = np.zeros(m + 1, dtype=np.int64)
    if nnzC:
        np.add.at(Cptr, Crows + 1, 1)
    Cptr = np.cumsum(Cptr).astype(np.int32)
    dtype = jnp.result_type(A.dtype, B.dtype)
    val = _add_numeric(
        effA.val.astype(dtype),
        effB.val.astype(dtype),
        jnp.asarray(srcA),
        jnp.asarray(srcB),
        jnp.asarray(alpha, dtype),
        nnzC,
    )
    return SparseMatrix(CSR(Cptr, Cind, val, shape=(m, n)), FormatType.csr)
