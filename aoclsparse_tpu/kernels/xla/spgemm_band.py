"""Band x band SpGEMM numeric stage: a lax.scan of dense matmuls.

The product-expansion numeric (ops/level3/spgemm.py _numeric) is three
irregular index ops of size P. When BOTH operands are band-compressible the
product needs no per-product indexing: with G-row-group banded storage (the bwdg layout)
the B-row slab each A group multiplies decomposes into 2-4 consecutive
B blocks whose placement offsets are IDENTICAL for every group (grid
alignment), so the numeric stage becomes

    scan over row groups g:
        for stream s:  C_g[:, G*s : G*s+WB] += A_g[:, rows_s] @ B_{g+d0+s}[rows_s', :]

— static-sliced dense matmuls only, emitting C as a (nblk, G, WC) dense
band; CSR values are one final gather through a plan-time extraction map.
The rolled B-block streams are materialized at refresh time, not per call.
Reference counterpart: the numeric stage of the Gustavson engine
(level3/aoclsparse_csr2m.cpp:405) — same math, dense-tile formulation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BandGemmPlan",
    "build_band_gemm_plan",
    "band_gemm_cband",
    "band_gemm_values",
    "cband_exec_form",
]


def _window8(eff, G):
    """(W, rel_lo) of the G-group relative window, 8-aligned (the gemm slab
    handles arbitrary sub-G offsets via sl0, unlike the SpMV bwdg path
    whose x-slicing needs G alignment — G alignment would widen W by up
    to G-8)."""
    if eff.nnz == 0 or eff.m == 0:
        return None
    rows = np.repeat(np.arange(eff.m, dtype=np.int64), np.diff(eff.ptr.astype(np.int64)))
    rel = eff.ind.astype(np.int64) - G * (rows // G)
    rel_lo = (int(rel.min()) // 8) * 8
    W = -(-(int(rel.max()) - rel_lo + 1) // 8) * 8
    return W, rel_lo, rows, rel


@dataclasses.dataclass
class BandGemmPlan:
    """Geometry + extraction map for the band x band numeric stage."""

    G: int
    WA: int
    WB: int
    WC: int
    d0: int  # first B-block offset (g + d0)
    sl0: int  # slab-row offset of the first stream inside its block
    nstream: int
    relC: int  # C's group-relative window start
    nblk: int
    stream_ranges: Tuple  # ((rho_lo, rho_hi, br_lo), ...) per stream
    extract_idx: np.ndarray  # (nnzC,) flat positions into the C band
    formA: object  # bwdg-layout ExecForm of A (8-aligned window)
    formB: object


def build_band_gemm_plan(
    effA, effB, Cptr, Cind, G: int = 512, force: bool = False,
    formA_pre=None, formB_pre=None,
) -> Optional[BandGemmPlan]:
    """Set up the band path for C = effA @ effB given C's pattern from the
    symbolic stage; None when the operands don't band-compress or the
    cost model prefers product expansion.

    formA_pre/formB_pre: an operand that is itself a band-engine product
    carries a seeded ``bwdg`` form (cband_exec_form) whose device band IS
    the operand — chained products reuse it directly, skipping the host
    relayout and the first refresh (its window may be wider than the tight
    one; the cost model prices that width honestly)."""
    from ...planner.plan import BWD_MAX_W, _build_bwd_coo

    mA, nA = effA.shape
    mB, nB = effB.shape
    if mA == 0 or effA.nnz == 0 or effB.nnz == 0:
        return None
    if formA_pre is not None and formA_pre.bwd_G != G:
        formA_pre = None
    if formB_pre is not None and formB_pre.bwd_G != G:
        formB_pre = None
    if formA_pre is not None:
        WA, relA, rowsA, relsA = formA_pre.bwd_W, formA_pre.bwd_rel, None, None
    else:
        wA = _window8(effA, G)
        if wA is None:
            return None
        WA, relA, rowsA, relsA = wA
    if formB_pre is not None:
        WB, relB, rowsB, relsB = formB_pre.bwd_W, formB_pre.bwd_rel, None, None
    else:
        wB = _window8(effB, G)
        if wB is None:
            return None
        WB, relB, rowsB, relsB = wB
    if WA > 2 * BWD_MAX_W or WB > 2 * BWD_MAX_W:
        return None
    d0 = relA // G
    sl0 = relA - G * d0  # in [0, G)
    nstream = -(-(sl0 + WA) // G)
    if nstream > 6:
        return None
    relC = relB + G * d0
    WC = G * (nstream - 1) + WB
    nblk = -(-mA // G)
    if -(-mB // G) != nblk:
        return None  # stream alignment assumes equal group counts
    if nblk * G * WC * 4 > 8e9:  # C band memory guard
        return None
    # cost model weights (not calibrated on the GPU; PERF.md open
    # questions): per-product index op, dense stream rate, matmul rate
    P = float(np.diff(effB.ptr.astype(np.int64))[effA.ind.astype(np.int64)].sum())
    nnzC = float(Cind.shape[0])
    est_exp = 3.0 * P * 13e-9
    est_band = (
        (mA * WA + (1.0 + nstream) * mB * WB + 2.0 * nblk * G * WC) * 4 / 250e9
        + (nblk * G * WA * WB * 2.0) / 20e12
        + nnzC * 13e-9  # extraction gather
    )
    if est_band > 0.7 * est_exp and not force:
        return None
    # per-stream static ranges: slab rows rho in [G*s-sl0, G*(s+1)-sl0)
    ranges = []
    for s in range(nstream):
        rho_lo = max(0, G * s - sl0)
        rho_hi = min(WA, G * (s + 1) - sl0)
        br_lo = rho_lo + sl0 - G * s  # row inside block g+d0+s
        ranges.append((int(rho_lo), int(rho_hi), int(br_lo)))
    # extraction map: CSR entry (i, j) -> band slot
    rowsC = np.repeat(np.arange(mA, dtype=np.int64), np.diff(Cptr.astype(np.int64)))
    colsC = Cind.astype(np.int64)
    g = rowsC // G
    c = colsC - G * g - relC
    if colsC.size and (c.min() < 0 or c.max() >= WC):
        return None  # coverage violated (safety)
    extract = (g * G + rowsC % G) * WC + c
    # band operands with the 8-aligned windows (srcpos=None: identity map)
    if formA_pre is not None:
        formA = formA_pre
    else:
        colsA = effA.ind.astype(np.int64)
        formA = _build_bwd_coo(rowsA, colsA, None, mA, nA, G=G, kind="bwdg", window=(relA, WA))
    if formB_pre is not None:
        formB = formB_pre
    else:
        colsB = effB.ind.astype(np.int64)
        formB = _build_bwd_coo(rowsB, colsB, None, mB, nB, G=G, kind="bwdg", window=(relB, WB))
    if formA is None or formB is None:
        return None
    return BandGemmPlan(
        G=G,
        WA=WA,
        WB=WB,
        WC=WC,
        d0=int(d0),
        sl0=int(sl0),
        nstream=int(nstream),
        relC=int(relC),
        nblk=int(nblk),
        stream_ranges=tuple(ranges),
        extract_idx=extract,
        formA=formA,
        formB=formB,
    )


@partial(jax.jit, static_argnames=("G", "WB", "WC", "ranges", "mixed"))
def _band_gemm_scan(Aband, streams, G: int, WB: int, WC: int, ranges, mixed: bool = False):
    """C band = scan_g( sum_s A_g[:, rows_s] @ B_stream_s[g][rows_s', :] )."""
    dt = Aband.dtype

    def step(_, xs):
        A_g = xs[0]
        blocks = xs[1:]
        C_g = jnp.zeros((A_g.shape[0], WC), dt)
        for s, (rho_lo, rho_hi, br_lo) in enumerate(ranges):
            if rho_hi <= rho_lo:
                continue
            Asub = jax.lax.slice_in_dim(A_g, rho_lo, rho_hi, axis=1)
            Bsub = jax.lax.slice_in_dim(blocks[s], br_lo, br_lo + (rho_hi - rho_lo), axis=0)
            if mixed:
                part = jnp.dot(
                    Asub.astype(jnp.bfloat16),
                    Bsub.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32,
                ).astype(dt)
            else:
                # HIGHEST: the default may lower to TF32 (~1e-3 relative)
                part = jnp.dot(
                    Asub, Bsub, preferred_element_type=dt,
                    precision=jax.lax.Precision.HIGHEST,
                )
            col0 = G * s
            C_g = C_g.at[:, col0 : col0 + WB].add(part)
        return None, C_g

    _, Cband = jax.lax.scan(step, None, (Aband,) + streams)
    return Cband  # (nblk, G, WC)


def _ensure_streams(plan: BandGemmPlan):
    """Rolled B-block streams, rebuilt only when B's band was refreshed.
    Staleness is tracked by holding a REFERENCE to the band array (an `is`
    check), never by bare id(): a freed array's address can be recycled, so
    an id match on a dead object would silently serve stale streams."""
    B = plan.formB.bwd_val
    if getattr(plan, "_streams_src", None) is not B:
        plan._streams = tuple(
            jnp.roll(B, -(plan.d0 + s), axis=0) if (plan.d0 + s) != 0 else B
            for s in range(plan.nstream)
        )
        plan._streams_src = B
    return plan._streams


def band_gemm_cband(plan: BandGemmPlan, valA_eff, valB_eff, mixed: bool = False):
    """Run the numeric stage; returns C as the raw (nblk, G, WC) band. The
    band refresh (host scatter + upload) only re-runs when the value vector
    object changed — finalize on an unchanged plan reuses the bands."""
    # hold references for the staleness check (`is`, not id(): a recycled
    # address of a freed array must not skip the refresh)
    if getattr(plan, "_valA_src", None) is not valA_eff:
        plan.formA.refresh(valA_eff)
        plan._valA_src = valA_eff
    if getattr(plan, "_valB_src", None) is not valB_eff:
        plan.formB.refresh(valB_eff)
        plan._valB_src = valB_eff
    streams = _ensure_streams(plan)
    return _band_gemm_scan(
        plan.formA.bwd_val,
        streams,
        G=plan.G,
        WB=plan.WB,
        WC=plan.WC,
        ranges=plan.stream_ranges,
        mixed=mixed,
    )


def band_gemm_values(plan: BandGemmPlan, valA_eff, valB_eff, mixed: bool = False):
    """Numeric stage returning CSR-ordered C values (one extraction gather
    through the plan-time map). The raw band is cached on the plan so the
    op layer can seed the result handle's mv path with it (cband_exec_form)
    without recomputing."""
    Cband = band_gemm_cband(plan, valA_eff, valB_eff, mixed=mixed)
    plan._last_cband = Cband
    return Cband.reshape(-1)[jnp.asarray(plan.extract_idx)]


def cband_exec_form(plan: BandGemmPlan, Cband, m: int, n: int, dtype=None):
    """Wrap an already-computed C band as a ready ``bwdg`` SpMV exec form
    (kernels/xla/spmv.py spmv_bwdg): band[g, r, c] = C[G*g + r, G*g + relC + c].

    Seeded onto the product handle's plan (planner.Plan.seed_bwdg) so a
    chained ``mv`` on the SpGEMM result runs directly on the device band —
    no CSR extraction, no host relayout. ``bwd_dest`` is the extraction map
    (CSR slot -> band slot), which doubles as the scatter list the normal
    ``refresh``-after-update_values path needs (CLAUDE.md refreshability
    rule). Reference role: consuming a product through the optimized-format
    cache (level2/aoclsparse_mv.cpp:179 format switch)."""
    from ...planner.plan import ExecForm

    if dtype is not None and Cband.dtype != dtype:
        Cband = Cband.astype(dtype)
    return ExecForm(
        kind="bwdg",
        m=m,
        n=n,
        bwd_val=Cband,
        bwd_dest=plan.extract_idx,
        bwd_srcpos=None,
        bwd_W=plan.WC,
        bwd_G=plan.G,
        bwd_rel=plan.relC,
    )
