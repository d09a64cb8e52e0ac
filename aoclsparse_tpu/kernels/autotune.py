"""Empirical kernel auto-tuning: the measured version of the Oracle.

The reference's KAT/Oracle picks a kernel by static scoring (ISA flags +
size heuristics, cntx_dispatcher.hpp:272-364); our registry mirrors that
with the planner's format heuristics (planner/plan.py choose_mv_format). This module adds
what SURVEY.md §7 calls "autotuned defaults": time every buildable
execution form for a concrete matrix through the live dispatch path and
pin the measured winner as the plan's auto-selected form — exactly the
decision the cost model approximates, made empirical. One tuning run costs
a few hundred dispatches; the winner persists on the plan (and stays
value-refreshable — every form keeps its host scatter maps, so
update_values flows through unchanged).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.descr import MatrixDescriptor
from ..core.types import AoclSparseError, Operation, Status

__all__ = ["autotune_mv", "autotune_trsv", "autotune_mm", "autotune_spgemm"]

_MV_KINDS = ("bwd", "diag", "gen", "ell", "ellhyb", "segsum", "host")


def _time_form(form, x, iters: int, chunks: int) -> float:
    """Chained dispatch + one fetch per chunk, best-of-chunks."""
    from ..ops.level2.mv import _run_exec_form

    y = _run_exec_form(form, x, None)
    if not isinstance(y, np.ndarray):
        np.asarray(jnp.ravel(y)[:1])  # compile + sync
    best = float("inf")
    for _ in range(chunks):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = _run_exec_form(form, x, None)
        if not isinstance(y, np.ndarray):
            # host engine results are already synced (np.asarray per call —
            # the device fetch it pays with a jnp probe input is part of
            # the honest measurement)
            np.asarray(jnp.ravel(y)[:1])
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def autotune_mv(
    A,
    descr: Optional[MatrixDescriptor] = None,
    op: Operation = Operation.none,
    iters: int = 20,
    chunks: int = 3,
    kinds: Optional[Tuple[str, ...]] = None,
    x=None,
) -> Dict[str, float]:
    """Measure every buildable SpMV execution form for `A` and pin the
    winner as the plan's auto form for (descr, op).

    Returns {form_kind: best_seconds_per_mv}. The winner is planted under
    the plan's kind=None cache slot (the same mechanism seed_bwdg uses), so
    subsequent ``mv`` calls dispatch it; an explicit ``kid=`` still
    overrides per call, and ``update_values`` refreshes the planted form
    through its scatter maps like any other."""
    from ..planner.plan import build_exec_form, get_plan

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = MatrixDescriptor() if descr is None else descr
    op = Operation(op)
    plan = get_plan(A)
    eff = plan.effective_for(descr, op, A.dtype)
    # effective_for folds the op into the structure, so the input dimension
    # is ALWAYS the effective column count
    n_in = eff.shape[1]
    if x is None:
        # deterministic, scale-1 probe vector
        x = jnp.asarray(np.linspace(-1.0, 1.0, n_in), dtype=A.dtype)
    else:
        x = jnp.asarray(x).astype(A.dtype)

    if kinds is None:
        kinds = _MV_KINDS
        if eff.ind.shape[0] > (1 << 18):
            # the host engine targets the dispatch-latency-bound regime
            # (~1-3 ms/dispatch ≈ a few-hundred-k-nnz device SpMV); above
            # that it only wastes measurement time unless explicitly asked
            kinds = tuple(k for k in kinds if k != "host")
    results: Dict[str, float] = {}
    forms = {}
    for kind in kinds:
        try:
            form = build_exec_form(eff, kind)
        except Exception:
            continue
        if form is None or form.kind in results:
            # builders fall back (gen -> a gather form when the band is too
            # wide); time each realized kind once
            continue
        try:
            t = _time_form(form, x, iters, chunks)
        except Exception:
            continue
        results[form.kind] = t
        forms[form.kind] = form

    if not results:
        raise AoclSparseError(Status.internal_error, "no execution form could be timed")
    winner = min(results, key=results.get)
    key4 = (descr.type, descr.fill_mode, descr.diag_type, op)
    key = key4 + (None,)
    if winner == "host":
        # pin the host engine at the eager mv entry only; traced callers
        # (fused solvers, symgs) keep the best DEVICE form in the auto slot
        if getattr(plan, "_mv_engine", None) is None:
            plan._mv_engine = {}
        plan._mv_engine[key4] = "host"
        # host form lives in exec_forms under its explicit kind so
        # refresh_values/save_plan cover it
        plan.exec_forms[key4 + ("host",)] = forms["host"]
        device = {k: v for k, v in results.items() if k != "host"}
        if device:
            plan.exec_forms[key] = forms[min(device, key=device.get)]
    else:
        if getattr(plan, "_mv_engine", None) is not None:
            plan._mv_engine.pop(key4, None)
        plan.exec_forms[key] = forms[winner]
    return results


_MM_KINDS = ("diag", "bwdg", "ell", "ellhyb", "segsum")


def autotune_mm(
    A,
    k: int = 128,
    descr: Optional[MatrixDescriptor] = None,
    op: Operation = Operation.none,
    iters: int = 10,
    chunks: int = 3,
    kinds: Optional[Tuple[str, ...]] = None,
    B=None,
) -> Dict[str, float]:
    """Measure the SpMM execution forms for `A` at RHS width `k` through the
    live ``mm`` dispatch and pin the winner for (descr, op, k) — the SpMM
    counterpart of autotune_mv (ROADMAP round-3: extend autotune to mm).

    Returns {form_kind: best_seconds_per_mm}. The pin lives in
    ``plan._mm_tuned`` and is consulted by ``mm`` when no explicit kid is
    given; ``update_values`` refreshes the underlying forms unchanged."""
    from ..kernels.registry import registry
    from ..ops.level3.csrmm import mm
    from ..planner.plan import get_plan

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = MatrixDescriptor() if descr is None else descr
    op = Operation(op)
    plan = get_plan(A)
    eff = plan.effective_for(descr, op, A.dtype)
    n_in = eff.shape[1]
    if B is None:
        B = jnp.asarray(
            np.linspace(-1.0, 1.0, n_in * k).reshape(n_in, k), dtype=A.dtype
        )
    else:
        B = jnp.asarray(B).astype(A.dtype)
        k = int(B.shape[1])
    kid_of: Dict[str, int] = {}
    for e in registry.table("mm"):
        kid_of.setdefault(e.fmt, e.kid)
    results: Dict[str, float] = {}
    for kind in kinds or _MM_KINDS:
        kid = kid_of.get(kind)
        if kid is None:
            continue
        try:
            C = mm(1.0, A, descr, op, B, 0.0, kid=kid)
            np.asarray(jnp.ravel(C)[:1])  # compile + sync
        except Exception:
            continue  # form not buildable for this structure/k
        best = float("inf")
        for _ in range(chunks):
            t0 = time.perf_counter()
            for _ in range(iters):
                C = mm(1.0, A, descr, op, B, 0.0, kid=kid)
            np.asarray(jnp.ravel(C)[:1])
            best = min(best, (time.perf_counter() - t0) / iters)
        results[kind] = best
    if not results:
        raise AoclSparseError(Status.internal_error, "no mm form could be timed")
    winner = min(results, key=results.get)
    if getattr(plan, "_mm_tuned", None) is None:
        plan._mm_tuned = {}
    plan._mm_tuned[(descr.type, descr.fill_mode, descr.diag_type, op, k)] = winner
    return results


def autotune_spgemm(
    A,
    B,
    opA: Operation = Operation.none,
    opB: Operation = Operation.none,
    descrA: Optional[MatrixDescriptor] = None,
    descrB: Optional[MatrixDescriptor] = None,
    iters: int = 5,
    chunks: int = 2,
):
    """Measure both SpGEMM numeric engines (band scan-of-matmuls vs
    product-expansion segment-sum) for op(A)@op(B) and pin the winner on the
    staged product's plan (ROADMAP round-3: extend autotune to the spgemm
    engine choice).

    Returns ``(C, results)``: C is the nnz_count-staged product handle whose
    plan is pinned — drive ``sp2m(..., request=finalize, C=C)`` on it (the
    reference's staged protocol, functions.h:2184-2201) to use the measured
    engine; `results` maps engine name to best seconds per numeric pass."""
    from ..core.descr import MatrixDescriptor as MD
    from ..core.types import Request
    from ..ops.level3.spgemm import _effective, _numeric, _numeric_auto, sp2m

    if A is None or B is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descrA = MD() if descrA is None else descrA
    descrB = MD() if descrB is None else descrB
    C = sp2m(opA, descrA, A, opB, descrB, B, request=Request.nnz_count)
    plan = C._spgemm_plan
    effA = _effective(A, descrA, Operation(opA))
    effB = _effective(B, descrB, Operation(opB))

    def _time(fn) -> float:
        v = fn()
        np.asarray(jnp.ravel(v)[:1])
        best = float("inf")
        for _ in range(chunks):
            t0 = time.perf_counter()
            for _ in range(iters):
                v = fn()
            np.asarray(jnp.ravel(v)[:1])
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    results: Dict[str, float] = {}
    if plan.nnz:
        from ..ops.level3.spgemm import _ensure_expansion

        _ensure_expansion(plan, effA, effB)  # pattern-only (band-first) plan
        results["expand"] = _time(
            lambda: _numeric(
                effA.val, effB.val, plan.pa, plan.pb, plan.pc, plan.nnz, False, False
            )
        )
        if plan.band is not None:
            try:
                results["band"] = _time(
                    lambda: _numeric_auto(plan, effA, effB, False, False)
                )
            except Exception:
                plan.band = None
        # third engine: threaded host numeric (reference csr2m.cpp:405-545)
        from .. import native as _native

        av = np.asarray(effA.val)
        bv = np.asarray(effB.val)
        pa_h, pb_h, pc_h = np.asarray(plan.pa), np.asarray(plan.pb), np.asarray(plan.pc)
        # zero-length probe: exercises lib availability + dtype support
        # without paying a full numeric pass
        probe = _native.spgemm_numeric_host(pa_h[:0], pb_h[:0], pc_h[:0], av, bv, 0)
        if probe is not None:

            def _host():
                return jnp.asarray(
                    _native.spgemm_numeric_host(pa_h, pb_h, pc_h, av, bv, plan.nnz)
                )

            results["host"] = _time(_host)
    # extraction-route measurement (VERDICT r4 item 6): with the band
    # engine, exporting CSR values pays either the device extraction gather
    # or a host numeric pass that writes values in CSR order directly
    # (reference csr2m.cpp:305 style). Time the gather alone on the band's
    # C output and pin the cheaper route for the lazy-value thunk.
    if plan.nnz and plan.band is not None and "band" in results:
        try:
            cband = getattr(plan.band, "_last_cband", None)
            if cband is not None:
                ex = jnp.asarray(plan.band.extract_idx)
                results["extract_gather"] = _time(
                    lambda: cband.reshape(-1)[ex]
                )
                host_t = results.get("host")
                plan._extract_route = (
                    "host"
                    if host_t is not None and host_t < results["extract_gather"]
                    else "gather"
                )
        except Exception:
            plan._extract_route = "gather"
    if not results:
        results["expand"] = 0.0  # empty product: either engine is a no-op
    # engine pick over the NUMERIC engines only (extract_gather is the
    # extraction-route measurement, not an engine)
    engines = {k: v for k, v in results.items() if k in ("expand", "band", "host")}
    best = min(engines, key=engines.get) if engines else "expand"
    plan._host_engine = best == "host"
    if best != "band":
        plan.band = None  # pin the chosen engine for finalize passes
    return C, results


def autotune_trsv(
    A,
    descr: Optional[MatrixDescriptor] = None,
    op: Operation = Operation.none,
    nb_candidates: Tuple[int, ...] = (128, 256, 512),
    k: int = 1,
    iters: int = 10,
    chunks: int = 3,
) -> Dict[int, float]:
    """Measure the blocked triangular solve at several block sizes and pin
    the winner for this plan's (fill, diag, op) — the empirical version of
    adaptive_nb's ~512-step heuristic (planner/triangular.py). `k` sizes
    the probe RHS (k > 1 tunes the TRSM path). Returns {nb: seconds}."""
    from ..core.types import MatrixType
    from ..planner.plan import get_plan
    from ..planner.triangular import trsv_form_for

    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = (
        MatrixDescriptor(type=MatrixType.triangular) if descr is None else descr
    )
    op = Operation(op)
    plan = get_plan(A)
    m = plan.clean.m
    results: Dict[int, float] = {}
    seen_nb = set()
    for nb in nb_candidates:
        try:
            form = trsv_form_for(plan, descr, op, nb=min(nb, max(8, m)))
        except Exception:
            continue
        if form.nb in seen_nb:
            continue  # clamped candidates can collapse to the same block size
        seen_nb.add(form.nb)
        m_pad = form.nblk * form.nb
        r2 = jnp.asarray(
            np.tile(np.linspace(1.0, 2.0, m_pad, dtype=np.float64)[:, None], (1, k))
        ).astype(A.dtype)
        try:
            form.solve(r2)  # compile
            np.asarray(jnp.ravel(form.solve(r2))[:1])
            best = float("inf")
            for _ in range(chunks):
                t0 = time.perf_counter()
                for _ in range(iters):
                    x = form.solve(r2)
                np.asarray(jnp.ravel(x)[:1])
                best = min(best, (time.perf_counter() - t0) / iters)
        except Exception:
            continue
        results[form.nb] = best
    # level-scheduled wavefront engine (TRSV KID 1) as one more candidate:
    # wins on shallow circuit-class dependency DAGs
    try:
        from ..planner.triangular import trsv_level_form_for

        lform = trsv_level_form_for(plan, descr, op)
        r2 = jnp.asarray(
            np.tile(np.linspace(1.0, 2.0, m, dtype=np.float64)[:, None], (1, k))
        ).astype(A.dtype)
        lform.solve(r2)
        np.asarray(jnp.ravel(lform.solve(r2))[:1])
        best = float("inf")
        for _ in range(chunks):
            t0 = time.perf_counter()
            for _ in range(iters):
                x = lform.solve(r2)
            np.asarray(jnp.ravel(x)[:1])
            best = min(best, (time.perf_counter() - t0) / iters)
        results["level"] = best
    except Exception:
        pass
    # host sequential engine (TRSV KID 2): wins when the whole solve is
    # latency-bound (tiny m) — a device dispatch alone costs ~1-3 ms here.
    # k>1 probes tune the TRSM path, whose host engine (trsm KID 2) is
    # explicit-KID only (the pin stores a single-RHS verdict); large
    # triangles can't win on a sequential sweep (same 1<<18 carve-out as
    # autotune_mv) — skip both rather than time a hopeless candidate.
    if k == 1 and plan.clean.nnz <= (1 << 18):
        try:
            from ..planner.triangular import trsv_host_form_for

            hform = trsv_host_form_for(plan, descr, op)
            bh = np.linspace(1.0, 2.0, m).astype(A.dtype)
            hform.solve(bh)
            best = float("inf")
            for _ in range(chunks):
                t0 = time.perf_counter()
                for _ in range(iters):
                    hform.solve(bh)
                best = min(best, (time.perf_counter() - t0) / iters)
            results["host"] = best
        except Exception:
            pass
    if not results:
        raise AoclSparseError(Status.internal_error, "no block size could be timed")
    winner = min(results, key=results.get)
    key = (descr.fill_mode, descr.diag_type, op)
    if winner in ("level", "host"):
        if getattr(plan, "_trsv_engine", None) is None:
            plan._trsv_engine = {}
        plan._trsv_engine[key] = winner
    else:
        if getattr(plan, "_trsv_engine", None) is not None:
            plan._trsv_engine.pop(key, None)
        if getattr(plan, "_trsv_tuned", None) is None:
            plan._trsv_tuned = {}
        plan._trsv_tuned[key] = winner
    return results
