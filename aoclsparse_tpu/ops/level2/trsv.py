"""Level-2 triangular solve: ``trsv`` (+ strided variant).

Reference: aoclsparse_?trsv/_kid/_strided (level2/aoclsparse_trsv.cpp:46,
DOID x KID table documented at :198-290) — sequential substitution vectorized
within each row. Redesign: planner-built blocked form + lax.scan kernel
(see planner/triangular.py, kernels/xla/trsv.py).

Semantics: solve op(tri(A)) x = alpha * b, where tri() takes descr.fill_mode's
triangle of A honoring diag_type; symmetric descriptors are treated as
triangular like the reference (trsv.cpp:141-151).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.descr import MatrixDescriptor
from ...core.matrix import SparseMatrix
from ...core.types import AoclSparseError, MatrixType, Operation, Status
from ...kernels.registry import KernelEntry, registry
from ...kernels.xla.trsv import trsv_blocked
from ...planner.plan import get_plan
from ...planner.triangular import trsv_form_for

__all__ = ["trsv", "trsv_strided", "csrsv"]

registry.register("sv", KernelEntry(0, "xla_blocked_scan", trsv_blocked, "blocked", "any", 0))
# KID 1: level-scheduled wavefront (opt-in: priority below the blocked scan;
# wins on shallow dependency DAGs — circuit-class triangles)
registry.register("sv", KernelEntry(1, "xla_level_wavefront", None, "level", "any", -1))
# KID 2: sequential host engine (native C++ substitution) for latency-bound
# small solves — every device solve pays a dispatch and a fetch; never the
# default, never traced (same policy as the host mv engine, KID 11)
registry.register("sv", KernelEntry(2, "host_sequential", None, "host", "any", -2))

#: trsv KID of the host engine
HOST_TRSV_KID = 2


def _host_route(A, descr, op, b, kid, alpha=1.0, allow_pin=True):
    """Return the TrsvHostForm when this call should run on the host engine
    (explicit HOST KID, or an autotune_trsv pin), else None. Traced inputs
    (b OR alpha) never route here: a pin falls back to the device form, an
    explicit KID errors out. Mirrors mv._host_route (ops/level2/mv.py).
    `allow_pin=False` (trsm) honors only the explicit KID — the trsv pin
    comes from a single-RHS measurement and must not hijack multi-RHS."""
    if kid is not None and kid != HOST_TRSV_KID:
        return None
    try:
        op = Operation(op)
        descr.validate()
        if MatrixType(descr.type) == MatrixType.general or A.shape[0] != A.shape[1]:
            return None  # let the main path raise its usual statuses
    except Exception:
        return None
    import jax

    if isinstance(b, jax.core.Tracer) or isinstance(alpha, jax.core.Tracer):
        if kid == HOST_TRSV_KID:
            raise AoclSparseError(
                Status.not_implemented, "host trsv engine inside a traced program"
            )
        return None
    from ...planner.triangular import trsv_host_form_for

    if kid == HOST_TRSV_KID:
        return trsv_host_form_for(get_plan(A), descr, op)
    # autotune pin: only consult an EXISTING plan — never materialize lazy
    # SpGEMM values or build a plan just to probe for a pin
    if not allow_pin or A.values_pending or A.plan is None:
        return None
    eng = getattr(A.plan, "_trsv_engine", None)
    if eng and eng.get((descr.fill_mode, descr.diag_type, op)) == "host":
        return trsv_host_form_for(A.plan, descr, op)
    return None


def _solve(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, rhs, kid):
    if A is None or descr is None or rhs is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to trsv")
    descr.validate()
    from ...core.validate import check_base_match

    check_base_match(A, descr)
    op = Operation(op)
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "trsv requires square A")
    if MatrixType(descr.type) == MatrixType.general:
        raise AoclSparseError(
            Status.invalid_value, "trsv requires a triangular or symmetric/hermitian descriptor"
        )
    entry = registry.select("sv", kid=kid)  # KID validation + engine choice
    if entry.fmt == "host":
        # only reachable with traced operands: the eager trsv/trsm entries
        # route the host engine themselves before calling _solve
        raise AoclSparseError(
            Status.not_implemented, "host solve engine inside a traced program"
        )
    plan = get_plan(A)
    if kid is None and entry.fmt != "level":
        # autotune_trsv may have pinned the level engine for this key
        eng = getattr(plan, "_trsv_engine", None)
        if eng and eng.get((descr.fill_mode, descr.diag_type, Operation(op))) == "level":
            entry = registry.select("sv", kid=1)
    if entry.fmt == "level":
        from ...planner.triangular import trsv_level_form_for

        lform = trsv_level_form_for(plan, descr, op)
        return lform.solve(rhs)
    key_r = (descr.fill_mode, descr.diag_type, Operation(op))
    try:
        if kid is None and key_r in getattr(plan, "_trsv_refused", ()):
            raise AoclSparseError(
                Status.memory_error, "blocked window refused (cached)"
            )
        form = trsv_form_for(plan, descr, op)
    except AoclSparseError as e:
        if e.status != Status.memory_error or kid is not None:
            raise
        # structural refusal: cache it (and the level stats below) so
        # repeat trsv/trsm calls skip the doomed build attempt
        refused = getattr(plan, "_trsv_refused", None) or set()
        refused.add(key_r)
        plan._trsv_refused = refused
        # blocked window structurally oversized (scircuit-class rail
        # columns reach the whole triangle): default calls fall back to
        # the level-scheduled engine when the DAG is shallow (circuit
        # class — exactly its niche), else to the host engine for eager
        # callers; explicit kid=0 keeps the memory_error. Stats are
        # checked BEFORE building the level form (building uploads its
        # run arrays to the device).
        from ...planner.triangular import (
            trsv_host_form_for,
            trsv_level_form_for,
            trsv_level_stats_for,
        )

        stats_cache = getattr(plan, "_trsv_lvlstats", None) or {}
        if key_r in stats_cache:
            nlev, padded = stats_cache[key_r]
        else:
            nlev, padded = trsv_level_stats_for(plan, descr, op)
            stats_cache[key_r] = (nlev, padded)
            plan._trsv_lvlstats = stats_cache
        # shallow enough that the per-level scan beats a sequential host
        # sweep: cost ~ sum of run-padded gathers vs ~1.5 ns/nnz host
        key_eng = key_r
        if nlev <= 4096 and padded <= 16 * max(A.nnz, 1):
            return trsv_level_form_for(plan, descr, op).solve(rhs)
        if not isinstance(rhs, jax.core.Tracer):
            # pin the decision: repeat eager calls must take the whole-call
            # host route in trsv()/trsm() instead of re-attempting the
            # blocked build + stats every time (in-2004 stand-in measured
            # 1.6-10.8 s/call of rediscovery around a 30 ms native solve)
            eng = getattr(plan, "_trsv_engine", None) or {}
            eng[key_eng] = "host"
            plan._trsv_engine = eng
            hform = trsv_host_form_for(plan, descr, op)
            rh = np.asarray(rhs)
            x_h = hform.solve(rh) if rh.ndim == 1 else hform.solve_mat(rh)
            return jnp.asarray(x_h)
        # traced caller, no host escape, and even the level form's
        # run-padded arrays would be GBs: refuse honestly
        raise AoclSparseError(
            Status.memory_error,
            "triangle too wide for the blocked window and too padded"
            " for the wavefront engine inside a traced program; call"
            " trsv eagerly (host engine) or kid=1 explicitly",
        )
    m_pad = form.nblk * form.nb
    rhs = jnp.asarray(rhs)
    squeeze = rhs.ndim == 1
    r2 = rhs[:, None] if squeeze else rhs
    if form.reversed_:
        r2 = r2[::-1]
    if m_pad != m:
        r2 = jnp.pad(r2, ((0, m_pad - m), (0, 0)))
    x = form.solve(r2)[:m]
    if form.reversed_:
        x = x[::-1]
    return x[:, 0] if squeeze else x


def trsv(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    b,
    kid: Optional[int] = None,
):
    """x = op(tri(A))^{-1} (alpha * b)  (aoclsparse_?trsv)."""
    if A is None or descr is None or b is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    hform = _host_route(A, descr, op, b, kid, alpha)
    if hform is not None:
        # whole-call host path: numpy in, numpy out — nothing touches the
        # device (the engine exists to dodge the dispatch/fetch cost)
        from ...core.validate import check_dtype_compat

        bh = np.asarray(b)
        if bh.ndim != 1 or bh.shape[0] != A.shape[0]:
            raise AoclSparseError(
                Status.invalid_size, f"b must be ({A.shape[0]},), got {bh.shape}"
            )
        check_dtype_compat(A.dtype, bh.dtype, "b")
        dtype = np.result_type(np.dtype(A.dtype), bh.dtype)
        adt = np.dtype(A.dtype)
        if np.isscalar(alpha) and alpha == 1.0:
            rhs = bh.astype(adt, copy=False)
        else:
            rhs = (np.asarray(alpha, dtype) * bh).astype(adt, copy=False)
        return hform.solve(rhs).astype(dtype, copy=False)
    b = jnp.asarray(b)
    if b.ndim != 1 or b.shape[0] != A.shape[0]:
        raise AoclSparseError(Status.invalid_size, f"b must be ({A.shape[0]},), got {b.shape}")
    from ...core.validate import check_dtype_compat

    check_dtype_compat(A.dtype, b.dtype, "b")
    dtype = jnp.result_type(A.dtype, b.dtype)
    # alpha == 1 is the overwhelming case (every solver inner loop): skip
    # the scalar transfer + elementwise scale (two dispatches)
    if np.isscalar(alpha) and alpha == 1.0:
        rhs = b.astype(A.dtype)
    else:
        rhs = (jnp.asarray(alpha, dtype) * b).astype(A.dtype)
    return _solve(A, descr, op, rhs, kid).astype(dtype)


def csrsv(alpha, A, descr, op, b, kid=None):
    """Deprecated alias of trsv (the reference deprecates aoclsparse_?csrsv
    in favor of ?trsv, include/aoclsparse_functions.h:1203)."""
    return trsv(alpha, A, descr, op, b, kid=kid)


def trsv_strided(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    b,
    incb: int,
    incx: int = 1,
    x_out=None,
    kid: Optional[int] = None,
):
    """Strided-rhs variant (aoclsparse_?trsv_strided): reads b[i*incb],
    returns x embedded at stride incx (into x_out when given)."""
    if incb <= 0 or incx <= 0:
        raise AoclSparseError(Status.invalid_size, "strides must be positive")
    b = jnp.asarray(b)
    m = A.shape[0]
    if b.shape[0] < (m - 1) * incb + 1:
        raise AoclSparseError(Status.invalid_size, "b too small for stride")
    bs = b[: (m - 1) * incb + 1 : incb]
    x = trsv(alpha, A, descr, op, bs, kid=kid)
    if x_out is None:
        x_out = jnp.zeros(((m - 1) * incx + 1,), dtype=x.dtype)
    else:
        x_out = jnp.asarray(x_out)
    return x_out.at[: (m - 1) * incx + 1 : incx].set(x)
