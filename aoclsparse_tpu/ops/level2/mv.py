"""Level-2 SpMV: ``mv`` (aoclsparse_?mv) and the fused ``dotmv``.

Reference: entry/validation at level2/aoclsparse_mv.cpp:39-382 (null/size/base
checks, empty-matrix beta-scale quick exit, DOID copy lookup, format switch),
dispatch aoclsparse_csrmv_t (level2/aoclsparse_csrmv.hpp:34-451), fused dotmv
template (level2/aoclsparse_dotmv.hpp:32).

Redesign: the (descr, op) pair resolves through the planner to an
EffectiveCSR copy + ExecForm (general-form data, uniform kernels — the same
strategy as the reference's matrix_transform DOID copies), then the registry
Oracle picks a kernel row for the execution format. y = alpha*op(A)x + beta*y
is computed with the alpha/beta epilogue fused in jit.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.descr import MatrixDescriptor
from ...core.formats import BSR, DIA, ELL
from ...core.matrix import SparseMatrix
from ...core.validate import check_base_match
from ...core.types import (
    AoclSparseError,
    MatrixType,
    MemoryPolicy,
    Operation,
    Status,
)
from ...kernels.registry import registry
from ...planner.plan import get_plan

__all__ = ["mv", "dotmv", "mv_operator", "MvOperator"]


def _validate(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, x, y):
    if A is None or descr is None or x is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to mv")
    descr.validate()
    check_base_match(A, descr)
    op = Operation(op)
    m, n = A.shape
    nx, ny = (n, m) if op == Operation.none else (m, n)
    x = jnp.asarray(x)
    if x.shape != (nx,):
        raise AoclSparseError(Status.invalid_size, f"x must have shape ({nx},), got {x.shape}")
    if y is not None:
        y = jnp.asarray(y)
        if y.shape != (ny,):
            raise AoclSparseError(
                Status.invalid_size, f"y must have shape ({ny},), got {y.shape}"
            )
    if MatrixType(descr.type) in (MatrixType.symmetric, MatrixType.hermitian, MatrixType.triangular):
        if m != n:
            raise AoclSparseError(Status.invalid_size, f"{descr.type.name} requires square A")
    return op, x, y, ny


@partial(jax.jit, static_argnames=())
def _epilogue(ax, alpha, beta, y):
    return alpha * ax + beta * y


@jax.jit
def _scale(ax, alpha):
    return alpha * ax


_ZERO_CACHE = {}

def _zero_operands(dtype):
    key = jnp.dtype(dtype)
    z = _ZERO_CACHE.get(key)
    if z is None:
        # concrete even when first requested inside a user trace: a cached
        # tracer poisons every LATER trace (UnexpectedTracerError on the
        # next jit of a gen mv)
        with jax.ensure_compile_time_eval():
            z = (jnp.zeros((0,), jnp.int32), jnp.zeros((0,), key))
        _ZERO_CACHE[key] = z
    return z


_ZERO_AUX_CACHE = {}


def _zero_aux(dtype):
    key = jnp.dtype(dtype)
    z = _ZERO_AUX_CACHE.get(key)
    if z is None:
        with jax.ensure_compile_time_eval():  # see _zero_operands
            z = (jnp.zeros((0, 0), key), jnp.zeros((0,), jnp.bool_))
        _ZERO_AUX_CACHE[key] = z
    return z


def _mixed_enabled(form, dtype) -> bool:
    """Precision policy gate (docs/precision.md): bf16-multiply/f32-
    accumulate runs when the handle opted in (set_precision_mode(A,
    "mixed") — propagated onto the form by _spmv_core) or the env flag
    forces it; an explicit env "0" is the kill switch either way. Only f32
    operands qualify."""
    import os

    if jnp.dtype(dtype) != jnp.dtype(jnp.float32):
        return False
    env = os.environ.get("AOCLSPARSE_TPU_MIXED_PRECISION")
    if env is not None and env != "":
        return env in ("1", "true")
    return getattr(form, "precision_mode", "full") == "mixed"


def _run_exec_form(form, x, kid):
    e = registry.select("mv", fmt=form.kind, kid=kid)
    if form.kind == "host":
        # host numpy engine (kernels/host.py): never valid under a trace —
        # the result must stay host-resident, a tracer has no host value
        if isinstance(x, jax.core.Tracer):
            raise AoclSparseError(
                Status.not_implemented, "host mv engine inside a traced program"
            )
        return e.fn(form.host_ptr, form.host_ind, form.host_values(), np.asarray(x))
    if form.kind in ("segsum", "sell"):
        return e.fn(form.ind, form.val, form.row_ids, x, form.m)
    if form.kind == "ell":
        return e.fn(form.ell_ind, form.ell_val, x)
    if form.kind == "ellhyb":
        return e.fn(
            form.ell_ind, form.ell_val, form.sp_ind, form.sp_val, form.sp_rows, x, form.m
        )
    if form.kind == "bwd":
        xp = jnp.pad(x, (form.bwd_padL, form.bwd_n_pad - form.bwd_padL - form.n))
        mixed = _mixed_enabled(form, x.dtype)
        wv = form.bwd_val
        if mixed:
            # cache the bf16 operand: casting per call would re-stream the
            # full band (the whole point of bf16 is halving that traffic).
            # Concrete even mid-trace (a cached tracer poisons later traces)
            if getattr(form, "_bwd_val_bf16", None) is None:
                with jax.ensure_compile_time_eval():
                    form._bwd_val_bf16 = wv.astype(jnp.bfloat16)
            wv = form._bwd_val_bf16
        y = e.fn(wv, xp, form.bwd_W, form.bwd_base8, form.bwd_n_pad, mixed)
        y = y[: form.m]
        if form.sp_ind is not None and form.sp_ind.shape[0]:
            # edge-peel spill: the few window-outlier entries (planner peel)
            y = y + jax.ops.segment_sum(
                form.sp_val * x[form.sp_ind],
                form.sp_rows,
                num_segments=form.m,
                indices_are_sorted=True,
            )
        return y
    if form.kind == "bwdg":
        mixed = _mixed_enabled(form, x.dtype)
        return e.fn(
            form.bwd_val, x, form.bwd_G, form.bwd_W, form.bwd_rel, form.m, mixed
        )
    if form.kind == "diag":
        return e.fn(
            form.dia_val,
            form.dia_offs,
            x,
            form.m,
            form.dia_L,
            form.dia_n_pad,
            offs_static=form.dia_offs_static,
        )
    if form.kind == "gen":
        mixed = _mixed_enabled(form, x.dtype)
        wv = form.bwd_val
        if mixed:
            if getattr(form, "_bwd_val_bf16", None) is None:
                with jax.ensure_compile_time_eval():  # concrete mid-trace
                    form._bwd_val_bf16 = wv.astype(jnp.bfloat16)
            wv = form._bwd_val_bf16
        has_spill = form.sp_ind is not None and bool(form.sp_ind.shape[0])
        has_hub = form.hub_cols is not None and bool(form.hub_cols.shape[0])
        has_hubrow = form.hubr_rows is not None and bool(form.hubr_rows.shape[0])
        zero_i, zero_v = _zero_operands(x.dtype)
        zero_m, zero_b = _zero_aux(x.dtype)
        has_flip = form.gen_flip is not None
        flip = form.gen_flip if has_flip else zero_b
        return e.fn(
            wv,
            x,
            form.gen_perm,
            form.gen_out,
            flip,
            form.hub_slab if has_hub else zero_m,
            form.hub_cols if has_hub else zero_i,
            form.hubr_slab if has_hubrow else zero_m,
            form.hubr_rows if has_hubrow else zero_i,
            form.sp_val if has_spill else zero_v,
            form.sp_ind if has_spill else zero_i,
            form.sp_rows if has_spill else zero_i,
            B=form.gen_B,
            W=form.bwd_W,
            base8=form.bwd_base8,
            padL=form.bwd_padL,
            n_pad=form.bwd_n_pad,
            m=form.m,
            m_pad=form.gen_m_pad,
            mixed=mixed,
            has_hub=has_hub,
            has_hubrow=has_hubrow,
            has_spill=has_spill,
            has_flip=has_flip,
        )
    raise AoclSparseError(Status.internal_error, f"bad exec form {form.kind}")


def _spmv_core(A: SparseMatrix, descr: MatrixDescriptor, op: Operation, x, kid=None):
    """op(descr(A)) @ x without the alpha/beta epilogue."""
    general_n = MatrixType(descr.type) == MatrixType.general and op == Operation.none
    if (
        general_n
        and kid is None
        and A.plan is None
        and A.values_pending
        and A.mem_policy != MemoryPolicy.restricted
    ):
        # lazy band-engine SpGEMM product consumed as a plain operand: run
        # straight on the seeded device band — touching A.data would pay the
        # CSR extraction gather this mode exists to skip
        seed = getattr(A, "_seed_bwdg", None)
        if seed is not None:
            return _run_exec_form(seed, x, None)
    data = A.data
    # native-format fast paths (the reference's format switch, mv.cpp:179)
    if general_n and isinstance(data, ELL):
        e = registry.select("mv", fmt="ell", kid=kid)
        return e.fn(data.ind, data.val, x)
    if general_n and isinstance(data, DIA):
        e = registry.select("mv", fmt="dia", kid=kid)
        dist = tuple(int(d) for d in np.asarray(data.dist))
        return e.fn(dist, data.val, x, data.m, data.n)
    if general_n and isinstance(data, BSR):
        e = registry.select("mv", fmt="bsr", kid=kid)
        bs = data.block_dim
        brow = np.repeat(
            np.arange(data.mb, dtype=np.int32), np.diff(np.asarray(data.ptr))
        )
        y = e.fn(jnp.asarray(brow), data.ind, data.val, x, data.mb, bs)
        return y[: data.m]
    # CSR path through the planner
    plan = get_plan(A)
    kind = "segsum" if A.mem_policy == MemoryPolicy.restricted else None
    if kid is not None:
        # an explicit KID pins the kernel, hence its execution format
        # (the reference validates the KID against the DOID table and errors
        # with invalid_kid when unsupported, cntx_dispatcher.hpp:272-364)
        for e in registry.table("mv"):
            if e.kid == kid:
                if e.fmt not in (
                    "segsum",
                    "ell",
                    "ellhyb",
                    "bwd",
                    "diag",
                    "gen",
                    "bwdg",
                    "sell",
                ):
                    raise AoclSparseError(
                        Status.invalid_kid, f"kid {kid} serves format '{e.fmt}', not CSR"
                    )
                kind = e.fmt
                break
        else:
            raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for 'mv'")
    form = plan.exec_form_for(descr, op, kind=kind, dtype=A.dtype)
    # propagate the handle's precision policy onto the form (consulted by
    # _mixed_enabled; callers going straight through _run_exec_form — the
    # bench, fused solvers — see whatever the handle last requested)
    form.precision_mode = getattr(A, "precision_mode", "full")
    return _run_exec_form(form, x, kid)


def _host_route(A, descr, op, x, kid, alpha=1.0, beta=0.0, y=None):
    """Return the host ExecForm when this call should run on the host engine
    (explicit HOST KID, or an autotune_mv pin), else None. Traced inputs
    (any of x/alpha/beta/y) never route here: a pin falls back to the device
    form, an explicit KID errors out."""
    from ...kernels.host import HOST_MV_KID

    if kid is not None and kid != HOST_MV_KID:
        return None
    try:
        op = Operation(op)
        descr.validate()
    except Exception:
        return None  # let the main path raise its usual statuses
    if any(isinstance(v, jax.core.Tracer) for v in (x, alpha, beta, y)):
        if kid == HOST_MV_KID:
            raise AoclSparseError(
                Status.not_implemented, "host mv engine inside a traced program"
            )
        return None
    general_n = MatrixType(descr.type) == MatrixType.general and op == Operation.none
    if kid == HOST_MV_KID:
        if general_n and isinstance(A.data, (ELL, DIA, BSR)):
            # native-format fast paths keep their own KAT rows (mv.cpp:179)
            raise AoclSparseError(
                Status.invalid_kid, "host mv engine serves the CSR planner path"
            )
        plan = get_plan(A)
        return plan.exec_form_for(descr, op, kind="host", dtype=A.dtype)
    # autotune pin: only consult an EXISTING plan — never materialize lazy
    # SpGEMM values or build a plan just to probe for a pin
    if A.values_pending or A.plan is None:
        return None
    if general_n and isinstance(A.data, (ELL, DIA, BSR)):
        return None
    eng = getattr(A.plan, "_mv_engine", None)
    if eng and eng.get((descr.type, descr.fill_mode, descr.diag_type, op)) == "host":
        return A.plan.exec_form_for(descr, op, kind="host", dtype=A.dtype)
    return None


def _mv_host(alpha, A, descr, op, x, beta, y, form):
    """Whole-call host path: numpy validation, kernel and epilogue. Returns
    np.ndarray — the engine exists to keep sub-ms operands off the device
    dispatch and fetch path, so nothing touches the device."""
    from ...core.validate import check_dtype_compat

    descr.validate()
    op = Operation(op)
    m, n = A.shape
    nx, ny = (n, m) if op == Operation.none else (m, n)
    xh = np.asarray(x)
    if xh.shape != (nx,):
        raise AoclSparseError(Status.invalid_size, f"x must have shape ({nx},), got {xh.shape}")
    yh = None
    if y is not None:
        yh = np.asarray(y)
        if yh.shape != (ny,):
            raise AoclSparseError(
                Status.invalid_size, f"y must have shape ({ny},), got {yh.shape}"
            )
    if MatrixType(descr.type) in (
        MatrixType.symmetric,
        MatrixType.hermitian,
        MatrixType.triangular,
    ) and m != n:
        raise AoclSparseError(Status.invalid_size, f"{descr.type.name} requires square A")
    check_dtype_compat(A.dtype, xh.dtype, "x")
    dtype = np.result_type(np.dtype(A.dtype), xh.dtype)
    y0 = np.zeros(ny, dtype=dtype) if yh is None else yh.astype(dtype)
    # beta == 0: y is NOT read (reference zeroes it even when it holds
    # NaN/Inf, csrmv_kr.hpp:54-56); NaN/Inf beta falls through
    beta_is_zero = np.isscalar(beta) and beta == 0
    if A.nnz == 0 or (np.isscalar(alpha) and alpha == 0):
        if beta_is_zero:
            return np.zeros(ny, dtype=dtype)
        # empty/alpha-0 quick exit keeps IEEE alpha*0 propagation (mv.cpp:118)
        return ((alpha * 0) * np.zeros(ny, dtype=dtype) + beta * y0).astype(dtype)
    e = registry.select("mv", fmt="host", kid=None)
    ax = e.fn(form.host_ptr, form.host_ind, form.host_values(), xh.astype(dtype, copy=False))
    if beta_is_zero:
        if np.isscalar(alpha) and alpha == 1.0:
            return ax.astype(dtype, copy=False)
        return (alpha * ax).astype(dtype, copy=False)
    return (alpha * ax + beta * y0).astype(dtype, copy=False)


def mv(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    x,
    beta,
    y=None,
    kid: Optional[int] = None,
):
    """y = alpha * op(descr(A)) @ x + beta * y  (aoclsparse_?mv)."""
    if A is None or descr is None or x is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument to mv")
    hform = _host_route(A, descr, op, x, kid, alpha, beta, y)
    if hform is not None:
        return _mv_host(alpha, A, descr, op, x, beta, y, hform)
    op, x, y, ny = _validate(A, descr, op, x, y)
    from ...core.validate import check_dtype_compat

    check_dtype_compat(A.dtype, x.dtype, "x")
    dtype = jnp.result_type(A.dtype, x.dtype)
    # beta == 0 means y is NOT read — the reference zeroes/overwrites y
    # directly even when it holds NaN/Inf (csrmv_kr.hpp:54-56), so 0*NaN
    # must not contaminate the result. NaN/Inf beta compares unequal to 0
    # and falls through to the full epilogue (IEEE propagation).
    beta_is_zero = np.isscalar(beta) and beta == 0
    # quick exits (mv.cpp:118-123)
    if A.nnz == 0 or (np.isscalar(alpha) and alpha == 0):
        if beta_is_zero:
            return jnp.zeros((ny,), dtype=dtype)
        alpha_c = jnp.asarray(alpha, dtype=dtype)
        beta_c = jnp.asarray(beta, dtype=dtype)
        y0 = jnp.zeros((ny,), dtype=dtype) if y is None else y.astype(dtype)
        return _epilogue(jnp.zeros((ny,), dtype=dtype), alpha_c * 0, beta_c, y0)
    ax = _spmv_core(A, descr, op, x.astype(A.dtype), kid)
    if beta_is_zero:
        # result is alpha*ax regardless of y — skip the accumulate (and,
        # when y is None, the zeros allocation + scalar transfers)
        if np.isscalar(alpha) and alpha == 1.0:
            return ax.astype(dtype)
        return _scale(ax.astype(dtype), jnp.asarray(alpha, dtype=dtype))
    alpha_c = jnp.asarray(alpha, dtype=dtype)
    beta_c = jnp.asarray(beta, dtype=dtype)
    y0 = jnp.zeros((ny,), dtype=dtype) if y is None else y.astype(dtype)
    return _epilogue(ax.astype(dtype), alpha_c, beta_c, y0)


class MvOperator:
    """Iteration-resident SpMV operator (see mv_operator)."""

    def __init__(self, apply, to_space, from_space, space: str):
        self.apply = apply  # v_space -> (A v)_space
        self.to_space = to_space  # original -> iteration space
        self.from_space = from_space  # iteration space -> original
        self.space = space  # "original"

    def __call__(self, v):
        return self.apply(v)


def mv_operator(
    A: SparseMatrix,
    descr: Optional[MatrixDescriptor] = None,
    op: Operation = Operation.none,
) -> MvOperator:
    """Resident operator for CHAINED y = A @ x iteration (power methods,
    user-written Krylov loops, any x <- f(A x) chain).

    `to_space` maps a vector into the iteration space once before the loop,
    `apply` iterates, `from_space` maps back once after. Every execution
    form iterates in the original index space, so both maps are the
    identity and `apply` is exactly the mv core; callers can use this API
    unconditionally. The reference reaches the same amortization through
    its hint/optimize model (aoclsparse_set_mv_hint + repeated
    aoclsparse_?mv reuse the optimized copy, analysis.cpp:35-385).
    """
    if A is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    descr = MatrixDescriptor() if descr is None else descr
    op, _, _, _ = _validate(A, descr, op, jnp.zeros((A.shape[1] if Operation(op) == Operation.none else A.shape[0],), A.dtype), None)
    plan = get_plan(A)
    form = plan.exec_form_for(descr, op, dtype=A.dtype)
    form.precision_mode = getattr(A, "precision_mode", "full")
    return MvOperator(
        lambda v: _run_exec_form(form, jnp.asarray(v), None),
        lambda v: jnp.asarray(v),
        lambda v: v,
        "original",
    )


@jax.jit
def _dot_conj(x, y):
    return jnp.sum(jnp.conj(x) * y)


def dotmv(
    alpha,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    op: Operation,
    x,
    beta,
    y=None,
    kid: Optional[int] = None,
):
    """Fused y = alpha*op(A)x + beta*y then d = <x, y> (conjugated for complex
    x, matching aoclsparse_dotmv.hpp:32). Returns (y, d)."""
    ynew = mv(alpha, A, descr, op, x, beta, y, kid=kid)
    if isinstance(ynew, np.ndarray):
        # host-engine result stays host-resident (kernels/host.py)
        d = np.sum(np.conj(np.asarray(x)).astype(ynew.dtype) * ynew)
        return ynew, d
    d = _dot_conj(jnp.asarray(x).astype(ynew.dtype), ynew)
    return ynew, d
