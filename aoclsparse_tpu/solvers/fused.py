"""Fused single-dispatch preconditioned Krylov solvers.

The host-driven RCI steppers (solvers/itsol.py) mirror the reference's
reverse-communication protocol; the reference's FORWARD interface fuses the
operator and preconditioner into one loop (aoclsparse_cg_solve,
itsol_functions.hpp:1352; gmres :1493). These are the device twins of that
forward path: the whole preconditioned solve — SpMV through the planner's
execution form, ILU0/SymGS application as blocked scans, vector updates,
convergence test — is ONE compiled XLA program (`lax.while_loop`), so a
full Krylov solve costs one dispatch instead of one per vector op.

Iteration semantics match the reference task machines (same update order,
same convergence tests), so iteration counts are comparable with the host
RCI path — pinned by tests/test_fused_solvers.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

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
from ..ops.level2.mv import _run_exec_form
from ..planner.plan import get_plan
from ..planner.triangular import trsv_form_for

__all__ = ["pcg_solve", "pgmres_solve", "make_cg_operator", "make_gmres_operator"]

GENERAL = MatrixDescriptor()
#: f32 basis products must not run in TF32 (kernels/xla/spmv.py)
HIGHEST = jax.lax.Precision.HIGHEST


def _pad_solve(form, r):
    """Traceable TrsvForm application on a 1-D rhs (see ilu._apply_form)."""
    m_pad = form.nblk * form.nb
    r2 = r[:, None]
    if form.reversed_:
        r2 = r2[::-1]
    if m_pad != form.m:
        r2 = jnp.pad(r2, ((0, m_pad - form.m), (0, 0)))
    x = form.solve(r2)[: form.m]
    if form.reversed_:
        x = x[::-1]
    return x[:, 0]


def _tri(fill, diag):
    return MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill, diag_type=diag)


def _make_apply(A: SparseMatrix, precond: Optional[str]):
    """Build a traceable z = M^{-1} r for the requested preconditioner.

    ILU0: two blocked scans over the cached factors (reference L/U
    substitution, ilu0.hpp:115-162). SGS: the zero-initial-guess symmetric
    GS sweep (symgs_ref steps with x0=0, solvers/aoclsparse_symgs.hpp:88):
    x1 = (L+D)^{-1} b ;  z = (U+D)^{-1} (b - L_s x1).
    """
    if precond is None:
        return None
    if precond == "ilu0":
        from .ilu import _ilu_level_forms, ilu0_factorize

        st = ilu0_factorize(A)
        if st.l_form is None:
            # blocked windows refused (oversized): level-scheduled sweeps
            l_lvl, u_lvl = _ilu_level_forms(st)

            def apply(r):
                return u_lvl.solve(l_lvl.solve(r))

            return apply

        def apply(r):
            return _pad_solve(st.u_form, _pad_solve(st.l_form, r))

        return apply
    if precond == "sgs":
        plan = get_plan(A)
        l_form = trsv_form_for(plan, _tri(FillMode.lower, DiagType.non_unit), Operation.none)
        u_form = trsv_form_for(plan, _tri(FillMode.upper, DiagType.non_unit), Operation.none)
        ls_eff_form = plan.exec_form_for(
            _tri(FillMode.lower, DiagType.zero), Operation.none, dtype=A.dtype
        )

        def apply(r):
            x1 = _pad_solve(l_form, r)
            t = r - _run_exec_form(ls_eff_form, x1, None)
            return _pad_solve(u_form, t)

        return apply
    raise AoclSparseError(Status.invalid_value, f"unknown preconditioner '{precond}'")


def _get_cache(A: SparseMatrix):
    plan = get_plan(A)
    if not hasattr(plan, "_fused_cache"):
        plan._fused_cache = {}
    return plan._fused_cache


def _build_cg_run(matvec, apply, maxit: int):
    """CG while_loop body over an arbitrary traceable `matvec` (and optional
    traceable preconditioner `apply`). Shared by the matrix-handle path
    (pcg_solve) and the matrix-free operator path (make_cg_operator)."""

    def run(b, x0, rtol_c, atol_c):
        # norms are real; dots stay UNCONJUGATED for complex dtypes
        # (the reference CG's complex-symmetric semantics,
        # itsol_functions.hpp:665-832 via cblas dotu)
        def nrm(v):
            return jnp.sqrt(jnp.sum(jnp.abs(v) ** 2).real)

        if apply is None and not jnp.iscomplexobj(b):
            # real unpreconditioned CG: rz = r.r doubles as ||r||^2, so the
            # loop runs on 2 reductions/iteration instead of 3 — each
            # reduction is a sequential barrier inside the while_loop
            # (same update order; the reference's RES_NORM is sqrt(rz))
            bnorm = nrm(b)
            brtol = rtol_c * bnorm
            r0 = matvec(x0) - b
            rr0 = jnp.sum(r0 * r0)

            def cond2(state):
                x, r, p, rr_prev, rr, k = state
                rnorm = jnp.sqrt(rr)
                not_conv = jnp.logical_and(rnorm > atol_c, rnorm > brtol)
                return jnp.logical_and(not_conv, k < maxit)

            def body2(state):
                x, r, p, rr_prev, rr, k = state
                beta = jnp.where(k == 0, jnp.zeros_like(rr), rr / rr_prev)
                p = beta * p - r
                q = matvec(p)
                alpha = rr / jnp.sum(p * q)
                x = x + alpha * p
                r = r + alpha * q
                return (x, r, p, rr, jnp.sum(r * r), k + 1)

            st2 = (
                x0,
                r0,
                jnp.zeros_like(x0),
                jnp.ones((), b.dtype),
                rr0,
                jnp.zeros((), jnp.int32),
            )
            x, r, p, rr_prev, rr, k = jax.lax.while_loop(cond2, body2, st2)
            return x, k, jnp.sqrt(rr)

        bnorm = nrm(b)
        brtol = rtol_c * bnorm
        r0 = matvec(x0) - b
        rn0 = nrm(r0)

        def cond(state):
            x, r, p, rz, k, rnorm = state
            not_conv = jnp.logical_and(rnorm > atol_c, rnorm > brtol)
            return jnp.logical_and(not_conv, k < maxit)

        def body(state):
            x, r, p, rz, k, rnorm = state
            z = apply(r) if apply is not None else r
            rz_new = jnp.sum(r * z)
            beta = jnp.where(k == 0, jnp.zeros_like(rz), rz_new / rz)
            p = beta * p - z
            q = matvec(p)
            alpha = rz_new / jnp.sum(p * q)
            x = x + alpha * p
            r = r + alpha * q
            return (x, r, p, rz_new, k + 1, nrm(r))

        st = (x0, r0, jnp.zeros_like(x0), jnp.ones((), b.dtype), jnp.zeros((), jnp.int32), rn0)
        x, r, p, rz, k, rnorm = jax.lax.while_loop(cond, body, st)
        return x, k, rnorm

    return run


def make_cg_operator(matvec, precond=None, maxit: int = 500):
    """Matrix-free fused CG: `matvec` (and optional `precond`) are arbitrary
    jax-traceable callables — the functional analog of driving the RCI loop
    with a user operator (SURVEY.md §7; the reference only reaches
    matrix-free operation through its RCI interface). Returns a reusable
    `solve(b, x0=None, rtol=1e-8, atol=0.0) -> (x, iters, rnorm)` closure
    whose whole solve is ONE compiled dispatch."""
    run = jax.jit(_build_cg_run(matvec, precond, int(maxit)))

    def solve(b, x0=None, rtol: float = 1e-8, atol: float = 0.0):
        b = jnp.asarray(b)
        x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).astype(b.dtype)
        rdt = jnp.zeros((), b.dtype).real.dtype
        x, k, rnorm = run(b, x0, jnp.asarray(rtol, rdt), jnp.asarray(atol, rdt))
        return x, int(k), float(rnorm)

    return solve


def pcg_solve(
    A: SparseMatrix,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxit: int = 500,
    precond: Optional[str] = None,
    descr: MatrixDescriptor = GENERAL,
) -> Tuple[jnp.ndarray, int, float]:
    """Preconditioned CG as one compiled program. Same update order as the
    reference CG task machine (itsol_functions.hpp:619-870): r = Ax - b,
    z = M^{-1} r, p = beta*p - z, alpha = rz/pq; convergence on ||r||_2
    against max(atol, rtol*||b||). Returns (x, iterations, final ||r||)."""
    if A.shape[0] != A.shape[1]:
        raise AoclSparseError(Status.invalid_size, "pcg requires square A")
    m = A.shape[0]
    b = jnp.asarray(b).astype(A.dtype)
    if b.shape != (m,):
        raise AoclSparseError(Status.invalid_size, f"b must be ({m},)")
    x0 = jnp.zeros((m,), A.dtype) if x0 is None else jnp.asarray(x0).astype(A.dtype)
    plan = get_plan(A)
    form = plan.exec_form_for(descr, Operation.none, dtype=A.dtype)
    apply = _make_apply(A, precond)
    rdt = jnp.zeros((), b.dtype).real.dtype  # tolerance dtype: real part
    cache = _get_cache(A)
    key = ("pcg", precond, int(maxit), descr.type, descr.fill_mode)
    ent = cache.get(key)
    if ent is None:

        def matvec(v):
            return _run_exec_form(form, v, None)

        # trace ONCE and pass the captured operands (exec form arrays, ILU
        # factor forms) as jit ARGUMENTS: closed-over they would become HLO
        # constants baked into the compiled program (GB-scale for large
        # band forms and ILU windows)
        run = _build_cg_run(matvec, apply, int(maxit))
        closed = jax.make_jaxpr(run)(
            b, x0, jnp.asarray(rtol, rdt), jnp.asarray(atol, rdt)
        )
        consts = [jnp.asarray(c) for c in closed.consts]

        @jax.jit
        def fn(b_, x0_, rt_, at_, *cs):
            return jax.core.eval_jaxpr(closed.jaxpr, list(cs), b_, x0_, rt_, at_)

        ent = (fn, consts)
        cache[key] = ent
    fn, consts = ent
    x, k, rnorm = fn(
        b, x0, jnp.asarray(rtol, rdt), jnp.asarray(atol, rdt), *consts
    )
    return x, int(k), float(rnorm)


def _build_gmres_run(matvec, apply, mr: int, maxit: int):
    """Restarted-GMRES while_loop body over arbitrary traceable `matvec` /
    right preconditioner `apply`. Shared by pgmres_solve and
    make_gmres_operator."""

    def op(v):
        return matvec(apply(v)) if apply is not None else matvec(v)

    def run(b, x0, rtol_c, atol_c):
        # complex-generic: norms are real, CGS dots are CONJUGATED
        # (<v_i, w> = v_i^H w), and the Givens rotations use the complex
        # form [c, s; -conj(s), c] with real c (LAPACK ?lartg semantics,
        # the reference's rotation source, itsol_functions.hpp:1133-1152).
        # For real dtypes every conj is a no-op and c/s reduce to the
        # reference's sign convention (r = sign(f)*d).
        dt = b.dtype
        rdt = jnp.zeros((), dt).real.dtype

        def nrm(v):
            return jnp.sqrt(jnp.sum(jnp.abs(v) ** 2).real).astype(rdt)

        bnorm = nrm(b)
        brtol = rtol_c * bnorm
        tol = jnp.maximum(atol_c, brtol)

        def cycle(x):
            """One restart cycle; returns (x_new, beta_end, n_inner)."""
            r0 = b - matvec(x)
            beta = nrm(r0)
            safe_beta = jnp.where(beta > 0, beta, jnp.ones((), rdt))
            V0 = jnp.zeros((mr + 1, b.shape[0]), dt).at[0].set(r0 / safe_beta)
            g0 = jnp.zeros((mr + 1,), dt).at[0].set(beta.astype(dt))
            H0 = jnp.zeros((mr + 1, mr), dt)
            c0 = jnp.zeros((mr,), rdt)
            s0 = jnp.zeros((mr,), dt)

            def arnoldi(carry, j):
                V, H, g, c, s, res, active = carry
                w = op(V[j])
                # CGS against all basis vectors, masked to i <= j
                hc = jnp.matmul(jnp.conj(V), w, precision=HIGHEST)  # (mr+1,)
                mask = jnp.arange(mr + 1) <= j
                hc = jnp.where(mask, hc, jnp.zeros((), dt))
                w = w - jnp.matmul(hc, V, precision=HIGHEST)
                hh = nrm(w)
                safe_hh = jnp.where(hh > 0, hh, jnp.ones((), rdt))
                V = V.at[j + 1].set(jnp.where(active, w / safe_hh, V[j + 1]))
                hcol = hc.at[j + 1].set(hh.astype(dt))

                # previous Givens rotations, masked scan over i < j
                def rot(hcol, i):
                    r1 = hcol[i]
                    r2 = hcol[i + 1]
                    nr1 = c[i] * r1 + s[i] * r2
                    nr2 = -jnp.conj(s[i]) * r1 + c[i] * r2
                    apply_i = i < j
                    hcol = hcol.at[i].set(jnp.where(apply_i, nr1, r1))
                    hcol = hcol.at[i + 1].set(jnp.where(apply_i, nr2, r2))
                    return hcol, None

                hcol, _ = jax.lax.scan(rot, hcol, jnp.arange(mr))
                f, gg = hcol[j], hcol[j + 1]
                af = jnp.abs(f).real.astype(rdt)
                d = jnp.sqrt(af * af + (jnp.abs(gg) ** 2).real).astype(rdt)
                safe_d = jnp.where(d > 0, d, jnp.ones((), rdt))
                safe_af = jnp.where(af > 0, af, jnp.ones((), rdt))
                # phase = f/|f| (1 when f = 0); real dtype: sign(f)
                phase = jnp.where(af > 0, f / safe_af.astype(dt), jnp.ones((), dt))
                cj = jnp.where(d > 0, af / safe_d, jnp.ones((), rdt))
                sj = jnp.where(
                    d > 0,
                    phase * jnp.conj(gg) / safe_d.astype(dt),
                    jnp.zeros((), dt),
                )
                rj = jnp.where(d > 0, phase * d.astype(dt), f)
                hcol = hcol.at[j].set(rj).at[j + 1].set(jnp.zeros((), dt))
                H = H.at[:, j].set(jnp.where(active, hcol, H[:, j]))
                c = c.at[j].set(jnp.where(active, cj, c[j]))
                s = s.at[j].set(jnp.where(active, sj, s[j]))
                gj = g[j]
                g = g.at[j].set(jnp.where(active, cj * gj, g[j]))
                g = g.at[j + 1].set(jnp.where(active, -jnp.conj(sj) * gj, g[j + 1]))
                res_new = jnp.where(active, jnp.abs(g[j + 1]).real.astype(rdt), res)
                took = active
                active = jnp.logical_and(active, res_new > tol)
                return (V, H, g, c, s, res_new, active), took

            init = (V0, H0, g0, c0, s0, beta, beta > tol)
            (V, H, g, c, s, res, _), took = jax.lax.scan(
                arnoldi, init, jnp.arange(mr)
            )
            n_inner = jnp.sum(took.astype(jnp.int32)).astype(jnp.int32)

            # back-substitution on the rotated H (masked to j < n_inner)
            def backsub(y, jj):
                j = mr - 1 - jj
                active_j = j < n_inner
                acc = g[j] - jnp.matmul(H[j], y, precision=HIGHEST)
                diag = jnp.where(jnp.abs(H[j, j]) > 0, H[j, j], jnp.ones((), dt))
                y = y.at[j].set(jnp.where(active_j, acc / diag, 0.0))
                return y, None

            y, _ = jax.lax.scan(backsub, jnp.zeros((mr,), dt), jnp.arange(mr))
            upd = jnp.matmul(y, V[:mr], precision=HIGHEST)
            upd = apply(upd) if apply is not None else upd
            return x + upd, res, n_inner

        def cond(state):
            x, res, it, cyc = state
            return jnp.logical_and(res > tol, it < maxit)

        def body(state):
            x, res, it, cyc = state
            x, res, n_inner = cycle(x)
            return (x, res, (it + n_inner).astype(jnp.int32), cyc + 1)

        r_init = b - matvec(x0)
        res0 = nrm(r_init)
        x, res, it, cyc = jax.lax.while_loop(
            cond, body, (x0, res0, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
        )
        return x, it, res

    return run


def make_gmres_operator(matvec, precond=None, maxit: int = 500, restart: int = 20):
    """Matrix-free fused restarted GMRES (right-preconditioned): `matvec`
    and optional `precond` are jax-traceable callables — the functional
    analog of the RCI operator protocol (SURVEY.md §7). Returns a reusable
    `solve(b, x0=None, rtol=1e-8, atol=0.0) -> (x, iters, rnorm)` closure;
    the whole solve is ONE compiled dispatch."""
    run = jax.jit(_build_gmres_run(matvec, precond, int(restart), int(maxit)))

    def solve(b, x0=None, rtol: float = 1e-8, atol: float = 0.0):
        b = jnp.asarray(b)
        x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).astype(b.dtype)
        rdt = jnp.zeros((), b.dtype).real.dtype
        x, k, rnorm = run(b, x0, jnp.asarray(rtol, rdt), jnp.asarray(atol, rdt))
        return x, int(k), float(rnorm)

    return solve


def pgmres_solve(
    A: SparseMatrix,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxit: int = 500,
    restart: int = 20,
    precond: Optional[str] = None,
    descr: MatrixDescriptor = GENERAL,
) -> Tuple[jnp.ndarray, int, float]:
    """Right-preconditioned restarted GMRES as one compiled program.

    Mirrors the reference engine (CGS orthogonalization + Givens rotations,
    itsol_functions.hpp:893-1290) with the Krylov cycle as a `lax.scan` of
    fixed length `restart` (masked past convergence) inside a while_loop
    over restarts. Right preconditioning keeps the true residual in the
    recurrence: x += M^{-1}(V y) applies M once per cycle.
    Returns (x, inner iterations, final residual norm)."""
    if A.shape[0] != A.shape[1]:
        raise AoclSparseError(Status.invalid_size, "pgmres requires square A")
    m = A.shape[0]
    b = jnp.asarray(b).astype(A.dtype)
    if b.shape != (m,):
        raise AoclSparseError(Status.invalid_size, f"b must be ({m},)")
    x0 = jnp.zeros((m,), A.dtype) if x0 is None else jnp.asarray(x0).astype(A.dtype)
    mr = int(restart)
    plan = get_plan(A)
    form = plan.exec_form_for(descr, Operation.none, dtype=A.dtype)
    apply = _make_apply(A, precond)
    cache = _get_cache(A)
    rdt = jnp.zeros((), b.dtype).real.dtype  # tolerance dtype: real part
    key = ("pgmres", precond, int(maxit), mr, descr.type, descr.fill_mode)
    ent = cache.get(key)
    if ent is None:

        def matvec(v):
            return _run_exec_form(form, v, None)

        # operands as jit arguments, not closure constants (see pcg_solve)
        run = _build_gmres_run(matvec, apply, mr, int(maxit))
        closed = jax.make_jaxpr(run)(
            b, x0, jnp.asarray(rtol, rdt), jnp.asarray(atol, rdt)
        )
        consts = [jnp.asarray(c) for c in closed.consts]

        @jax.jit
        def fn(b_, x0_, rt_, at_, *cs):
            return jax.core.eval_jaxpr(closed.jaxpr, list(cs), b_, x0_, rt_, at_)

        ent = (fn, consts)
        cache[key] = ent
    fn, consts = ent
    x, k, rnorm = fn(
        b, x0, jnp.asarray(rtol, rdt), jnp.asarray(atol, rdt), *consts
    )
    return x, int(k), float(rnorm)
