"""Iterative solver framework: CG + restarted GMRES, RCI + forward interfaces.

Reference: handle + per-type data (src/include/aoclsparse_itsol_data.hpp:
108-184), CG task state machine (solvers/aoclsparse_itsol_functions.hpp:619),
GMRES restarted CGS-Arnoldi + Givens (:893-1290), forward interfaces driving
the RCI internally (:1352 cg, :1493 gmres), entry points
aoclsparse_itsol_?_init/_solve/_rci_solve (aoclsparse_itsol_functions.cpp:
115-497), rinfo[100] statistics (RES_NORM=0, RHS_NORM=1, ITER=30,
itsol_functions.hpp:40-44).

Redesign (SURVEY.md §7): the RCI protocol keeps its exact job vocabulary
(interrupt/stop/start/mv/precond/stopping_criterion) but becomes a Python
stepper object — the functional analog of the reference's reverse
communication; every vector update between bounces is a jitted device op.
The forward interface drives the stepper with this library's mv and
preconditioners (ILU0 / SymGS), matching the reference's option wiring
("cg preconditioner" = None/User/SGS, "gmres preconditioner" =
None/User/ILU0).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.descr import MatrixDescriptor
from ..core.matrix import SparseMatrix
from ..core.types import AoclSparseError, Operation, Status
from ..ops.level2.mv import mv
from .options import (
    OptionRegistry,
    PRECOND_ILU0,
    PRECOND_NONE,
    PRECOND_SGS,
    PRECOND_USER,
    SOLVER_CG,
    default_registry,
)

#: contractions must not lower to TF32 (kernels/xla/spmv.py)
HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "RciJob",
    "RINFO_RES_NORM",
    "RINFO_RHS_NORM",
    "RINFO_ITER",
    "ItsolHandle",
    "itsol_handle_prn_options",
    "itsol_init",
    "itsol_option_set",
    "itsol_rci_input",
    "itsol_rci_solve",
    "itsol_solve",
    "itsol_solve_operator",
    "CgRci",
    "GmresRci",
]

RINFO_RES_NORM = 0
RINFO_RHS_NORM = 1
RINFO_ITER = 30


class RciJob(enum.IntEnum):
    """aoclsparse_itsol_rci_job (include/aoclsparse_solvers.h:113-134)."""

    interrupt = -1
    stop = 0
    start = 1
    mv = 2
    precond = 3
    stopping_criterion = 4


class ItsolHandle:
    """aoclsparse_itsol_handle analog: options + problem data."""

    def __init__(self, dtype=np.float64):
        self.dtype = np.dtype(dtype)
        self.options: OptionRegistry = default_registry(self.dtype)
        self.b = None
        self.n = None
        self.rci = None
        self.rinfo = np.zeros(100, dtype=np.float64)

    def solving(self) -> bool:
        return self.rci is not None


def itsol_init(dtype=np.float64) -> ItsolHandle:
    """aoclsparse_itsol_?_init."""
    return ItsolHandle(dtype)


def itsol_option_set(handle: ItsolHandle, name: str, value) -> None:
    """aoclsparse_itsol_option_set; rejected mid-solve like the reference."""
    if handle.solving():
        raise AoclSparseError(Status.invalid_operation, "cannot set options mid-solve")
    handle.options.set(name, value)


def itsol_handle_prn_options(handle: ItsolHandle, file=None) -> str:
    """aoclsparse_itsol_handle_prn_options (solvers.h:147): print the
    handle's option table (name, value, default, set/locked state). Returns
    the formatted table; writes it to `file` (default stdout) like the
    reference prints to stdout."""
    text = handle.options.print_options()
    print(text, file=file)
    return text


def itsol_rci_input(handle: ItsolHandle, n: int, b) -> None:
    """aoclsparse_itsol_?_rci_input: register problem size + rhs."""
    b = jnp.asarray(b)
    if b.shape != (n,):
        raise AoclSparseError(Status.invalid_size, f"b must be ({n},)")
    handle.n = int(n)
    handle.b = b.astype(handle.dtype)
    handle.rci = None


# ---------------------------------------------------------------------------
# jitted vector steps
# ---------------------------------------------------------------------------


@jax.jit
def _nrm2(x):
    return jnp.sqrt(jnp.sum(jnp.abs(x) ** 2).real)


@jax.jit
def _dotu(x, y):
    return jnp.sum(x * y)


@jax.jit
def _dotc(x, y):
    return jnp.sum(jnp.conj(x) * y)


# ---------------------------------------------------------------------------
# CG RCI state machine (itsol_functions.hpp:619-870)
# ---------------------------------------------------------------------------


class CgRci:
    """Preconditioned CG with the reference's exact task graph:
    start -> init_res -> check_conv -> start_iter -> compute_beta ->
    take_step -> check_conv."""

    def __init__(self, n, b, x0, rtol, atol, maxit, precond: bool, rinfo):
        self.n = n
        self.b = b
        self.x = jnp.asarray(x0, dtype=b.dtype)
        self.rtol, self.atol, self.maxit = float(rtol), float(atol), int(maxit)
        self.precond = bool(precond)
        self.rinfo = rinfo
        self.task = "start"
        self.niter = 0
        self.r = None
        self.p = None
        self.q = None
        self.z = None
        self.rz = 1.0
        self.status = Status.success

    def step(self, result=None) -> Tuple[RciJob, Optional[jnp.ndarray]]:
        """Advance until the next external job. `result` answers the
        previous job (v = A u or v = M^{-1} u). Returns (job, u)."""
        while True:
            if self.task == "start":
                self.rinfo[:] = 0.0
                self.niter = 0
                self.r = -self.b
                self.p = self.x
                bnorm = float(_nrm2(self.b))
                if np.isnan(bnorm):
                    raise AoclSparseError(Status.invalid_value, "b contains NaN")
                self.bnorm2 = bnorm
                self.rinfo[RINFO_RHS_NORM] = bnorm
                self.brtol = self.rtol * bnorm
                self.task = "init_res"
                return RciJob.mv, self.p  # q = A p

            if self.task == "init_res":
                self.q = result
                self.r = self.r + self.q
                rnorm = float(_nrm2(self.r))
                if np.isnan(rnorm):
                    self.status = Status.numerical_error
                    return RciJob.stop, None
                self.rnorm2 = rnorm
                self.rinfo[RINFO_RES_NORM] = rnorm
                self.p = jnp.zeros_like(self.p)
                self.rz = jnp.ones((), dtype=self.b.dtype)
                self.task = "check_conv"
                continue

            if self.task == "check_conv":
                if 0.0 < self.atol and self.rnorm2 <= self.atol:
                    return RciJob.stop, None
                if 0.0 < self.rtol and self.rnorm2 <= self.brtol:
                    return RciJob.stop, None
                if self.maxit > 0 and self.niter > self.maxit:
                    self.status = Status.maxit
                    return RciJob.stop, None
                self.task = "start_iter"
                return RciJob.stopping_criterion, self.r

            if self.task == "start_iter":
                self.niter += 1
                self.rinfo[RINFO_ITER] = self.niter
                self.task = "compute_beta"
                if not self.precond:
                    self.z = self.r
                    continue
                return RciJob.precond, self.r  # z = M^{-1} r

            if self.task == "compute_beta":
                if self.precond and result is not None:
                    self.z = result
                rz_new = _dotu(self.r, self.z)
                rz_c = complex(np.asarray(self.rz))
                # real dtypes: rz must stay positive (is_negative_or_nearzero);
                # complex (unconjugated dots): only magnitude breakdown applies
                if np.iscomplexobj(np.asarray(self.b)):
                    if abs(rz_c) < 1e-300:
                        raise AoclSparseError(Status.numerical_error, "CG breakdown: rz ~ 0")
                elif rz_c.real <= 0 or abs(rz_c.real) < 1e-300:
                    raise AoclSparseError(Status.numerical_error, "CG breakdown: rz <= 0")
                beta = rz_new / self.rz
                self.rz = rz_new
                self.p = beta * self.p - self.z
                self.task = "take_step"
                return RciJob.mv, self.p  # q = A p

            if self.task == "take_step":
                self.q = result
                pq = _dotu(self.p, self.q)
                pq_c = complex(np.asarray(pq))
                if np.iscomplexobj(np.asarray(self.b)):
                    if abs(pq_c) < 1e-300:
                        raise AoclSparseError(Status.numerical_error, "CG breakdown: pq ~ 0")
                elif pq_c.real <= 0 or abs(pq_c.real) < 1e-300:
                    raise AoclSparseError(
                        Status.numerical_error, "CG: matrix not positive definite"
                    )
                alpha = self.rz / pq
                self.x = self.x + alpha * self.p
                self.r = self.r + alpha * self.q
                rnorm = float(_nrm2(self.r))
                if np.isnan(rnorm):
                    self.status = Status.numerical_error
                    return RciJob.stop, None
                self.rnorm2 = rnorm
                self.rinfo[RINFO_RES_NORM] = rnorm
                self.task = "check_conv"
                continue

            raise AoclSparseError(Status.internal_error, f"bad CG task {self.task}")


# ---------------------------------------------------------------------------
# GMRES RCI state machine (itsol_functions.hpp:893-1290)
# ---------------------------------------------------------------------------


class GmresRci:
    """Right-preconditioned restarted GMRES with CGS orthogonalization and
    Givens rotations, restart cycle m = "gmres restart iterations"."""

    def __init__(self, n, b, x0, rtol, atol, maxit, restart, precond: bool, rinfo):
        self.n = n
        self.b = b
        self.x = jnp.asarray(x0, dtype=b.dtype)
        self.rtol, self.atol = float(rtol), float(atol)
        self.maxit, self.m = int(maxit), int(restart)
        self.precond = bool(precond)
        self.rinfo = rinfo
        self.task = "start"
        self.niter = 0
        self.status = Status.success
        dt = b.dtype
        self.V = []  # Krylov basis vectors
        self.Z = []  # preconditioned vectors (when precond)
        self.H = np.zeros((self.m + 1, self.m), dtype=dt)
        self.g = np.zeros(self.m + 1, dtype=dt)
        self.c = np.zeros(self.m, dtype=np.float64)
        self.s = np.zeros(self.m, dtype=dt)
        self.j = 0

    # Givens: lartg(f, g) -> c, s, r with c*f + s*g = r; c real
    @staticmethod
    def _lartg(f, g):
        af, ag = abs(f), abs(g)
        if ag == 0:
            return 1.0, 0.0 * g, f
        if af == 0:
            return 0.0, np.conj(g) / ag, ag
        d = np.sqrt(af * af + ag * ag)
        c = af / d
        r = f / af * d
        s = np.conj(g) * (f / af) / d
        return c, s, r

    @staticmethod
    def _backsolve(R, g):
        """Upper-triangular back-substitution y = R^{-1} g.

        The reference solves the rotated Hessenberg system the same way
        (itsol_functions.hpp:1237-1255) rather than with a general solver —
        H[:j,:j] is upper triangular by construction after the Givens sweep,
        and a general LU here could silently mask a rotation bug."""
        j = len(g)
        y = np.zeros(j, dtype=R.dtype)
        for i in range(j - 1, -1, -1):
            acc = g[i] - jnp.matmul(R[i, i + 1 :], y[i + 1 :], precision=HIGHEST)
            y[i] = acc / R[i, i]
        return y

    def _start_cycle_residual(self, v):
        """v = A x computed; build r0 = b - v, check convergence, set v0.

        beta == 0 (exact initial guess / b == 0) counts as converged — the
        basis normalization r0/beta below would otherwise produce NaN."""
        r0 = self.b - v
        beta = float(_nrm2(r0))
        self.rinfo[RINFO_RES_NORM] = beta
        self.rnorm2 = beta
        if beta <= self.atol or beta <= self.brtol:
            self.rinfo[RINFO_ITER] = self.niter
            return True
        self.V = [r0 / beta]
        self.Z = []
        self.H[:] = 0
        self.g[:] = 0
        self.g[0] = beta
        self.j = 0
        return False

    def step(self, result=None) -> Tuple[RciJob, Optional[jnp.ndarray]]:
        while True:
            if self.task == "start":
                bnorm = float(_nrm2(self.b))
                if np.isnan(bnorm):
                    raise AoclSparseError(Status.invalid_value, "b contains NaN")
                self.rinfo[RINFO_RHS_NORM] = bnorm
                self.brtol = self.rtol * bnorm
                if self.atol <= 0 and self.brtol <= 0:
                    raise AoclSparseError(Status.invalid_value, "both tolerances zero")
                self.task = "init_res"
                return RciJob.mv, self.x

            if self.task == "init_res":
                if self._start_cycle_residual(result):
                    return RciJob.stop, None
                self.task = "inner_precond"
                continue

            if self.task == "inner_precond":
                if not self.precond:
                    self.task = "inner_mv"
                    result = None
                    continue
                self.task = "inner_mv"
                return RciJob.precond, self.V[self.j]

            if self.task == "inner_mv":
                if self.precond:
                    self.Z.append(result)
                    u = result
                else:
                    u = self.V[self.j]
                self.task = "arnoldi"
                return RciJob.mv, u  # w = A u

            if self.task == "arnoldi":
                w = result
                j, m = self.j, self.m
                # CGS orthogonalization against V[0..j]
                hcol = np.zeros(j + 2, dtype=self.H.dtype)
                for i in range(j + 1):
                    hij = complex(np.asarray(_dotc(self.V[i], w)))
                    if not np.iscomplexobj(self.H):
                        hij = hij.real
                    hcol[i] = hij
                    w = w - hcol[i] * self.V[i]
                hh = float(_nrm2(w))
                breakdown = (hh < self.atol) or (hh < self.brtol)
                if not breakdown:
                    self.V.append(w / hh)
                hcol[j + 1] = hh
                # apply previous rotations, then the new one — also on the
                # happy-breakdown path, so H[:j+1,:j+1] stays a complete
                # upper-triangular factor for the x-update back-solve
                for i in range(j):
                    r1, r2 = hcol[i], hcol[i + 1]
                    hcol[i] = self.c[i] * r1 + self.s[i] * r2
                    hcol[i + 1] = -np.conj(self.s[i]) * r1 + self.c[i] * r2
                cj, sj, rj = self._lartg(hcol[j], hcol[j + 1])
                self.c[j], self.s[j] = cj, sj
                hcol[j], hcol[j + 1] = rj, 0.0
                self.H[: j + 2, j] = hcol
                g0 = self.g[j]
                self.g[j] = cj * g0
                self.g[j + 1] = -np.conj(sj) * g0
                self.rnorm2 = abs(self.g[j + 1])
                self.rinfo[RINFO_RES_NORM] = self.rnorm2
                self.j += 1
                if breakdown:
                    # residual already (numerically) in span(V): solve with the
                    # j+1 completed columns and accept the updated x
                    self.niter += self.j
                    self.rinfo[RINFO_ITER] = self.niter
                    self.task = "x_update_ortho"
                    continue
                if self.j >= m:
                    self.task = "x_update"
                    continue
                self.task = "inner_precond"
                continue

            if self.task in ("x_update", "x_update_ortho"):
                j = self.j
                if j > 0:
                    y = self._backsolve(self.H[:j, :j], self.g[:j])
                    basis = self.Z if self.precond else self.V
                    upd = jnp.zeros_like(self.x)
                    for i in range(j):
                        upd = upd + jnp.asarray(y[i]) * basis[i]
                    self.x = self.x + upd
                if self.task == "x_update_ortho":
                    return RciJob.stop, None
                self.niter += j
                self.rinfo[RINFO_ITER] = self.niter
                converged = self.rnorm2 <= self.atol or self.rnorm2 <= self.brtol
                if self.maxit > 0 and self.niter >= self.maxit and not converged:
                    self.status = Status.maxit
                    return RciJob.stop, None
                if converged:
                    self.task = "stopped"
                    return RciJob.stopping_criterion, self.x
                # restart: bounce stopping_criterion first so RCI drivers can
                # monitor/interrupt at every cycle boundary (the reference's
                # gmres RCI monitoring cadence, itsol_functions.hpp:893)
                self.task = "restart_bounce"
                return RciJob.stopping_criterion, self.x

            if self.task == "restart_bounce":
                self.task = "init_res"
                return RciJob.mv, self.x

            if self.task == "stopped":
                return RciJob.stop, None

            raise AoclSparseError(Status.internal_error, f"bad GMRES task {self.task}")


# ---------------------------------------------------------------------------
# RCI + forward entry points
# ---------------------------------------------------------------------------


def _make_rci(handle: ItsolHandle, x0, user_precond: bool):
    opts = handle.options
    solver = opts.get("iterative method", lock=True)
    if handle.b is None:
        raise AoclSparseError(Status.invalid_value, "call itsol_rci_input first")
    if solver == SOLVER_CG:
        pre = opts.get("cg preconditioner", lock=True)
        return CgRci(
            handle.n,
            handle.b,
            x0,
            opts.get("cg rel tolerance", lock=True),
            opts.get("cg abs tolerance", lock=True),
            opts.get("cg iteration limit", lock=True),
            precond=(pre != PRECOND_NONE),
            rinfo=handle.rinfo,
        )
    pre = opts.get("gmres preconditioner", lock=True)
    return GmresRci(
        handle.n,
        handle.b,
        x0,
        opts.get("gmres rel tolerance", lock=True),
        opts.get("gmres abs tolerance", lock=True),
        opts.get("gmres iteration limit", lock=True),
        opts.get("gmres restart iterations", lock=True),
        precond=(pre != PRECOND_NONE),
        rinfo=handle.rinfo,
    )


def itsol_rci_solve(handle: ItsolHandle, x0=None):
    """aoclsparse_itsol_?_rci_solve analog: returns the stepper. Drive it:

        rci = itsol_rci_solve(h, x0)
        job, u = rci.step()
        while job not in (RciJob.stop,):
            if job == RciJob.mv:        job, u = rci.step(A @ u)
            elif job == RciJob.precond: job, u = rci.step(M_inv(u))
            else:                       job, u = rci.step()   # monitoring
        x = rci.x
    """
    if handle.b is None or handle.n is None:
        raise AoclSparseError(Status.invalid_value, "call itsol_rci_input first")
    x0 = jnp.zeros((handle.n,), handle.dtype) if x0 is None else jnp.asarray(x0)
    handle.rci = _make_rci(handle, x0, user_precond=True)
    return handle.rci


def itsol_solve(
    handle: ItsolHandle,
    n: int,
    A: SparseMatrix,
    descr: MatrixDescriptor,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    monitoring: Optional[Callable] = None,
):
    """Forward interface (aoclsparse_itsol_?_solve, itsol_functions.hpp:543):
    drives the RCI loop internally, wiring mv and the option-selected
    preconditioner (User -> `precond` callable; SGS/ILU0 -> this library's).
    Returns (x, rinfo, status). `monitoring(x_or_r, rinfo)` may return
    nonzero to request user_stop."""
    if A is None or descr is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix/descriptor")
    if A.shape != (n, n):
        raise AoclSparseError(Status.invalid_size, f"A must be ({n},{n})")
    itsol_rci_input(handle, n, b)
    x0 = jnp.zeros((n,), handle.dtype) if x0 is None else jnp.asarray(x0)
    opts = handle.options
    solver = opts.get("iterative method")
    pre_id = opts.get("cg preconditioner" if solver == SOLVER_CG else "gmres preconditioner")

    if pre_id == PRECOND_USER and precond is None:
        raise AoclSparseError(Status.invalid_value, "User preconditioner requires callable")
    if pre_id == PRECOND_SGS:
        from .symgs import symgs

        def precond_fn(u):
            return symgs(Operation.none, A, descr, 1.0, u)

    elif pre_id == PRECOND_ILU0:
        from .ilu import ilu_smoother

        def precond_fn(u):
            return ilu_smoother(A, descr, u)

    elif pre_id == PRECOND_USER:
        precond_fn = precond
    else:
        precond_fn = None

    rci = _make_rci(handle, x0, user_precond=False)
    handle.rci = rci
    try:
        job, u = rci.step()
        while job != RciJob.stop:
            if job == RciJob.mv:
                v = mv(1.0, A, descr, Operation.none, u, 0.0)
                job, u = rci.step(v)
            elif job == RciJob.precond:
                if precond_fn is not None:
                    v = precond_fn(u)
                    if v is None:
                        # reference precond callback returning nonzero flag
                        # requests termination (itsol_functions.hpp:1366,
                        # cg_ut_functions.hpp:62-72 precond_dummy) — the
                        # Python contract is returning None
                        rci.status = Status.user_stop
                        break
                    job, u = rci.step(v)
                else:
                    job, u = rci.step(u)
            else:  # stopping_criterion / monitoring bounce
                if monitoring is not None:
                    flag = monitoring(np.asarray(u), handle.rinfo)
                    if flag:
                        rci.status = Status.user_stop
                        break
                job, u = rci.step()
    finally:
        handle.rci = None
        handle.options.unlock_all()
    if rci.status not in (Status.success,):
        if rci.status == Status.maxit:
            # reference returns the best x with maxit status; surface both
            return rci.x, handle.rinfo, Status.maxit
    return rci.x, handle.rinfo, rci.status


def itsol_solve_operator(
    handle: ItsolHandle,
    n: int,
    matvec: Callable,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    monitoring: Optional[Callable] = None,
):
    """Matrix-free forward interface: like itsol_solve but `matvec` is any
    callable v -> A@v (the functional operator protocol SURVEY.md §7 maps
    the reference's RCI onto; the reference reaches matrix-free use only by
    hand-driving aoclsparse_itsol_?_rci_solve). The SGS/ILU0 preconditioner
    options need a matrix handle and therefore raise invalid_value here —
    pass a `precond` callable with the "User" option instead.
    Returns (x, rinfo, status)."""
    if matvec is None:
        raise AoclSparseError(Status.invalid_pointer, "null matvec")
    itsol_rci_input(handle, n, b)
    x0 = jnp.zeros((n,), handle.dtype) if x0 is None else jnp.asarray(x0)
    opts = handle.options
    solver = opts.get("iterative method")
    pre_id = opts.get("cg preconditioner" if solver == SOLVER_CG else "gmres preconditioner")
    if pre_id == PRECOND_USER and precond is None:
        raise AoclSparseError(Status.invalid_value, "User preconditioner requires callable")
    if pre_id not in (PRECOND_NONE, PRECOND_USER):
        raise AoclSparseError(
            Status.invalid_value,
            "matrix-free solve supports only None/User preconditioners",
        )
    precond_fn = precond if pre_id == PRECOND_USER else None

    rci = _make_rci(handle, x0, user_precond=False)
    handle.rci = rci
    try:
        job, u = rci.step()
        while job != RciJob.stop:
            if job == RciJob.mv:
                job, u = rci.step(jnp.asarray(matvec(u)))
            elif job == RciJob.precond:
                if precond_fn is not None:
                    v = precond_fn(u)
                    if v is None:  # user-stop request (see itsol_solve)
                        rci.status = Status.user_stop
                        break
                    job, u = rci.step(v)
                else:
                    job, u = rci.step(u)
            else:
                if monitoring is not None:
                    flag = monitoring(np.asarray(u), handle.rinfo)
                    if flag:
                        rci.status = Status.user_stop
                        break
                job, u = rci.step()
    finally:
        handle.rci = None
        handle.options.unlock_all()
    if rci.status == Status.maxit:
        return rci.x, handle.rinfo, Status.maxit
    return rci.x, handle.rinfo, rci.status
