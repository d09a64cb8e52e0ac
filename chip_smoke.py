#!/usr/bin/env python
"""Drive the library's main path once on an NVIDIA GPU and check every result.

    python chip_smoke.py           # one card: mv, mm, trsv, sp2m, CG, GMRES
    python chip_smoke.py --four    # four cards: distributed halo SpMV and CG

Every operand is a seeded SuiteSparse stand-in from ``benchmarks/realmat.py``
at its published size; nothing is downloaded. Every phase goes through the
public API (``create_csr``, hints/``optimize``, ``mv``, ``mm``, ``trsv``,
``sp2m``, ``itsol_solve``) and is compared with ``scipy.sparse`` in float64.
The error and its tolerance (``utils/tolerances.py``) are printed side by
side.

Output, one line each: the card as ``nvidia-smi`` reports its name and power
limit; whether the native host library loaded; one JSON object per phase;
and last

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

The script exits non-zero, without that last line, when JAX's default device
is not a GPU, when the native host library is missing, when any phase
raises, and when any error exceeds its tolerance.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

#: relative-error scales passed to utils.tolerances.expected_precision.
#: Scale 1 puts the float32 bound (~9.8e-4) far below the error a TF32
#: contraction leaves on the boosted pwtk operand (~1.6e-2 with its operands
#: rounded to nearest TF32; tests/test_chip_smoke.py), so an f32 phase that
#: ran in TF32 fails here.
PRODUCT_SCALE = 1.0
#: triangular solves amplify rounding by the conditioning of the triangle
SOLVE_SCALE = 10.0
#: Krylov phases: the residual recomputed by scipy must be within this
#: multiple of the requested rtol (the solver's own residual is recursive)
RESIDUAL_SLACK = 10.0
#: diagonal boost that makes the FEM and circuit stand-ins SPD / strongly
#: nonsingular for the solver and triangular phases
DIAG_BOOST = 80.0


class PhaseFailure(AssertionError):
    """A phase's result was outside its tolerance."""


def require_gpu(count: int = 1):
    """Return jax.devices() if the default device is a GPU and there are at
    least `count` of them; otherwise stop the program with a non-zero exit."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX's default device is {devs[0].platform!r}; a GPU is required"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: {count} GPUs required, JAX sees {len(devs)}")
    return devs


class CompileClock:
    """Sums JAX's own compile-duration events (trace, lowering, backend
    compile) so each phase can report compile seconds apart from host
    planning and steady-state run time."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.total += duration


def _median_seconds(fn, reps: int) -> float:
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def max_rel_err(got, ref) -> float:
    """max_i |got_i - ref_i| / max(|ref_i|, 1): the absolute-or-relative
    metric of utils/tolerances.assert_allclose_spec."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise PhaseFailure(f"shape {got.shape} != reference shape {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise PhaseFailure("non-finite values in the result")
    if ref.size == 0:
        return 0.0
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))


def scipy_csr(mat, dtype=np.float64):
    import scipy.sparse as sp

    m, n, ptr, ind, val = mat
    return sp.csr_matrix((np.asarray(val).astype(dtype), ind, ptr), shape=(m, n))


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Smoke:
    """Runs phases, prints one JSON line each, and remembers failures."""

    def __init__(self, reps: int = 20, out=sys.stdout):
        import jax

        jax.config.update("jax_enable_x64", True)
        import aoclsparse_tpu as asp

        self.asp = asp
        self.reps = reps
        self.out = out
        self.clock = CompileClock()
        self.failures: list[str] = []

    # -- helpers ---------------------------------------------------------
    def _emit(self, rec: dict) -> dict:
        print(json.dumps(rec), file=self.out, flush=True)
        return rec

    def _run(self, phase: str, fn, **ident) -> dict:
        """Run one phase; a raised error or a tolerance miss is recorded as
        a failure (the phase line says why) and the remaining phases go on."""
        c0 = self.clock.total
        try:
            rec = fn()
        except Exception as e:  # noqa: BLE001 - reported, then the run fails
            self.failures.append(phase)
            return self._emit({"phase": phase, **ident, "ok": False, "error": repr(e)[:400]})
        rec = {"phase": phase, **ident, **rec}
        rec["compile_s"] = self.clock.total - c0
        rec["peak_bytes_in_use"] = peak_bytes()
        ok = rec["err"] <= rec["tol"]
        rec["ok"] = ok
        if not ok:
            self.failures.append(phase)
        return self._emit(rec)

    def _dispatch(self, op, A, kind=None, kid=None):
        """(execution form, KID) the planner picked for A's general form."""
        from aoclsparse_tpu.planner.plan import get_plan

        form = get_plan(A).exec_form_for(
            self.asp.GENERAL, self.asp.Operation.none, kind=kind, dtype=A.dtype
        )
        info = self.asp.debug_dispatcher(op, fmt=form.kind, kid=kid)
        return form.kind, info["kid"], info["name"]

    def _first_and_steady(self, call):
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(call())
        first = time.perf_counter() - t0
        jax.block_until_ready(call())
        return out, first, _median_seconds(call, self.reps)

    # -- phases ----------------------------------------------------------
    def mv(self, name, mat, dtype, kind=None, seed=0):
        """y = A x through asp.mv; kind pins an execution form by its KID."""
        import jax.numpy as jnp

        from aoclsparse_tpu.utils.tolerances import expected_precision

        asp, GEN, NONE = self.asp, self.asp.GENERAL, self.asp.Operation.none
        m, n, ptr, ind, val = mat
        dtype = np.dtype(dtype)

        def run():
            x = np.random.default_rng(seed).standard_normal(n).astype(dtype)
            v = np.asarray(val).astype(dtype)
            t0 = time.perf_counter()
            A = asp.create_csr(m, n, ptr, ind, v)
            asp.set_mv_hint(A, NONE, GEN, nop=1000)
            asp.optimize(A)
            kid = None if kind is None else asp.debug_dispatcher("mv", fmt=kind)["kid"]
            form, kid_run, kname = self._dispatch("mv", A, kind=kind, kid=kid)
            plan_s = time.perf_counter() - t0
            xd = jnp.asarray(x)
            y, first, steady = self._first_and_steady(
                lambda: asp.mv(1.0, A, GEN, NONE, xd, 0.0, kid=kid)
            )
            ref = scipy_csr((m, n, ptr, ind, v)) @ x.astype(np.float64)
            return dict(
                form=form, kid=kid_run, kernel=kname, plan_s=plan_s,
                first_call_s=first, steady_s=steady,
                err=max_rel_err(y, ref), tol=expected_precision(dtype, PRODUCT_SCALE),
            )

        return self._run(
            "mv" if kind is None else f"mv_{kind}", run,
            matrix=name, dtype=dtype.name, rows=m, nnz=int(ptr[-1]),
        )

    def mm(self, name, mat, dtype, k=64, seed=1):
        """C = A B through asp.mm with a dense (n, k) B."""
        import jax.numpy as jnp

        from aoclsparse_tpu.utils.tolerances import expected_precision

        asp, GEN, NONE = self.asp, self.asp.GENERAL, self.asp.Operation.none
        m, n, ptr, ind, val = mat
        dtype = np.dtype(dtype)

        def run():
            B = np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)
            v = np.asarray(val).astype(dtype)
            t0 = time.perf_counter()
            A = asp.create_csr(m, n, ptr, ind, v)
            asp.set_mm_hint(A, NONE, GEN, nop=1000)
            asp.optimize(A)
            form, kid, kname = self._dispatch("mm", A)
            plan_s = time.perf_counter() - t0
            Bd = jnp.asarray(B)
            C, first, steady = self._first_and_steady(
                lambda: asp.mm(1.0, A, GEN, NONE, Bd, 0.0)
            )
            ref = scipy_csr((m, n, ptr, ind, v)) @ B.astype(np.float64)
            return dict(
                form=form, kid=kid, kernel=kname, plan_s=plan_s,
                first_call_s=first, steady_s=steady,
                err=max_rel_err(C, ref), tol=expected_precision(dtype, PRODUCT_SCALE),
            )

        return self._run("mm", run, matrix=name, dtype=dtype.name, rows=m,
                         nnz=int(ptr[-1]), k=k)

    def trsv(self, name, mat, dtype=np.float64, seed=2):
        """Lower, non-unit triangular solve on the lower triangle of A."""
        import jax.numpy as jnp
        import scipy.sparse as sp
        from scipy.sparse.linalg import spsolve_triangular

        from aoclsparse_tpu.planner.plan import get_plan
        from aoclsparse_tpu.planner.triangular import trsv_form_for
        from aoclsparse_tpu.utils.tolerances import expected_precision

        asp, NONE = self.asp, self.asp.Operation.none
        m, n, ptr, ind, val = mat
        dtype = np.dtype(dtype)
        descr = asp.MatrixDescriptor(
            type=asp.MatrixType.triangular,
            fill_mode=asp.FillMode.lower,
            diag_type=asp.DiagType.non_unit,
        )

        def run():
            b = np.random.default_rng(seed).standard_normal(m).astype(dtype)
            v = np.asarray(val).astype(dtype)
            t0 = time.perf_counter()
            A = asp.create_csr(m, n, ptr, ind, v)
            asp.set_sv_hint(A, NONE, descr, nop=1000)
            asp.optimize(A)
            plan_s = time.perf_counter() - t0
            bd = jnp.asarray(b)
            x, first, steady = self._first_and_steady(
                lambda: asp.trsv(1.0, A, descr, NONE, bd)
            )
            L = sp.tril(scipy_csr((m, n, ptr, ind, v))).tocsr()
            ref = spsolve_triangular(L, b.astype(np.float64), lower=True)
            info = asp.debug_dispatcher("sv")
            tform = trsv_form_for(get_plan(A), descr, NONE)  # cached by the call
            return dict(
                form=f"{info['fmt']}:{tform.kind}", kid=info["kid"], kernel=info["name"],
                plan_s=plan_s,
                first_call_s=first, steady_s=steady,
                err=max_rel_err(x, ref), tol=expected_precision(dtype, SOLVE_SCALE),
            )

        return self._run("trsv", run, matrix=name, dtype=dtype.name, rows=m,
                         nnz=int(ptr[-1]))

    def sp2m(self, name, mat, dtype=np.float64, reps=3):
        """C = A A through the two-stage protocol (nnz_count, then finalize);
        the pattern must equal scipy's exactly, the values within tolerance."""
        from aoclsparse_tpu.utils.tolerances import expected_precision

        asp, GEN, NONE = self.asp, self.asp.GENERAL, self.asp.Operation.none
        m, n, ptr, ind, val = mat
        dtype = np.dtype(dtype)

        def run():
            v = np.asarray(val).astype(dtype)
            A = asp.create_csr(m, n, ptr, ind, v)
            t0 = time.perf_counter()
            C = asp.sp2m(NONE, GEN, A, NONE, GEN, A, request=asp.Request.nnz_count)
            symbolic_s = time.perf_counter() - t0

            def finalize():
                out = asp.sp2m(NONE, GEN, A, NONE, GEN, A, request=asp.Request.finalize, C=C)
                return asp.export_csr(out)[3:]

            t0 = time.perf_counter()
            cptr, cind, cval = finalize()
            first = time.perf_counter() - t0
            steady = float(np.median([_timed(finalize) for _ in range(reps)]))
            As = scipy_csr((m, n, ptr, ind, v))
            ref = (As @ As).tocsr()
            ref.sort_indices()
            pat = scipy_csr((m, n, ptr, ind, np.ones_like(v)))
            pat = (pat @ pat).tocsr()  # counts >= 1: no cancellation drops
            pat.sort_indices()
            if not (np.array_equal(cptr, pat.indptr) and np.array_equal(cind, pat.indices)):
                raise PhaseFailure("sp2m pattern differs from scipy's A @ A")
            dense_ref = np.zeros(cind.size)
            # ref may have dropped exact zeros: scatter it onto the pattern
            rows_r = np.repeat(np.arange(m), np.diff(ref.indptr))
            pos = _positions(pat.indptr, pat.indices, rows_r, ref.indices)
            dense_ref[pos] = ref.data
            host = _native_ok() and C._spgemm_plan.P > (1 << 17)  # ops/level3/spgemm.py
            return dict(
                form="host" if host else "device", kid=None, kernel="sp2m",
                plan_s=symbolic_s, first_call_s=first, steady_s=steady, nnz_c=int(cind.size),
                err=max_rel_err(cval, dense_ref), tol=expected_precision(dtype, PRODUCT_SCALE),
            )

        return self._run("sp2m", run, matrix=name, dtype=dtype.name, rows=m,
                         nnz=int(ptr[-1]))

    def itsol(self, name, mat, method, precond, rtol=1e-8, dtype=np.float64, seed=3):
        """itsol_solve (CG + SymGS or GMRES + ILU0); the residual is
        recomputed by scipy from the returned x."""
        import jax.numpy as jnp

        asp, GEN = self.asp, self.asp.GENERAL
        m, n, ptr, ind, val = mat
        dtype = np.dtype(dtype)
        pre_opt = "cg preconditioner" if method == "cg" else "gmres preconditioner"
        tol_opt = "cg rel tolerance" if method == "cg" else "gmres rel tolerance"
        abs_opt = "cg abs tolerance" if method == "cg" else "gmres abs tolerance"

        def run():
            b = np.random.default_rng(seed).standard_normal(m).astype(dtype)
            v = np.asarray(val).astype(dtype)
            t0 = time.perf_counter()
            A = asp.create_csr(m, n, ptr, ind, v)
            asp.set_mv_hint(A, asp.Operation.none, GEN, nop=1000)
            asp.optimize(A)
            plan_s = time.perf_counter() - t0
            bd = jnp.asarray(b)

            def solve():
                h = asp.itsol_init(dtype)
                asp.itsol_option_set(h, "iterative method", method)
                asp.itsol_option_set(h, pre_opt, precond)
                asp.itsol_option_set(h, tol_opt, rtol)
                asp.itsol_option_set(h, abs_opt, 0.0)
                x, rinfo, status = asp.itsol_solve(h, m, A, GEN, bd)
                if status != asp.Status.success:
                    raise PhaseFailure(f"itsol_solve returned {status!r}")
                return x, int(rinfo[30])

            t0 = time.perf_counter()
            x, iters = solve()
            first = time.perf_counter() - t0
            steady = float(np.median([_timed(lambda: solve()[0]) for _ in range(2)]))
            As = scipy_csr((m, n, ptr, ind, v))
            res = np.linalg.norm(b - As @ np.asarray(x, np.float64)) / np.linalg.norm(b)
            return dict(
                form=self._dispatch("mv", A)[0], kid=None, kernel=f"{method}+{precond}",
                plan_s=plan_s, first_call_s=first, steady_s=steady, iters=iters,
                err=float(res), tol=RESIDUAL_SLACK * rtol,
            )

        return self._run(f"itsol_{method}_{precond.lower()}", run, matrix=name,
                         dtype=dtype.name, rows=m, nnz=int(ptr[-1]))

    def dist(self, name, mat, ndev, rtol=1e-8, dtype=np.float64, seed=4):
        """Four-card phases: halo SpMV and halo CG over a row-partitioned
        band operand, each compared with the one-card path on the same
        operand (mv, and itsol_solve CG) and with scipy."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from aoclsparse_tpu.parallel import dist_cg_bwd_halo, dist_spmv_bwd_halo, make_mesh
        from aoclsparse_tpu.planner.plan import get_plan
        from aoclsparse_tpu.utils.tolerances import expected_precision

        asp, GEN, NONE = self.asp, self.asp.GENERAL, self.asp.Operation.none
        m, n, ptr, ind, val = mat
        dtype = np.dtype(dtype)
        ident = dict(matrix=name, dtype=dtype.name, rows=m, nnz=int(ptr[-1]), devices=ndev)
        v = np.asarray(val).astype(dtype)
        As = scipy_csr((m, n, ptr, ind, v))
        A = asp.create_csr(m, n, ptr, ind, v)
        mesh = make_mesh(ndev)
        m_pad = -(-m // (8 * ndev)) * 8 * ndev

        def spmv():
            t0 = time.perf_counter()
            form = get_plan(A).exec_form_for(GEN, NONE, kind="bwd", dtype=A.dtype)
            plan_s = time.perf_counter() - t0
            x = np.random.default_rng(seed).standard_normal(n).astype(dtype)
            x_sh = jax.device_put(jnp.pad(jnp.asarray(x), (0, m_pad - n)),
                                  NamedSharding(mesh, P("x")))
            y, first, steady = self._first_and_steady(
                lambda: dist_spmv_bwd_halo(mesh, form, x_sh)
            )
            shards = len({s.device for s in y.addressable_shards})
            if shards != ndev:
                raise PhaseFailure(f"halo SpMV result spans {shards} devices, not {ndev}")
            y1 = asp.mv(1.0, A, GEN, NONE, jnp.asarray(x), 0.0)
            ref = As @ x.astype(np.float64)
            vs_one = max_rel_err(np.asarray(y)[:m], np.asarray(y1))
            vs_ref = max_rel_err(np.asarray(y)[:m], ref)
            return dict(
                form="bwd", kid=None, kernel="dist_spmv_bwd_halo", plan_s=plan_s,
                first_call_s=first, steady_s=steady, devices_used=shards,
                err_vs_one_card=vs_one, err_vs_scipy=vs_ref,
                err=max(vs_one, vs_ref), tol=expected_precision(dtype, PRODUCT_SCALE),
            )

        def cg():
            form = get_plan(A).exec_form_for(GEN, NONE, kind="bwd", dtype=A.dtype)
            b = np.random.default_rng(seed + 1).standard_normal(m).astype(dtype)
            t0 = time.perf_counter()
            x, iters, _ = dist_cg_bwd_halo(mesh, form, b, rtol=rtol, maxit=2000)
            first = time.perf_counter() - t0
            steady = float(np.median([
                _timed(lambda: dist_cg_bwd_halo(mesh, form, b, rtol=rtol, maxit=2000)[0])
                for _ in range(2)
            ]))
            h = asp.itsol_init(dtype)
            asp.itsol_option_set(h, "cg rel tolerance", rtol)
            asp.itsol_option_set(h, "cg abs tolerance", 0.0)
            asp.itsol_option_set(h, "cg iteration limit", 2000)
            x1, rinfo, status = asp.itsol_solve(h, m, A, GEN, jnp.asarray(b))
            x = np.asarray(x, np.float64)
            res = np.linalg.norm(b - As @ x) / np.linalg.norm(b)
            res1 = np.linalg.norm(b - As @ np.asarray(x1, np.float64)) / np.linalg.norm(b)
            x_diff = float(np.linalg.norm(x - np.asarray(x1)) / np.linalg.norm(np.asarray(x1)))
            if status != asp.Status.success or x_diff > 100 * rtol:
                raise PhaseFailure(
                    f"four-card CG vs one-card CG: status {status!r}, x differs by {x_diff:.3e}"
                )
            return dict(
                form="bwd", kid=None, kernel="dist_cg_bwd_halo", plan_s=0.0,
                first_call_s=first, steady_s=steady, iters=iters,
                iters_one_card=int(rinfo[30]), residual=float(res),
                residual_one_card=float(res1), x_diff_vs_one_card=x_diff,
                err=float(max(res, res1)), tol=RESIDUAL_SLACK * rtol,
            )

        self._run("dist_spmv_bwd_halo", spmv, **ident)
        self._run("dist_cg_bwd_halo", cg, **ident)


def _timed(fn) -> float:
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def _positions(ptr, ind, rows, cols):
    """Flat positions of (rows, cols) inside a sorted CSR pattern."""
    ptr = np.asarray(ptr, np.int64)
    key = np.repeat(np.arange(ptr.size - 1, dtype=np.int64), np.diff(ptr)) * (
        int(ind.max()) + 1 if ind.size else 1
    ) + ind
    want = rows.astype(np.int64) * (int(ind.max()) + 1 if ind.size else 1) + cols
    pos = np.searchsorted(key, want)
    if ind.size and not np.array_equal(key[np.minimum(pos, key.size - 1)], want):
        raise PhaseFailure("reference entry outside the computed pattern")
    return pos


def _native_ok() -> bool:
    from aoclsparse_tpu import native

    return native.available()


def load_matrices(names, boost):
    """Generate the named stand-ins (seeded, published sizes)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from benchmarks.realmat import generate

    return {nm: generate(nm, diag_boost=boost) for nm in names}


def run_one_card(smoke: Smoke, mats) -> None:
    pwtk, web = mats["pwtk"], mats["webbase-1M"]
    for dt in (np.float64, np.float32):
        smoke.mv("pwtk", pwtk, dt)
        smoke.mv("webbase-1M", web, dt)
    # form comparison on the FEM band: planner default vs the XLA band forms
    for dt in (np.float32, np.float64):
        smoke.mv("pwtk", pwtk, dt, kind="bwd")
        smoke.mv("pwtk", pwtk, dt, kind="diag")
    for dt in (np.float32, np.float64):
        smoke.mm("pwtk", pwtk, dt)
    smoke.trsv("pwtk", pwtk)
    smoke.sp2m("cant", mats["cant"])
    smoke.itsol("pwtk", pwtk, "cg", "SGS")
    smoke.itsol("scircuit", mats["scircuit"], "gmres", "ILU0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed phases on a 4-GPU mesh")
    args = ap.parse_args(argv)
    ndev = 4 if args.four else 1

    import jax

    devs = require_gpu(ndev)
    from aoclsparse_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smoke = Smoke()
    from aoclsparse_tpu.utils.profiling import gpu_cards

    for line in gpu_cards():
        print(line, flush=True)
    native = _native_ok()
    print(json.dumps({"native_host_library": native}), flush=True)
    if not native:
        print("chip_smoke: the native host library did not load", file=sys.stderr)
        return 1
    if args.four:
        mats = load_matrices(["pwtk"], DIAG_BOOST)
        smoke.dist("pwtk", mats["pwtk"], ndev)
    else:
        mats = load_matrices(["pwtk", "webbase-1M", "cant", "scircuit"], DIAG_BOOST)
        run_one_card(smoke, mats)
    if smoke.failures:
        print(f"chip_smoke: failed phases: {smoke.failures}", file=sys.stderr)
        return 1
    d0 = devs[0]
    count = ndev if args.four else len(jax.devices())
    print(json.dumps({"ok": True, "device": {"platform": d0.platform, "kind": d0.device_kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
