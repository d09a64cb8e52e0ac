#!/usr/bin/env python
"""aoclsparse-bench-style CLI driver (reference:
tests/benchmarks/aoclsparse_test.cpp + testing_*.hpp).

Examples:
    python benchmarks/cli.py --function=csrmv --m=100000 --nnz-per-row=32 \
        --half-bw=64 --iters=50 --verify=1
    python benchmarks/cli.py --function=trsv --m=65536 --precision=s
    python benchmarks/cli.py --function=csrmm --k=64
    python benchmarks/cli.py --function=csr2m --m=20000
    python benchmarks/cli.py --function=ilu0 --m=20000
    python benchmarks/cli.py --function=csrmv --mtx=path/to/matrix.mtx

Prints one JSON line per run with GFLOP/s and effective GB/s per the
reference's formulas (aoclsparse_flops.hpp / aoclsparse_gbyte.hpp) and a
verify result against the scalar oracle when --verify=1.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

try:
    _here = os.path.dirname(os.path.abspath(__file__))
except NameError:  # exec'd without __file__
    _here = os.path.join(os.getcwd(), "benchmarks")
sys.path.insert(0, os.path.join(_here, ".."))

PRECISIONS = {"s": np.float32, "d": np.float64, "c": np.complex64, "z": np.complex128}


def banded_csr(rng, m, n, half_bw, row_nnz, dtype):
    win = max(2 * half_bw, row_nnz + 1)
    base = np.clip(np.arange(m) - half_bw, 0, max(n - win, 0))
    pick = np.argsort(rng.random((m, win)), axis=1)[:, : row_nnz - 1]
    cols = np.concatenate([base[:, None] + pick, np.minimum(np.arange(m), n - 1)[:, None]], 1)
    cols = np.sort(cols, axis=1)
    dup = np.concatenate([np.zeros((m, 1), bool), cols[:, 1:] == cols[:, :-1]], axis=1)
    cols[dup] += 1
    cols = np.sort(np.clip(cols, 0, n - 1), axis=1)
    ptr = np.arange(m + 1, dtype=np.int64) * cols.shape[1]
    val = rng.standard_normal(cols.size)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        val = val + 1j * rng.standard_normal(cols.size)
    val = val.astype(dtype)
    isdiag = (cols == np.arange(m)[:, None]).reshape(-1)
    val[isdiag] = row_nnz  # diagonally dominant for solves
    return ptr, cols.reshape(-1).astype(np.int32), val


def chain_min(run, iters, chunks=4):
    import jax

    y = run()
    jax.block_until_ready(y)
    np.asarray(np.ravel(np.asarray(y))[:1])
    per = max(1, iters // chunks)
    best = float("inf")
    for _ in range(chunks):
        t0 = time.perf_counter()
        for _ in range(per):
            y = run()
        np.asarray(np.ravel(np.asarray(y))[:1])
        best = min(best, (time.perf_counter() - t0) / per)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--function", default="csrmv",
                    choices=["csrmv", "csrmm", "trsv", "csr2m", "ilu0", "cg", "gmres"])
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--k", type=int, default=64, help="dense RHS columns (csrmm)")
    ap.add_argument("--nnz-per-row", type=int, default=32)
    ap.add_argument("--half-bw", type=int, default=64)
    ap.add_argument("--precision", default="s", choices=list(PRECISIONS))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--verify", type=int, default=0)
    ap.add_argument("--mtx", default=None, help="MatrixMarket input instead of generator")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=0.0)
    args = ap.parse_args()

    import jax

    from aoclsparse_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if PRECISIONS[args.precision] in (np.float64, np.complex128):
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import aoclsparse_tpu as ast
    from aoclsparse_tpu import MatrixDescriptor, MatrixType, Operation
    from aoclsparse_tpu.utils import profiling as prof
    from aoclsparse_tpu.utils.reference import ref_mm, ref_mv, ref_trsv

    dtype = PRECISIONS[args.precision]
    rng = np.random.default_rng(7)
    if args.mtx:
        A = ast.io.read_mtx(args.mtx, dtype=dtype) if hasattr(ast, "io") else None
        from aoclsparse_tpu.io import read_mtx

        A = read_mtx(args.mtx, dtype=dtype)
        m, n, nnz, ptr, ind, val = ast.export_csr(A)
    else:
        m = args.m
        n = args.n or m
        ptr, ind, val = banded_csr(rng, m, n, args.half_bw, args.nnz_per_row, dtype)
        A = ast.create_csr(m, n, ptr, ind, val)
        nnz = ind.size
    out = {"function": args.function, "m": m, "n": n, "nnz": int(nnz),
           "precision": args.precision}
    vsize = np.dtype(dtype).itemsize
    GEN = MatrixDescriptor()

    if args.function == "csrmv":
        x = jnp.asarray(rng.standard_normal(n).astype(dtype))
        from aoclsparse_tpu.ops.level2.mv import _run_exec_form
        from aoclsparse_tpu.planner.plan import get_plan

        form = get_plan(A).exec_form_for(GEN, Operation.none)
        t = chain_min(lambda: _run_exec_form(form, x, None), args.iters)
        out["exec_form"] = form.kind
        out["gflops"] = round(prof.spmv_flops(nnz) / t / 1e9, 3)
        out["gbs"] = round(prof.spmv_bytes(m, n, nnz, vsize) / t / 1e9, 3)
        out["t_us"] = round(t * 1e6, 1)
        if args.verify:
            got = np.asarray(_run_exec_form(form, x, None))
            want = ref_mv(1.0, m, n, ptr, ind, val, GEN, Operation.none, np.asarray(x), 0.0,
                          np.zeros(m, dtype))
            out["verified"] = bool(np.allclose(got, want, rtol=1e-3, atol=1e-3))
    elif args.function == "csrmm":
        B = jnp.asarray(rng.standard_normal((n, args.k)).astype(dtype))
        t = chain_min(lambda: ast.mm(1.0, A, GEN, Operation.none, B, 0.0), max(4, args.iters // 8))
        out["gflops"] = round(prof.csrmm_flops(nnz, args.k) / t / 1e9, 3)
        out["t_ms"] = round(t * 1e3, 3)
        if args.verify:
            got = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0))
            want = ref_mm(1.0, m, n, ptr, ind, val, GEN, Operation.none, np.asarray(B), 0.0,
                          np.zeros((m, args.k), dtype))
            out["verified"] = bool(np.allclose(got, want, rtol=1e-3, atol=1e-3))
    elif args.function == "trsv":
        descr = MatrixDescriptor(type=MatrixType.triangular)
        b = jnp.asarray(rng.standard_normal(m).astype(dtype))
        t = chain_min(lambda: ast.trsv(1.0, A, descr, Operation.none, b), max(4, args.iters // 8))
        tri_nnz = int(np.sum(ind <= np.repeat(np.arange(m), np.diff(np.asarray(ptr)))))
        out["gflops"] = round(prof.trsv_flops(tri_nnz, m) / t / 1e9, 3)
        out["t_ms"] = round(t * 1e3, 3)
        if args.verify:
            got = np.asarray(ast.trsv(1.0, A, descr, Operation.none, b))
            want = ref_trsv(1.0, m, ptr, ind, val, descr, Operation.none, np.asarray(b))
            out["verified"] = bool(np.allclose(got, want, rtol=1e-3, atol=1e-3))
    elif args.function == "csr2m":
        t0 = time.perf_counter()
        C = ast.sp2m(Operation.none, GEN, A, Operation.none, GEN, A)
        np.asarray(np.ravel(np.asarray(C.data.val))[:1])
        t = time.perf_counter() - t0
        pl_ = C._spgemm_plan
        P = int(pl_.P) if pl_.P else int(np.asarray(pl_.pa).shape[0])
        out["gflops"] = round(prof.spgemm_flops(P) / t / 1e9, 3)
        out["nnzC"] = C.nnz
        out["t_s"] = round(t, 3)
    elif args.function == "ilu0":
        t0 = time.perf_counter()
        ast.ilu0_factorize(A)
        t = time.perf_counter() - t0
        out["gbs"] = round(prof.ilu0_bytes(m, nnz, vsize) / t / 1e9, 4)
        out["t_s"] = round(t, 3)
    elif args.function in ("cg", "gmres"):
        h = ast.itsol_init(dtype)
        ast.itsol_option_set(h, "iterative method", args.function)
        b = rng.standard_normal(m).astype(dtype)
        # CG needs SPD: run on the symmetric view of the (diag-dominant)
        # lower triangle; GMRES takes the general matrix
        descr = (
            MatrixDescriptor(type=MatrixType.symmetric)
            if args.function == "cg"
            else GEN
        )
        t0 = time.perf_counter()
        x, rinfo, status = ast.itsol_solve(h, m, A, descr, b)
        t = time.perf_counter() - t0
        out["iters"] = int(rinfo[30])
        out["res_norm"] = float(rinfo[0])
        out["status"] = int(status)
        out["t_s"] = round(t, 3)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
