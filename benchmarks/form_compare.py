#!/usr/bin/env python
"""Compare the SpMV execution forms on one GPU: the planner's default gather
form (ell, KID 1) against the dense band forms bwd (KID 5) and diag (KID 6).

    python benchmarks/form_compare.py [--matrix pwtk] [--chain 50] [--reps 5]

The operand is the seeded stand-in from ``benchmarks/realmat.py`` with the
diagonal boost ``chip_smoke.py`` uses. For each dtype (float32, float64) and
form it prints one JSON line with

- ``device_us``: device time per application. CHAIN applications
  ``x <- s * A x`` run chained in one compiled program (the form's arrays
  passed as arguments, not baked in), median over REPS runs, divided by
  CHAIN;
- ``roofline``: useful csrmv bytes (utils/profiling.spmv_bytes) per
  ``device_us`` against the card's published bandwidth (core/context.py
  PEAKS);
- ``e2e_us``: median time of one ``asp.mv`` call through the public API,
  ended by ``block_until_ready``;
- ``agree``: the chained result's max relative error against the ell
  form's, under the dtype's product tolerance.

A last line gives the host floor: ``asp.mv`` on an 8 x 8 tridiagonal matrix.
The card's name and power limit are printed first. Exits non-zero when JAX's
default device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("ell", "diag", "bwd")


def _median_s(fn, reps: int) -> float:
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def chained(form, x0, chain: int, scale: float):
    """A no-argument callable running `chain` applications x <- scale * A x
    of `form` in one compiled program; the form's arrays are arguments."""
    import jax
    import jax.numpy as jnp

    from aoclsparse_tpu.ops.level2.mv import _run_exec_form

    def run(x):
        return jax.lax.fori_loop(
            0, chain, lambda _, v: scale * _run_exec_form(form, v, None), x
        )

    closed = jax.make_jaxpr(run)(x0)
    consts = [jnp.asarray(c) for c in closed.consts]
    prog = jax.jit(lambda x, *cs: jax.core.eval_jaxpr(closed.jaxpr, list(cs), x)[0])
    return lambda: prog(x0, *consts)


def compare_forms(mat, dtype, chain: int = 50, reps: int = 5, e2e_reps: int = 50,
                  kinds=KINDS, seed: int = 0):
    """One record per form: device time per chained application, end-to-end
    asp.mv time, and agreement of the chained result with the first form's."""
    import jax
    import jax.numpy as jnp

    import aoclsparse_tpu as asp
    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.utils.tolerances import expected_precision

    sys.path.insert(0, str(ROOT))
    from chip_smoke import max_rel_err

    GEN, NONE = asp.GENERAL, asp.Operation.none
    m, n, ptr, ind, val = mat
    dtype = np.dtype(dtype)
    v = np.asarray(val).astype(dtype)
    A = asp.create_csr(m, n, ptr, ind, v)
    asp.set_mv_hint(A, NONE, GEN, nop=1000)
    asp.optimize(A)
    # 1 / ||A||_inf keeps the chained iterate bounded
    scale = 1.0 / float(np.max(np.add.reduceat(np.abs(v), ptr[:-1])))
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(n).astype(dtype))
    recs, first = [], None
    for kind in kinds:
        kid = asp.debug_dispatcher("mv", fmt=kind)["kid"]
        form = get_plan(A).exec_form_for(GEN, NONE, kind=kind, dtype=A.dtype)
        run = chained(form, x, chain, scale)
        out = jax.block_until_ready(run())
        device_s = _median_s(run, reps) / chain
        call = lambda: asp.mv(1.0, A, GEN, NONE, x, 0.0, kid=kid)  # noqa: E731
        jax.block_until_ready(call())
        e2e_s = _median_s(call, e2e_reps)
        if first is None:
            first = out
        recs.append(dict(
            form=form.kind, kid=kid, dtype=dtype.name, rows=m, nnz=int(ptr[-1]),
            chain=chain, device_us=device_s * 1e6, e2e_us=e2e_s * 1e6,
            agree=max_rel_err(out, first), tol=expected_precision(dtype),
        ))
        del run, form
    return recs


def host_floor(reps: int = 200) -> float:
    """Median seconds of asp.mv on an 8 x 8 tridiagonal matrix."""
    import jax.numpy as jnp

    import aoclsparse_tpu as asp

    n = 8
    rows = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    order = np.lexsort((cols, rows))
    ptr = np.searchsorted(rows[order], np.arange(n + 1)).astype(np.int64)
    A = asp.create_csr(n, n, ptr, cols[order], np.ones(rows.size))
    asp.optimize(A)
    x = jnp.ones(n)
    call = lambda: asp.mv(1.0, A, asp.GENERAL, asp.Operation.none, x, 0.0)  # noqa: E731
    call()
    return _median_s(call, reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matrix", default="pwtk")
    ap.add_argument("--chain", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("form_compare: JAX's default device is not a GPU", file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(ROOT))
    from aoclsparse_tpu.utils.compile_cache import enable_compile_cache
    from aoclsparse_tpu.utils.profiling import gpu_cards, roofline, spmv_bytes
    from benchmarks.realmat import generate
    from chip_smoke import DIAG_BOOST

    enable_compile_cache()
    for line in gpu_cards():
        print(line, flush=True)
    mat = generate(args.matrix, diag_boost=DIAG_BOOST)
    m, n, ptr = mat[0], mat[1], mat[2]
    ok = True
    for dtype in (np.float32, np.float64):
        for rec in compare_forms(mat, dtype, args.chain, args.reps):
            nbytes = spmv_bytes(m, n, int(ptr[-1]), np.dtype(dtype).itemsize)
            rec["roofline"] = roofline(nbytes, rec["device_us"] * 1e-6)["fraction_of_peak"]
            rec["matrix"] = args.matrix
            ok &= rec["agree"] <= rec["tol"]
            print(json.dumps(rec), flush=True)
    print(json.dumps({"host_floor_us": host_floor() * 1e6}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
