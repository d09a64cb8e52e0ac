#!/usr/bin/env python
"""Headline benchmark: CSR SpMV through the public API on one GPU.

Methodology is the reference's (BASELINE.md): GFLOP/s = 2*nnz/t
(tests/include/aoclsparse_flops.hpp:40-44), effective GB/s from the csrmv
byte formula (aoclsparse_gbyte.hpp:41-47) — *useful* bytes, so any padding
of the execution form counts against us. vs_baseline = effective GB/s /
(0.80 * the device's published memory bandwidth, core/context.py PEAKS).

Operand: cant-like FEM band profile (m=262144, 64 nnz/row, halfband 64 —
the SuiteSparse cant/consph shape class, BASELINE.md), float32, seeded.

Timing: ``asp.mv`` end to end, each call ended by ``block_until_ready``,
median over REPS calls after warm-up; the first call (compile + planning
already done by ``optimize``) is reported separately.

Exits non-zero without a result when JAX's default device is not a GPU.
Prints ONE JSON line.
"""

import json
import sys
import time

import numpy as np

REPS = 200


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX's default device is {dev.platform!r}; a GPU is required",
              file=sys.stderr)
        return 1
    from aoclsparse_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    import aoclsparse_tpu as asp
    from aoclsparse_tpu import MatrixDescriptor, Operation
    from aoclsparse_tpu.core.context import get_context
    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.utils.profiling import gpu_cards, spmv_bytes, spmv_flops

    ctx = get_context()
    dtype = np.float32
    m = n = 262144
    row_nnz = 64
    half_bw = 64
    rng = np.random.default_rng(7)
    win = 2 * half_bw
    base = np.clip(np.arange(m) - half_bw, 0, n - win)
    pick = np.argsort(rng.random((m, win)), axis=1)[:, :row_nnz]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1, dtype=np.int64) * row_nnz
    val = rng.standard_normal(m * row_nnz).astype(dtype)
    nnz = m * row_nnz
    x = jnp.asarray(rng.standard_normal(n).astype(dtype))

    GEN = MatrixDescriptor()
    t0 = time.perf_counter()
    A = asp.create_csr(m, n, ptr, cols.reshape(-1).astype(np.int32), val)
    asp.set_mv_hint(A, Operation.none, GEN, nop=1000)
    asp.optimize(A)
    plan_s = time.perf_counter() - t0
    form = get_plan(A).exec_form_for(GEN, Operation.none, dtype=A.dtype)
    kid = asp.debug_dispatcher("mv", fmt=form.kind)["kid"]

    def call():
        return asp.mv(1.0, A, GEN, Operation.none, x, 0.0)

    t0 = time.perf_counter()
    jax.block_until_ready(call())
    first_s = time.perf_counter() - t0
    for _ in range(10):
        jax.block_until_ready(call())
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    gbs = spmv_bytes(m, n, nnz, np.dtype(dtype).itemsize) / t / 1e9
    peak = ctx.peaks.hbm_gbps
    rec = {
        "metric": "spmv_csr_gbs_eff",
        "value": gbs,
        "unit": "GB/s",
        "vs_baseline": gbs / (0.80 * peak),
        "extra": {
            "gflops": spmv_flops(nnz) / t / 1e9,
            "t_median_us": t * 1e6,
            "t_min_us": float(np.min(ts)) * 1e6,
            "reps": REPS,
            "first_call_s": first_s,
            "plan_s": plan_s,
            "exec_form": form.kind,
            "kid": kid,
            "m": m,
            "nnz": nnz,
            "dtype": np.dtype(dtype).name,
            "peak_gbps": peak,
            "peak_source": ctx.peaks.source,
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
                "cards": gpu_cards(),
            },
        },
    }
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
