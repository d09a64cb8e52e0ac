#!/usr/bin/env python
"""SpGEMM numeric engines side by side: band x band (scan of dense matmuls,
attached only with AOCLSPARSE_TPU_FORCE_BANDGEMM=1) vs the device product
expansion, on a 262144-row band with 8 nnz/row (~16.7M products). Prints one
JSON line per stage; times are host-clock seconds around synced calls."""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def emit(rec):
    print(json.dumps(rec), flush=True)


def main():
    import jax

    from aoclsparse_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    import aoclsparse_tpu as ast
    from aoclsparse_tpu import MatrixDescriptor, Operation
    from aoclsparse_tpu.ops.level3.spgemm import _effective, _symbolic, _attach_band_plan, _numeric, _numeric_auto
    from aoclsparse_tpu.kernels.xla.spgemm_band import band_gemm_values

    rng = np.random.default_rng(1)
    m = 262144
    half, row_nnz = 8, 8
    base = np.clip(np.arange(m) - half, 0, m - 2 * half)
    pick = np.argsort(rng.random((m, 2 * half)), axis=1)[:, :row_nnz]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1, dtype=np.int64) * row_nnz
    ind = cols.reshape(-1).astype(np.int32)
    val = rng.standard_normal(m * row_nnz).astype(np.float32)
    A = ast.create_csr(m, m, ptr, ind, val)
    G = MatrixDescriptor()
    eff = _effective(A, G, Operation.none)

    t0 = time.perf_counter()
    plan = _symbolic(eff, eff)
    t_sym = time.perf_counter() - t0
    P = int(plan.pa.shape[0])
    emit({"stage": "symbolic", "t_s": round(t_sym, 2), "P": P, "nnzC": plan.nnz})

    t0 = time.perf_counter()
    _attach_band_plan(plan, eff, eff)
    t_band_build = time.perf_counter() - t0
    emit(
        {
            "stage": "band_plan",
            "ok": plan.band is not None,
            "t_s": round(t_band_build, 2),
            "WA": None if plan.band is None else plan.band.WA,
            "WC": None if plan.band is None else plan.band.WC,
            "nstream": None if plan.band is None else plan.band.nstream,
        }
    )

    def sync(y):
        return np.asarray(jnp.ravel(y)[:1])

    # band numeric
    if plan.band is not None:
        y = band_gemm_values(plan.band, eff.val, eff.val)
        sync(y)
        t = float("inf")
        for c in range(6):
            t1 = time.perf_counter()
            for _ in range(5):
                y = band_gemm_values(plan.band, eff.val, eff.val)
            sync(y)
            t = min(t, (time.perf_counter() - t1) / 5)
        emit(
            {
                "stage": "numeric_band",
                "t_ms": round(t * 1e3, 2),
                "gprod_s": round(P / t / 1e9, 3),
            }
        )
        yband = np.asarray(y[:64])

    # expansion numeric
    y2 = _numeric(eff.val, eff.val, plan.pa, plan.pb, plan.pc, plan.nnz, False, False)
    sync(y2)
    t = float("inf")
    for c in range(4):
        t1 = time.perf_counter()
        for _ in range(3):
            y2 = _numeric(eff.val, eff.val, plan.pa, plan.pb, plan.pc, plan.nnz, False, False)
        sync(y2)
        t = min(t, (time.perf_counter() - t1) / 3)
    emit(
        {
            "stage": "numeric_expansion",
            "t_ms": round(t * 1e3, 2),
            "gprod_s": round(P / t / 1e9, 3),
        }
    )
    if plan.band is not None:
        err = float(np.max(np.abs(yband - np.asarray(y2[:64]))))
        emit({"stage": "crosscheck", "max_abs_diff_first64": err})


if __name__ == "__main__":
    main()
