"""Tracing/profiling + roofline accounting.

The reference has no in-library tracing (SURVEY.md §5.1) — timing lives in
its bench harness (aoclsparse_clock, testing_csrmv.hpp:79-92) with FLOP/byte
formulas (aoclsparse_flops.hpp / aoclsparse_gbyte.hpp) and two-sample t-test
comparison (tools/twosampletest.py). This module is the JAX equivalent: JAX
profiler trace capture, per-op FLOP/byte counts matching the reference's
formulas, roofline accounting against the device's published memory peak
(core/context.py PEAKS), and the statistical comparison utilities.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.context import get_context

__all__ = [
    "spmv_flops",
    "spmv_bytes",
    "trsv_flops",
    "csrmm_flops",
    "spgemm_flops",
    "ilu0_bytes",
    "roofline",
    "BenchResult",
    "chain_bench",
    "trace",
    "two_sample_t",
]


# -- FLOP / byte formulas (aoclsparse_flops.hpp:40-..., aoclsparse_gbyte.hpp) --


def spmv_flops(nnz: int, m: int = 0, beta_nonzero: bool = False) -> float:
    """2*nnz (+2m if beta) — spmv_gflop_count (aoclsparse_flops.hpp:40-44)."""
    return 2.0 * nnz + (2.0 * m if beta_nonzero else 0.0)


def spmv_bytes(m: int, n: int, nnz: int, val_size: int, idx_size: int = 4, beta_nonzero=False):
    """csrmv_gbyte_count (aoclsparse_gbyte.hpp:41-47)."""
    reads = (m + 1 + nnz) * idx_size + (nnz + n + m * (1 if beta_nonzero else 0)) * val_size
    writes = m * val_size
    return reads + writes


def trsv_flops(nnz: int, m: int, unit_diag: bool = False) -> float:
    """2*nnz - m non-unit (aoclsparse_flops.hpp:46-55)."""
    return 2.0 * nnz - (0 if unit_diag else m)


def csrmm_flops(nnz_a: int, k: int, nnz_c: int = 0, beta_nonzero: bool = False) -> float:
    """csrmm_gflop_count (aoclsparse_flops.hpp:64-73)."""
    return 2.0 * nnz_a * k + (2.0 * nnz_c if beta_nonzero else 0.0)


def spgemm_flops(visited_products: int) -> float:
    """csr2m_gflop_count: 2 * visited products (aoclsparse_flops.hpp:74-...)."""
    return 2.0 * visited_products


def ilu0_bytes(m: int, nnz: int, val_size: int, idx_size: int = 4) -> float:
    """csrilu0_gbyte_count (aoclsparse_gbyte.hpp:121-...)."""
    return (m + 1 + nnz) * idx_size + 2.0 * nnz * val_size


def roofline(bytes_moved: float, seconds: float, frac: float = 1.0) -> Dict[str, float]:
    """Achieved vs the published peak memory bandwidth of the current device
    (core/context.py PEAKS). Raises AoclSparseError for a device without
    published peaks: a roofline share needs a real peak."""
    hbm = get_context().peaks.hbm_gbps
    achieved = bytes_moved / seconds / 1e9
    peak = hbm * frac
    return {
        "achieved_gbps": achieved,
        "peak_gbps": hbm,
        "fraction_of_peak": achieved / hbm,
        "fraction_of_target": achieved / peak if peak else math.inf,
    }


def gpu_cards() -> List[str]:
    """One line per GPU, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it (e.g. "NVIDIA H100 80GB HBM3, 700.00 W").
    A card set below its maximum power limit cannot hold its published
    peaks, so every measurement names the limit beside its numbers. Runs
    nvidia-smi as a child process, which leaves the card to the caller."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


# -- timing -------------------------------------------------------------------


@dataclasses.dataclass
class BenchResult:
    name: str
    iters: int
    t_mean: float
    t_median: float
    t_min: float
    times: List[float]

    def gflops(self, flops: float) -> float:
        return flops / self.t_median / 1e9

    def gbytes(self, nbytes: float) -> float:
        return nbytes / self.t_median / 1e9


def chain_bench(run, name: str = "op", iters: int = 50, chunks: int = 5) -> BenchResult:
    """Time `run()` with chained dispatch + one sync per chunk, to amortize
    the device-sync latency."""
    import jax

    y = run()
    jax.block_until_ready(y)
    np.asarray(np.ravel(np.asarray(y))[:1])
    per_chunk = max(1, iters // chunks)
    times = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        for _ in range(per_chunk):
            y = run()
        np.asarray(np.ravel(np.asarray(y))[:1])
        times.append((time.perf_counter() - t0) / per_chunk)
    return BenchResult(
        name=name,
        iters=per_chunk * chunks,
        t_mean=float(np.mean(times)),
        t_median=float(np.median(times)),
        t_min=float(np.min(times)),
        times=times,
    )


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """JAX profiler trace capture (XPlane), viewable in TensorBoard/xprof —
    the replacement for the reference's wall-clock-only harness."""
    import jax

    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def two_sample_t(a, b) -> Dict[str, float]:
    """Welch's two-sample t statistic for comparing two timing runs
    (tools/twosampletest.py / aoclsparse_stats.cpp analog)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    na, nb = a.size, b.size
    va, vb = a.var(ddof=1), b.var(ddof=1)
    se = math.sqrt(va / na + vb / nb)
    t = (a.mean() - b.mean()) / se if se else 0.0
    # Welch-Satterthwaite dof
    dof = (
        (va / na + vb / nb) ** 2 / ((va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1))
        if se
        else na + nb - 2
    )
    return {"t": float(t), "dof": float(dof), "mean_a": float(a.mean()), "mean_b": float(b.mean())}
