"""Numerical-debug modes — the analog of the reference's sanitizer builds
(SURVEY.md §5.2: ASAN/Valgrind CMake options; no TSAN). Memory safety is
XLA's problem here; what a sparse framework needs instead is (a) NaN/Inf
trapping inside jitted code and (b) bitwise-deterministic reductions for
run-to-run comparison."""

from __future__ import annotations

import contextlib

import jax

__all__ = ["nan_checks", "deterministic_mode", "enable_nan_checks"]


def enable_nan_checks(on: bool = True) -> None:
    """Global NaN/Inf trap: jitted programs re-run op-by-op on failure and
    raise at the producing primitive (jax debug_nans)."""
    jax.config.update("jax_debug_nans", bool(on))


@contextlib.contextmanager
def nan_checks():
    """Scoped NaN/Inf trapping."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextlib.contextmanager
def deterministic_mode():
    """Bitwise-reproducible reductions (disables nondeterministic XLA
    scatter/reduction paths) for run-to-run comparisons of segment-sum-based
    kernels."""
    import os

    prev = os.environ.get("XLA_FLAGS", "")
    if "--xla_gpu_deterministic_ops" not in prev:
        # the flag matters for the gather/scatter kernels' atomics on GPU
        # and for fast-math reassociation on CPU.
        os.environ["XLA_FLAGS"] = (prev + " --xla_cpu_enable_fast_math=false").strip()
    try:
        yield
    finally:
        os.environ["XLA_FLAGS"] = prev
