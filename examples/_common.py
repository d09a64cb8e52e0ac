"""Shared boilerplate for the example programs.

Every example forces the CPU backend in-process (examples are didactic,
not benchmarks, and leave the GPU to measurement runs) and exposes a tiny check helper that prints PASS/FAIL like the reference samples
print their expected-vs-computed tables (tests/examples/README.md)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def check(name, got, want, tol=1e-10):
    got = np.asarray(got)
    want = np.asarray(want)
    ok = np.allclose(got, want, rtol=tol, atol=tol)
    print(f"{name}: {'PASS' if ok else 'FAIL'}")
    print("  computed:", np.round(got.reshape(-1)[:8], 6))
    print("  expected:", np.round(want.reshape(-1)[:8], 6))
    if not ok:
        sys.exit(1)
    return got
