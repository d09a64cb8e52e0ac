"""Tolerance framework mirroring the reference's model.

Reference: expected_precision = scale * safeguard * sqrt(2*eps)
(library/src/extra/aoclsparse_utils.hpp:493-498; safeguard 1.0 for double,
2.0 for float), and the bench-side near_check with scale 10 and up to 4x
relaxation (tests/include/aoclsparse_check.hpp:36-122).
"""

from __future__ import annotations

import numpy as np

__all__ = ["expected_precision", "is_near", "assert_allclose_spec", "MAX_TOL_MULTIPLIER"]

MAX_TOL_MULTIPLIER = 4


def _real_dtype(dtype):
    dt = np.dtype(dtype)
    if dt == np.complex64:
        return np.float32
    if dt == np.complex128:
        return np.float64
    return dt


def _safeguard(dtype) -> float:
    dt = _real_dtype(dtype)
    if dt == np.float64:
        return 1.0
    if dt == np.float32:
        return 2.0
    # low-precision dtypes (bf16/f16): scale safeguard with the wider eps
    return 4.0


def expected_precision(dtype, scale: float = 1.0) -> float:
    """scale * safeguard * sqrt(2 * eps) for the (real part of the) dtype."""
    dt = _real_dtype(dtype)
    eps = float(np.finfo(dt).eps)
    return scale * _safeguard(dtype) * float(np.sqrt(2.0 * eps))


def is_near(x, y, dtype=None, scale: float = 10.0, relax: int = MAX_TOL_MULTIPLIER) -> bool:
    """Bench-style permissive check (aoclsparse_check.hpp:36-122): absolute or
    relative error within expected_precision(scale), with <= relax multiplier."""
    x = np.asarray(x)
    y = np.asarray(y)
    dt = dtype if dtype is not None else y.dtype
    tol = expected_precision(dt, scale)
    err = np.abs(x - y)
    denom = np.maximum(np.abs(y), 1.0)
    return bool(np.all(err <= relax * tol * denom))


def assert_allclose_spec(actual, expected, dtype=None, scale: float = 1.0, err_msg=""):
    """Unit-test-style check: EXPECT_ARR_NEAR with expected_precision(scale),
    absolute-or-relative per element."""
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    dt = dtype if dtype is not None else expected.dtype
    tol = expected_precision(dt, scale)
    err = np.abs(actual - expected)
    denom = np.maximum(np.abs(expected), 1.0)
    bad = err > tol * denom
    if np.any(bad):
        idx = np.argwhere(bad)[:8]
        details = ", ".join(
            f"[{tuple(i)}] got {actual[tuple(i)]} want {expected[tuple(i)]}" for i in idx
        )
        raise AssertionError(
            f"{err_msg} mismatch > {tol:g} ({int(bad.sum())}/{bad.size} elements): {details}"
        )
