"""Double-precision band SpMV: the XLA banded-window form (mv KID 5) in
native float64, the reference's benchmark precision (csrmv.sh:88-92 runs
doubles). The removed double-float kernel (KID 13) raises invalid_kid.

Accuracy model: f64 working precision — far below f32's 2^-24 and inside the
reference's own f64 test tolerance (expected_precision = scale*sqrt(2*eps_f64)
~ 2.1e-8*scale, aoclsparse_utils.hpp:493-498). These tests pin both: the f64
error must beat f32 by orders of magnitude AND land within ~1e-11 relative.
"""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.core.types import AoclSparseError, Status

GEN = MatrixDescriptor()


def _band_csr(rng, m=512, half_bw=10, row_nnz=8, dtype=np.float64, outliers=0):
    """Random banded CSR with full f64-precision values (mantissas the f32
    path must drop)."""
    n = m
    win = 2 * half_bw
    base = np.clip(np.arange(m) - half_bw, 0, n - win)
    pick = np.argsort(rng.random((m, win)), axis=1)[:, :row_nnz]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1, dtype=np.int64) * row_nnz
    cols = cols.reshape(-1).astype(np.int32)
    if outliers:
        # scatter a few far-off-band entries (planner peel -> spill path)
        rows_o = rng.integers(0, m // 2, outliers)
        for r in rows_o:
            cols[r * row_nnz] = n - 1 - int(rng.integers(0, 8))
    # re-sort within rows after the outlier pokes
    cols2 = cols.reshape(m, row_nnz)
    cols2 = np.sort(cols2, axis=1)
    # dedup guard: bump equal neighbors apart (keeps the fixture simple)
    for i in range(m):
        for j in range(1, row_nnz):
            if cols2[i, j] <= cols2[i, j - 1]:
                cols2[i, j] = cols2[i, j - 1] + 1
    cols = np.minimum(cols2, n - 1).reshape(-1).astype(np.int32)
    val = rng.standard_normal(m * row_nnz).astype(dtype)
    val *= 1.0 + 1e-10 * rng.standard_normal(m * row_nnz)  # sub-f32 mantissa bits
    dense = np.zeros((m, n), dtype=np.float64)
    dense[np.repeat(np.arange(m), row_nnz), cols] = val
    return ast.create_csr(m, n, ptr, cols, val), dense


def _relerr(got, want):
    scale = np.max(np.abs(want)) + 1e-300
    return np.max(np.abs(np.asarray(got) - want)) / scale


def test_df64_band_accuracy(rng):
    A, dense = _band_csr(rng, m=512, half_bw=10, row_nnz=8)
    x = rng.standard_normal(512) * (1.0 + 1e-10 * rng.standard_normal(512))
    want = dense @ x
    got_df = ast.mv(1.0, A, GEN, Operation.none, x, 0.0, None, kid=5)
    assert np.asarray(got_df).dtype == np.float64
    err_df = _relerr(got_df, want)
    # f32 comparator: same product at f32 working precision
    got_f32 = dense.astype(np.float32) @ x.astype(np.float32)
    err_f32 = _relerr(got_f32, want)
    assert err_df < 1e-11
    assert err_df < err_f32 / 1e3  # orders of magnitude beyond f32


def test_df64_needs_float64_operand(rng):
    A, _ = _band_csr(rng, m=128, half_bw=6, row_nnz=4, dtype=np.float32)
    x = rng.standard_normal(128).astype(np.float32)
    with pytest.raises(AoclSparseError) as e:
        ast.mv(1.0, A, GEN, Operation.none, x, 0.0, None, kid=13)
    assert e.value.status == Status.invalid_kid  # removed kernel


def test_df64_spill_path(rng):
    # outliers force the planner's peel spill: f64 spill segment-sum
    # alongside the f64 band
    A, dense = _band_csr(rng, m=1024, half_bw=8, row_nnz=6, outliers=5)
    x = rng.standard_normal(1024)
    want = dense @ x
    got = ast.mv(1.0, A, GEN, Operation.none, x, 0.0, None, kid=5)
    assert _relerr(got, want) < 1e-11


def test_df64_alpha_beta_epilogue(rng):
    A, dense = _band_csr(rng, m=256, half_bw=6, row_nnz=4)
    x = rng.standard_normal(256)
    y = rng.standard_normal(256)
    got = ast.mv(1.25, A, GEN, Operation.none, x, -0.5, y, kid=5)
    want = 1.25 * (dense @ x) - 0.5 * y
    assert _relerr(got, want) < 1e-11


def test_df64_update_values_refresh(rng):
    A, dense = _band_csr(rng, m=256, half_bw=6, row_nnz=4)
    x = rng.standard_normal(256)
    y1 = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, None, kid=5))
    # bulk value replacement must flow through the cached band
    m, n, nnz, ptr, ind, val = ast.export_csr(A)
    new_val = val * 3.0 + 1e-9
    ast.update_values(A, new_val)
    dense2 = np.zeros_like(dense)
    dense2[np.repeat(np.arange(m), np.diff(ptr)), ind] = new_val
    y2 = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, None, kid=5))
    assert _relerr(y2, dense2 @ x) < 1e-11
    assert not np.allclose(y1, y2)


def test_df64_autoroute_on_f64_bandt_pin(rng):
    # autotune_mv pinning the band form on an f64 matrix routes the default
    # (kid=None) dispatch through it at full f64 accuracy
    from aoclsparse_tpu.kernels.autotune import autotune_mv

    A, dense = _band_csr(rng, m=256, half_bw=6, row_nnz=4)
    res = autotune_mv(A, iters=1, chunks=1, kinds=("bwd",))
    assert "bwd" in res
    x = rng.standard_normal(256)
    got = ast.mv(1.0, A, GEN, Operation.none, x, 0.0, None)  # default dispatch
    assert _relerr(got, dense @ x) < 1e-11


def test_df64_split_exactness():
    # an f64 value split into two f32 halves (hi, lo) reconstructs to
    # within 2^-45 relative: the precision bound any paired-f32 scheme has
    rng = np.random.default_rng(3)
    v = rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
    vh = v.astype(np.float32).astype(np.float64)
    vl = (v - vh).astype(np.float32).astype(np.float64)
    rel = np.abs((vh + vl) - v) / np.abs(v)
    assert rel.max() < 2.0**-45
