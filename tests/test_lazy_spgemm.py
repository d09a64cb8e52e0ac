"""Lazy band-product values (ROADMAP round-3): a SpGEMM result computed on
the band engine defers the CSR extraction gather until CSR values are actually read; chained mv/sp2m consumption runs on the
seeded device band and never pays it. Reference role: consuming a product
through the optimized-format cache (level2/aoclsparse_mv.cpp:179)."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.core.types import Request


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _force_band_lazy(monkeypatch):
    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")
    monkeypatch.setenv("AOCLSPARSE_TPU_LAZY_SPGEMM", "1")


def _band(rng, m, half=6, per=4):
    base = np.clip(np.arange(m) - half, 0, m - 2 * half)
    pick = np.argsort(rng.random((m, 2 * half)), axis=1)[:, :per]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1) * per
    val = rng.standard_normal(m * per)
    dense = np.zeros((m, m))
    dense[np.repeat(np.arange(m), per), cols.reshape(-1)] = val
    return ast.create_csr(m, m, ptr, cols.reshape(-1), val), dense


def _dense_of(C):
    m, n, _, ptr, ind, val = ast.export_csr(C)
    out = np.zeros((m, n))
    out[np.repeat(np.arange(m), np.diff(ptr)), np.asarray(ind)] = np.asarray(val)
    return out


def test_full_computation_defers_extraction(rng):
    A, dA = _band(rng, 192)
    B, dB = _band(rng, 192)
    C = ast.spmm(A, B)
    if C._spgemm_plan.band is None:
        pytest.skip("band engine not attachable for this structure")
    assert C.values_pending
    # structure metadata answers without materializing
    assert C.shape == (192, 192) and C.nnz > 0 and C.dtype == np.float64
    assert C.values_pending
    # chained mv runs on the seeded band and leaves the extraction pending
    x = rng.standard_normal(192)
    y = ast.mv(1.0, C, MatrixDescriptor(), Operation.none, x, 0.0)
    np.testing.assert_allclose(np.asarray(y), dA @ dB @ x, atol=1e-8)
    assert C.values_pending
    # reading CSR values materializes exactly the product
    got = _dense_of(C)
    assert not C.values_pending
    np.testing.assert_allclose(got, dA @ dB, atol=1e-8)


def test_finalize_lazy_and_refinalize(rng):
    A, dA = _band(rng, 160)
    B, dB = _band(rng, 160)
    d = MatrixDescriptor()
    C = ast.sp2m(Operation.none, d, A, Operation.none, d, B, request=Request.nnz_count)
    if C._spgemm_plan.band is None:
        pytest.skip("band engine not attachable for this structure")
    C = ast.sp2m(Operation.none, d, A, Operation.none, d, B, request=Request.finalize, C=C)
    assert C.values_pending
    np.testing.assert_allclose(_dense_of(C), dA @ dB, atol=1e-8)
    # serving loop: update operand values, re-finalize, still correct
    m, n, _, ptr, ind, val = ast.export_csr(A)
    ast.update_values(A, np.asarray(val) * 2)
    C = ast.sp2m(Operation.none, d, A, Operation.none, d, B, request=Request.finalize, C=C)
    assert C.values_pending
    np.testing.assert_allclose(_dense_of(C), 2 * dA @ dB, atol=1e-8)


def test_chained_spgemm_consumes_pending_seed(rng):
    """A lazy product used as a sp2m operand: the seed certifies freshness
    while pending, so the chained product needs no extraction of C1."""
    A, dA = _band(rng, 160)
    C1 = ast.spmm(A, A)
    if C1._spgemm_plan.band is None:
        pytest.skip("band engine not attachable for this structure")
    assert C1.values_pending
    C2 = ast.spmm(C1, A)
    np.testing.assert_allclose(_dense_of(C2), dA @ dA @ dA, atol=1e-8)


def test_update_values_on_pending_skips_extraction(rng):
    A, dA = _band(rng, 128)
    C = ast.spmm(A, A)
    if C._spgemm_plan.band is None:
        pytest.skip("band engine not attachable for this structure")
    assert C.values_pending
    nnz = C.nnz
    new = np.arange(1.0, nnz + 1.0)
    ast.update_values(C, new)
    assert not C.values_pending
    m, n, _, ptr, ind, val = ast.export_csr(C)
    np.testing.assert_allclose(np.asarray(val), new)
    # the stale seed must NOT serve mv anymore
    x = rng.standard_normal(128)
    dense = np.zeros((m, n))
    dense[np.repeat(np.arange(m), np.diff(ptr)), np.asarray(ind)] = new
    y = ast.mv(1.0, C, MatrixDescriptor(), Operation.none, x, 0.0)
    np.testing.assert_allclose(np.asarray(y), dense @ x, atol=1e-8)


def test_transpose_mv_materializes(rng):
    A, dA = _band(rng, 128)
    C = ast.spmm(A, A)
    if C._spgemm_plan.band is None:
        pytest.skip("band engine not attachable for this structure")
    x = rng.standard_normal(128)
    yt = ast.mv(1.0, C, MatrixDescriptor(), Operation.transpose, x, 0.0)
    np.testing.assert_allclose(np.asarray(yt), (dA @ dA).T @ x, atol=1e-8)
    assert not C.values_pending  # transpose needs the plan -> materialized
