"""Band execution forms through the full dispatch: the XLA banded-window
SpMV (mv KID 5, ``bwd``) and group-band SpMM (mm KID 3, ``bwdg``) — parity
with the dense oracle over band, peel spill, transpose, descriptors,
update_values refresh and mixed precision — plus the KIDs of the removed
band kernels, which must raise invalid_kid."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import AoclSparseError, MatrixDescriptor, Operation, Status
from aoclsparse_tpu.core.types import FillMode, MatrixType
from aoclsparse_tpu.planner.plan import get_plan

GEN = MatrixDescriptor()
BWD_KID = 5
BWDG_MM_KID = 3


def _band(rng, m, half, per_row=5, outliers=0):
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.clip(i + rng.integers(-half, half + 1, per_row), 0, m - 1)
        dense[i, js] = rng.standard_normal(js.size)
    if outliers:
        oi = rng.integers(0, m, outliers)
        oj = rng.integers(0, m, outliers)
        dense[oi, oj] = rng.standard_normal(outliers)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    ind = np.nonzero(dense)[1].astype(np.int32)
    return ast.create_csr(m, m, ptr, ind, dense[dense != 0]), dense


def test_bandt_parity(rng):
    m = 600
    A, dense = _band(rng, m, 7)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.5, A, GEN, Operation.none, x, 0.0, kid=BWD_KID))
    np.testing.assert_allclose(y, 1.5 * dense @ x, atol=1e-10)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="bwd")
    assert form.kind == "bwd" and form.bwd_W <= 32


def test_bandt_transpose_and_beta(rng):
    m = 300
    A, dense = _band(rng, m, 5)
    x = rng.standard_normal(m)
    y0 = rng.standard_normal(m)
    y = np.asarray(
        ast.mv(2.0, A, GEN, Operation.transpose, x, -1.0, y=y0.copy(), kid=BWD_KID)
    )
    np.testing.assert_allclose(y, 2.0 * dense.T @ x - y0, atol=1e-10)


def test_bandt_peel_spill(rng):
    # >4096 nnz triggers the percentile peel; outliers go to the spill
    m = 8192
    A, dense = _band(rng, m, 5, per_row=3, outliers=40)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="bwd")
    assert form.sp_ind is not None and int(form.sp_ind.shape[0]) >= 1
    assert form.bwd_W <= 32
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=BWD_KID))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)


def test_bandt_update_values(rng):
    m = 400
    A, dense = _band(rng, m, 6)
    x = rng.standard_normal(m)
    _ = ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=BWD_KID)
    v2 = rng.standard_normal(A.nnz)
    ast.update_values(A, v2)
    d2 = np.zeros((m, m))
    d2[
        np.repeat(np.arange(m), np.diff(np.asarray(A.data.ptr))), np.asarray(A.data.ind)
    ] = v2
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=BWD_KID))
    np.testing.assert_allclose(y, d2 @ x, atol=1e-10)


def test_pallas_spmm_band_interpret(rng):
    """Group-band SpMM (mm KID 3) on a band operand, f32 at 128 columns."""
    m, K = 300, 128
    A, dense = _band(rng, m, 8)
    B = rng.standard_normal((m, K)).astype(np.float32)
    _, _, _, ptr, ind, val = ast.export_csr(A)
    Af = ast.create_csr(m, m, ptr, ind, np.asarray(val, np.float32))
    C = np.asarray(ast.mm(1.0, Af, GEN, Operation.none, B, 0.0, kid=BWDG_MM_KID))
    np.testing.assert_allclose(C, dense.astype(np.float32) @ B, atol=1e-3)


def test_bandtm_mm_dispatch(rng):
    # mm() keeps band matrices on the gather forms by default, including
    # rows carrying outliers
    m, K = 8192, 128
    A, dense = _band(rng, m, 5, per_row=3, outliers=30)
    B = rng.standard_normal((m, K))
    C = np.asarray(ast.mm(2.0, A, GEN, Operation.none, B, 0.0))
    form = get_plan(A).exec_form_for(GEN, Operation.none)
    assert form.kind in ("ell", "ellhyb", "segsum")
    np.testing.assert_allclose(C, 2.0 * dense @ B, atol=1e-9)


def test_bandmxu_kid5_dispatch(rng, monkeypatch):
    """mm KID 3 (group-band scan) through the full dispatch: parity
    including spill rows, a non-128-multiple RHS width, mixed precision and
    refresh."""
    m = 4096
    A, dense = _band(rng, m, 5, per_row=3, outliers=20)
    for K in (128, 72):
        B = rng.standard_normal((m, K)).astype(np.float32)
        C3 = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0, kid=BWDG_MM_KID))
        np.testing.assert_allclose(C3, dense @ B, atol=1e-3)
    _, _, _, ptr_e, ind_e, val_e = ast.export_csr(A)
    Af = ast.create_csr(m, m, ptr_e, ind_e, np.asarray(val_e, np.float32))
    monkeypatch.setenv("AOCLSPARSE_TPU_MIXED_PRECISION", "1")
    B = rng.standard_normal((m, 128)).astype(np.float32)
    C3m = np.asarray(ast.mm(1.0, Af, GEN, Operation.none, B, 0.0, kid=BWDG_MM_KID))
    ref = dense @ B
    assert np.max(np.abs(C3m - ref)) / np.max(np.abs(ref)) < 2e-2
    monkeypatch.delenv("AOCLSPARSE_TPU_MIXED_PRECISION")
    ast.update_values(A, np.asarray(val_e) * 3.0)
    C3r = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0, kid=BWDG_MM_KID))
    np.testing.assert_allclose(C3r, 3.0 * ref, atol=1e-2)


def test_autotune_mm_includes_bandmxu(rng):
    """autotune_mm times only forms with an mm kernel row and mm honors a
    pin to one of them."""
    from aoclsparse_tpu.kernels.autotune import autotune_mm

    m = 2048
    A, dense = _band(rng, m, 4, per_row=3)
    res = autotune_mm(A, k=128, iters=1, chunks=1)
    assert "bwdg" in res and "ell" in res
    assert set(res) <= {"diag", "bwdg", "ell", "ellhyb", "segsum"}
    plan = get_plan(A)
    key = next(iter(plan._mm_tuned))
    plan._mm_tuned[key] = "bwdg"
    B = rng.standard_normal((m, 128)).astype(np.float32)
    C = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0))
    np.testing.assert_allclose(C, dense @ B, atol=1e-3)


def test_pallas_trsv_routing(rng):
    # single-RHS trsv runs the blocked scan: parity on a padded block count
    # and after update_values (the cached form must refresh)
    m = 1100  # non-multiple of the block: exercises block padding
    dense = np.tril(rng.standard_normal((m, m)).astype(np.float32)) * (
        np.abs(rng.standard_normal((m, m))) < 0.02
    )
    np.fill_diagonal(dense, 5.0)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    A = ast.create_csr(m, m, ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0])
    tri = MatrixDescriptor(type=MatrixType.triangular, fill_mode=FillMode.lower)
    b = rng.standard_normal(m).astype(np.float32)
    x = np.asarray(ast.trsv(1.0, A, tri, Operation.none, b))
    assert np.abs(dense @ x - b).max() < 1e-3
    v2 = (dense[dense != 0] * 1.5).astype(np.float32)
    ast.update_values(A, v2)
    x2 = np.asarray(ast.trsv(1.0, A, tri, Operation.none, b))
    assert np.abs(1.5 * dense @ x2 - b).max() < 1e-3


def test_bandt_symmetric_descriptor(rng):
    m = 256
    A, dense = _band(rng, m, 4)
    up = np.triu(dense)
    ptr = np.concatenate([[0], np.cumsum((up != 0).sum(1))]).astype(np.int64)
    Au = ast.create_csr(m, m, ptr, np.nonzero(up)[1].astype(np.int32), up[up != 0])
    sym = MatrixDescriptor(type=MatrixType.symmetric, fill_mode=FillMode.upper)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, Au, sym, Operation.none, x, 0.0, kid=BWD_KID))
    full = np.triu(up) + np.triu(up, 1).T
    np.testing.assert_allclose(y, full @ x, atol=1e-10)


def test_pallas_routes_reject_complex_dtype(rng):
    """The band form serves complex operands exactly like real ones."""
    m = 1024
    A, dense = _band(rng, m, 16, per_row=6)
    _, _, _, ptr, ind, fval = ast.export_csr(A)
    zval = np.asarray(fval).astype(np.complex128) * (1 + 1j)
    Az = ast.create_csr(m, m, ptr, ind, zval)
    x = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, Az, GEN, Operation.none, x, 0.0, kid=BWD_KID))
    np.testing.assert_allclose(y, (dense * (1 + 1j)) @ x, atol=1e-9)


def test_bandtm_wide_rhs_falls_back_to_bwdg(rng):
    """A wide RHS (K=512) on the group-band SpMM matches the oracle."""
    m = 8192
    A, dense = _band(rng, m, 5, per_row=3, outliers=0)
    K = 512
    B = rng.standard_normal((m, K)).astype(np.float32)
    C = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0, kid=BWDG_MM_KID))
    np.testing.assert_allclose(C, dense @ B, rtol=2e-3, atol=2e-3)


def test_pallas_band_v_variants(rng, monkeypatch):
    """Mixed precision on the band SpMV: bf16 multiply / f32 accumulate
    stays within the bf16 bound; full precision stays at f32 parity."""
    m = 2048
    A, dense = _band(rng, m, 12, per_row=6)
    _, _, _, ptr, ind, val = ast.export_csr(A)
    Af = ast.create_csr(m, m, ptr, ind, np.asarray(val, np.float32))
    x = rng.standard_normal(m).astype(np.float32)
    ref = dense @ x
    y = np.asarray(ast.mv(1.0, Af, GEN, Operation.none, x, 0.0, kid=BWD_KID))
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)
    monkeypatch.setenv("AOCLSPARSE_TPU_MIXED_PRECISION", "1")
    ym = np.asarray(ast.mv(1.0, Af, GEN, Operation.none, x, 0.0, kid=BWD_KID))
    assert np.max(np.abs(ym - ref)) / np.max(np.abs(ref)) < 2e-2


@pytest.mark.parametrize("kid", [8, 12, 13, 14])
def test_bandv_kid12_dispatch(rng, kid):
    """KIDs of the removed band kernels raise invalid_kid through mv."""
    A, _ = _band(rng, 256, 4)
    x = rng.standard_normal(256)
    with pytest.raises(AoclSparseError) as e:
        ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=kid)
    assert e.value.status == Status.invalid_kid


@pytest.mark.parametrize("kid", [4, 5, 6])
def test_pallas_band_mxu(rng, kid):
    """KIDs of the removed band SpMM kernels raise invalid_kid through mm."""
    A, _ = _band(rng, 256, 4)
    B = rng.standard_normal((256, 8))
    with pytest.raises(AoclSparseError) as e:
        ast.mm(1.0, A, GEN, Operation.none, B, 0.0, kid=kid)
    assert e.value.status == Status.invalid_kid


def test_pallas_trsm_multi_rhs(rng):
    """Multi-RHS solve (trsm) on the blocked scan: oracle parity for odd
    and even K and after update_values."""
    m = 2048
    dense = np.tril(
        rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.01), -1
    ) + np.diag(4 + rng.random(m))
    mask = dense != 0
    ptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
    ind = np.nonzero(mask)[1]
    val = dense[mask].astype(np.float32)
    A = ast.create_csr(m, m, ptr, ind, val)
    low = MatrixDescriptor().with_(type=MatrixType.triangular)
    for k in (3, 8, 17):
        B = rng.standard_normal((m, k)).astype(np.float32)
        X = np.asarray(ast.trsm(2.0, A, low, Operation.none, B))
        np.testing.assert_allclose(X, np.linalg.solve(dense, 2.0 * B), rtol=5e-4, atol=5e-4)
    ast.update_values(A, val * 2)
    B = rng.standard_normal((m, 5)).astype(np.float32)
    X2 = np.asarray(ast.trsm(1.0, A, low, Operation.none, B))
    np.testing.assert_allclose(X2, np.linalg.solve(2 * dense, B), rtol=5e-4, atol=5e-4)
