"""Band x band SpGEMM numeric (the scan of dense matmuls) vs the library's
default product engine on the same pattern."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.kernels.xla.spgemm_band import build_band_gemm_plan
from aoclsparse_tpu.planner.plan import build_effective_csr, get_plan


def _banded(rng, m, half_bw, row_nnz):
    win = 2 * half_bw
    base = np.clip(np.arange(m) - half_bw, 0, m - win)
    pick = np.argsort(rng.random((m, win)), axis=1)[:, :row_nnz]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1, dtype=np.int64) * row_nnz
    val = rng.standard_normal(m * row_nnz).astype(np.float32)
    return ptr, cols.reshape(-1).astype(np.int32), val


@pytest.mark.parametrize("half_bw", [16, 48])
def test_pallas_band_gemm_matches_scan(half_bw):
    rng = np.random.default_rng(5)
    m = 1024
    ptr, ind, val = _banded(rng, m, half_bw, 8)
    A = ast.create_csr(m, m, ptr, ind, val)
    B = ast.create_csr(m, m, ptr, ind, (val * 0.5).astype(np.float32))
    plan_a = get_plan(A)
    effA = build_effective_csr(plan_a.clean, MatrixDescriptor(), Operation.none)
    plan_b = get_plan(B)
    effB = build_effective_csr(plan_b.clean, MatrixDescriptor(), Operation.none)
    # symbolic pattern via the library product
    C = ast.sp2m(Operation.none, MatrixDescriptor(), A, Operation.none, MatrixDescriptor(), B)
    _, _, _, Cptr, Cind, _ = ast.export_csr(C)
    gp = build_band_gemm_plan(
        effA, effB, np.asarray(Cptr), np.asarray(Cind), G=256, force=True
    )
    assert gp is not None
    from aoclsparse_tpu.kernels.xla.spgemm_band import band_gemm_values

    got = np.asarray(band_gemm_values(gp, effA.val, effB.val))
    want = np.asarray(ast.export_csr(C)[5])
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5
