"""Band-form coverage: TRSV dense-left-window variant and SpMM group-banded
(bwdg) kernel parity with the gather paths."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import DiagType, FillMode, MatrixDescriptor, MatrixType, Operation
from aoclsparse_tpu.planner.plan import get_plan
from aoclsparse_tpu.planner.triangular import trsv_form_for
from aoclsparse_tpu.utils.reference import ref_mm, ref_trsv
from aoclsparse_tpu.utils.tolerances import assert_allclose_spec


def _banded(rng, m, n, half_bw, row_nnz, dtype=np.float64, diag=True):
    dense = np.zeros((m, n), dtype=dtype)
    for i in range(m):
        cs = np.unique(np.clip(i + rng.integers(-half_bw, half_bw + 1, row_nnz), 0, n - 1))
        dense[i, cs] = rng.standard_normal(cs.size)
        if diag and i < n:
            dense[i, i] = m
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    ind = np.nonzero(dense)[1].astype(np.int32)
    val = dense[dense != 0]
    return ptr, ind, val, dense


@pytest.mark.parametrize("fill", [FillMode.lower, FillMode.upper])
@pytest.mark.parametrize("op", [Operation.none, Operation.transpose])
def test_trsv_win_variant(rng, fill, op):
    # banded matrix with many blocks -> dense-left-window kind selected
    m = 512
    ptr, ind, val, dense = _banded(rng, m, m, 10, 6)
    A = ast.create_csr(m, m, ptr, ind, val)
    descr = MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill)
    form = trsv_form_for(get_plan(A), descr, op)
    assert form.kind == "win", f"expected win kind, got {form.kind} (WL={form.WL})"
    b = rng.standard_normal(m)
    got = ast.trsv(1.0, A, descr, op, b)
    want = ref_trsv(1.0, m, ptr, ind, val, descr, op, b)
    assert_allclose_spec(got, want, dtype=np.float64, scale=100)


def test_trsv_gather_variant_still_used(rng):
    # large scattered matrix: window blowup rejected -> gather kind
    from conftest import random_csr

    m = 2048
    ptr, ind, val, dense = random_csr(rng, m, m, density=0.01, ensure_diag=True)
    A = ast.create_csr(m, m, ptr, ind, val)
    descr = MatrixDescriptor(type=MatrixType.triangular)
    form = trsv_form_for(get_plan(A), descr, Operation.none)
    assert form.kind == "gather"
    b = rng.standard_normal(m)
    got = ast.trsv(1.0, A, descr, Operation.none, b)
    want = ref_trsv(1.0, m, ptr, ind, val, descr, Operation.none, b)
    assert_allclose_spec(got, want, dtype=np.float64, scale=100)


def test_trsv_win_unit_diag(rng):
    m = 512
    ptr, ind, val, dense = _banded(rng, m, m, 8, 5)
    A = ast.create_csr(m, m, ptr, ind, val)
    descr = MatrixDescriptor(
        type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.unit
    )
    form = trsv_form_for(get_plan(A), descr, Operation.none)
    assert form.kind == "win"
    b = rng.standard_normal(m)
    got = ast.trsv(1.0, A, descr, Operation.none, b)
    want = ref_trsv(1.0, m, ptr, ind, val, descr, Operation.none, b)
    assert_allclose_spec(got, want, dtype=np.float64, scale=100)


def test_trsv_win_inverse_variant(rng):
    """The pre-inverted-diagonal-block solve must match substitution within
    the tolerance model (the distributed pipeline's path, exercised here
    directly)."""
    import jax.numpy as jnp

    from aoclsparse_tpu.kernels.xla.trsv import (
        invert_diag_blocks,
        trsv_blocked_win,
        trsv_blocked_win_inv,
    )
    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.planner.triangular import trsv_form_for

    m = 512
    ptr, ind, val, dense = _banded(rng, m, m, 10, 6)
    A = ast.create_csr(m, m, ptr, ind, val)
    descr = MatrixDescriptor(type=MatrixType.triangular, fill_mode=FillMode.lower)
    form = trsv_form_for(get_plan(A), descr, Operation.none)
    assert form.kind == "win"
    b = rng.standard_normal(m)
    m_pad = form.nblk * form.nb
    b2 = jnp.pad(jnp.asarray(b)[:, None], ((0, m_pad - m), (0, 0)))
    x_exact = np.asarray(trsv_blocked_win(form.D, form.Lval, b2, form.nb, m_pad, form.WL))
    Dinv = invert_diag_blocks(form.D)
    x_inv = np.asarray(trsv_blocked_win_inv(Dinv, form.Lval, b2, form.nb, m_pad, form.WL))
    np.testing.assert_allclose(x_inv[:m], x_exact[:m], rtol=1e-8, atol=1e-10)
    want = ref_trsv(1.0, m, ptr, ind, val, descr, Operation.none, b)
    assert_allclose_spec(x_inv[:m, 0], want, dtype=np.float64, scale=100)


def test_spmm_bwdg_kernel(rng):
    m, n, k = 300, 280, 17
    ptr, ind, val, dense = _banded(rng, m, n, 12, 5)
    A = ast.create_csr(m, n, ptr, ind, val)
    plan = get_plan(A)
    form = plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="bwdg")
    assert form.kind == "bwdg" and form.bwd_G == 512
    B = rng.standard_normal((n, k))
    import jax.numpy as jnp
    from aoclsparse_tpu.kernels.xla.spmm import spmm_bwd

    Bp = jnp.pad(
        jnp.asarray(B), ((form.bwd_padL, form.bwd_n_pad - form.bwd_padL - n), (0, 0))
    )
    got = np.asarray(
        spmm_bwd(form.bwd_val, Bp, form.bwd_G, form.bwd_W, form.bwd_base8, form.bwd_n_pad, False)
    )[:m]
    want = ref_mm(
        1.0, m, n, ptr, ind, val, MatrixDescriptor(), Operation.none, B, 0.0, np.zeros((m, k))
    )
    assert_allclose_spec(got, want, dtype=np.float64, scale=30)


def test_spmm_bwdg_refresh(rng):
    m = 256
    ptr, ind, val, dense = _banded(rng, m, m, 6, 4)
    A = ast.create_csr(m, m, ptr, ind, val)
    plan = get_plan(A)
    form = plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="bwdg")
    ast.update_values(A, np.asarray(val) * -2.0)
    B = rng.standard_normal((m, 5))
    import jax.numpy as jnp
    from aoclsparse_tpu.kernels.xla.spmm import spmm_bwd

    Bp = jnp.pad(
        jnp.asarray(B), ((form.bwd_padL, form.bwd_n_pad - form.bwd_padL - m), (0, 0))
    )
    got = np.asarray(
        spmm_bwd(form.bwd_val, Bp, form.bwd_G, form.bwd_W, form.bwd_base8, form.bwd_n_pad, False)
    )[:m]
    assert_allclose_spec(got, -2.0 * dense @ B, dtype=np.float64, scale=30)
