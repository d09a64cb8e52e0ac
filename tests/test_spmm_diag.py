"""Diag-form SpMM (mm KID 7): the XLA unrolled static-slice kernel and its
scan fallback vs the dense oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.kernels.xla.spmm import _spmm_diag_unrolled, spmm_diag
from aoclsparse_tpu.planner.plan import get_plan


def _diag_matrix(rng, m, offs):
    """CSR with exactly the given generalized diagonals (clipped rows)."""
    rows, cols, vals = [], [], []
    for d in offs:
        i = np.arange(max(0, -d), min(m, m - d))
        rows.append(i)
        cols.append(i + d)
        vals.append(rng.standard_normal(i.size))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    return np.cumsum(ptr), c.astype(np.int32), v.astype(np.float32), r


@pytest.mark.parametrize("k", [8, 64])
def test_pallas_spmm_diag_parity(k):
    # unaligned offsets spanning both signs, all 8 phases exercised
    offs = (-517, -130, -129, -7, -1, 0, 1, 3, 8, 37, 129, 515)
    m = 900
    rng = np.random.default_rng(5)
    ptr, ind, val, r = _diag_matrix(rng, m, offs)
    A = ast.create_csr(m, m, ptr, ind, val)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="diag")
    assert form.kind == "diag"
    B = rng.standard_normal((m, k)).astype(np.float32)
    D = np.zeros((m, m), np.float64)
    D[r, ind] = val
    want = D @ B.astype(np.float64)

    got = np.asarray(
        spmm_diag(
            form.dia_val, form.dia_offs, jnp.asarray(B), form.m, form.dia_L,
            form.dia_n_pad, offs_static=form.dia_offs_static,
        )
    )
    assert got.shape == (m, k)
    assert np.abs(got - want).max() < 1e-3

    got_u = np.asarray(
        _spmm_diag_unrolled(
            form.dia_val, jnp.asarray(B), form.dia_offs_static,
            form.m, form.dia_L, form.dia_n_pad,
        )
    )
    assert np.abs(got_u - want).max() < 1e-3


def test_mm_routes_diag_form():
    # stencil-type matrix: mm KID 7 rides the diag engine end-to-end and
    # matches (the default dispatch picks a gather form, so the route is
    # pinned)
    nx = 48
    m = nx * nx
    rng = np.random.default_rng(3)
    offs = (-nx, -1, 0, 1, nx)
    ptr, ind, val, r = _diag_matrix(rng, m, offs)
    A = ast.create_csr(m, m, ptr, ind, val)
    B = rng.standard_normal((m, 16)).astype(np.float32)
    D = np.zeros((m, m), np.float64)
    D[r, ind] = val
    want = D @ B.astype(np.float64)
    C7 = np.asarray(ast.mm(1.0, A, MatrixDescriptor(), Operation.none, B, 0.0, kid=7))
    assert np.abs(C7 - want).max() < 1e-3
    # default dispatch agrees whatever form the cost model picked
    C = np.asarray(ast.mm(1.0, A, MatrixDescriptor(), Operation.none, B, 0.0))
    assert np.abs(C - want).max() < 1e-3


def test_spmm_diag_scan_many_diagonals():
    # past DIA_UNROLL the dispatcher takes the scan form
    from aoclsparse_tpu.kernels.xla.spmv import DIA_UNROLL

    m = 512
    rng = np.random.default_rng(11)
    offs = tuple(sorted(rng.choice(np.arange(-200, 201), DIA_UNROLL + 8,
                                   replace=False).tolist()))
    ptr, ind, val, r = _diag_matrix(rng, m, offs)
    A = ast.create_csr(m, m, ptr, ind, val)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="diag")
    B = rng.standard_normal((m, 8)).astype(np.float32)
    got = np.asarray(
        spmm_diag(form.dia_val, form.dia_offs, jnp.asarray(B), form.m,
                  form.dia_L, form.dia_n_pad, offs_static=None)
    )
    D = np.zeros((m, m), np.float64)
    D[r, ind] = val
    want = D @ B.astype(np.float64)
    assert np.abs(got - want).max() < 1e-3


def test_spmm_diag_clustered_wide_span():
    # ldoor/bone010 class: diagonal clusters around distant plane offsets
    # (a global span far wider than each cluster) must match the oracle
    m = 2200
    offs = tuple(sorted(
        [-40960 + d for d in (-5, -1, 0, 3)]
        + [-7, -1, 0, 1, 9]
        + [40960 + d for d in (-2, 0, 1, 6)]
    ))
    # build on a larger index space so the far offsets exist: embed in a
    # (m, n) rectangle? offsets need |off| < n; use square with n > 43k
    n = 45000
    rng = np.random.default_rng(13)
    rows_l, cols_l, vals_l = [], [], []
    for d in offs:
        i = np.arange(max(0, -d), min(m, n - d))
        rows_l.append(i)
        cols_l.append(i + d)
        vals_l.append(rng.standard_normal(i.size))
    r = np.concatenate(rows_l)
    c = np.concatenate(cols_l)
    v = np.concatenate(vals_l).astype(np.float32)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    A = ast.create_csr(m, n, np.cumsum(ptr), c.astype(np.int32), v)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="diag")
    assert form.kind == "diag"
    k = 16
    B = rng.standard_normal((n, k)).astype(np.float32)
    got = np.asarray(
        spmm_diag(form.dia_val, form.dia_offs, jnp.asarray(B), form.m,
                  form.dia_L, form.dia_n_pad,
                  offs_static=form.dia_offs_static)
    )
    import scipy.sparse as sp

    S = sp.csr_matrix((v.astype(np.float64), c, np.cumsum(ptr)), shape=(m, n))
    want = S @ B.astype(np.float64)
    assert np.abs(got - want).max() < 1e-3
