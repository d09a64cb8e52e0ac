"""Scan-over-diagonals (diag) execution-form tests: stencil matrices,
rectangular shapes, refresh, and the form-selection cost model."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.kernels.xla.spmv import spmv_diag_scan
from aoclsparse_tpu.planner.plan import get_plan
from aoclsparse_tpu.utils.tolerances import assert_allclose_spec


def _laplace2d(nx):
    """5-point stencil on an nx*nx grid — the classic scattered-diagonal
    matrix (offsets 0, +-1, +-nx) whose band window is ~2*nx wide."""
    n = nx * nx
    dense = np.zeros((n, n))
    for i in range(n):
        dense[i, i] = 4.0
        x, y = divmod(i, nx)
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            xx, yy = x + dx, y + dy
            if 0 <= xx < nx and 0 <= yy < nx:
                dense[i, xx * nx + yy] = -1.0
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    ind = np.nonzero(dense)[1].astype(np.int32)
    val = dense[dense != 0]
    return ptr, ind, val, dense


def _run_diag(A, x):
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="diag")
    assert form.kind == "diag"
    import jax.numpy as jnp

    return (
        np.asarray(
            spmv_diag_scan(
                form.dia_val, form.dia_offs, jnp.asarray(x), form.m, form.dia_L, form.dia_n_pad
            )
        ),
        form,
    )


def test_diag_laplace(rng):
    ptr, ind, val, dense = _laplace2d(12)
    n = dense.shape[0]
    A = ast.create_csr(n, n, ptr, ind, val)
    x = rng.standard_normal(n)
    got, form = _run_diag(A, x)
    assert form.dia_offs.shape[0] <= 5
    assert_allclose_spec(got, dense @ x, dtype=np.float64, scale=10)


def test_diag_rectangular(rng):
    m, n = 40, 60
    dense = np.zeros((m, n))
    for i in range(m):
        for d in (0, 3, 17):
            if i + d < n:
                dense[i, i + d] = rng.standard_normal()
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    ind = np.nonzero(dense)[1].astype(np.int32)
    A = ast.create_csr(m, n, ptr, ind, dense[dense != 0])
    x = rng.standard_normal(n)
    got, form = _run_diag(A, x)
    assert_allclose_spec(got, dense @ x, dtype=np.float64, scale=10)


def test_diag_negative_offsets(rng):
    m = 50
    dense = np.zeros((m, m))
    for i in range(m):
        for d in (-7, -1, 0):
            if 0 <= i + d:
                dense[i, i + d] = rng.standard_normal()
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    ind = np.nonzero(dense)[1].astype(np.int32)
    A = ast.create_csr(m, m, ptr, ind, dense[dense != 0])
    x = rng.standard_normal(m)
    got, form = _run_diag(A, x)
    assert form.dia_L >= 7
    assert_allclose_spec(got, dense @ x, dtype=np.float64, scale=10)


def test_diag_refresh(rng):
    ptr, ind, val, dense = _laplace2d(6)
    n = dense.shape[0]
    A = ast.create_csr(n, n, ptr, ind, val)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="diag")
    ast.update_values(A, np.asarray(val) * 0.5)
    x = rng.standard_normal(n)
    import jax.numpy as jnp

    got = np.asarray(
        spmv_diag_scan(
            form.dia_val, form.dia_offs, jnp.asarray(x), form.m, form.dia_L, form.dia_n_pad
        )
    )
    assert_allclose_spec(got, 0.5 * dense @ x, dtype=np.float64, scale=10)


def test_choose_format_prefers_diag_for_stencils(monkeypatch, rng):
    """On a CPU and on a (simulated) GPU context the planner keeps a
    gather form for a stencil; the diag form (mv KID 6) serves it when
    pinned and matches the dense oracle."""
    import dataclasses

    import aoclsparse_tpu as ast
    from aoclsparse_tpu.core import context as ctx_mod
    from aoclsparse_tpu.planner.plan import build_clean_csr, build_effective_csr, choose_mv_format
    from aoclsparse_tpu.core.formats import CSR

    ptr, ind, val, dense = _laplace2d(10)
    n = dense.shape[0]
    clean = build_clean_csr(CSR(ptr, ind, val, shape=(n, n)))
    eff = build_effective_csr(clean, MatrixDescriptor(), Operation.none)
    assert choose_mv_format(eff) in ("ell", "ellhyb")
    gpu = dataclasses.replace(ctx_mod.get_context(), platform="gpu")
    monkeypatch.setattr(ctx_mod, "_ctx", gpu)
    assert choose_mv_format(eff) in ("ell", "ellhyb")
    A = ast.create_csr(n, n, ptr, ind, val)
    x = rng.standard_normal(n)
    y = np.asarray(ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0, kid=6))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
