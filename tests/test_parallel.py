"""Distributed-execution tests on the 8-virtual-device CPU mesh (the
multi-host test story SURVEY.md §4 requires; the reference has no analog):
row-sharded SpMV (replicated and sharded-x halo paths), single-dispatch CG
under sharding, parity with the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.parallel import (
    cg_ell_jit,
    dist_cg,
    dist_spmv_ell,
    dist_spmv_ell_sharded_x,
    make_mesh,
    prepare_dist_ell,
    shard_ell,
)
from aoclsparse_tpu.planner.plan import get_plan
from aoclsparse_tpu.utils.tolerances import assert_allclose_spec

from conftest import random_csr


def _ell_form(A):
    plan = get_plan(A)
    return plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="ell")


def test_dist_spmv_matches_local(rng):
    m = n = 64
    ptr, ind, val, dense = random_csr(rng, m, n, density=0.2)
    A = ast.create_csr(m, n, ptr, ind, val)
    form = _ell_form(A)
    x = rng.standard_normal(n)
    want = dense @ x

    mesh = make_mesh(8)
    ind_s, val_s, m_pad = shard_ell(mesh, form.ell_ind, form.ell_val)
    y = dist_spmv_ell(mesh, ind_s, val_s, jnp.asarray(x))
    assert_allclose_spec(np.asarray(y)[:m], want, dtype=np.float64, scale=10)


def test_dist_spmv_sharded_x_halo(rng):
    m = n = 64
    ptr, ind, val, dense = random_csr(rng, m, n, density=0.2)
    A = ast.create_csr(m, n, ptr, ind, val)
    form = _ell_form(A)
    x = rng.standard_normal(n)
    mesh = make_mesh(8)
    ind_s, val_s, m_pad = shard_ell(mesh, form.ell_ind, form.ell_val)
    from jax.sharding import NamedSharding, PartitionSpec as P

    x_sh = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    y = dist_spmv_ell_sharded_x(mesh, ind_s, val_s, x_sh)
    assert_allclose_spec(np.asarray(y)[:m], dense @ x, dtype=np.float64, scale=10)


def _spd(rng, m):
    B = rng.standard_normal((m, m))
    B[np.abs(B) < 1.2] = 0
    dense = B @ B.T + m * np.eye(m)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int32)
    ind = np.nonzero(dense)[1].astype(np.int32)
    return ast.create_csr(m, m, ptr, ind, dense[dense != 0]), dense


def test_cg_jit_single_device(rng):
    m = 48
    A, dense = _spd(rng, m)
    form = _ell_form(A)
    b = rng.standard_normal(m)
    x, k, rnorm = cg_ell_jit(
        form.ell_ind,
        form.ell_val,
        jnp.asarray(b),
        jnp.zeros(m),
        jnp.asarray(1e-10),
        jnp.asarray(0.0),
        200,
    )
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(dense, b), atol=1e-6)
    assert int(k) < 200


def test_dist_cg_matches_and_same_iters(rng):
    m = 48
    A, dense = _spd(rng, m)
    form = _ell_form(A)
    b = rng.standard_normal(m)
    # single-device reference run
    x1, k1, _ = cg_ell_jit(
        form.ell_ind, form.ell_val, jnp.asarray(b), jnp.zeros(m),
        jnp.asarray(1e-10), jnp.asarray(0.0), 200,
    )
    mesh = make_mesh(8)
    x2, k2, rnorm = dist_cg(mesh, form.ell_ind, form.ell_val, b, rtol=1e-10, maxit=200)
    np.testing.assert_allclose(np.asarray(x2), np.linalg.solve(dense, b), atol=1e-6)
    assert k2 == int(k1)  # scaling must not change convergence behavior


def test_dist_cg_bwd(rng):
    """Distributed CG over the banded-window operand."""
    from aoclsparse_tpu import MatrixDescriptor, Operation
    from aoclsparse_tpu.parallel import dist_cg_bwd

    m = 72  # not a multiple of 8*8 devices -> exercises padding
    A, dense = _spd(rng, m)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    b = rng.standard_normal(m)
    mesh = make_mesh(8)
    x, k, rn = dist_cg_bwd(mesh, form, b, rtol=1e-10, maxit=300)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(dense, b), atol=1e-6)
    assert k > 0


def test_dist_spgemm_numeric(rng):
    from aoclsparse_tpu.core.descr import GENERAL
    from aoclsparse_tpu.ops.level3.spgemm import _effective, _symbolic
    from aoclsparse_tpu.parallel import dist_spgemm_numeric
    from aoclsparse_tpu.utils.reference import csr_to_dense

    mA, k, nB = 30, 25, 28
    ptrA, indA, valA, dA = random_csr(rng, mA, k, density=0.25)
    ptrB, indB, valB, dB = random_csr(rng, k, nB, density=0.25)
    A = ast.create_csr(mA, k, ptrA, indA, valA)
    B = ast.create_csr(k, nB, ptrB, indB, valB)
    effA = _effective(A, GENERAL, Operation.none)
    effB = _effective(B, GENERAL, Operation.none)
    plan = _symbolic(effA, effB)
    mesh = make_mesh(8)
    cval = dist_spgemm_numeric(mesh, plan, effA.val, effB.val)
    got = csr_to_dense(mA, nB, plan.ptr, plan.ind, np.asarray(cval))
    np.testing.assert_allclose(got, dA @ dB, atol=1e-12)


def test_gmres_bwd_jit_single(rng):
    from aoclsparse_tpu import MatrixDescriptor, Operation
    from aoclsparse_tpu.parallel import gmres_bwd_jit

    m = 60
    dense = rng.standard_normal((m, m))
    dense[np.abs(dense) < 1.0] = 0
    np.fill_diagonal(dense, m / 2.0)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int32)
    ind = np.nonzero(dense)[1].astype(np.int32)
    A = ast.create_csr(m, m, ptr, ind, dense[dense != 0])
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    b = rng.standard_normal(m)
    x, ncyc, rnorm = gmres_bwd_jit(
        form.bwd_val,
        jnp.asarray(b),
        jnp.zeros(m),
        jnp.asarray(1e-10),
        jnp.asarray(0.0),
        20,
        30,
        form.bwd_W,
        form.bwd_base8,
        form.bwd_padL,
        form.bwd_n_pad,
    )
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(dense, b), atol=1e-6)
    assert float(rnorm) < 1e-8


def test_dist_gmres_bwd(rng):
    from aoclsparse_tpu import MatrixDescriptor, Operation
    from aoclsparse_tpu.parallel import dist_gmres_bwd

    m = 72
    dense = rng.standard_normal((m, m))
    dense[np.abs(dense) < 1.0] = 0
    np.fill_diagonal(dense, m / 2.0)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int32)
    ind = np.nonzero(dense)[1].astype(np.int32)
    A = ast.create_csr(m, m, ptr, ind, dense[dense != 0])
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    b = rng.standard_normal(m)
    mesh = make_mesh(8)
    x, iters, rnorm = dist_gmres_bwd(mesh, form, b, rtol=1e-10, maxit=300)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(dense, b), atol=1e-6)


def test_dist_cg_uneven_rows(rng):
    # m not divisible by device count exercises the padding path
    m = 37
    A, dense = _spd(rng, m)
    form = _ell_form(A)
    b = rng.standard_normal(m)
    mesh = make_mesh(8)
    x, k, rnorm = dist_cg(mesh, form.ell_ind, form.ell_val, b, rtol=1e-10, maxit=200)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(dense, b), atol=1e-6)


def _band_csr(rng, m, per, lo_shift=0):
    """Square banded matrix: row i has `per` cols in [i+lo_shift, i+lo_shift+2*per)."""
    span = 2 * per
    base = np.clip(np.arange(m) + lo_shift, 0, m - span)
    pick = np.argsort(rng.random((m, span)), axis=1)[:, :per]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1) * per
    val = rng.standard_normal(m * per)
    return ast.create_csr(m, m, ptr, cols.reshape(-1), val)


@pytest.mark.parametrize("lo_shift", [-6, 0, 40])
def test_dist_spmm_bwd_halo(rng, lo_shift):
    """Distributed SpMM over the group-banded form with ppermute row-block
    halos (SURVEY §5.8(i) SpMM half): parity with the single-device mm."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from aoclsparse_tpu.parallel import dist_spmm_bwd_halo

    m, per, K = 8192, 5, 8  # 2 bwdg groups (G=512) per device on the 8-mesh
    A = _band_csr(rng, m, per, lo_shift)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwdg")
    assert form.bwd_G == 512 and form.sp_ind is None
    B = rng.standard_normal((m, K))
    want = np.asarray(ast.mm(1.0, A, MatrixDescriptor(), Operation.none, B, 0.0))
    mesh = make_mesh(8)
    Bs = jax.device_put(jnp.asarray(B), NamedSharding(mesh, P("x", None)))
    C = dist_spmm_bwd_halo(mesh, form, Bs)
    np.testing.assert_allclose(np.asarray(C)[:m], want, atol=1e-8)


def test_dist_spmm_bwd_halo_single_group(rng):
    """m_pad == G * ndev: one group per device, no interior -> unsplit path."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from aoclsparse_tpu.parallel import dist_spmm_bwd_halo

    m, per, K = 4096, 4, 4
    A = _band_csr(rng, m, per)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwdg")
    B = rng.standard_normal((m, K))
    want = np.asarray(ast.mm(1.0, A, MatrixDescriptor(), Operation.none, B, 0.0))
    mesh = make_mesh(8)
    Bs = jax.device_put(jnp.asarray(B), NamedSharding(mesh, P("x", None)))
    C = dist_spmm_bwd_halo(mesh, form, Bs)
    np.testing.assert_allclose(np.asarray(C)[:m], want, atol=1e-8)


def test_dist_cg_bwd_halo(rng):
    """Halo-CG: fully sharded vectors, ppermute band halos inside the
    while_loop; must match dense solve AND dist_cg_bwd's iteration count
    (reductions are psum'd, so the scalar sequence is identical up to
    reduction order)."""
    from aoclsparse_tpu.parallel import dist_cg_bwd, dist_cg_bwd_halo

    m = 384
    # banded SPD: pentadiagonal, diagonally dominant -> spill-free bwd form
    dense = np.zeros((m, m))
    for off, v in [(0, 6.0), (1, -1.0), (2, -0.5)]:
        dense += np.diag(np.full(m - off, v), off)
        if off:
            dense += np.diag(np.full(m - off, v), -off)
    msk = dense != 0
    ptr = np.concatenate([[0], np.cumsum(msk.sum(1))]).astype(np.int64)
    A = ast.create_csr(m, m, ptr, np.nonzero(msk)[1].astype(np.int32), dense[msk])
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    assert form.sp_ind is None or form.sp_ind.shape[0] == 0
    b = rng.standard_normal(m)
    mesh = make_mesh(8)
    x1, k1, rn1 = dist_cg_bwd(mesh, form, b, rtol=1e-10, maxit=400)
    x2, k2, rn2 = dist_cg_bwd_halo(mesh, form, b, rtol=1e-10, maxit=400)
    np.testing.assert_allclose(np.asarray(x2), np.linalg.solve(dense, b), atol=1e-6)
    assert abs(k2 - k1) <= 2  # same math, different reduction order
