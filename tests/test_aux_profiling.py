"""Auxiliary API + profiling/roofline + extreme-value (NaN/Inf) tests
(reference: aoclsparse_auxiliary.cpp API surface, extreme_value_tests.cpp,
tools/twosampletest.py)."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import FormatType, MatrixDescriptor, Operation
from aoclsparse_tpu.utils import profiling as prof
from aoclsparse_tpu.utils.reference import csr_to_dense

from conftest import random_csr


def test_convert_handle_level(rng):
    m, n = 8, 6
    ptr, ind, val, dense = random_csr(rng, m, n, density=0.4)
    h = ast.create_csr(m, n, ptr, ind, val)
    for fmt in [FormatType.csc, FormatType.coo, FormatType.ell, FormatType.bsr, FormatType.dia]:
        kw = {"block_dim": 2} if fmt == FormatType.bsr else {}
        h2 = ast.convert_format(h, fmt, **kw)
        m2, n2, nnz2, p2, i2, v2 = ast.export_csr(h2)
        np.testing.assert_allclose(csr_to_dense(m2, n2, p2, i2, v2), dense)
    # transpose conversion
    ht = ast.convert_csr(h, Operation.transpose)
    mt, nt, _, pt, it_, vt = ast.export_csr(ht)
    np.testing.assert_allclose(csr_to_dense(mt, nt, pt, it_, vt), dense.T)


def test_debug_get_and_version():
    info = ast.debug_get()
    assert info["version"] == ast.get_version()
    assert info["platform"] in ("cpu", "gpu")
    assert isinstance(info["native_host_kernels"], bool)
    # a CPU has no published peaks (core/context.py PEAKS)
    assert info["peaks"] is None


def test_enable_instructions_roundtrip(rng):
    import os

    ast.enable_instructions("generic")
    ast.enable_instructions(None)
    assert "AOCLSPARSE_TPU_FORCE_GENERIC" not in os.environ
    with pytest.raises(ast.AoclSparseError):
        ast.enable_instructions("avx999")


def test_flop_byte_formulas():
    assert prof.spmv_flops(100) == 200
    assert prof.spmv_flops(100, 10, True) == 220
    assert prof.trsv_flops(100, 10) == 190
    assert prof.trsv_flops(100, 10, unit_diag=True) == 200
    assert prof.csrmm_flops(50, 4) == 400
    b = prof.spmv_bytes(10, 10, 100, 8)
    assert b == (11 + 100) * 4 + (100 + 10) * 8 + 10 * 8


def test_roofline_accounting(monkeypatch):
    import dataclasses

    import aoclsparse_tpu.core.context as ctx_mod

    # a CPU has no published peaks: no roofline share without a real peak
    with pytest.raises(ast.AoclSparseError):
        prof.roofline(bytes_moved=1e9, seconds=0.01)
    h100 = dataclasses.replace(
        ctx_mod.get_context(), platform="gpu", device_kind="NVIDIA H100 80GB HBM3"
    )
    monkeypatch.setattr(prof, "get_context", lambda: h100)
    r = prof.roofline(bytes_moved=1e9, seconds=0.01, frac=0.8)
    assert r["achieved_gbps"] == pytest.approx(100.0)
    assert r["peak_gbps"] == pytest.approx(3350.0)
    assert r["fraction_of_peak"] == pytest.approx(100.0 / 3350.0)
    assert r["fraction_of_target"] == pytest.approx(100.0 / (0.8 * 3350.0))


def test_chain_bench_and_ttest():
    import jax.numpy as jnp

    x = jnp.ones(1024)
    res = prof.chain_bench(lambda: x * 2, iters=10, chunks=2)
    assert res.t_median > 0
    st = prof.two_sample_t([1.0, 1.1, 0.9], [2.0, 2.1, 1.9])
    assert st["t"] < 0
    assert st["mean_b"] > st["mean_a"]


def test_nan_inf_propagation(rng):
    """extreme_value_tests.cpp analog: IEEE semantics must propagate."""
    m = 6
    ptr, ind, val, dense = random_csr(rng, m, m, density=0.5, ensure_diag=True)
    val = np.array(val)
    val[0] = np.nan
    val[1] = np.inf
    A = ast.create_csr(m, m, ptr, ind, val)
    x = np.ones(m)
    y = np.asarray(ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0))
    # rows containing the NaN/Inf entries must reflect them
    dense2 = csr_to_dense(m, m, ptr, ind, val)
    want = dense2 @ x
    np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
    assert np.array_equal(y[~np.isnan(want)], want[~np.isnan(want)])


def test_cg_bwd_jit(rng):
    import jax.numpy as jnp

    from aoclsparse_tpu.parallel.cg import cg_bwd_jit
    from aoclsparse_tpu.planner.plan import get_plan

    m = 64
    B = rng.standard_normal((m, m))
    B[np.abs(B) < 1.0] = 0
    dense = B @ B.T + m * np.eye(m)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int32)
    ind = np.nonzero(dense)[1].astype(np.int32)
    A = ast.create_csr(m, m, ptr, ind, dense[dense != 0])
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    b = rng.standard_normal(m)
    x, k, rn = cg_bwd_jit(
        form.bwd_val,
        jnp.asarray(b),
        jnp.zeros(m),
        jnp.asarray(1e-10),
        jnp.asarray(0.0),
        200,
        form.bwd_W,
        form.bwd_base8,
        form.bwd_padL,
        form.bwd_n_pad,
    )
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(dense, b), atol=1e-6)


def test_cg_bandv_jit_matches_bwd(rng):
    """cg_ell_jit (matvec = the padded-ELL gather form) must converge to the
    same solution in the same iteration count as cg_bwd_jit (banded-window
    form) on the same operand."""
    import jax.numpy as jnp

    from aoclsparse_tpu.parallel.cg import cg_bwd_jit, cg_ell_jit
    from aoclsparse_tpu.planner.plan import get_plan

    m = 128
    B = (rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.2)) * (
        np.abs(np.subtract.outer(np.arange(m), np.arange(m))) < 12
    )
    dense = (B @ B.T + m * np.eye(m)).astype(np.float32)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int32)
    ind = np.nonzero(dense)[1].astype(np.int32)
    A = ast.create_csr(m, m, ptr, ind, dense[dense != 0])
    plan = get_plan(A)
    formb = plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    forme = plan.exec_form_for(MatrixDescriptor(), Operation.none, kind="ell")
    b = rng.standard_normal(m).astype(np.float32)
    x1, k1, rn1 = cg_bwd_jit(
        formb.bwd_val, jnp.asarray(b), jnp.zeros(m, jnp.float32),
        jnp.asarray(1e-6, jnp.float32), jnp.asarray(0.0, jnp.float32), 200,
        formb.bwd_W, formb.bwd_base8, formb.bwd_padL, formb.bwd_n_pad,
    )
    x2, k2, rn2 = cg_ell_jit(
        forme.ell_ind, forme.ell_val, jnp.asarray(b), jnp.zeros(m, jnp.float32),
        jnp.asarray(1e-6, jnp.float32), jnp.asarray(0.0, jnp.float32), 200,
    )
    assert int(k1) == int(k2), (int(k1), int(k2))
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(x2), np.linalg.solve(dense, b).astype(np.float32), rtol=1e-3, atol=1e-3
    )
