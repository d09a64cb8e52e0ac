"""SELL execution form as an explicit-KID mv path (ROADMAP: wire SELL as a
dispatcher-selectable KID). Mirrors the reference's per-format dispatch tests
(csrmv kid table, level2/aoclsparse_mv.cpp:179) for the sliced-ELL form."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.kernels.registry import debug_dispatcher
from aoclsparse_tpu.planner.plan import get_plan
from aoclsparse_tpu.utils.reference import ref_mv
from aoclsparse_tpu.utils.tolerances import assert_allclose_spec

from conftest import random_csr

SELL_KID = 10
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", [Operation.none, Operation.transpose])
def test_mv_sell_kid_matches_reference(rng, dtype, op):
    m, n = 37, 29
    ptr, ind, val, dense = random_csr(rng, m, n, dtype=dtype)
    A = ast.create_csr(m, n, ptr, ind, val)
    descr = MatrixDescriptor()
    nx, ny = (n, m) if op == Operation.none else (m, n)
    x = rng.standard_normal(nx).astype(dtype)
    y = rng.standard_normal(ny).astype(dtype)
    got = ast.mv(1.3, A, descr, op, x, -0.7, y, kid=SELL_KID)
    want = ref_mv(1.3, m, n, ptr, ind, val, descr, op, x, -0.7, y)
    assert_allclose_spec(got, want, dtype=dtype, scale=10)


def test_sell_form_structure(rng):
    """The built form is slice-padded: total is a multiple of 8*128 per slice
    and every stored entry lands at its row-major slice position."""
    m, n = 20, 20
    ptr, ind, val, dense = random_csr(rng, m, n, density=0.4)
    A = ast.create_csr(m, n, ptr, ind, val)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="sell")
    assert form.kind == "sell"
    assert form.sell_total % (8 * 128) == 0
    assert form.sell_dest.size == len(val)
    # row_ids sorted (slice layout is row-major)
    rids = np.asarray(form.row_ids)
    assert (np.diff(rids) >= 0).all()
    x = rng.standard_normal(n)
    got = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0, kid=SELL_KID)
    assert_allclose_spec(got, dense @ x, dtype=np.float64, scale=10)


def test_sell_kid_value_refresh(rng):
    """update_values must refresh the cached SELL buffer (CLAUDE.md rule:
    every execution form stores host scatter lists and refreshes)."""
    m = 16
    ptr, ind, val, dense = random_csr(rng, m, m, density=0.5)
    A = ast.create_csr(m, m, ptr, ind, val)
    x = rng.standard_normal(m)
    got0 = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0, kid=SELL_KID)
    assert_allclose_spec(got0, dense @ x, dtype=np.float64, scale=10)
    new_val = rng.standard_normal(val.size)
    ast.update_values(A, new_val)
    dense2 = np.zeros_like(dense)
    rows = np.repeat(np.arange(m), np.diff(ptr))
    dense2[rows, ind] = new_val
    got1 = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0, kid=SELL_KID)
    assert_allclose_spec(got1, dense2 @ x, dtype=np.float64, scale=10)


def test_sell_debug_dispatcher():
    info = debug_dispatcher("mv", fmt="sell")
    assert info["kid"] == SELL_KID
    assert info["name"] == "xla_sell"


def test_sell_empty_matrix(rng):
    m, n = 9, 9
    ptr = np.zeros(m + 1, dtype=np.int64)
    A = ast.create_csr(m, n, ptr, np.zeros(0, np.int32), np.zeros(0))
    x = rng.standard_normal(n)
    # nnz==0 takes the mv quick exit; build the form directly
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="sell")
    assert form.sell_total == 0
