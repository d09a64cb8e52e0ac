"""Banded-window SpMV kernel (kernels/xla/spmv.py spmv_bwd) against the
dense oracle, called directly on planner-built operands."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import MatrixDescriptor, Operation
from aoclsparse_tpu.kernels.xla.spmv import spmv_bwd
from aoclsparse_tpu.planner.plan import get_plan
from aoclsparse_tpu.utils.tolerances import assert_allclose_spec


def _banded(rng, m, n, half_bw, row_nnz):
    dense = np.zeros((m, n), dtype=np.float32)
    for i in range(m):
        cs = np.unique(np.clip(i + rng.integers(-half_bw, half_bw + 1, row_nnz), 0, n - 1))
        dense[i, cs] = rng.standard_normal(cs.size)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    ind = np.nonzero(dense)[1].astype(np.int32)
    return ptr, ind, dense[dense != 0], dense


@pytest.mark.parametrize("m,half_bw,TM", [(256, 8, 64), (200, 12, 64), (128, 4, 128)])
def test_pallas_bwd_matches_dense(rng, m, half_bw, TM):
    import jax.numpy as jnp

    ptr, ind, val, dense = _banded(rng, m, m, half_bw, 5)
    A = ast.create_csr(m, m, ptr, ind, val)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    x = rng.standard_normal(m).astype(np.float32)
    xp = jnp.pad(jnp.asarray(x), (form.bwd_padL, form.bwd_n_pad - form.bwd_padL - m))
    y = spmv_bwd(form.bwd_val, xp, form.bwd_W, form.bwd_base8, form.bwd_n_pad)
    assert_allclose_spec(np.asarray(y)[:m], dense @ x, dtype=np.float32, scale=30)


def test_pallas_bwd_negative_base(rng):
    """Window reaching left of column 0 (padL > 0) exercises the x padding."""
    import jax.numpy as jnp

    m = 160
    ptr, ind, val, dense = _banded(rng, m, m, 20, 6)
    A = ast.create_csr(m, m, ptr, ind, val)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind="bwd")
    assert form.bwd_padL > 0 or form.bwd_base8 >= 0
    x = rng.standard_normal(m).astype(np.float32)
    xp = jnp.pad(jnp.asarray(x), (form.bwd_padL, form.bwd_n_pad - form.bwd_padL - m))
    y = spmv_bwd(form.bwd_val, xp, form.bwd_W, form.bwd_base8, form.bwd_n_pad)
    assert_allclose_spec(np.asarray(y)[:m], dense @ x, dtype=np.float32, scale=30)
