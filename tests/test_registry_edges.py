"""Dispatcher white-box tests (reference: dispatcher_tests.cpp:65-333 Oracle
scoring) + edge-case matrix shapes (empty, 1x1, single-row) + RNG/reproducibility
(rng_tests.cpp analog)."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import AoclSparseError, MatrixDescriptor, Operation, Status
from aoclsparse_tpu.kernels.registry import KernelEntry, Registry
from aoclsparse_tpu.utils.tolerances import assert_allclose_spec


def _dummy(*a, **k):
    return None


def test_oracle_exact_backend_wins(monkeypatch):
    r = Registry()
    r.register("op", KernelEntry(0, "generic", _dummy, "f", "any", 0))
    r.register("op", KernelEntry(1, "cpu_special", _dummy, "f", "cpu", 0))
    # the exact-backend row (the context's platform) beats the "any" row
    e = r.select("op", fmt="f")
    assert ast.get_context().platform == "cpu"
    assert e.kid == 1
    # a "gpu" row is its own backend: never chosen on a CPU context
    r.register("op", KernelEntry(2, "gpu_special", _dummy, "f", "gpu", 9))
    assert r.select("op", fmt="f").kid == 1


def test_oracle_tie_highest_kid():
    r = Registry()
    r.register("op", KernelEntry(0, "a", _dummy, "f", "any", 0))
    r.register("op", KernelEntry(7, "b", _dummy, "f", "any", 0))
    assert r.select("op", fmt="f").kid == 7


def test_oracle_priority_beats_kid():
    r = Registry()
    r.register("op", KernelEntry(9, "low", _dummy, "f", "any", 0))
    r.register("op", KernelEntry(1, "high", _dummy, "f", "any", 5))
    assert r.select("op", fmt="f").kid == 1


def test_oracle_format_mismatch_disqualifies():
    r = Registry()
    r.register("op", KernelEntry(0, "a", _dummy, "f", "any", 0))
    with pytest.raises(AoclSparseError) as e:
        r.select("op", fmt="other")
    assert e.value.status == Status.not_implemented


def test_kid_override_and_invalid():
    r = Registry()
    r.register("op", KernelEntry(0, "a", _dummy, "f", "any", 0))
    r.register("op", KernelEntry(1, "b", _dummy, "g", "any", 0))
    assert r.select("op", fmt="f", kid=0).kid == 0
    with pytest.raises(AoclSparseError) as e:
        r.select("op", fmt="f", kid=1)  # wrong format for kid
    assert e.value.status == Status.invalid_kid
    with pytest.raises(AoclSparseError) as e:
        r.select("op", fmt="f", kid=42)
    assert e.value.status == Status.invalid_kid


def test_duplicate_kid_rejected():
    r = Registry()
    r.register("op", KernelEntry(0, "a", _dummy, "f", "any", 0))
    with pytest.raises(ValueError):
        r.register("op", KernelEntry(0, "b", _dummy, "f", "any", 0))


def test_unknown_op():
    r = Registry()
    with pytest.raises(AoclSparseError) as e:
        r.select("nope")
    assert e.value.status == Status.not_implemented


# ---------------------------------------------------------------------------
# edge-case shapes
# ---------------------------------------------------------------------------


def test_empty_matrix_mv():
    A = ast.create_csr(3, 3, np.zeros(4, np.int32), np.zeros(0, np.int32), np.zeros(0))
    y = ast.mv(2.0, A, MatrixDescriptor(), Operation.none, np.ones(3), 3.0, np.ones(3))
    assert_allclose_spec(y, 3.0 * np.ones(3))


def test_1x1_ops(rng):
    A = ast.create_csr(1, 1, [0, 1], [0], [4.0])
    y = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, np.array([2.0]), 0.0)
    assert float(np.asarray(y)[0]) == 8.0
    x = ast.trsv(
        1.0,
        A,
        MatrixDescriptor(type=ast.MatrixType.triangular),
        Operation.none,
        np.array([8.0]),
    )
    assert abs(float(np.asarray(x)[0]) - 2.0) < 1e-12
    C = ast.spmm(A, A)
    assert C.nnz == 1


def test_single_row_matrix(rng):
    A = ast.create_csr(1, 5, [0, 3], [0, 2, 4], [1.0, 2.0, 3.0])
    x = rng.standard_normal(5)
    y = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0)
    assert_allclose_spec(np.asarray(y), [x[0] + 2 * x[2] + 3 * x[4]])
    # transpose of the single row
    yt = ast.mv(1.0, A, MatrixDescriptor(), Operation.transpose, np.array([2.0]), 0.0)
    want = np.zeros(5)
    want[[0, 2, 4]] = [2.0, 4.0, 6.0]
    assert_allclose_spec(np.asarray(yt), want)


def test_one_based_flow_through_ops(rng):
    # reference sample-style 1-based input exercised through mv + trsv
    ptr = np.array([1, 3, 4, 6])
    ind = np.array([1, 3, 2, 1, 3])
    val = np.array([4.0, 2.0, 3.0, 1.0, 5.0])
    A = ast.create_csr(3, 3, ptr, ind, val, base=ast.IndexBase.one)
    dense = np.array([[4, 0, 2], [0, 3, 0], [1, 0, 5.0]])
    x = rng.standard_normal(3)
    # descriptor base must match the handle base (reference parity,
    # aoclsparse_mv.cpp:71-73)
    y = ast.mv(1.0, A, MatrixDescriptor(base=1), Operation.none, x, 0.0)
    assert_allclose_spec(np.asarray(y), dense @ x)
    xs = ast.trsv(
        1.0,
        A,
        MatrixDescriptor(type=ast.MatrixType.triangular, base=1),
        Operation.none,
        np.array([4.0, 3.0, 6.0]),
    )
    want = np.linalg.solve(np.tril(dense), [4.0, 3.0, 6.0])
    assert_allclose_spec(np.asarray(xs), want)


def test_duplicate_entries_merge_consistently(rng):
    """Duplicate (row, col) inputs must SUM across every execution form and
    survive update_values (dense-oracle semantics; regression for the
    scatter-form last-write bug)."""
    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.utils.reference import ref_mv
    import jax.numpy as jnp

    m = 64
    ptr = np.arange(m + 1) * 4
    base = np.clip(np.arange(m)[:, None] + np.array([[-1, 0, 0, 1]]), 0, m - 1)
    ind = base.reshape(-1).astype(np.int32)  # col dup in every row
    val = rng.standard_normal(m * 4)
    A = ast.create_csr(m, m, ptr, ind, val)
    x = rng.standard_normal(m)
    want = ref_mv(1.0, m, m, ptr, ind, val, MatrixDescriptor(), Operation.none, x, 0.0, np.zeros(m))
    for kind in ["segsum", "ell", "bwd", "diag"]:
        form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind=kind)
        from aoclsparse_tpu.ops.level2.mv import _run_exec_form

        got = np.asarray(_run_exec_form(form, jnp.asarray(x), None))
        assert_allclose_spec(got, want, err_msg=kind)
    ast.update_values(A, np.asarray(val) * -1.0)
    for kind in ["segsum", "bwd"]:
        form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none, kind=kind)
        from aoclsparse_tpu.ops.level2.mv import _run_exec_form

        got = np.asarray(_run_exec_form(form, jnp.asarray(x), None))
        assert_allclose_spec(got, -want, err_msg=f"refresh-{kind}")


def test_rng_reproducibility():
    """rng_tests.cpp analog: the test-fixture generator is deterministic."""
    from conftest import random_csr

    a = random_csr(np.random.default_rng(123), 10, 10, density=0.3)
    b = random_csr(np.random.default_rng(123), 10, 10, density=0.3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_hint_validation_errors(rng):
    from conftest import random_csr

    ptr, ind, val, _ = random_csr(rng, 4, 4)
    A = ast.create_csr(4, 4, ptr, ind, val)
    with pytest.raises(AoclSparseError) as e:
        ast.set_mv_hint(None, Operation.none, MatrixDescriptor())
    assert e.value.status == Status.invalid_pointer
    with pytest.raises(AoclSparseError) as e:
        ast.set_mv_hint(A, Operation.none, MatrixDescriptor(), nop=-1)
    assert e.value.status == Status.invalid_value
    with pytest.raises(ValueError):
        ast.set_mv_hint(A, 999, MatrixDescriptor())


def test_set_value_and_pattern_miss(rng):
    from conftest import random_csr

    ptr, ind, val, dense = random_csr(rng, 5, 5, density=0.4, ensure_diag=True)
    A = ast.create_csr(5, 5, ptr, ind, val)
    ast.set_value(A, 0, 0, 99.0)
    m, n, nnz, p2, i2, v2 = ast.export_csr(A)
    from aoclsparse_tpu.utils.reference import csr_to_dense

    assert csr_to_dense(m, n, p2, i2, v2)[0, 0] == 99.0
    # a position outside the pattern must raise invalid_index_value
    zero_positions = np.argwhere(dense == 0)
    if zero_positions.size:
        i, j = zero_positions[0]
        with pytest.raises(AoclSparseError) as e:
            ast.set_value(A, int(i), int(j), 1.0)
        assert e.value.status == Status.invalid_index_value
