"""Empirical kernel auto-tuning (kernels/autotune.py): the measured Oracle
(SURVEY.md §7 "autotuned defaults"; static scoring analog:
cntx_dispatcher.hpp:272-364)."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import AoclSparseError, MatrixDescriptor, Operation, Status
from aoclsparse_tpu.planner.plan import get_plan


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _band(rng, m, half=8, per=5):
    base = np.clip(np.arange(m) - half, 0, m - 2 * half)
    pick = np.argsort(rng.random((m, 2 * half)), axis=1)[:, :per]
    cols = np.sort(base[:, None] + pick, axis=1)
    ptr = np.arange(m + 1) * per
    val = rng.standard_normal(m * per)
    dense = np.zeros((m, m))
    dense[np.repeat(np.arange(m), per), cols.reshape(-1)] = val
    return ast.create_csr(m, m, ptr, cols.reshape(-1), val), dense


def test_autotune_times_pins_and_refreshes(rng):
    A, dense = _band(rng, 2048)
    t = ast.autotune_mv(A, iters=2, chunks=2)
    assert len(t) >= 3 and all(v > 0 for v in t.values())
    winner = min(t, key=t.get)
    form = get_plan(A).exec_form_for(MatrixDescriptor(), Operation.none)
    if winner == "host":
        # host engine winners pin _mv_engine; the auto slot keeps the best
        # DEVICE form for traced callers (fused solvers)
        key4 = (
            MatrixDescriptor().type,
            MatrixDescriptor().fill_mode,
            MatrixDescriptor().diag_type,
            Operation.none,
        )
        assert get_plan(A)._mv_engine.get(key4) == "host"
        assert form.kind != "host"
    else:
        assert form.kind == winner
    x = rng.standard_normal(2048)
    y = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0)
    np.testing.assert_allclose(np.asarray(y), dense @ x, atol=1e-8)
    # the tuned form must stay value-refreshable
    _, _, _, ptr, ind, val = ast.export_csr(A)
    ast.update_values(A, np.asarray(val) * 3)
    y3 = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0)
    np.testing.assert_allclose(np.asarray(y3), 3 * dense @ x, atol=1e-8)


def test_autotune_kind_subset_and_transpose(rng):
    A, dense = _band(rng, 1024)
    t = ast.autotune_mv(A, iters=2, chunks=1, kinds=("ell", "segsum"))
    assert set(t) <= {"ell", "segsum"}
    # transpose tuning pins the transpose slot, not the none slot
    t2 = ast.autotune_mv(A, op=Operation.transpose, iters=2, chunks=1, kinds=("ell", "segsum"))
    x = rng.standard_normal(1024)
    yt = ast.mv(1.0, A, MatrixDescriptor(), Operation.transpose, x, 0.0)
    np.testing.assert_allclose(np.asarray(yt), dense.T @ x, atol=1e-8)


def test_autotune_null_handle():
    with pytest.raises(AoclSparseError) as e:
        ast.autotune_mv(None)
    assert e.value.status == Status.invalid_pointer


def test_autotune_trsv_pins_block_size(rng):
    from aoclsparse_tpu.core.types import MatrixType
    from aoclsparse_tpu.planner.triangular import trsv_form_for

    m = 1536
    dense = np.tril(
        rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.01), -1
    ) + np.diag(4 + rng.random(m))
    mask = dense != 0
    ptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
    A = ast.create_csr(m, m, ptr, np.nonzero(mask)[1], dense[mask])
    low = MatrixDescriptor().with_(type=MatrixType.triangular)
    t = ast.autotune_trsv(A, low, nb_candidates=(128, 256), iters=2, chunks=1)
    assert set(t) <= {128, 256, "level", "host"} and (set(t) & {128, 256})
    winner = min(t, key=t.get)
    if winner in ("level", "host"):
        # engine won: the dispatch pin routes trsv() to KID 1 / the host path
        assert get_plan(A)._trsv_engine
    else:
        form = trsv_form_for(get_plan(A), low, Operation.none)
        assert form.nb == winner
    # solve still correct with the pinned size
    b = rng.standard_normal(m)
    x = ast.trsv(1.0, A, low, Operation.none, b)
    np.testing.assert_allclose(dense @ np.asarray(x), b, atol=1e-8)
    # an explicit nb still overrides the pin
    f512 = trsv_form_for(get_plan(A), low, Operation.none, nb=512)
    assert f512.nb == 512


def test_autotune_trsv_small_matrix(rng):
    """m below every candidate: nb clamps to m instead of internal_error."""
    from aoclsparse_tpu.core.types import MatrixType

    m = 100
    dense = np.tril(rng.standard_normal((m, m)), -1) * 0.1 + np.diag(3 + rng.random(m))
    mask = dense != 0
    ptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
    A = ast.create_csr(m, m, ptr, np.nonzero(mask)[1], dense[mask])
    low = MatrixDescriptor().with_(type=MatrixType.triangular)
    t = ast.autotune_trsv(A, low, iters=1, chunks=1)
    assert t  # at least one clamped candidate timed
    b = rng.standard_normal(m)
    x = ast.trsv(1.0, A, low, Operation.none, b)
    np.testing.assert_allclose(dense @ np.asarray(x), b, atol=1e-8)


def test_autotune_mv_transpose_probe_length(rng):
    """op=transpose on a rectangular matrix: the probe vector length is the
    effective column count (op folded into the structure), not eff rows."""
    m, n = 96, 40
    lens = np.full(m, 3)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([np.sort(rng.choice(n, 3, replace=False)) for _ in range(m)])
    val = rng.standard_normal(3 * m)
    A = ast.create_csr(m, n, ptr, cols, val)
    t = ast.autotune_mv(A, op=Operation.transpose, iters=1, chunks=1, kinds=("segsum", "ell"))
    assert t  # a mis-sized probe would clamp silently; here it must just run
    dense = np.zeros((m, n))
    dense[np.repeat(np.arange(m), 3), cols] = val
    x = rng.standard_normal(m)
    yt = ast.mv(1.0, A, MatrixDescriptor(), Operation.transpose, x, 0.0)
    np.testing.assert_allclose(np.asarray(yt), dense.T @ x, atol=1e-8)


def test_optimize_autotune_env(rng, monkeypatch):
    """AOCLSPARSE_TPU_AUTOTUNE=1: optimize() measures heavily-hinted mv ops
    and pins the winner; below the nop threshold the cost model is used."""
    monkeypatch.setenv("AOCLSPARSE_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("AOCLSPARSE_TPU_AUTOTUNE_NOP", "100")
    A, dense = _band(rng, 1024)
    ast.set_mv_hint(A, Operation.none, MatrixDescriptor(), nop=500)
    ast.optimize(A)
    # the measured winner must already sit in the kind=None cache slot —
    # exec_form_for would build one on demand, so assert the slot directly
    d = MatrixDescriptor()
    key = (d.type, d.fill_mode, d.diag_type, Operation.none, None)
    assert key in get_plan(A).exec_forms
    form = get_plan(A).exec_forms[key]
    x = rng.standard_normal(1024)
    y = ast.mv(1.0, A, MatrixDescriptor(), Operation.none, x, 0.0)
    np.testing.assert_allclose(np.asarray(y), dense @ x, atol=1e-8)
    # below threshold: no measurement, plain cost-model prebuild
    B, dense_b = _band(rng, 512)
    ast.set_mv_hint(B, Operation.none, MatrixDescriptor(), nop=10)
    ast.optimize(B)
    yb = ast.mv(1.0, B, MatrixDescriptor(), Operation.none, np.ones(512), 0.0)
    np.testing.assert_allclose(np.asarray(yb), dense_b @ np.ones(512), atol=1e-8)


def test_autotune_mm_pins_and_dispatches(rng):
    """autotune_mm times the mm forms and pins the winner for (descr,op,k);
    a subsequent mm with no kid dispatches the pinned form."""
    A, dense = _band(rng, 512)
    t = ast.autotune_mm(A, k=8, iters=1, chunks=1, kinds=("ell", "ellhyb", "segsum"))
    assert t and all(v > 0 for v in t.values())
    winner = min(t, key=t.get)
    plan = get_plan(A)
    d = MatrixDescriptor()
    assert plan._mm_tuned[(d.type, d.fill_mode, d.diag_type, Operation.none, 8)] == winner
    B = rng.standard_normal((512, 8))
    C = ast.mm(1.0, A, d, Operation.none, B, 0.0)
    np.testing.assert_allclose(np.asarray(C), dense @ B, atol=1e-8)
    # a different RHS width is not pinned (bandtm eligibility is k-dependent)
    C2 = ast.mm(1.0, A, d, Operation.none, rng.standard_normal((512, 3)), 0.0)
    assert C2.shape == (512, 3)


def test_mm_after_autotune_mv_incompatible_form(rng):
    """Regression: autotune_mv can plant a diag/bandt/gen form in the
    kind=None plan slot; mm has no kernel rows for those and must fall back
    to a gather form instead of raising not_implemented."""
    A, dense = _band(rng, 512)
    ast.autotune_mv(A, iters=1, chunks=1, kinds=("diag", "bwd"))
    B = rng.standard_normal((512, 4))
    C = ast.mm(1.0, A, MatrixDescriptor(), Operation.none, B, 0.0)
    np.testing.assert_allclose(np.asarray(C), dense @ B, atol=1e-8)


def test_autotune_spgemm_engines_and_finalize(rng, monkeypatch):
    """autotune_spgemm measures both numeric engines, pins the winner on the
    staged plan, and finalize reproduces the product under the pin."""
    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")
    from aoclsparse_tpu.core.types import Request

    A, dA = _band(rng, 256)
    B, dB = _band(rng, 256)
    C, t = ast.autotune_spgemm(A, B, iters=1, chunks=1)
    assert "expand" in t
    plan = C._spgemm_plan
    # whichever engine won, finalize must agree with the dense product
    d = MatrixDescriptor()
    C = ast.sp2m(Operation.none, d, A, Operation.none, d, B, request=Request.finalize, C=C)
    mC, nC, _, ptr, ind, val = ast.export_csr(C)
    got = np.zeros((mC, nC))
    got[np.repeat(np.arange(mC), np.diff(ptr)), np.asarray(ind)] = np.asarray(val)
    np.testing.assert_allclose(got, dA @ dB, atol=1e-8)
    # the pin is deterministic: band stays attached iff it beat every other
    # numeric engine (expand, and host when the native library is present)
    engines = {k: v for k, v in t.items() if k in ("expand", "band", "host")}
    assert (plan.band is not None) == (min(engines, key=engines.get) == "band")


def test_autotune_trsv_level_candidate(rng):
    """autotune_trsv times the level-scheduled engine alongside the blocked
    block sizes; a level win pins the engine and plain trsv() dispatch
    follows the pin (value-refresh keeps parity: plan.levels rebuilds)."""
    from aoclsparse_tpu.core.types import DiagType, FillMode, MatrixType
    from aoclsparse_tpu.kernels.autotune import autotune_trsv
    from aoclsparse_tpu.planner.plan import get_plan

    m = 96
    full = np.tril(rng.random((m, m)) < 0.05) * rng.standard_normal((m, m))
    np.fill_diagonal(full, 2.0 + rng.random(m))
    ptr = np.concatenate([[0], np.cumsum((full != 0).sum(1))]).astype(np.int64)
    ind = np.nonzero(full)[1].astype(np.int32)
    A = ast.create_csr(m, m, ptr, ind, full[full != 0])
    D = MatrixDescriptor(
        type=MatrixType.triangular, fill_mode=FillMode.lower, diag_type=DiagType.non_unit
    )
    res = autotune_trsv(A, D, Operation.none, iters=2, chunks=1)
    assert "level" in res
    b = rng.standard_normal(m)
    x = np.asarray(ast.trsv(1.0, A, D, Operation.none, b))
    x0 = np.asarray(ast.trsv(1.0, A, D, Operation.none, b, kid=0))
    np.testing.assert_allclose(x, x0, rtol=1e-12, atol=1e-12)
    # values update: dispatch (pinned or not) still tracks the fresh values
    _, _, _, p2, i2, v2 = ast.export_csr(A)
    ast.update_values(A, np.asarray(v2) * 3.0)
    x1 = np.asarray(ast.trsv(1.0, A, D, Operation.none, b))
    x2 = np.asarray(ast.trsv(1.0, A, D, Operation.none, b, kid=0))
    np.testing.assert_allclose(x1, x2, rtol=1e-12, atol=1e-12)
