"""Planner-state persistence (io/plancache.py): snapshot exec forms +
autotune pins, restore onto a fresh handle of the same structure with
values re-derived from the live handle."""

import os
import tempfile

import numpy as np
import pytest

import aoclsparse_tpu as ast

from conftest import random_csr
from aoclsparse_tpu import AoclSparseError, MatrixDescriptor, Operation, Status
from aoclsparse_tpu.io.plancache import load_plan, save_plan
from aoclsparse_tpu.planner.plan import get_plan

GEN = MatrixDescriptor()


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _circuitish(rng, m):
    rows = np.repeat(np.arange(m), 4)
    cols = np.clip(rows + rng.integers(-8, 9, rows.size), 0, m - 1)
    hub_r = rng.integers(0, m, m // 2)
    r = np.concatenate([rows, hub_r])
    c = np.concatenate([cols, np.full(m // 2, 7)])
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.ones(r.size, bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    r, c = r[keep], c[keep]
    val = rng.standard_normal(r.size)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=m))])
    dense = np.zeros((m, m))
    dense[r, c] = val
    return ptr, c, val, dense


def test_save_load_roundtrip_values_from_live_handle(rng):
    m = 2048
    ptr, c, val, dense = _circuitish(rng, m)
    A = ast.create_csr(m, m, ptr, c, val)
    form = get_plan(A).exec_form_for(GEN, Operation.none, dtype=A.dtype)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "plan.npz")
        save_plan(A, p)
        # fresh handle, same structure, DIFFERENT values: the snapshot's
        # values must not leak in
        B = ast.create_csr(m, m, ptr, c, val * 3)
        n = load_plan(B, p)
        assert n >= 1
        formB = get_plan(B).exec_form_for(GEN, Operation.none, dtype=B.dtype)
        assert formB.kind == form.kind
        x = rng.standard_normal(m)
        y = ast.mv(1.0, B, GEN, Operation.none, x, 0.0)
        np.testing.assert_allclose(np.asarray(y), 3 * dense @ x, atol=1e-8)
        # restored forms stay refreshable
        ast.update_values(B, val)
        y2 = ast.mv(1.0, B, GEN, Operation.none, x, 0.0)
        np.testing.assert_allclose(np.asarray(y2), dense @ x, atol=1e-8)


def test_load_rejects_different_structure(rng):
    m = 256
    ptr, c, val, _ = _circuitish(rng, m)
    A = ast.create_csr(m, m, ptr, c, val)
    get_plan(A).exec_form_for(GEN, Operation.none, dtype=A.dtype)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "plan.npz")
        save_plan(A, p)
        C = ast.create_csr(m, m, ptr, np.clip(c + 1, 0, m - 1), val)
        with pytest.raises(AoclSparseError) as e:
            load_plan(C, p)
        assert e.value.status == Status.invalid_value


def test_save_load_preserves_autotune_pins(rng):
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
    t = ast.autotune_trsv(A, low, nb_candidates=(128, 256), iters=1, chunks=1)
    winner = min(t, key=t.get)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "plan.npz")
        save_plan(A, p)
        B = ast.create_csr(m, m, ptr, np.nonzero(mask)[1], dense[mask])
        load_plan(B, p)
        if winner in ("level", "host"):
            # engine winners pin _trsv_engine, not a block size
            key = (low.fill_mode, low.diag_type, Operation.none)
            assert get_plan(B)._trsv_engine.get(key) == winner
        else:
            form = trsv_form_for(get_plan(B), low, Operation.none)
            assert form.nb == winner
        b = rng.standard_normal(m)
        x = ast.trsv(1.0, B, low, Operation.none, b)
        np.testing.assert_allclose(dense @ np.asarray(x), b, atol=1e-8)


def test_gen_form_snapshot_roundtrip(rng, monkeypatch):
    """The expensive case the cache exists for: the gen composite's RCM/
    hub/spill analysis restores without re-running (simulated GPU context;
    the gen kind is requested explicitly)."""
    import dataclasses

    import aoclsparse_tpu.core.context as ctx_mod
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    ctx_mod._ctx = dataclasses.replace(ctx_mod.get_context(), platform="gpu")
    try:
        m = 4096
        ptr, c, val, dense = _circuitish(rng, m)
        A = ast.create_csr(m, m, ptr, c, val.astype(np.float32))
        form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen", dtype=A.dtype)
        if form is None or form.kind != "gen":
            pytest.skip("gen composite rejected this structure")
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "plan.npz")
            save_plan(A, p)
            B = ast.create_csr(m, m, ptr, c, val.astype(np.float32))
            n = load_plan(B, p)
            assert n >= 1
            formB = get_plan(B).exec_forms[
                (GEN.type, GEN.fill_mode, GEN.diag_type, Operation.none, "gen")
            ]
            assert formB.kind == "gen"
            x = rng.standard_normal(m).astype(np.float32)
            from aoclsparse_tpu.ops.level2.mv import _run_exec_form

            y = _run_exec_form(formB, np.asarray(x), None)
            np.testing.assert_allclose(
                np.asarray(y), dense @ x.astype(np.float64), rtol=2e-4, atol=2e-3
            )
    finally:
        reset_context()


def test_save_load_bare_path(rng):
    """A path without .npz works for both save and load (np.savez appends
    the extension; load must stay symmetric)."""
    m = 128
    ptr, c, val, dense = _circuitish(rng, m)
    A = ast.create_csr(m, m, ptr, c, val)
    get_plan(A).exec_form_for(GEN, Operation.none, dtype=A.dtype)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "plan")  # no extension
        save_plan(A, p)
        B = ast.create_csr(m, m, ptr, c, val)
        assert load_plan(B, p) >= 1


def test_snapshot_persists_mm_tuned_pin(rng, tmp_path):
    """autotune_mm pins survive a plan snapshot round-trip like the
    trsv/mv pins."""
    from aoclsparse_tpu.io.plancache import load_plan, save_plan
    from aoclsparse_tpu.planner.plan import get_plan

    m, k = 64, 8
    ptr, ind, val, dense = random_csr(rng, m, m, density=0.3)
    A = ast.create_csr(m, m, ptr, ind, val)
    from aoclsparse_tpu.kernels.autotune import autotune_mm

    autotune_mm(A, k=k, iters=1, chunks=1)
    pin = dict(get_plan(A)._mm_tuned)
    assert pin
    p = tmp_path / "plan.npz"
    save_plan(A, str(p))
    A2 = ast.create_csr(m, m, ptr, ind, val)
    load_plan(A2, str(p))
    assert getattr(get_plan(A2), "_mm_tuned", None) == pin
