"""chip_smoke.py: its device gate fails on a CPU, and each phase function runs
at tiny size through the public API and agrees with scipy within the printed
tolerance. The card run itself is `python chip_smoke.py` on a GPU."""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from benchmarks import realmat  # noqa: E402


def _fem(nx=20, ny=12, dof=3, boost=80.0, seed=7):
    rng = np.random.default_rng(seed)
    offs = [(dx, dy, 0, False) for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)]
    r, c = realmat._grid_block_mesh((nx, ny, 1), dof, offs, rng)
    m = nx * ny * dof
    return realmat._finish(r, c, m, m, rng, boost, sym_vals=True)


def _irregular(m=900, boost=80.0, seed=3):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m, 4 * m)
    c = rng.integers(0, m, 4 * m)
    rr, cc = np.concatenate([r, c]), np.concatenate([c, r])
    return realmat._finish(rr, cc, m, m, rng, boost, sym_vals=False)


@pytest.fixture(scope="module")
def smoke():
    return cs.Smoke(reps=2, out=io.StringIO())


def _check(smoke, rec):
    assert rec["ok"], rec
    assert rec["err"] <= rec["tol"]
    line = json.loads(smoke.out.getvalue().strip().splitlines()[-1])
    assert line["phase"] == rec["phase"] and line["ok"] is True
    for key in ("plan_s", "first_call_s", "steady_s", "compile_s", "form"):
        assert key in rec


def test_require_gpu_fails_on_cpu():
    with pytest.raises(SystemExit):
        cs.require_gpu()


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_main_exits_nonzero_without_gpu():
    out = _run_script(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "GPU" in out.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", [None, "bwd", "diag"])
def test_phase_mv(smoke, dtype, kind):
    rec = smoke.mv("fem", _fem(), dtype, kind=kind)
    _check(smoke, rec)
    assert rec["form"] == (kind or "ell")


def test_phase_mv_irregular(smoke):
    rec = smoke.mv("irregular", _irregular(), np.float32)
    _check(smoke, rec)
    assert rec["form"] in ("ell", "ellhyb")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_phase_mm(smoke, dtype):
    _check(smoke, smoke.mm("fem", _fem(), dtype, k=8))


def test_phase_trsv(smoke):
    _check(smoke, smoke.trsv("fem", _fem()))


def test_phase_sp2m(smoke):
    rec = smoke.sp2m("fem", _fem())
    _check(smoke, rec)
    assert rec["nnz_c"] > 0


@pytest.mark.parametrize("method,precond,mat", [("cg", "SGS", "fem"), ("gmres", "ILU0", "irr")])
def test_phase_itsol(smoke, method, precond, mat):
    A = _fem() if mat == "fem" else _irregular()
    rec = smoke.itsol(mat, A, method, precond)
    _check(smoke, rec)
    assert rec["iters"] >= 1


def test_phase_dist_four_devices(smoke):
    """The --four phases on four virtual CPU devices: halo SpMV and halo CG
    agree with the one-device path and with scipy."""
    n0 = len(smoke.failures)
    smoke.dist("fem", _fem(nx=32, ny=16), 4)
    lines = [json.loads(x) for x in smoke.out.getvalue().strip().splitlines()[-2:]]
    assert [x["phase"] for x in lines] == ["dist_spmv_bwd_halo", "dist_cg_bwd_halo"]
    assert all(x["ok"] for x in lines), lines
    assert lines[0]["err_vs_one_card"] <= lines[0]["tol"]
    assert lines[1]["x_diff_vs_one_card"] < 1e-6
    assert len(smoke.failures) == n0


@pytest.fixture(scope="module")
def pwtk_f32():
    """The smoke's own f32 operand: the pwtk stand-in with its diagonal boost."""
    m, n, ptr, ind, val = realmat.generate("pwtk", diag_boost=cs.DIAG_BOOST)
    return m, n, ptr, ind, val.astype(np.float32)


def _tf32(v, mode):
    """float32 -> TF32 (10 explicit mantissa bits), as a tensor core reads its
    operands: round to nearest even, or truncate."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32).astype(np.uint64)
    if mode == "rne":
        u = u + 0x0FFF + ((u >> 13) & 1)
    return (u & 0xFFFFE000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("mode", ["rne", "trunc"])
@pytest.mark.parametrize("k", [None, 8])
def test_tolerance_rejects_tf32_rounding(pwtk_f32, mode, k):
    """On the smoke's f32 operand (boosted pwtk stand-in, full size) an f32
    product passes the f32 product tolerance and the same product with TF32
    operands fails it, for the mv and the mm phase's shapes."""
    import scipy.sparse as sp

    from aoclsparse_tpu.utils.tolerances import expected_precision

    m, n, ptr, ind, v32 = pwtk_f32
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n if k is None else (n, k)).astype(np.float32)
    ref = sp.csr_matrix((v32.astype(np.float64), ind, ptr), shape=(m, n)) @ x.astype(np.float64)
    got_f32 = sp.csr_matrix((v32, ind, ptr), shape=(m, n)) @ x
    At = sp.csr_matrix((_tf32(v32, mode).astype(np.float64), ind, ptr), shape=(m, n))
    got_tf32 = At @ _tf32(x, mode).astype(np.float64)
    tol = expected_precision(np.float32, cs.PRODUCT_SCALE)
    assert cs.max_rel_err(got_f32, ref) <= tol
    assert cs.max_rel_err(got_tf32, ref) > 4 * tol


def test_failed_phase_is_recorded(smoke):
    """A phase that raises is reported and marks the run failed."""
    n0 = len(smoke.failures)
    bad = (4, 4, np.array([0, 1, 2, 3]), np.array([0, 1, 2]), np.ones(3))  # corrupt ptr
    rec = smoke.mv("corrupt", bad, np.float64)
    assert rec["ok"] is False and "error" in rec
    assert len(smoke.failures) == n0 + 1


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device):
    """Every one-card phase at tiny size on the card (run with -m gpu)."""
    smoke = cs.Smoke(reps=2, out=io.StringIO())
    for dt in (np.float32, np.float64):
        smoke.mv("fem", _fem(), dt)
        smoke.mm("fem", _fem(), dt, k=8)
    smoke.trsv("fem", _fem())
    smoke.sp2m("fem", _fem())
    smoke.itsol("fem", _fem(), "cg", "SGS")
    smoke.itsol("irr", _irregular(), "gmres", "ILU0")
    assert smoke.failures == [], smoke.out.getvalue()
