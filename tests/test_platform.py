"""Platform decisions: the published-peaks table, compile-cache placement,
removed kernel ids, and the forms every op picks on a GPU context (only XLA
or host forms; no Pallas kernel and no interpret mode anywhere)."""

import ast as pyast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import aoclsparse_tpu as asp
from aoclsparse_tpu import AoclSparseError, MatrixDescriptor, Operation, Status
from aoclsparse_tpu.core import context as ctx_mod

GEN = MatrixDescriptor()
PKG = Path(asp.__file__).resolve().parent
H100 = "NVIDIA H100 80GB HBM3"


def test_peaks_h100_resolves():
    p = ctx_mod.device_peaks(H100)
    assert p.hbm_gbps == 3350.0
    assert p.fp64_tflops == 34.0 and p.fp64_tensor_tflops == 67.0
    assert p.fp32_tflops == 67.0
    assert "H100" in p.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_peaks_unknown_kind_raises(kind):
    with pytest.raises(AoclSparseError) as e:
        ctx_mod.device_peaks(kind)
    assert e.value.status == Status.invalid_value


def test_context_fields_and_cpu_has_no_peaks():
    c = ctx_mod.get_context()
    assert c.platform == "cpu" and c.num_devices >= 1
    assert not hasattr(c, "is_tpu") and not hasattr(c, "pallas_ok")
    with pytest.raises(AoclSparseError):
        c.peaks


def _restore_cache_config():
    import jax

    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs",
    )
    saved = {k: getattr(jax.config, k) for k in keys}

    def restore():
        for k, v in saved.items():
            jax.config.update(k, v)

    return restore


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from aoclsparse_tpu.utils.compile_cache import compile_cache_dir, enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    restore = _restore_cache_config()
    try:
        assert compile_cache_dir() == str(tmp_path)
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        restore()


def test_compile_cache_default_in_checkout(monkeypatch):
    import jax

    from aoclsparse_tpu.utils.compile_cache import (
        DEFAULT_CACHE_DIR,
        compile_cache_dir,
        enable_compile_cache,
    )

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = PKG.parent
    assert DEFAULT_CACHE_DIR.parent == root
    assert compile_cache_dir() == str(DEFAULT_CACHE_DIR)
    ignored = (root / ".gitignore").read_text().split()
    assert DEFAULT_CACHE_DIR.name + "/" in ignored
    restore = _restore_cache_config()
    try:
        assert enable_compile_cache() == str(DEFAULT_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == str(DEFAULT_CACHE_DIR)
    finally:
        restore()


@pytest.mark.parametrize("kid", [8, 12, 13, 14])
def test_removed_mv_kids_invalid_via_force_kid(monkeypatch, rng, kid):
    """AOCLSPARSE_TPU_FORCE_KID naming a removed kernel raises invalid_kid."""
    m = 64
    dense = np.diag(rng.standard_normal(m) + 4.0) + np.diag(rng.standard_normal(m - 1), 1)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    A = asp.create_csr(m, m, ptr, np.nonzero(dense)[1], dense[dense != 0])
    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_KID", str(kid))
    ctx_mod.reset_context()
    try:
        with pytest.raises(AoclSparseError) as e:
            asp.mv(1.0, A, GEN, Operation.none, np.ones(m), 0.0)
        assert e.value.status == Status.invalid_kid
    finally:
        monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_KID")
        ctx_mod.reset_context()


def _kwarg_call_sites(name):
    """(file, line) of every call in the library that passes keyword `name`."""
    hits = []
    for f in PKG.rglob("*.py"):
        tree = pyast.parse(f.read_text())
        for node in pyast.walk(tree):
            if isinstance(node, pyast.Call) and any(k.arg == name for k in node.keywords):
                hits.append((f.relative_to(PKG).as_posix(), node.lineno))
    return hits


#: the Pallas modules a GPU build may import
GPU_PALLAS = {
    "jax.experimental.pallas",
    "jax.experimental.pallas.triton",
    "jax.experimental.pallas.mosaic_gpu",
}


def test_no_interpret_call_sites_and_no_tpu_pallas():
    assert _kwarg_call_sites("interpret") == []
    for f in PKG.rglob("*.py"):
        for node in pyast.walk(pyast.parse(f.read_text())):
            mods = []
            if isinstance(node, pyast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, pyast.ImportFrom) and node.module:
                mods = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            for mod in mods:
                if mod.startswith("jax.experimental.pallas."):
                    assert mod in GPU_PALLAS, (f, mod)
    assert not (PKG / "kernels" / "pallas").exists()


@pytest.fixture
def gpu_context(monkeypatch):
    """The context as it reads on an H100 (the arrays still live on CPU)."""
    ctx_mod.reset_context()
    gpu = dataclasses.replace(ctx_mod.get_context(), platform="gpu", device_kind=H100)
    monkeypatch.setattr(ctx_mod, "_ctx", gpu)
    yield gpu
    ctx_mod.reset_context()


def _fem(rng, m=512, half=9, boost=40.0):
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.clip(i + rng.integers(-half, half + 1, 6), 0, m - 1)
        dense[i, js] = rng.standard_normal(js.size)
    dense = dense + dense.T + boost * np.eye(m)
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    return asp.create_csr(m, m, ptr, np.nonzero(dense)[1], dense[dense != 0]), dense


GATHER_FORMS = ("segsum", "ell", "ellhyb")


def test_gpu_context_mv_and_mm_pick_gather_forms(gpu_context, rng):
    from aoclsparse_tpu.planner.plan import get_plan

    A, dense = _fem(rng)
    x = rng.standard_normal(A.shape[0])
    y = np.asarray(asp.mv(1.0, A, GEN, Operation.none, x, 0.0))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
    form = get_plan(A).exec_form_for(GEN, Operation.none, dtype=A.dtype)
    assert form.kind in GATHER_FORMS
    assert asp.debug_dispatcher("mv", fmt=form.kind)["kid"] in (0, 1, 2)
    B = rng.standard_normal((A.shape[0], 8))
    C = np.asarray(asp.mm(1.0, A, GEN, Operation.none, B, 0.0))
    np.testing.assert_allclose(C, dense @ B, atol=1e-10)


def test_gpu_context_trsv_runs_blocked_scan(gpu_context, rng):
    from aoclsparse_tpu.planner.plan import get_plan
    from aoclsparse_tpu.planner.triangular import trsv_form_for

    A, dense = _fem(rng)
    tri = MatrixDescriptor(type=asp.MatrixType.triangular, fill_mode=asp.FillMode.lower)
    b = rng.standard_normal(A.shape[0])
    x = np.asarray(asp.trsv(1.0, A, tri, Operation.none, b))
    np.testing.assert_allclose(np.tril(dense) @ x, b, atol=1e-9)
    form = trsv_form_for(get_plan(A), tri, Operation.none)
    assert form.kind in ("win", "dwin", "gather")


def test_gpu_context_sp2m_uses_host_or_expansion(gpu_context, rng, monkeypatch):
    monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", raising=False)
    A, dense = _fem(rng, m=256)
    C = asp.sp2m(Operation.none, GEN, A, Operation.none, GEN, A)
    assert C._spgemm_plan.band is None  # no device band engine by default
    m, n, _, ptr, ind, val = asp.export_csr(C)
    got = np.zeros((m, n))
    got[np.repeat(np.arange(m), np.diff(ptr)), ind] = val
    np.testing.assert_allclose(got, dense @ dense, atol=1e-9)


@pytest.mark.parametrize("method,precond", [("cg", "SGS"), ("gmres", "ILU0")])
def test_gpu_context_itsol_solve(gpu_context, rng, method, precond):
    A, dense = _fem(rng)
    b = rng.standard_normal(A.shape[0])
    h = asp.itsol_init(np.float64)
    asp.itsol_option_set(h, "iterative method", method)
    pre = "cg preconditioner" if method == "cg" else "gmres preconditioner"
    asp.itsol_option_set(h, pre, precond)
    x, rinfo, status = asp.itsol_solve(h, A.shape[0], A, GEN, b)
    assert status == Status.success
    assert np.linalg.norm(dense @ np.asarray(x) - b) <= 1e-6 * np.linalg.norm(b)


def test_native_library_keyed_on_source_flags_and_host(monkeypatch):
    """The host library's file name changes with the build flags and with
    the host CPU, so a build made elsewhere (e.g. -march=native on another
    machine) is never loaded."""
    from aoclsparse_tpu import native

    base = native._lib_path()
    assert base.parent == PKG / "native" and base.name.startswith("libaoclsparse_host-")
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ("-DEXTRA",))
    assert native._lib_path() != base
    monkeypatch.undo()
    monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
    assert native._lib_path() != base
    ignored = (PKG.parent / ".gitignore").read_text().split()
    assert "aoclsparse_tpu/native/*.so" in ignored
