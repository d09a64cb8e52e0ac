"""Test configuration: run on CPU with 8 virtual devices and x64 enabled.

Mirrors SURVEY.md §4's plan: reference-parity tests need f64/complex128
(CPU), and the multi-chip sharding tests need an 8-device virtual mesh
(XLA_FLAGS --xla_force_host_platform_device_count).

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; whether a card is
present is decided in the ``gpu_device`` fixture, never at import, so every
test worker collects the same tests. On a machine with a card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_csr(rng, m, n, density=0.3, dtype=np.float64, ensure_diag=False, sorted_ind=True):
    """Deterministic random CSR in raw numpy arrays (analog of
    tests/include/aoclsparse_init.hpp:50-320)."""
    mask = rng.random((m, n)) < density
    if ensure_diag:
        for i in range(min(m, n)):
            mask[i, i] = True
    dense = np.zeros((m, n), dtype=dtype)
    vals = rng.standard_normal(mask.sum())
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = vals + 1j * rng.standard_normal(mask.sum())
    dense[mask] = vals.astype(dtype)
    if ensure_diag:
        for i in range(min(m, n)):
            dense[i, i] += m  # diagonally dominant enough for solves
    ptr = np.zeros(m + 1, dtype=np.int32)
    ind = []
    val = []
    for i in range(m):
        cols = np.nonzero(mask[i])[0]
        if not sorted_ind and cols.size > 1:
            cols = cols[rng.permutation(cols.size)]
        ind.extend(cols.tolist())
        val.extend(dense[i, cols].tolist())
        ptr[i + 1] = len(ind)
    return ptr, np.asarray(ind, np.int32), np.asarray(val, dtype), dense


@pytest.fixture
def make_csr(rng):
    def f(m, n, **kw):
        return random_csr(rng, m, n, **kw)

    return f
