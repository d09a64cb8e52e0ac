"""benchmarks/form_compare.py at tiny size on the CPU: every form's chained
application agrees with the ell form's, and the timing fields are filled.
The card run is `python benchmarks/form_compare.py` on a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import form_compare as fc  # noqa: E402
from benchmarks import realmat  # noqa: E402


def _fem(nx=16, ny=10, dof=3, seed=7):
    rng = np.random.default_rng(seed)
    offs = [(dx, dy, 0, False) for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)]
    r, c = realmat._grid_block_mesh((nx, ny, 1), dof, offs, rng)
    m = nx * ny * dof
    return realmat._finish(r, c, m, m, rng, 80.0, sym_vals=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compare_forms_agree(dtype):
    import jax

    jax.config.update("jax_enable_x64", True)
    recs = fc.compare_forms(_fem(), dtype, chain=4, reps=2, e2e_reps=2)
    assert [r["form"] for r in recs] == list(fc.KINDS)
    assert [r["kid"] for r in recs] == [1, 6, 5]
    for r in recs:
        assert r["agree"] <= r["tol"], r
        assert r["device_us"] > 0 and r["e2e_us"] > 0


def test_host_floor_positive():
    assert fc.host_floor(reps=3) > 0


def test_main_exits_nonzero_without_gpu():
    out = subprocess.run(
        [sys.executable, "benchmarks/form_compare.py"], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""
