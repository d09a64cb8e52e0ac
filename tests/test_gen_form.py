"""General-sparsity execution form (gen = hub slab + block/element RCM band +
COO spill; VERDICT.md round-1 item #1). The reference's SpMV is fast on every
structure via x86 gathers (level2/aoclsparse_csrmv_kt.cpp:31-108); the gen
form reaches the same coverage by *making* matrices band-compressible. These
tests pin oracle parity on the structure classes of the reference's matrix
suite (tests/benchmarks/matrices/matrixlist): circuit-like (hubs + locality),
scrambled band (element RCM), and value-refresh through update_values."""

import numpy as np
import pytest

import aoclsparse_tpu as ast
from aoclsparse_tpu import AoclSparseError, MatrixDescriptor, Operation, Status
from aoclsparse_tpu.core.types import FillMode, MatrixType
from aoclsparse_tpu.planner.plan import get_plan

GEN = MatrixDescriptor()


def _mk(m, dense):
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    ind = np.nonzero(dense)[1].astype(np.int32)
    return ast.create_csr(m, m, ptr, ind, dense[dense != 0])


def _circuit_like(rng, m=1024, hubs=5, scatter=200):
    """scircuit-class profile: local banded coupling + a few dense columns
    (power rails) + random off-structure entries."""
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-10, 11, 6), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    for h in rng.choice(m, hubs, replace=False):
        rs = rng.choice(m, m // 3, replace=False)
        dense[rs, h] = rng.standard_normal(rs.size)
    ri, rj = rng.integers(0, m, scatter), rng.integers(0, m, scatter)
    dense[ri, rj] = rng.standard_normal(scatter)
    return dense


def test_gen_circuit_profile_parity(rng):
    m = 1024
    dense = _circuit_like(rng, m)
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
    assert form.kind == "gen"
    assert form.hub_cols is not None and int(form.hub_cols.shape[0]) >= 1
    # the band must be narrow relative to m (hub extraction + RCM worked)
    assert form.bwd_W <= m // 4


def test_gen_alpha_beta_ops(rng):
    m = 1024
    dense = _circuit_like(rng, m)
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    y0 = rng.standard_normal(m)
    y = np.asarray(ast.mv(2.5, A, GEN, Operation.transpose, x, -0.5, y=y0.copy(), kid=7))
    np.testing.assert_allclose(y, 2.5 * dense.T @ x - 0.5 * y0, atol=1e-10)


def test_gen_scrambled_band_element_rcm(rng):
    # element-level permutation of a narrow band: block-quotient RCM sees no
    # structure, the element-granular ladder step must recover it
    m = 2048
    p = rng.permutation(m)
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.clip(i + rng.integers(-8, 9, 5), 0, m - 1)
        dense[p[i], p[js]] = rng.standard_normal(js.size)
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
    assert form.gen_B == 1  # element granularity chosen
    assert form.bwd_W <= 128  # band recovered


def test_gen_update_values_refresh(rng):
    m = 1024
    dense = _circuit_like(rng, m)
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    _ = ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7)  # build the form
    v2 = rng.standard_normal(A.nnz)
    ast.update_values(A, v2)
    ptr, ind = np.asarray(A.data.ptr), np.asarray(A.data.ind)
    d2 = np.zeros((m, m))
    d2[np.repeat(np.arange(m), np.diff(ptr)), ind] = v2
    y2 = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y2, d2 @ x, atol=1e-10)


def test_gen_symmetric_descriptor(rng):
    m = 512
    dense = _circuit_like(rng, m, hubs=2, scatter=50)
    up = np.triu(dense + dense.T)
    A = _mk(m, up)
    sym = MatrixDescriptor(type=MatrixType.symmetric, fill_mode=FillMode.upper)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, sym, Operation.none, x, 0.0, kid=7))
    full = np.triu(up) + np.triu(up, 1).T
    np.testing.assert_allclose(y, full @ x, atol=1e-10)


def test_gen_rejects_uniform_random_structure(rng):
    # webbase-worst-case: uniformly random columns, no hubs, no locality —
    # the builder must reject (every granularity blows the caps) and the
    # explicit-KID path must surface invalid_kid like the reference's
    # KID validation (cntx_dispatcher.hpp:272-364)
    m = 2048
    nnz_row = 3
    cols = rng.integers(0, m, (m, nnz_row))
    dense = np.zeros((m, m))
    for i in range(m):
        dense[i, cols[i]] = rng.standard_normal(nnz_row)
    A = _mk(m, dense)
    from aoclsparse_tpu.planner.plan import _build_gen

    eff = get_plan(A).effective_for(GEN, Operation.none, A.dtype)
    assert _build_gen(eff) is None
    with pytest.raises(AoclSparseError) as e:
        ast.mv(1.0, A, GEN, Operation.none, rng.standard_normal(m), 0.0, kid=7)
    assert e.value.status == Status.invalid_kid


def test_gen_bandt_core_parity(rng, monkeypatch):
    # f32 gen composite (mv KID 7) on the circuit profile: parity, refresh
    # and mixed precision on the band
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    try:
        m = 1024
        dense = _circuit_like(rng, m).astype(np.float32)
        A = _mk(m, dense)
        x = rng.standard_normal(m).astype(np.float32)
        y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
        form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
        assert form.kind == "gen"
        np.testing.assert_allclose(y, dense.astype(np.float64) @ x, atol=1e-3)
        v2 = rng.standard_normal(A.nnz).astype(np.float32)
        ast.update_values(A, v2)
        ptr, ind = np.asarray(A.data.ptr), np.asarray(A.data.ind)
        d2 = np.zeros((m, m))
        d2[np.repeat(np.arange(m), np.diff(ptr)), ind] = v2
        y2 = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
        np.testing.assert_allclose(y2, d2 @ x, atol=1e-3)
        # mixed precision rides the bf16 band
        monkeypatch.setenv("AOCLSPARSE_TPU_MIXED_PRECISION", "1")
        ym = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
        monkeypatch.delenv("AOCLSPARSE_TPU_MIXED_PRECISION")
        ref2 = d2 @ x
        scale = max(1e-9, float(np.max(np.abs(ref2))))
        assert np.max(np.abs(ym - ref2)) / scale < 2e-2
    finally:
        reset_context()


def test_gen_block_orientation_flips(rng):
    # alternating-orientation chain: every odd 128-block's element order is
    # reversed. Block-granular RCM recovers the chain but cannot fix the
    # orientations, so without the per-block flip DP (_block_flips) the
    # boundary crossings land at ~±2B and spill/widen the window; with it
    # they return to the diagonal at zero traffic cost.
    B = 128
    m = 16 * B
    base = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-10, 11, 6), 0, m - 1))
        base[i, js] = rng.standard_normal(js.size)
    q = np.arange(m).reshape(-1, B)
    q[1::2] = q[1::2, ::-1]
    q = q.reshape(-1)
    dense = base[np.ix_(q, q)]
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
    assert form.gen_B == B
    assert form.gen_flip is not None and bool(np.asarray(form.gen_flip).any())
    n_spill = 0 if form.sp_ind is None else int(form.sp_ind.shape[0])
    assert n_spill <= 0.01 * A.nnz  # crossings rejoined the band
    assert form.bwd_W <= 64  # window stayed chain-narrow (no ±2B widening)
    # value refresh must rescatter through the flip-aware maps
    v2 = rng.standard_normal(A.nnz)
    ast.update_values(A, v2)
    ptr, ind = np.asarray(A.data.ptr), np.asarray(A.data.ind)
    d2 = np.zeros((m, m))
    d2[np.repeat(np.arange(m), np.diff(ptr)), ind] = v2
    y2 = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y2, d2 @ x, atol=1e-10)


def test_gen_flips_with_hubs_and_transpose(rng):
    # flips + hub columns + hub rows + spill together, plus the transpose
    # op (separate effective copy): every dest map must be flip-aware
    B = 128
    m = 8 * B
    base = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-8, 9, 5), 0, m - 1))
        base[i, js] = rng.standard_normal(js.size)
    q = np.arange(m).reshape(-1, B)
    q[1::2] = q[1::2, ::-1]
    q = q.reshape(-1)
    dense = base[np.ix_(q, q)]
    for h in rng.choice(m, 3, replace=False):
        rs = rng.choice(m, m // 2, replace=False)
        dense[rs, h] = rng.standard_normal(rs.size)
    rr = rng.choice(m, 2, replace=False)
    dense[rr] = rng.standard_normal((2, m)) * (rng.random((2, m)) < 0.5)
    sc_i, sc_j = rng.integers(0, m, 40), rng.integers(0, m, 40)
    dense[sc_i, sc_j] = rng.standard_normal(40)
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
    yt = np.asarray(ast.mv(1.0, A, GEN, Operation.transpose, x, 0.0, kid=7))
    np.testing.assert_allclose(yt, dense.T @ x, atol=1e-10)


def test_gen_spill_promotion_to_hub_slabs(rng):
    # 40 mid-degree scattered columns, but the first-pass hub budget
    # (8*nnz slab entries) only admits ~24: the leftovers land in the
    # window spill with >= thresh entries each and must be PROMOTED into
    # the hub slab (second pass), leaving only the uniform dust as spill
    m = 2048
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-6, 7, 3), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    mid_cols = rng.choice(m, 40, replace=False)
    for h in mid_cols:
        rs = rng.choice(m, 100, replace=False)
        dense[rs, h] = rng.standard_normal(rs.size)
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
    assert form.hub_cols is not None
    k = int(form.hub_cols.shape[0])
    assert k >= 38  # nearly all scattered columns ended up as slab lanes
    n_spill = 0 if form.sp_ind is None else int(form.sp_ind.shape[0])
    assert n_spill <= 0.02 * A.nnz
    # refresh through the promoted maps
    v2 = rng.standard_normal(A.nnz)
    ast.update_values(A, v2)
    ptr, ind = np.asarray(A.data.ptr), np.asarray(A.data.ind)
    d2 = np.zeros((m, m))
    d2[np.repeat(np.arange(m), np.diff(ptr)), ind] = v2
    y2 = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y2, d2 @ x, atol=1e-10)


def test_gen_spill_row_promotion(rng):
    # dense-ish scattered ROWS beyond the first-pass hubr budget must be
    # promoted into the hub-row slab from the spill
    m = 2048
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-6, 7, 3), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    wide_rows = rng.choice(m, 60, replace=False)
    for r in wide_rows:
        cs = rng.choice(m, 50, replace=False)
        dense[r, cs] = rng.standard_normal(cs.size)
    A = _mk(m, dense)
    x = rng.standard_normal(m)
    y = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
    np.testing.assert_allclose(y, dense @ x, atol=1e-10)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
    n_spill = 0 if form.sp_ind is None else int(form.sp_ind.shape[0])
    assert n_spill <= 0.02 * A.nnz
    y2 = np.asarray(
        ast.mv(1.5, A, GEN, Operation.transpose, x, 0.0, kid=7)
    )
    np.testing.assert_allclose(y2, 1.5 * dense.T @ x, atol=1e-10)


def test_rcm_native_vs_numpy(rng):
    from aoclsparse_tpu import native

    m = 3000
    half = 12
    rows = np.repeat(np.arange(m), 2 * half + 1)
    cols = rows + rng.integers(-half, half + 1, rows.size)
    ok = (cols >= 0) & (cols < m)
    rows, cols = rows[ok], cols[ok]
    p = rng.permutation(m)
    r2, c2 = p[rows], p[cols]
    order = np.lexsort((c2, r2))
    r2, c2 = r2[order], c2[order]
    uq = np.concatenate([[True], (r2[1:] != r2[:-1]) | (c2[1:] != c2[:-1])])
    r2, c2 = r2[uq], c2[uq]
    ptr = np.zeros(m + 1, np.int64)
    np.add.at(ptr, r2 + 1, 1)
    ptr = np.cumsum(ptr)
    for fn in (native.rcm_permutation, native._rcm_numpy):
        perm, bw = fn(m, ptr, c2)
        assert sorted(perm) == list(range(m))
        assert bw <= 6 * half  # scrambled bandwidth (~m) recovered to ~band


def test_gen_spmm_parity(rng, monkeypatch):
    """mm on a circuit-profile operand whose plan holds the gen composite:
    mm has no gen kernel row (the removed mm KID 6 raises invalid_kid), so
    the product rides a gather form and must match the dense oracle."""
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    try:
        m, k = 1024, 128
        dense = _circuit_like(rng, m).astype(np.float32)
        A = _mk(m, dense)
        B = rng.standard_normal((m, k)).astype(np.float32)
        form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
        assert form.kind == "gen"
        with pytest.raises(AoclSparseError) as e:
            ast.mm(1.0, A, GEN, Operation.none, B, 0.0, kid=6)
        assert e.value.status == Status.invalid_kid
        C = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0))
        np.testing.assert_allclose(
            C, dense.astype(np.float64) @ B, atol=5e-3, rtol=1e-4
        )
    finally:
        reset_context()


def test_gen_spmm_alpha_beta_and_refresh(rng, monkeypatch):
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    try:
        m, k = 1024, 128
        dense = _circuit_like(rng, m).astype(np.float32)
        A = _mk(m, dense)
        B = rng.standard_normal((m, k)).astype(np.float32)
        C0 = rng.standard_normal((m, k)).astype(np.float32)
        got = np.asarray(ast.mm(1.5, A, GEN, Operation.none, B, -0.5, C0))
        want = 1.5 * dense.astype(np.float64) @ B - 0.5 * C0
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-4)
        # update_values flows through the cached form
        newval = (-2.0 * dense[dense != 0]).astype(np.float32)
        ast.update_values(A, newval)
        got2 = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0))
        np.testing.assert_allclose(
            got2, -2.0 * dense.astype(np.float64) @ B, atol=1e-2, rtol=1e-4
        )
    finally:
        reset_context()


def test_gen_spmm_k_pad_lane_multiple(rng, monkeypatch):
    """A K that is not a multiple of 128 (and a plan holding the gen form)
    gives a (m, K) product matching the oracle."""
    m = 1024
    dense = _circuit_like(rng, m)
    A = _mk(m, dense)
    B = rng.standard_normal((m, 40)).astype(np.float32)  # 40 % 128 != 0
    C = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0))
    assert C.shape == (m, 40)
    np.testing.assert_allclose(C, dense.astype(np.float32) @ B, atol=5e-3, rtol=1e-4)
    form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
    assert form.kind == "gen"
    C6 = np.asarray(ast.mm(1.0, A, GEN, Operation.none, B, 0.0))
    np.testing.assert_allclose(C6, C, atol=1e-6)


def test_gen_permuted_space_apply_parity(rng, monkeypatch):
    """mv_operator on an operand pinned to the gen composite: its spaces
    are the identity and its apply reproduces mv KID 7."""
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    try:
        import jax.numpy as jnp

        from aoclsparse_tpu.kernels.autotune import autotune_mv

        m = 1024
        dense = _circuit_like(rng, m).astype(np.float32)
        A = _mk(m, dense)
        autotune_mv(A, iters=1, chunks=1, kinds=("gen",))  # pin gen
        assert get_plan(A).exec_form_for(GEN, Operation.none).kind == "gen"
        op = ast.mv_operator(A)
        assert op.space == "original"
        matvec_p, to_p, from_p = op.apply, op.to_space, op.from_space
        x = rng.standard_normal(m).astype(np.float32)
        # boundary round-trip is exact
        np.testing.assert_array_equal(
            np.asarray(from_p(to_p(jnp.asarray(x)))), x
        )
        y_p = np.asarray(from_p(matvec_p(to_p(jnp.asarray(x)))))
        y_ref = np.asarray(ast.mv(1.0, A, GEN, Operation.none, x, 0.0, kid=7))
        np.testing.assert_allclose(y_p, y_ref, atol=2e-4, rtol=1e-5)
        np.testing.assert_allclose(
            y_p, dense.astype(np.float64) @ x, atol=5e-3
        )
    finally:
        reset_context()


def test_gen_pcg_permuted_space_iterations(rng, monkeypatch):
    """pcg_solve on a gen-composite SPD operand runs the permuted-space
    loop; solution and iteration count must match the dense solve /
    matrix-free CG on the same operand."""
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    try:
        import jax.numpy as jnp

        from aoclsparse_tpu.solvers.fused import make_cg_operator, pcg_solve

        m = 1024
        base = _circuit_like(rng, m).astype(np.float32)
        dense = (base + base.T).astype(np.float32)
        dense[np.arange(m), np.arange(m)] += np.abs(dense).sum(1) + 1.0  # SPD
        A = _mk(m, dense)
        form = get_plan(A).exec_form_for(GEN, Operation.none, dtype=A.dtype)
        if form.kind != "gen":  # symmetrized structure may stay banded
            form = get_plan(A).exec_form_for(GEN, Operation.none, kind="gen")
        b = rng.standard_normal(m).astype(np.float32)
        x, it, rn = pcg_solve(A, b, rtol=1e-5, maxit=300)
        np.testing.assert_allclose(
            dense.astype(np.float64) @ np.asarray(x), b, atol=2e-3
        )
        # iteration parity vs a matrix-free CG on the same dense operand
        dj = jnp.asarray(dense)
        solve2 = make_cg_operator(lambda v: dj @ v, maxit=300)
        x2, it2, rn2 = solve2(jnp.asarray(b), rtol=1e-5)
        assert abs(int(it) - int(it2)) <= 2, (it, it2)
    finally:
        reset_context()


def test_gen_pgmres_permuted_space(rng, monkeypatch):
    """pgmres_solve (no preconditioner) also iterates in permuted space on
    gen operands; solution parity with the dense system."""
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    try:
        from aoclsparse_tpu.solvers.fused import pgmres_solve

        m = 1024
        dense = _circuit_like(rng, m).astype(np.float32)
        dense[np.arange(m), np.arange(m)] += np.abs(dense).sum(1) + 1.0
        A = _mk(m, dense)
        b = rng.standard_normal(m).astype(np.float32)
        x, it, rn = pgmres_solve(A, b, rtol=1e-5, maxit=200, restart=30)
        np.testing.assert_allclose(
            dense.astype(np.float64) @ np.asarray(x), b, atol=5e-3
        )
        assert it > 0
    finally:
        reset_context()


def test_gen_pcg_pspace_refreshes_after_update_values(rng, monkeypatch):
    """update_values must invalidate the cached permuted-space solver
    closure (plan.refresh_values clears _fused_cache) so the next solve
    sees the new values."""
    from aoclsparse_tpu.core.context import reset_context

    reset_context()
    try:
        from aoclsparse_tpu.solvers.fused import pcg_solve

        m = 1024
        base = _circuit_like(rng, m).astype(np.float32)
        dense = (base + base.T).astype(np.float32)
        dense[np.arange(m), np.arange(m)] += np.abs(dense).sum(1) + 1.0
        A = _mk(m, dense)
        b = rng.standard_normal(m).astype(np.float32)
        x1, _, _ = pcg_solve(A, b, rtol=1e-6, maxit=300)
        # scale all values by 2: solution halves
        ast.update_values(A, (2.0 * dense[dense != 0]).astype(np.float32))
        x2, _, _ = pcg_solve(A, b, rtol=1e-6, maxit=300)
        np.testing.assert_allclose(
            np.asarray(x2), 0.5 * np.asarray(x1), rtol=5e-3, atol=5e-5
        )
    finally:
        reset_context()
