"""Distributed preconditioner sweeps: ILU0 apply and SymGS over a mesh.

SURVEY.md §5.8(iii) asks for sharded wavefront sweeps of TRSV **and** the
ILU0/SymGS smoothers. Both are compositions of the pieces that already run
distributed: the block-row pipelined triangular solve (trsv.py — operand
sharded, rolling window over the ring via ppermute) and the row-sharded
SpMV (spmv.py). The reference's smoothers are single-node sequential sweeps
(solvers/aoclsparse_ilu0.hpp, aoclsparse_symgs.hpp:88+); here the storage
and the per-block work scale with the mesh while the loop-carried
dependency rides the ring.

Real dtypes; general (op=none) and symmetric descriptors, like the fused
single-device sweeps.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..core.descr import MatrixDescriptor
from ..core.types import (
    AoclSparseError,
    DiagType,
    MatrixType,
    Operation,
    Status,
)
from .spmv import dist_spmv_ell, shard_ell
from .trsv import dist_trsv_pipeline

__all__ = ["dist_ilu_apply", "dist_symgs", "dist_symgs_chain"]


def _tri(fill, diag):
    return MatrixDescriptor(type=MatrixType.triangular, fill_mode=fill, diag_type=diag)


def _pipeline_solve(mesh, form, rhs, axis):
    """dist_trsv_pipeline with the same reversal/padding contract as the
    local _apply_form (solvers/ilu.py). The rhs stays a device array — a
    host round-trip here would sync the device per sweep step."""
    x = dist_trsv_pipeline(mesh, form, rhs, axis=axis)
    return jnp.asarray(x)


def dist_ilu_apply(mesh: Mesh, A, b, axis: str = "x", engine: str = "pipeline"):
    """x = U^{-1} L^{-1} b over the cached ILU0 factors. engine="pipeline"
    (default) runs both solves as block-row ring pipelines (banded
    operands); engine="level" shards the wavefront LevelForms instead
    (parallel/trsv.py dist_trsv_levels — one all_gather per dependency
    level, the shallow-DAG schedule)."""
    from ..solvers.ilu import ilu0_factorize

    if b is None:
        raise AoclSparseError(Status.invalid_pointer, "null b")
    st = A.ilu_state if getattr(A, "ilu_state", None) is not None else ilu0_factorize(A)
    b = jnp.asarray(b).astype(A.dtype)
    if engine == "level":
        from ..solvers.ilu import _ilu_level_forms
        from .trsv import dist_trsv_levels

        l_lvl, u_lvl = _ilu_level_forms(st)
        y = dist_trsv_levels(mesh, l_lvl, b, axis=axis)
        return dist_trsv_levels(mesh, u_lvl, y, axis=axis)
    if engine != "pipeline":
        raise AoclSparseError(Status.invalid_value, f"unknown engine '{engine}'")
    y = _pipeline_solve(mesh, st.l_form, b, axis)[: A.shape[0]]
    return _pipeline_solve(mesh, st.u_form, y, axis)[: A.shape[0]]


def dist_symgs(
    mesh: Mesh,
    A,
    descr: MatrixDescriptor,
    alpha,
    b,
    x0=None,
    axis: str = "x",
    engine: str = "pipeline",
):
    """One distributed symmetric Gauss-Seidel sweep (the mesh rebuild of
    aoclsparse_?symgs, solvers/aoclsparse_symgs.hpp:88+):

        1. q = alpha*U_s x0 ; (L+D) x1 = b - q     [SpMV + pipelined solve]
        2. r = L_s x1 ;       (U+D) x  = b - r     [SpMV + pipelined solve]

    The strict-triangle SpMVs run row-sharded (dist_spmv_ell); the
    triangular solves run as block-row ring pipelines (engine="pipeline")
    or sharded level wavefronts (engine="level" — shallow circuit-class
    DAGs, parallel/trsv.py dist_trsv_levels). Returns x."""
    from ..planner.plan import get_plan
    from ..planner.triangular import trsv_form_for

    if b is None:
        raise AoclSparseError(Status.invalid_pointer, "null b")
    mtype = MatrixType(descr.type)
    if mtype not in (MatrixType.general, MatrixType.symmetric):
        raise AoclSparseError(Status.not_implemented, f"dist_symgs: type {mtype.name}")
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "symgs requires a square matrix")
    if jnp.iscomplexobj(jnp.zeros((), A.dtype)):
        raise AoclSparseError(Status.not_implemented, "dist_symgs: real dtypes")

    from ..solvers.symgs import lu_view_selection

    l_fm, l_op, u_fm, u_op = lu_view_selection(mtype, descr, Operation.none)

    plan = get_plan(A)
    # cache the sharded operands + solve forms on the plan: re-uploading the
    # full ELL arrays to the devices per sweep would dominate
    # an outer iteration (the single-device sweep caches its whole fused
    # program for the same reason, solvers/symgs.py _symgs_fused)
    if engine not in ("pipeline", "level"):
        raise AoclSparseError(Status.invalid_value, f"unknown engine '{engine}'")
    ckey = ("dist_symgs", mtype, descr.fill_mode, axis, mesh.shape[axis], engine)
    cache = getattr(plan, "_dist_sweep_cache", None)
    if cache is None:
        cache = plan._dist_sweep_cache = {}
    ops = cache.get(ckey)
    if ops is None:
        tri_l = _tri(l_fm, DiagType.non_unit)
        tri_u = _tri(u_fm, DiagType.non_unit)
        tri_ls = _tri(l_fm, DiagType.zero)
        tri_us = _tri(u_fm, DiagType.zero)

        def _sharded_mv(descr_s, op_s):
            form = plan.exec_form_for(descr_s, op_s, kind="ell", dtype=A.dtype)
            ind_s, val_s, m_pad = shard_ell(mesh, form.ell_ind, form.ell_val)

            def run(x):
                xp = jnp.pad(jnp.asarray(x), (0, max(0, m_pad - np.shape(x)[0])))
                return dist_spmv_ell(mesh, ind_s, val_s, xp)[:m]

            return run

        if engine == "level":
            from ..planner.triangular import trsv_level_form_for

            ops = (
                _sharded_mv(tri_us, u_op),
                _sharded_mv(tri_ls, l_op),
                trsv_level_form_for(plan, tri_l, l_op),
                trsv_level_form_for(plan, tri_u, u_op),
            )
        else:
            ops = (
                _sharded_mv(tri_us, u_op),
                _sharded_mv(tri_ls, l_op),
                trsv_form_for(plan, tri_l, l_op),
                trsv_form_for(plan, tri_u, u_op),
            )
        cache[ckey] = ops
    mv_us, mv_ls, form_l, form_u = ops

    b = jnp.asarray(b).astype(A.dtype)
    x0 = jnp.zeros((m,), A.dtype) if x0 is None else jnp.asarray(x0).astype(A.dtype)
    alpha_c = jnp.asarray(alpha, A.dtype)

    if engine == "level":
        from .trsv import dist_trsv_levels

        q = mv_us(x0)
        x1 = dist_trsv_levels(mesh, form_l, b - alpha_c * q, axis=axis)[:m]
        r = mv_ls(x1)
        return dist_trsv_levels(mesh, form_u, b - r, axis=axis)[:m]
    q = mv_us(x0)  # U_s x0 (alpha applied below, symgs.hpp step 1)
    x1 = _pipeline_solve(mesh, form_l, b - alpha_c * q, axis)[:m]
    r = mv_ls(x1)
    x = _pipeline_solve(mesh, form_u, b - r, axis)[:m]
    return x


def dist_symgs_chain(
    mesh: Mesh,
    A,
    descr: MatrixDescriptor,
    alpha,
    b,
    nsweeps: int,
    x0=None,
    axis: str = "x",
):
    """nsweeps distributed SymGS sweeps as ONE compiled program.

    dist_symgs dispatches four collective programs per sweep and returns to
    the host between sweeps, so an N-sweep smoother chain pays N host
    round-trips plus N cold collective
    schedules. Here the whole chain traces into a single jitted
    lax.fori_loop over sweeps — the SpMV shard_maps and both ring-pipeline
    solves (parallel/trsv.py pipeline_runner) compose inside the loop body,
    so XLA schedules the ppermute/all_gather stream across stage boundaries
    and the host syncs once per CHAIN. The reference's smoother loop is the
    caller's (sequential, aoclsparse_symgs.hpp:88+); this is its mesh
    rebuild for multi-step smoothing (ROADMAP: double-buffered halo for
    multi-step smoother chains).

    Returns x after nsweeps sweeps (parity with nsweeps dist_symgs calls
    is pinned in tests)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..planner.plan import get_plan
    from ..planner.triangular import trsv_form_for
    from .placement import put
    from .spmv import shard_ell, spmv_ell_runner
    from .trsv import _prep, pipeline_runner

    if b is None:
        raise AoclSparseError(Status.invalid_pointer, "null b")
    if not isinstance(nsweeps, int) or nsweeps < 1:
        raise AoclSparseError(Status.invalid_value, "nsweeps must be a positive int")
    mtype = MatrixType(descr.type)
    if mtype not in (MatrixType.general, MatrixType.symmetric):
        raise AoclSparseError(Status.not_implemented, f"dist_symgs_chain: type {mtype.name}")
    m, n = A.shape
    if m != n:
        raise AoclSparseError(Status.invalid_size, "symgs requires a square matrix")
    if jnp.iscomplexobj(jnp.zeros((), A.dtype)):
        raise AoclSparseError(Status.not_implemented, "dist_symgs_chain: real dtypes")

    from ..solvers.symgs import lu_view_selection

    l_fm, l_op, u_fm, u_op = lu_view_selection(mtype, descr, Operation.none)
    plan = get_plan(A)
    cache = getattr(plan, "_dist_sweep_cache", None)
    if cache is None:
        cache = plan._dist_sweep_cache = {}
    ckey = ("dist_symgs_chain", mtype, descr.fill_mode, axis, mesh.shape[axis], nsweeps)
    entry = cache.get(ckey)
    if entry is None:
        tri_l = _tri(l_fm, DiagType.non_unit)
        tri_u = _tri(u_fm, DiagType.non_unit)
        tri_ls = _tri(l_fm, DiagType.zero)
        tri_us = _tri(u_fm, DiagType.zero)

        def _ell(descr_s, op_s):
            form = plan.exec_form_for(descr_s, op_s, kind="ell", dtype=A.dtype)
            return shard_ell(mesh, form.ell_ind, form.ell_val, axis=axis)

        ind_us, val_us, _ = _ell(tri_us, u_op)
        ind_ls, val_ls, _ = _ell(tri_ls, l_op)
        form_l = trsv_form_for(plan, tri_l, l_op)
        form_u = trsv_form_for(plan, tri_u, u_op)
        Dl, Ll, ndev, nb_l, WL_l, nblk_l = _prep(mesh, form_l, axis)
        Du, Lu, _, nb_u, WL_u, nblk_u = _prep(mesh, form_u, axis)
        mvr = spmv_ell_runner(mesh, axis)
        run_l = pipeline_runner(mesh, axis, ndev, nb_l, WL_l, 1)
        run_u = pipeline_runner(mesh, axis, ndev, nb_u, WL_u, 1)
        rep = NamedSharding(mesh, P())
        cfg = (
            (nblk_l * nb_l, bool(form_l.reversed_)),
            (nblk_u * nb_u, bool(form_u.reversed_)),
        )

        @jax.jit
        def chain(ind_us, val_us, ind_ls, val_ls, Dl, Ll, Du, Lu, b_r, x0_r, a_c):
            def solve(run, Dinv, Lwin, pad_rev, rhs):
                m_pad, reversed_ = pad_rev
                r2 = rhs[::-1] if reversed_ else rhs
                r2 = jnp.pad(r2, (0, m_pad - m))[:, None]
                xs = run(Dinv, Lwin, r2)[:m, 0]
                return xs[::-1] if reversed_ else xs

            def sweep(_, x):
                q = mvr(ind_us, val_us, x)[:m]
                x1 = solve(run_l, Dl, Ll, cfg[0], b_r - a_c * q)
                x1 = jax.lax.with_sharding_constraint(x1, rep)
                r = mvr(ind_ls, val_ls, x1)[:m]
                x2 = solve(run_u, Du, Lu, cfg[1], b_r - r)
                return jax.lax.with_sharding_constraint(x2, rep)

            return jax.lax.fori_loop(0, nsweeps, sweep, x0_r)

        entry = (chain, (ind_us, val_us, ind_ls, val_ls, Dl, Ll, Du, Lu))
        cache[ckey] = entry
    chain, ops = entry
    from jax.sharding import PartitionSpec as _P

    b_r = put(jnp.asarray(b).astype(A.dtype), mesh, _P())
    x0_r = put(
        jnp.zeros((m,), A.dtype) if x0 is None else jnp.asarray(x0).astype(A.dtype),
        mesh,
        _P(),
    )
    a_c = jnp.asarray(alpha, A.dtype)
    return chain(*ops, b_r, x0_r, a_c)
