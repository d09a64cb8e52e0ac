"""Distributed triangular solve: block-row pipeline over the mesh.

The reference's TRSV is a strictly sequential sweep on one node
(level2/aoclsparse_trsv_kt.cpp:65, SURVEY.md §3.3); the required
distributed analog (§2.9/§5.8(iii)) shards the OPERAND — the blocked
"win" form's diagonal blocks and left windows — across devices and passes
the rolling solve window between ring neighbors via `lax.ppermute`:

  * single RHS: device d solves its block-row chunk on tick d and hands
    the WL-wide boundary window to d+1 — storage scales with the mesh
    while honoring the loop-carried dependency (there is no intra-RHS
    parallelism to exploit; the reference has none either),
  * multi-RHS (trsm): the RHS columns are split into groups that flow
    through the same pipeline, so device d works on column group t-d at
    tick t — true wavefront parallelism with ndev chunks in flight.

Forms come from the planner (planner/triangular.py, kind="win"); values
stay refreshable through the form's maps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .placement import put
from jax import shard_map

#: contractions must not lower to TF32 (kernels/xla/spmv.py)
HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "dist_trsv_pipeline",
    "dist_trsm_pipeline",
    "dist_trsv_levels",
    "pipeline_runner",
]


def _pvary(v, axis):
    """Mark a shard-local constant as device-varying (shard_map VMA rule:
    a scan carry that mixes with sharded data must start 'varying')."""
    if hasattr(jax.lax, "pcast"):
        return jax.lax.pcast(v, (axis,), to="varying")
    return jax.lax.pvary(v, (axis,))  # older spelling


def _prep(mesh, form, axis):
    if form.kind != "win":
        raise ValueError("distributed pipeline requires the dense-window (win) form")
    ndev = mesh.shape[axis]
    nb, WL = form.nb, form.WL
    nblk = form.nblk
    nblk_pad = -(-nblk // ndev) * ndev
    from ..kernels.xla.trsv import invert_diag_blocks

    if getattr(form, "_Dinv", None) is None:
        form._Dinv = invert_diag_blocks(form.D)
    Dinv = form._Dinv
    Lwin = form.Lval
    if nblk_pad != nblk:
        # identity-extend so padded blocks solve to zero on zero rhs
        eye = jnp.broadcast_to(jnp.eye(nb, dtype=Dinv.dtype), (nblk_pad - nblk, nb, nb))
        Dinv = jnp.concatenate([Dinv, eye])
        Lwin = jnp.concatenate(
            [Lwin, jnp.zeros((nblk_pad - nblk, nb, WL), Lwin.dtype)]
        )
    return (
        put(Dinv, mesh, P(axis, None, None)),
        put(Lwin, mesh, P(axis, None, None)),
        ndev,
        nb,
        WL,
        nblk_pad,
    )


def _local_chunk_scan(Dinv_c, Lwin_c, b_c, w0, nb, WL):
    """Sequential solve of this device's block chunk given the incoming
    rolling window w0 (WL, k); returns (final window, solved (mloc, k))."""
    k = b_c.shape[1]
    gloc = Dinv_c.shape[0]
    bs = b_c.reshape(gloc, nb, k)

    def step(w, args):
        Dik, lwk, bk = args
        s = jnp.einsum("rw,wk->rk", lwk, w, precision=HIGHEST)
        xk = jnp.dot(Dik, bk - s, preferred_element_type=Dik.dtype, precision=HIGHEST)
        w = jnp.concatenate([w, xk], axis=0)[-WL:]
        return w, xk

    w, xs = jax.lax.scan(step, w0, (Dinv_c, Lwin_c, bs))
    return w, xs.reshape(gloc * nb, k)


def pipeline_runner(mesh: Mesh, axis: str, ndev: int, nb: int, WL: int, k: int):
    """The traceable core of the block-row ring pipeline: a shard_map
    program (Dinv, Lwin, b) -> x over PRE-SHARDED operands. Pure — safe to
    call inside jit/fori_loop (dist_symgs_chain composes sweeps from it)."""
    ring = [(i, (i + 1) % ndev) for i in range(ndev)]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    def _run(Dinv_c, Lwin_c, b_c):
        me = jax.lax.axis_index(axis)
        w0 = _pvary(jnp.zeros((WL, k), Dinv_c.dtype), axis)
        x0 = jnp.zeros_like(b_c)

        def tick(t, carry):
            w, xs = carry
            w_out, x_loc = _local_chunk_scan(Dinv_c, Lwin_c, b_c, w, nb, WL)
            mine = me == t
            xs = jnp.where(mine, x_loc, xs)
            w_send = jnp.where(mine, w_out, w)
            w = jax.lax.ppermute(w_send, axis, ring)
            return (w, xs)

        _, xs = jax.lax.fori_loop(0, ndev, tick, (w0, x0))
        return xs

    return _run


def dist_trsv_pipeline(mesh: Mesh, form, b, axis: str = "x"):
    """Solve the planner's blocked-lower form with operands sharded over the
    mesh, window handoff by ppermute. b: (m,) (or (m, k) — see
    dist_trsm_pipeline for the column-pipelined variant). Returns x (m,)."""
    Dinv, Lwin, ndev, nb, WL, nblk_pad = _prep(mesh, form, axis)
    m_pad = nblk_pad * nb
    squeeze = np.ndim(b) == 1
    b2 = jnp.asarray(b)
    if squeeze:
        b2 = b2[:, None]
    k = b2.shape[1]
    if form.reversed_:
        b2 = b2[::-1]
    b2 = jnp.pad(b2, ((0, m_pad - b2.shape[0]), (0, 0))).astype(Dinv.dtype)
    b_sh = put(b2, mesh, P(axis, None))
    x = pipeline_runner(mesh, axis, ndev, nb, WL, k)(Dinv, Lwin, b_sh)[: form.m]
    if form.reversed_:
        x = x[::-1]
    return x[:, 0] if squeeze else x


def dist_trsm_pipeline(mesh: Mesh, form, B, axis: str = "x"):
    """Multi-RHS pipelined solve: column groups flow through the device ring
    so all devices work concurrently on different column groups (wavefront).
    B: (m, k). Returns X (m, k)."""
    Dinv, Lwin, ndev, nb, WL, nblk_pad = _prep(mesh, form, axis)
    m_pad = nblk_pad * nb
    B2 = jnp.asarray(B)
    if B2.ndim != 2:
        raise ValueError("dist_trsm_pipeline expects a (m, k) RHS")
    if form.reversed_:
        B2 = B2[::-1]
    k = B2.shape[1]
    ncg = ndev  # column groups = devices keeps the pipeline full
    kc = -(-k // ncg)
    B2 = jnp.pad(B2, ((0, m_pad - B2.shape[0]), (0, ncg * kc - k))).astype(Dinv.dtype)
    b_sh = put(B2, mesh, P(axis, None))
    ring = [(i, (i + 1) % ndev) for i in range(ndev)]
    nticks = ndev + ncg - 1

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    def _run(Dinv_c, Lwin_c, b_c):
        me = jax.lax.axis_index(axis)
        w0 = _pvary(jnp.zeros((WL, kc), Dinv_c.dtype), axis)
        xs0 = jnp.zeros_like(b_c)

        def tick(t, carry):
            w, xs = carry
            cg = t - me  # column group this device works on at tick t
            active = jnp.logical_and(cg >= 0, cg < ncg)
            cg_c = jnp.clip(cg, 0, ncg - 1)
            b_cg = jax.lax.dynamic_slice_in_dim(b_c, cg_c * kc, kc, axis=1)
            w_out, x_loc = _local_chunk_scan(Dinv_c, Lwin_c, b_cg, w, nb, WL)
            zero_i = jnp.zeros((), cg_c.dtype)
            xs = jnp.where(
                active,
                jax.lax.dynamic_update_slice(xs, x_loc, (zero_i, cg_c * kc)),
                xs,
            )
            w_send = jnp.where(active, w_out, w)
            w = jax.lax.ppermute(w_send, axis, ring)
            return (w, xs)

        _, xs = jax.lax.fori_loop(0, nticks, tick, (w0, xs0))
        return xs

    X = _run(Dinv, Lwin, b_sh)
    X = X[: form.m, :k]
    if form.reversed_:
        X = X[::-1]
    return X


def dist_trsv_levels(mesh: Mesh, form, b, axis: str = "x"):
    """Sharded LEVEL-SCHEDULED triangular solve — §5.8(iii) for GENERAL
    structure (the block-row pipeline above covers banded operands; this
    covers shallow-DAG circuit-class triangles). The wavefront form's
    per-level row sets (kernels/xla/trsv_level.py LevelForm) shard across
    the mesh: every device solves its slice of each level simultaneously,
    then ONE `all_gather` of the level's new entries (O(R_max) values)
    makes them visible for the next level's gathers — the collective-per-
    level schedule of a distributed wavefront sweep. x is replicated
    (every row may be read by any later level on any device).

    Returns x (replicated)."""
    ndev = mesh.shape[axis]
    form.global_arrays()  # runs-form keeps only slices; sharding pads whole levels
    L, R = form.rows.shape
    W = form.cols.shape[2]
    Rp = -(-R // ndev) * ndev
    m = form.m

    def pad_r(a, fill):
        if a.shape[1] == Rp:
            return a
        pw = [(0, 0), (0, Rp - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
        return jnp.pad(a, pw, constant_values=fill)

    rows = put(pad_r(jnp.asarray(form.rows), m), mesh, P(None, axis))
    rvalid = put(pad_r(jnp.asarray(form.row_valid), False), mesh, P(None, axis))
    cols = put(pad_r(jnp.asarray(form.cols), 0), mesh, P(None, axis, None))
    cvalid = put(pad_r(jnp.asarray(form.col_valid), False), mesh, P(None, axis, None))
    Lval_full, Dinv_full = form.full_vals()  # runs-form keeps only slices
    Lval = put(pad_r(Lval_full, 0), mesh, P(None, axis, None))
    Dinv = put(pad_r(Dinv_full, 1), mesh, P(None, axis))

    b = jnp.asarray(b)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    if form.reversed_:
        b2 = b2[::-1]
    b_r = put(b2, mesh, P())

    # check_vma=False: the carry is typed device-varying because the
    # per-level all_gathers flow into it, but after each gather every
    # device provably holds the identical x — the replicated out_spec is
    # correct even though the VMA checker cannot infer it
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, axis),
            P(None, axis),
            P(None, axis, None),
            P(None, axis, None),
            P(None, axis, None),
            P(None, axis),
            P(),
        ),
        out_specs=P(),
        check_vma=False,
    )
    def _solve(r_s, rv_s, c_s, cv_s, lv_s, di_s, bl):
        k = bl.shape[1]
        x0 = jnp.zeros((m + 1, k), bl.dtype)
        bp = jnp.concatenate([bl, jnp.zeros((1, k), bl.dtype)], axis=0)

        from ..kernels.xla.trsv_level import level_step

        def step(x, lvl):
            r, rv, c, cv, lv, di = lvl  # local level slice (R_loc, ...)
            xi = level_step(x, bp, r, rv, c, cv, lv, di)
            # ONE collective per level: everyone learns the level's entries
            xi_all = jax.lax.all_gather(xi, axis, tiled=True)
            r_all = jax.lax.all_gather(r, axis, tiled=True)
            return x.at[r_all].set(xi_all), None

        x, _ = jax.lax.scan(step, x0, (r_s, rv_s, c_s, cv_s, lv_s, di_s))
        return x[:m]

    x = _solve(rows, rvalid, cols, cvalid, Lval, Dinv, b_r)
    if form.reversed_:
        x = x[::-1]
    return x[:, 0] if squeeze else x
