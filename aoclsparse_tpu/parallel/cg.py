"""Fully-jitted CG and its distributed form.

The host-driven RCI CG (solvers/itsol.py) mirrors the reference's reverse-
communication protocol; this module is the device twin: the same
iteration as ONE compiled XLA program (`lax.while_loop`), so a whole Krylov
solve is a single dispatch. Under a `jax.sharding.Mesh`, the operand arrays
are placed row-sharded (A) / sharded (x, b) and XLA inserts the collectives
(all-gather for the x gather in SpMV, psum for the dots) — the distributed
rebuild of the reference's single-node OpenMP loop demanded by SURVEY.md
§2.9/§5.8.

The matvec operand is the padded-ELL execution form (planner's `ell` kind).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .placement import put

#: contractions must not lower to TF32 (kernels/xla/spmv.py)
HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "cg_ell_jit",
    "cg_bwd_jit",
    "dist_cg",
    "dist_cg_bwd",
    "dist_cg_bwd_halo",
    "dist_cg_pipelined",
    "dist_cg_ell_halo",
    "prepare_dist_ell",
]


@partial(jax.jit, static_argnames=("m",))
def _trim_jit(a, m: int):
    return jax.lax.slice_in_dim(a, 0, m)


def _trim(x, m: int):
    """Drop the row padding. A multi-process global array cannot be sliced
    eagerly (some shards are remote), so the slice runs as a tiny SPMD jit
    (module-level jit: one trace per m, not per call)."""
    if int(x.shape[0]) == m:
        return x
    if x.is_fully_addressable:
        return x[:m]
    return _trim_jit(x, m)


def _prep_precond(dinv, mesh, axis, m: int, m_pad: int, dtype, placeholder):
    """Place a shard-local preconditioner operand for the distributed CG
    variants. Returns (device_operand, in_spec, kind) with kind one of
    None / "diag" / "block".

    - 1-D `dinv` (length m): Jacobi; padded with zeros (padding rows carry
      r = 0 anyway) and row-sharded.
    - 3-D `dinv` (m_pad/nb, nb, nb) block inverses (see
      parallel/precond.py block_jacobi_inv): block-Jacobi; the block count
      must split evenly over the mesh axis (nb divides the shard rows).
    """
    if dinv is None:
        return placeholder, P(axis), None
    d = np.asarray(dinv)
    ndev = mesh.shape[axis]
    if d.ndim == 1:
        if d.shape[0] not in (m, m_pad):
            raise ValueError(
                f"Jacobi dinv must have length m={m} (or m_pad={m_pad}), got {d.shape[0]}"
            )
        dv = np.zeros(m_pad, dtype=np.float64)
        dv[: d.shape[0]] = d
        return put(jnp.asarray(dv).astype(dtype), mesh, P(axis)), P(axis), "diag"
    if d.ndim == 3:
        nblk, nb, nb2 = d.shape
        if nb != nb2 or nblk * nb != m_pad:
            raise ValueError("block dinv must be (m_pad/nb, nb, nb)")
        if nblk % ndev:
            raise ValueError("block count must divide evenly over the mesh axis")
        return (
            put(jnp.asarray(d).astype(dtype), mesh, P(axis, None, None)),
            P(axis, None, None),
            "block",
        )
    raise ValueError("dinv must be 1-D (Jacobi) or 3-D (block-Jacobi)")


def _apply_precond(kind, dl, r):
    """Traceable shard-local z = M⁻¹ r for the kinds of _prep_precond."""
    if kind is None:
        return r
    if kind == "diag":
        return dl * r
    nb = dl.shape[1]
    return jnp.einsum("bij,bj->bi", dl, r.reshape(-1, nb), precision=HIGHEST).reshape(-1)


@partial(jax.jit, static_argnames=("maxit", "W", "base8", "padL", "n_pad"))
def cg_bwd_jit(
    win_val,
    b,
    x0,
    rtol,
    atol,
    maxit: int,
    W: int,
    base8: int,
    padL: int,
    n_pad: int,
    sp_ind=None,
    sp_rows=None,
    sp_val=None,
):
    """CG over the banded-window operand (kernels/xla/spmv.py spmv_bwd) as one
    compiled while_loop (no gathers). Operand rows can be
    sharded over a mesh axis; vectors replicated; XLA all-gathers the sharded
    einsum output per iteration. sp_* carry the planner's edge-peel spill
    (may be empty/None)."""

    def matvec(v):
        vp = jnp.pad(v, (padL, n_pad - padL - v.shape[0]))
        xr = vp.reshape(-1, 8)
        nblk = win_val.shape[0]
        pats = jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(xr, base8 + j, nblk, 0) for j in range(W // 8)],
            axis=1,
        )
        y = jnp.einsum("brw,bw->br", win_val, pats, precision=HIGHEST).reshape(-1)[: v.shape[0]]
        if sp_ind is not None and sp_ind.shape[0]:
            y = y + jax.ops.segment_sum(
                sp_val * v[sp_ind], sp_rows, num_segments=v.shape[0], indices_are_sorted=True
            )
        return y

    # 2 reductions/iteration ): rz = r.r doubles as ||r||^2 (the reference's RES_NORM)
    bnorm = jnp.sqrt(jnp.sum(b * b))
    brtol = rtol * bnorm
    r0 = matvec(x0) - b
    rr0 = jnp.sum(r0 * r0)

    def cond(state):
        x, r, p, rr_prev, rr, k = state
        rnorm = jnp.sqrt(rr)
        not_conv = jnp.logical_and(rnorm > atol, rnorm > brtol)
        return jnp.logical_and(not_conv, k < maxit)

    def body(state):
        x, r, p, rr_prev, rr, k = state
        beta = jnp.where(k == 0, jnp.zeros_like(rr), rr / rr_prev)
        p = beta * p - r
        q = matvec(p)
        alpha = rr / jnp.sum(p * q)
        x = x + alpha * p
        r = r + alpha * q
        return (x, r, p, rr, jnp.sum(r * r), k + 1)

    state = (
        x0,
        r0,
        jnp.zeros_like(x0),
        jnp.ones((), b.dtype),
        rr0,
        jnp.zeros((), jnp.int32),
    )
    x, r, p, rr_prev, rr, k = jax.lax.while_loop(cond, body, state)
    return x, k, jnp.sqrt(rr)


@partial(jax.jit, static_argnames=("maxit",))
def cg_ell_jit(ell_ind, ell_val, b, x0, rtol, atol, maxit: int):
    """CG on a padded-ELL operand as one compiled while_loop.

    Same update order as the reference CG task machine
    (itsol_functions.hpp:619-870): r=Ax-b, p=-z+beta*p, alpha=rz/pq.
    Returns (x, iters, rnorm).
    """

    def matvec(v):
        g = jnp.take(v, jnp.maximum(ell_ind, 0), axis=0)
        prods = jnp.where(ell_ind >= 0, ell_val * g, jnp.zeros((), dtype=ell_val.dtype))
        return jnp.sum(prods, axis=1)

    # 2 reductions/iteration ): rz = r.r doubles as ||r||^2 (the reference's RES_NORM)
    bnorm = jnp.sqrt(jnp.sum(b * b))
    brtol = rtol * bnorm

    r0 = matvec(x0) - b
    rr0 = jnp.sum(r0 * r0)

    def cond(state):
        x, r, p, rr_prev, rr, k = state
        rnorm = jnp.sqrt(rr)
        not_conv = jnp.logical_and(rnorm > atol, rnorm > brtol)
        return jnp.logical_and(not_conv, k < maxit)

    def body(state):
        x, r, p, rr_prev, rr, k = state
        beta = jnp.where(k == 0, jnp.zeros_like(rr), rr / rr_prev)
        p = beta * p - r
        q = matvec(p)
        alpha = rr / jnp.sum(p * q)
        x = x + alpha * p
        r = r + alpha * q
        return (x, r, p, rr, jnp.sum(r * r), k + 1)

    state = (
        x0,
        r0,
        jnp.zeros_like(x0),
        jnp.ones((), b.dtype),
        rr0,
        jnp.zeros((), jnp.int32),
    )
    x, r, p, rr_prev, rr, k = jax.lax.while_loop(cond, body, state)
    return x, k, jnp.sqrt(rr)


def prepare_dist_ell(mesh: Mesh, ell_ind, ell_val, axis: str = "x"):
    """Row-shard the padded-ELL operand; pad rows to a device multiple."""
    n_dev = mesh.shape[axis]
    m = ell_ind.shape[0]
    m_pad = -(-m // n_dev) * n_dev
    if m_pad != m:
        pad = ((0, m_pad - m), (0, 0))
        ell_ind = jnp.pad(ell_ind, pad, constant_values=-1)
        ell_val = jnp.pad(ell_val, pad)
    return (
        put(ell_ind, mesh, P(axis, None)),
        put(ell_val, mesh, P(axis, None)),
        m_pad,
    )


def dist_cg_bwd(
    mesh: Mesh,
    form,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxit: int = 500,
    axis: str = "x",
):
    """Distributed CG over a planner banded-window ExecForm: the (nblk, 8, W)
    operand is row-sharded over the mesh, vectors replicated; the sharded
    einsum's output all-gathers each iteration. Returns
    (x, iters, rnorm) with the padded tail trimmed."""
    n_dev = mesh.shape[axis]
    wv = form.bwd_val
    nblk = wv.shape[0]
    nblk_pad = -(-nblk // n_dev) * n_dev
    if nblk_pad != nblk:
        wv = jnp.pad(wv, ((0, nblk_pad - nblk), (0, 0), (0, 0)))
    m_pad = nblk_pad * 8
    # n_pad must still cover every slice after padding rows
    n_pad = max(form.bwd_n_pad, 8 * (form.bwd_base8 + form.bwd_W // 8 - 1 + nblk_pad))
    wv = put(wv, mesh, P(axis, None, None))
    m = form.m
    b = jnp.asarray(b)
    bp = jnp.pad(b, (0, m_pad - b.shape[0]))
    x0p = (
        jnp.zeros((m_pad,), wv.dtype)
        if x0 is None
        else jnp.pad(jnp.asarray(x0), (0, m_pad - np.shape(x0)[0]))
    )
    bp = put(bp.astype(wv.dtype), mesh, P())
    x0p = put(x0p.astype(wv.dtype), mesh, P())

    # the kernel pads x by (padL, n_pad - padL - len): feed the padded-rows
    # vector and let the matvec's internal pad cover the window tail
    sp_ind = sp_rows = sp_val = None
    if form.sp_ind is not None and form.sp_ind.shape[0]:
        sp_ind = put(form.sp_ind, mesh, P())
        sp_rows = put(form.sp_rows, mesh, P())
        sp_val = put(form.sp_val, mesh, P())
    x, k, rnorm = cg_bwd_jit(
        wv,
        bp,
        x0p,
        put(np.asarray(rtol, wv.dtype), mesh, P()),
        put(np.asarray(atol, wv.dtype), mesh, P()),
        maxit,
        form.bwd_W,
        form.bwd_base8,
        form.bwd_padL,
        n_pad,
        sp_ind,
        sp_rows,
        sp_val,
    )
    return _trim(x, m), int(k), float(rnorm)


@lru_cache(maxsize=64)
def _halo_cg_program(mesh, axis, ndev, W, rel_lo, maxit, prec_kind, dspec):
    """The halo CG solve as one compiled program per (mesh, band geometry,
    iteration cap, preconditioner kind): every later solve on the same
    geometry reuses it instead of tracing and compiling again."""
    from .spmv import _bwd_halo_matvec

    matvec, _, _ = _bwd_halo_matvec(axis, ndev, W, rel_lo)

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis), P(axis), dspec, P(), P()),
        out_specs=(P(axis), P(), P()),
    )
    def _cg(wv_c, bl, x0l, dl, rt, at):
        def dot(u, v):
            return jax.lax.psum(jnp.sum(u * v), axis)

        def dot2(u1, v1, u2, v2):
            # two dots fused into ONE psum (each psum is a cross-device
            # barrier; the classic loop paid 3/iteration, this loop pays 2)
            local = jnp.stack([jnp.sum(u1 * v1), jnp.sum(u2 * v2)])
            s = jax.lax.psum(local, axis)
            return s[0], s[1]

        def prec(r):
            return _apply_precond(prec_kind, dl, r)

        bnorm = jnp.sqrt(dot(bl, bl))
        brtol = rt * bnorm
        r0 = matvec(wv_c, x0l) - bl
        z0 = prec(r0)
        rz0, rr0 = dot2(r0, z0, r0, r0)

        def cond(state):
            x, r, p, z, rz, rz_prev, k, rr = state
            rnorm = jnp.sqrt(rr)
            not_conv = jnp.logical_and(rnorm > at, rnorm > brtol)
            return jnp.logical_and(not_conv, k < maxit)

        def body(state):
            x, r, p, z, rz, rz_prev, k, rr = state
            beta = jnp.where(k == 0, jnp.zeros_like(rz), rz / rz_prev)
            p = beta * p - z
            q = matvec(wv_c, p)
            alpha = rz / dot(p, q)
            x = x + alpha * p
            r = r + alpha * q
            z = prec(r)
            rz_new, rr_new = dot2(r, z, r, r)
            return (x, r, p, z, rz_new, rz, k + 1, rr_new)

        state = (
            x0l,
            r0,
            jnp.zeros_like(x0l),
            z0,
            rz0,
            jnp.ones((), bl.dtype),
            jnp.zeros((), jnp.int32),
            rr0,
        )
        x, r, p, z, rz, rz_prev, k, rr = jax.lax.while_loop(cond, body, state)
        return x, k, jnp.sqrt(rr)

    return _cg


def dist_cg_bwd_halo(
    mesh: Mesh,
    form,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxit: int = 500,
    axis: str = "x",
    dinv=None,
):
    """Distributed CG with FULLY SHARDED vectors and ppermute band halos
    inside the while_loop — the multi-step-solver refinement of
    dist_spmv_bwd_halo (SURVEY.md §5.8(i)): per iteration each device moves
    only the W-wide boundary windows of p over the ring (O(W) bytes) plus
    two psum'd scalars, instead of dist_cg_bwd's O(n) all-gather of the
    einsum output. Same iteration as cg_bwd_jit (reference CG task order,
    itsol_functions.hpp:619-870), whole solve = ONE dispatch.

    `dinv` (optional) enables shard-local preconditioning with no extra
    collectives: a length-m array is JACOBI (z = dinv ⊙ r); an
    (m_pad/nb, nb, nb) array of block inverses (parallel/precond.py
    block_jacobi_inv) is BLOCK-JACOBI, applied as one batched einsum —
    dense work, still zero communication. Convergence stays on ||r||₂ like the
    reference CG.

    Contract: square spill-free band ExecForm with the halo narrower than
    one shard. Returns (x, iters, rnorm)."""
    ndev = mesh.shape[axis]
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        raise ValueError("halo path requires a spill-free band form")
    from .spmv import _bwd_halo_matvec, _sharded_band

    W = form.bwd_W
    rel_lo = 8 * form.bwd_base8 - form.bwd_padL
    _, HL, HR = _bwd_halo_matvec(axis, ndev, W, rel_lo)
    m = form.m
    m_pad = -(-m // (8 * ndev)) * 8 * ndev
    if HL > m_pad // ndev or HR > m_pad // ndev:
        raise ValueError("halo wider than a shard: use dist_cg_bwd")
    wv = _sharded_band(form, mesh, axis, m_pad // 8)
    b = jnp.asarray(b)
    bp = put(jnp.pad(b, (0, m_pad - b.shape[0])).astype(wv.dtype), mesh, P(axis))
    x0p = (
        jnp.zeros((m_pad,), wv.dtype)
        if x0 is None
        else jnp.pad(jnp.asarray(x0), (0, m_pad - np.shape(x0)[0])).astype(wv.dtype)
    )
    x0p = put(x0p, mesh, P(axis))
    rtol_c = put(np.asarray(rtol, wv.dtype), mesh, P())
    atol_c = put(np.asarray(atol, wv.dtype), mesh, P())
    dinv_s, dspec, prec_kind = _prep_precond(dinv, mesh, axis, m, m_pad, wv.dtype, bp)
    _cg = _halo_cg_program(mesh, axis, ndev, W, rel_lo, int(maxit), prec_kind, dspec)

    # stash the device program for the collective ledger
    # (utils/collectives.py): the solve is ONE compiled dispatch, so the
    # ledger of _cg IS the wire cost of the whole solver
    dist_cg_bwd_halo.last_inner = (_cg, (wv, bp, x0p, dinv_s, rtol_c, atol_c))
    x, k, rnorm = _cg(wv, bp, x0p, dinv_s, rtol_c, atol_c)
    return _trim(x, m), int(k), float(rnorm)


def dist_cg_pipelined(
    mesh: Mesh,
    form,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxit: int = 500,
    axis: str = "x",
    dinv=None,
):
    """Distributed PIPELINED CG (Ghysels–Vanroose single-reduction variant)
    over the band-halo matvec: per iteration the TWO inner products are
    packed into ONE `psum` of a length-2 vector, and the recurrence is
    rearranged so the matvec q = A·w does NOT depend on that reduction —
    the XLA scheduler is free to run the ppermute+einsum while the psum is
    on the wire. This is the collective-latency-hiding refinement of
    dist_cg_bwd_halo (SURVEY.md §5.8's "overlap with local compute" applied
    to the solver's reductions; the reference, being single-node OpenMP,
    has no analog — its dots are shared-memory).

    Recurrence (unpreconditioned):
        γ=(r,r), δ=(w,r) [one psum];  q = A w  [overlapped]
        β = γ/γ₋ ;  α = γ/(δ − βγ/α₋)
        z←q+βz ; s←w+βs ; p←r+βp ; x←x+αp ; r←r−αs ; w←w−αz
    Convergence on √γ like the reference CG's ||r||₂ test. Extra storage:
    3 vectors over classic CG — the standard pipelining trade.

    `dinv` (optional) switches to the PRECONDITIONED Ghysels–Vanroose
    recurrence with a shard-local M⁻¹: length-m array = Jacobi, an
    (m_pad/nb, nb, nb) block-inverse array (parallel/precond.py) =
    block-Jacobi (one batched einsum). The THREE inner products (γ=(r,u),
    δ=(w,u), ρ=(r,r)) ride the same single fused psum; convergence stays
    on ||r||₂ via ρ.

    Contract matches dist_cg_bwd_halo (square spill-free band form, halo
    narrower than one shard). Returns (x, iters, rnorm)."""
    ndev = mesh.shape[axis]
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        raise ValueError("halo path requires a spill-free band form")
    from .spmv import _bwd_halo_matvec

    W = form.bwd_W
    rel_lo = 8 * form.bwd_base8 - form.bwd_padL
    matvec, HL, HR = _bwd_halo_matvec(axis, ndev, W, rel_lo)
    m = form.m
    m_pad = -(-m // (8 * ndev)) * 8 * ndev
    if HL > m_pad // ndev or HR > m_pad // ndev:
        raise ValueError("halo wider than a shard: use dist_cg_bwd")
    wv = form.bwd_val
    if wv.shape[0] != m_pad // 8:
        wv = jnp.pad(wv, ((0, m_pad // 8 - wv.shape[0]), (0, 0), (0, 0)))
    wv = put(wv, mesh, P(axis, None, None))
    b = jnp.asarray(b)
    bp = put(jnp.pad(b, (0, m_pad - b.shape[0])).astype(wv.dtype), mesh, P(axis))
    x0p = (
        jnp.zeros((m_pad,), wv.dtype)
        if x0 is None
        else jnp.pad(jnp.asarray(x0), (0, m_pad - np.shape(x0)[0])).astype(wv.dtype)
    )
    x0p = put(x0p, mesh, P(axis))
    rtol_c = put(np.asarray(rtol, wv.dtype), mesh, P())
    atol_c = put(np.asarray(atol, wv.dtype), mesh, P())
    dinv_s, dspec, prec_kind = _prep_precond(dinv, mesh, axis, m, m_pad, wv.dtype, bp)
    has_pre = prec_kind is not None

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis), P(axis), dspec, P(), P()),
        out_specs=(P(axis), P(), P()),
    )
    def _pipecg(wv_c, bl, x0l, dl, rt, at):
        def dots(*pairs):
            # the single fused reduction: every dot rides ONE psum
            local = jnp.stack([jnp.sum(u * v) for u, v in pairs])
            return jax.lax.psum(local, axis)

        bnorm = jnp.sqrt(jax.lax.psum(jnp.sum(bl * bl), axis))
        brtol = rt * bnorm
        r0 = bl - matvec(wv_c, x0l)
        zv = jnp.zeros_like(x0l)
        rn0sq = jax.lax.psum(jnp.sum(r0 * r0), axis)
        tolsq = jnp.maximum(at, brtol) ** 2

        # convergence is tested on the ρ=(r,r) that the fused reduction of
        # the PREVIOUS iteration produced (the standard pipelined-CG lag:
        # one extra cheap update past the classic stopping point instead of
        # an extra collective per iteration)
        if not has_pre:

            def cond(st):
                x, r, w, z, s, p, g, a_old, k = st
                return jnp.logical_and(g > tolsq, k < maxit)

            def body(st):
                x, r, w, z, s, p, g_old, a_old, k = st
                gd = dots((r, r), (w, r))  # ONE collective per iteration …
                q = matvec(wv_c, w)  # … overlapped with the matvec
                g, d = gd[0], gd[1]
                beta = jnp.where(k == 0, jnp.zeros_like(g), g / g_old)
                denom = d - beta * g / jnp.where(k == 0, jnp.ones_like(a_old), a_old)
                alpha = g / denom
                # γ already ≤ tol² (the lagged test): freeze the state so
                # the in-flight update cannot disturb the converged x
                conv = g <= tolsq
                alpha = jnp.where(conv, jnp.zeros_like(alpha), alpha)
                z = q + beta * z
                s = w + beta * s
                p = r + beta * p
                x = x + alpha * p
                r = r - alpha * s
                w = w - alpha * z
                k = jnp.where(conv, k, k + 1)
                return (x, r, w, z, s, p, g, jnp.where(conv, a_old, alpha), k)

            w0 = matvec(wv_c, r0)
            st = (
                x0l,
                r0,
                w0,
                zv,
                zv,
                zv,
                rn0sq,
                jnp.ones_like(rn0sq),
                jnp.zeros((), jnp.int32),
            )
            x, r, w, z, s, p, g, a, k = jax.lax.while_loop(cond, body, st)
        else:
            # preconditioned recurrence: u = M⁻¹r, w = A u, and the M⁻¹/A
            # applications of the NEXT search direction happen before the
            # fused reduction lands
            def cond(st):
                x, r, u, w, z, q, s, p, g, a_old, rho, k = st
                return jnp.logical_and(rho > tolsq, k < maxit)

            def body(st):
                x, r, u, w, z, q, s, p, g_old, a_old, rho_old, k = st
                gdr = dots((r, u), (w, u), (r, r))  # ONE collective …
                mh = _apply_precond(prec_kind, dl, w)  # shard-local apply
                nh = matvec(wv_c, mh)  # … overlapped with the matvec
                g, d, rho = gdr[0], gdr[1], gdr[2]
                beta = jnp.where(k == 0, jnp.zeros_like(g), g / g_old)
                denom = d - beta * g / jnp.where(k == 0, jnp.ones_like(a_old), a_old)
                alpha = g / denom
                conv = rho <= tolsq
                alpha = jnp.where(conv, jnp.zeros_like(alpha), alpha)
                z = nh + beta * z
                q = mh + beta * q
                s = w + beta * s
                p = u + beta * p
                x = x + alpha * p
                r = r - alpha * s
                u = u - alpha * q
                w = w - alpha * z
                k = jnp.where(conv, k, k + 1)
                return (x, r, u, w, z, q, s, p, g, jnp.where(conv, a_old, alpha), rho, k)

            u0 = _apply_precond(prec_kind, dl, r0)
            w0 = matvec(wv_c, u0)
            st = (
                x0l,
                r0,
                u0,
                w0,
                zv,
                zv,
                zv,
                zv,
                jnp.ones_like(rn0sq),
                jnp.ones_like(rn0sq),
                rn0sq,
                jnp.zeros((), jnp.int32),
            )
            x, r, u, w, z, q, s, p, g, a, rho, k = jax.lax.while_loop(cond, body, st)
        rnorm = jnp.sqrt(jax.lax.psum(jnp.sum(r * r), axis))
        return x, k, rnorm

    # device program stash for the collective ledger (utils/collectives.py)
    dist_cg_pipelined.last_inner = (_pipecg, (wv, bp, x0p, dinv_s, rtol_c, atol_c))
    x, k, rnorm = _pipecg(wv, bp, x0p, dinv_s, rtol_c, atol_c)
    return _trim(x, m), int(k), float(rnorm)


def dist_cg(
    mesh: Mesh,
    ell_ind,
    ell_val,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxit: int = 500,
    axis: str = "x",
) -> Tuple[jnp.ndarray, int, float]:
    """Distributed CG: shard the operand + vectors over the mesh and run the
    single-dispatch CG. XLA inserts the all-gather/psum collectives."""
    ind_s, val_s, m_pad = prepare_dist_ell(mesh, ell_ind, ell_val, axis)
    m = b.shape[0]
    if m_pad != m:
        b = jnp.pad(jnp.asarray(b), (0, m_pad - m))
    x0 = jnp.zeros((m_pad,), val_s.dtype) if x0 is None else jnp.asarray(x0)
    if x0.shape[0] != m_pad:
        x0 = jnp.pad(x0, (0, m_pad - x0.shape[0]))
    b = put(b.astype(val_s.dtype), mesh, P(axis))
    x0 = put(x0.astype(val_s.dtype), mesh, P(axis))
    x, k, rnorm = cg_ell_jit(
        ind_s,
        val_s,
        b,
        x0,
        put(np.asarray(rtol, val_s.dtype), mesh, P()),
        put(np.asarray(atol, val_s.dtype), mesh, P()),
        maxit,
    )
    return _trim(x, m), int(k), float(rnorm)


def dist_cg_ell_halo(
    mesh: Mesh,
    ell_ind,
    ell_val,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxit: int = 500,
    axis: str = "x",
    dinv=None,
):
    """Distributed CG on GENERAL (non-banded) structure with the
    plan-derived halo exchange inside the while_loop: per iteration each
    device packs exactly the x entries its neighbors' rows reference (host
    schedule, parallel/spmv.py plan_general_halo), trades them in ONE
    `lax.all_to_all` (O(halo) bytes for ANY sparsity), and runs the local
    padded-ELL reduce — the general-structure member of the halo solver
    family (band: dist_cg_bwd_halo). Vectors fully sharded; dots psum'd;
    optional `dinv` (Jacobi / block-Jacobi) as in the band variants.

    ell_ind/ell_val: (m, w) padded-ELL arrays (host). Square operands only
    (the Krylov iterate feeds back into the matvec). Returns
    (x, iters, rnorm)."""
    from .spmv import _general_halo_matvec as _ghm, plan_general_halo

    ndev = mesh.shape[axis]
    ell_ind = np.asarray(ell_ind)
    ell_val = np.asarray(ell_val)
    m = int(np.shape(b)[0])
    m_pad = -(-max(m, ell_ind.shape[0]) // ndev) * ndev
    if ell_ind.shape[0] != m_pad:
        pad = ((0, m_pad - ell_ind.shape[0]), (0, 0))
        ell_ind = np.pad(ell_ind, pad, constant_values=-1)
        ell_val = np.pad(ell_val, pad)
    n_loc = m_pad // ndev
    ind_remap, pack_idx, S_max = plan_general_halo(ell_ind, ndev, n_loc)
    dt = ell_val.dtype
    ind_s = put(jnp.asarray(ind_remap), mesh, P(axis, None))
    val_s = put(jnp.asarray(ell_val), mesh, P(axis, None))
    pidx_s = put(jnp.asarray(pack_idx), mesh, P(axis, None, None))
    bp = put(jnp.asarray(np.pad(np.asarray(b), (0, m_pad - m))).astype(dt), mesh, P(axis))
    x0p = (
        jnp.zeros((m_pad,), dt)
        if x0 is None
        else jnp.pad(jnp.asarray(x0), (0, m_pad - np.shape(x0)[0])).astype(dt)
    )
    x0p = put(x0p, mesh, P(axis))
    rtol_c = put(np.asarray(rtol, dt), mesh, P())
    atol_c = put(np.asarray(atol, dt), mesh, P())
    dinv_s, dspec, prec_kind = _prep_precond(dinv, mesh, axis, m, m_pad, dt, bp)

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None, None), P(axis), P(axis), dspec, P(), P()),
        out_specs=(P(axis), P(), P()),
    )
    def _cg(ind, val, pidx, bl, x0l, dl, rt, at):
        pidx2 = pidx[0]
        mv_body = _ghm(axis)

        def matvec(v):
            return mv_body(ind, val, pidx2, v)

        def dot(u, v):
            return jax.lax.psum(jnp.sum(u * v), axis)

        def dot2(u1, v1, u2, v2):
            # two dots in ONE psum: 2 collectives/iteration instead of 3
            local = jnp.stack([jnp.sum(u1 * v1), jnp.sum(u2 * v2)])
            s = jax.lax.psum(local, axis)
            return s[0], s[1]

        def prec(r):
            return _apply_precond(prec_kind, dl, r)

        bnorm = jnp.sqrt(dot(bl, bl))
        brtol = rt * bnorm
        r0 = matvec(x0l) - bl
        z0 = prec(r0)
        rz0, rr0 = dot2(r0, z0, r0, r0)

        def cond(state):
            x, r, p, z, rz, rz_prev, k, rr = state
            rnorm = jnp.sqrt(rr)
            not_conv = jnp.logical_and(rnorm > at, rnorm > brtol)
            return jnp.logical_and(not_conv, k < maxit)

        def body(state):
            x, r, p, z, rz, rz_prev, k, rr = state
            beta = jnp.where(k == 0, jnp.zeros_like(rz), rz / rz_prev)
            p = beta * p - z
            q = matvec(p)
            alpha = rz / dot(p, q)
            x = x + alpha * p
            r = r + alpha * q
            z = prec(r)
            rz_new, rr_new = dot2(r, z, r, r)
            return (x, r, p, z, rz_new, rz, k + 1, rr_new)

        state = (
            x0l,
            r0,
            jnp.zeros_like(x0l),
            z0,
            rz0,
            jnp.ones((), bl.dtype),
            jnp.zeros((), jnp.int32),
            rr0,
        )
        x, r, p, z, rz, rz_prev, k, rr = jax.lax.while_loop(cond, body, state)
        return x, k, jnp.sqrt(rr)

    x, k, rnorm = _cg(ind_s, val_s, pidx_s, bp, x0p, dinv_s, rtol_c, atol_c)
    return _trim(x, m), int(k), float(rnorm)
