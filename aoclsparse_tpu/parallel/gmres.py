"""Single-dispatch restarted GMRES over the banded-window operand.

Perf twin of the host-driven RCI GMRES (solvers/itsol.py): the full restarted
iteration — CGS Arnoldi, Givens rotations, restart cycles — compiles to ONE
XLA program (`while_loop` over cycles, `fori_loop` over the inner Krylov
steps), so a whole solve is a single dispatch. Under a Mesh the operand rows
shard and vectors replicate, like cg_bwd_jit.

Real dtypes (f32/f64); complex solves use the RCI layer. Residual tracked via
the rotated g vector (|g[j+1]|), exactly the reference's recurrence
(itsol_functions.hpp:1133-1160).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .placement import put

#: contractions must not lower to TF32 (kernels/xla/spmv.py)
HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["gmres_bwd_jit", "dist_gmres_bwd", "dist_gmres_bwd_halo"]


@partial(jax.jit, static_argnames=("R", "maxcycles", "W", "base8", "padL", "n_pad"))
def gmres_bwd_jit(
    win_val,
    b,
    x0,
    rtol,
    atol,
    R: int,
    maxcycles: int,
    W: int,
    base8: int,
    padL: int,
    n_pad: int,
    sp_ind=None,
    sp_rows=None,
    sp_val=None,
):
    """Returns (x, cycles, rnorm). R = restart length (static)."""
    mq = b.shape[0]
    dtype = b.dtype
    nblk = win_val.shape[0]
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e3, dtype)

    def matvec(v):
        vp = jnp.pad(v, (padL, n_pad - padL - mq))
        xr = vp.reshape(-1, 8)
        pats = jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(xr, base8 + j, nblk, 0) for j in range(W // 8)],
            axis=1,
        )
        y = jnp.einsum("brw,bw->br", win_val, pats, precision=HIGHEST).reshape(-1)[:mq]
        if sp_ind is not None and sp_ind.shape[0]:
            y = y + jax.ops.segment_sum(
                sp_val * v[sp_ind], sp_rows, num_segments=mq, indices_are_sorted=True
            )
        return y

    bnorm = jnp.sqrt(jnp.sum(b * b))
    brtol = rtol * bnorm

    def inner(j, carry):
        V, H, g, c, s = carry
        w = matvec(V[j])
        hcol = jnp.matmul(V, w, precision=HIGHEST)  # (R+1,)
        mask = jnp.arange(R + 1) <= j
        hcol = jnp.where(mask, hcol, 0)
        w = w - jnp.matmul(hcol, V, precision=HIGHEST)
        hh = jnp.sqrt(jnp.sum(w * w))
        V = V.at[j + 1].set(w / jnp.maximum(hh, tiny))
        hcol = hcol.at[j + 1].set(hh)

        def rot_body(i, hc):
            r1, r2 = hc[i], hc[i + 1]
            pred = i < j
            hc = hc.at[i].set(jnp.where(pred, c[i] * r1 + s[i] * r2, r1))
            hc = hc.at[i + 1].set(jnp.where(pred, -s[i] * r1 + c[i] * r2, r2))
            return hc

        hcol = jax.lax.fori_loop(0, R, rot_body, hcol)
        denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        denom = jnp.maximum(denom, tiny)
        cj = hcol[j] / denom
        sj = hcol[j + 1] / denom
        c = c.at[j].set(cj)
        s = s.at[j].set(sj)
        hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
        H = H.at[:, j].set(hcol)
        gj = g[j]
        g = g.at[j].set(cj * gj).at[j + 1].set(-sj * gj)
        return (V, H, g, c, s)

    def cycle_cond(state):
        x, ncyc, rnorm = state
        not_conv = jnp.logical_and(rnorm > atol, rnorm > brtol)
        return jnp.logical_and(not_conv, ncyc < maxcycles)

    def cycle_body(state):
        x, ncyc, rnorm = state
        r0 = b - matvec(x)
        beta = jnp.sqrt(jnp.sum(r0 * r0))
        V = jnp.zeros((R + 1, mq), dtype).at[0].set(r0 / jnp.maximum(beta, tiny))
        H = jnp.zeros((R + 1, R), dtype)
        g = jnp.zeros((R + 1,), dtype).at[0].set(beta)
        c = jnp.zeros((R,), dtype)
        s = jnp.zeros((R,), dtype)
        V, H, g, c, s = jax.lax.fori_loop(0, R, inner, (V, H, g, c, s))
        y = jax.lax.linalg.triangular_solve(
            H[:R, :R] + jnp.eye(R, dtype=dtype) * tiny, g[:R, None], left_side=True, lower=False
        )[:, 0]
        x = x + jnp.matmul(V[:R].T, y, precision=HIGHEST)
        return (x, ncyc + 1, jnp.abs(g[R]))

    r0 = b - matvec(x0)
    state = (x0, jnp.zeros((), jnp.int32), jnp.sqrt(jnp.sum(r0 * r0)))
    x, ncyc, rnorm = jax.lax.while_loop(cycle_cond, cycle_body, state)
    return x, ncyc, rnorm


def dist_gmres_bwd(
    mesh: Mesh,
    form,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 20,
    maxit: int = 150,
    axis: str = "x",
):
    """Distributed restarted GMRES over a planner bwd ExecForm (rows sharded,
    vectors replicated). Returns (x, iters≈cycles*restart, rnorm)."""
    n_dev = mesh.shape[axis]
    wv = form.bwd_val
    nblk = wv.shape[0]
    nblk_pad = -(-nblk // n_dev) * n_dev
    if nblk_pad != nblk:
        wv = jnp.pad(wv, ((0, nblk_pad - nblk), (0, 0), (0, 0)))
    m_pad = nblk_pad * 8
    n_pad = max(form.bwd_n_pad, 8 * (form.bwd_base8 + form.bwd_W // 8 - 1 + nblk_pad))
    wv = put(wv, mesh, P(axis, None, None))
    m = form.m
    b = jnp.asarray(b)
    bp = put(jnp.pad(b, (0, m_pad - b.shape[0])).astype(wv.dtype), mesh, P())
    x0p = (
        jnp.zeros((m_pad,), wv.dtype)
        if x0 is None
        else jnp.pad(jnp.asarray(x0), (0, m_pad - np.shape(x0)[0])).astype(wv.dtype)
    )
    x0p = put(x0p, mesh, P())
    maxcycles = max(1, -(-maxit // restart))
    sp_ind = sp_rows = sp_val = None
    if form.sp_ind is not None and form.sp_ind.shape[0]:
        sp_ind = put(form.sp_ind, mesh, P())
        sp_rows = put(form.sp_rows, mesh, P())
        sp_val = put(form.sp_val, mesh, P())
    x, ncyc, rnorm = gmres_bwd_jit(
        wv,
        bp,
        x0p,
        jnp.asarray(rtol, wv.dtype),
        jnp.asarray(atol, wv.dtype),
        restart,
        maxcycles,
        form.bwd_W,
        form.bwd_base8,
        form.bwd_padL,
        n_pad,
        sp_ind,
        sp_rows,
        sp_val,
    )
    return x[:m], int(ncyc) * restart, float(rnorm)


def dist_gmres_bwd_halo(
    mesh: Mesh,
    form,
    b,
    x0=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 20,
    maxit: int = 150,
    axis: str = "x",
    dinv=None,
):
    """Distributed restarted GMRES with a SHARDED KRYLOV BASIS and ppermute
    band halos — the GMRES member of the halo-solver family (dist_cg_bwd_halo,
    dist_cg_pipelined). The (R+1, n) basis V is GMRES's dominant memory
    consumer; here every vector (b, x, r, the V rows) is row-sharded, so
    per-device storage is O(R·n/P) instead of dist_gmres_bwd's replicated
    O(R·n). Per inner Arnoldi step the communication is: the W-wide band
    halos of V[j] (two `ppermute`s inside the matvec) plus the WHOLE CGS
    projection as ONE fused psum of an (R+1)-vector (local (R+1,mloc)·w
    matvec-shaped contraction, then psum) and one scalar psum for the
    normalization — independent of n. Givens rotations and the small H solve
    run on replicated scalars, identical to gmres_bwd_jit (reference
    recurrence, itsol_functions.hpp:1133-1160).

    `dinv` (optional) adds shard-local RIGHT preconditioning (Jacobi for a
    length-m array, block-Jacobi for an (m_pad/nb, nb, nb) block-inverse
    array — parallel/precond.py): the Arnoldi operator becomes A·M⁻¹ and
    the cycle update applies M⁻¹ once to the correction (x += M⁻¹(Vᵀy)),
    so the tracked residual stays the TRUE residual — the reference's
    right-preconditioned recurrence (itsol_functions.hpp:1493), zero extra
    collectives.

    Contract matches dist_cg_bwd_halo: square spill-free band ExecForm, halo
    narrower than one shard, real dtypes. Returns (x, iters, rnorm)."""
    from jax import shard_map

    from .cg import _apply_precond, _prep_precond, _trim
    from .spmv import _bwd_halo_matvec

    ndev = mesh.shape[axis]
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        raise ValueError("halo path requires a spill-free band form")
    W = form.bwd_W
    rel_lo = 8 * form.bwd_base8 - form.bwd_padL
    matvec, HL, HR = _bwd_halo_matvec(axis, ndev, W, rel_lo)
    m = form.m
    m_pad = -(-m // (8 * ndev)) * 8 * ndev
    if HL > m_pad // ndev or HR > m_pad // ndev:
        raise ValueError("halo wider than a shard: use dist_gmres_bwd")
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
    R = int(restart)
    maxcycles = max(1, -(-int(maxit) // R))
    dtype = np.dtype(np.float32) if wv.dtype == jnp.float32 else np.dtype(np.float64)
    tiny = float(np.finfo(dtype).tiny * 1e3)

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis), P(axis), dspec, P(), P()),
        out_specs=(P(axis), P(), P()),
    )
    def _gmres(wv_c, bl, x0l, dl, rt, at):
        dt = bl.dtype
        mloc = bl.shape[0]
        tiny_c = jnp.asarray(tiny, dt)

        def psum(v):
            return jax.lax.psum(v, axis)

        def nrm(v):
            return jnp.sqrt(psum(jnp.sum(v * v)))

        bnorm = nrm(bl)
        brtol = rt * bnorm

        def inner(j, carry):
            V, H, g, c, s = carry
            w = matvec(wv_c, _apply_precond(prec_kind, dl, V[j]))
            # whole CGS projection = ONE fused psum of an (R+1)-vector
            hcol = psum(jnp.matmul(V, w, precision=HIGHEST))
            mask = jnp.arange(R + 1) <= j
            hcol = jnp.where(mask, hcol, 0)
            w = w - jnp.matmul(hcol, V, precision=HIGHEST)
            hh = nrm(w)
            V = V.at[j + 1].set(w / jnp.maximum(hh, tiny_c))
            hcol = hcol.at[j + 1].set(hh)

            def rot_body(i, hc):
                r1, r2 = hc[i], hc[i + 1]
                pred = i < j
                hc = hc.at[i].set(jnp.where(pred, c[i] * r1 + s[i] * r2, r1))
                hc = hc.at[i + 1].set(jnp.where(pred, -s[i] * r1 + c[i] * r2, r2))
                return hc

            hcol = jax.lax.fori_loop(0, R, rot_body, hcol)
            denom = jnp.maximum(jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2), tiny_c)
            cj = hcol[j] / denom
            sj = hcol[j + 1] / denom
            c = c.at[j].set(cj)
            s = s.at[j].set(sj)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            H = H.at[:, j].set(hcol)
            gj = g[j]
            g = g.at[j].set(cj * gj).at[j + 1].set(-sj * gj)
            return (V, H, g, c, s)

        def cycle_cond(state):
            x, ncyc, rnorm = state
            not_conv = jnp.logical_and(rnorm > at, rnorm > brtol)
            return jnp.logical_and(not_conv, ncyc < maxcycles)

        def cycle_body(state):
            x, ncyc, rnorm = state
            r0 = bl - matvec(wv_c, x)
            beta = nrm(r0)
            V = jnp.zeros((R + 1, mloc), dt).at[0].set(r0 / jnp.maximum(beta, tiny_c))
            H = jnp.zeros((R + 1, R), dt)
            g = jnp.zeros((R + 1,), dt).at[0].set(beta)
            c = jnp.zeros((R,), dt)
            s = jnp.zeros((R,), dt)
            V, H, g, c, s = jax.lax.fori_loop(0, R, inner, (V, H, g, c, s))
            y = jax.lax.linalg.triangular_solve(
                H[:R, :R] + jnp.eye(R, dtype=dt) * tiny_c,
                g[:R, None],
                left_side=True,
                lower=False,
            )[:, 0]
            upd = jnp.matmul(V[:R].T, y, precision=HIGHEST)  # shard-local update
            x = x + _apply_precond(prec_kind, dl, upd)
            return (x, ncyc + 1, jnp.abs(g[R]))

        r0 = bl - matvec(wv_c, x0l)
        state = (x0l, jnp.zeros((), jnp.int32), nrm(r0))
        x, ncyc, rnorm = jax.lax.while_loop(cycle_cond, cycle_body, state)
        return x, ncyc, rnorm

    # device program stash for the collective ledger (utils/collectives.py)
    dist_gmres_bwd_halo.last_inner = (_gmres, (wv, bp, x0p, dinv_s, rtol_c, atol_c))
    x, ncyc, rnorm = _gmres(wv, bp, x0p, dinv_s, rtol_c, atol_c)
    return _trim(x, m), int(ncyc) * R, float(rnorm)
