"""Blocked triangular solve kernels.

Executes the planner's TrsvForm (planner/triangular.py): a lax.scan over row
blocks; each step does a padded-ELL gather matvec against the already-solved
prefix of x and a dense (nb, nb) `triangular_solve` for the diagonal block.
This replaces the reference's loop-carried scalar sweep
(level2/aoclsparse_trsv_kt.cpp:65-...) with dense block steps; scan length
is m/nb instead of m.

Works for single RHS (trsv) and multi-RHS (trsm: B is (m, k)) identically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

#: contractions must not lower to TF32 (kernels/xla/spmv.py)
HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["trsv_blocked"]


@partial(jax.jit, static_argnames=("nb", "m_pad", "WL"))
def trsv_blocked_win(D, Lwin, b, nb: int, m_pad: int, WL: int):
    """Banded variant: the left-of-diagonal part of each block is a dense
    (nb, WL) window ending at the block start. The scan carries that window
    as a ROLLING buffer (concat + static slice — traced-index dynamic slices
    cost ~0.4 ms each on this stack) and emits each solved block as a scan
    output. b: (m_pad,) or (m_pad, k)."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    k = b.shape[1]
    nblk = D.shape[0]
    dtype = D.dtype
    b = b.astype(dtype)

    def step(w, args):
        # w: (WL, k) = x rows [blk0-WL, blk0) of the current block
        Dk, lwink, bk = args
        s = jnp.einsum("rw,wk->rk", lwink, w, precision=HIGHEST)
        xk = jax.lax.linalg.triangular_solve(
            Dk, bk - s, left_side=True, lower=True, unit_diagonal=False
        )
        w = jnp.concatenate([w, xk], axis=0)[-WL:]
        return w, xk

    w0 = jnp.zeros((WL, k), dtype=dtype)
    bs = b.reshape(nblk, nb, k)
    _, xs = jax.lax.scan(step, w0, (D, Lwin, bs))
    x = xs.reshape(m_pad, k)
    return x[:, 0] if squeeze else x


@jax.jit
def invert_diag_blocks(D):
    """Invert the (nblk, nb, nb) lower-triangular diagonal blocks once
    (scan of 2-D solves). Lets the per-step solve become one matmul
    (trsv_blocked_win_inv; the distributed pipeline uses it)."""
    nb = D.shape[1]
    eye = jnp.eye(nb, dtype=D.dtype)

    def step(_, Dk):
        return None, jax.lax.linalg.triangular_solve(
            Dk, eye, left_side=True, lower=True, unit_diagonal=False
        )

    _, Dinv = jax.lax.scan(step, None, D)
    return Dinv


@partial(jax.jit, static_argnames=("nb", "m_pad", "WL"))
def trsv_blocked_win_inv(Dinv, Lwin, b, nb: int, m_pad: int, WL: int):
    """Rolling-window solve with pre-inverted diagonal blocks: each scan step
    is two dense matmuls (left-window matvec + Dinv multiply) instead of a
    `triangular_solve`. Numerics: inv-multiply instead of substitution;
    within the tolerance model for the well-conditioned diagonal blocks the
    planner builds. No default path selects it; it is the candidate for the
    TRSV cell on the GPU (ROADMAP)."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    k = b.shape[1]
    nblk = Dinv.shape[0]
    dtype = Dinv.dtype
    b = b.astype(dtype)

    def step(w, args):
        Dik, lwink, bk = args
        s = jnp.einsum("rw,wk->rk", lwink, w, precision=HIGHEST)
        xk = jnp.dot(Dik, bk - s, preferred_element_type=dtype, precision=HIGHEST)
        w = jnp.concatenate([w, xk], axis=0)[-WL:]
        return w, xk

    w0 = jnp.zeros((WL, k), dtype=dtype)
    bs = b.reshape(nblk, nb, k)
    _, xs = jax.lax.scan(step, w0, (Dinv, Lwin, bs))
    x = xs.reshape(m_pad, k)
    return x[:, 0] if squeeze else x


@partial(jax.jit, static_argnames=("nb", "m_pad", "WL", "offs", "inv"))
def trsv_blocked_dwin(Dm, Dv, b, nb: int, m_pad: int, WL: int, offs: tuple, inv: bool):
    """Diagonal-window variant for WIDE-band triangles whose left-of-block
    part carries few distinct element diagonals (pwtk-class FEM stencils:
    half-bandwidth ~2729 but only ~50 strictly-lower diagonals). The dense
    (nb, WL) window of trsv_blocked_win needs nblk*nb*WL storage (~2.4 GB
    at pwtk scale — refused by the memory guard, so those triangles rode
    the 0.09 GF/s host fallback; VERDICT r4 item 3). Here the left
    contribution is ndiag static-sliced VPU fmas against a rolling
    solved-x window:

        s[r] = sum_d Dv[blk, d, r] * w_pad[WL - off_d + r]

    with storage ndiag*m_pad and per-step traffic O(ndiag*nb + WL).
    Entries with off_d <= r (intra-block) live in the diagonal block Dm and
    have Dv == 0 here, so the zero-pad read past WL is masked by value.
    Reference sequential kernel this replaces on-device:
    level2/aoclsparse_trsv_kt.cpp:65. b: (m_pad,) or (m_pad, k)."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    k = b.shape[1]
    nblk = Dm.shape[0]
    dtype = Dm.dtype
    b = b.astype(dtype)

    def step(w, args):
        Dk, dvk, bk = args  # dvk: (ndiag, nb)
        wp = jnp.concatenate([w, jnp.zeros((nb, k), dtype)], axis=0)
        s = jnp.zeros((nb, k), dtype)
        for j, d in enumerate(offs):
            s = s + dvk[j][:, None] * jax.lax.slice_in_dim(wp, WL - d, WL - d + nb)
        rhs = bk - s
        if inv:
            xk = jnp.dot(Dk, rhs, preferred_element_type=dtype, precision=HIGHEST)
        else:
            xk = jax.lax.linalg.triangular_solve(
                Dk, rhs, left_side=True, lower=True, unit_diagonal=False
            )
        w = jnp.concatenate([w, xk], axis=0)[-WL:]
        return w, xk

    w0 = jnp.zeros((WL, k), dtype=dtype)
    bs = b.reshape(nblk, nb, k)
    _, xs = jax.lax.scan(step, w0, (Dm, Dv, bs))
    x = xs.reshape(m_pad, k)
    return x[:, 0] if squeeze else x


@partial(jax.jit, static_argnames=("nb", "m_pad"))
def trsv_blocked(D, Lind, Lval, b, nb: int, m_pad: int):
    """Solve L x = b with the blocked lower form. b: (m_pad,) or (m_pad, k)."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    k = b.shape[1]
    nblk = D.shape[0]
    dtype = D.dtype
    b = b.astype(dtype)

    def step(x, args):
        Dk, indk, valk, bk, kidx = args
        # left contribution: (nb, W) gather of solved entries
        xg = x[indk]  # (nb, W, k)
        s = jnp.einsum("rw,rwk->rk", valk, xg.astype(dtype), precision=HIGHEST)
        rhs = bk - s
        xk = jax.lax.linalg.triangular_solve(
            Dk, rhs, left_side=True, lower=True, unit_diagonal=False
        )
        x = jax.lax.dynamic_update_slice(x, xk, (kidx * nb, 0))
        return x, None

    x0 = jnp.zeros((m_pad, k), dtype=dtype)
    bs = b.reshape(nblk, nb, k)
    idx = jnp.arange(nblk)
    x, _ = jax.lax.scan(step, x0, (D, Lind, Lval, bs, idx))
    return x[:, 0] if squeeze else x
