"""SpMM kernels: C = op(A) @ B, sparse x dense (csrmm analog).

Reference: level3/aoclsparse_csrmm.{cpp,hpp} + csrmm_kt.cpp — OpenMP rows x
4-wide column tiles of B. Here each gathered B row is a contiguous vector, so
the (m, w, k) padded form streams whole rows and XLA fuses the masked
multiply into the row reduction. Contractions run at ``precision=HIGHEST``
unless mixed precision was requested (see kernels/xla/spmv.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["spmm_segsum", "spmm_ell", "spmm_ellhyb", "spmm_bwd", "spmm_diag"]


@partial(jax.jit, static_argnames=("m",))
def spmm_segsum(ind, val, row_ids, B, m: int):
    """(nnz,k) gather + segment-sum over rows. The product tile is nnz*k
    elements — at SuiteSparse scale (pwtk: 11.6M nnz, k=64 -> 3 GB f32)
    one tile exhausts HBM, so wide RHS splits into column chunks whose
    tiles stay under ~256M elements (sequential, peak-memory-bound)."""
    import os

    k = B.shape[1]
    nnz = max(int(ind.shape[0]), 1)
    budget = float(os.environ.get("AOCLSPARSE_TPU_SPMM_CHUNK_ELEMS", "64e6"))
    kc = max(int(budget // nnz) // 8 * 8, 8)
    if k <= kc:
        prods = val[:, None] * B[ind]
        return jax.ops.segment_sum(prods, row_ids, num_segments=m, indices_are_sorted=True)
    # column chunks under a lax.scan: unrolled chunks are independent, so
    # XLA schedules them concurrently and the peak allocation is the FULL
    # (nnz, k) tile again (pwtk at k=64 OOM'd); scan forces one live chunk
    nch = -(-k // kc)
    Bp = jnp.pad(B, ((0, 0), (0, nch * kc - k)))
    Bch = jnp.moveaxis(Bp.reshape(B.shape[0], nch, kc), 1, 0)  # (nch, n, kc)

    def step(_, Bc):
        prods = val[:, None] * Bc[ind]
        return None, jax.ops.segment_sum(
            prods, row_ids, num_segments=m, indices_are_sorted=True
        )

    _, outs = jax.lax.scan(step, None, Bch)  # (nch, m, kc)
    return jnp.moveaxis(outs, 0, 1).reshape(m, nch * kc)[:, :k]


@jax.jit
def spmm_ell(ind, val, B):
    """Padded-row form: gather (m, w, k) tiles of B, mask, reduce over w.
    The tile is m*w*k elements — SuiteSparse scale at wide RHS (pwtk:
    218k x 73 x 64 = a 4 GB f32 allocation) exhausts HBM, so wide RHS
    splits into column chunks under a lax.scan (one live chunk)."""
    import os

    m, w = ind.shape
    k = B.shape[1]
    budget = float(os.environ.get("AOCLSPARSE_TPU_SPMM_CHUNK_ELEMS", "64e6"))
    kc = max(int(budget // max(m * w, 1)) // 8 * 8, 8)
    valid = (ind >= 0)[..., None]
    ind_c = jnp.maximum(ind, 0)
    if k <= kc:
        g = jnp.take(B, ind_c, axis=0)  # (m, w, k)
        prods = jnp.where(valid, val[..., None] * g, jnp.zeros((), dtype=val.dtype))
        return jnp.sum(prods, axis=1)
    nch = -(-k // kc)
    Bp = jnp.pad(B, ((0, 0), (0, nch * kc - k)))
    Bch = jnp.moveaxis(Bp.reshape(B.shape[0], nch, kc), 1, 0)  # (nch, n, kc)

    def step(_, Bc):
        g = jnp.take(Bc, ind_c, axis=0)
        prods = jnp.where(valid, val[..., None] * g, jnp.zeros((), dtype=val.dtype))
        return None, jnp.sum(prods, axis=1)

    _, outs = jax.lax.scan(step, None, Bch)  # (nch, m, kc)
    return jnp.moveaxis(outs, 0, 1).reshape(m, nch * kc)[:, :k]


@partial(jax.jit, static_argnames=("m",))
def spmm_ellhyb(ell_ind, ell_val, sp_ind, sp_val, sp_rows, B, m: int):
    C = spmm_ell(ell_ind, ell_val, B)
    if sp_ind.shape[0]:
        C = C + jax.ops.segment_sum(
            sp_val[:, None] * B[sp_ind], sp_rows, num_segments=m, indices_are_sorted=True
        )
    return C


@partial(jax.jit, static_argnames=("G", "Wg", "base", "n_pad", "mixed"))
def spmm_bwd(grp_val, B, G: int, Wg: int, base: int, n_pad: int, mixed: bool = False):
    """Group-banded SpMM (mm KID 3; see spmv_bwd).

    Rows are grouped into blocks of G; each group's band window (G + halo) is
    materialized densely: grp_val (ngrp, G, Wg), window of group g covering
    rows [G*(g + base) .. +Wg) of the padded B. Compute is a lax.scan over
    groups, each step ONE plain 2-D (G x Wg) @ (Wg x k) matmul against a
    window of B — zero gathers; XLA hands each matmul to the GPU's BLAS.
    csrmm analog of the reference's blocked SpMM
    (level3/aoclsparse_csrmm.hpp)."""
    ngrp = grp_val.shape[0]
    k = B.shape[1]
    out_dtype = grp_val.dtype
    acc = jnp.float32 if mixed or grp_val.dtype == jnp.float32 else grp_val.dtype
    if mixed:
        grp_val = grp_val.astype(jnp.bfloat16)
        B = B.astype(jnp.bfloat16)

    # Build all B windows with STATIC slices, then scan plain 2-D matmuls.
    nslice = -(-Wg // G)
    Br2 = B.reshape(-1, G * k)  # (n_pad/G, G*k) — pure view
    wins2 = jnp.concatenate(
        [jax.lax.dynamic_slice_in_dim(Br2, base + j, ngrp, 0) for j in range(nslice)],
        axis=1,
    )  # static starts; (ngrp, nslice*G*k)
    wins = wins2.reshape(ngrp, nslice * G, k)[:, :Wg, :]

    def step(_, args):
        a_g, w_g = args
        return None, jnp.dot(
            a_g, w_g, preferred_element_type=acc, precision=None if mixed else HIGHEST
        )

    _, outs = jax.lax.scan(step, None, (grp_val, wins))
    return outs.reshape(ngrp * G, k).astype(out_dtype)


@partial(jax.jit, static_argnames=("offs", "m", "L", "n_pad"))
def _spmm_diag_unrolled(dvals, B, offs: tuple, m: int, L: int, n_pad: int):
    """Diag-form SpMM as ndiag static shifted elementwise FMAs over the
    padded RHS — the matrix-RHS twin of spmv._spmv_diag_unrolled. One
    fused XLA kernel, gather-free; each diagonal re-reads a shifted (m, k)
    window of B, so traffic is ~ndiag * m * k values."""
    Bp = jnp.pad(B, ((L, n_pad - L - B.shape[0]), (0, 0)))
    acc = jnp.zeros((m, B.shape[1]), dvals.dtype)
    for k, d in enumerate(offs):
        acc = acc + dvals[k][:, None] * jax.lax.dynamic_slice_in_dim(Bp, d + L, m, 0)
    return acc


@partial(jax.jit, static_argnames=("m", "L", "n_pad"))
def _spmm_diag_scan(dvals, offs, B, m: int, L: int, n_pad: int):
    """Scan-over-diagonals SpMM fallback for very many diagonals (compile
    time of the unrolled kernel is O(ndiag)); pays one traced-start
    dynamic_slice per diagonal per step — same tradeoff as
    spmv_diag_scan."""
    Bp = jnp.pad(B, ((L, n_pad - L - B.shape[0]), (0, 0)))

    import numpy as _np

    def step(acc, args):
        dv, off = args
        w = jax.lax.dynamic_slice(
            Bp, (off + _np.int32(L), _np.int32(0)), (m, Bp.shape[1])
        )
        return acc + dv[:, None] * w, None

    acc, _ = jax.lax.scan(
        step,
        jnp.zeros((m, B.shape[1]), dvals.dtype),
        (dvals, offs.astype(jnp.int32)),
    )
    return acc


def spmm_diag(dvals, offs, B, m: int, L: int, n_pad: int, offs_static=None):
    """Dispatcher for the diag execution form's SpMM (mm KID 7): the
    unrolled static-slice kernel up to the unroll cap, the scan form past
    it. Reference role: csrmm over the DIA internal format
    (level3/aoclsparse_csrmm.hpp)."""
    from .spmv import DIA_UNROLL

    if offs_static is not None and len(offs_static) <= DIA_UNROLL:
        offs_t = tuple(int(o) for o in offs_static)
        return _spmm_diag_unrolled(dvals, B, offs_t, m, L, n_pad)
    return _spmm_diag_scan(dvals, offs, B, m, L, n_pad)
