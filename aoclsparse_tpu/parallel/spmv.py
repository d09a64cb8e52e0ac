"""Distributed SpMV over a jax.sharding Mesh.

The JAX rebuild of the reference's OpenMP row-partition parallelism
(level2/aoclsparse_csrmv_kt.cpp:53 `#pragma omp parallel for` over rows;
SURVEY.md §2.9): rows of the padded execution format are sharded over the
mesh's "x" axis, the dense input vector is all-gathered (the analog
of shared-memory reads of x), and each shard runs the local gather-multiply-
reduce kernel. XLA overlaps the all-gather with local compute where possible.

Partitioning is row-balanced by padding m to a multiple of n_devices * 8; nnz balancing lands with the planner's distributed mode.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .placement import put

#: contractions must not lower to TF32 (kernels/xla/spmv.py)
HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "make_mesh",
    "shard_ell",
    "spmv_ell_runner",
    "dist_spmv_ell",
    "dist_spmv_ell_sharded_x",
    "dist_spmv_bwd_halo",
    "dist_spmv_bwd_halo_overlap",
    "dist_spmm_bwd_halo",
    "dist_spmv_ell_balanced",
    "plan_general_halo",
    "dist_spmv_ell_halo_plan",
    "dist_spmm_ell_halo_plan",
    "dist_spmv_balanced_halo",
    "compact_balanced",
]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def _pad_rows(a, m_pad):
    if a.shape[0] == m_pad:
        return a
    pad = [(0, m_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    fill = -1 if jnp.issubdtype(a.dtype, jnp.integer) else 0
    return jnp.pad(a, pad, constant_values=fill)


def shard_ell(mesh: Mesh, ell_ind, ell_val, axis: str = "x"):
    """Pad the padded-row (m, w) arrays to a device multiple and place them
    row-sharded on the mesh."""
    n = mesh.shape[axis]
    m = ell_ind.shape[0]
    m_pad = -(-m // n) * n
    ind = put(_pad_rows(ell_ind, m_pad), mesh, P(axis, None))
    val = put(_pad_rows(ell_val, m_pad), mesh, P(axis, None))
    return ind, val, m_pad


def spmv_ell_runner(mesh: Mesh, axis: str = "x"):
    """Traceable core of the row-sharded/replicated-x ELL SpMV: safe to call
    inside jit/fori_loop over pre-sharded operands (used by the fused
    smoother chains, parallel/sweeps.py)."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P()),
        out_specs=P(axis),
    )
    def _local(ind, val, xloc):
        g = jnp.take(xloc, jnp.maximum(ind, 0), axis=0)
        prods = jnp.where(ind >= 0, val * g, jnp.zeros((), dtype=val.dtype))
        return jnp.sum(prods, axis=1)

    return _local


def dist_spmv_ell(mesh: Mesh, ell_ind, ell_val, x, axis: str = "x"):
    """y = A @ x with A row-sharded and x replicated: embarrassingly parallel,
    each device reduces its row block (the direct OpenMP-row-split analog)."""
    xr = put(x, mesh, P())
    return spmv_ell_runner(mesh, axis)(ell_ind, ell_val, xr)


def dist_spmv_ell_sharded_x(mesh: Mesh, ell_ind, ell_val, x_sharded, axis: str = "x"):
    """y = A @ x with BOTH A rows and x sharded: x shards are all-gathered
    over the mesh axis (a collective — the halo-exchange analog of shared-
    memory x reads; SURVEY.md §5.8) before the local reduce."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
    )
    def _local(ind, val, xloc):
        xall = jax.lax.all_gather(xloc, axis, tiled=True)
        g = jnp.take(xall, jnp.maximum(ind, 0), axis=0)
        prods = jnp.where(ind >= 0, val * g, jnp.zeros((), dtype=val.dtype))
        return jnp.sum(prods, axis=1)

    return _local(ell_ind, ell_val, x_sharded)


def _bwd_halo_matvec(axis: str, ndev: int, W: int, rel_lo: int):
    """Build the per-device halo matvec `(wv_c, xloc) -> y_loc` used by the
    halo SpMV and the halo Krylov loops: ppermute the W-wide boundary
    windows over the ring, stitch, run the local band einsum."""
    HL = max(0, -rel_lo)
    HR = max(0, rel_lo + W - 8)
    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
    base_loc = (rel_lo + HL) // 8  # window start inside the extended local x

    def matvec(wv_c, xloc):
        me = jax.lax.axis_index(axis)
        zero = jnp.zeros((), xloc.dtype)
        if HL:
            left = jax.lax.ppermute(xloc[-HL:], axis, fwd)
            left = jnp.where(me == 0, zero, left)  # global left edge: padding
        else:
            left = jnp.zeros((0,), xloc.dtype)
        if HR:
            right = jax.lax.ppermute(xloc[:HR], axis, bwd)
            right = jnp.where(me == ndev - 1, zero, right)
        else:
            right = jnp.zeros((0,), xloc.dtype)
        xe = jnp.concatenate([left, xloc, right])
        pad8 = (-xe.shape[0]) % 8
        if pad8:
            xe = jnp.pad(xe, (0, pad8))
        xr = xe.reshape(-1, 8)
        gloc = wv_c.shape[0]
        pats = jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(xr, base_loc + j, gloc, 0) for j in range(W // 8)],
            axis=1,
        )
        return jnp.einsum("brw,bw->br", wv_c, pats, precision=HIGHEST).reshape(-1)

    return matvec, HL, HR


def _sharded_band(form, mesh: Mesh, axis: str, nblk_pad: int):
    """The form's (nblk, 8, W) band padded to nblk_pad row groups and
    row-sharded over `axis`. Cached on the form (ExecForm.refresh drops the
    cache), so repeated distributed calls do not re-shard a GB-scale
    operand."""
    cache = getattr(form, "_sharded_band", None)
    if cache is None:
        cache = form._sharded_band = {}
    key = (mesh, axis, nblk_pad)
    wv = cache.get(key)
    if wv is None:
        wv = form.bwd_val
        if wv.shape[0] != nblk_pad:
            wv = jnp.pad(wv, ((0, nblk_pad - wv.shape[0]), (0, 0), (0, 0)))
        wv = cache[key] = put(wv, mesh, P(axis, None, None))
    return wv


@lru_cache(maxsize=64)
def _halo_spmv_program(mesh: Mesh, axis: str, ndev: int, W: int, rel_lo: int):
    """The halo SpMV as one compiled program per (mesh, band geometry): run
    eagerly, the shard_map would execute its W/8 window slices one by one."""
    matvec, _, _ = _bwd_halo_matvec(axis, ndev, W, rel_lo)
    return jax.jit(
        shard_map(
            matvec, mesh=mesh, in_specs=(P(axis, None, None), P(axis)), out_specs=P(axis)
        )
    )


def dist_spmv_bwd_halo(mesh: Mesh, form, x_sharded, axis: str = "x"):
    """Banded-window SpMV with x SHARDED and only the band halos exchanged
    via `ppermute` — the §5.8(i) halo-exchange schedule: instead of
    all-gathering the whole x (O(n) bytes per device per call), each device
    receives just the W-wide boundary windows from its ring neighbors
    (O(W) bytes on the wire), which XLA can overlap with the local einsum.

    Requires a square banded ExecForm without spill whose halo fits inside
    one neighbor shard (the planner's band forms satisfy this for
    n >> W * n_devices); callers fall back to the all-gather path
    otherwise. x_sharded: (m_pad,) sharded over `axis`, m_pad a multiple
    of 8*n_devices. Returns y with the same sharding."""
    ndev = mesh.shape[axis]
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        raise ValueError("halo path requires a spill-free band form")
    W = form.bwd_W
    rel_lo = 8 * form.bwd_base8 - form.bwd_padL
    _, HL, HR = _bwd_halo_matvec(axis, ndev, W, rel_lo)
    m_pad = int(x_sharded.shape[0])
    mloc = m_pad // ndev
    if HL > mloc or HR > mloc:
        raise ValueError("halo wider than a shard: use the all-gather path")
    wv = _sharded_band(form, mesh, axis, m_pad // 8)
    return _halo_spmv_program(mesh, axis, ndev, W, rel_lo)(wv, x_sharded)


def dist_spmv_bwd_halo_overlap(mesh: Mesh, form, x_sharded, axis: str = "x"):
    """Halo-exchange band SpMV with COMPUTE/COLLECTIVE OVERLAP (SURVEY.md
    §5.8(i) "overlap with local compute"; the double-buffered refinement of
    dist_spmv_bwd_halo): the local row groups are split into INTERIOR groups
    whose x-windows lie entirely inside the local shard and EDGE groups that
    touch a halo. The interior einsum depends only on the local x shard, so
    the XLA scheduler is free to run it while the two `ppermute`s are still
    on the wire; only the small edge einsums wait for the halos. Same
    contract as dist_spmv_bwd_halo (spill-free band form, halo narrower than
    a shard); falls back to the unsplit path when shards are too small to
    have an interior."""
    ndev = mesh.shape[axis]
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        raise ValueError("halo path requires a spill-free band form")
    W = form.bwd_W
    rel_lo = 8 * form.bwd_base8 - form.bwd_padL
    HL = max(0, -rel_lo)
    HR = max(0, rel_lo + W - 8)
    m_pad = int(x_sharded.shape[0])
    mloc = m_pad // ndev
    if HL > mloc or HR > mloc:
        raise ValueError("halo wider than a shard: use the all-gather path")
    nblk_pad = m_pad // 8
    gloc = nblk_pad // ndev
    # interior groups [g0, g1): local window [8b+rel_lo, 8b+rel_lo+W) in-shard
    g0 = max(0, -(-HL // 8))
    g1 = min(gloc, (mloc - rel_lo - W) // 8 + 1)
    if g1 <= g0:  # shard too small for an interior — nothing to overlap
        return dist_spmv_bwd_halo(mesh, form, x_sharded, axis=axis)
    wv = form.bwd_val
    if wv.shape[0] != nblk_pad:
        wv = jnp.pad(wv, ((0, nblk_pad - wv.shape[0]), (0, 0), (0, 0)))
    wv = put(wv, mesh, P(axis, None, None))
    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
    base = rel_lo + HL  # xe index of local x position 0's window origin

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis)),
        out_specs=P(axis),
    )
    def _local(wv_c, xloc):
        me = jax.lax.axis_index(axis)
        zero = jnp.zeros((), xloc.dtype)
        # issue the halo transfers first …
        if HL:
            left = jax.lax.ppermute(xloc[-HL:], axis, fwd)
            left = jnp.where(me == 0, zero, left)
        else:
            left = jnp.zeros((0,), xloc.dtype)
        if HR:
            right = jax.lax.ppermute(xloc[:HR], axis, bwd)
            right = jnp.where(me == ndev - 1, zero, right)
        else:
            right = jnp.zeros((0,), xloc.dtype)
        # … then the interior einsum, which depends ONLY on xloc: the
        # scheduler can run it concurrently with the ppermutes above
        nint = g1 - g0
        pats_int = jnp.concatenate(
            [
                jax.lax.slice_in_dim(
                    xloc, 8 * g0 + rel_lo + 8 * j, 8 * g0 + rel_lo + 8 * j + 8 * nint
                ).reshape(nint, 8)
                for j in range(W // 8)
            ],
            axis=1,
        )
        y_int = jnp.einsum("brw,bw->br", wv_c[g0:g1], pats_int, precision=HIGHEST)
        # edge groups read the stitched halo window
        xe = jnp.concatenate([left, xloc, right])

        def _edge(b_lo, b_hi):
            nb = b_hi - b_lo
            pats = jnp.concatenate(
                [
                    jax.lax.slice_in_dim(
                        xe, base + 8 * b_lo + 8 * j, base + 8 * b_lo + 8 * j + 8 * nb
                    ).reshape(nb, 8)
                    for j in range(W // 8)
                ],
                axis=1,
            )
            return jnp.einsum("brw,bw->br", wv_c[b_lo:b_hi], pats, precision=HIGHEST)

        parts = []
        if g0:
            parts.append(_edge(0, g0))
        parts.append(y_int)
        if g1 < gloc:
            parts.append(_edge(g1, gloc))
        return jnp.concatenate(parts, axis=0).reshape(-1)

    return _local(wv, x_sharded)


def dist_spmm_bwd_halo(mesh: Mesh, form, B_sharded, axis: str = "x"):
    """Distributed SpMM C = A @ B with A's group-banded (bwdg) form row-
    sharded and the dense RHS B row-sharded — the SpMM half of SURVEY.md
    §5.8(i) (halo exchange "for SpMV/SpMM" overlapped with local compute).

    Each device exchanges only the band's boundary ROW BLOCKS of B over the
    ring (`ppermute`, O(W·K) bytes instead of an O(n·K) all-gather), splits
    its row groups into INTERIOR groups whose B-windows lie inside the
    local shard and EDGE groups touching a halo, and runs the local compute
    as a lax.scan of plain 2-D matmuls (kernels/xla/spmm.py spmm_bwd). The
    interior scan
    depends only on the local B shard, so XLA may run it while the
    ppermutes are on the wire.

    Contract (mirrors dist_spmv_bwd_halo): square spill-free bwdg form,
    B_sharded (m_pad, K) row-sharded over `axis` with m_pad a multiple of
    G * n_devices and the halo narrower than one shard. Returns C with the
    same sharding. Reference role: the OpenMP row split of csrmm
    (level3/aoclsparse_csrmm.hpp:59) rebuilt as a mesh partition."""
    ndev = mesh.shape[axis]
    if form.sp_ind is not None and int(form.sp_ind.shape[0]):
        raise ValueError("halo path requires a spill-free band form")
    G = form.bwd_G
    W = form.bwd_W
    rel = form.bwd_rel  # G-aligned window start in original row coords
    m_pad = int(B_sharded.shape[0])
    K = int(B_sharded.shape[1])
    if m_pad % (G * ndev):
        raise ValueError("B rows must be padded to a multiple of G * n_devices")
    mloc = m_pad // ndev
    HL = max(0, -rel)
    HR = max(0, rel + W - G)
    if HL > mloc or HR > mloc:
        raise ValueError("halo wider than a shard: use a replicated-B path")
    nblk_pad = m_pad // G
    ngl = nblk_pad // ndev
    nslice = -(-W // G)
    wv = form.bwd_val
    if wv.shape[0] != nblk_pad:
        wv = jnp.pad(wv, ((0, nblk_pad - wv.shape[0]), (0, 0), (0, 0)))
    wv = put(wv, mesh, P(axis, None, None))
    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
    # interior groups: the SLICE [G*gl + rel, + nslice*G) (what _wins
    # actually fetches — a G-granular over-read past W) inside [0, mloc)
    nslice_g = -(-W // G)
    gi0 = max(0, -(-HL // G))
    gi1 = min(ngl, mloc // G - rel // G - nslice_g + 1)
    split = gi1 > gi0
    acc = jnp.float32 if wv.dtype in (jnp.float32, jnp.bfloat16) else wv.dtype

    def _scan_mm(wv_part, wins_part):
        def step(_, args):
            a_g, w_g = args
            return None, jnp.dot(a_g, w_g, preferred_element_type=acc, precision=HIGHEST)

        _, outs = jax.lax.scan(step, None, (wv_part, wins_part))
        return outs

    def _wins(src2, off, ngrp_part):
        # src2: (rows/G, G*K) view; static starts
        w2 = jnp.concatenate(
            [
                jax.lax.slice_in_dim(src2, off + j, off + j + ngrp_part, axis=0)
                for j in range(nslice)
            ],
            axis=1,
        )
        return w2.reshape(ngrp_part, nslice * G, K)[:, :W, :]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    def _local(wv_c, Bloc):
        me = jax.lax.axis_index(axis)
        zero = jnp.zeros((), Bloc.dtype)
        # issue the halo transfers first …
        if HL:
            left = jax.lax.ppermute(Bloc[-HL:], axis, fwd)
            left = jnp.where(me == 0, zero, left)
        else:
            left = jnp.zeros((0, K), Bloc.dtype)
        if HR:
            right = jax.lax.ppermute(Bloc[:HR], axis, bwd)
            right = jnp.where(me == ndev - 1, zero, right)
        else:
            right = jnp.zeros((0, K), Bloc.dtype)
        off = (rel + HL) // G  # xe group offset of local group 0's window
        # xe must cover the last edge group's full G-granular slice
        need_rows = G * (off + ngl - 1 + nslice)

        def _xe():
            xe = jnp.concatenate([left, Bloc, right], axis=0)
            pad = max(need_rows - xe.shape[0], (-xe.shape[0]) % G)
            pad += (-(xe.shape[0] + pad)) % G
            if pad:
                xe = jnp.pad(xe, ((0, pad), (0, 0)))
            return xe.reshape(-1, G * K)

        parts = []
        if split:
            # … interior scan depends only on Bloc: overlappable. Window of
            # local group gl starts at row G*gl + rel >= 0 (G-aligned).
            Bloc2 = Bloc.reshape(mloc // G, G * K)
            y_int = _scan_mm(wv_c[gi0:gi1], _wins(Bloc2, gi0 + rel // G, gi1 - gi0))
            xe2 = _xe()
            if gi0:
                parts.append(_scan_mm(wv_c[:gi0], _wins(xe2, off, gi0)))
            parts.append(y_int)
            if gi1 < ngl:
                parts.append(_scan_mm(wv_c[gi1:], _wins(xe2, off + gi1, ngl - gi1)))
        else:
            parts.append(_scan_mm(wv_c, _wins(_xe(), off, ngl)))
        return jnp.concatenate(parts, axis=0).reshape(mloc, K).astype(wv_c.dtype)

    return _local(wv, B_sharded)


def dist_spmv_ell_balanced(mesh: Mesh, ell_ind_stack, x, bounds, val_stack, axis: str = "x"):
    """Row-sharded SpMV over NNZ-BALANCED partitions (parallel/partition.py):
    each device holds a (mloc, w) padded-ELL block covering rows
    [bounds[d], bounds[d+1]) — unequal row counts, ~equal nnz, so skewed
    matrices keep every device busy (the reference's static row split,
    csr2m.cpp:89-101, stalls on skew). x replicated; returns the stacked
    padded (n_parts, mloc) result + bounds for compaction."""
    xr = put(x, mesh, P())
    ind_s = put(ell_ind_stack, mesh, P(axis, None, None))
    val_s = put(val_stack, mesh, P(axis, None, None))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P()),
        out_specs=P(axis, None),
    )
    def _local(ind, val, xloc):
        ind2 = ind[0]
        val2 = val[0]
        g = jnp.take(xloc, jnp.maximum(ind2, 0), axis=0)
        prods = jnp.where(ind2 >= 0, val2 * g, jnp.zeros((), dtype=val2.dtype))
        return jnp.sum(prods, axis=1)[None]

    return _local(ind_s, val_s, xr)


def plan_general_halo(ell_ind, ndev: int, n_loc: int):
    """Host planning for the GENERAL-sparsity halo exchange (SURVEY.md
    §5.8(i) "a plan-derived halo-exchange schedule ... gather remote x
    entries"): from the row-sharded padded-ELL indices, compute per
    (src→dst) pair exactly which x entries must move, so the device program
    exchanges O(halo) values via ONE `all_to_all` instead of all-gathering
    the whole x (dist_spmv_ell_sharded_x). Works for ANY structure — the
    general-matrix counterpart of the band ppermute halo.

    ell_ind: (m_pad, w) global column indices, -1 padding, m_pad divisible
    by ndev; x is split uniformly into ndev shards of n_loc entries.
    Returns (ind_remap, pack_idx, S_max):
      - pack_idx (ndev, ndev, S_max): pack_idx[src, dst] = LOCAL positions
        (into src's x shard) of the entries src sends dst, zero-padded;
      - ind_remap (m_pad, w): per-device-local indices into the stitched
        [x_loc | recv(ndev, S_max)] buffer (-1 padding preserved).
    Vectorized numpy (host structure work rule)."""
    ell_ind = np.asarray(ell_ind)
    m_pad, w = ell_ind.shape
    if m_pad % ndev:
        raise ValueError("ell rows must be padded to a device multiple")
    m_loc = m_pad // ndev
    valid_cols = ell_ind[ell_ind >= 0]
    if valid_cols.size and int(valid_cols.max()) >= ndev * n_loc:
        raise ValueError(
            f"column index {int(valid_cols.max())} outside the sharded x "
            f"(ndev*n_loc = {ndev * n_loc}); pad x / check operand width"
        )
    need = []  # need[dst][src] = sorted unique cols dst needs from src
    for d in range(ndev):
        sl = ell_ind[d * m_loc : (d + 1) * m_loc]
        cols = np.unique(sl[sl >= 0])
        owner = cols // n_loc
        need.append([cols[owner == s] for s in range(ndev)])
    S_max = 1
    for d in range(ndev):
        for s in range(ndev):
            if s != d:
                S_max = max(S_max, need[d][s].size)
    pack_idx = np.zeros((ndev, ndev, S_max), dtype=np.int64)
    for s in range(ndev):
        for d in range(ndev):
            if s == d:
                continue
            lst = need[d][s]
            pack_idx[s, d, : lst.size] = lst - s * n_loc
    ind_remap = np.full_like(ell_ind, -1, dtype=np.int64)
    for d in range(ndev):
        sl = ell_ind[d * m_loc : (d + 1) * m_loc]
        out = np.full(sl.shape, -1, dtype=np.int64)
        valid = sl >= 0
        cols = np.where(valid, sl, 0)
        owner = cols // n_loc
        local = owner == d
        out[valid & local] = (cols - d * n_loc)[valid & local]
        for s in range(ndev):
            if s == d:
                continue
            m = valid & (owner == s)
            if not m.any():
                continue
            pos = np.searchsorted(need[d][s], cols[m])
            out[m] = n_loc + s * S_max + pos
        ind_remap[d * m_loc : (d + 1) * m_loc] = out
    return ind_remap, pack_idx, S_max


def _general_halo_matvec(axis: str):
    """Shared device body of the plan-derived general halo: pack the
    host-scheduled entries with one local gather, trade them in ONE
    `lax.all_to_all`, stitch [local | recv] and run the masked padded-ELL
    reduce. `v` may be (n_loc,) (SpMV/CG) or (n_loc, K) rows (SpMM)."""

    def matvec(ind, val, pidx2, v):
        send = v[pidx2]
        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0, tiled=True)
        if v.ndim == 1:
            buf = jnp.concatenate([v, recv.reshape(-1)])
            g = jnp.take(buf, jnp.maximum(ind, 0), axis=0)
            prods = jnp.where(ind >= 0, val * g, jnp.zeros((), dtype=val.dtype))
        else:
            buf = jnp.concatenate([v, recv.reshape(-1, v.shape[1])], axis=0)
            g = jnp.take(buf, jnp.maximum(ind, 0), axis=0)  # (m_loc, w, K)
            prods = jnp.where(
                (ind >= 0)[..., None], val[..., None] * g, jnp.zeros((), val.dtype)
            )
        return jnp.sum(prods, axis=1)

    return matvec


def dist_spmv_ell_halo_plan(mesh: Mesh, ell_ind, ell_val, x_sharded, axis: str = "x"):
    """General-sparsity SpMV with x SHARDED and a PLAN-DERIVED halo
    exchange: the host schedule (plan_general_halo) says exactly which x
    entries each device pair trades, the device program packs them with one
    local gather, moves them with ONE `lax.all_to_all` (O(halo) bytes,
    any structure), stitches [x_loc | recv] and runs the padded-ELL
    reduce on host-remapped indices. Completes SURVEY.md §5.8(i) beyond the
    band-structured ppermute path (dist_spmv_bwd_halo). The schedule is
    cached on (id-stable) operands by the caller; returns y row-sharded."""
    ndev = mesh.shape[axis]
    n_pad = int(x_sharded.shape[0])
    if n_pad % ndev:
        raise ValueError("x must be padded to a device multiple")
    n_loc = n_pad // ndev
    ell_ind = np.asarray(ell_ind)
    m_pad = ell_ind.shape[0]
    if m_pad % ndev:
        raise ValueError("ell rows must be padded to a device multiple")
    ind_remap, pack_idx, S_max = plan_general_halo(ell_ind, ndev, n_loc)
    ind_s = put(jnp.asarray(ind_remap), mesh, P(axis, None))
    val_s = put(jnp.asarray(ell_val), mesh, P(axis, None))
    pidx_s = put(jnp.asarray(pack_idx), mesh, P(axis, None, None))

    mv_body = _general_halo_matvec(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None, None), P(axis)),
        out_specs=P(axis),
    )
    def _local(ind, val, pidx, xloc):
        return mv_body(ind, val, pidx[0], xloc)

    return _local(ind_s, val_s, pidx_s, x_sharded)


def dist_spmm_ell_halo_plan(mesh: Mesh, ell_ind, ell_val, B_sharded, axis: str = "x"):
    """General-sparsity SpMM C = A @ B with B ROW-SHARDED and a plan-derived
    halo exchange — the SpMM half of §5.8(i) for arbitrary structure (the
    band-structured counterpart is dist_spmm_bwd_halo). The same host
    schedule as dist_spmv_ell_halo_plan decides which B ROWS each device
    pair trades; the device program packs them with one local row gather,
    moves (ndev, S_max, K) slabs in ONE `lax.all_to_all`, and contracts the
    local padded-ELL rows against the stitched [B_loc | recv] row buffer.
    Returns C row-sharded like A."""
    ndev = mesh.shape[axis]
    n_pad = int(B_sharded.shape[0])
    if n_pad % ndev:
        raise ValueError("B rows must be padded to a device multiple")
    n_loc = n_pad // ndev
    ell_ind = np.asarray(ell_ind)
    if ell_ind.shape[0] % ndev:
        raise ValueError("ell rows must be padded to a device multiple")
    ind_remap, pack_idx, S_max = plan_general_halo(ell_ind, ndev, n_loc)
    ind_s = put(jnp.asarray(ind_remap), mesh, P(axis, None))
    val_s = put(jnp.asarray(ell_val), mesh, P(axis, None))
    pidx_s = put(jnp.asarray(pack_idx), mesh, P(axis, None, None))

    mv_body = _general_halo_matvec(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    def _local(ind, val, pidx, Bloc):
        return mv_body(ind, val, pidx[0], Bloc)

    return _local(ind_s, val_s, pidx_s, B_sharded)


def dist_spmv_balanced_halo(mesh: Mesh, ptr, ind, val, x_sharded, axis: str = "x"):
    """NNZ-BALANCED row partition COMPOSED with the plan-derived halo
    exchange — the full §5.8(i) requirement in one schedule: rows split on
    the cumulative-nnz curve (skewed/power-law matrices keep every device
    busy; partition.py), x stays uniformly sharded, and only the
    host-scheduled cross-shard x entries move (one `lax.all_to_all`).

    The balanced ELL stack reshapes directly into the uniform-rows contract
    of dist_spmv_ell_halo_plan: each device owns `mloc` padded rows that
    cover its nnz-balanced row range. Returns (y_padded, bounds, mloc);
    compact with `compact_balanced` (host) — y_padded[p*mloc + r] is row
    bounds[p] + r of the true product."""
    from .partition import nnz_balanced_bounds, pack_balanced_ell

    ndev = mesh.shape[axis]
    # align=1: the padded-ELL halo path has no row-group constraint, and the
    # default 8-row alignment can collapse cuts to 0 under extreme skew
    # (power-law heads with hundreds of nnz in the first few rows)
    bounds = nnz_balanced_bounds(ptr, ndev, align=1)
    src, ind_stack, mloc, bounds = pack_balanced_ell(ptr, ind, ndev, bounds=bounds)
    valh = np.asarray(val)
    vals = np.where(src >= 0, valh[np.clip(src, 0, None)], np.zeros((), valh.dtype))
    w = ind_stack.shape[2]
    y = dist_spmv_ell_halo_plan(
        mesh, ind_stack.reshape(ndev * mloc, w), vals.reshape(ndev * mloc, w), x_sharded, axis=axis
    )
    return y, bounds, mloc


def compact_balanced(y, bounds, mloc: int) -> np.ndarray:
    """Drop the per-part row padding of a balanced-partition result (host)."""
    from .placement import fetch

    yh = fetch(y)
    parts = [
        yh[p * mloc : p * mloc + (int(bounds[p + 1]) - int(bounds[p]))]
        for p in range(len(bounds) - 1)
    ]
    return np.concatenate(parts) if parts else yh[:0]
