"""Distributed SpGEMM numeric stage.

SURVEY.md §5.8(ii): the reference's shared-memory Gustavson row-merge
(level3/aoclsparse_csr2m.cpp:89-200, per-thread dense markers over a static
row split) becomes, on a mesh: the host symbolic stage partitions the
*product list* by C-row blocks (the same static row split), each device
reduces its products with a local segment-sum, and the sharded C values
concatenate row-aligned — no cross-device traffic in the numeric stage at
all because products are grouped by their output row (A's values replicate;
they are nnz-sized, tiny next to the product stream).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from .placement import fetch, put


@partial(jax.jit, static_argnames=("nnz",))
def _flatten_trim(a, nnz: int):
    return a.reshape(-1)[:nnz]

__all__ = ["partition_products", "dist_spgemm_numeric", "dist_spgemm_rowpart", "dist_spgemm_halo"]


def dist_spgemm_rowpart(mesh: Mesh, effA, effB, axis: str = "x"):
    """Fully row-partitioned distributed SpGEMM (SURVEY §5.8(ii)).

    Gustavson's row-merge is row-local in A: C's row block d depends only on
    A's row block d (plus the B rows it references), so the SYMBOLIC stage
    decomposes into per-partition marker scans — each shard builds its own
    product plan (native C++ spgemm_expand on its nnz-balanced row block;
    on a real multi-host deployment each host runs only its own) — and the
    NUMERIC stage runs shard-local segment-sums with no cross-device
    traffic (B values replicate; they are nnz-sized, small next to the
    product stream). Returns (Cptr, Cind, Cval) host/device triples.
    """
    from ..native import spgemm_expand
    from .partition import nnz_balanced_bounds

    n_dev = mesh.shape[axis]
    mA = effA.shape[0]
    bounds = nnz_balanced_bounds(effA.ptr, n_dev, align=1)
    ptrA = effA.ptr.astype(np.int64)
    indA = effA.ind.astype(np.int64)
    shard_plans = []
    P_max, nnzC_max = 1, 1
    for d in range(n_dev):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        lptr = ptrA[lo : hi + 1] - ptrA[lo]
        lind = indA[ptrA[lo] : ptrA[hi]]
        nat = spgemm_expand(hi - lo, lptr, lind, effB.ptr, effB.ind)
        if nat is None:
            from ..native import available

            raise RuntimeError(
                "shard product list exceeds int32 triple capacity"
                if available()
                else "native spgemm_expand unavailable"
            )
        pa, pb, pc, Cptr_l, Cind_l = nat
        pa = pa.astype(np.int64) + int(ptrA[lo])  # back to global A positions
        shard_plans.append((pa, pb.astype(np.int64), pc.astype(np.int64), Cptr_l, Cind_l))
        P_max = max(P_max, pa.size)
        nnzC_max = max(nnzC_max, int(Cptr_l[-1]))
    # pad per-shard product lists to a common length (padding products hit a
    # scratch slot) and per-shard C blocks to nnzC_max
    pa_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pb_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pc_s = np.full((n_dev, P_max), nnzC_max, dtype=np.int64)
    for d, (pa, pb, pc, _, _) in enumerate(shard_plans):
        pa_s[d, : pa.size] = pa
        pb_s[d, : pb.size] = pb
        pc_s[d, : pc.size] = pc
    pa_d = put(jnp.asarray(pa_s), mesh, P(axis, None))
    pb_d = put(jnp.asarray(pb_s), mesh, P(axis, None))
    pc_d = put(jnp.asarray(pc_s), mesh, P(axis, None))
    a_d = put(jnp.asarray(effA.val), mesh, P())
    b_d = put(jnp.asarray(effB.val), mesh, P())

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(), P()),
        out_specs=P(axis, None),
    )
    def _local(pa, pb, pc, av, bv):
        prods = av[pa[0]] * bv[pb[0]]
        out = jax.ops.segment_sum(prods, pc[0], num_segments=nnzC_max + 1)
        return out[None, :nnzC_max]

    c_blocks = fetch(_local(pa_d, pb_d, pc_d, a_d, b_d))  # (n_dev, nnzC_max)
    # assemble global C: shard offsets are cumulative local nnz counts
    offs = np.cumsum([0] + [int(p[3][-1]) for p in shard_plans])
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    Cind_parts, Cval_parts = [], []
    for d, (_, _, _, Cptr_l, Cind_l) in enumerate(shard_plans):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        Cptr[lo + 1 : hi + 1] = Cptr_l[1:] + offs[d]
        nnz_l = int(Cptr_l[-1])
        Cind_parts.append(Cind_l[:nnz_l])
        Cval_parts.append(c_blocks[d, :nnz_l])
    Cind = np.concatenate(Cind_parts) if Cind_parts else np.zeros(0, np.int32)
    Cval = np.concatenate(Cval_parts) if Cval_parts else np.zeros(0)
    return Cptr, Cind, Cval


def partition_products(plan, n_dev: int):
    """Split a SpgemmPlan's (pa, pb, pc) by C-row blocks into n_dev equal
    shards (padded with no-op products pointing at a scratch slot)."""
    pa = np.asarray(plan.pa)
    pb = np.asarray(plan.pb)
    pc = np.asarray(plan.pc)
    nnzC = plan.nnz
    # device d owns C value rows [d*chunk, (d+1)*chunk)
    chunk = -(-nnzC // n_dev) if nnzC else 1
    owner = np.minimum(pc // chunk, n_dev - 1) if pc.size else pc
    counts = np.bincount(owner, minlength=n_dev) if pc.size else np.zeros(n_dev, np.int64)
    P_max = int(counts.max()) if counts.size else 0
    P_max = max(P_max, 1)
    pa_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pb_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pc_s = np.full((n_dev, P_max), chunk, dtype=np.int64)  # pad -> scratch slot
    for d in range(n_dev):
        sel = owner == d
        cnt = int(counts[d])
        pa_s[d, :cnt] = pa[sel]
        pb_s[d, :cnt] = pb[sel]
        pc_s[d, :cnt] = pc[sel] - d * chunk  # local offsets
    return pa_s, pb_s, pc_s, chunk


def dist_spgemm_numeric(mesh: Mesh, plan, a_val, b_val, axis: str = "x"):
    """Numeric stage on the mesh; returns the (nnzC,) C value vector."""
    n_dev = mesh.shape[axis]
    pa_s, pb_s, pc_s, chunk = partition_products(plan, n_dev)
    pa_d = put(jnp.asarray(pa_s), mesh, P(axis, None))
    pb_d = put(jnp.asarray(pb_s), mesh, P(axis, None))
    pc_d = put(jnp.asarray(pc_s), mesh, P(axis, None))
    a_d = put(jnp.asarray(a_val), mesh, P())
    b_d = put(jnp.asarray(b_val), mesh, P())

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(), P()),
        out_specs=P(axis, None),
    )
    def _local(pa, pb, pc, av, bv):
        prods = av[pa[0]] * bv[pb[0]]
        # chunk+1 segments: the last is the padding scratch slot
        out = jax.ops.segment_sum(prods, pc[0], num_segments=chunk + 1)
        return out[None, :chunk]

    c_blocks = _local(pa_d, pb_d, pc_d, a_d, b_d)  # (n_dev, chunk)
    if not c_blocks.is_fully_addressable:
        # multi-process: eager reshape/slice cannot touch remote shards
        return _flatten_trim(c_blocks, plan.nnz)
    return c_blocks.reshape(-1)[: plan.nnz]


def dist_spgemm_halo(mesh: Mesh, effA, effB, axis: str = "x"):
    """Distributed SpGEMM with B-row HALO EXCHANGE (SURVEY.md §7's "local
    Gustavson row-merge + collective exchange of B rows"; the B-sharded
    refinement of dist_spgemm_rowpart, whose B values replicate).

    Both operands shard by row over the mesh axis on the same uniform row
    bounds. Shard d's products reference B rows indexed by its local A
    columns; when those stay within one neighbor shard (banded/local
    structure — the same applicability condition as the SpMV halo path),
    only the boundary B-row windows move, as two `lax.ppermute`s of
    host-packed value slabs (O(halo nnz) on the wire instead of O(nnzB)
    replication). The symbolic stage runs per-shard (native C++ marker
    scan on the local A rows); pb indices are host-remapped into the
    device-local [left-halo | local | right-halo] value buffer, so the
    numeric stage is one shard-local segment-sum.

    Raises ValueError when a shard needs B rows beyond its ring neighbors
    (callers fall back to dist_spgemm_rowpart). Returns (Cptr, Cind, Cval).
    """
    from ..native import spgemm_expand

    n_dev = mesh.shape[axis]
    mA = effA.shape[0]
    mB = effB.shape[0]
    # uniform row bounds shared by A (C rows) and B (row index space)
    bA = np.linspace(0, mA, n_dev + 1).astype(np.int64)
    bB = np.linspace(0, mB, n_dev + 1).astype(np.int64)
    ptrA = effA.ptr.astype(np.int64)
    indA = effA.ind.astype(np.int64)
    ptrB = effB.ptr.astype(np.int64)

    shard_plans = []  # (pa_global, pb_global, pc_local, Cptr_l, Cind_l)
    P_max, nnzC_max = 1, 1
    for d in range(n_dev):
        lo, hi = int(bA[d]), int(bA[d + 1])
        lptr = ptrA[lo : hi + 1] - ptrA[lo]
        lind = indA[ptrA[lo] : ptrA[hi]]
        # applicability: every referenced B row within ring neighbors
        if lind.size:
            blo = int(bB[d - 1]) if d > 0 else 0
            bhi = int(bB[d + 2]) if d + 2 <= n_dev else mB
            if lind.min() < blo or lind.max() >= bhi:
                raise ValueError(
                    f"shard {d} references B rows outside its ring neighbors"
                )
        nat = spgemm_expand(hi - lo, lptr, lind, effB.ptr, effB.ind)
        if nat is None:
            from ..native import available

            raise RuntimeError(
                "shard product list exceeds int32 triple capacity"
                if available()
                else "native spgemm_expand unavailable"
            )
        pa, pb, pc, Cptr_l, Cind_l = nat
        shard_plans.append(
            (pa.astype(np.int64) + int(ptrA[lo]), pb.astype(np.int64), pc.astype(np.int64), Cptr_l, Cind_l)
        )
        P_max = max(P_max, pa.size)
        nnzC_max = max(nnzC_max, int(Cptr_l[-1]))

    # host value packing: per shard, [local B values | pad], plus the
    # outgoing LEFT slab (the shard's first rows, destined for d-1's right
    # halo) and outgoing RIGHT slab (last rows, for d+1's left halo)
    loc_nnz = [int(ptrB[bB[d + 1]] - ptrB[bB[d]]) for d in range(n_dev)]
    L_max = max(max(loc_nnz), 1)
    halo_nnz_out_r = []  # nnz of shard d's right-edge window that d+1 needs
    halo_nnz_out_l = []
    need_lo, need_hi = [], []
    for d in range(n_dev):
        lo, hi = int(bA[d]), int(bA[d + 1])
        lind = indA[ptrA[lo] : ptrA[hi]]
        nlo = int(lind.min()) if lind.size else int(bB[d])
        nhi = int(lind.max()) + 1 if lind.size else int(bB[d])
        need_lo.append(min(nlo, int(bB[d])))
        need_hi.append(max(nhi, int(bB[d])))
    for d in range(n_dev):
        # shard d's outgoing right slab: B rows [bB[d+1] - r, bB[d+1]) where
        # r covers what d+1 needs below its own start
        take_lo = need_lo[d + 1] if d + 1 < n_dev else int(bB[d + 1])
        out_r = int(ptrB[bB[d + 1]] - ptrB[max(take_lo, int(bB[d]))])
        halo_nnz_out_r.append(out_r)
        take_hi = need_hi[d - 1] if d > 0 else int(bB[d])
        out_l = int(ptrB[min(take_hi, int(bB[d + 1]))] - ptrB[bB[d]])
        halo_nnz_out_l.append(out_l)
    H_r = max(max(halo_nnz_out_r), 1)
    H_l = max(max(halo_nnz_out_l), 1)

    bval = np.asarray(effB.val)
    locB = np.zeros((n_dev, L_max), dtype=bval.dtype)
    outR = np.zeros((n_dev, H_r), dtype=bval.dtype)
    outL = np.zeros((n_dev, H_l), dtype=bval.dtype)
    # host maps for refreshability: source positions into effB.val
    for d in range(n_dev):
        s, e = int(ptrB[bB[d]]), int(ptrB[bB[d + 1]])
        locB[d, : e - s] = bval[s:e]
        r = halo_nnz_out_r[d]
        if r:
            outR[d, :r] = bval[e - r : e]
        l = halo_nnz_out_l[d]
        if l:
            outL[d, :l] = bval[s : s + l]

    # pb remap: global B val position -> local buffer position, buffer =
    # [in_left (H_r slots, from d-1's right slab) | local | in_right (H_l)]
    pa_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pb_s = np.zeros((n_dev, P_max), dtype=np.int64)
    pc_s = np.full((n_dev, P_max), nnzC_max, dtype=np.int64)
    buf_w = H_r + L_max + H_l
    for d, (pa, pb, pc, _, _) in enumerate(shard_plans):
        s, e = int(ptrB[bB[d]]), int(ptrB[bB[d + 1]])
        pbl = np.empty_like(pb)
        in_local = (pb >= s) & (pb < e)
        pbl[in_local] = H_r + (pb[in_local] - s)
        below = pb < s  # lives in d-1's right slab: positions [e_prev-H, e_prev)
        if below.any():
            e_prev = s  # ptrB[bB[d]] == end of shard d-1's values
            r_prev = halo_nnz_out_r[d - 1]
            pbl[below] = pb[below] - (e_prev - r_prev)
        above = pb >= e  # lives in d+1's left slab
        if above.any():
            pbl[above] = H_r + L_max + (pb[above] - e)
        pa_s[d, : pa.size] = pa
        pb_s[d, : pb.size] = pbl
        pc_s[d, : pc.size] = pc

    pa_d = put(jnp.asarray(pa_s), mesh, P(axis, None))
    pb_d = put(jnp.asarray(pb_s), mesh, P(axis, None))
    pc_d = put(jnp.asarray(pc_s), mesh, P(axis, None))
    loc_d = put(jnp.asarray(locB), mesh, P(axis, None))
    outR_d = put(jnp.asarray(outR), mesh, P(axis, None))
    outL_d = put(jnp.asarray(outL), mesh, P(axis, None))
    a_d = put(jnp.asarray(effA.val), mesh, P())

    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    # A values replicate (nnz-sized, small next to the product stream)
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None),) * 6 + (P(),),
        out_specs=P(axis, None),
    )
    def _numeric(pa, pb, pc, av_loc, o_r, o_l, a_rep):
        in_left = jax.lax.ppermute(o_r, axis, fwd)
        in_right = jax.lax.ppermute(o_l, axis, bwd)
        buf = jnp.concatenate([in_left[0], av_loc[0], in_right[0]])
        prods = a_rep[pa[0]] * buf[pb[0]]
        out = jax.ops.segment_sum(prods, pc[0], num_segments=nnzC_max + 1)
        return out[None, :nnzC_max]

    c_blocks = fetch(_numeric(pa_d, pb_d, pc_d, loc_d, outR_d, outL_d, a_d))

    offs = np.cumsum([0] + [int(p[3][-1]) for p in shard_plans])
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    Cind_parts, Cval_parts = [], []
    for d, (_, _, _, Cptr_l, Cind_l) in enumerate(shard_plans):
        lo, hi = int(bA[d]), int(bA[d + 1])
        Cptr[lo + 1 : hi + 1] = Cptr_l[1:] + offs[d]
        nnz_l = int(Cptr_l[-1])
        Cind_parts.append(Cind_l[:nnz_l])
        Cval_parts.append(c_blocks[d, :nnz_l])
    Cind = np.concatenate(Cind_parts) if Cind_parts else np.zeros(0, np.int32)
    Cval = np.concatenate(Cval_parts) if Cval_parts else np.zeros(0)
    return Cptr, Cind, Cval
