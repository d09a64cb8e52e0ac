#!/usr/bin/env python
"""Pattern-faithful stand-ins for the reference's SuiteSparse benchmark set.

The reference's perf story runs on 29 downloaded SuiteSparse matrices
(/root/reference/tests/benchmarks/matrices/matrixlist:1-29 + the
get_matrices_*.sh fetch scripts); BASELINE.md's configs name scircuit, cant
and pwtk explicitly. This box has zero network egress, so — per the round-3
review — these generators construct STAND-INS that reproduce each matrix's
published structural statistics (dimensions, nnz, nnz/row distribution,
dof-block size, bandwidth/locality class, hub degrees) from the public
SuiteSparse collection pages / the Williams et al. SpMV benchmark-suite
descriptions. They are NOT the real matrices; every emitted result says so.

Published statistics targeted (SuiteSparse collection metadata):

  cant       (Williams/cant):       n=62,451    nnz=4,007,383  avg 64.2/row
             FEM cantilever, 3 dof/node, 3-D mesh -> narrow banded blocks.
  pwtk       (Boeing/pwtk):         n=217,918   nnz=11,524,432 avg 52.9/row
             pressurized wind-tunnel stiffness, 6 dof/node shell mesh ->
             9-node-neighborhood coupling, narrow band.
  scircuit   (Hamm/scircuit):       n=170,998   nnz=958,936    avg 5.6/row
             circuit simulation: near-diagonal local coupling, a few
             hundred-degree power/ground rails (max row ~353), structurally
             symmetric, full diagonal.
  webbase-1M (Williams/webbase-1M): n=1,000,005 nnz=3,105,536  avg 3.1/row
             web link graph: power-law in-degree (max ~4700), dense
             site-local blocks, sparse global tail.

Each generator returns (m, n, ptr, ind, val) CSR arrays, deterministic for
a given seed. Values are standard normal with an optional diagonal boost so
the same operand drives the solver rows (ILU0/CG need nonsingular diagonals).
"""

import numpy as np

__all__ = ["MATRICES", "generate", "cant", "pwtk", "scircuit", "webbase_1m"]


def _dedupe_coo(r, c, m, n):
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.concatenate([[True], (r[1:] != r[:-1]) | (c[1:] != c[:-1])])
    return r[keep], c[keep]


def _finish(r, c, m, n, rng, diag_boost, sym_vals):
    """COO -> CSR with dedupe, guaranteed full diagonal, optional symmetric
    values (FEM operands are symmetric) and diagonal dominance."""
    r = np.asarray(r, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    mask = (r >= 0) & (r < m) & (c >= 0) & (c < n)
    r, c = r[mask], c[mask]
    # full diagonal (all four targets have one; solvers need it)
    d = np.arange(min(m, n), dtype=np.int64)
    r = np.concatenate([r, d])
    c = np.concatenate([c, d])
    r, c = _dedupe_coo(r, c, m, n)
    if sym_vals:
        # one value per unordered pair, mirrored: tie-break on (min,max)
        lo = np.minimum(r, c)
        hi = np.maximum(r, c)
        key = lo * n + hi
        uq, inv = np.unique(key, return_inverse=True)
        vals_uq = rng.standard_normal(uq.size)
        val = vals_uq[inv]
    else:
        val = rng.standard_normal(r.size)
    if diag_boost:
        val[r == c] = np.abs(val[r == c]) + diag_boost
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ptr, r + 1, 1)
    ptr = np.cumsum(ptr)
    return m, n, ptr, c.astype(np.int32), val.astype(np.float32)


def _grid_block_mesh(dims, dof, neigh_offsets, rng, corner_frac=0.0):
    """dof-per-node mesh on a structured grid: every node couples (all dof x
    all dof) to itself and each neighbor at the given grid offsets; an
    optional random fraction of the corner offsets models tet-mesh
    irregularity in the neighbor count."""
    nx, ny, nz = dims
    nn = nx * ny * nz
    idx = np.arange(nn, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    src, dst = [], []
    for (dx, dy, dz, is_corner) in neigh_offsets:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        if is_corner and corner_frac < 1.0:
            ok = ok & (rng.random(nn) < corner_frac)
        j = jx + nx * (jy + ny * jz)
        src.append(idx[ok])
        dst.append(j[ok])
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    # expand node pairs to full dof x dof blocks
    di = np.arange(dof, dtype=np.int64)
    r = (src[:, None, None] * dof + di[None, :, None]) + 0 * di[None, None, :]
    c = (dst[:, None, None] * dof + di[None, None, :]) + 0 * di[None, :, None]
    return r.ravel(), c.ravel()


def cant(rng, diag_boost=0.0):
    """Williams/cant stand-in: 3-dof nodes on a long 631 x 11 x 3 cantilever
    grid (n = 3*20,823 = 62,469 vs published 62,451), 19-point
    face+edge neighborhood plus ~30% of the 8 corner neighbors -> avg 63.9
    nnz/row vs published 64.2; symmetric values."""
    # grid dims fastest-to-slowest: the 3 x 11 cross-section is contiguous
    # and the 631-node beam axis is slowest, giving the natural narrow-band
    # ordering the real matrix ships with (half-bandwidth ~100 dof)
    offsets = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                dist = abs(dx) + abs(dy) + abs(dz)
                if dist == 0:
                    continue
                offsets.append((dx, dy, dz, dist == 3))
    # second ring along the beam axis (quadratic-element reach) at a
    # fraction calibrated so boundary truncation on the thin 11 x 3
    # cross-section still lands at the published ~64 nnz/row
    for dz in (-2, 2):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                offsets.append((dx, dy, dz, True))
    r, c = _grid_block_mesh((3, 11, 631), 3, offsets, rng, corner_frac=0.43)
    m = 631 * 11 * 3 * 3
    return _finish(r, c, m, m, rng, diag_boost, sym_vals=True)


def pwtk(rng, diag_boost=0.0):
    """Boeing/pwtk stand-in: 6-dof nodes on a 227 x 160 shell grid
    (n = 6*36,320 = 217,920 vs published 217,918), full 9-point (8-neighbor)
    node coupling -> ~53 nnz/row vs published 52.9; symmetric values."""
    offsets = [
        (dx, dy, 0, False)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        if (dx, dy) != (0, 0)
    ]
    # sparse second shell (shell-element reach) calibrated to the published
    # 52.9 nnz/row after boundary truncation
    offsets += [(2, 0, 0, True), (-2, 0, 0, True), (0, 2, 0, True), (0, -2, 0, True)]
    r, c = _grid_block_mesh((227, 160, 1), 6, offsets, rng, corner_frac=0.20)
    m = 227 * 160 * 6
    return _finish(r, c, m, m, rng, diag_boost, sym_vals=True)


def scircuit(rng, diag_boost=0.0):
    """Hamm/scircuit stand-in: n=170,998; ~4 local couplings/row within a
    +-24 window, 24 power/ground rail nodes with ~300-entry rows AND columns
    (published max row 353), plus a uniform scatter tail calibrated to land
    near the published nnz=958,936; structurally symmetric."""
    m = 170998
    # local coupling: 2 neighbors per row within +-24, symmetrized
    k_loc = 2
    rows = np.repeat(np.arange(m, dtype=np.int64), k_loc)
    cols = rows + rng.integers(-24, 25, rows.size)
    # rails: high-degree nodes touched by many rows
    n_rail = 24
    rails = rng.choice(m, n_rail, replace=False).astype(np.int64)
    deg = np.clip(rng.zipf(1.35, n_rail), 120, 353)
    rr = np.repeat(rails, deg)
    rc = rng.integers(0, m, rr.size)
    # uniform scatter tail
    n_sc = 67000
    sr = rng.integers(0, m, n_sc)
    sc = rng.integers(0, m, n_sc)
    r = np.concatenate([rows, rr, sr])
    c = np.concatenate([np.clip(cols, 0, m - 1), rc, sc])
    # structural symmetry: mirror every off-diagonal entry
    r2 = np.concatenate([r, c])
    c2 = np.concatenate([c, r])
    return _finish(r2, c2, m, m, rng, diag_boost, sym_vals=False)


def webbase_1m(rng, diag_boost=0.0):
    """Williams/webbase-1M stand-in: n=1,000,005; power-law column (in-link)
    degrees over ~8000 hub pages (max in-degree clipped at the published
    ~4700), dense site-local links within +-128, and a uniform global tail;
    calibrated to land near the published nnz=3,105,536 (avg 3.1/row)."""
    m = 1000005
    # site-local links: ~1.4 per row
    n_loc = int(1.40 * m)
    rows_l = rng.integers(0, m, n_loc)
    cols_l = np.clip(rows_l + rng.integers(-128, 129, n_loc), 0, m - 1)
    # hub out-links (the published max-nnz/ROW ~4700) + hub in-links: zipf
    # over hub ids on both sides, row-side clipped at the published max
    n_hub = int(0.55 * m)
    hub_ids = rng.zipf(1.55, n_hub)
    keep = hub_ids <= 8000
    hub_ids = hub_ids[keep] - 1
    hub_pages = rng.permutation(m)[:8000].astype(np.int64)
    half = hub_ids.size // 2
    # first half: hub pages as link TARGETS (column hubs / in-degree)
    rows_h1 = rng.integers(0, m, half)
    cols_h1 = hub_pages[hub_ids[:half]]
    # second half: hub pages as link SOURCES (row hubs / out-degree),
    # per-hub out-degree clipped at the published max row of ~4700
    ids2 = hub_ids[half:]
    uq, cnt = np.unique(ids2, return_counts=True)
    cnt = np.minimum(cnt, 4700)
    rows_h2 = np.repeat(hub_pages[uq], cnt)
    cols_h2 = rng.integers(0, m, rows_h2.size)
    rows_h = np.concatenate([rows_h1, rows_h2])
    cols_h = np.concatenate([cols_h1, cols_h2])
    # uniform global tail
    n_rand = int(0.33 * m)
    rows_r = rng.integers(0, m, n_rand)
    cols_r = rng.integers(0, m, n_rand)
    r = np.concatenate([rows_l, rows_h, rows_r])
    c = np.concatenate([cols_l, cols_h, cols_r])
    return _finish(r, c, m, m, rng, diag_boost, sym_vals=False)


def rajat31(rng, diag_boost=0.0):
    """Rajat/rajat31 stand-in (round-5 class: HUGE circuit, extreme row
    count): published n=4,690,002, nnz=20,316,253 (avg 4.33/row), circuit
    simulation, structurally symmetric, full diagonal, near-diagonal local
    coupling with a handful of moderate-degree rails. The 4.7M-row scale is
    the point — it stresses 32-bit index headroom and the planner's host
    passes (VERDICT r4 missing item 2)."""
    m = 4690002
    # local coupling ~1.58/row within +-16, symmetrized -> ~3.1/row
    n_loc = int(1.58 * m)
    rows = rng.integers(0, m, n_loc)
    cols = np.clip(rows + rng.integers(-16, 17, n_loc), 0, m - 1)
    # rails: 48 moderate-degree nets (max row degree lands ~1.2k)
    n_rail = 48
    rails = rng.choice(m, n_rail, replace=False).astype(np.int64)
    deg = np.clip(rng.zipf(1.30, n_rail), 200, 1200)
    rr = np.repeat(rails, deg)
    rc = rng.integers(0, m, rr.size)
    # thin uniform scatter tail
    n_sc = int(0.17 * m)
    sr = rng.integers(0, m, n_sc)
    sc = rng.integers(0, m, n_sc)
    r = np.concatenate([rows, rr, sr])
    c = np.concatenate([cols, rc, sc])
    r2 = np.concatenate([r, c])
    c2 = np.concatenate([c, r])
    return _finish(r2, c2, m, m, rng, diag_boost, sym_vals=False)


def asic_680k(rng, diag_boost=0.0):
    """Sandia/ASIC_680k stand-in (round-5 class: circuit with NEARLY-DENSE
    rows): published n=682,862, nnz=3,871,773 (avg 5.67/row); the unsanitized
    ASIC_680k carries a few power/ground nets touching a large fraction of
    all cells (max row degree ~395k — dominates a tenth of the matrix), the
    worst published hub-row case in the 29-matrix list. Stresses the hub/
    spill decomposition far past scircuit's 353-degree rails."""
    m = 682862
    # ultra-dense nets (approximate published max row ~395k)
    rail_deg = np.array([395000, 130000, 70000, 40000, 25000], dtype=np.int64)
    rails = rng.choice(m, rail_deg.size, replace=False).astype(np.int64)
    # rail targets WITHOUT replacement (random draws collide at deg~0.6m and
    # dedupe would shave the published max row back to ~300k)
    rr_l, rc_l = [], []
    for rail, dg in zip(rails, rail_deg):
        rr_l.append(np.full(dg, rail, dtype=np.int64))
        rc_l.append(rng.permutation(m)[:dg].astype(np.int64))
    rr = np.concatenate(rr_l)
    rc = np.concatenate(rc_l)
    # local coupling ~1.32/row within +-12, symmetrized
    n_loc = int(1.32 * m)
    rows = rng.integers(0, m, n_loc)
    cols = np.clip(rows + rng.integers(-12, 13, n_loc), 0, m - 1)
    # mid-degree zipf nets
    n_mid = 600
    mids = rng.choice(m, n_mid, replace=False).astype(np.int64)
    mdeg = np.clip(rng.zipf(1.6, n_mid), 20, 2000)
    mr = np.repeat(mids, mdeg)
    mc = rng.integers(0, m, mr.size)
    r = np.concatenate([rr, rows, mr])
    c = np.concatenate([rc, cols, mc])
    # structural symmetry (mirror) — dense rows are also dense columns
    r2 = np.concatenate([r, c])
    c2 = np.concatenate([c, r])
    return _finish(r2, c2, m, m, rng, diag_boost, sym_vals=False)


def in_2004(rng, diag_boost=0.0):
    """LAW/in-2004 stand-in (round-5 class: 16M-nnz web graph): published
    n=1,382,908, nnz=16,917,053 (avg 12.2/row), crawl of the .in domain in
    LAW URL ordering — strong host locality (pages of one site are a
    contiguous index range and link within it) + power-law global hubs
    (max in-degree ~21.9k). 5.5x webbase's nnz with ~4x its density."""
    m = 1382908
    # site blocks: lognormal sizes (median ~27 pages), contiguous ranges
    sizes = np.maximum(1, rng.lognormal(3.3, 1.2, 120000).astype(np.int64))
    starts = np.concatenate([[0], np.cumsum(sizes)])
    ncover = np.searchsorted(starts, m)
    sizes = sizes[:ncover]
    starts = starts[:ncover]
    sizes[-1] = m - starts[-1]
    # per-page intra-site links: ~8.6 uniform targets within the site block
    page_site = np.repeat(np.arange(ncover), sizes)
    k_in = rng.poisson(10.4, m)
    rows_s = np.repeat(np.arange(m, dtype=np.int64), k_in)
    site_of = np.repeat(page_site, k_in)
    cols_s = starts[site_of] + (
        rng.random(rows_s.size) * sizes[site_of]).astype(np.int64)
    # global hubs: zipf over 30k hub pages, in-degree capped at the
    # published ~21.9k max
    n_hub_links = int(3.0 * m)
    hub_ids = rng.zipf(1.45, n_hub_links)
    hub_ids = hub_ids[hub_ids <= 30000] - 1
    hub_pages = rng.permutation(m)[:30000].astype(np.int64)
    uq, cnt = np.unique(hub_ids, return_counts=True)
    cnt = np.minimum(cnt, 21866)
    cols_h = np.repeat(hub_pages[uq], cnt)
    rows_h = rng.integers(0, m, cols_h.size)
    # out-degree hubs (directory/link pages; published max out ~7.8k)
    n_ohub = 2000
    ohubs = rng.choice(m, n_ohub, replace=False).astype(np.int64)
    odeg = np.clip(rng.zipf(1.6, n_ohub), 50, 7753)
    rows_o = np.repeat(ohubs, odeg)
    cols_o = rng.integers(0, m, rows_o.size)
    # uniform tail
    n_rand = int(0.5 * m)
    rows_r = rng.integers(0, m, n_rand)
    cols_r = rng.integers(0, m, n_rand)
    r = np.concatenate([rows_s, rows_h, rows_o, rows_r])
    c = np.concatenate([cols_s, cols_h, cols_o, cols_r])
    return _finish(r, c, m, m, rng, diag_boost, sym_vals=False)


def _box3(a, reps=2):
    """Separable 3-pass box smoothing of a 3-D field (no scipy dependency)."""
    for _ in range(reps):
        for ax in range(3):
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
    return a


def ldoor(rng, diag_boost=0.0):
    """GHS_psdef/ldoor stand-in (round-5 class: very large FEM, WIDE band):
    published n=952,203, nnz=42,493,817 (avg 44.6/row), SPD 3-dof solid
    mesh of a car door part. Grid 120x60x44 nodes (m=950,400 dof): node
    halfband ~7.3k -> dof halfband ~22k, an order past pwtk's — exercises
    the wide-band planner guards at 42M nnz. Faces + a calibrated fraction
    of edge neighbors land the published ~44.6 nnz/row; symmetric values."""
    offsets = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                dist = abs(dx) + abs(dy) + abs(dz)
                if dist == 0 or dist == 3:
                    continue
                # faces always; edges at the calibrated fraction
                offsets.append((dx, dy, dz, dist == 2))
    r, c = _grid_block_mesh((120, 60, 44), 3, offsets, rng, corner_frac=0.70)
    m = 120 * 60 * 44 * 3
    return _finish(r, c, m, m, rng, diag_boost, sym_vals=True)


def bone010(rng, diag_boost=0.0):
    """Oberwolfach/bone010 stand-in (round-5 class: large IRREGULAR FEM):
    published n=986,703, nnz=47,851,783 (avg 48.5/row), micro-FE model of
    trabecular bone — a porous voxel mesh: locally dense 27-point coupling
    inside bone struts, voids elsewhere. Modeled as a 148x82x82 voxel grid
    masked by thresholded smoothed noise (~33% voxels kept, spatially
    clustered), 3 dof/node; the irregular row-block structure (band with
    holes) is the class cant/pwtk/ldoor don't cover."""
    dims = (148, 82, 82)
    nn_full = dims[0] * dims[1] * dims[2]
    field = _box3(rng.random(dims), reps=2)
    target_nodes = 328901  # published n/3
    thr = np.quantile(field.ravel(), 1.0 - target_nodes / nn_full)
    keep = field >= thr
    keep_flat = keep.ravel(order="F")  # x fastest, matching index math below
    # mapping voxel -> compact node id (kept voxels only)
    node_id = np.cumsum(keep_flat) - 1
    nx, ny, nz = dims
    idx = np.flatnonzero(keep_flat)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    src_n, dst_n = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) == (0, 0, 0):
                    continue
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                ok = (
                    (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                    & (jz >= 0) & (jz < nz)
                )
                if abs(dx) + abs(dy) + abs(dz) == 3:
                    # partial corner coupling calibrated to the published
                    # 48.5 nnz/row (hexahedral micro-FE corner terms)
                    ok = ok & (rng.random(idx.size) < 0.81)
                j = jx + nx * (jy + ny * jz)
                ok = ok & keep_flat[np.where(ok, j, 0)]
                src_n.append(node_id[idx[ok]])
                dst_n.append(node_id[j[ok]])
    src = np.concatenate(src_n)
    dst = np.concatenate(dst_n)
    dof = 3
    di = np.arange(dof, dtype=np.int64)
    r = (src[:, None, None] * dof + di[None, :, None]) + 0 * di[None, None, :]
    c = (dst[:, None, None] * dof + di[None, None, :]) + 0 * di[None, :, None]
    m = int(keep_flat.sum()) * dof
    return _finish(r.ravel(), c.ravel(), m, m, rng, diag_boost, sym_vals=True)


def circuit5m(rng, diag_boost=0.0):
    """Freescale/circuit5M stand-in (round-5 class: >=50M-nnz scale):
    published n=5,558,326, nnz=59,524,291 (avg 10.7/row), post-layout
    circuit with a few power-net rows of ~1M+ entries (published max row
    ~1.29M). The first >=50M-nnz / >=5M-row operand in the tree (VERDICT
    r4 missing item 2): stresses 32-bit index headroom, host-to-device upload,
    planner memory guards, and the hub/spill split simultaneously."""
    m = 5558326
    # power rails: handful of ~1M-degree nets (approx published max 1.29M)
    rail_deg = np.array([1290000, 600000, 300000, 150000, 80000, 40000],
                        dtype=np.int64)
    rails = rng.choice(m, rail_deg.size, replace=False).astype(np.int64)
    # rail targets WITHOUT replacement (keeps the published ~1.29M max row
    # through dedupe)
    rr_l, rc_l = [], []
    for rail, dg in zip(rails, rail_deg):
        rr_l.append(np.full(dg, rail, dtype=np.int64))
        rc_l.append(rng.permutation(m)[:dg].astype(np.int64))
    rr = np.concatenate(rr_l)
    rc = np.concatenate(rc_l)
    # local coupling ~4.4/row within +-64, symmetrized -> ~8.8/row
    n_loc = int(4.4 * m)
    rows = rng.integers(0, m, n_loc)
    cols = np.clip(rows + rng.integers(-64, 65, n_loc), 0, m - 1)
    # mid-degree zipf nets
    n_mid = 6000
    mids = rng.choice(m, n_mid, replace=False).astype(np.int64)
    mdeg = np.clip(rng.zipf(1.5, n_mid), 30, 8000)
    mr = np.repeat(mids, mdeg)
    mc = rng.integers(0, m, mr.size)
    r = np.concatenate([rr, rows, mr])
    c = np.concatenate([rc, cols, mc])
    # structural symmetry (mirror): dense rows are also dense columns
    r2 = np.concatenate([r, c])
    c2 = np.concatenate([c, r])
    return _finish(r2, c2, m, m, rng, diag_boost, sym_vals=False)


MATRICES = {
    "cant": (cant, dict(n=62451, nnz=4007383, cls="FEM 3x3-block band")),
    "pwtk": (pwtk, dict(n=217918, nnz=11524432, cls="FEM 6x6-block band")),
    "scircuit": (scircuit, dict(n=170998, nnz=958936, cls="circuit irregular")),
    "webbase-1M": (webbase_1m, dict(n=1000005, nnz=3105536, cls="web power-law")),
    "rajat31": (rajat31, dict(n=4690002, nnz=20316253, cls="huge circuit 4.7M rows")),
    "ASIC_680k": (asic_680k, dict(n=682862, nnz=3871773, cls="circuit dense-row hubs")),
    "in-2004": (in_2004, dict(n=1382908, nnz=16917053, cls="web 16M-nnz host-local")),
    "ldoor": (ldoor, dict(n=952203, nnz=42493817, cls="FEM wide-band 42M nnz")),
    "bone010": (bone010, dict(n=986703, nnz=47851783, cls="FEM porous irregular")),
    "circuit5M": (circuit5m, dict(n=5558326, nnz=59524291, cls="circuit 59M nnz, 1.3M-deg rails")),
}


def generate(name, seed=7, diag_boost=0.0):
    fn, _pub = MATRICES[name]
    rng = np.random.default_rng(seed)
    return fn(rng, diag_boost=diag_boost)


if __name__ == "__main__":
    import json

    for name in MATRICES:
        m, n, ptr, ind, val = generate(name)
        pub = MATRICES[name][1]
        deg = np.diff(ptr)
        print(
            json.dumps(
                {
                    "name": name,
                    "m": int(m),
                    "nnz": int(ptr[-1]),
                    "pub_n": pub["n"],
                    "pub_nnz": pub["nnz"],
                    "avg_row": round(float(deg.mean()), 2),
                    "max_row": int(deg.max()),
                    "class": pub["cls"],
                }
            )
        )
