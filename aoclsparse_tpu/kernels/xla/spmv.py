"""SpMV compute kernels (XLA path).

JAX redesign of the reference's SpMV kernel zoo
(level2/aoclsparse_csrmv_kt.cpp:31-108, csrmv_kr.hpp:450, blkcsrmv_avx512.cpp,
ellmv.hpp, diamv.hpp, bsrmv.cpp). Where the reference vectorizes each row over
AVX lanes with gather+FMA+hsum, every operand here is a statically-shaped
array so XLA can fuse and tile it:

- ``spmv_segsum``     COO-flavored: one gather of x, elementwise multiply,
                      segment-sum by row id. Works for any CSR via precomputed
                      row ids; the general-purpose fallback.
- ``spmv_ell``        padded-row gather kernel: (m, w) gather + masked
                      multiply + row reduce. The analog of the reference's
                      ELL/BLKCSR/BR4 lane-blocked layouts.
- ``spmv_ellhyb``     ELL head + COO spill (ellthybmv analog).
- ``spmv_bsr``        dense (bs, bs) blocks ride a batched matmul.
- ``spmv_dia``        per-diagonal shifted multiply (diamv analog).

All kernels are pure functions of arrays (jit-cached by shape); structure
arrays (row ids, padding maps) are built host-side by the planner once.

Contractions run at ``precision=HIGHEST`` unless the caller opted into mixed
precision: XLA may otherwise lower a float32 contraction to TF32 on a GPU,
which keeps about three decimal digits and breaks the reference's float32
tolerance model (utils/tolerances.py, docs/precision.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "csr_row_ids",
    "spmv_segsum",
    "spmv_sell",
    "spmv_ell",
    "spmv_ellhyb",
    "spmv_bsr",
    "spmv_dia",
    "spmv_bwdg",
    "spmv_csr_dense_ref",
]


def csr_row_ids(ptr) -> np.ndarray:
    """Host-side: expand CSR ptr to per-nnz row ids (int32)."""
    ptr = np.asarray(ptr)
    return np.repeat(np.arange(ptr.size - 1, dtype=np.int32), np.diff(ptr))


@partial(jax.jit, static_argnames=("m",))
def spmv_segsum(ind, val, row_ids, x, m: int):
    """y = A @ x via gather + segment-sum. `row_ids` must be sorted
    (CSR order), letting XLA use the scan-based segment-sum lowering."""
    prods = val * x[ind]
    return jax.ops.segment_sum(prods, row_ids, num_segments=m, indices_are_sorted=True)


@partial(jax.jit, static_argnames=("m",))
def spmv_sell(ind, val, row_ids, x, m: int):
    """y = A @ x over the flattened sliced-ELL layout (core/formats.py SELL):
    8-row slices each padded to a lane-multiple width. Padding entries carry
    val == 0 and an in-range column, so unlike spmv_ell no validity mask is
    needed, and unlike spmv_segsum the buffer is tile-aligned per slice.
    `row_ids` are the precomputed per-entry destination rows (sorted — slice
    layout is row-major). Plays the reference's BLKCSR/BR4 dispatch role
    (aoclsparse_analysis.cpp:35-385) as an explicit-KID alternative form."""
    prods = val * x[ind]
    return jax.ops.segment_sum(prods, row_ids, num_segments=m, indices_are_sorted=True)


@jax.jit
def spmv_ell(ind, val, x):
    """y = A @ x over padded rows: ind/val are (m, w), padding ind == -1.

    One big gather (memory-bound, matching SpMV's roofline), masked multiply,
    row-sum — everything statically shaped.
    """
    gathered = jnp.take(x, jnp.maximum(ind, 0), axis=0)
    prods = jnp.where(ind >= 0, val * gathered, jnp.zeros((), dtype=val.dtype))
    return jnp.sum(prods, axis=1)


@partial(jax.jit, static_argnames=("m",))
def spmv_ellhyb(ell_ind, ell_val, sp_ind, sp_val, sp_rows, x, m: int):
    """Hybrid: ELL head + COO spill segment-sum (ellthybmv analog)."""
    y = spmv_ell(ell_ind, ell_val, x)
    if sp_ind.shape[0]:
        y = y + jax.ops.segment_sum(
            sp_val * x[sp_ind], sp_rows, num_segments=m, indices_are_sorted=True
        )
    return y


@partial(jax.jit, static_argnames=("mb", "block_dim"))
def spmv_bsr(ptr_rows, ind, val, x, mb: int, block_dim: int):
    """BSR SpMV: gather x blocks then batched block matvec + block-row
    segment-sum. `ptr_rows` is per-block block-row ids (host-precomputed).
    bsrmv analog (level2/aoclsparse_bsrmv.cpp:179)."""
    bs = block_dim
    n_pad = x.shape[0]
    # gather the x block for each stored block: (nnzb, bs)
    xb = x[(ind[:, None] * bs + jnp.arange(bs)[None, :]).reshape(-1)].reshape(-1, bs)
    # (nnzb, bs, bs) @ (nnzb, bs) -> (nnzb, bs)
    prod = jnp.einsum(
        "krc,kc->kr", val, xb, preferred_element_type=val.dtype, precision=HIGHEST
    )
    yb = jax.ops.segment_sum(prod, ptr_rows, num_segments=mb, indices_are_sorted=True)
    return yb.reshape(mb * bs)


def spmv_dia(dist: tuple, val, x, m: int, n: int):
    """DIA SpMV: ndiag static shifted multiplies (diamv analog). `dist` is a
    static tuple so the loop unrolls at trace time into fused elementwise ops."""

    @partial(jax.jit, static_argnames=("dist", "m", "n"))
    def _run(val, x, dist, m, n):
        y = jnp.zeros((m,), dtype=val.dtype)
        rows = jnp.arange(m)
        for k, d in enumerate(dist):
            cols = rows + d
            ok = (cols >= 0) & (cols < n)
            xg = x[jnp.clip(cols, 0, n - 1)]
            y = y + jnp.where(ok, val[k] * xg, jnp.zeros((), dtype=val.dtype))
        return y

    return _run(val, x, tuple(int(d) for d in dist), m, n)


@partial(jax.jit, static_argnames=("W", "base8", "n_pad", "mixed"))
def spmv_bwd(win_val, x, W: int, base8: int, n_pad: int, mixed: bool = False):
    """Banded-window dense SpMV (explicit-KID form; the planner default is
    the gather forms).

    Replacement for the reference's AVX-blocked formats (BLKCSR/BR4,
    aoclsparse_analysis.cpp:35-385) without gathers: the planner
    materializes each 8-row block's band window densely,

        win_val: (nblk, 8, W) with win_val[b, r, t] = A[8b+r, 8b*?+rel]
        window of block b covers columns [8*(b + base8') .. +W)

    and the kernel is ONE batched matvec over statically-sliced x windows;
    traffic = m*W values (the planner bounds the blowup m*W/nnz).

    x is pre-padded to n_pad (multiple of 8, covering every window);
    `base8` is the first block's window start in 8-element units into the
    padded x. With mixed=True the multiply runs in bfloat16 with f32
    accumulation (docs/precision.md; off for parity tests).
    """
    nblk = win_val.shape[0]
    xr = x.reshape(-1, 8)  # (n_pad/8, 8)
    pats = jnp.concatenate(
        [jax.lax.dynamic_slice_in_dim(xr, base8 + j, nblk, 0) for j in range(W // 8)],
        axis=1,
    )  # (nblk, W)
    if mixed:
        out = jnp.einsum(
            "brw,bw->br",
            win_val.astype(jnp.bfloat16),
            pats.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).astype(win_val.dtype)
    else:
        out = jnp.einsum("brw,bw->br", win_val, pats, precision=HIGHEST)
    return out.reshape(-1)


@partial(
    jax.jit,
    static_argnames=(
        "B",
        "W",
        "base8",
        "padL",
        "n_pad",
        "m",
        "m_pad",
        "mixed",
        "has_hub",
        "has_hubrow",
        "has_spill",
        "has_flip",
    ),
)
def spmv_gen(
    win_val,
    x,
    bperm,
    bout,
    flip,
    hub_slab,
    hub_cols,
    hubr_slab,
    hubr_rows,
    sp_val,
    sp_ind,
    sp_rows,
    B: int,
    W: int,
    base8: int,
    padL: int,
    n_pad: int,
    m: int,
    m_pad: int,
    mixed: bool = False,
    has_hub: bool = False,
    has_hubrow: bool = False,
    has_spill: bool = False,
    has_flip: bool = False,
):
    """General-sparsity SpMV: block-RCM-permuted band window + dense
    hub-column slab + COO spill, fused into ONE compiled program.

    The decomposition P A P^T = Band + HubSlab + Spill is planner-built
    (plan._build_gen). P is BLOCK-granular (B-element blocks of the index
    space are reordered whole), so the x/y permutes are reshaped panel
    gathers, not scalar gathers. After permutation, near-diagonal entries
    ride the banded-window dense form (spmv_bwd layout), dense columns
    (power-law hubs, ORIGINAL column ids) become a dense (m_pad, k) slab,
    and window outliers spill to a sorted segment-sum. Covers the
    structure classes the reference's gather-kernel SpMV handles
    uniformly (level2/aoclsparse_csrmv_kt.cpp:31-108).
    """
    nblk = m_pad // B
    xb = jnp.pad(x, (0, m_pad - x.shape[0])).reshape(nblk, B)
    xpb = xb[bperm]  # (nblk, B) block-permuted x
    if has_flip:
        # per-block orientation (planner _block_flips): dense where-reverse,
        # negligible next to the band stream
        xpb = jnp.where(flip[:, None], xpb[:, ::-1], xpb)
    xp = xpb.reshape(-1)  # (m_pad,)
    xpad = jnp.pad(xp, (padL, n_pad - padL - m_pad))
    yp = spmv_bwd(win_val, xpad, W, base8, n_pad, mixed)[:m_pad]
    if has_spill:
        yp = yp + jax.ops.segment_sum(
            sp_val * xp[sp_ind], sp_rows, num_segments=m_pad, indices_are_sorted=True
        )
    if has_hub:
        if mixed:
            yp = yp + (
                hub_slab.astype(jnp.bfloat16) @ x[hub_cols].astype(jnp.bfloat16)
            ).astype(yp.dtype)
        else:
            yp = yp + jnp.matmul(hub_slab, x[hub_cols], precision=HIGHEST)
    if has_hubrow:
        # dense rows (transpose-side hubs): (kr, m_pad) slab against the
        # permuted x, scattered back at kr permuted row positions
        if mixed:
            contrib = (
                hubr_slab.astype(jnp.bfloat16) @ xp.astype(jnp.bfloat16)
            ).astype(yp.dtype)
        else:
            contrib = jnp.matmul(hubr_slab, xp, precision=HIGHEST)
        yp = yp.at[hubr_rows].add(contrib)
    ypb = yp.reshape(nblk, B)
    if has_flip:
        ypb = jnp.where(flip[:, None], ypb[:, ::-1], ypb)
    return ypb[bout].reshape(-1)[:m]


@partial(jax.jit, static_argnames=("G", "W", "rel", "m", "mixed"))
def spmv_bwdg(band, x, G: int, W: int, rel: int, m: int, mixed: bool = False):
    """SpMV over a G-row-group group-relative band: ``band`` is
    (nblk, G, W) with band[g, r, c] = A[G*g + r, G*g + rel + c].

    This is the storage layout the band x band SpGEMM numeric engine emits
    for C (kernels/xla/spgemm_band.py), so a product result can be consumed
    by SpMV directly — no CSR extraction gather, no relayout. Same static-slice x-window trick as :func:`spmv_bwd`, at
    group granularity G: x is padded so every window start is G-aligned,
    then each window is a concat of consecutive G-blocks. The einsum is a
    batched matvec. Reference role: csrmv over an optimized internal
    format (level2/aoclsparse_mv.cpp:179 format switch).
    """
    nblk = band.shape[0]
    # left-pad so window starts (G*g + rel) become G-aligned and non-negative
    padL = (-rel) % G
    while rel + padL < 0:
        padL += G
    d = (rel + padL) // G  # first window's start, in G-blocks of padded x
    nsl = -(-W // G)  # G-blocks spanned by one (G-aligned) window
    # padded blocks: cover every window AND all of x (x can extend past the
    # last window when the band only touches a left portion of the columns)
    nbx = max(d + nblk + nsl, -(-(padL + x.shape[0]) // G))
    xp = jnp.pad(x, (padL, nbx * G - padL - x.shape[0]))
    xg = xp.reshape(nbx, G)
    win = jnp.concatenate(
        [jax.lax.dynamic_slice_in_dim(xg, d + j, nblk, 0) for j in range(nsl)],
        axis=1,
    )  # (nblk, nsl*G); row g = padded cols [G*(d+g), +nsl*G)
    if nsl * G != W:
        win = jax.lax.slice_in_dim(win, 0, W, axis=1)
    if mixed:
        out = jnp.einsum(
            "grw,gw->gr",
            band.astype(jnp.bfloat16),
            win.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).astype(band.dtype)
    else:
        out = jnp.einsum("grw,gw->gr", band, win, precision=HIGHEST)
    return out.reshape(-1)[:m]


#: unroll threshold: static slices fuse into one kernel (fast); beyond this,
#: compile time would grow linearly so we fall back to the on-device scan
# unrolled static-slice cap: one fused XLA kernel, no scan/dynamic-slice
# overhead. 6x6-block shell meshes (pwtk class) carry ~150 distinct element
# diagonals, which the round-4 real-matrix sweep showed must ride this path
# (the gen fallback built a 2.4 GB band there)
DIA_UNROLL = 192


def spmv_diag(dvals, offs, x, m: int, L: int, n_pad: int, offs_static=None):
    """Dispatcher: unrolled static-slice kernel for few diagonals (fuses into
    one XLA kernel like spmv_bwd), scan fallback for many."""
    if offs_static is not None and len(offs_static) <= DIA_UNROLL:
        return _spmv_diag_unrolled(dvals, x, tuple(int(o) for o in offs_static), m, L, n_pad)
    return spmv_diag_scan(dvals, offs, x, m, L, n_pad)


@partial(jax.jit, static_argnames=("offs", "m", "L", "n_pad"))
def _spmv_diag_unrolled(dvals, x, offs: tuple, m: int, L: int, n_pad: int):
    xp = jnp.pad(x, (L, n_pad - L - x.shape[0]))
    acc = jnp.zeros((m,), dvals.dtype)
    for k, d in enumerate(offs):
        acc = acc + dvals[k] * jax.lax.dynamic_slice_in_dim(xp, d + L, m, 0)
    return acc


@partial(jax.jit, static_argnames=("m", "L", "n_pad"))
def spmv_diag_scan(dvals, offs, x, m: int, L: int, n_pad: int):
    """Scan-over-diagonals SpMV — the gather-free form for stencil-type
    matrices (few distinct generalized diagonals j-i, arbitrary spread —
    where the contiguous band window of spmv_bwd would explode; e.g. 5/7/27-
    point finite-difference stencils).

    dvals (ndiag, m) holds diagonal d's values aligned to rows; each scan
    step is one shifted elementwise FMA. DIA kernel analog
    (level2/aoclsparse_diamv.hpp) rebuilt as a single compiled scan so
    compile time is O(1) in ndiag."""
    xp = jnp.pad(x, (L, n_pad - L - x.shape[0]))

    def step(acc, args):
        dv, off = args
        xs = jax.lax.dynamic_slice(xp, (off + L,), (m,))
        return acc + dv * xs, None

    acc, _ = jax.lax.scan(
        step, jnp.zeros((m,), dvals.dtype), (dvals, offs.astype(jnp.int32))
    )
    return acc


@partial(jax.jit, static_argnames=("m", "n"))
def spmv_csr_dense_ref(ind, val, row_ids, x, m: int, n: int):
    """Debug-only: materialize dense then matmul (tiny matrices)."""
    A = jnp.zeros((m, n), dtype=val.dtype).at[row_ids, ind].add(val)
    return jnp.matmul(A, x, precision=HIGHEST)
