"""Native host-kernel bindings (ctypes over src/host_kernels.cpp).

C++ is used exactly where the reference uses it for host-side sequential
work (ILU0 factorization, ilu0.hpp:37-112; Gustavson symbolic scan,
csr2m.cpp:89-200) plus the level-scheduling analysis the planner adds.
The library is compiled on first use with g++ into this package directory
and cached under a name keyed on a hash of the source, the build flags and
the host CPU (``-march=native`` code runs only where it was built), so a
stale build or one copied from another machine is never loaded. Every entry
point has a numpy fallback so the package works without a toolchain
(`AOCLSPARSE_TPU_NO_NATIVE=1` forces the fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "trsv_win_build",
    "available",
    "blkcsr_build",
    "blkcsr_count",
    "ilu0_factor",
    "level_schedule",
    "rcm_permutation",
    "spgemm_nnz",
    "spgemm_expand",
    "spgemm_pattern",
]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "src" / "host_kernels.cpp"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> str:
    """Model and feature flags of this host's CPU (what -march=native
    compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep)


def _lib_path() -> Path:
    key = hashlib.sha256()
    key.update(_SRC.read_bytes())
    key.update(" ".join(_FLAGS).encode())
    key.update(platform.machine().encode())
    key.update(_host_cpu().encode())
    return _HERE / f"libaoclsparse_host-{key.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    # compile to a private name and rename: concurrent first uses (test
    # workers) never load a half-written library
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
            check=True,
            capture_output=True,
            timeout=300,
        )
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("AOCLSPARSE_TPU_NO_NATIVE", "0") in ("1", "true"):
            return None
        lib_path = _lib_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        for suf, vt in (
            ("s", ctypes.POINTER(ctypes.c_float)),
            ("d", ctypes.POINTER(ctypes.c_double)),
            ("c", ctypes.c_void_p),
            ("z", ctypes.c_void_p),
        ):
            fn = getattr(lib, f"ilu0_{suf}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int64, i64p, i64p, vt, i64p, i64p]
        lib.level_schedule.restype = ctypes.c_int64
        lib.level_schedule.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
        lib.rcm.restype = ctypes.c_int64
        lib.rcm.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
        lib.spgemm_nnz.restype = ctypes.c_int64
        lib.spgemm_nnz.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p, i64p, i64p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.spgemm_expand.restype = ctypes.c_int64
        lib.spgemm_expand.argtypes = (
            [ctypes.c_int64] + [i64p] * 4 + [i32p] * 3 + [i64p, i32p, ctypes.c_uint8, i64p]
        )
        lib.spgemm_pattern_count.restype = ctypes.c_int64
        lib.spgemm_pattern_count.argtypes = [ctypes.c_int64] + [i64p] * 6
        lib.spgemm_pattern_fill.restype = None
        lib.spgemm_pattern_fill.argtypes = [ctypes.c_int64] + [i64p] * 6 + [i32p]
        for suf, vt in (
            ("s", ctypes.POINTER(ctypes.c_float)),
            ("d", ctypes.POINTER(ctypes.c_double)),
            ("c", ctypes.c_void_p),
            ("z", ctypes.c_void_p),
        ):
            fn = getattr(lib, f"spgemm_numeric_{suf}")
            fn.restype = None
            fn.argtypes = [ctypes.c_int64, i32p, i32p, i32p, vt, vt, vt, ctypes.c_int64]
        for suf, vt in (
            ("s", ctypes.POINTER(ctypes.c_float)),
            ("d", ctypes.POINTER(ctypes.c_double)),
            ("c", ctypes.c_void_p),
            ("z", ctypes.c_void_p),
        ):
            fn = getattr(lib, f"trsv_seq_{suf}")
            fn.restype = None
            fn.argtypes = [ctypes.c_int64, i64p, i64p, vt, vt, vt, ctypes.c_int]
            fn = getattr(lib, f"trsm_seq_{suf}")
            fn.restype = None
            fn.argtypes = [
                ctypes.c_int64, ctypes.c_int64, i64p, i64p, vt, vt, vt, ctypes.c_int,
            ]
        lib.trsv_win_analyze.restype = None
        lib.trsv_win_analyze.argtypes = [
            ctypes.c_int64, i64p, i64p, i32p, ctypes.c_int64, ctypes.c_int,
            i64p, i64p, i64p,
        ]
        for suf, vt in (
            ("s", ctypes.POINTER(ctypes.c_float)),
            ("d", ctypes.POINTER(ctypes.c_double)),
        ):
            fn = getattr(lib, f"trsv_win_fill_{suf}")
            fn.restype = None
            fn.argtypes = [
                ctypes.c_int64, i64p, i64p, i32p, vt, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int64, i64p, i64p,
                vt, vt, i64p, i64p, i64p, i64p,
            ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.blkcsr_count.restype = ctypes.c_int64
        lib.blkcsr_count.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
        lib.blkcsr_build.restype = ctypes.c_int64
        lib.blkcsr_build.argtypes = (
            [ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p, i64p, u8p, i64p]
        )
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int64)


_SUFFIX = {
    np.dtype(np.float32): "s",
    np.dtype(np.float64): "d",
    np.dtype(np.complex64): "c",
    np.dtype(np.complex128): "z",
}


def ilu0_factor(m: int, ptr, ind, val) -> Tuple[np.ndarray, np.ndarray]:
    """IKJ ILU(0); returns (lu, diag_ptr). Raises ValueError with the
    offending row on missing diagonal / zero pivot (caller maps to Status)."""
    lib = _load()
    val = np.asarray(val)
    if lib is None or val.dtype not in _SUFFIX:
        return _ilu0_numpy(m, ptr, ind, val)
    ptr64 = _i64(ptr)
    ind64 = _i64(ind)
    lu = np.ascontiguousarray(val).copy()
    diag = np.empty(m, dtype=np.int64)
    err = np.zeros(1, dtype=np.int64)
    fn = getattr(lib, f"ilu0_{_SUFFIX[val.dtype]}")
    i64p = ctypes.POINTER(ctypes.c_int64)
    if val.dtype == np.float32:
        vp = lu.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    elif val.dtype == np.float64:
        vp = lu.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    else:
        vp = ctypes.c_void_p(lu.ctypes.data)
    rc = fn(
        ctypes.c_int64(m),
        ptr64.ctypes.data_as(i64p),
        ind64.ctypes.data_as(i64p),
        vp,
        diag.ctypes.data_as(i64p),
        err.ctypes.data_as(i64p),
    )
    if rc == 1:
        raise ValueError(f"missing_diag:{int(err[0])}")
    if rc == 2:
        raise ValueError(f"zero_pivot:{int(err[0])}")
    return lu, diag


def _ilu0_numpy(m, ptr, ind, val):
    """Fallback: same IKJ sweep in numpy (slow path)."""
    ptr = _i64(ptr)
    ind = _i64(ind)
    lu = np.array(val, copy=True)
    diag = np.full(m, -1, dtype=np.int64)
    for i in range(m):
        lo, hi = ptr[i], ptr[i + 1]
        seg = ind[lo:hi]
        p = np.searchsorted(seg, i)
        if p < hi - lo and seg[p] == i:
            diag[i] = lo + p
        else:
            raise ValueError(f"missing_diag:{i}")
    pos = np.full(m, -1, dtype=np.int64)
    for i in range(m):
        lo, hi = int(ptr[i]), int(ptr[i + 1])
        pos[ind[lo:hi]] = np.arange(lo, hi)
        for k in range(lo, hi):
            j = int(ind[k])
            if j >= i:
                break
            piv = lu[diag[j]]
            if piv == 0:
                raise ValueError(f"zero_pivot:{j}")
            lik = lu[k] / piv
            lu[k] = lik
            t0, t1 = int(diag[j]) + 1, int(ptr[j + 1])
            if t0 < t1:
                tgt = pos[ind[t0:t1]]
                ok = tgt >= 0
                lu[tgt[ok]] -= lik * lu[t0:t1][ok]
        pos[ind[lo:hi]] = -1
    return lu, diag


def level_schedule(m: int, ptr, ind) -> Tuple[np.ndarray, int]:
    """Wavefront levels of the strictly-lower dependency DAG."""
    lib = _load()
    ptr64 = _i64(ptr)
    ind64 = _i64(ind)
    levels = np.zeros(m, dtype=np.int64)
    if lib is not None:
        i64p = ctypes.POINTER(ctypes.c_int64)
        nlev = lib.level_schedule(
            ctypes.c_int64(m),
            ptr64.ctypes.data_as(i64p),
            ind64.ctypes.data_as(i64p),
            levels.ctypes.data_as(i64p),
        )
        return levels, int(nlev)
    nlev = 0
    for i in range(m):
        lv = 0
        for k in range(int(ptr64[i]), int(ptr64[i + 1])):
            j = int(ind64[k])
            if j >= i:
                break
            lv = max(lv, int(levels[j]) + 1)
        levels[i] = lv
        nlev = max(nlev, lv + 1)
    return levels, nlev


def rcm_permutation(m: int, ptr, ind) -> Tuple[np.ndarray, int]:
    """Reverse Cuthill-McKee ordering on the symmetrized pattern.

    Returns (perm, half_bandwidth_after): perm[k] = original row placed at
    position k; applying it symmetrically (B = A[perm][:, perm]) gives the
    reported half bandwidth. The planner uses this to route general-sparsity
    matrices to the banded-window form (new analysis — the reference's
    gather kernels are structure-agnostic on x86 and never reorder)."""
    lib = _load()
    ptr64 = _i64(ptr)
    ind64 = _i64(ind)
    perm = np.empty(m, dtype=np.int64)
    if lib is not None:
        i64p = ctypes.POINTER(ctypes.c_int64)
        bw = lib.rcm(
            ctypes.c_int64(m),
            ptr64.ctypes.data_as(i64p),
            ind64.ctypes.data_as(i64p),
            perm.ctypes.data_as(i64p),
        )
        return perm, int(bw)
    return _rcm_numpy(m, ptr64, ind64)


def _rcm_numpy(m, ptr, ind):
    """Vectorized-per-level numpy fallback (per-node Python loops are
    throttled on this host; BFS levels batch with bincount/argsort)."""
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    keep = (ind < m) & (ind != rows)
    src = np.concatenate([rows[keep], ind[keep]])
    dst = np.concatenate([ind[keep], rows[keep]])
    order2 = np.lexsort((dst, src))
    src, dst = src[order2], dst[order2]
    # dedup edges
    if src.size:
        uniq = np.concatenate([[True], (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])])
        src, dst = src[uniq], dst[uniq]
    aptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(aptr, src + 1, 1)
    aptr = np.cumsum(aptr)
    deg = np.diff(aptr)
    visited = np.zeros(m, dtype=bool)
    order = []
    remaining = np.argsort(deg, kind="stable")
    for seed in remaining:
        if visited[seed]:
            continue
        frontier = np.array([seed], dtype=np.int64)
        visited[seed] = True
        while frontier.size:
            order.append(frontier)
            # gather all neighbors of the frontier, dedup, drop visited
            starts, stops = aptr[frontier], aptr[frontier + 1]
            if stops.sum() - starts.sum() == 0:
                nxt = np.zeros(0, dtype=np.int64)
            else:
                chunks = [dst[a:b] for a, b in zip(starts, stops)]
                nxt = np.unique(np.concatenate(chunks)) if chunks else np.zeros(0, np.int64)
                nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            # degree-ascending within the level (CM tie-break)
            frontier = nxt[np.argsort(deg[nxt], kind="stable")] if nxt.size else nxt
    perm = np.concatenate(order)[::-1].copy() if order else np.zeros(0, np.int64)
    ip = np.empty(m, dtype=np.int64)
    ip[perm] = np.arange(m)
    bw = int(np.abs(ip[rows[keep]] - ip[ind[keep]]).max()) if keep.any() else 0
    return perm, bw


def spgemm_expand(mA: int, Aptr, Aind, Bptr, Bind, upper_only: bool = False):
    """Full symbolic stage: returns (pa, pb, pc, Cptr, Cind) with products
    ordered by (row, col), or None when the native library is unavailable
    (caller falls back to the numpy sort path)."""
    lib = _load()
    if lib is None:
        return None
    Aptr64, Aind64 = _i64(Aptr), _i64(Aind)
    Bptr64, Bind64 = _i64(Bptr), _i64(Bind)
    lensB = np.diff(Bptr64)
    P = int(lensB[Aind64].sum()) if Aind64.size else 0  # upper bound on products
    if (
        P >= np.iinfo(np.int32).max
        or Aind64.size >= np.iinfo(np.int32).max  # pa stores A positions
        or Bind64.size >= np.iinfo(np.int32).max  # pb stores B positions
        or (Bind64.size and int(Bind64.max()) >= np.iinfo(np.int32).max)  # Cind cols
    ):
        return None  # int32 product triples: absurd sizes take the numpy path
    pa = np.empty(P, dtype=np.int32)
    pb = np.empty(P, dtype=np.int32)
    pc = np.empty(P, dtype=np.int32)
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    Cind = np.empty(max(P, 1), dtype=np.int32)
    kept = np.zeros(1, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nnzC = lib.spgemm_expand(
        ctypes.c_int64(mA),
        Aptr64.ctypes.data_as(i64p),
        Aind64.ctypes.data_as(i64p),
        Bptr64.ctypes.data_as(i64p),
        Bind64.ctypes.data_as(i64p),
        pa.ctypes.data_as(i32p),
        pb.ctypes.data_as(i32p),
        pc.ctypes.data_as(i32p),
        Cptr.ctypes.data_as(i64p),
        Cind.ctypes.data_as(i32p),
        ctypes.c_uint8(1 if upper_only else 0),
        kept.ctypes.data_as(i64p),
    )
    kp = int(kept[0])
    return pa[:kp], pb[:kp], pc[:kp], Cptr, Cind[:nnzC]


def spgemm_pattern(mA: int, Aptr, Aind, Bptr, Bind):
    """Pattern-only symbolic stage: (Cptr, Cind, P) without the O(P)
    product-expansion triples (the band numeric engine only needs C's
    pattern). None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    Aptr64, Aind64 = _i64(Aptr), _i64(Aind)
    Bptr64, Bind64 = _i64(Bptr), _i64(Bind)
    if Bind64.size and int(Bind64.max()) >= np.iinfo(np.int32).max:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    Pptr = np.zeros(mA + 1, dtype=np.int64)
    nnzC = lib.spgemm_pattern_count(
        ctypes.c_int64(mA),
        Aptr64.ctypes.data_as(i64p),
        Aind64.ctypes.data_as(i64p),
        Bptr64.ctypes.data_as(i64p),
        Bind64.ctypes.data_as(i64p),
        Cptr.ctypes.data_as(i64p),
        Pptr.ctypes.data_as(i64p),
    )
    Cind = np.empty(max(int(nnzC), 1), dtype=np.int32)
    lib.spgemm_pattern_fill(
        ctypes.c_int64(mA),
        Aptr64.ctypes.data_as(i64p),
        Aind64.ctypes.data_as(i64p),
        Bptr64.ctypes.data_as(i64p),
        Bind64.ctypes.data_as(i64p),
        Cptr.ctypes.data_as(i64p),
        Pptr.ctypes.data_as(i64p),
        Cind.ctypes.data_as(i32p),
    )
    return Cptr, Cind[: int(nnzC)], int(Pptr[mA])


def spgemm_nnz(mA: int, nB: int, Aptr, Aind, Bptr, Bind) -> Tuple[np.ndarray, int]:
    """Symbolic C row pointer (Gustavson marker scan)."""
    lib = _load()
    Aptr64, Aind64, Bptr64, Bind64 = _i64(Aptr), _i64(Aind), _i64(Bptr), _i64(Bind)
    Cptr = np.zeros(mA + 1, dtype=np.int64)
    if lib is not None:
        i64p = ctypes.POINTER(ctypes.c_int64)
        total = lib.spgemm_nnz(
            ctypes.c_int64(mA),
            ctypes.c_int64(nB),
            Aptr64.ctypes.data_as(i64p),
            Aind64.ctypes.data_as(i64p),
            Bptr64.ctypes.data_as(i64p),
            Bind64.ctypes.data_as(i64p),
            Cptr.ctypes.data_as(i64p),
        )
        return Cptr, int(total)
    marker = np.full(nB, -1, dtype=np.int64)
    total = 0
    for i in range(mA):
        cnt = 0
        for k in range(int(Aptr64[i]), int(Aptr64[i + 1])):
            kk = int(Aind64[k])
            cols = Bind64[int(Bptr64[kk]) : int(Bptr64[kk + 1])]
            fresh = marker[cols] != i
            marker[cols[fresh]] = i
            cnt += int(fresh.sum())
        total += cnt
        Cptr[i + 1] = total
    return Cptr, total


def _blkcsr_numpy(m, n, ptr, ind, nrowsblk, build):
    """Fallback greedy block scan. Python loops over row *groups* only; the
    inner consume step is a searchsorted per subrow (columns are sorted)."""
    W = 8
    total = 0
    brow_ptr = np.zeros(m + 1, dtype=np.int64) if build else None
    bcols, masks, perm = [], [], []
    for r0 in range(0, m, nrowsblk):
        nr = min(nrowsblk, m - r0)
        cur = ptr[r0 : r0 + nr].astype(np.int64).copy()
        end = ptr[r0 + 1 : r0 + nr + 1].astype(np.int64)
        blk0 = total
        while True:
            heads = [ind[cur[s]] if cur[s] < end[s] else None for s in range(nr)]
            live = [h for h in heads if h is not None]
            if not live:
                break
            c0 = int(min(live))
            edge = c0 + W > n
            cstart = n - W if edge else c0
            if build:
                bcols.append(cstart)
                for s in range(nr):
                    stop = cur[s] + np.searchsorted(ind[cur[s] : end[s]], c0 + W)
                    cols = ind[cur[s] : stop]
                    masks.append(np.bitwise_or.reduce(
                        (1 << (cols - cstart)).astype(np.uint8), initial=np.uint8(0)
                    ))
                    perm.append(np.arange(cur[s], stop, dtype=np.int64))
                    cur[s] = stop
                masks.extend([np.uint8(0)] * (nrowsblk - nr))
            else:
                for s in range(nr):
                    cur[s] += np.searchsorted(ind[cur[s] : end[s]], c0 + W)
            total += 1
        if build:
            brow_ptr[r0] = blk0
            brow_ptr[r0 + 1 : r0 + nr + 1] = total
    if not build:
        return total
    bcol = np.asarray(bcols, dtype=np.int64)
    msk = np.asarray(masks, dtype=np.uint8)
    prm = np.concatenate(perm) if perm else np.zeros(0, np.int64)
    return brow_ptr, bcol, msk, prm


def blkcsr_count(m: int, n: int, ptr, ind, nrowsblk: int) -> int:
    """Number of nrowsblk x 8 blocks the greedy scan produces
    (reference opt_blksize counting pass, conversion/aoclsparse_convert.cpp:69-110)."""
    lib = _load()
    ptr64, ind64 = _i64(ptr), _i64(ind)
    if lib is not None:
        i64p = ctypes.POINTER(ctypes.c_int64)
        return int(
            lib.blkcsr_count(
                ctypes.c_int64(m),
                ctypes.c_int64(n),
                ptr64.ctypes.data_as(i64p),
                ind64.ctypes.data_as(i64p),
                ctypes.c_int64(nrowsblk),
            )
        )
    return _blkcsr_numpy(m, n, ptr64, ind64, nrowsblk, build=False)


def blkcsr_build(m: int, n: int, ptr, ind, nrowsblk: int):
    """Full blkcsr structure (reference csr2blkcsr,
    conversion/aoclsparse_convert.cpp:145-290). Returns
    (blk_row_ptr, blk_col_ind, masks, perm) with perm mapping each output
    value slot to its CSR source index (values placed dtype-generic by the
    caller)."""
    lib = _load()
    ptr64, ind64 = _i64(ptr), _i64(ind)
    if lib is None:
        return _blkcsr_numpy(m, n, ptr64, ind64, nrowsblk, build=True)
    nblk = blkcsr_count(m, n, ptr64, ind64, nrowsblk)
    nnz = int(ind64.shape[0])
    brow_ptr = np.zeros(m + 1, dtype=np.int64)
    bcol = np.empty(max(nblk, 1), dtype=np.int64)
    masks = np.zeros(max(nblk * nrowsblk, 1), dtype=np.uint8)
    perm = np.empty(max(nnz, 1), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    nval = lib.blkcsr_build(
        ctypes.c_int64(m),
        ctypes.c_int64(n),
        ptr64.ctypes.data_as(i64p),
        ind64.ctypes.data_as(i64p),
        ctypes.c_int64(nrowsblk),
        brow_ptr.ctypes.data_as(i64p),
        bcol.ctypes.data_as(i64p),
        masks.ctypes.data_as(u8p),
        perm.ctypes.data_as(i64p),
    )
    return brow_ptr, bcol[:nblk], masks[: nblk * nrowsblk], perm[: int(nval)]


def trsv_seq(m: int, ptr, ind, val, b, lower: bool) -> np.ndarray:
    """Sequential substitution over a host CSR triangle (the host TRSV
    engine, trsv KID 2; reference role: the scalar substitution of
    level2/aoclsparse_trsv_kr.hpp). The triangle must carry its diagonal
    materialized (the planner's effective triangle always does — unit diag
    becomes constant 1 entries, plan.py _inject_diag); a zero/missing pivot
    divides through to IEEE inf/nan like the device forms. Falls back to a
    row-loop numpy path when the native library is unavailable (acceptable:
    this engine exists for latency-bound SMALL solves)."""
    ptr64 = _i64(ptr)
    ind64 = _i64(ind)
    v = np.ascontiguousarray(np.asarray(val))
    dt = np.result_type(v.dtype, np.asarray(b).dtype)
    v = v.astype(dt, copy=False)
    bh = np.ascontiguousarray(np.asarray(b), dtype=dt)
    lib = _load()
    suf = _SUFFIX.get(np.dtype(dt))
    if lib is None or suf is None:
        return _trsv_seq_numpy(m, ptr64, ind64, v, bh, lower)
    x = np.zeros(m, dtype=dt)
    if suf in ("s", "d"):
        ct = ctypes.c_float if suf == "s" else ctypes.c_double
        vp = lambda a: a.ctypes.data_as(ctypes.POINTER(ct))
    else:
        vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    i64p = ctypes.POINTER(ctypes.c_int64)
    getattr(lib, f"trsv_seq_{suf}")(
        ctypes.c_int64(m),
        ptr64.ctypes.data_as(i64p),
        ind64.ctypes.data_as(i64p),
        vp(v),
        vp(bh),
        vp(x),
        ctypes.c_int(1 if lower else 0),
    )
    return x


def trsm_seq(m: int, ptr, ind, val, B, lower: bool) -> np.ndarray:
    """Multi-RHS sequential substitution (the host TRSM engine, trsm KID 2).
    `B` is (m, k); columns solve independently, threaded across RHS in C++
    like the reference's OpenMP column split (level3/aoclsparse_trsm.hpp:149).
    Falls back to per-column numpy solves without the native library."""
    ptr64 = _i64(ptr)
    ind64 = _i64(ind)
    v = np.ascontiguousarray(np.asarray(val))
    Bh = np.asarray(B)
    k = Bh.shape[1]
    dt = np.result_type(v.dtype, Bh.dtype)
    v = v.astype(dt, copy=False)
    # (k, m) RHS-major: each solve sweeps a contiguous vector
    bt = np.ascontiguousarray(Bh.T, dtype=dt)
    lib = _load()
    suf = _SUFFIX.get(np.dtype(dt))
    if lib is None or suf is None:
        out = np.empty((k, m), dtype=dt)
        for r in range(k):
            out[r] = _trsv_seq_numpy(m, ptr64, ind64, v, bt[r], lower)
        return out.T
    x = np.zeros((k, m), dtype=dt)
    if suf in ("s", "d"):
        ct = ctypes.c_float if suf == "s" else ctypes.c_double
        vp = lambda a: a.ctypes.data_as(ctypes.POINTER(ct))
    else:
        vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    i64p = ctypes.POINTER(ctypes.c_int64)
    getattr(lib, f"trsm_seq_{suf}")(
        ctypes.c_int64(m),
        ctypes.c_int64(k),
        ptr64.ctypes.data_as(i64p),
        ind64.ctypes.data_as(i64p),
        vp(v),
        vp(bt),
        vp(x),
        ctypes.c_int(1 if lower else 0),
    )
    return x.T


def _trsv_seq_numpy(m, ptr, ind, val, b, lower):
    """Row-loop fallback (vectorized within each row)."""
    dt = np.result_type(val.dtype, b.dtype)
    x = np.zeros(m, dtype=dt)
    err = np.errstate(divide="ignore", invalid="ignore")
    rng = range(m) if lower else range(m - 1, -1, -1)
    with err:
        for i in rng:
            k0, k1 = int(ptr[i]), int(ptr[i + 1])
            cols = ind[k0:k1]
            vals = val[k0:k1]
            dmask = cols == i
            off = (cols < i) if lower else (cols > i)
            s = vals[off] @ x[cols[off]] if off.any() else dt.type(0)
            d = vals[dmask][0] if dmask.any() else dt.type(0)
            x[i] = (b[i] - s) / d
    return x


def spgemm_numeric_host(pa, pb, pc, aval, bval, nnzC: int):
    """Threaded host numeric pass over the expansion plan (the reference's
    numeric Gustavson, level3/aoclsparse_csr2m.cpp:405-545): threads own
    disjoint output ranges of the SORTED pc (binary search), so the
    accumulation is race-free. Returns the (nnzC,) value vector or None
    when the native library is unavailable (callers fall back to the
    device segment-sum)."""
    lib = _load()
    if lib is None:
        return None
    pa32 = np.ascontiguousarray(np.asarray(pa, dtype=np.int32))
    pb32 = np.ascontiguousarray(np.asarray(pb, dtype=np.int32))
    pc32 = np.ascontiguousarray(np.asarray(pc, dtype=np.int32))
    av = np.ascontiguousarray(np.asarray(aval))
    bv = np.ascontiguousarray(np.asarray(bval))
    dt = np.result_type(av.dtype, bv.dtype)
    av = av.astype(dt, copy=False)
    bv = bv.astype(dt, copy=False)
    suf = {"float32": "s", "float64": "d", "complex64": "c", "complex128": "z"}.get(dt.name)
    if suf is None:
        return None
    cv = np.zeros(max(int(nnzC), 1), dtype=dt)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if suf in ("s", "d"):
        ct = ctypes.c_float if suf == "s" else ctypes.c_double
        vp = lambda a: a.ctypes.data_as(ctypes.POINTER(ct))
    else:
        vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    getattr(lib, f"spgemm_numeric_{suf}")(
        ctypes.c_int64(pa32.size),
        pa32.ctypes.data_as(i32p),
        pb32.ctypes.data_as(i32p),
        pc32.ctypes.data_as(i32p),
        vp(av),
        vp(bv),
        vp(cv),
        ctypes.c_int64(int(nnzC)),
    )
    return cv[: int(nnzC)]


def trsv_win_build(m, lo, hi, ind, vals, nb, reversed_):
    """Blocked-window TRSV form operands in C++ (the build_trsv_form hot
    path): triangle given as per-row [lo, hi) slices of the CLEAN structure,
    entries partitioned into dense diagonal blocks D (nblk, nb, nb) and the
    left window Lw (nblk, nb, WL), plus the refresh scatter maps (dest +
    clean-position src). reversed_=True builds on reversed indices (upper ->
    lower). Returns dict or None when the native library is unavailable /
    dtype unsupported / the window would blow the memory cap (caller falls
    back to the numpy path)."""
    lib = _load()
    vals = np.ascontiguousarray(np.asarray(vals))
    if lib is None or vals.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    m = int(m)
    lo64 = _i64(lo)
    hi64 = _i64(hi)
    ind32 = np.ascontiguousarray(np.asarray(ind), dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    wl = np.zeros(1, np.int64)
    prefL = np.zeros(m + 1, np.int64)
    prefD = np.zeros(m + 1, np.int64)
    lib.trsv_win_analyze(
        ctypes.c_int64(m),
        lo64.ctypes.data_as(i64p),
        hi64.ctypes.data_as(i64p),
        ind32.ctypes.data_as(i32p),
        ctypes.c_int64(int(nb)),
        ctypes.c_int(1 if reversed_ else 0),
        prefL.ctypes.data_as(i64p),
        prefD.ctypes.data_as(i64p),
        wl.ctypes.data_as(i64p),
    )
    WL = max(8, -(-int(wl[0]) // 8) * 8)
    nblk = -(-m // nb) if m else 1
    nL, nD = int(prefL[-1]), int(prefD[-1])
    nnz_tri = nL + nD
    # the numpy path's win-mode cap (planner/triangular.py use_win)
    if not (nblk * nb * WL <= max(8 * max(nnz_tri, 1), 64 * nb * nb) and WL <= 8192):
        return None
    D = np.zeros(nblk * nb * nb, dtype=vals.dtype)
    Lw = np.zeros(nblk * nb * WL, dtype=vals.dtype)
    D_dest = np.empty(nD, np.int64)
    D_srcpos = np.empty(nD, np.int64)
    L_dest = np.empty(nL, np.int64)
    L_srcpos = np.empty(nL, np.int64)
    ct = ctypes.c_float if vals.dtype == np.float32 else ctypes.c_double
    vp = lambda a: a.ctypes.data_as(ctypes.POINTER(ct))  # noqa: E731
    suf = "s" if vals.dtype == np.float32 else "d"
    getattr(lib, f"trsv_win_fill_{suf}")(
        ctypes.c_int64(m),
        lo64.ctypes.data_as(i64p),
        hi64.ctypes.data_as(i64p),
        ind32.ctypes.data_as(i32p),
        vp(vals),
        ctypes.c_int64(int(nb)),
        ctypes.c_int(1 if reversed_ else 0),
        ctypes.c_int64(WL),
        prefL.ctypes.data_as(i64p),
        prefD.ctypes.data_as(i64p),
        vp(D),
        vp(Lw),
        D_dest.ctypes.data_as(i64p),
        D_srcpos.ctypes.data_as(i64p),
        L_dest.ctypes.data_as(i64p),
        L_srcpos.ctypes.data_as(i64p),
    )
    return {
        "WL": WL,
        "nblk": nblk,
        "D": D,
        "Lw": Lw,
        "D_dest": D_dest,
        "D_srcpos": D_srcpos,
        "L_dest": L_dest,
        "L_srcpos": L_srcpos,
    }
