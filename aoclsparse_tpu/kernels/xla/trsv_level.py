"""Level-scheduled (wavefront) triangular solve.

SURVEY.md §7's second sequential-algorithm design: "level-scheduling
analysis in the planner (host-side, C++-backed where hot) → wavefront
execution as a lax.scan over levels with batched per-level sparse ops".
The planner's default TRSV is the blocked scan (planner/triangular.py —
dense block solves, best for banded structure where the dependency chain is
long anyway); THIS form wins when the dependency DAG is SHALLOW
(circuit/power-law triangles with few levels): all rows of a level solve
simultaneously as one masked gather-reduce, so the scan has `nlev` steps
instead of `m/nb`.

Reference role: the sequential loop-carried sweep of
level2/aoclsparse_trsv_kt.cpp:65-…, re-parallelized by level. Exposed
as TRSV KID 1 (the blocked scan stays KID 0 and the Oracle default).

Level analysis runs in native C++ (native/host_kernels.cpp
level_schedule); the host packing here is vectorized numpy per the repo
rule. Value paths stay refreshable: the form stores src positions into the
effective value array and `refresh()` regathers on device.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["LevelForm", "build_level_form", "solve_levels", "level_step"]


@dataclasses.dataclass
class LevelForm:
    """Wavefront execution form for one oriented triangle."""

    m: int
    nlev: int
    R_max: int  # max rows per level
    W_max: int  # max strict-lower entries per row
    reversed_: bool
    unit_diag: bool
    rows: Optional[object]  # (L, R) int32 global layout (on demand only)
    row_valid: Optional[object]
    cols: Optional[object]  # (L, R, W) int32
    col_valid: Optional[object]
    Lval: Optional[jax.Array]  # (L, R, W) global values (on demand only)
    Dinv: Optional[jax.Array]  # (L, R)
    _L_srcpos: Optional[np.ndarray]  # global srcpos (on demand only)
    _D_srcpos: Optional[np.ndarray]
    runs: Tuple = ()  # ((lo, hi, R_run, W_run), ...) contiguous level runs
    _eff = None  # EffectiveCSR kept by the planner for refresh

    def _vals_for(self, v, Ls_np, Ds_np):
        Ls = jnp.asarray(Ls_np)
        lv = jnp.where(Ls >= 0, v[jnp.clip(Ls, 0)], jnp.zeros((), v.dtype))
        if self.unit_diag:
            di = jnp.ones(Ds_np.shape, v.dtype)
        else:
            Ds = jnp.asarray(Ds_np)
            di = 1.0 / jnp.where(Ds >= 0, v[jnp.clip(Ds, 0)], jnp.ones((), v.dtype))
        return lv, di

    def refresh(self, eff_val: jax.Array) -> None:
        """Regather values after update_values (value-path rule). Only
        run-sized value arrays go to the device — the globally padded
        (nlev, R_max, W_max) layout on skewed/deep DAGs is GBs of padding
        (circuit-profile device OOM; scircuit triangle: a 238 GB host
        allocation request). The global layout materializes on demand
        (global_arrays()/full_vals(), used by the dist wavefront twin)."""
        v = jnp.asarray(eff_val)
        self._val_src = v
        self._run_vals = tuple(
            self._vals_for(v, Ls, Ds)
            for Ls, Ds in zip(self._run_srcL, self._run_srcD)
        )
        self.Lval = self.Dinv = None

    def global_arrays(self):
        """Materialize the globally padded structure + srcpos layout from
        the run slices (dist consumers shard whole levels). Allocates
        O(nlev * R_max * W_max) — callers own that risk."""
        if self.rows is None:
            rows = np.full((self.nlev, self.R_max), self.m, dtype=np.int32)
            rv = np.zeros((self.nlev, self.R_max), dtype=bool)
            cols = np.zeros((self.nlev, self.R_max, self.W_max), dtype=np.int32)
            cv = np.zeros((self.nlev, self.R_max, self.W_max), dtype=bool)
            Ls = np.full((self.nlev, self.R_max, self.W_max), -1, dtype=np.int64)
            Ds = np.full((self.nlev, self.R_max), -1, dtype=np.int64)
            for (lo, hi, R, W), (r_, v_, c_, cv_), Ls_r, Ds_r in zip(
                self.runs, self._run_struct, self._run_srcL, self._run_srcD
            ):
                rows[lo:hi, :R] = np.asarray(r_)
                rv[lo:hi, :R] = np.asarray(v_)
                cols[lo:hi, :R, :W] = np.asarray(c_)
                cv[lo:hi, :R, :W] = np.asarray(cv_)
                Ls[lo:hi, :R, :W] = Ls_r
                Ds[lo:hi, :R] = Ds_r
            self.rows, self.row_valid, self.cols, self.col_valid = rows, rv, cols, cv
            self._L_srcpos, self._D_srcpos = Ls, Ds
        return self.rows, self.row_valid, self.cols, self.col_valid

    def full_vals(self):
        """(Lval, Dinv) in the globally padded layout — materialized on
        demand for consumers that shard whole levels (dist_trsv_levels)."""
        self.global_arrays()
        return self._vals_for(self._val_src, self._L_srcpos, self._D_srcpos)

    def solve(self, b) -> jax.Array:
        """x = T^{-1} b, b (m,) or (m, k)."""
        b = jnp.asarray(b)
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        if self.reversed_:
            b2 = b2[::-1]
        x = _solve_runs_jit(self.runs, self._run_struct, self._run_vals, b2, self.m)
        if self.reversed_:
            x = x[::-1]
        return x[:, 0] if squeeze else x


def level_step(x, bp, r, rv, c, cv, lv, di):
    """Solve ONE wavefront level against the partial solution x: returns
    the level's new entries xi (R, k), zeroed on padding rows. Shared by
    the local scan below and the distributed dist_trsv_levels (which adds
    an all_gather of xi between levels)."""
    g = x[c]  # (R, W, k) gather of already-solved levels
    contrib = jnp.where(cv[..., None], lv[..., None].astype(x.dtype) * g, 0)
    s = jnp.sum(contrib, axis=1)  # (R, k)
    xi = (bp[r] - s) * di[..., None].astype(x.dtype)
    return jnp.where(rv[..., None], xi, 0)


@partial(jax.jit, static_argnames=("m",))
def _solve_levels_jit(rows, row_valid, cols, col_valid, Lval, Dinv, b2, m: int):
    """lax.scan over levels: every row of a level solves simultaneously.
    x carries one scratch row at index m for level padding."""
    k = b2.shape[1]
    x0 = jnp.zeros((m + 1, k), b2.dtype)
    bp = jnp.concatenate([b2, jnp.zeros((1, k), b2.dtype)], axis=0)

    def step(x, lvl):
        r, rv, c, cv, lv, di = lvl
        xi = level_step(x, bp, r, rv, c, cv, lv, di)
        return x.at[r].set(xi), None

    x, _ = jax.lax.scan(
        step, x0, (rows, row_valid, cols, col_valid, Lval, Dinv)
    )
    return x[:m]


@partial(jax.jit, static_argnames=("runs", "m"))
def _solve_runs_jit(runs, run_struct, run_vals, b2, m: int):
    """Shape-bucketed wavefront: one scan per contiguous run of levels with
    similar width, each with TIGHT (R_run, W_run) shapes. The single-scan
    formulation pads every level to the global (R_max, W_max) — on the
    skewed level-size distributions the engine exists for (shallow circuit
    DAGs: one huge first level, then a geometric tail) that padding costs
    ~10x the useful gather work (VERDICT r3 item 6)."""
    k = b2.shape[1]
    x = jnp.zeros((m + 1, k), b2.dtype)
    bp = jnp.concatenate([b2, jnp.zeros((1, k), b2.dtype)], axis=0)
    for (lo, hi, R, W), (rows, rv, cols, cv), (lv, di) in zip(
        runs, run_struct, run_vals
    ):
        if hi - lo == 1:
            xi = level_step(x, bp, rows[0], rv[0], cols[0], cv[0], lv[0], di[0])
            x = x.at[rows[0]].set(xi)
        else:

            def step(xc, lvl):
                r, rvl, c, cvl, lvl_v, dil = lvl
                xi = level_step(xc, bp, r, rvl, c, cvl, lvl_v, dil)
                return xc.at[r].set(xi), None

            x, _ = jax.lax.scan(step, x, (rows, rv, cols, cv, lv, di))
    return x[:m]


def _level_runs(counts, wlev, slack: float = 1.6, max_runs: int = 16):
    """Greedy contiguous grouping of levels into shape buckets: extend the
    current run while its padded cost stays within `slack` of the exact
    per-level cost sum; if the greedy pass still exceeds max_runs (deep
    DAGs), adjacent runs merge by smallest combined padded cost until the
    bound holds (each run is one unrolled scan in the solve program — an
    unbounded count would blow the HLO). Returns ((lo, hi, R, W), ...)."""
    nlev = counts.shape[0]
    runs = []
    while True:
        runs.clear()
        lo = 0
        Rr = Wr = exact = 0
        for l in range(nlev):
            R_l, W_l = int(counts[l]), max(int(wlev[l]), 1)
            c_l = R_l * (W_l + 1)
            nR, nW = max(Rr, R_l), max(Wr, W_l)
            padded = (l - lo + 1) * nR * (nW + 1)
            if l > lo and padded > slack * (exact + c_l):
                runs.append((lo, l, Rr, Wr))
                lo, Rr, Wr, exact = l, R_l, W_l, c_l
            else:
                Rr, Wr, exact = nR, nW, exact + c_l
        runs.append((lo, nlev, Rr, Wr))
        if len(runs) <= max_runs or slack > 64:
            break
        slack *= 1.8

    def _cost(r):
        lo_, hi_, R_, W_ = r
        return (hi_ - lo_) * R_ * (W_ + 1)

    while len(runs) > max_runs:
        best_i, best_c = 0, None
        for i in range(len(runs) - 1):
            a, b = runs[i], runs[i + 1]
            merged = (a[0], b[1], max(a[2], b[2]), max(a[3], b[3]))
            dc = _cost(merged) - _cost(a) - _cost(b)
            if best_c is None or dc < best_c:
                best_i, best_c = i, dc
        a, b = runs[best_i], runs[best_i + 1]
        runs[best_i : best_i + 2] = [(a[0], b[1], max(a[2], b[2]), max(a[3], b[3]))]
    return tuple(runs)


def solve_levels(form: LevelForm, b):
    return form.solve(b)


def level_form_stats(eff_ptr, eff_ind, m: int):
    """(nlev, padded_run_entries) of the wavefront form WITHOUT building
    it — the dispatcher's routing check (build uploads run arrays to the
    device, so checking after building defeats the memory routing)."""
    from ... import native

    ptr = np.asarray(eff_ptr, dtype=np.int64)
    ind = np.asarray(eff_ind, dtype=np.int64)
    levels, nlev = native.level_schedule(m, ptr, ind)
    nlev = max(int(nlev), 1)
    counts = np.bincount(levels, minlength=nlev).astype(np.int64) if m else np.zeros(1, np.int64)
    lens = np.diff(ptr)
    rows_of = np.repeat(np.arange(m, dtype=np.int64), lens)
    strict = ind < rows_of
    wlev = np.zeros(nlev, dtype=np.int64)
    if strict.any():
        cl = np.bincount(rows_of[strict], minlength=m)
        np.maximum.at(wlev, levels, cl)
    runs = _level_runs(counts, wlev) if m else ()
    padded = sum((hi - lo) * R * (W + 1) for lo, hi, R, W in runs)
    return nlev, int(padded)


def build_level_form(
    eff_ptr, eff_ind, eff_src, m: int, reversed_: bool, unit_diag: bool, eff_val
) -> LevelForm:
    """Build the wavefront form from an ORIENTED (lower) triangle structure:
    ptr/ind sorted CSR of the lower-oriented triangle, eff_src mapping each
    entry to its position in the effective value array. The native C++
    level analysis walks the strictly-lower dependency DAG."""
    from ... import native

    ptr = np.asarray(eff_ptr, dtype=np.int64)
    ind = np.asarray(eff_ind, dtype=np.int64)
    src = np.asarray(eff_src, dtype=np.int64)
    levels, nlev = native.level_schedule(m, ptr, ind)
    nlev = max(int(nlev), 1)

    counts = np.bincount(levels, minlength=nlev).astype(np.int64) if m else np.zeros(1, np.int64)
    R_max = max(int(counts.max()) if counts.size else 1, 1)
    # slot of each row inside its level
    lvl_first = np.zeros(nlev, dtype=np.int64)
    np.cumsum(counts[:-1], out=lvl_first[1:])
    order = np.lexsort((np.arange(m), levels))  # rows grouped by level
    slot_of = np.empty(m, dtype=np.int64)
    slot_of[order] = np.arange(m, dtype=np.int64) - lvl_first[levels[order]]

    lens = np.diff(ptr)
    rows_of = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = ind
    strict = cols < rows_of
    pos_in_row = np.arange(cols.size, dtype=np.int64) - np.repeat(ptr[:-1], lens)
    W_max = 1
    cl_full = None
    if strict.any():
        cl_full = np.bincount(rows_of[strict], minlength=m)
        W_max = max(1, int(cl_full.max()))
    dmask = cols == rows_of
    if not unit_diag:
        has_d = np.zeros(m, dtype=bool)
        has_d[rows_of[dmask]] = True
        if not has_d.all():
            from ...core.types import AoclSparseError, Status

            missing = int(np.nonzero(~has_d)[0][0])
            raise AoclSparseError(
                Status.invalid_value, f"missing diagonal entry in row {missing}"
            )

    # per-level strict-entry width for the shape-bucketed runs
    wlev = np.zeros(nlev, dtype=np.int64)
    if cl_full is not None:
        np.maximum.at(wlev, levels, cl_full)
    runs = _level_runs(counts, wlev) if m else ()

    # PER-RUN construction only: the globally padded (nlev, R_max, W_max)
    # arrays are multi-GB of padding on skewed/deep DAGs (scircuit lower
    # triangle: 21.6k levels x 11.4k x 121 = a 238 GB allocation request).
    # Runs allocate ~sum(exact level sizes * slack); the global layout
    # materializes only on demand (global_arrays(), dist twin).
    e_lv = levels[rows_of] if m else rows_of
    run_struct = []
    run_srcL = []
    run_srcD = []
    for (lo, hi, R, W) in runs:
        nl = hi - lo
        sel = (levels >= lo) & (levels < hi)
        rids = np.nonzero(sel)[0]
        li = levels[rids] - lo
        si = slot_of[rids]
        rows_r = np.full((nl, R), m, dtype=np.int32)
        rv_r = np.zeros((nl, R), dtype=bool)
        rows_r[li, si] = rids.astype(np.int32)
        rv_r[li, si] = True
        cols_r = np.zeros((nl, R, W), dtype=np.int32)
        cv_r = np.zeros((nl, R, W), dtype=bool)
        Ls_r = np.full((nl, R, W), -1, dtype=np.int64)
        emask = strict & (e_lv >= lo) & (e_lv < hi)
        if emask.any():
            er = rows_of[emask]
            pe = pos_in_row[emask]
            cols_r[levels[er] - lo, slot_of[er], pe] = cols[emask].astype(np.int32)
            cv_r[levels[er] - lo, slot_of[er], pe] = True
            Ls_r[levels[er] - lo, slot_of[er], pe] = src[emask]
        Ds_r = np.full((nl, R), -1, dtype=np.int64)
        dm = dmask & (e_lv >= lo) & (e_lv < hi)
        if dm.any():
            dr = rows_of[dm]
            Ds_r[levels[dr] - lo, slot_of[dr]] = src[dm]
        run_struct.append(
            (jnp.asarray(rows_r), jnp.asarray(rv_r), jnp.asarray(cols_r), jnp.asarray(cv_r))
        )
        run_srcL.append(Ls_r)
        run_srcD.append(Ds_r)

    form = LevelForm(
        m=m,
        nlev=nlev,
        R_max=R_max,
        W_max=W_max,
        reversed_=reversed_,
        unit_diag=unit_diag,
        rows=None,
        row_valid=None,
        cols=None,
        col_valid=None,
        Lval=None,
        Dinv=None,
        _L_srcpos=None,
        _D_srcpos=None,
        runs=runs,
    )
    form._run_struct = tuple(run_struct)
    form._run_srcL = tuple(run_srcL)
    form._run_srcD = tuple(run_srcD)
    form.refresh(eff_val)
    return form
