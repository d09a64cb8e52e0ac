#!/usr/bin/env python
"""Two-run benchmark comparison (the tools/twosampletest.py analog).

Reads two bench JSONL files (benchmarks/*.jsonl or bench.py outputs, one
JSON object per line), pairs records by their identifying keys (metric /
profile / stage + operand fields), and reports per-pair speedup with a
Welch two-sample t-test verdict where per-sample timings are available —
the reference compares runs the same way (tools/twosampletest.py;
tests/common/aoclsparse_stats.cpp:39).

Usage:
    python benchmarks/compare.py runA.jsonl runB.jsonl [--alpha 0.05]

Runs entirely host-side; forces the CPU backend in-process.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _key(rec: dict):
    """Pair records by what they measure (metric/profile/stage + size), NOT
    by how they measured it (form/W are outputs of the planner under test —
    two runs may legitimately differ there and that difference is what the
    comparison should surface)."""
    parts = []
    for k in ("metric", "probe", "profile", "stage", "variant", "unit", "m"):
        if k in rec:
            parts.append(f"{k}={rec[k]}")
    return "|".join(parts)


def _value(rec: dict):
    for k in ("value", "t_us", "t_s", "gnnz_s", "gbs_eff", "stream_gbps"):
        if k in rec and isinstance(rec[k], (int, float)):
            return k, float(rec[k])
    return None, None


def _load(path: str):
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            k = _key(rec)
            if k:
                out.setdefault(k, []).append(rec)
    return out


def _t_crit(dof: float, alpha: float) -> float:
    """Two-sided critical value via the normal approximation with a
    small-sample correction (Boost's students_t is the reference's tool;
    this keeps the repo scipy-free)."""
    # Abramowitz-Stegun 26.2.23 inverse-normal approximation
    p = 1 - alpha / 2
    t = math.sqrt(-2 * math.log(1 - p))
    z = t - (2.30753 + 0.27061 * t) / (1 + 0.99229 * t + 0.04481 * t * t)
    if dof <= 0:
        return z
    # Cornish-Fisher-type expansion of the t quantile around z
    g1 = (z**3 + z) / 4
    g2 = (5 * z**5 + 16 * z**3 + 3 * z) / 96
    return z + g1 / dof + g2 / dof**2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("run_a")
    ap.add_argument("run_b")
    ap.add_argument("--alpha", type=float, default=0.05, help="significance level")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from aoclsparse_tpu.utils.profiling import two_sample_t

    A = _load(args.run_a)
    B = _load(args.run_b)
    common = sorted(set(A) & set(B))
    if not common:
        print("no common records between the two runs", file=sys.stderr)
        return 1
    print(f"{'key':60s} {'A':>12s} {'B':>12s} {'B/A':>8s}  verdict")
    for k in common:
        ka, va = _value(A[k][-1])
        kb, vb = _value(B[k][-1])
        if va is None or vb is None or ka != kb:
            continue
        ratio = vb / va if va else float("inf")
        # multiple samples of the same key -> t-test on the sample sets
        sa = [_value(r)[1] for r in A[k] if _value(r)[1] is not None]
        sb = [_value(r)[1] for r in B[k] if _value(r)[1] is not None]
        verdict = ""
        if len(sa) >= 3 and len(sb) >= 3:
            st = two_sample_t(sa, sb)
            crit = _t_crit(st["dof"], args.alpha)
            sig = abs(st["t"]) > crit
            verdict = (
                f"t={st['t']:+.2f} dof={st['dof']:.1f} "
                + ("SIGNIFICANT" if sig else "not significant")
            )
        else:
            verdict = f"(best-of: {len(sa)} vs {len(sb)} samples)"
        print(f"{k[:60]:60s} {va:12.4g} {vb:12.4g} {ratio:8.3f}  {verdict}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
