"""Collective ledger: count the cross-device collectives a distributed
path actually issues, from its jaxpr (VERDICT r3 item 8b).

Walk the traced program and record every collective primitive (psum/all-reduce, ppermute/halo,
all_gather, all_to_all, reduce_scatter) with its per-shard payload bytes,
and separate the ones inside `while`/`scan` bodies — those are the
per-iteration wire cost of a solver loop. A distributed CG that claims
"1 fused psum per iteration" must show exactly one in_loop all-reduce here.

The reference has no analog (its MPI usage is external to the library);
this plays the role its message-count discussions in
tests/benchmarks/README.md would need.
"""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import numpy as np

__all__ = ["collective_ledger", "ledger_summary"]

# jaxpr primitive name -> wire-operation class
_COLLECTIVES = {
    "psum": "all_reduce",
    "psum_invariant": "all_reduce",  # psum as traced under shard_map
    "ppermute": "collective_permute",
    "all_gather": "all_gather",
    "all_to_all": "all_to_all",
    "reduce_scatter": "reduce_scatter",
    "psum_scatter": "reduce_scatter",
    "pmax": "all_reduce",
    "pmin": "all_reduce",
    "allreduce": "all_reduce",
}

# eqn params that hold nested jaxprs, and whether entering them means the
# contents execute once per loop iteration
_SUBJAXPR_PARAMS = (
    ("jaxpr", False),  # pjit / closed_call / shard_map / scan (see below)
    ("call_jaxpr", False),
    ("body_jaxpr", True),  # while body
    ("cond_jaxpr", False),
    ("branches", False),  # cond/switch
)


def _payload_bytes(eqn) -> int:
    tot = 0
    for v in eqn.invars:
        aval = getattr(v, "aval", None)
        if aval is not None and hasattr(aval, "shape"):
            tot += int(np.prod(aval.shape, dtype=np.int64)) * aval.dtype.itemsize
    return tot


def _walk(jaxpr, in_loop: bool, out: List[Dict[str, Any]]):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in _COLLECTIVES:
            out.append(
                {
                    "primitive": name,
                    "op": _COLLECTIVES[name],
                    "per_shard_bytes": _payload_bytes(eqn),
                    "in_loop": in_loop,
                }
            )
        loop_body = name in ("while", "scan")
        for pname, marks_loop in _SUBJAXPR_PARAMS:
            sub = eqn.params.get(pname)
            if sub is None:
                continue
            subs = sub if isinstance(sub, (list, tuple)) else [sub]
            for s in subs:
                inner = getattr(s, "jaxpr", s)  # ClosedJaxpr -> jaxpr
                if hasattr(inner, "eqns"):
                    _walk(
                        inner,
                        in_loop or (marks_loop and loop_body) or (loop_body and pname == "jaxpr"),
                        out,
                    )


def collective_ledger(fn, *args, **kwargs) -> List[Dict[str, Any]]:
    """Trace fn(*args, **kwargs) and return every collective it issues:
    [{primitive, op, per_shard_bytes, in_loop}]. `in_loop` marks
    collectives inside a while/scan body — the per-iteration wire cost."""
    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    out: List[Dict[str, Any]] = []
    _walk(closed.jaxpr, False, out)
    return out


def ledger_summary(ledger: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a ledger into {op: count} totals plus per-iteration rows."""
    summary: Dict[str, Any] = {
        "total_collectives": len(ledger),
        "per_iteration": {},
        "one_time": {},
        "per_iteration_bytes": 0,
    }
    for rec in ledger:
        bucket = "per_iteration" if rec["in_loop"] else "one_time"
        summary[bucket][rec["op"]] = summary[bucket].get(rec["op"], 0) + 1
        if rec["in_loop"]:
            summary["per_iteration_bytes"] += rec["per_shard_bytes"]
    return summary
