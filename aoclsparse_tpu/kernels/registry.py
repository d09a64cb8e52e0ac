"""Kernel registry + oracle dispatcher.

Analog of the reference's Kernel-Attribute-Table + Oracle
(library/src/include/aoclsparse_cntx_dispatcher.hpp:46-78, 272-364). The
reference scores table rows by CPU arch/ISA flags; here rows declare which
backend (a JAX platform, "gpu"/"cpu", or "any") and which execution-format
they serve and the
Oracle scores (backend exact match, format match, declared priority), caches
the winner per lookup key, honors explicit KID overrides (returning
``Status.invalid_kid`` for unsupported requests, like Dispatch::Oracle), and a
global env override ``AOCLSPARSE_TPU_FORCE_KID`` (the AOCL_ENABLE_INSTRUCTIONS
analog). ``debug_dispatcher`` reports which kernel would run
(aoclsparse_debug_dispatcher analog, include/aoclsparse_auxiliary.h).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..core.context import get_context
from ..core.types import AoclSparseError, Status

__all__ = ["KernelEntry", "Registry", "registry", "debug_dispatcher"]


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One KAT row: Table<K>{kernel, min_cpu_flag, arch_bitmask} analog."""

    kid: int
    name: str
    fn: Callable
    fmt: str  # execution format it consumes: "segsum"|"ell"|"ellhyb"|"bsr"|"dia"|...
    backend: str = "any"  # a JAX platform ("gpu" | "cpu") or "any"
    priority: int = 0  # ties -> highest kid wins, like the reference


class Registry:
    def __init__(self):
        self._tables: Dict[str, List[KernelEntry]] = {}
        self._cache: Dict[Tuple, KernelEntry] = {}

    def register(self, op: str, entry: KernelEntry) -> None:
        tbl = self._tables.setdefault(op, [])
        if any(e.kid == entry.kid for e in tbl):
            raise ValueError(f"duplicate kid {entry.kid} for op {op}")
        tbl.append(entry)
        self._cache = {k: v for k, v in self._cache.items() if k[0] != op}

    def table(self, op: str) -> List[KernelEntry]:
        return list(self._tables.get(op, []))

    def _score(self, e: KernelEntry, fmt: Optional[str], backend: str) -> int:
        """Oracle scoring (cntx_dispatcher.hpp:272-364): exact backend match
        scores highest; "any" rows are penalized; format mismatch disqualifies."""
        if fmt is not None and e.fmt != fmt:
            return -1
        if e.backend not in ("any", backend):
            return -1
        score = 32 if e.backend == backend else 16
        return score + e.priority

    def select(
        self, op: str, fmt: Optional[str] = None, kid: Optional[int] = None
    ) -> KernelEntry:
        """Pick the kernel for (op, execution format), honoring KID override."""
        ctx = get_context()
        backend = ctx.platform
        if kid is None and ctx.force_kid is not None:
            kid = ctx.force_kid
        tbl = self._tables.get(op)
        if not tbl:
            raise AoclSparseError(Status.not_implemented, f"no kernels for op '{op}'")
        if kid is not None:
            for e in tbl:
                if e.kid == kid:
                    if self._score(e, fmt, backend) < 0:
                        raise AoclSparseError(
                            Status.invalid_kid,
                            f"kid {kid} unsupported for op '{op}' fmt={fmt} backend={backend}",
                        )
                    return e
            raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for '{op}'")
        key = (op, fmt, backend)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        best, best_score = None, -1
        for e in tbl:
            s = self._score(e, fmt, backend)
            # ties resolved toward highest kid, like the reference Oracle
            if s > best_score or (s == best_score and best is not None and e.kid > best.kid):
                best, best_score = e, s
        if best is None or best_score < 0:
            raise AoclSparseError(
                Status.not_implemented, f"no kernel for op '{op}' fmt={fmt} backend={backend}"
            )
        self._cache[key] = best
        return best


#: Global registry (the static KAT tables live in each op module, which
#: registers its kernels at import).
registry = Registry()


def debug_dispatcher(op: str, fmt: Optional[str] = None, kid: Optional[int] = None) -> dict:
    """Which kernel would run? (aoclsparse_debug_dispatcher analog)."""
    e = registry.select(op, fmt=fmt, kid=kid)
    ctx = get_context()
    return {
        "op": op,
        "kid": e.kid,
        "name": e.name,
        "fmt": e.fmt,
        "backend": e.backend,
        "platform": ctx.platform,
        "device_kind": ctx.device_kind,
    }
