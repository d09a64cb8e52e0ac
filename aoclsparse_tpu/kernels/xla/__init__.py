"""XLA-path kernels: jittable pure functions over statically-shaped arrays.

Registered into the global kernel registry (kernels/registry.py) as the
rows of each op's KAT table — the analog of the reference's ``ref``/KT-AVX2
rows.
"""

from . import spmv  # noqa: F401
from ..registry import KernelEntry, registry

# SpMV KAT table (csrmv/ellmv/bsrmv/diamv analog rows)
registry.register("mv", KernelEntry(0, "xla_segsum", spmv.spmv_segsum, "segsum", "any", 0))
registry.register("mv", KernelEntry(1, "xla_ell", spmv.spmv_ell, "ell", "any", 0))
registry.register("mv", KernelEntry(2, "xla_ellhyb", spmv.spmv_ellhyb, "ellhyb", "any", 0))
registry.register("mv", KernelEntry(3, "xla_bsr", spmv.spmv_bsr, "bsr", "any", 0))
registry.register("mv", KernelEntry(4, "xla_dia", spmv.spmv_dia, "dia", "any", 0))
registry.register("mv", KernelEntry(5, "xla_bwd", spmv.spmv_bwd, "bwd", "any", 1))
registry.register("mv", KernelEntry(6, "xla_diag", spmv.spmv_diag, "diag", "any", 1))
registry.register("mv", KernelEntry(7, "xla_gen", spmv.spmv_gen, "gen", "any", 1))
registry.register("mv", KernelEntry(9, "xla_bwdg", spmv.spmv_bwdg, "bwdg", "any", 1))
registry.register("mv", KernelEntry(10, "xla_sell", spmv.spmv_sell, "sell", "any", 0))

# Host engine for latency-bound tiny operands (kernels/host.py): negative
# priority keeps it out of Oracle auto-selection — it runs only via an
# explicit KID or an autotune_mv pin (CLAUDE.md non-default carve-out)
from ..host import HOST_MV_KID, spmv_host_csr  # noqa: E402

registry.register(
    "mv", KernelEntry(HOST_MV_KID, "host_csr", spmv_host_csr, "host", "any", -5)
)
