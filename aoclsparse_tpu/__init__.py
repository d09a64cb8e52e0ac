"""aoclsparse_tpu — a sparse linear-algebra library on JAX.

JAX/XLA implementation of the capability surface of
AMD's AOCL-Sparse (see SURVEY.md at the repo root): sparse BLAS levels 1-3,
format conversions, a trace-time planner (the hint/optimize analog),
triangular solves and preconditioners via level-scheduled wavefronts, a
CG/GMRES Krylov layer, and multi-device distribution over jax.sharding
meshes.
"""

from .core.types import (  # noqa: F401
    AoclSparseError,
    DiagType,
    FillMode,
    FormatType,
    IluType,
    IndexBase,
    MatrixSort,
    MatrixType,
    MemoryPolicy,
    Operation,
    Order,
    Request,
    SorType,
    Status,
)
from .core.descr import Doid, GENERAL, MatrixDescriptor, get_doid, trans_doid  # noqa: F401
from .core.formats import BSR, COO, CSC, CSR, DIA, ELL, SELL  # noqa: F401
from .core.matrix import (  # noqa: F401
    SparseMatrix,
    copy,
    create_bsr,
    create_coo,
    create_csc,
    create_csr,
    create_dia,
    create_ell,
    create_tcsr,
    destroy,
    export_coo,
    export_csc,
    export_csr,
    order_mat,
    set_value,
    update_values,
)
from .core.auxiliary import (  # noqa: F401
    convert_format,
    convert_bsr,
    convert_csr,
    debug_get,
    enable_instructions,
    set_precision_mode,
)
from .core.context import get_context  # noqa: F401
from .kernels.autotune import (  # noqa: F401
    autotune_mm,
    autotune_mv,
    autotune_spgemm,
    autotune_trsv,
)
from .kernels.registry import debug_dispatcher  # noqa: F401
from .ops import (  # noqa: F401
    add,
    axpyi,
    blkcsrmv,
    bsrmv,
    csr2m,
    csrmv,
    csrsv,
    diamv,
    dotci,
    doti,
    dotmv,
    dotui,
    ellmv,
    ellthybmv,
    elltmv,
    gthr,
    gthrs,
    gthrz,
    roti,
    sctr,
    sctrs,
    mm,
    mv,
    mv_operator,
    sp2m,
    sp2md,
    spmm,
    spmmd,
    sypr,
    syprd,
    syrk,
    syrkd,
    trsm,
    trsv,
    trsv_strided,
)
from .convert.conversions import (  # noqa: F401
    csr2blkcsr,
    csr2bsr_nnz,
    csr2dia_ndiag,
    csr2ell_width,
    csr2ellthyb_width,
    opt_blksize,
)
from .solvers import (  # noqa: F401
    RciJob,
    ilu0_factorize,
    ilu_smoother,
    itsol_handle_prn_options,
    itsol_init,
    itsol_option_set,
    itsol_rci_input,
    itsol_rci_solve,
    itsol_solve,
    itsol_solve_operator,
    pcg_solve,
    pgmres_solve,
    sorv,
    symgs,
    symgs_mv,
)
from .planner import (  # noqa: F401
    optimize,
    set_2m_hint,
    set_dotmv_hint,
    set_lu_smoother_hint,
    set_memory_hint,
    set_mm_hint,
    set_mv_hint,
    set_mv_hint_kid,
    set_sm_hint,
    set_sorv_hint,
    set_sv_hint,
    set_symgs_hint,
)

__version__ = "0.1.0"


def get_version() -> str:
    """aoclsparse_get_version analog."""
    return __version__
