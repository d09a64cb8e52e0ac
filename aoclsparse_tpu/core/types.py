"""Core type system: enums, status codes, exceptions, dtype policy.

Re-design of the reference's C type layer
(/root/reference/library/include/aoclsparse_types.h:54-402). The reference
exposes C enums and a 15-value status enum returned from every call; here the
same taxonomy becomes Python ``IntEnum``s plus a typed exception hierarchy, and
the ILP64 ``aoclsparse_int`` switch becomes an index-dtype policy (int32 is the
default index width; int64 supported for very large matrices).
"""

from __future__ import annotations

import enum

import jax.numpy as jnp
import numpy as np

__all__ = [
    "Status",
    "AoclSparseError",
    "Operation",
    "IndexBase",
    "MatrixType",
    "FillMode",
    "DiagType",
    "Order",
    "FormatType",
    "Request",
    "SorType",
    "MemoryPolicy",
    "MatrixSort",
    "IluType",
    "index_dtype",
    "supported_value_dtypes",
    "is_complex_dtype",
    "real_dtype_of",
    "check_value_dtype",
]


class Status(enum.IntEnum):
    """Status codes, mirroring aoclsparse_status (aoclsparse_types.h:303-323)."""

    success = 0
    invalid_handle = 1
    not_implemented = 2
    invalid_pointer = 3
    invalid_size = 4
    internal_error = 5
    invalid_value = 6
    invalid_index_value = 7
    maxit = 8
    user_stop = 9
    wrong_type = 10
    memory_error = 11
    numerical_error = 12
    invalid_operation = 13
    unsorted_input = 14
    invalid_kid = 15


class AoclSparseError(Exception):
    """Exception carrying a :class:`Status`; the JAX-native analog of the
    reference's C status-code returns."""

    def __init__(self, status: Status, message: str = ""):
        self.status = Status(status)
        super().__init__(f"[{self.status.name}] {message}" if message else self.status.name)


def _err(status: Status, message: str = "") -> AoclSparseError:
    return AoclSparseError(status, message)


class Operation(enum.IntEnum):
    """Transposition applied to the sparse operand (aoclsparse_operation)."""

    none = 111
    transpose = 112
    conjugate_transpose = 113

    @property
    def short(self) -> str:
        return {111: "n", 112: "t", 113: "h"}[int(self)]


class IndexBase(enum.IntEnum):
    zero = 0
    one = 1


class MatrixType(enum.IntEnum):
    general = 0
    symmetric = 1
    hermitian = 2
    triangular = 3


class FillMode(enum.IntEnum):
    lower = 0
    upper = 1


class DiagType(enum.IntEnum):
    non_unit = 0
    unit = 1
    zero = 2  # structurally-zero diagonal (reference: aoclsparse_diag_type_zero)


class Order(enum.IntEnum):
    """Dense storage order for SpMM / dense outputs."""

    row = 0
    column = 1


class FormatType(enum.IntEnum):
    """Storage formats. The x86-motivated formats of the reference
    (BLKCSR/CSR-BR4/TCSR) are replaced by internal execution forms chosen by
    the planner; user-facing formats below."""

    csr = 0
    csc = 1
    coo = 2
    ell = 3
    dia = 4
    bsr = 5
    ellhyb = 6  # hybrid ELL + CSR spill (internal, planner-chosen)
    sell = 7  # sliced-ELL row-block padded form (internal, planner-chosen)
    tcsr = 8  # triangular CSR, both triangles + duplicated diagonal


class Request(enum.IntEnum):
    """Two-stage SpGEMM request protocol (aoclsparse_types.h:334-346)."""

    nnz_count = 0
    finalize = 1
    full_computation = 2


class SorType(enum.IntEnum):
    forward = 0
    backward = 1
    symmetric = 2


class MemoryPolicy(enum.IntEnum):
    unrestricted = 0
    restricted = 1


class MatrixSort(enum.IntEnum):
    unknown = 0
    unsorted = 1
    partially_sorted = 2
    fully_sorted = 3


class IluType(enum.IntEnum):
    ilu0 = 0
    ilup = 1  # placeholder, like the reference (types.h:217-222)


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------

#: Default index dtype. int32 by default; the reference's BUILD_ILP64
#: switch corresponds to passing int64 indices explicitly.
index_dtype = jnp.int32

_SUPPORTED = ("float32", "float64", "complex64", "complex128", "bfloat16", "float16")


def supported_value_dtypes() -> tuple:
    return tuple(jnp.dtype(d) for d in _SUPPORTED)


def check_value_dtype(dtype) -> jnp.dtype:
    dt = jnp.dtype(dtype)
    if str(dt) not in _SUPPORTED:
        raise _err(Status.wrong_type, f"unsupported value dtype {dt}")
    return dt


def is_complex_dtype(dtype) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)


def real_dtype_of(dtype) -> jnp.dtype:
    dt = jnp.dtype(dtype)
    if dt == jnp.complex64:
        return jnp.dtype(jnp.float32)
    if dt == jnp.dtype("complex128"):
        return jnp.dtype(jnp.float64)
    return dt


def conj_if(x, flag: bool):
    """Conjugate ``x`` when ``flag`` and x is complex (no-op for reals)."""
    if flag and is_complex_dtype(np.asarray(x).dtype if not hasattr(x, "dtype") else x.dtype):
        return jnp.conj(x)
    return x
