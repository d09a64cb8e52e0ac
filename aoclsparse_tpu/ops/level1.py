"""Level-1 sparse-vector ops (reference: library/src/level1/*).

aoclsparse_?axpyi (level1/aoclsparse_axpyi.cpp:44), ?doti/?dotci/?dotui
(aoclsparse_dot.cpp), ?gthr/?gthrz/?gthrs (aoclsparse_gthr.cpp), ?roti
(aoclsparse_roti.cpp), ?sctr/?sctrs (aoclsparse_sctr.cpp).

JAX-functional redesign: the reference mutates dense operands in place; here
every op returns the updated array(s). Sparse vectors are (val, ind) pairs
against a dense partner, exactly the reference's compressed-index model. All
kernels are jitted gathers/scatters — the `kt_set_p` index-gather maps to
jnp.take, the scatter stores to `.at[].set/add`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.types import AoclSparseError, Status, is_complex_dtype
from ..kernels.registry import KernelEntry, registry

__all__ = [
    "axpyi",
    "doti",
    "dotci",
    "dotui",
    "gthr",
    "gthrz",
    "gthrs",
    "roti",
    "sctr",
    "sctrs",
]


def _check_sparse_vec(x, indx, allow_empty=True):
    if x is None or indx is None:
        raise AoclSparseError(Status.invalid_pointer, "null sparse vector argument")
    x = jnp.asarray(x)
    indx = jnp.asarray(indx)
    if indx.ndim != 1 or x.ndim != 1 or x.shape[0] != indx.shape[0]:
        raise AoclSparseError(Status.invalid_size, "sparse vector val/ind mismatch")
    if not allow_empty and x.shape[0] == 0:
        raise AoclSparseError(Status.invalid_size, "empty sparse vector")
    return x, indx


def _check_bounds(indx, n: int):
    """Index-range validation against the dense operand. The C reference
    cannot know the dense array's extent (raw pointers); here the arrays
    carry their length, so out-of-range indices surface
    invalid_index_value instead of silently clipping in the XLA gather."""
    if indx.shape[0] and (int(indx.min()) < 0 or int(indx.max()) >= n):
        raise AoclSparseError(Status.invalid_index_value, "index out of range of dense operand")


def _check_kid(op: str, kid: Optional[int]):
    """`_kid`-variant parity (aoclsparse_?axpyi_kid etc.): an explicit kernel
    id must name a registered row for the op, else invalid_kid — the
    reference validates against the KAT and returns invalid_kid
    (cntx_dispatcher.hpp:272-364). With one XLA row per level-1 op the
    override is a no-op when valid."""
    if kid is None:
        return
    if not any(e.kid == kid for e in registry.table(op)):
        raise AoclSparseError(Status.invalid_kid, f"kid {kid} not in table for '{op}'")


@jax.jit
def _axpyi(a, x, indx, y):
    return y.at[indx].add(a * x)


def axpyi(a, x, indx, y, kid: Optional[int] = None):
    """y[indx[i]] += a * x[i] (aoclsparse_?axpyi/_kid)."""
    _check_kid("axpyi", kid)
    x, indx = _check_sparse_vec(x, indx)
    if y is None:
        raise AoclSparseError(Status.invalid_pointer, "null y")
    y = jnp.asarray(y)
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return y
    a = jnp.asarray(a, dtype=jnp.result_type(y.dtype, x.dtype))
    return _axpyi(a, x, indx, y)


@jax.jit
def _dot(x, indx, y, conj_x: bool = False):
    xs = jnp.conj(x) if conj_x else x
    return jnp.sum(xs * y[indx])


def doti(x, indx, y, kid: Optional[int] = None):
    """Real dot: sum x[i] * y[indx[i]] (aoclsparse_?doti/_kid)."""
    _check_kid("doti", kid)
    x, indx = _check_sparse_vec(x, indx)
    y = jnp.asarray(y)
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return jnp.zeros((), dtype=jnp.result_type(x.dtype, y.dtype))
    return _dot(x, indx, y)


def dotci(x, indx, y, kid: Optional[int] = None):
    """Conjugated complex dot: sum conj(x[i]) * y[indx[i]] (aoclsparse_?dotci/_kid)."""
    _check_kid("dotci", kid)
    x, indx = _check_sparse_vec(x, indx)
    y = jnp.asarray(y)
    if not is_complex_dtype(x.dtype):
        raise AoclSparseError(Status.wrong_type, "dotci requires complex dtype")
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return jnp.zeros((), dtype=jnp.result_type(x.dtype, y.dtype))
    return _dot(jnp.conj(x), indx, y)


def dotui(x, indx, y, kid: Optional[int] = None):
    """Unconjugated complex dot (aoclsparse_?dotui/_kid)."""
    _check_kid("dotui", kid)
    x, indx = _check_sparse_vec(x, indx)
    y = jnp.asarray(y)
    if not is_complex_dtype(x.dtype):
        raise AoclSparseError(Status.wrong_type, "dotui requires complex dtype")
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return jnp.zeros((), dtype=jnp.result_type(x.dtype, y.dtype))
    return _dot(x, indx, y)


@jax.jit
def _gthr(y, indx):
    return y[indx]


def gthr(y, indx, kid: Optional[int] = None):
    """x[i] = y[indx[i]] (aoclsparse_?gthr/_kid)."""
    _check_kid("gthr", kid)
    if y is None or indx is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    y = jnp.asarray(y)
    indx = jnp.asarray(indx)
    _check_bounds(indx, y.shape[0])
    return _gthr(y, indx)


@jax.jit
def _gthrz(y, indx):
    return y[indx], y.at[indx].set(0)


def gthrz(y, indx, kid: Optional[int] = None) -> Tuple[jax.Array, jax.Array]:
    """Gather then zero the gathered entries; returns (x, y') (aoclsparse_?gthrz/_kid)."""
    _check_kid("gthrz", kid)
    if y is None or indx is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    y = jnp.asarray(y)
    indx = jnp.asarray(indx)
    _check_bounds(indx, y.shape[0])
    return _gthrz(y, indx)


def gthrs(y, stride: int, nnz: Optional[int] = None, kid: Optional[int] = None):
    """Strided gather x[i] = y[i*stride] (aoclsparse_?gthrs/_kid)."""
    _check_kid("gthrs", kid)
    if y is None:
        raise AoclSparseError(Status.invalid_pointer, "null y")
    y = jnp.asarray(y)
    if stride <= 0:
        raise AoclSparseError(Status.invalid_size, "stride must be positive")
    n = nnz if nnz is not None else y.shape[0] // stride
    if n < 0 or n * stride > y.shape[0]:
        raise AoclSparseError(Status.invalid_size, "stride*nnz exceeds y size")
    return y[: n * stride : stride]


@jax.jit
def _roti(x, indx, y, c, s):
    yg = y[indx]
    x_new = c * x + s * yg
    y_new = y.at[indx].set(c * yg - s * x)
    return x_new, y_new


def roti(x, indx, y, c, s, kid: Optional[int] = None) -> Tuple[jax.Array, jax.Array]:
    """Givens rotation of sparse x against dense y (aoclsparse_?roti):
    x[i] <- c*x[i] + s*y[indx[i]];  y[indx[i]] <- c*y[indx[i]] - s*x[i]."""
    _check_kid("roti", kid)
    x, indx = _check_sparse_vec(x, indx)
    y = jnp.asarray(y)
    if is_complex_dtype(x.dtype):
        raise AoclSparseError(Status.wrong_type, "roti is real-only (s/d) like the reference")
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return x, y
    dt = jnp.result_type(x.dtype, y.dtype)
    return _roti(x, indx, y, jnp.asarray(c, dt), jnp.asarray(s, dt))


@jax.jit
def _sctr(x, indx, y):
    return y.at[indx].set(x)


def sctr(x, indx, y, kid: Optional[int] = None):
    """y[indx[i]] = x[i] (aoclsparse_?sctr/_kid)."""
    _check_kid("sctr", kid)
    x, indx = _check_sparse_vec(x, indx)
    if y is None:
        raise AoclSparseError(Status.invalid_pointer, "null y")
    y = jnp.asarray(y)
    _check_bounds(indx, y.shape[0])
    if x.shape[0] == 0:
        return y
    return _sctr(x, indx, y)


def sctrs(x, stride: int, y, kid: Optional[int] = None):
    """Strided scatter y[i*stride] = x[i] (aoclsparse_?sctrs/_kid)."""
    _check_kid("sctrs", kid)
    if x is None or y is None:
        raise AoclSparseError(Status.invalid_pointer, "null argument")
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if stride <= 0:
        raise AoclSparseError(Status.invalid_size, "stride must be positive")
    if x.shape[0] * stride > y.shape[0]:
        raise AoclSparseError(Status.invalid_size, "stride*nnz exceeds y size")
    return y.at[: x.shape[0] * stride : stride].set(x)


# KAT rows for introspection parity (each op has one XLA row)
for _op, _fn in [
    ("axpyi", _axpyi),
    ("doti", _dot),
    ("dotci", _dot),
    ("dotui", _dot),
    ("gthr", _gthr),
    ("gthrz", _gthrz),
    ("gthrs", _gthr),
    ("roti", _roti),
    ("sctr", _sctr),
    ("sctrs", _sctr),
]:
    registry.register(_op, KernelEntry(0, f"xla_{_op}", _fn, "dense", "any", 0))
