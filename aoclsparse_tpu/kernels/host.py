"""Host (numpy) execution engine for latency-bound tiny operands.

Every device call pays a dispatch and, for numpy callers, a result fetch;
for sub-ms operands (small stencils, RCI driver loops holding numpy
vectors) the device path is pure overhead. This engine serves the same
role as the reference's plain scalar kernels on small inputs
(ref_csrmv_gn, level2/aoclsparse_csrmv_kr.hpp:450): a vectorized host CSR
SpMV over plan-cached numpy arrays, selected either explicitly (mv KID 11)
or by an ``autotune_mv`` measurement pin. It is never the default: the
registry row carries negative priority, and traced (jit) callers never
route here (the pin is consulted only at the eager ``mv`` entry).

The host path returns ``np.ndarray`` (the whole point is to avoid touching
the device); callers that need a device array get one implicitly on first
jnp use.
"""

from __future__ import annotations

import numpy as np

__all__ = ["spmv_host_csr", "HOST_MV_KID"]

#: mv KID of the host engine (see kernels/xla/__init__.py registration).
HOST_MV_KID = 11


def spmv_host_csr(ptr: np.ndarray, ind: np.ndarray, val: np.ndarray, x: np.ndarray):
    """y = A @ x over host CSR arrays, vectorized (np.add.reduceat).

    ``reduceat`` quirks — an empty segment (ptr[i] == ptr[i+1]) returns the
    *element* at the start index instead of 0, and a clamped start index
    would silently truncate the previous row — so reduceat runs over the
    non-empty rows only (their start offsets are strictly increasing and in
    bounds) and empty rows stay 0. Host-side structure work must be
    vectorized numpy per repo rules (this box's Python is throttled).
    """
    m = ptr.shape[0] - 1
    nnz = ind.shape[0]
    dtype = np.result_type(val.dtype, x.dtype)
    if nnz == 0 or m == 0:
        return np.zeros(m, dtype=dtype)
    prods = (val * x[ind]).astype(dtype, copy=False)
    starts = ptr[:-1].astype(np.int64)
    lens = np.diff(ptr.astype(np.int64))
    nz = lens > 0
    y = np.zeros(m, dtype=dtype)
    if nz.any():
        y[nz] = np.add.reduceat(prods, starts[nz])
    return y
