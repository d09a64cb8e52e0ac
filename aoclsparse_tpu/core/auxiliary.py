"""Auxiliary/introspection API.

Reference: src/extra/aoclsparse_auxiliary.cpp — get_version (:35),
enable_instructions (:53), debug_get (:116), handle-level
convert_csr/convert_bsr (conversion/aoclsparse_convert.cpp:1004-1471).
"""

from __future__ import annotations

from typing import Optional

from ..core.context import get_context, reset_context
from ..core.matrix import SparseMatrix
from ..core.types import AoclSparseError, FormatType, Operation, Status

__all__ = [
    "convert_csr",
    "convert_bsr",
    "convert_format",
    "debug_get",
    "enable_instructions",
    "set_precision_mode",
]


def convert_csr(h: SparseMatrix, op: Operation = Operation.none) -> SparseMatrix:
    """New CSR-format handle holding op(A) (aoclsparse_convert_csr,
    conversion/aoclsparse_convert.cpp:1004)."""
    from ..convert import conversions as cv

    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix")
    A = cv.to_csr(h.data)
    A = cv.csr_apply_operation(A, op)
    return SparseMatrix(A, FormatType.csr, h.base)


def convert_bsr(
    h: SparseMatrix, block_dim: int, op: Operation = Operation.none
) -> SparseMatrix:
    """CSR -> BSR handle conversion (aoclsparse_convert_bsr)."""
    from ..convert import conversions as cv

    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix")
    if block_dim <= 0:
        raise AoclSparseError(Status.invalid_size, "block_dim must be positive")
    A = cv.csr_apply_operation(cv.to_csr(h.data), op)
    return SparseMatrix(cv.csr_to_bsr(A, block_dim), FormatType.bsr, h.base)


def convert_format(h: SparseMatrix, fmt: FormatType, op: Operation = Operation.none, **kw):
    """Generic handle-level format conversion."""
    from ..convert import conversions as cv

    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    try:
        fmt = FormatType(fmt)
    except ValueError:
        raise AoclSparseError(Status.invalid_value, f"unknown format {fmt!r}") from None
    if fmt == FormatType.csr:
        return convert_csr(h, op)
    if fmt == FormatType.bsr:
        return convert_bsr(h, kw.get("block_dim", 2), op)
    A = cv.csr_apply_operation(cv.to_csr(h.data), op)
    if fmt == FormatType.csc:
        return SparseMatrix(cv.to_csc(A), FormatType.csc, h.base)
    if fmt == FormatType.coo:
        return SparseMatrix(cv.to_coo(A), FormatType.coo, h.base)
    if fmt == FormatType.ell:
        return SparseMatrix(cv.csr_to_ell(A), FormatType.ell, h.base)
    if fmt == FormatType.dia:
        return SparseMatrix(cv.csr_to_dia(A), FormatType.dia, h.base)
    raise AoclSparseError(Status.not_implemented, f"convert to {fmt.name}")


def debug_get() -> dict:
    """Runtime introspection (aoclsparse_debug_get analog: ISA/arch/threads
    there; platform/device/published peaks/native-library here). `peaks`
    is None for a device without published peaks (core/context.py PEAKS)."""
    import dataclasses

    from .. import native
    from .. import __version__
    from .context import PEAKS

    ctx = get_context()
    peaks = PEAKS.get(ctx.device_kind)
    return {
        "version": __version__,
        "platform": ctx.platform,
        "device_kind": ctx.device_kind,
        "num_devices": ctx.num_devices,
        "peaks": None if peaks is None else dataclasses.asdict(peaks),
        "native_host_kernels": native.available(),
        "force_kid": ctx.force_kid,
    }


def enable_instructions(mode: Optional[str]) -> None:
    """Kernel-path override (AOCL_ENABLE_INSTRUCTIONS /
    aoclsparse_enable_instructions analog). The portable gather kernels are
    the default on every platform, so "generic" and None/""/"auto" select
    the same kernels; the call validates the mode and re-detects the
    device context. Per-call kernel pins go through a KID instead."""
    if mode not in (None, "", "auto", "generic"):
        raise AoclSparseError(Status.invalid_value, f"unknown instruction mode '{mode}'")
    reset_context()


def set_precision_mode(h: SparseMatrix, mode: str) -> None:
    """Per-handle precision policy opt-in (docs/precision.md; no reference
    analog — its kernels are fixed-precision by dtype suffix):

      "full"  — every multiply in the operand dtype (default)
      "mixed" — bf16-multiply/f32-accumulate on f32 operands where a kernel
                supports it (band/bwd/gen SpMV, band SpMM); halves the
                dominant operand traffic at a documented, tested error
                bound (tests/test_precision_policy.py vs the reference
                tolerance model)

    The AOCLSPARSE_TPU_MIXED_PRECISION env var overrides in both
    directions ("1" forces on, "0" kills)."""
    if h is None:
        raise AoclSparseError(Status.invalid_pointer, "null matrix handle")
    if mode not in ("full", "mixed"):
        raise AoclSparseError(Status.invalid_value, f"unknown precision mode '{mode}'")
    h.precision_mode = mode
