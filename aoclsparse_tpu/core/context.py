"""Runtime context singleton: the analog of the reference's cpuid/thread
context (library/src/include/aoclsparse_context.hpp:130-379 and the singleton
at src/extra/aoclsparse_context.cpp:32-37).

Where the reference detects Zen arch + AVX flags and a thread budget, we
detect the JAX backend ("gpu" or "cpu"), the device kind and the device
count. The published peaks of each supported device live in ``PEAKS``, keyed
by ``device_kind``; they serve roofline reporting only, never correctness,
and a device missing from the table has no peaks (asking for them raises).
Env override (the AOCL_ENABLE_INSTRUCTIONS analog):

- ``AOCLSPARSE_TPU_FORCE_KID``  — global kernel-id override (debugging)
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import jax

from .types import AoclSparseError, Status

__all__ = ["Context", "DevicePeaks", "PEAKS", "device_peaks", "get_context", "reset_context"]


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one device (dense, no sparsity)."""

    hbm_gbps: float
    fp64_tflops: float
    fp64_tensor_tflops: float
    fp32_tflops: float
    source: str


#: Published peaks by ``jax.Device.device_kind``. The H100 rates assume the
#: card's full 700 W power limit; a card set lower cannot hold them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        hbm_gbps=3350.0,
        fp64_tflops=34.0,
        fp64_tensor_tflops=67.0,
        fp32_tflops=67.0,
        source="NVIDIA H100 SXM data sheet",
    ),
}


def device_peaks(device_kind: str) -> DevicePeaks:
    """Peaks of `device_kind`; an unknown device is an error, not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise AoclSparseError(
            Status.invalid_value,
            f"no published peaks for device kind {device_kind!r} (core/context.py PEAKS)",
        ) from None


@dataclasses.dataclass
class Context:
    platform: str
    device_kind: str
    num_devices: int
    force_kid: Optional[int]

    @property
    def peaks(self) -> DevicePeaks:
        return device_peaks(self.device_kind)


_lock = threading.Lock()
_ctx: Optional[Context] = None


def _detect() -> Context:
    devs = jax.devices()
    d0 = devs[0]
    force_kid = os.environ.get("AOCLSPARSE_TPU_FORCE_KID")
    return Context(
        platform=d0.platform,
        device_kind=str(getattr(d0, "device_kind", d0.platform)),
        num_devices=len(devs),
        force_kid=int(force_kid) if force_kid is not None else None,
    )


def get_context() -> Context:
    global _ctx
    if _ctx is None:
        with _lock:
            if _ctx is None:
                _ctx = _detect()
    return _ctx


def reset_context() -> None:
    """Drop the cached context (tests switch platforms)."""
    global _ctx
    with _lock:
        _ctx = None
