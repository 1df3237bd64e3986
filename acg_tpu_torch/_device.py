"""Device selection for the port's entry points.

Every entry point runs on the CUDA card unless its caller asks for the
CPU (``device="cpu"``, ``--device cpu``).  There is no fallback: with no
card and no such request, :func:`resolve_device` raises, so a run never
drops to the CPU on its own.
"""

from __future__ import annotations

import torch

from acg_tpu_torch.errors import AcgError, ErrorCode


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda"/"cuda:N" -> that CUDA device (an error when no
    card is visible); "cpu" -> the CPU, only because it was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise AcgError(ErrorCode.DEVICE,
                       f"unsupported device {str(dev)!r} (use cuda or cpu)")
    if not torch.cuda.is_available():
        raise AcgError(ErrorCode.DEVICE,
                       "no CUDA device is available; the port runs on the "
                       "card unless asked for the CPU (device='cpu', "
                       "--device cpu)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_sync(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (a no-op on the CPU, whose
    ops complete before they return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
