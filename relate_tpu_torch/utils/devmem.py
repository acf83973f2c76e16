"""Device selection and device-memory introspection for window planning.

The reference sizes windows from a user ``--memory`` budget (default 5 GB,
data.cpp:129,219-229). Here the default budget follows the card's actual
memory as ``torch.cuda.mem_get_info`` reports it. On ``device="cpu"`` there
is no card to ask, so the caller gives ``memory_gb``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card and raises if there is none: nothing
    runs on the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for but none is available")
    return device


def device_memory_gb(device=None) -> float:
    """Total memory of the card in GB (10^9 bytes)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(
            "device memory is only known for a CUDA device; give memory_gb "
            "explicitly on device='cpu'")
    _free, total = torch.cuda.mem_get_info(device)
    return total / 1e9


def auto_memory_gb(device=None) -> float:
    """Window-planner budget derived from the card's memory.

    The planner's budget counts 4-byte posterior floats (the reference's
    model); on the card a window holds about 9 bytes per posterior cell
    (int8 mismatch stream + f32 forward rows + f32 posterior) and the step
    axis runs to the longest target. total/20, clamped to [0.25, 5] GB,
    leaves room for that, the merge matrices and the checkpoint slabs.
    """
    return max(0.25, min(5.0, device_memory_gb(device) / 20.0))


# the bytes one batch may use on the CPU, where no free memory is reported
HOST_BATCH_BYTES = 1 << 30


def batch_rows(bytes_per_row: int, total: int, device, share: float = 0.5,
               reserve: int = 0) -> int:
    """How many rows of ``bytes_per_row`` one batch may hold: ``share`` of
    the card's free memory less ``reserve`` bytes on a CUDA device,
    ``HOST_BATCH_BYTES`` on the CPU; at least 1 and at most ``total``."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = share * free - reserve
    else:
        budget = HOST_BATCH_BYTES
    return int(max(1, min(max(total, 1), budget // max(bytes_per_row, 1))))
