"""Bit-exact PyTorch port of the reference's fast_log approximation.

The reference uses a polynomial float32 log approximation in every hot loop
(``include/src/fast_log.hpp:6-21``). Replicating it bit for bit keeps the
distance matrices (and thus the tree builder's decisions) aligned with the
JAX package and the C++ oracle. The float is reinterpreted as int32 with
``tensor.view(torch.int32)``; the polynomial is evaluated with separate
multiplies and adds (eager PyTorch does not contract them).
"""
from __future__ import annotations

import torch

LN2 = 0.69314718  # rounded to float32 by the multiply below


def fast_log2(val: torch.Tensor) -> torch.Tensor:
    """float32 -> float32, identical to fast_log2 in fast_log.hpp."""
    val = val.to(torch.float32).contiguous()
    x = val.view(torch.int32)
    log_2 = ((x >> 23) & 255) - 128
    x = (x & ~(255 << 23)) + (127 << 23)
    m = x.view(torch.float32)
    m = (m * (-1.0 / 3) + 2) * m - (2.0 / 3)
    return m + log_2.to(torch.float32)


def fast_log(val: torch.Tensor) -> torch.Tensor:
    """Natural-log version (fast_log.hpp:20-22)."""
    return fast_log2(val) * LN2
