"""Bit helpers (counterpart of ``popcount`` in ``paxos_tpu/utils/bitops.py``).

The packed lane-state codec of the reference is not ported yet: the port
keeps its state unpacked.
"""

from __future__ import annotations

import torch


def popcount(mask: torch.Tensor) -> torch.Tensor:
    """Number of set bits of each int32, as int32 (SWAR over the uint32
    bit pattern, computed in int64 so no shift sign-extends)."""
    x = mask.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
