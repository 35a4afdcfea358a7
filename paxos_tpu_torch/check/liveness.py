"""Liveness helpers (counterpart of ``paxos_tpu/check/liveness.py``).

Only the long-log window mask is ported; the ``liveness=`` report block
(decided-by curve, latency histogram, stuck lanes) is not.
"""

from __future__ import annotations

import torch


def window_valid_mask(chosen_shape, base: torch.Tensor, log_total: int) -> torch.Tensor:
    """(L, I) bool: window rows whose global slot index is a real log slot.

    ``base`` is the per-instance count of compacted (decided) slots; row
    ``l`` of instance ``i`` holds global slot ``base[i] + l``, which exists
    only while it is ``< log_total``."""
    sl = torch.arange(chosen_shape[0], dtype=torch.int32, device=base.device)[:, None]
    return (base[None, :] + sl) < log_total
