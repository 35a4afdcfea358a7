"""Quorum predicates (counterpart of ``paxos_tpu/kernels/quorum.py``).

Votes are accumulated as acceptor bits, so duplicate deliveries of one
acceptor's reply cannot inflate the count.
"""

from __future__ import annotations

import torch

from paxos_tpu_torch.utils.bitops import popcount


def majority(n_acc: int) -> int:
    """Size of a classic majority quorum."""
    return n_acc // 2 + 1


def fast_quorum(n_acc: int) -> int:
    """Size of a Fast Paxos fast quorum: ceil(3n/4)."""
    return -((-3 * n_acc) // 4)


def quorum_reached(heard_mask: torch.Tensor, quorum: int) -> torch.Tensor:
    """Elementwise: does the voter bitmask contain >= ``quorum`` voters?"""
    return popcount(heard_mask) >= quorum
