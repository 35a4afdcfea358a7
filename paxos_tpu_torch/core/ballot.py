"""Packed ballot numbers (counterpart of ``paxos_tpu/core/ballot.py``).

    ballot = round * MAX_PROPOSERS + proposer_id + 1      (NIL = 0)

Lexicographic (round, proposer_id) order becomes integer order.
"""

from __future__ import annotations

import torch

MAX_PROPOSERS = 8
NIL = 0


def make_ballot(rnd: torch.Tensor, proposer_id: torch.Tensor) -> torch.Tensor:
    """Pack (round, proposer_id) into an ordered int32 ballot."""
    return (rnd * MAX_PROPOSERS + proposer_id + 1).to(torch.int32)


def ballot_round(bal: torch.Tensor) -> torch.Tensor:
    """Round component of a packed ballot: ``(bal - 1) // MAX_PROPOSERS``,
    floored like ``jnp`` (NIL maps to round -1)."""
    return torch.div(bal - 1, MAX_PROPOSERS, rounding_mode="floor").to(
        torch.int32
    )
