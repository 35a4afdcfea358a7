"""Fixed-slot message buffers (counterpart of ``paxos_tpu/core/messages.py``).

Two buffer families, each with a kind axis of size 2, shape
``(2, n_prop, n_acc, n_inst)``:

- requests, proposer -> acceptor: kind 0 = PREPARE(bal), 1 = ACCEPT(bal, val)
- replies, acceptor -> proposer: kind 0 = PROMISE(bal, prev_bal, prev_val),
  1 = ACCEPTED(bal, val)

A slot is an overwriting channel; ``present`` marks occupied slots.  The
optional ``until`` leaf is the bounded-delay stamp (``FaultConfig.p_delay``):
a slot is deliverable only once ``tick >= until``.  It is None when delay is
off, and then the buffer has the reference's four leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PREPARE = 0
ACCEPT = 1
PROMISE = 0
ACCEPTED = 1


@dataclasses.dataclass
class MsgBuf:
    bal: torch.Tensor  # (2, P, A, I) int32
    v1: torch.Tensor  # (2, P, A, I) int32
    v2: torch.Tensor  # (2, P, A, I) int32
    present: torch.Tensor  # (2, P, A, I) bool
    until: Optional[torch.Tensor] = None  # (2, P, A, I) int32 delay stamp

    @classmethod
    def empty(
        cls, n_inst: int, n_prop: int, n_acc: int, device="cpu", delay: bool = False
    ) -> "MsgBuf":
        shape = (2, n_prop, n_acc, n_inst)
        return cls(
            bal=torch.zeros(shape, dtype=torch.int32, device=device),
            v1=torch.zeros(shape, dtype=torch.int32, device=device),
            v2=torch.zeros(shape, dtype=torch.int32, device=device),
            present=torch.zeros(shape, dtype=torch.bool, device=device),
            until=torch.zeros(shape, dtype=torch.int32, device=device) if delay else None,
        )

    def leaves(self) -> list:
        """The reference's flatten order: ``until`` last, when present."""
        out = [self.bal, self.v1, self.v2, self.present]
        return out if self.until is None else out + [self.until]
