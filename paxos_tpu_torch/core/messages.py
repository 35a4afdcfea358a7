"""Fixed-slot message buffers (counterpart of ``paxos_tpu/core/messages.py``).

Two buffer families, each with a kind axis of size 2, shape
``(2, n_prop, n_acc, n_inst)``:

- requests, proposer -> acceptor: kind 0 = PREPARE(bal), 1 = ACCEPT(bal, val)
- replies, acceptor -> proposer: kind 0 = PROMISE(bal, prev_bal, prev_val),
  1 = ACCEPTED(bal, val)

A slot is an overwriting channel; ``present`` marks occupied slots.  The
bounded-delay ``until`` leaf of the reference is not ported yet.
"""

from __future__ import annotations

import dataclasses

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

    @classmethod
    def empty(
        cls, n_inst: int, n_prop: int, n_acc: int, device="cpu"
    ) -> "MsgBuf":
        shape = (2, n_prop, n_acc, n_inst)
        return cls(
            bal=torch.zeros(shape, dtype=torch.int32, device=device),
            v1=torch.zeros(shape, dtype=torch.int32, device=device),
            v2=torch.zeros(shape, dtype=torch.int32, device=device),
            present=torch.zeros(shape, dtype=torch.bool, device=device),
        )

    def leaves(self) -> list:
        return [self.bal, self.v1, self.v2, self.present]
