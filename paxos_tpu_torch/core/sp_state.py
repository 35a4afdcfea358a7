"""SynchPaxos state (counterpart of ``paxos_tpu/core/sp_state.py``).

SynchPaxos bets on the bounded-delay synchrony window ``FaultConfig.delta``:
proposer 0, the leader, owns the round-0 ballot ``sync_ballot()`` and opens
in the FAST phase, sending ``Accept(sync_bal, own_val)`` at its first tick
and deciding on a majority of Accepted heard while its timer is inside the
window; past it, it falls back to classic rounds.  The followers open in P1
with nothing in flight and send their first PREPARE after ``timeout``.

The state reuses the classic role dataclasses and the :class:`MsgBuf` wire
format; only the init differs.  With ``delay=True`` (``p_delay > 0``) both
buffers carry ``until`` stamps, and with ``stale=True`` (``stale_k > 0``)
the acceptors their snapshot shadows, so the state has 30, 31 or 33
per-lane leaves instead of 28.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.core.ballot import make_ballot
from paxos_tpu_torch.core.messages import MsgBuf
from paxos_tpu_torch.core.state import (
    P1,
    AcceptorState,
    LaneState,
    LearnerState,
    ProposerState,
    check_topology,
)

# Proposer phases: P1, P2 and DONE of core.state (so summarize() is shared),
# plus the leader's round-0 window.
FAST = 3

# Value encoding: proposer p proposes VALUE_BASE + p (ProposerState.init).
VALUE_BASE = 100


def sync_ballot() -> int:
    """The leader-owned round-0 ballot of the fast path."""
    return int(make_ballot(torch.tensor(0), torch.tensor(0)))


@dataclasses.dataclass
class SynchPaxosState(LaneState):
    """Full simulator state for SynchPaxos."""

    protocol = "synchpaxos"
    takes_stamps = True
    takes_snapshots = True

    acceptor: AcceptorState
    proposer: ProposerState
    learner: LearnerState
    requests: MsgBuf  # proposer -> acceptor (PREPARE / ACCEPT)
    replies: MsgBuf  # acceptor -> proposer (PROMISE / ACCEPTED)
    tick: torch.Tensor  # () int32

    @classmethod
    def init(
        cls, n_inst: int, n_prop: int, n_acc: int, k: int = 8, device="cpu",
        delay: bool = False, stale: bool = False,
    ) -> "SynchPaxosState":
        check_topology(n_prop, n_acc)
        proposer = ProposerState.init(n_inst, n_prop, device)
        # The leader (proposer 0, whose ballot is already sync_ballot())
        # opens in FAST; its round-0 broadcast goes out through the faulty
        # network at its first tick, so nothing is in flight yet.
        proposer.phase[0] = FAST
        proposer.phase[1:] = P1
        return cls(
            acceptor=AcceptorState.init(n_inst, n_acc, device, stale),
            proposer=proposer,
            learner=LearnerState.init(n_inst, k, device),
            requests=MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay),
            replies=MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay),
            tick=torch.zeros((), dtype=torch.int32, device=device),
        )
