"""Fast Paxos state (counterpart of ``paxos_tpu/core/fp_state.py``).

Shares :class:`AcceptorState`, :class:`LearnerState` and the
:class:`MsgBuf` wire format with single-decree Paxos.  The proposer lane
carries ``rep_mask`` (P, V=P, I), the per-value acceptor bitmask at the
highest accepted ballot seen in recovery, in place of Paxos' single
``best_val``.  The fast round is round 0: every proposer shares the ballot
``make_ballot(0, 0)`` and its ``Accept(fast_bal, own_val)`` broadcast is in
flight at tick 0.  A state run with ``stale_k > 0`` carries the acceptors'
snapshot shadows, and one run with ``p_delay > 0`` its buffers' delay
stamps, as the reference's does; the observer planes a run turns on follow
the tick, as a Paxos state's (``core.state.OBSERVERS``).
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.core.ballot import make_ballot
from paxos_tpu_torch.core.messages import ACCEPT, MsgBuf
from paxos_tpu_torch.core.state import (
    AcceptorState,
    LaneState,
    LearnerState,
    check_topology,
)

# Proposer phases: P1, P2 and DONE of core.state (so summarize() is shared),
# plus the fast round.
FAST = 3  # fast round: Accept(fast_bal, own_val) sent, collecting accepted

# Value encoding: proposer p proposes VALUE_BASE + p.
VALUE_BASE = 100


@dataclasses.dataclass
class FastProposerState:
    bal: torch.Tensor  # (P, I) int32 current ballot (the fast ballot in FAST)
    phase: torch.Tensor  # (P, I) int32 in {P1, P2, DONE, FAST}
    own_val: torch.Tensor  # (P, I) int32 value this proposer wants
    prop_val: torch.Tensor  # (P, I) int32 value sent in classic phase 2
    heard: torch.Tensor  # (P, I) int32 acceptor bitmask for current phase
    best_bal: torch.Tensor  # (P, I) int32 highest prev-accepted ballot seen in P1
    rep_mask: torch.Tensor  # (P, V, I) int32 acceptors reporting value v at best_bal
    timer: torch.Tensor  # (P, I) int32 ticks since phase start (< 0: backoff)
    decided_val: torch.Tensor  # (P, I) int32 value this proposer saw decided

    @classmethod
    def init(cls, n_inst: int, n_prop: int, device="cpu") -> "FastProposerState":
        shape = (n_prop, n_inst)

        def z():
            return torch.zeros(shape, dtype=torch.int32, device=device)

        pid = (
            torch.arange(n_prop, dtype=torch.int32, device=device)[:, None]
            .expand(shape)
            .contiguous()
        )
        return cls(
            bal=make_ballot(torch.zeros_like(pid), torch.zeros_like(pid)),
            phase=torch.full(shape, FAST, dtype=torch.int32, device=device),
            own_val=pid + VALUE_BASE,
            prop_val=z(),
            heard=z(),
            best_bal=z(),
            rep_mask=torch.zeros((n_prop, n_prop, n_inst), dtype=torch.int32, device=device),
            timer=z(),
            decided_val=z(),
        )

    def leaves(self) -> list:
        return [
            self.bal, self.phase, self.own_val, self.prop_val, self.heard,
            self.best_bal, self.rep_mask, self.timer, self.decided_val,
        ]


@dataclasses.dataclass
class FastPaxosState(LaneState):
    """Full simulator state for Fast Paxos."""

    protocol = "fastpaxos"
    takes_stamps = True
    takes_snapshots = True
    takes_planes = True

    acceptor: AcceptorState
    proposer: FastProposerState
    learner: LearnerState
    requests: MsgBuf  # proposer -> acceptor (PREPARE / ACCEPT)
    replies: MsgBuf  # acceptor -> proposer (PROMISE / ACCEPTED)
    tick: torch.Tensor  # () int32
    # The observer planes (core.state.OBSERVERS), None when off.
    telemetry: "TelemetryState | None" = None
    coverage: "CoverageState | None" = None
    exposure: "FaultExposure | None" = None
    margin: "MarginState | None" = None
    wload: "WloadState | None" = None

    @classmethod
    def init(
        cls, n_inst: int, n_prop: int, n_acc: int, k: int = 8, device="cpu",
        stale: bool = False, delay: bool = False,
    ) -> "FastPaxosState":
        """The initial state; ``stale`` allocates the acceptors' snapshot
        shadows (``stale_k > 0``), ``delay`` both buffers' delay stamps
        (``p_delay > 0``; the fast round's ACCEPTs are deliverable at
        once)."""
        check_topology(n_prop, n_acc)
        proposer = FastProposerState.init(n_inst, n_prop, device)
        # The fast round is in flight at tick 0: every proposer's
        # Accept(fast_bal, own_val) broadcast occupies its ACCEPT slots.
        requests = MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay)
        requests.bal[ACCEPT] = proposer.bal[:, None, :]
        requests.v1[ACCEPT] = proposer.own_val[:, None, :]
        requests.present[ACCEPT] = True
        return cls(
            acceptor=AcceptorState.init(n_inst, n_acc, device, stale),
            proposer=proposer,
            learner=LearnerState.init(n_inst, k, device),
            requests=requests,
            replies=MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay),
            tick=torch.zeros((), dtype=torch.int32, device=device),
        )
