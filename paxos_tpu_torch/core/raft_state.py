"""Raft-core state (counterpart of ``paxos_tpu/core/raft_state.py``).

Voters with single-slot logs and candidates with terms, over the same
(instances, proposers, acceptors) topology as Paxos: proposer lanes are
candidates/leaders, acceptor lanes are voters that also store the
replicated entry.  Terms are packed ballots, so "one vote per term" is
"grant only terms strictly above the last granted one", and the election
restriction is an integer compare.  A state run with ``stale_k > 0``
carries the voters' snapshot shadows, and one run with ``p_delay > 0`` its
buffers' delay stamps, as the reference's does; the observer planes a run
turns on follow the tick, as a Paxos state's (``core.state.OBSERVERS``).
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.core.ballot import make_ballot
from paxos_tpu_torch.core.messages import MsgBuf
from paxos_tpu_torch.core.state import LaneState, LearnerState, check_topology

# Candidate phases (values match core.state.P1/P2/DONE so summarize() is
# shared across protocols).
CAND = 0  # soliciting votes (RequestVote broadcast out)
LEAD = 1  # elected; appending the entry (AppendEntries broadcast out)
DONE = 2  # observed a majority of acks: entry committed

# Request kinds (candidate -> voter)
REQVOTE = 0  # bal=candidate term, v1=candidate's entry term (0 = empty log)
APPEND = 1  # bal=leader term, v1=entry value
# Reply kinds (voter -> candidate)
VOTE = 0  # bal=requested term, v1=2 * payload_term + granted, v2=entry value
ACK = 1  # bal=leader term, v1=entry value

VALUE_BASE = 100  # candidate p proposes VALUE_BASE + p when its log is empty


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device)


@dataclasses.dataclass
class VoterState:
    """(A, I) per-voter durable state; ``voted`` is the highest term the
    voter granted a vote to or accepted an append from (the vote fence)."""

    voted: torch.Tensor  # (A, I) int32 packed term; 0 = none yet
    ent_term: torch.Tensor  # (A, I) int32 term of the stored entry; 0 = empty
    ent_val: torch.Tensor  # (A, I) int32 stored entry value
    # Stale-snapshot shadows (FaultConfig.stale_k); None unless the knob is on.
    snap_voted: "torch.Tensor | None" = None  # (A, I) int32
    snap_term: "torch.Tensor | None" = None  # (A, I) int32
    snap_val: "torch.Tensor | None" = None  # (A, I) int32

    # (durable field, its snapshot shadow) pairs (protocols.paxos.recover).
    SNAPSHOT = (("voted", "snap_voted"), ("ent_term", "snap_term"), ("ent_val", "snap_val"))

    @classmethod
    def init(cls, n_inst: int, n_acc: int, device="cpu", stale: bool = False) -> "VoterState":
        return cls(*(_zeros((n_acc, n_inst), device) for _ in range(6 if stale else 3)))

    def leaves(self) -> list:
        snaps = [self.snap_voted, self.snap_term, self.snap_val]
        return [self.voted, self.ent_term, self.ent_val] + [x for x in snaps if x is not None]


@dataclasses.dataclass
class CandidateState:
    bal: torch.Tensor  # (P, I) int32 current term (packed ballot)
    phase: torch.Tensor  # (P, I) int32 in {CAND, LEAD, DONE}
    own_val: torch.Tensor  # (P, I) int32 value proposed if the log is empty
    prop_val: torch.Tensor  # (P, I) int32 value being appended while LEAD
    heard: torch.Tensor  # (P, I) int32 voter bitmask (grants in CAND, acks in LEAD)
    ent_term: torch.Tensor  # (P, I) int32 candidate's own log entry term
    ent_val: torch.Tensor  # (P, I) int32 candidate's own log entry value
    timer: torch.Tensor  # (P, I) int32 ticks since phase start (< 0: backoff)
    decided_val: torch.Tensor  # (P, I) int32 value this candidate saw committed

    @classmethod
    def init(cls, n_inst: int, n_prop: int, device="cpu") -> "CandidateState":
        shape = (n_prop, n_inst)
        pid = (
            torch.arange(n_prop, dtype=torch.int32, device=device)[:, None]
            .expand(shape)
            .contiguous()
        )
        return cls(
            bal=make_ballot(torch.zeros_like(pid), pid),
            phase=_zeros(shape, device),  # CAND
            own_val=pid + VALUE_BASE,
            prop_val=_zeros(shape, device),
            heard=_zeros(shape, device),
            ent_term=_zeros(shape, device),
            ent_val=_zeros(shape, device),
            timer=_zeros(shape, device),
            decided_val=_zeros(shape, device),
        )

    def leaves(self) -> list:
        return [
            self.bal, self.phase, self.own_val, self.prop_val, self.heard,
            self.ent_term, self.ent_val, self.timer, self.decided_val,
        ]


@dataclasses.dataclass
class RaftState(LaneState):
    """Full simulator state for Raft-core."""

    protocol = "raftcore"
    takes_stamps = True
    takes_snapshots = True

    acceptor: VoterState  # named `acceptor` so summaries are uniform
    proposer: CandidateState  # likewise
    learner: LearnerState
    requests: MsgBuf  # candidate -> voter (REQVOTE / APPEND)
    replies: MsgBuf  # voter -> candidate (VOTE / ACK)
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
    ) -> "RaftState":
        """The initial state; ``stale`` allocates the voters' snapshot
        shadows (``stale_k > 0``), ``delay`` both buffers' delay stamps
        (``p_delay > 0``; the opening REQVOTEs are deliverable at once)."""
        check_topology(n_prop, n_acc)
        proposer = CandidateState.init(n_inst, n_prop, device)
        # Every candidate opens with a RequestVote broadcast in flight.
        requests = MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay)
        requests.bal[REQVOTE] = proposer.bal[:, None, :]
        requests.present[REQVOTE] = True
        return cls(
            acceptor=VoterState.init(n_inst, n_acc, device, stale),
            proposer=proposer,
            learner=LearnerState.init(n_inst, k, device),
            requests=requests,
            replies=MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay),
            tick=torch.zeros((), dtype=torch.int32, device=device),
        )
