"""State and fault-plan exchange with the reference package, as numpy.

The reference's pytrees flatten to leaves in a fixed order (flax field
order, absent optional fields dropped); the port's ``leaves()`` use the same
order.  These functions take and return plain numpy arrays in that order,
so the port needs nothing of the reference to read what it wrote.  This is
how a sampled fault plan, or a state from a reference run, carries across.
"""

from __future__ import annotations

import numpy as np
import torch

from paxos_tpu_torch.core.fp_state import FastPaxosState, FastProposerState
from paxos_tpu_torch.core.messages import MsgBuf
from paxos_tpu_torch.core.mp_state import (
    AcceptedBuf,
    MPAcceptorState,
    MPLearnerState,
    MPProposerState,
    MultiPaxosState,
    PromiseBuf,
)
from paxos_tpu_torch.core.raft_state import CandidateState, RaftState, VoterState
from paxos_tpu_torch.core.sp_state import SynchPaxosState
from paxos_tpu_torch.core.state import (
    AcceptorState,
    LaneState,
    LearnerState,
    PaxosState,
    ProposerState,
)
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan

# Per protocol: the state type, its sub-states with their leaf counts in
# flatten order, and the trailing scalar and per-lane leaves (the tick, and
# Multi-Paxos' base).  SynchPaxos' buffers carry a fifth leaf, the delay
# stamps, when its config delays sends (``_STAMPED``); the acceptors of
# Paxos, Fast Paxos, Raft-core and Multi-Paxos carry their snapshot shadows
# (one more leaf per durable field, ``SNAPSHOT``) when its config has
# stale_k > 0.
_SHARED = ((LearnerState, 8), (MsgBuf, 4), (MsgBuf, 4))
_STAMPED = ((LearnerState, 8), (MsgBuf, 5), (MsgBuf, 5))
_GROUPS = {
    "paxos": (PaxosState, ((AcceptorState, 3), (ProposerState, 9)) + _SHARED, ("tick",)),
    "synchpaxos": (
        SynchPaxosState, ((AcceptorState, 3), (ProposerState, 9)) + _SHARED, ("tick",)
    ),
    "fastpaxos": (
        FastPaxosState, ((AcceptorState, 3), (FastProposerState, 9)) + _SHARED, ("tick",)
    ),
    "raftcore": (RaftState, ((VoterState, 3), (CandidateState, 9)) + _SHARED, ("tick",)),
    "multipaxos": (
        MultiPaxosState,
        (
            (MPAcceptorState, 2), (MPProposerState, 8), (MPLearnerState, 7),
            (MsgBuf, 4), (PromiseBuf, 3), (AcceptedBuf, 4),
        ),
        ("tick", "base"),
    ),
}


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype not in (np.int32, np.bool_):
        raise ValueError(f"state leaves are int32 or bool, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(device)


def state_from_numpy(leaves, device="cpu", protocol: str = "paxos") -> LaneState:
    """``protocol``'s state from the reference's flattened leaves (a
    SynchPaxos state with or without delay stamps: 31 or 29 leaves; a
    Paxos, Fast Paxos or Raft-core state with or without snapshot shadows:
    32 or 29; a Multi-Paxos state with or without them: 32 or 30)."""
    leaves = list(leaves)
    if protocol not in _GROUPS:
        raise NotImplementedError(f"protocol {protocol!r} is not ported yet")
    state_cls, groups, tail = _GROUPS[protocol]
    if protocol == "synchpaxos" and len(leaves) == 31:
        groups = groups[:2] + _STAMPED
    acc_cls, n_acc_leaves = groups[0]
    snaps = len(getattr(acc_cls, "SNAPSHOT", ()))
    if state_cls.takes_snapshots and len(leaves) == sum(n for _, n in groups) + len(tail) + snaps:
        groups = ((acc_cls, n_acc_leaves + snaps),) + groups[1:]
    want = sum(n for _, n in groups) + len(tail)
    if len(leaves) != want:
        raise NotImplementedError(
            f"state has {len(leaves)} leaves; the port holds the {want} of a "
            f"{protocol} state with every optional plane off (snapshot "
            "shadows on SynchPaxos, delay stamps outside SynchPaxos and "
            "observer planes: ROADMAP queue A slice 5)"
        )
    tensors = [_tensor(leaf, device) for leaf in leaves]
    parts, k = [], 0
    for cls, n in groups:
        parts.append(cls(*tensors[k : k + n]))
        k += n
    state = state_cls(*parts, **dict(zip(tail, tensors[k:])))
    state.check_layout()
    return state


def state_to_numpy(state: LaneState) -> list:
    """The state's leaves as numpy arrays, in the reference's order (for
    every protocol, Multi-Paxos included)."""
    return [leaf.detach().cpu().numpy() for leaf in state.leaves()]


def plan_from_numpy(leaves, device="cpu", cfg: "FaultConfig | None" = None) -> FaultPlan:
    """A :class:`FaultPlan` from the reference's flattened plan leaves
    (crash windows, equivocators, proposer crash windows, partitions, and
    the optional fields of a plan sampled for ``cfg``: the cut direction,
    the per-link loss and duplication thresholds, the timer skew and the
    per-link latency caps).  The reference's optional fields are told apart
    by the knobs of ``cfg`` that gate them, not by the leaf count."""
    return FaultPlan.from_numpy(leaves, device, cfg)
