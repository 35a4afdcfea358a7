"""State and fault-plan exchange with the reference package, as numpy.

The reference's pytrees flatten to leaves in a fixed order (flax field
order, absent optional fields dropped); the port's ``leaves()`` use the same
order.  These functions take and return plain numpy arrays in that order,
so the port needs nothing of the reference to read what it wrote.  This is
how a sampled fault plan, or a state from a reference run, observer planes
included, carries across.
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
from paxos_tpu_torch.core.telemetry import TelemetryState
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan
from paxos_tpu_torch.obs.coverage import CoverageState
from paxos_tpu_torch.obs.exposure import FaultExposure
from paxos_tpu_torch.obs.margin import MarginState
from paxos_tpu_torch.workload.generator import WloadState

# Per protocol: the state type, its sub-states with their leaf counts in
# flatten order, and the trailing scalar and per-lane leaves (the tick, and
# Multi-Paxos' base).  Every message buffer (``_BUFFERS``: the two
# ``MsgBuf`` of a single-decree state, Multi-Paxos' requests, PROMISEs and
# ACCEPTEDs) carries one more leaf, its delay stamps, when the config
# delays sends; the acceptors of every protocol carry their snapshot
# shadows (one more leaf per durable field, ``SNAPSHOT``) when its config
# has stale_k > 0.  The observer planes a config turns on follow the tail
# (``_plane_groups``) on the state types that take them.
_BUFFERS = (MsgBuf, PromiseBuf, AcceptedBuf)
_SHARED = ((LearnerState, 8), (MsgBuf, 4), (MsgBuf, 4))
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


def state_from_numpy(leaves, device="cpu", protocol: str = "paxos", cfg=None) -> LaneState:
    """``protocol``'s state from the reference's flattened leaves, with or
    without delay stamps and snapshot shadows: a single-decree state (Paxos,
    Fast Paxos, Raft-core, SynchPaxos) of 29 leaves, 31 with stamps, 32 with
    shadows, 34 with both; a Multi-Paxos state of 30, 33 with stamps, 32
    with shadows, 35 with both.  The state's observer planes follow (a
    Multi-Paxos state's after ``base``): those the SimConfig ``cfg`` turns
    on (their leaf counts and sizes come from it)."""
    leaves = list(leaves)
    planes = {}
    if cfg is not None and cfg.planes_on():
        n_obs = sum(n for _, n, _ in _plane_groups(cfg))
        obs, leaves = leaves[len(leaves) - n_obs:], leaves[:len(leaves) - n_obs]
        k = 0
        for name, n, make in _plane_groups(cfg):
            planes[name] = make([_tensor(x, device) for x in obs[k:k + n]])
            k += n
    if protocol not in _GROUPS:
        raise NotImplementedError(f"protocol {protocol!r} is not ported yet")
    state_cls, groups, tail = _GROUPS[protocol]
    acc_cls, n_acc_leaves = groups[0]
    snaps = len(acc_cls.SNAPSHOT) if state_cls.takes_snapshots else 0
    stamps = sum(cls in _BUFFERS for cls, _ in groups)
    base = sum(n for _, n in groups) + len(tail)
    layouts = {base + s + t: (s, t) for s in {0, snaps} for t in {0, stamps}}
    if len(leaves) not in layouts:
        raise NotImplementedError(
            f"state has {len(leaves)} leaves; the port holds a {protocol} state of "
            f"{sorted(layouts)} (a state with observer planes needs cfg=)"
        )
    s, t = layouts[len(leaves)]
    groups = ((acc_cls, n_acc_leaves + s),) + tuple(
        (cls, n + (cls in _BUFFERS and t > 0)) for cls, n in groups[1:]
    )
    tensors = [_tensor(leaf, device) for leaf in leaves]
    parts, k = [], 0
    for cls, n in groups:
        parts.append(cls(*tensors[k : k + n]))
        k += n
    state = state_cls(*parts, **dict(zip(tail, tensors[k:])), **planes)
    state.check_layout()
    return state


def _plane_groups(cfg) -> list:
    """(field, leaf count, constructor from the leaves) of each observer
    plane ``cfg`` turns on, in flatten order."""
    out = []
    tel = cfg.telemetry
    if tel.enabled():
        ring, hist = tel.ring_depth > 0, tel.hist_bins > 0

        def make_tel(xs):
            it = iter(xs)
            counters = next(it)
            ring_leaves = (next(it), next(it), next(it)) if ring else (None, None, None)
            return TelemetryState(counters, *ring_leaves, next(it) if hist else None)

        out.append(("telemetry", 1 + 3 * ring + hist, make_tel))
    if cfg.coverage.enabled():
        out.append(("coverage", 2, lambda xs: CoverageState(*xs)))
    if cfg.exposure.enabled():
        out.append(("exposure", 2, lambda xs: FaultExposure(*xs)))
    if cfg.margin.enabled():
        out.append(("margin", 4, lambda xs: MarginState(*xs)))
    if cfg.workload.enabled():
        out.append(("wload", 10, lambda xs: WloadState(*xs, cfg=cfg.workload)))
    return out


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
