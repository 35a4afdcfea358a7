"""Struct-of-arrays role state (counterpart of ``paxos_tpu/core/state.py``).

Every array is instance-minor: acceptors ``(A, I)``, proposers ``(P, I)``,
learner tables ``(K, I)``, message slots ``(2, P, A, I)``.  Everything is
int32 or bool; NIL ballots and values are 0.

``leaves()`` returns the tensors in the reference's flatten order (flax
field order, absent optional fields dropped), so a sha256 over the leaf
bytes equals the reference's state digest.  A Paxos, Fast Paxos,
Raft-core or SynchPaxos state run with ``stale_k > 0`` carries the
acceptors' snapshot shadows, and one run with ``p_delay > 0`` its buffers'
delay stamps, as the reference's does.  Every protocol's state carries
the observer planes a run turns on (``OBSERVERS``: telemetry, coverage,
exposure, margin, the client workload), each None when off, after the
tick (a Multi-Paxos state's after its ``base``) in flatten order.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch

from paxos_tpu_torch.core.ballot import MAX_PROPOSERS, make_ballot
from paxos_tpu_torch.core.messages import PREPARE, MsgBuf

# Proposer phases
P1 = 0  # prepare sent, collecting promises
P2 = 1  # accept sent, collecting accepted
DONE = 2  # proposer observed a quorum of Accepted for its ballot

MAX_ACCEPTORS = 16  # voter-bitmask capacity


def _zeros(shape, device, dtype=torch.int32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass
class AcceptorState:
    promised: torch.Tensor  # (A, I) int32 highest ballot promised
    acc_bal: torch.Tensor  # (A, I) int32 ballot of last accepted proposal
    acc_val: torch.Tensor  # (A, I) int32 value of last accepted proposal
    # Stale-snapshot shadows (FaultConfig.stale_k): the durable image a
    # recovering acceptor rolls back to; None unless the knob is on.
    snap_promised: "torch.Tensor | None" = None  # (A, I) int32
    snap_bal: "torch.Tensor | None" = None  # (A, I) int32
    snap_val: "torch.Tensor | None" = None  # (A, I) int32

    # (durable field, its snapshot shadow) pairs: what stale recovery
    # restores and refreshes (protocols.paxos.recover).
    SNAPSHOT = (("promised", "snap_promised"), ("acc_bal", "snap_bal"), ("acc_val", "snap_val"))

    @classmethod
    def init(cls, n_inst: int, n_acc: int, device="cpu", stale: bool = False) -> "AcceptorState":
        shape = (n_acc, n_inst)
        return cls(*(_zeros(shape, device) for _ in range(6 if stale else 3)))

    def leaves(self) -> list:
        snaps = [self.snap_promised, self.snap_bal, self.snap_val]
        return [self.promised, self.acc_bal, self.acc_val] + [x for x in snaps if x is not None]


@dataclasses.dataclass
class ProposerState:
    bal: torch.Tensor  # (P, I) int32 current ballot
    phase: torch.Tensor  # (P, I) int32 in {P1, P2, DONE}
    own_val: torch.Tensor  # (P, I) int32 value this proposer wants
    prop_val: torch.Tensor  # (P, I) int32 value sent in phase 2
    heard: torch.Tensor  # (P, I) int32 acceptor bitmask for current phase
    best_bal: torch.Tensor  # (P, I) int32 highest prev-accepted ballot seen
    best_val: torch.Tensor  # (P, I) int32 its value
    timer: torch.Tensor  # (P, I) int32 ticks in phase (< 0: backoff)
    decided_val: torch.Tensor  # (P, I) int32 value this proposer saw decided

    @classmethod
    def init(cls, n_inst: int, n_prop: int, device="cpu") -> "ProposerState":
        shape = (n_prop, n_inst)
        pid = (
            torch.arange(n_prop, dtype=torch.int32, device=device)[:, None]
            .expand(shape)
            .contiguous()
        )
        return cls(
            bal=make_ballot(torch.zeros_like(pid), pid),  # round 0
            phase=_zeros(shape, device),  # P1
            own_val=pid + 100,  # distinct per proposer so duels are observable
            prop_val=_zeros(shape, device),
            heard=_zeros(shape, device),
            best_bal=_zeros(shape, device),
            best_val=_zeros(shape, device),
            timer=_zeros(shape, device),
            decided_val=_zeros(shape, device),
        )

    def leaves(self) -> list:
        return [
            self.bal, self.phase, self.own_val, self.prop_val, self.heard,
            self.best_bal, self.best_val, self.timer, self.decided_val,
        ]


@dataclasses.dataclass
class LearnerState:
    """Bounded per-instance table of (ballot, value) -> acceptor bitmask."""

    lt_bal: torch.Tensor  # (K, I) int32
    lt_val: torch.Tensor  # (K, I) int32
    lt_mask: torch.Tensor  # (K, I) int32 acceptor bitmask
    chosen: torch.Tensor  # (I,) bool
    chosen_val: torch.Tensor  # (I,) int32 first chosen value
    chosen_tick: torch.Tensor  # (I,) int32 tick of first choice (-1 if none)
    violations: torch.Tensor  # (I,) int32 safety violations observed
    evictions: torch.Tensor  # (I,) int32 table evictions

    @classmethod
    def init(cls, n_inst: int, k: int = 8, device="cpu") -> "LearnerState":
        return cls(
            lt_bal=_zeros((k, n_inst), device),
            lt_val=_zeros((k, n_inst), device),
            lt_mask=_zeros((k, n_inst), device),
            chosen=_zeros((n_inst,), device, torch.bool),
            chosen_val=_zeros((n_inst,), device),
            chosen_tick=torch.full(
                (n_inst,), -1, dtype=torch.int32, device=device
            ),
            violations=_zeros((n_inst,), device),
            evictions=_zeros((n_inst,), device),
        )

    def leaves(self) -> list:
        return [
            self.lt_bal, self.lt_val, self.lt_mask, self.chosen,
            self.chosen_val, self.chosen_tick, self.violations,
            self.evictions,
        ]


def check_topology(n_prop: int, n_acc: int) -> None:
    """Raise unless the topology fits the ballot and voter-mask packing."""
    if not 1 <= n_prop <= MAX_PROPOSERS:
        raise ValueError(
            f"n_prop={n_prop} exceeds ballot packing capacity {MAX_PROPOSERS}"
        )
    if not 1 <= n_acc <= MAX_ACCEPTORS:
        raise ValueError(
            f"n_acc={n_acc} exceeds voter bitmask capacity {MAX_ACCEPTORS}"
        )


@functools.lru_cache(maxsize=64)
def init_layout(cls, *args, **kw) -> tuple:
    """(shape, dtype) of every leaf ``cls.init(*args, **kw)`` gives, built
    once per argument list on the meta device, so that checking a state
    against it (a fused kernel's wrapper does before every launch) runs no
    tensor op."""
    return tuple((x.shape, x.dtype) for x in cls.init(*args, device="meta", **kw).leaves())


def check_leaves(leaves: list, want: tuple) -> None:
    """Raise unless ``leaves`` match the (shape, dtype) list ``want``."""
    if len(leaves) != len(want):
        raise ValueError(f"state has {len(leaves)} leaves, expected {len(want)}")
    for i, (leaf, (shape, dtype)) in enumerate(zip(leaves, want)):
        if leaf.shape != shape or leaf.dtype != dtype:
            raise ValueError(
                f"state leaf {i}: {tuple(leaf.shape)} {leaf.dtype}, "
                f"expected {tuple(shape)} {dtype}"
            )


# The observer planes, in the reference's field (flatten) order after the
# tick; a state type that carries them has these fields, None when off.
OBSERVERS = ("telemetry", "coverage", "exposure", "margin", "wload")


class LaneState:
    """What every protocol's full state shares: the five sub-states
    ``acceptor``, ``proposer``, ``learner``, ``requests``, ``replies`` and
    the ``tick`` scalar, flattened in that order, then the observer planes
    that are on (``OBSERVERS``, fields of every state type).  ``protocol``
    names the tick that advances it; ``takes_stamps`` says whether its ``init``
    allocates delay stamps (``delay=True``), ``takes_snapshots`` whether
    it allocates the acceptors' snapshot shadows (``stale=True``)."""

    protocol = ""
    takes_stamps = False
    takes_snapshots = False

    def protocol_leaves(self) -> list:
        """The protocol's per-instance tensors (tick and observers
        excluded), in flatten order: the leaves a fused kernel's state
        argument holds."""
        return (
            self.acceptor.leaves()
            + self.proposer.leaves()
            + self.learner.leaves()
            + self.requests.leaves()
            + self.replies.leaves()
        )

    def obs_leaves(self) -> list:
        """The observer planes' tensors, in flatten order ([] when none is on)."""
        out = []
        for name in OBSERVERS:
            plane = getattr(self, name, None)
            if plane is not None:
                out += plane.leaves()
        return out

    @property
    def planes(self) -> tuple:
        """The names of the observer planes the state carries."""
        return tuple(n for n in OBSERVERS if getattr(self, n, None) is not None)

    def leaves(self) -> list:
        """Tensors in the reference's flatten order (the tick after the
        protocol's leaves, the observers after it)."""
        return self.protocol_leaves() + [self.tick] + self.obs_leaves()

    def lane_leaves(self) -> list:
        """Every per-instance tensor (all but the tick), in flatten order."""
        return self.protocol_leaves() + self.obs_leaves()

    def check_layout(self) -> None:
        """Raise unless every protocol leaf has the shape and dtype ``init``
        gives for this state's (n_inst, n_prop, n_acc, k_slots), with delay
        stamps where the request buffer carries them and snapshot shadows
        where the acceptors carry them, and every observer leaf the shape
        its plane's sizes give (:func:`check_planes`)."""
        kw = {"delay": True} if self.requests.until is not None else {}
        if kw and not self.takes_stamps:
            raise ValueError(
                f"a {type(self).__name__} carries no delay stamps (MsgBuf.until)"
            )
        if self.snapshots:
            if not self.takes_snapshots:
                raise ValueError(f"a {type(self).__name__} carries no snapshot shadows")
            kw["stale"] = True
        check_leaves(
            self.protocol_leaves() + [self.tick],
            init_layout(type(self), self.n_inst, self.n_prop, self.n_acc, self.k_slots, **kw),
        )
        check_planes(self)

    def clone(self):
        """A deep copy on the same device (the fused kernels update the
        state they are given in place)."""
        return copy.deepcopy(self)

    @property
    def n_inst(self) -> int:
        return self.acceptor.leaves()[0].shape[1]

    @property
    def n_acc(self) -> int:
        return self.acceptor.leaves()[0].shape[0]

    @property
    def n_prop(self) -> int:
        return self.proposer.bal.shape[0]

    @property
    def k_slots(self) -> int:
        return self.learner.lt_bal.shape[0]

    @property
    def device(self) -> torch.device:
        return self.proposer.bal.device

    @property
    def stamped(self) -> int:
        """1 when the message buffers carry delay stamps (``until``), else 0."""
        return int(self.requests.until is not None)

    @property
    def snapshots(self) -> bool:
        """Whether the acceptors carry snapshot shadows (``stale_k > 0``)."""
        pairs = getattr(self.acceptor, "SNAPSHOT", ())
        return bool(pairs) and getattr(self.acceptor, pairs[0][1]) is not None


@dataclasses.dataclass
class PaxosState(LaneState):
    """Full simulator state for single-decree Paxos."""

    protocol = "paxos"
    takes_stamps = True
    takes_snapshots = True

    acceptor: AcceptorState
    proposer: ProposerState
    learner: LearnerState
    requests: MsgBuf  # proposer -> acceptor (PREPARE / ACCEPT)
    replies: MsgBuf  # acceptor -> proposer (PROMISE / ACCEPTED)
    tick: torch.Tensor  # () int32 global tick counter
    # The observer planes (OBSERVERS), None when off.
    telemetry: "TelemetryState | None" = None
    coverage: "CoverageState | None" = None
    exposure: "FaultExposure | None" = None
    margin: "MarginState | None" = None
    wload: "WloadState | None" = None

    @classmethod
    def init(
        cls, n_inst: int, n_prop: int, n_acc: int, k: int = 8, device="cpu",
        stale: bool = False, delay: bool = False,
    ) -> "PaxosState":
        """The initial state; ``stale`` allocates the acceptors' snapshot
        shadows (``stale_k > 0``), ``delay`` both buffers' delay stamps
        (``p_delay > 0``; the opening PREPAREs are deliverable at once)."""
        check_topology(n_prop, n_acc)
        proposer = ProposerState.init(n_inst, n_prop, device)
        # Every proposer opens with a phase-1 broadcast: PREPARE(bal) to all
        # acceptors is in flight at tick 0.
        requests = MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay)
        requests.bal[PREPARE] = proposer.bal[:, None, :]
        requests.present[PREPARE] = True
        return cls(
            acceptor=AcceptorState.init(n_inst, n_acc, device, stale),
            proposer=proposer,
            learner=LearnerState.init(n_inst, k, device),
            requests=requests,
            replies=MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay),
            tick=torch.zeros((), dtype=torch.int32, device=device),
        )


def plane_layout(state: LaneState) -> list:
    """(shape, dtype) of every observer leaf of ``state``, from the sizes
    its planes were made with (ring depth, histogram bins, coverage words,
    the workload's queue and bins)."""
    n, p = state.n_inst, state.n_prop
    i32 = torch.int32
    want = []
    tel = getattr(state, "telemetry", None)
    if tel is not None:
        from paxos_tpu_torch.core.telemetry import N_EVENTS

        want.append(((N_EVENTS, n), i32))
        if tel.ring is not None:
            want += [((tel.ring.shape[0], n), i32), ((n,), i32), ((n,), i32)]
        if tel.hist is not None:
            want.append(((tel.hist.shape[0], n), i32))
    cov = getattr(state, "coverage", None)
    if cov is not None:
        words = cov.bitmap.shape[0]
        if words < 1 or words & (words - 1):
            raise ValueError(f"coverage bitmap of {words} words: a power of two is needed")
        want += [((words, n), i32), ((n,), i32)]
    if getattr(state, "exposure", None) is not None:
        from paxos_tpu_torch.obs.exposure import CLASSES

        want += [((len(CLASSES), n), i32)] * 2
    if getattr(state, "margin", None) is not None:
        want += [((n,), i32)] * 4
    wl = getattr(state, "wload", None)
    if wl is not None:
        from paxos_tpu_torch.workload.generator import CLASSES as WCLASSES

        cfg = wl.cfg
        want += [((p, n), i32)] * 2 + [((cfg.queue_cap, p, n), i32)] + [((p, n), i32)] * 6
        want.append(((len(WCLASSES) * cfg.hist_bins, n), i32))
    return [(torch.Size(s), d) for s, d in want]


def check_planes(state: LaneState) -> None:
    """Raise unless the observer leaves have their planes' shapes, int32."""
    leaves = state.obs_leaves()
    if leaves:
        check_leaves(leaves, plane_layout(state))


# Bytes of state each instance carries (bool leaves 1 byte, tick excluded):
# the figure the fused kernel's memory bound is computed from.
def state_bytes_per_lane(state: LaneState) -> int:
    return sum(
        leaf.element_size() * (leaf.numel() // state.n_inst)
        for leaf in state.lane_leaves()
    )
