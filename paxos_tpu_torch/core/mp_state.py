"""Multi-Paxos log-replication state (counterpart of
``paxos_tpu/core/mp_state.py``).

Every array is instance-minor.  The log is a fixed window of ``L`` slots
per instance: the acceptor log ``(A, L, I)``, the proposers' recovery
arrays ``(P, L, I)``, the PROMISE payloads ``(P, A, L, I)`` and the
learner's per-slot tables ``(L, K, I)``.  Every slot-indexed (ballot,
value) pair rides in one int32, ``bal << 16 | val`` (:func:`pack_bv`), so
integer order is (ballot, value) order and 0 is the NIL pair.

``leaves()`` follows the reference's flatten order (acceptor, proposer,
learner, requests, promises, accepted, tick, base), so a sha256 over the
leaf bytes equals the reference's state digest.  A state run with
``stale_k > 0`` carries the acceptors' snapshot shadows of ``promised``
and the slot log, and one run with ``p_delay > 0`` the delay stamps of its
three buffers (``until``), as the reference's does; the observer planes
are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.core.messages import MsgBuf
from paxos_tpu_torch.core.state import LaneState, check_leaves, check_topology, init_layout

# Proposer phases
FOLLOW = 0  # passive: watching progress, lease ticking
CANDIDATE = 1  # phase 1 outstanding
LEAD = 2  # distinguished leader, driving slots

BV_SHIFT = 16
BV_VAL_MASK = (1 << BV_SHIFT) - 1


def pack_bv(bal, val):
    """One int32 per (ballot, value) pair; 0 stays the NIL sentinel."""
    return (bal << BV_SHIFT) | val


def bv_bal(bv):
    return bv >> BV_SHIFT


def bv_val(bv):
    return bv & BV_VAL_MASK


def _zeros(shape, device, dtype=torch.int32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass
class MPAcceptorState:
    promised: torch.Tensor  # (A, I) int32: one promise covers every slot
    log: torch.Tensor  # (A, L, I) int32 packed accepted (ballot, value) per slot
    # Stale-snapshot shadows (FaultConfig.stale_k); None unless the knob is on.
    snap_promised: "torch.Tensor | None" = None  # (A, I) int32
    snap_log: "torch.Tensor | None" = None  # (A, L, I) int32

    # (durable field, its snapshot shadow) pairs (protocols.paxos.recover).
    SNAPSHOT = (("promised", "snap_promised"), ("log", "snap_log"))

    @classmethod
    def init(
        cls, n_inst: int, n_acc: int, log_len: int, device="cpu", stale: bool = False
    ) -> "MPAcceptorState":
        shapes = ((n_acc, n_inst), (n_acc, log_len, n_inst))
        return cls(*(_zeros(shape, device) for shape in shapes * (2 if stale else 1)))

    def leaves(self) -> list:
        snaps = [self.snap_promised, self.snap_log]
        return [self.promised, self.log] + [x for x in snaps if x is not None]


@dataclasses.dataclass
class MPProposerState:
    bal: torch.Tensor  # (P, I) int32 current ballot
    phase: torch.Tensor  # (P, I) int32 in {FOLLOW, CANDIDATE, LEAD}
    heard: torch.Tensor  # (P, I) int32 acceptor bitmask (phase 1 or current slot)
    commit_idx: torch.Tensor  # (P, I) int32 next slot this leader drives
    recov_bv: torch.Tensor  # (P, L, I) int32 packed highest accepted pair per slot
    lease_timer: torch.Tensor  # (P, I) int32 ticks since observed progress
    last_chosen_count: torch.Tensor  # (P, I) int32 chosen slots last observed
    candidate_timer: torch.Tensor  # (P, I) int32 ticks spent as candidate

    @classmethod
    def init(
        cls, n_inst: int, n_prop: int, log_len: int, lease_init: int = 0, device="cpu"
    ) -> "MPProposerState":
        shape = (n_prop, n_inst)
        return cls(
            bal=_zeros(shape, device),  # NIL until the first election
            phase=_zeros(shape, device),  # FOLLOW
            heard=_zeros(shape, device),
            commit_idx=_zeros(shape, device),
            recov_bv=_zeros((n_prop, log_len, n_inst), device),
            # Head start: the first election does not wait a full lease.
            lease_timer=torch.full(shape, lease_init, dtype=torch.int32, device=device),
            last_chosen_count=_zeros(shape, device),
            candidate_timer=_zeros(shape, device),
        )

    def leaves(self) -> list:
        return [
            self.bal, self.phase, self.heard, self.commit_idx, self.recov_bv,
            self.lease_timer, self.last_chosen_count, self.candidate_timer,
        ]


@dataclasses.dataclass
class MPLearnerState:
    """Per-(instance, slot) chosen tracking and agreement checking: K rows
    of packed (ballot, value) -> voter bitmask per slot."""

    lt_bv: torch.Tensor  # (L, K, I) int32 packed (ballot, value) per row
    lt_mask: torch.Tensor  # (L, K, I) int32
    chosen: torch.Tensor  # (L, I) bool
    chosen_val: torch.Tensor  # (L, I) int32
    chosen_tick: torch.Tensor  # (L, I) int32 (-1 if not chosen)
    violations: torch.Tensor  # (I,) int32
    evictions: torch.Tensor  # (I,) int32

    @classmethod
    def init(cls, n_inst: int, log_len: int, k: int = 4, device="cpu") -> "MPLearnerState":
        return cls(
            lt_bv=_zeros((log_len, k, n_inst), device),
            lt_mask=_zeros((log_len, k, n_inst), device),
            chosen=_zeros((log_len, n_inst), device, torch.bool),
            chosen_val=_zeros((log_len, n_inst), device),
            chosen_tick=torch.full((log_len, n_inst), -1, dtype=torch.int32, device=device),
            violations=_zeros((n_inst,), device),
            evictions=_zeros((n_inst,), device),
        )

    def leaves(self) -> list:
        return [
            self.lt_bv, self.lt_mask, self.chosen, self.chosen_val,
            self.chosen_tick, self.violations, self.evictions,
        ]


@dataclasses.dataclass
class PromiseBuf:
    """PROMISE replies with the full-log recovery payload, one slot per
    (proposer, acceptor) edge."""

    present: torch.Tensor  # (P, A, I) bool
    bal: torch.Tensor  # (P, A, I) int32: the promised ballot
    p_bv: torch.Tensor  # (P, A, L, I) int32 packed accepted pair per slot
    # Bounded-delay stamp (p_delay): the first tick the slot may be
    # delivered, 0 = at once; None when delay is off (MsgBuf.until).
    until: "torch.Tensor | None" = None  # (P, A, I) int32

    @classmethod
    def empty(
        cls, n_inst: int, n_prop: int, n_acc: int, log_len: int, device="cpu",
        delay: bool = False,
    ) -> "PromiseBuf":
        edge = (n_prop, n_acc, n_inst)
        return cls(
            present=_zeros(edge, device, torch.bool),
            bal=_zeros(edge, device),
            p_bv=_zeros((n_prop, n_acc, log_len, n_inst), device),
            until=_zeros(edge, device) if delay else None,
        )

    def leaves(self) -> list:
        out = [self.present, self.bal, self.p_bv]
        return out if self.until is None else out + [self.until]


@dataclasses.dataclass
class AcceptedBuf:
    """ACCEPTED replies: (ballot, slot, value) per (proposer, acceptor) edge."""

    present: torch.Tensor  # (P, A, I) bool
    bal: torch.Tensor  # (P, A, I) int32
    slot: torch.Tensor  # (P, A, I) int32
    val: torch.Tensor  # (P, A, I) int32
    until: "torch.Tensor | None" = None  # (P, A, I) int32 delay stamp (p_delay)

    @classmethod
    def empty(
        cls, n_inst: int, n_prop: int, n_acc: int, device="cpu", delay: bool = False
    ) -> "AcceptedBuf":
        edge = (n_prop, n_acc, n_inst)
        return cls(
            present=_zeros(edge, device, torch.bool),
            bal=_zeros(edge, device),
            slot=_zeros(edge, device),
            val=_zeros(edge, device),
            until=_zeros(edge, device) if delay else None,
        )

    def leaves(self) -> list:
        out = [self.present, self.bal, self.slot, self.val]
        return out if self.until is None else out + [self.until]


@dataclasses.dataclass
class MultiPaxosState(LaneState):
    """Full Multi-Paxos simulator state."""

    protocol = "multipaxos"
    takes_stamps = True
    takes_snapshots = True

    acceptor: MPAcceptorState
    proposer: MPProposerState
    learner: MPLearnerState
    requests: MsgBuf  # p -> a: kind 0 PREPARE(bal), kind 1 ACCEPT(bal, val, slot)
    promises: PromiseBuf  # a -> p
    accepted: AcceptedBuf  # a -> p
    tick: torch.Tensor  # () int32
    # (I,) int32: global log index of window slot 0, the count of decided
    # slots compacted out so far (0 unless the log is long).
    base: torch.Tensor

    @classmethod
    def init(
        cls, n_inst: int, n_prop: int, n_acc: int, log_len: int = 8, k: int = 4,
        lease_init: int = 0, device="cpu", stale: bool = False, delay: bool = False,
    ) -> "MultiPaxosState":
        """The initial state; ``stale`` allocates the acceptors' snapshot
        shadows (``stale_k > 0``), ``delay`` the three buffers' delay stamps
        (``p_delay > 0``)."""
        check_topology(n_prop, n_acc)
        return cls(
            acceptor=MPAcceptorState.init(n_inst, n_acc, log_len, device, stale),
            proposer=MPProposerState.init(n_inst, n_prop, log_len, lease_init, device),
            learner=MPLearnerState.init(n_inst, log_len, k, device),
            requests=MsgBuf.empty(n_inst, n_prop, n_acc, device, delay=delay),
            promises=PromiseBuf.empty(n_inst, n_prop, n_acc, log_len, device, delay=delay),
            accepted=AcceptedBuf.empty(n_inst, n_prop, n_acc, device, delay=delay),
            tick=torch.zeros((), dtype=torch.int32, device=device),
            base=_zeros((n_inst,), device),
        )

    def leaves(self) -> list:
        """Tensors in the reference's flatten order (tick before base)."""
        return (
            self.acceptor.leaves()
            + self.proposer.leaves()
            + self.learner.leaves()
            + self.requests.leaves()
            + self.promises.leaves()
            + self.accepted.leaves()
            + [self.tick, self.base]
        )

    def protocol_leaves(self) -> list:
        """Every per-instance tensor (all but the tick), in flatten order."""
        leaves = self.leaves()
        return leaves[:-2] + leaves[-1:]

    def check_layout(self) -> None:
        """Raise unless every leaf has the shape and dtype ``init`` gives
        for this state's (n_inst, n_prop, n_acc, log_len, k_slots), with
        delay stamps where the request buffer carries them and snapshot
        shadows where the acceptors carry them."""
        kw = {"stale": True} if self.snapshots else {}
        if self.stamped:
            kw["delay"] = True
        check_leaves(
            self.leaves(),
            init_layout(
                type(self), self.n_inst, self.n_prop, self.n_acc, self.log_len, self.k_slots,
                **kw,
            ),
        )

    @property
    def log_len(self) -> int:
        return self.acceptor.log.shape[1]

    @property
    def k_slots(self) -> int:
        return self.learner.lt_bv.shape[1]
