"""Single-decree Paxos tick (counterpart of ``paxos_tpu/protocols/paxos.py``).

One tick = deliver (masked selects) -> role transitions -> emit (masked
writes), batched over every instance.  :func:`counter_masks` draws a tick's
randomness from the counter PRNG; :func:`apply_tick` is the pure transition
over those masks.  Both are plain PyTorch: the plain version of the fused
CUDA kernel (``kernels/fused_tick``) replays them tick by tick.

Ported knobs: ``p_drop``, ``p_dup``, ``p_idle``, ``p_hold``, ``timeout``,
``backoff_max``, ``ballot_stride``, ``q1``, ``q2``, and the plan's crash
windows and equivocation flags; for every tick also the gray-failure and
partition arms (``p_part`` with ``p_asym``, ``p_flaky``, ``p_corrupt``,
``timeout_skew``, ``backoff_skew``, ``stale_k``, ``amnesia``), whose
pieces the ticks share (:func:`recover`, :func:`partition_cuts`,
:func:`gray_links`, :func:`deliver`, :func:`select`, :func:`corrupt`,
:func:`skewed_timers`; Multi-Paxos, whose buffers differ, takes the first
two and the last two); for every tick the bounded delay (``p_delay``,
``delay_max``: :func:`delay_stamps` on the sends, the readiness gates in
:func:`deliver` and :func:`select`; Multi-Paxos takes :func:`send_stamps`
over its own buffers), for SynchPaxos ``sp_unsafe_fast``.  Any other knob raises
``NotImplementedError`` naming its ROADMAP item.

The Paxos tick computes the observer planes its state carries (telemetry,
exposure, margin, the client workload, coverage last on the post-tick
state) at the reference's sites and in its order, through pieces the Fast
Paxos and Raft-core ticks share (:func:`skew_delta`,
:func:`observer_planes`, :func:`with_coverage`); they draw nothing but the
workload's arrivals (the ``ARRIVAL`` stream, drawn only where the state
carries the workload), so the schedule is the same with them on.

Both :func:`counter_masks` and :func:`apply_tick` take ``ablate``, a set of
``ABLATE_FLAGS`` that removes a component of the tick (the reference's
``fused_fns(protocol, ablate)``, for timing the fused kernel without it):
an ablated tick is not the protocol, and is held only against the
reference's ablated tick and the kernel's ablated builds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paxos_tpu_torch.check.safety import acceptor_invariants, learner_observe, margin_observe
from paxos_tpu_torch.core import telemetry as tel_mod
from paxos_tpu_torch.core.ballot import ballot_round, make_ballot
from paxos_tpu_torch.core.messages import ACCEPT, ACCEPTED, PREPARE, PROMISE
from paxos_tpu_torch.core.state import DONE, P1, P2, PaxosState
from paxos_tpu_torch.core.streams import SINGLE_DECREE_STREAMS as S
from paxos_tpu_torch.faults.injector import (
    FaultConfig,
    FaultPlan,
    bits_below,
    links_dup,
    rate_threshold,
)
from paxos_tpu_torch.kernels import counter_prng as cp
from paxos_tpu_torch.kernels.quorum import majority, quorum_reached
from paxos_tpu_torch.obs import coverage as cov_mod
from paxos_tpu_torch.obs import exposure as exp_mod
from paxos_tpu_torch.transport import inmemory as net
from paxos_tpu_torch.workload import generator as wload_mod

# The gray-failure and partition knobs, which every tick (and each of K1 to
# K5, in an arms instantiation) models.  A knob counts as on when it
# differs from its FaultConfig default.
GRAY_KNOBS = (
    "p_part", "p_asym", "p_flaky", "p_corrupt", "timeout_skew", "backoff_skew", "stale_k",
    "amnesia",
)
GRAY_PROTOCOLS = ("paxos", "fastpaxos", "raftcore", "synchpaxos", "multipaxos")
# The components an ablated tick removes (the reference's
# scripts/ablate_fused.py FLAGS, in its order): the counter-PRNG draws
# (constant masks instead), the acceptors' request selection, every send,
# the consume of delivered and selected messages, the learner with the
# acceptor invariants, and the proposer half-tick.
ABLATE_FLAGS = ("prng", "select", "sends", "consume", "learner", "proposer")
# Knobs only some ticks model: the ticks that do, and the ROADMAP item that
# speaks for the others.
_PARTIAL_KNOBS = {
    "sp_unsafe_fast": (
        ("synchpaxos",), "queue A item 10 (SynchPaxos' planted bug, read by no other tick)"
    ),
}


def check_supported(cfg: FaultConfig, protocol: str = "paxos") -> None:
    """Raise ``NotImplementedError`` for a knob ``protocol``'s tick does
    not model in the port."""
    default = FaultConfig()
    for knob, (protocols, item) in _PARTIAL_KNOBS.items():
        if protocol not in protocols and getattr(cfg, knob) != getattr(default, knob):
            raise NotImplementedError(
                f"FaultConfig.{knob}={getattr(cfg, knob)!r} is not ported to "
                f"paxos_tpu_torch's {protocol} tick yet (ROADMAP {item})"
            )


@dataclasses.dataclass
class TickMasks:
    """One tick's randomness (instance-minor; None = fault disabled)."""

    sel_score: torch.Tensor  # (2, P, A, I) int32 request-selection entropy
    busy: Optional[torch.Tensor]  # (1, 1, A, I) bool False = acceptor idles
    deliver: Optional[torch.Tensor]  # (2, P, A, I) bool reply not held
    dup_req: Optional[torch.Tensor]  # (2, P, A, I) bool request redelivered
    dup_rep: Optional[torch.Tensor]  # (2, P, A, I) bool reply redelivered
    keep_prom: Optional[torch.Tensor]  # (P, A, I) bool PROMISE not dropped
    keep_accd: Optional[torch.Tensor]  # (P, A, I) bool ACCEPTED not dropped
    keep_p1: Optional[torch.Tensor]  # (P, A, I) bool PREPARE not dropped
    keep_p2: Optional[torch.Tensor]  # (P, A, I) bool ACCEPT not dropped
    backoff: torch.Tensor  # (P, I) int32 retry backoff draw
    # Gray failures (None unless the knob is on).  With p_flaky > 0 the
    # keep_*/dup_* masks above are None and delivery is decided by these
    # raw bits against the plan's per-link thresholds (apply_tick).
    link_bits: Optional[torch.Tensor] = None  # (4, P, A, I) int32: sends of
    #   kind 0 PROMISE, 1 ACCEPTED, 2 PREPARE, 3 ACCEPT
    dup_bits: Optional[torch.Tensor] = None  # (2, 2, P, A, I) int32: axis 0
    #   0 requests, 1 replies
    corrupt: Optional[torch.Tensor] = None  # (A, I) bool payload perturbed
    delay_bits: Optional[torch.Tensor] = None  # (2, 2, P, A, I) int32 (p_delay)
    lat_bits: Optional[torch.Tensor] = None  # (2, 2, P, A, I) int32 latency draw
    arrival_bits: Optional[torch.Tensor] = None  # (P, I) int32 client arrivals (workload)


def counter_masks(
    cfg: FaultConfig, tick_seed, state: PaxosState, block=None, ablate: frozenset = frozenset()
) -> TickMasks:
    """Draw a tick's masks from the counter PRNG.

    ``tick_seed`` is a scalar stream seed (one stream block covering every
    lane) or a per-lane ``(n_inst,)`` tensor from ``counter_prng.lane_seeds``
    with ``block`` lanes per stream block.  It refuses the knobs that the
    tick of ``state``'s protocol does not model.  With ``p_flaky > 0`` the
    uniform drop and duplication masks are not drawn: the per-link raw bits
    take their place.  The client arrivals are drawn where the state
    carries the workload plane.

    ``ablate`` with "prng" draws nothing: every selection score is the
    lane's index within its stream block, and every other mask is off (no
    idling, hold, duplication or drop, a backoff of 0).
    """
    check_supported(cfg, state.protocol)
    _, n_prop, n_acc, n_inst = state.requests.present.shape
    slot = (2, n_prop, n_acc, n_inst)
    edge = (n_prop, n_acc, n_inst)
    if "prng" in ablate:
        return TickMasks(
            sel_score=in_block_iota(n_inst, block, state.device).expand(slot), busy=None,
            deliver=None, dup_req=None, dup_rep=None, keep_prom=None, keep_accd=None,
            keep_p1=None, keep_p2=None,
            backoff=torch.zeros((n_prop, n_inst), dtype=torch.int32, device=state.device),
        )
    kw = dict(block=block, device=state.device)
    flaky = cfg.p_flaky > 0.0

    def uniform(draw, stream, shape, p):
        return None if flaky else draw(tick_seed, S[stream], shape, p, **kw)

    return TickMasks(
        sel_score=cp.counter_bits(tick_seed, S["SEL"], slot, **kw),
        busy=cp.bern_not(
            tick_seed, S["BUSY"], (1, 1, n_acc, n_inst), cfg.p_idle, **kw
        ),
        deliver=cp.bern_not(tick_seed, S["DELIVER"], slot, cfg.p_hold, **kw),
        dup_req=uniform(cp.bern, "DUP_REQ", slot, cfg.p_dup),
        dup_rep=uniform(cp.bern, "DUP_REP", slot, cfg.p_dup),
        keep_prom=uniform(cp.bern_not, "KEEP_PROM", edge, cfg.p_drop),
        keep_accd=uniform(cp.bern_not, "KEEP_ACCD", edge, cfg.p_drop),
        keep_p1=uniform(cp.bern_not, "KEEP_P1", edge, cfg.p_drop),
        keep_p2=uniform(cp.bern_not, "KEEP_P2", edge, cfg.p_drop),
        backoff=cp.randint(
            tick_seed, S["BACKOFF"], (n_prop, n_inst), max(cfg.backoff_max, 1),
            **kw,
        ),
        link_bits=(
            cp.counter_bits(tick_seed, S["LINK_BITS"], (4,) + edge, **kw) if flaky else None
        ),
        dup_bits=(
            cp.counter_bits(tick_seed, S["DUP_BITS"], (2,) + slot, **kw)
            if links_dup(cfg) else None
        ),
        corrupt=cp.bern(tick_seed, S["CORRUPT"], (n_acc, n_inst), cfg.p_corrupt, **kw),
        delay_bits=(
            cp.counter_bits(tick_seed, S["DELAY_BITS"], (2,) + slot, **kw)
            if cfg.p_delay > 0.0 else None
        ),
        lat_bits=(
            cp.counter_bits(tick_seed, S["LAT_BITS"], (2,) + slot, **kw)
            if cfg.p_delay > 0.0 else None
        ),
        arrival_bits=(
            cp.counter_bits(tick_seed, S["ARRIVAL"], (n_prop, n_inst), **kw)
            if getattr(state, "wload", None) is not None else None
        ),
    )


def in_block_iota(n_inst: int, block, device) -> torch.Tensor:
    """(I,) int32: each lane's index within its stream block of ``block``
    lanes (one block where None), the reference's
    ``broadcasted_iota(..., 3)`` over a block of lanes: the selection score
    of a tick ablated of its PRNG."""
    lanes = torch.arange(n_inst, dtype=torch.int32, device=device)
    return lanes if block is None else lanes % block


def send_stamps(delay_bits, lat_bits, plan: FaultPlan, cfg: FaultConfig, tick) -> torch.Tensor:
    """The bounded-delay stamps (``p_delay``) of this tick's sends, from its
    raw delay and latency draws, each (..., P, A, I) over send kinds.

    Each send edge is delayed with probability ``p_delay`` by a latency
    ``1 + lat_bits % delay_max``, capped by the plan's per-link
    ``link_delay`` (cap 0: the link never delays).  The stamp is the
    earliest delivery tick of a send on that edge, 0 where it is
    deliverable at once (int32, the draws' shape).
    """
    ext = send_delays(delay_bits, lat_bits, plan, cfg)
    return torch.where(ext > 0, tick + 1 + ext, 0).to(torch.int32)


def send_delays(delay_bits, lat_bits, plan: FaultPlan, cfg: FaultConfig) -> torch.Tensor:
    """The extra latency :func:`send_stamps` gives each send edge (0: none)."""
    if plan.link_delay is None:
        raise ValueError("p_delay > 0 needs a plan with link_delay (the per-link latency caps)")
    # The sign bit is masked before the modulo, so the latency is in [1, delay_max].
    lat = 1 + (lat_bits & 0x7FFFFFFF) % max(cfg.delay_max, 1)
    return torch.where(
        bits_below(delay_bits, rate_threshold(cfg.p_delay)), torch.minimum(lat, plan.link_delay), 0
    ).to(torch.int32)


def delay_stamps(masks: TickMasks, plan: FaultPlan, cfg: FaultConfig, tick) -> tuple:
    """This tick's bounded-delay stamps (:func:`send_stamps`) per buffer:
    ``(until_req, until_rep)``, each (2, P, A, I) int32, or ``(None,
    None)`` when delay is off."""
    if cfg.p_delay <= 0.0:
        return None, None
    until = send_stamps(masks.delay_bits, masks.lat_bits, plan, cfg, tick)  # axis 0: requests, replies
    return until[0], until[1]


def kind_until(until: Optional[torch.Tensor], kind: int) -> Optional[torch.Tensor]:
    """Kind ``kind``'s (P, A, I) stamps of :func:`delay_stamps`' per-buffer
    ``until``, or None when delay is off."""
    return None if until is None else until[kind]


def _per_acceptor(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (A, I) mask viewed against an acceptor field ``x`` of shape (A,
    ..., I): Multi-Paxos' slot log is (A, L, I)."""
    return mask.view(mask.shape[:1] + (1,) * (x.dim() - 2) + mask.shape[1:])


def recover(acc, state, plan: FaultPlan, cfg: FaultConfig):
    """Stale-snapshot recovery (``stale_k``) or amnesia of ``acc``, the
    acceptors (Raft-core: voters) of ``state``, before the tick's acceptor
    half-tick and its invariant check (bug injections: the checker flags
    the consequences, not the rollback).  An acceptor recovering this tick
    restores the snapshot of the last multiple of stale_k ticks (forgets
    its state), and on a snapshot tick the snapshot takes the state after
    the restore; the durable fields and their shadows are
    ``type(acc).SNAPSHOT``'s (Multi-Paxos: ``promised`` and the whole slot
    log)."""
    pairs = type(acc).SNAPSHOT
    if cfg.stale_k > 0:
        if not state.snapshots:
            raise ValueError("stale_k > 0 needs a state with snapshot shadows (stale=True)")
        rec = plan.recovering(state.tick)
        acc = dataclasses.replace(acc, **{
            live: torch.where(
                _per_acceptor(rec, getattr(acc, live)), getattr(acc, snap), getattr(acc, live)
            )
            for live, snap in pairs
        })
        due = state.tick % cfg.stale_k == 0
        acc = dataclasses.replace(acc, **{
            snap: torch.where(due, getattr(acc, live), getattr(acc, snap)) for live, snap in pairs
        })
    elif cfg.amnesia:
        rec = plan.recovering(state.tick)
        acc = dataclasses.replace(acc, **{
            live: torch.where(_per_acceptor(rec, getattr(acc, live)), 0, getattr(acc, live))
            for live, _ in pairs
        })
    return acc


@dataclasses.dataclass
class Links:
    """A tick's link faults: the partition cuts (None without ``p_part``;
    (P, A, I) bool, True where the link delivers) per direction, and the
    drop and duplication masks of the sends and deliveries, each None where
    its fault is off.  Raft-core's roles: keep_prom VOTE, keep_accd ACK,
    keep_p1 REQVOTE, keep_p2 APPEND."""

    link_req: Optional[torch.Tensor]
    link_rep: Optional[torch.Tensor]
    keep_prom: Optional[torch.Tensor]
    keep_accd: Optional[torch.Tensor]
    keep_p1: Optional[torch.Tensor]
    keep_p2: Optional[torch.Tensor]
    dup_req: Optional[torch.Tensor]
    dup_rep: Optional[torch.Tensor]


def partition_cuts(plan: FaultPlan, cfg: FaultConfig, tick) -> tuple:
    """(link_req, link_rep): the partition cuts at ``tick`` (``p_part``;
    one-way with ``p_asym``), (P, A, I) bool, True where the link
    delivers requests (replies); (None, None) without ``p_part``."""
    if cfg.p_part <= 0.0:
        return None, None
    if cfg.p_asym > 0.0:
        return plan.link_ok(tick, "req"), plan.link_ok(tick, "rep")
    link = plan.link_ok(tick)
    return link, link


def gray_links(masks: TickMasks, plan: FaultPlan, cfg: FaultConfig, tick) -> Links:
    """The link faults at ``tick``: partition cuts (:func:`partition_cuts`),
    which stall messages in flight and lose nothing; and with ``p_flaky``
    the per-link loss and duplication, this tick's raw bits against the
    plan's per-link thresholds, in place of the uniform masks (p_flaky 0 is
    the uniform case)."""
    link_req, link_rep = partition_cuts(plan, cfg, tick)
    if cfg.p_flaky <= 0.0:
        return Links(
            link_req, link_rep, masks.keep_prom, masks.keep_accd, masks.keep_p1, masks.keep_p2,
            masks.dup_req, masks.dup_rep,
        )
    keeps = [~bits_below(masks.link_bits[k], plan.link_drop) for k in range(4)]
    dup_req = dup_rep = None
    if masks.dup_bits is not None:
        dup_req = bits_below(masks.dup_bits[0], plan.link_dup[None])
        dup_rep = bits_below(masks.dup_bits[1], plan.link_dup[None])
    return Links(link_req, link_rep, *keeps, dup_req, dup_rep)


def deliver(state, masks: TickMasks, links: Links) -> tuple:
    """(delivered, replies): the replies delivered this tick, those not
    held, arrived (a stamped buffer's ``tick >= until``) and not on a cut
    link, and the reply buffer with them consumed unless duplicated.
    Delivery is decided (and delivered slots cleared) BEFORE the acceptor
    half-tick writes new replies; proposers read payloads from the pre-tick
    buffer.  A reply still delayed or cut stays in flight: delay and cuts
    lose nothing."""
    delivered = state.replies.present
    if masks.deliver is not None:
        delivered = delivered & masks.deliver
    ready = net.ready(state.replies, state.tick)
    if ready is not None:  # delayed replies have not arrived yet
        delivered = delivered & ready
    if links.link_rep is not None:  # cut replies stay in flight
        delivered = delivered & links.link_rep[None]
    return delivered, net.consume(state.replies, delivered, stay=links.dup_rep)


def select(state, masks: TickMasks, plan: FaultPlan, links: Links) -> torch.Tensor:
    """(2, P, A, I) bool: the request each acceptor processes this tick,
    one at most, among those arrived (a stamped buffer's ``tick >=
    until``).  A request on a cut link still takes part in the selection;
    the cut masks the selected slot after it, as a crash does."""
    present = state.requests.present
    ready = net.ready(state.requests, state.tick)
    if ready is not None:  # delayed requests have not arrived yet
        present = present & ready
    sel = net.select_from_scores(present, masks.sel_score, masks.busy)
    sel = sel & plan.alive(state.tick)[None, None]  # crashed acceptors process nothing
    if links.link_req is not None:  # cut requests stay in flight
        sel = sel & links.link_req[None]
    return sel


def corrupt(masks: TickMasks, cfg: FaultConfig, msg_bal, msg_v1, is_kind0, is_kind1) -> tuple:
    """(msg_bal, msg_v1) after payload corruption (``p_corrupt``, a bug
    injection), between send and process: a kind-1 request's v1 (an
    ACCEPT's or APPEND's value) flips a bit, a kind-0 request's ballot (a
    PREPARE's or REQVOTE's) moves up one."""
    if cfg.p_corrupt > 0.0:
        msg_v1 = torch.where(masks.corrupt & is_kind1, msg_v1 ^ 64, msg_v1)
        msg_bal = torch.where(masks.corrupt & is_kind0, msg_bal + 1, msg_bal)
    return msg_bal, msg_v1


def skewed_timers(masks: TickMasks, plan: FaultPlan, cfg: FaultConfig) -> tuple:
    """(timeout, backoff): the timeout and this tick's backoff draw with
    the plan's per-proposer timer skew (``timeout_skew``: extra patience,
    ``backoff_skew``: a backoff multiplier)."""
    timeout = cfg.timeout + plan.ptimeout if cfg.timeout_skew > 0 else cfg.timeout
    backoff = masks.backoff * plan.pboff if cfg.backoff_skew > 1 else masks.backoff
    return timeout, backoff


def apply_tick(
    state: PaxosState, masks: TickMasks, plan: FaultPlan, cfg: FaultConfig,
    ablate: frozenset = frozenset(),
) -> PaxosState:
    """The pure protocol transition for one tick over pre-sampled masks.

    ``ablate`` removes components (``ABLATE_FLAGS``): "select", the
    acceptors select no request; "sends", no message is sent (replies and
    requests); "consume", delivered replies and selected requests stay
    present; "learner", neither the learner nor the acceptor invariants
    run; "proposer", the tick ends after the learner, the proposers as they
    were.  An ablated tick is not the protocol."""
    check_supported(cfg)
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    quorum = majority(n_acc)
    q1 = cfg.q1 or quorum
    q2 = cfg.q2 or quorum

    equiv = plan.equivocate  # (A, I)
    acc = recover(state.acceptor, state, plan, cfg)
    acc_pre = acc
    links = gray_links(masks, plan, cfg, state.tick)
    until_req, until_rep = delay_stamps(masks, plan, cfg, state.tick)
    delivered, replies = deliver(state, masks, links)
    if "consume" in ablate:
        replies = state.replies

    # ---- Acceptor half-tick: select one request per (instance, acceptor) ----
    if "select" in ablate:
        sel = torch.zeros_like(state.requests.present)
    else:
        sel = select(state, masks, plan, links)

    def gather(x):
        return torch.where(sel, x, 0).sum(dim=(0, 1), dtype=torch.int32)

    msg_bal = gather(state.requests.bal)  # (A, I)
    msg_val = gather(state.requests.v1)  # (A, I) ACCEPT payload
    is_prep = sel[PREPARE].any(dim=0)
    is_acc = sel[ACCEPT].any(dim=0)
    msg_bal, msg_val = corrupt(masks, cfg, msg_bal, msg_val, is_prep, is_acc)

    # PREPARE(b): honest promise iff b > promised; equivocators "promise"
    # unconditionally, never record it, and hide their accepted pair.
    ok_prep_h = is_prep & ~equiv & (msg_bal > acc.promised)
    ok_prep = ok_prep_h | (is_prep & equiv)
    # ACCEPT(b, v): honest iff b >= promised; equivocators accept all.
    ok_acc_h = is_acc & ~equiv & (msg_bal >= acc.promised)
    ok_acc = ok_acc_h | (is_acc & equiv)

    promised = torch.where(ok_prep_h, msg_bal, acc.promised)
    promised = torch.where(ok_acc_h, torch.maximum(promised, msg_bal), promised)
    acc_bal = torch.where(ok_acc, msg_bal, acc.acc_bal)
    acc_val = torch.where(ok_acc, msg_val, acc.acc_val)

    prom_payload_bal = torch.where(equiv, 0, acc.acc_bal)  # pre-update
    prom_payload_val = torch.where(equiv, 0, acc.acc_val)
    if "sends" not in ablate:
        replies = net.send(
            replies, PROMISE,
            send_mask=sel[PREPARE] & ok_prep[None],
            bal=msg_bal[None], v1=prom_payload_bal[None], v2=prom_payload_val[None],
            keep=links.keep_prom, until=kind_until(until_rep, PROMISE),
        )
        replies = net.send(
            replies, ACCEPTED,
            send_mask=sel[ACCEPT] & ok_acc[None],
            bal=msg_bal[None], v1=msg_val[None], v2=torch.zeros_like(msg_val)[None],
            keep=links.keep_accd, until=kind_until(until_rep, ACCEPTED),
        )
    if "consume" in ablate:
        requests = state.requests
    else:
        requests = net.consume(state.requests, sel, stay=links.dup_req)
    acc_new = dataclasses.replace(
        acc, promised=promised, acc_bal=acc_bal, acc_val=acc_val
    )

    # ---- Learner / safety checker ----
    if "learner" in ablate:
        learner = state.learner
    else:
        learner = learner_observe(
            state.learner, ok_acc, msg_bal, msg_val, state.tick, q2
        )
        inv_viol = acceptor_invariants(acc_pre, acc_new, honest=~equiv)
        learner = dataclasses.replace(
            learner, violations=learner.violations + inv_viol
        )
    if "proposer" in ablate:
        return dataclasses.replace(
            state, acceptor=acc_new, learner=learner, requests=requests, replies=replies,
            tick=state.tick + 1,
        )

    # ---- Proposer half-tick: fold all delivered replies ----
    prop = state.proposer
    bits = (1 << torch.arange(n_acc, dtype=torch.int32, device=state.device)).view(
        1, n_acc, 1
    )
    cur_bal = prop.bal[:, None]  # (P, 1, I)
    prom_ok = (
        delivered[PROMISE]
        & (state.replies.bal[PROMISE] == cur_bal)
        & (prop.phase == P1)[:, None]
    )  # (P, A, I)
    accd_ok = (
        delivered[ACCEPTED]
        & (state.replies.bal[ACCEPTED] == cur_bal)
        & (prop.phase == P2)[:, None]
    )
    heard = (
        prop.heard
        | torch.where(prom_ok, bits, 0).sum(dim=1, dtype=torch.int32)
        | torch.where(accd_ok, bits, 0).sum(dim=1, dtype=torch.int32)
    )  # (P, I)

    # Highest previously-accepted (ballot, value) among valid promises; the
    # value rides along by a max, since values agree at the max ballot.
    prev_bal = torch.where(prom_ok, state.replies.v1[PROMISE], 0)  # (P, A, I)
    cand_bal = prev_bal.amax(dim=1)  # (P, I)
    cand_val = torch.where(
        prev_bal == cand_bal[:, None], state.replies.v2[PROMISE], 0
    ).amax(dim=1)
    upgrade = cand_bal > prop.best_bal
    best_bal = torch.where(upgrade, cand_bal, prop.best_bal)
    best_val = torch.where(upgrade, cand_val, prop.best_val)

    p1_done = (prop.phase == P1) & quorum_reached(heard, q1)
    p2_done = (prop.phase == P2) & quorum_reached(heard, q2)
    v_chosen_by_p1 = torch.where(best_bal > 0, best_val, prop.own_val)

    timer = torch.where(prop.phase == DONE, prop.timer, prop.timer + 1)
    timeout, backoff = skewed_timers(masks, plan, cfg)
    pending = (prop.phase != DONE) & ~p1_done & ~p2_done
    expired = pending & (timer > timeout)
    exp_timeout_delta = skew_delta(state, cfg, expired, pending, timer)
    pid = torch.arange(n_prop, dtype=torch.int32, device=state.device)[:, None]
    new_bal = make_ballot(ballot_round(prop.bal) + cfg.ballot_stride, pid)

    phase = torch.where(p1_done, P2, prop.phase)
    phase = torch.where(p2_done, DONE, phase)
    phase = torch.where(expired, P1, phase)
    prop_val = torch.where(p1_done, v_chosen_by_p1, prop.prop_val)
    decided_val = torch.where(p2_done, prop.prop_val, prop.decided_val)
    bal_next = torch.where(expired, new_bal, prop.bal)
    heard = torch.where(p1_done | expired, 0, heard)
    best_bal = torch.where(expired, 0, best_bal)
    best_val = torch.where(expired, 0, best_val)
    timer = torch.where(p1_done, 0, timer)
    timer = torch.where(expired, -backoff, timer)

    # Emit: ACCEPT broadcast on phase-1 completion (old ballot), PREPARE
    # broadcast on retry (next ballot).
    zeros = torch.zeros((n_prop, 1, n_inst), dtype=torch.int32, device=state.device)
    if "sends" not in ablate:
        requests = net.send(
            requests, ACCEPT,
            send_mask=p1_done[:, None].expand(n_prop, n_acc, n_inst),
            bal=prop.bal[:, None], v1=prop_val[:, None], v2=zeros,
            keep=links.keep_p2, until=kind_until(until_req, ACCEPT),
        )
        requests = net.send(
            requests, PREPARE,
            send_mask=expired[:, None].expand(n_prop, n_acc, n_inst),
            bal=bal_next[:, None], v1=zeros, v2=zeros,
            keep=links.keep_p1, until=kind_until(until_req, PREPARE),
        )
    prop = dataclasses.replace(
        prop,
        bal=bal_next,
        phase=phase,
        prop_val=prop_val,
        heard=heard,
        best_bal=best_bal,
        best_val=best_val,
        timer=timer,
        decided_val=decided_val,
    )
    # ---- Observers: from signals the tick already produced. ----
    planes = observer_planes(
        state, masks, plan, cfg, links, learner, delivered=delivered, sel=sel,
        sends=(sel[PREPARE] & ok_prep[None], sel[ACCEPT] & ok_acc[None], p1_done, expired),
        kinds=(is_prep, is_acc), promise=ok_prep, accept=ok_acc, leader=p1_done,
        timeout=expired, serve=p2_done, fence=(acc_new.promised, acc_new.acc_bal, ~equiv),
        quorum=q2, timeout_delta=exp_timeout_delta,
    )
    return with_coverage(PaxosState(
        acceptor=acc_new,
        proposer=prop,
        learner=learner,
        requests=requests,
        replies=replies,
        tick=state.tick + 1,
        coverage=state.coverage,
        **planes,
    ))


def skew_delta(
    state, cfg: FaultConfig, expired, pending, timer, deadline=None
) -> "torch.Tensor | None":
    """Exposure's effective skewed timeouts (``timeout_skew``): where the
    expiry decision of the proposers still ``pending`` (not done and not
    advancing this tick) differs from the unskewed deadline's
    (``deadline``, default ``cfg.timeout``); taken before the timer
    rebases, and None where exposure or the skew is off."""
    if state.exposure is None or cfg.timeout_skew <= 0:
        return None
    return expired ^ (pending & (timer > (cfg.timeout if deadline is None else deadline)))


def observer_planes(
    state, masks: TickMasks, plan: FaultPlan, cfg: FaultConfig, links: Links, learner, *,
    delivered, sel, sends: tuple, kinds: tuple, promise, accept, leader, timeout, serve,
    fence: tuple, quorum: int, fast_quorum: "int | None" = None, timeout_delta=None,
) -> dict:
    """The observer planes of the single-decree ticks after one tick (all
    but coverage, which hashes the post-tick state: :func:`with_coverage`),
    each None where the state carries none, from the tick's own signals:
    the replies ``delivered`` and the requests selected (``sel``), whose
    duplicates telemetry and exposure count; ``sends``, the send masks of
    the tick's four kinds (the kind-0 and kind-1 replies, (P, A, I), then
    the kind-1 and kind-0 requests, (P, I) proposers that broadcast them;
    ``links``' keep_prom, keep_accd, keep_p2 and keep_p1 decide them),
    whose dropped sends telemetry and exposure count; ``kinds``, the acceptors that selected a kind-0 and a kind-1
    request (corruption's effective mask); telemetry's promise, accept,
    leader and timeout events; the proposers whose commit edge serves a
    queued client request (``serve``); the post-tick acceptor ``fence``
    (promise fence, accepted ballot, honest acceptors) and the ``quorum``
    (with ``fast_quorum``, a round-0 slot's) that the margin reads; and
    exposure's skewed-timeout delta (:func:`skew_delta`).  They draw
    nothing but the workload's arrivals (``masks.arrival_bits``)."""
    tel, exp = state.telemetry, state.exposure
    dropped = dups = None
    if tel is not None or exp is not None:
        lc = tel_mod.lane_count
        if links.keep_prom is not None:
            rep0, rep1, req1, req0 = sends
            dropped = (
                lc(rep0 & ~links.keep_prom) + lc(rep1 & ~links.keep_accd)
                + lc(req1[:, None] & ~links.keep_p2) + lc(req0[:, None] & ~links.keep_p1)
            )
        if links.dup_rep is not None:
            dups = lc(delivered & links.dup_rep) + lc(sel & links.dup_req)
    effective_corrupt = masks.corrupt & (kinds[0] | kinds[1]) if cfg.p_corrupt > 0.0 else None
    if tel is not None:
        tel = tel_mod.record(
            tel, state.tick,
            promise=promise, accept=accept, decide=learner.chosen & ~state.learner.chosen,
            conflict=learner.violations - state.learner.violations, leader=leader,
            timeout=timeout, drop=dropped, dup=dups, corrupt=effective_corrupt,
            **tel_mod.fault_lane_events(plan, cfg, state.tick),
        )
    if exp is not None:
        exp = exp_mod.record(exp, **_exposure_events(
            state, masks, plan, cfg, links, effective_corrupt, dropped, dups, timeout_delta,
        ))
    mar = state.margin
    if mar is not None:
        mar = margin_observe(mar, state.learner, learner, *fence, quorum, fast_quorum=fast_quorum)
    wl = state.wload
    if wl is not None:  # a proposer's commit edge serves one queued request
        wl = wload_mod.observe(wl, state.tick, serve=serve, arrival_bits=masks.arrival_bits)
    return dict(telemetry=tel, exposure=exp, margin=mar, wload=wl)


def with_coverage(out):
    """``out``, a post-tick state, with its coverage sketch folding its
    own digest (where it carries the plane)."""
    if out.coverage is not None:
        out.coverage = cov_mod.observe(out.coverage, out)
    return out


def _exposure_events(
    state, masks: TickMasks, plan: FaultPlan, cfg: FaultConfig, links: Links, effective_corrupt,
    dropped, dups, timeout_delta,
) -> dict:
    """The exposure classes' (injected, effective) pairs of a tick, each
    class only where its knob is on: every fault sampled this tick against
    those that changed something the protocol did or saw (a corruption:
    where its acceptor processed a request, ``effective_corrupt``)."""
    lc = tel_mod.lane_count
    events = {}
    if links.keep_prom is not None:
        events["drop"] = (
            lc(~links.keep_prom) + lc(~links.keep_accd) + lc(~links.keep_p1) + lc(~links.keep_p2),
            dropped,
        )
    if links.dup_rep is not None:
        events["dup"] = (lc(links.dup_req) + lc(links.dup_rep), dups)
    if cfg.p_corrupt > 0.0:
        events["corrupt"] = (masks.corrupt, effective_corrupt)
    if links.link_req is not None:  # the cut stalled what was in flight
        events["partition"] = (
            lc(~links.link_req) + lc(~links.link_rep),
            lc(state.requests.present & ~links.link_req[None])
            + lc(state.replies.present & ~links.link_rep[None]),
        )
    if timeout_delta is not None:
        events["timeout"] = (plan.ptimeout != 0, timeout_delta)
    if cfg.stale_k > 0:  # every restore rewrites durable state
        rec = plan.recovering(state.tick)
        events["stale"] = (rec, rec)
    if cfg.p_delay > 0.0:  # delays drawn; messages stalled behind their stamp
        ext = send_delays(masks.delay_bits, masks.lat_bits, plan, cfg)
        events["delay"] = (
            lc(ext > 0),
            lc(state.requests.present & ~net.ready(state.requests, state.tick))
            + lc(state.replies.present & ~net.ready(state.replies, state.tick)),
        )
    return events
