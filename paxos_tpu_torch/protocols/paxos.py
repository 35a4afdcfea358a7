"""Single-decree Paxos tick (counterpart of ``paxos_tpu/protocols/paxos.py``).

One tick = deliver (masked selects) -> role transitions -> emit (masked
writes), batched over every instance.  :func:`counter_masks` draws a tick's
randomness from the counter PRNG; :func:`apply_tick` is the pure transition
over those masks.  Both are plain PyTorch: the plain version of the fused
CUDA kernel (``kernels/fused_tick``) replays them tick by tick.

Ported knobs: ``p_drop``, ``p_dup``, ``p_idle``, ``p_hold``, ``timeout``,
``backoff_max``, ``ballot_stride``, ``q1``, ``q2``, and the plan's crash
windows and equivocation flags; for Paxos, Fast Paxos, Raft-core and
Multi-Paxos also the gray-failure and partition arms (``p_part`` with
``p_asym``, ``p_flaky``, ``p_corrupt``, ``timeout_skew``,
``backoff_skew``, ``stale_k``, ``amnesia``), whose pieces the four ticks
share (:func:`recover`, :func:`partition_cuts`, :func:`gray_links`,
:func:`deliver`, :func:`select`, :func:`corrupt`, :func:`skewed_timers`;
Multi-Paxos, whose buffers differ, takes the first two and the last
two); for SynchPaxos the bounded delay (``p_delay``, ``delay_max``:
:func:`delay_stamps`) and ``sp_unsafe_fast``.
Any other knob raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paxos_tpu_torch.check.safety import acceptor_invariants, learner_observe
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
from paxos_tpu_torch.transport import inmemory as net

# The gray-failure and partition knobs, which the Paxos, Fast Paxos,
# Raft-core and Multi-Paxos ticks (and K1 to K3 and K5) model so far; the
# SynchPaxos tick raises, naming the ROADMAP item that ports them.  A knob
# counts as on when it differs from its FaultConfig default.
GRAY_KNOBS = (
    "p_part", "p_asym", "p_flaky", "p_corrupt", "timeout_skew", "backoff_skew", "stale_k",
    "amnesia",
)
GRAY_PROTOCOLS = ("paxos", "fastpaxos", "raftcore", "multipaxos")
_GRAY_ITEM = "queue A item 12b (the gray-failure and partition arms of SynchPaxos)"
# Knobs only the SynchPaxos tick models so far.
_SYNCHPAXOS_ONLY_KNOBS = {
    "p_delay": "queue A item 12c (bounded delay on the other ticks)",
    "sp_unsafe_fast": "queue A item 10 (SynchPaxos' planted bug, read by no other tick)",
}


def check_supported(cfg: FaultConfig, protocol: str = "paxos") -> None:
    """Raise ``NotImplementedError`` for a knob ``protocol``'s tick does
    not model in the port."""
    knobs = {} if protocol in GRAY_PROTOCOLS else dict.fromkeys(GRAY_KNOBS, _GRAY_ITEM)
    if protocol != "synchpaxos":
        knobs.update(_SYNCHPAXOS_ONLY_KNOBS)
    default = FaultConfig()
    for knob, item in knobs.items():
        if getattr(cfg, knob) != getattr(default, knob):
            raise NotImplementedError(
                f"FaultConfig.{knob}={getattr(cfg, knob)!r} is not ported to "
                f"paxos_tpu_torch's {protocol} tick yet (ROADMAP {item})"
            )


def check_no_stamps(state, protocol: str) -> None:
    """Raise unless the state's buffers carry no delay stamps: only the
    SynchPaxos tick reads ``until``."""
    if state.requests.until is not None or state.replies.until is not None:
        raise NotImplementedError(
            f"the {protocol} tick does not read delay stamps (MsgBuf.until) yet "
            f"(ROADMAP {_SYNCHPAXOS_ONLY_KNOBS['p_delay']})"
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


def counter_masks(
    cfg: FaultConfig, tick_seed, state: PaxosState, block=None
) -> TickMasks:
    """Draw a tick's masks from the counter PRNG.

    ``tick_seed`` is a scalar stream seed (one stream block covering every
    lane) or a per-lane ``(n_inst,)`` tensor from ``counter_prng.lane_seeds``
    with ``block`` lanes per stream block.  It refuses the knobs that the
    tick of ``state``'s protocol does not model.  With ``p_flaky > 0`` the
    uniform drop and duplication masks are not drawn: the per-link raw bits
    take their place.
    """
    check_supported(cfg, state.protocol)
    _, n_prop, n_acc, n_inst = state.requests.present.shape
    slot = (2, n_prop, n_acc, n_inst)
    edge = (n_prop, n_acc, n_inst)
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
    )


def delay_stamps(masks: TickMasks, plan: FaultPlan, cfg: FaultConfig, tick) -> tuple:
    """This tick's bounded-delay stamps (``p_delay``).

    Each send edge is delayed with probability ``p_delay`` by a latency
    ``1 + lat_bits % delay_max``, capped by the plan's per-link
    ``link_delay`` (cap 0: the link never delays).  Returns ``(until_req,
    until_rep)``, each (2, P, A, I) int32: the earliest delivery tick of a
    send on that edge, 0 where it is deliverable at once; ``(None, None)``
    when delay is off.
    """
    if cfg.p_delay <= 0.0:
        return None, None
    if plan.link_delay is None:
        raise ValueError("p_delay > 0 needs a plan with link_delay (the per-link latency caps)")
    # The sign bit is masked before the modulo, so the latency is in [1, delay_max].
    lat = 1 + (masks.lat_bits & 0x7FFFFFFF) % max(cfg.delay_max, 1)
    ext = torch.where(
        bits_below(masks.delay_bits, rate_threshold(cfg.p_delay)),
        torch.minimum(lat, plan.link_delay[None, None]),
        0,
    ).to(torch.int32)  # (2, 2, P, A, I); axis 0: 0 = requests, 1 = replies
    until = torch.where(ext > 0, tick + 1 + ext, 0).to(torch.int32)
    return until[0], until[1]


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
    held and not on a cut link, and the reply buffer with them consumed
    unless duplicated.  Delivery is decided (and delivered slots cleared)
    BEFORE the acceptor half-tick writes new replies; proposers read
    payloads from the pre-tick buffer."""
    delivered = state.replies.present
    if masks.deliver is not None:
        delivered = delivered & masks.deliver
    if links.link_rep is not None:  # cut replies stay in flight
        delivered = delivered & links.link_rep[None]
    return delivered, net.consume(state.replies, delivered, stay=links.dup_rep)


def select(state, masks: TickMasks, plan: FaultPlan, links: Links) -> torch.Tensor:
    """(2, P, A, I) bool: the request each acceptor processes this tick,
    one at most.  A request on a cut link still takes part in the
    selection; the cut masks the selected slot after it, as a crash does."""
    sel = net.select_from_scores(state.requests.present, masks.sel_score, masks.busy)
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
    state: PaxosState, masks: TickMasks, plan: FaultPlan, cfg: FaultConfig
) -> PaxosState:
    """The pure protocol transition for one tick over pre-sampled masks."""
    check_supported(cfg)
    check_no_stamps(state, "paxos")
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    quorum = majority(n_acc)
    q1 = cfg.q1 or quorum
    q2 = cfg.q2 or quorum

    equiv = plan.equivocate  # (A, I)
    acc = recover(state.acceptor, state, plan, cfg)
    acc_pre = acc
    links = gray_links(masks, plan, cfg, state.tick)
    delivered, replies = deliver(state, masks, links)

    # ---- Acceptor half-tick: select one request per (instance, acceptor) ----
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
    replies = net.send(
        replies, PROMISE,
        send_mask=sel[PREPARE] & ok_prep[None],
        bal=msg_bal[None], v1=prom_payload_bal[None], v2=prom_payload_val[None],
        keep=links.keep_prom,
    )
    replies = net.send(
        replies, ACCEPTED,
        send_mask=sel[ACCEPT] & ok_acc[None],
        bal=msg_bal[None], v1=msg_val[None], v2=torch.zeros_like(msg_val)[None],
        keep=links.keep_accd,
    )
    requests = net.consume(state.requests, sel, stay=links.dup_req)
    acc_new = dataclasses.replace(
        acc, promised=promised, acc_bal=acc_bal, acc_val=acc_val
    )

    # ---- Learner / safety checker ----
    learner = learner_observe(
        state.learner, ok_acc, msg_bal, msg_val, state.tick, q2
    )
    inv_viol = acceptor_invariants(acc_pre, acc_new, honest=~equiv)
    learner = dataclasses.replace(
        learner, violations=learner.violations + inv_viol
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
    expired = (prop.phase != DONE) & ~p1_done & ~p2_done & (timer > timeout)
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
    requests = net.send(
        requests, ACCEPT,
        send_mask=p1_done[:, None].expand(n_prop, n_acc, n_inst),
        bal=prop.bal[:, None], v1=prop_val[:, None], v2=zeros,
        keep=links.keep_p2,
    )
    requests = net.send(
        requests, PREPARE,
        send_mask=expired[:, None].expand(n_prop, n_acc, n_inst),
        bal=bal_next[:, None], v1=zeros, v2=zeros,
        keep=links.keep_p1,
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
    return PaxosState(
        acceptor=acc_new,
        proposer=prop,
        learner=learner,
        requests=requests,
        replies=replies,
        tick=state.tick + 1,
    )
