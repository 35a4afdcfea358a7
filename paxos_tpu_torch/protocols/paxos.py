"""Single-decree Paxos tick (counterpart of ``paxos_tpu/protocols/paxos.py``).

One tick = deliver (masked selects) -> role transitions -> emit (masked
writes), batched over every instance.  :func:`counter_masks` draws a tick's
randomness from the counter PRNG; :func:`apply_tick` is the pure transition
over those masks.  Both are plain PyTorch: the plain version of the fused
CUDA kernel (``kernels/fused_tick``) replays them tick by tick.

Ported knobs: ``p_drop``, ``p_dup``, ``p_idle``, ``p_hold``, ``timeout``,
``backoff_max``, ``ballot_stride``, ``q1``, ``q2``, and the plan's crash
windows and equivocation flags; for SynchPaxos also the bounded delay
(``p_delay``, ``delay_max``: :func:`delay_stamps`) and ``sp_unsafe_fast``.
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
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan, bits_below, rate_threshold
from paxos_tpu_torch.kernels import counter_prng as cp
from paxos_tpu_torch.kernels.quorum import majority, quorum_reached
from paxos_tpu_torch.transport import inmemory as net

# Knobs of the reference's tick that the port does not implement yet, with
# the ROADMAP item that ports them.  A knob counts as on when it differs
# from its FaultConfig default.
_UNPORTED_KNOBS = {
    "p_part": "queue A slice 5 item 12 (partition windows)",
    "p_asym": "queue A slice 5 item 12 (gray plan fields)",
    "p_flaky": "queue A slice 5 item 12 (gray plan fields)",
    "p_corrupt": "queue A slice 5 item 12 (gray plan fields)",
    "timeout_skew": "queue A slice 5 item 12 (gray plan fields)",
    "backoff_skew": "queue A slice 5 item 12 (gray plan fields)",
    "stale_k": "queue A slice 5 item 12 (stale-snapshot recovery)",
    "amnesia": "queue A slice 5 item 12 (amnesia on recovery)",
}
# Knobs only the SynchPaxos tick models so far.
_SYNCHPAXOS_ONLY_KNOBS = {
    "p_delay": "queue A slice 5 item 12 (bounded delay on the other ticks)",
    "sp_unsafe_fast": "queue A item 10 (SynchPaxos' planted bug, read by no other tick)",
}


def check_supported(cfg: FaultConfig, protocol: str = "paxos") -> None:
    """Raise ``NotImplementedError`` for a knob ``protocol``'s tick does
    not model in the port."""
    knobs = dict(_UNPORTED_KNOBS)
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
    delay_bits: Optional[torch.Tensor] = None  # (2, 2, P, A, I) int32 (p_delay)
    lat_bits: Optional[torch.Tensor] = None  # (2, 2, P, A, I) int32 latency draw


def counter_masks(
    cfg: FaultConfig, tick_seed, state: PaxosState, block=None
) -> TickMasks:
    """Draw a tick's masks from the counter PRNG.

    ``tick_seed`` is a scalar stream seed (one stream block covering every
    lane) or a per-lane ``(n_inst,)`` tensor from ``counter_prng.lane_seeds``
    with ``block`` lanes per stream block.  It refuses the knobs that the
    tick of ``state``'s protocol does not model.
    """
    check_supported(cfg, state.protocol)
    _, n_prop, n_acc, n_inst = state.requests.present.shape
    slot = (2, n_prop, n_acc, n_inst)
    edge = (n_prop, n_acc, n_inst)
    kw = dict(block=block, device=state.device)
    return TickMasks(
        sel_score=cp.counter_bits(tick_seed, S["SEL"], slot, **kw),
        busy=cp.bern_not(
            tick_seed, S["BUSY"], (1, 1, n_acc, n_inst), cfg.p_idle, **kw
        ),
        deliver=cp.bern_not(tick_seed, S["DELIVER"], slot, cfg.p_hold, **kw),
        dup_req=cp.bern(tick_seed, S["DUP_REQ"], slot, cfg.p_dup, **kw),
        dup_rep=cp.bern(tick_seed, S["DUP_REP"], slot, cfg.p_dup, **kw),
        keep_prom=cp.bern_not(tick_seed, S["KEEP_PROM"], edge, cfg.p_drop, **kw),
        keep_accd=cp.bern_not(tick_seed, S["KEEP_ACCD"], edge, cfg.p_drop, **kw),
        keep_p1=cp.bern_not(tick_seed, S["KEEP_P1"], edge, cfg.p_drop, **kw),
        keep_p2=cp.bern_not(tick_seed, S["KEEP_P2"], edge, cfg.p_drop, **kw),
        backoff=cp.randint(
            tick_seed, S["BACKOFF"], (n_prop, n_inst), max(cfg.backoff_max, 1),
            **kw,
        ),
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

    acc = state.acceptor
    alive = plan.alive(state.tick)  # (A, I)
    equiv = plan.equivocate  # (A, I)

    # Reply delivery is decided (and delivered slots cleared) BEFORE the
    # acceptor half-tick writes new replies; proposers read payloads from
    # the pre-tick buffer.
    delivered = state.replies.present
    if masks.deliver is not None:
        delivered = delivered & masks.deliver
    replies = net.consume(state.replies, delivered, stay=masks.dup_rep)

    # ---- Acceptor half-tick: select one request per (instance, acceptor) ----
    sel = net.select_from_scores(
        state.requests.present, masks.sel_score, masks.busy
    )
    sel = sel & alive[None, None]  # crashed acceptors process nothing

    def gather(x):
        return torch.where(sel, x, 0).sum(dim=(0, 1), dtype=torch.int32)

    msg_bal = gather(state.requests.bal)  # (A, I)
    msg_val = gather(state.requests.v1)  # (A, I) ACCEPT payload
    is_prep = sel[PREPARE].any(dim=0)
    is_acc = sel[ACCEPT].any(dim=0)

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
        keep=masks.keep_prom,
    )
    replies = net.send(
        replies, ACCEPTED,
        send_mask=sel[ACCEPT] & ok_acc[None],
        bal=msg_bal[None], v1=msg_val[None], v2=torch.zeros_like(msg_val)[None],
        keep=masks.keep_accd,
    )
    requests = net.consume(state.requests, sel, stay=masks.dup_req)
    acc_new = dataclasses.replace(
        acc, promised=promised, acc_bal=acc_bal, acc_val=acc_val
    )

    # ---- Learner / safety checker ----
    learner = learner_observe(
        state.learner, ok_acc, msg_bal, msg_val, state.tick, q2
    )
    inv_viol = acceptor_invariants(acc, acc_new, honest=~equiv)
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
    expired = (prop.phase != DONE) & ~p1_done & ~p2_done & (timer > cfg.timeout)
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
    timer = torch.where(expired, -masks.backoff, timer)

    # Emit: ACCEPT broadcast on phase-1 completion (old ballot), PREPARE
    # broadcast on retry (next ballot).
    zeros = torch.zeros((n_prop, 1, n_inst), dtype=torch.int32, device=state.device)
    requests = net.send(
        requests, ACCEPT,
        send_mask=p1_done[:, None].expand(n_prop, n_acc, n_inst),
        bal=prop.bal[:, None], v1=prop_val[:, None], v2=zeros,
        keep=masks.keep_p2,
    )
    requests = net.send(
        requests, PREPARE,
        send_mask=expired[:, None].expand(n_prop, n_acc, n_inst),
        bal=bal_next[:, None], v1=zeros, v2=zeros,
        keep=masks.keep_p1,
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
