"""SynchPaxos tick (counterpart of ``paxos_tpu/protocols/synchpaxos.py``).

Classic single-decree Paxos plus a leader fast path that bets on the
bounded-delay window ``FaultConfig.delta`` (see :mod:`paxos_tpu_torch.core.sp_state`):

- the leader's round-0 ``Accept(sync_bal, own_val)`` broadcast goes out at
  ``timer == 0`` in FAST, through the faulty network (drops and delay
  stamps apply);
- it decides ``own_val`` on a majority of Accepted heard while ``timer <=
  delta``, the timer advancing first; past ``delta`` it falls back to
  classic rounds, the followers after the classic ``timeout``;
- ``sp_unsafe_fast``, the planted bug: the leader decides on the first
  Accepted heard, with no quorum and no window.

Acceptors, learner and checker are classic Paxos'.  The bounded-delay
channel is the transport's: sends carry :func:`delay_stamps`' ``until``
stamps, and a slot is delivered (a request selected) only once ``tick >=
until``.  The gray-failure and partition arms are the Paxos tick's shared
pieces (:func:`recover`, :func:`gray_links`, :func:`deliver`,
:func:`select`, :func:`corrupt`, :func:`skewed_timers`): a cut stalls a
message, stamped or not, and the timeout skew moves the classic deadline
only (FAST's stays ``delta``).  Masks come from
:func:`paxos_tpu_torch.protocols.paxos.counter_masks`.  The observer planes
are the Paxos tick's too (:func:`observer_planes`), with SynchPaxos'
signals: a fast or classic decide serves a client request, a fast decide
elects as phase 1 does, and the unskewed deadline of a skewed timeout is
FAST's ``delta`` in the fast round.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.check.safety import acceptor_invariants, learner_observe
from paxos_tpu_torch.core.ballot import ballot_round, make_ballot
from paxos_tpu_torch.core.messages import ACCEPT, ACCEPTED, PREPARE, PROMISE
from paxos_tpu_torch.core.sp_state import FAST, SynchPaxosState, sync_ballot
from paxos_tpu_torch.core.state import DONE, P1, P2
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan
from paxos_tpu_torch.kernels.quorum import majority, quorum_reached
from paxos_tpu_torch.protocols.paxos import (
    TickMasks,
    check_supported,
    corrupt,
    delay_stamps,
    deliver,
    gray_links,
    kind_until,
    observer_planes,
    recover,
    select,
    skew_delta,
    skewed_timers,
    with_coverage,
)
from paxos_tpu_torch.transport import inmemory as net
from paxos_tpu_torch.utils.bitops import popcount


def apply_tick_sp(
    state: SynchPaxosState, masks: TickMasks, plan: FaultPlan, cfg: FaultConfig
) -> SynchPaxosState:
    """The pure SynchPaxos transition for one tick over pre-sampled masks."""
    check_supported(cfg, "synchpaxos")
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    quorum = majority(n_acc)
    q1 = cfg.q1 or quorum
    q2 = cfg.q2 or quorum  # round 0 has one owner: its decide is a phase-2 quorum
    delta = max(cfg.delta, 0)
    dev = state.device

    equiv = plan.equivocate  # (A, I)
    acc = recover(state.acceptor, state, plan, cfg)
    links = gray_links(masks, plan, cfg, state.tick)

    # Send stamps; the readiness gates are deliver's and select's.
    until_req, until_rep = delay_stamps(masks, plan, cfg, state.tick)
    delivered, replies = deliver(state, masks, links)

    # ---- Acceptor half-tick (classic Paxos) ----
    sel = select(state, masks, plan, links)

    def gather(x):
        return torch.where(sel, x, 0).sum(dim=(0, 1), dtype=torch.int32)

    msg_bal = gather(state.requests.bal)  # (A, I)
    msg_val = gather(state.requests.v1)  # (A, I)
    is_prep = sel[PREPARE].any(dim=0)
    is_acc = sel[ACCEPT].any(dim=0)
    msg_bal, msg_val = corrupt(masks, cfg, msg_bal, msg_val, is_prep, is_acc)

    ok_prep_h = is_prep & ~equiv & (msg_bal > acc.promised)
    ok_prep = ok_prep_h | (is_prep & equiv)
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
        keep=links.keep_prom, until=kind_until(until_rep, PROMISE),
    )
    replies = net.send(
        replies, ACCEPTED,
        send_mask=sel[ACCEPT] & ok_acc[None],
        bal=msg_bal[None], v1=msg_val[None], v2=torch.zeros_like(msg_val)[None],
        keep=links.keep_accd, until=kind_until(until_rep, ACCEPTED),
    )
    requests = net.consume(state.requests, sel, stay=links.dup_req)
    acc_new = dataclasses.replace(acc, promised=promised, acc_bal=acc_bal, acc_val=acc_val)

    # ---- Learner / safety checker ----
    learner = learner_observe(state.learner, ok_acc, msg_bal, msg_val, state.tick, q2)
    inv_viol = acceptor_invariants(acc, acc_new, honest=~equiv)
    learner = dataclasses.replace(learner, violations=learner.violations + inv_viol)

    # ---- Proposer half-tick ----
    prop = state.proposer
    bits = (1 << torch.arange(n_acc, dtype=torch.int32, device=dev)).view(1, n_acc, 1)
    cur_bal = prop.bal[:, None]  # (P, 1, I)
    prom_ok = (
        delivered[PROMISE]
        & (state.replies.bal[PROMISE] == cur_bal)
        & (prop.phase == P1)[:, None]
    )  # (P, A, I)
    accd_ok = (
        delivered[ACCEPTED]
        & (state.replies.bal[ACCEPTED] == cur_bal)
        & ((prop.phase == P2) | (prop.phase == FAST))[:, None]
    )
    heard = (
        prop.heard
        | torch.where(prom_ok, bits, 0).sum(dim=1, dtype=torch.int32)
        | torch.where(accd_ok, bits, 0).sum(dim=1, dtype=torch.int32)
    )

    # Phase-1 recovery fold (classic): highest previously-accepted pair.
    prev_bal = torch.where(prom_ok, state.replies.v1[PROMISE], 0)  # (P, A, I)
    cand_bal = prev_bal.amax(dim=1)  # (P, I)
    cand_val = torch.where(
        prev_bal == cand_bal[:, None], state.replies.v2[PROMISE], 0
    ).amax(dim=1)
    upgrade = cand_bal > prop.best_bal
    best_bal = torch.where(upgrade, cand_bal, prop.best_bal)
    best_val = torch.where(upgrade, cand_val, prop.best_val)

    # The timer advances first, so the window test sees this tick's age.
    timer = torch.where(prop.phase == DONE, prop.timer, prop.timer + 1)
    in_window = timer <= delta
    if cfg.sp_unsafe_fast:  # planted bug: the first Accepted decides
        fast_done = (prop.phase == FAST) & (popcount(heard) >= 1)
    else:
        fast_done = (prop.phase == FAST) & quorum_reached(heard, q2) & in_window
    p1_done = (prop.phase == P1) & quorum_reached(heard, q1)
    p2_done = (prop.phase == P2) & quorum_reached(heard, q2)
    v_chosen_by_p1 = torch.where(best_bal > 0, best_val, prop.own_val)

    # FAST's deadline is the window delta, not the (skewed) classic timeout.
    timeout, backoff = skewed_timers(masks, plan, cfg)
    deadline = torch.where(prop.phase == FAST, delta, timeout)
    pending = (prop.phase != DONE) & ~p1_done & ~p2_done & ~fast_done
    expired = pending & (timer > deadline)
    exp_timeout_delta = skew_delta(
        state, cfg, expired, pending, timer,
        deadline=torch.where(prop.phase == FAST, delta, cfg.timeout),
    )
    pid = torch.arange(n_prop, dtype=torch.int32, device=dev)[:, None]
    new_bal = make_ballot(ballot_round(prop.bal) + cfg.ballot_stride, pid)

    phase = torch.where(p1_done, P2, prop.phase)
    phase = torch.where(p2_done | fast_done, DONE, phase)
    phase = torch.where(expired, P1, phase)
    prop_val = torch.where(p1_done, v_chosen_by_p1, prop.prop_val)
    decided_val = torch.where(p2_done, prop.prop_val, prop.decided_val)
    decided_val = torch.where(fast_done, prop.own_val, decided_val)
    bal_next = torch.where(expired, new_bal, prop.bal)
    heard = torch.where(p1_done | expired, 0, heard)
    best_bal = torch.where(expired, 0, best_bal)
    best_val = torch.where(expired, 0, best_val)
    timer = torch.where(p1_done, 0, timer)
    timer = torch.where(expired, -backoff, timer)

    # Emit: the leader's round-0 broadcast at its pre-tick timer 0 in FAST
    # (disjoint from p1_done, so both ACCEPT sends compose), the classic
    # ACCEPT on phase-1 completion, and PREPARE on expiry.
    zeros = torch.zeros((n_prop, 1, n_inst), dtype=torch.int32, device=dev)
    fast_kick = (prop.phase == FAST) & (prop.timer == 0)
    edges = (n_prop, n_acc, n_inst)
    until_acc = kind_until(until_req, ACCEPT)
    requests = net.send(
        requests, ACCEPT,
        send_mask=fast_kick[:, None].expand(edges),
        bal=prop.bal[:, None], v1=prop.own_val[:, None], v2=zeros,
        keep=links.keep_p2, until=until_acc,
    )
    requests = net.send(
        requests, ACCEPT,
        send_mask=p1_done[:, None].expand(edges),
        bal=prop.bal[:, None], v1=prop_val[:, None], v2=zeros,
        keep=links.keep_p2, until=until_acc,
    )
    requests = net.send(
        requests, PREPARE,
        send_mask=expired[:, None].expand(edges),
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
    # ---- Observers: from signals the tick already produced (the FAST
    #      round's kick is not a counted send, as in the reference). ----
    planes = observer_planes(
        state, masks, plan, cfg, links, learner, delivered=delivered, sel=sel,
        sends=(sel[PREPARE] & ok_prep[None], sel[ACCEPT] & ok_acc[None], p1_done, expired),
        kinds=(is_prep, is_acc), promise=ok_prep, accept=ok_acc, leader=p1_done | fast_done,
        timeout=expired, serve=p2_done | fast_done,
        fence=(acc_new.promised, acc_new.acc_bal, ~equiv), quorum=q2,
        timeout_delta=exp_timeout_delta,
    )
    return with_coverage(SynchPaxosState(
        acceptor=acc_new,
        proposer=prop,
        learner=learner,
        requests=requests,
        replies=replies,
        tick=state.tick + 1,
        coverage=state.coverage,
        **planes,
    ))


def fast_path_rate(state: SynchPaxosState) -> float:
    """Fraction of instances the leader decided on the round-0 fast path.

    The leader's ballot moves only on fallback, so phase DONE at the sync
    ballot marks a fast-path decide.  Reduced on the state's device; one
    transfer of the count."""
    prop = state.proposer
    fast = (prop.phase[0] == DONE) & (prop.bal[0] == sync_ballot())
    return int(fast.sum().item()) / state.n_inst
