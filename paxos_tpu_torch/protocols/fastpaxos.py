"""Fast Paxos tick (counterpart of ``paxos_tpu/protocols/fastpaxos.py``).

Same masks (:func:`paxos_tpu_torch.protocols.paxos.counter_masks`), same
transport and fault machinery as single-decree Paxos; what differs:

- the fast round (round 0): proposers skip phase 1, acceptors vote at most
  once per ballot, and a value needs a fast quorum (``q_fast``, default
  ceil(3n/4)) to be chosen;
- collision recovery: a proposer that times out runs classic rounds (>= 1)
  and adopts, from the highest reported ballot ``k``, a value that could
  have been chosen at ``k`` (``count(v) + unheard >= q_fast`` when ``k`` is
  the fast round; ``k``'s value when ``k`` is classic);
- the learner applies the per-round-kind threshold
  (``learner_observe(..., fast_quorum=...)``).

The gray-failure and partition arms are the Paxos tick's (stale-snapshot
restore and amnesia, cuts, flaky links, corruption, timer skew), through
the pieces the three ticks share.  Observer planes and unported knobs are
absent, as in the Paxos tick.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.check.safety import acceptor_invariants, first_true, learner_observe
from paxos_tpu_torch.core.ballot import ballot_round, make_ballot
from paxos_tpu_torch.core.fp_state import FAST, VALUE_BASE, FastPaxosState
from paxos_tpu_torch.core.messages import ACCEPT, ACCEPTED, PREPARE, PROMISE
from paxos_tpu_torch.core.state import DONE, P1, P2
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan
from paxos_tpu_torch.kernels.quorum import fast_quorum, majority, quorum_reached
from paxos_tpu_torch.protocols.paxos import (
    TickMasks,
    check_no_stamps,
    check_supported,
    corrupt,
    deliver,
    gray_links,
    recover,
    select,
    skewed_timers,
)
from paxos_tpu_torch.transport import inmemory as net
from paxos_tpu_torch.utils.bitops import popcount


def apply_tick_fast(
    state: FastPaxosState, masks: TickMasks, plan: FaultPlan, cfg: FaultConfig
) -> FastPaxosState:
    """The pure Fast Paxos transition for one tick over pre-sampled masks."""
    check_supported(cfg, "fastpaxos")
    check_no_stamps(state, "fastpaxos")
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    quorum = majority(n_acc)
    q1 = cfg.q1 or quorum
    q2 = cfg.q2 or quorum
    fquorum = cfg.q_fast or fast_quorum(n_acc)
    dev = state.device

    equiv = plan.equivocate  # (A, I)
    acc = recover(state.acceptor, state, plan, cfg)
    links = gray_links(masks, plan, cfg, state.tick)
    delivered, replies = deliver(state, masks, links)

    # ---- Acceptor half-tick ----
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
    # Vote at most once per ballot; re-accepting the identical pair stays
    # idempotent (duplicate deliveries).
    revote = (msg_bal > acc.acc_bal) | ((msg_bal == acc.acc_bal) & (msg_val == acc.acc_val))
    ok_acc_h = is_acc & ~equiv & (msg_bal >= acc.promised) & revote
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
    acc_new = dataclasses.replace(acc, promised=promised, acc_bal=acc_bal, acc_val=acc_val)

    # ---- Learner / safety checker (fast-quorum-aware thresholds) ----
    learner = learner_observe(
        state.learner, ok_acc, msg_bal, msg_val, state.tick, q2, fast_quorum=fquorum
    )
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

    # Phase-1 recovery fold: per-value acceptor bitmask at the highest
    # reported accepted ballot, folded over acceptors in order.
    best_bal, rep_mask = prop.best_bal, prop.rep_mask
    vids = torch.arange(n_prop, dtype=torch.int32, device=dev).view(1, n_prop, 1)
    for a in range(n_acc):
        pb = state.replies.v1[PROMISE, :, a]  # (P, I) prev-accepted ballot
        pv = state.replies.v2[PROMISE, :, a]  # (P, I) prev-accepted value
        valid = prom_ok[:, a] & (pb > 0) & (pv >= VALUE_BASE) & (pv < VALUE_BASE + n_prop)
        vid = torch.clamp(pv - VALUE_BASE, 0, n_prop - 1)
        higher = valid & (pb > best_bal)
        rep_mask = torch.where(higher[:, None], 0, rep_mask)
        best_bal = torch.where(higher, pb, best_bal)
        same = valid & (pb == best_bal)
        vhot = vid[:, None] == vids  # (P, V, I)
        rep_mask = rep_mask | torch.where(same[:, None] & vhot, 1 << a, 0).to(torch.int32)

    fast_done = (prop.phase == FAST) & (popcount(heard) >= fquorum)
    p1_done = (prop.phase == P1) & quorum_reached(heard, q1)
    p2_done = (prop.phase == P2) & quorum_reached(heard, q2)

    # Recovery value by the round kind of the highest reported ballot k.
    unheard = n_acc - popcount(heard)  # (P, I)
    cnt = popcount(rep_mask)  # (P, V, I)
    choosable = (rep_mask != 0) & (cnt + unheard[:, None] >= fquorum)
    any_ch = choosable.any(dim=1)
    pick_fast = torch.where(first_true(choosable, axis=1), vids, 0).sum(dim=1, dtype=torch.int32) + VALUE_BASE
    pick_classic = (
        torch.where(first_true(rep_mask != 0, axis=1), vids, 0).sum(dim=1, dtype=torch.int32)
        + VALUE_BASE
    )
    is_fast_k = ballot_round(best_bal) == 0
    v_fast = torch.where(any_ch, pick_fast, prop.own_val)
    v_recover = torch.where(best_bal > 0, torch.where(is_fast_k, v_fast, pick_classic), prop.own_val)

    timer = torch.where(prop.phase == DONE, prop.timer, prop.timer + 1)
    timeout, backoff = skewed_timers(masks, plan, cfg)
    expired = (prop.phase != DONE) & ~p1_done & ~p2_done & ~fast_done & (timer > timeout)
    pid = torch.arange(n_prop, dtype=torch.int32, device=dev)[:, None]
    new_bal = make_ballot(ballot_round(prop.bal) + cfg.ballot_stride, pid)

    phase = torch.where(p1_done, P2, prop.phase)
    phase = torch.where(p2_done | fast_done, DONE, phase)
    phase = torch.where(expired, P1, phase)
    prop_val = torch.where(p1_done, v_recover, prop.prop_val)
    decided_val = torch.where(p2_done, prop.prop_val, prop.decided_val)
    decided_val = torch.where(fast_done, prop.own_val, decided_val)
    bal_next = torch.where(expired, new_bal, prop.bal)
    heard = torch.where(p1_done | expired, 0, heard)
    best_bal = torch.where(expired, 0, best_bal)
    rep_mask = torch.where(expired[:, None], 0, rep_mask)
    timer = torch.where(p1_done, 0, timer)
    timer = torch.where(expired, -backoff, timer)

    # Emit: classic ACCEPT on phase-1 completion, PREPARE on retry.
    zeros = torch.zeros((n_prop, 1, n_inst), dtype=torch.int32, device=dev)
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
        rep_mask=rep_mask,
        timer=timer,
        decided_val=decided_val,
    )
    return FastPaxosState(
        acceptor=acc_new,
        proposer=prop,
        learner=learner,
        requests=requests,
        replies=replies,
        tick=state.tick + 1,
    )
