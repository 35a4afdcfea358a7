"""Multi-Paxos log replication with leader lease and leader crash
(counterpart of ``paxos_tpu/protocols/multipaxos.py``).

The single-decree tick's structure (one request per acceptor per tick,
commutative reply folds at the proposers), extended with:

- whole-log phase 1: a candidate's ``Prepare(b)`` covers every slot of the
  window, and each ``Promise(b)`` carries the acceptor's whole log, folded
  per slot by a max into the candidate's recovery array;
- slot-by-slot phase 2: the leader re-proposes from window slot 0 upward,
  adopting the highest accepted value per slot, and re-broadcasts the
  current slot's ``Accept`` every tick;
- progress leases: ``lease_len`` ticks without a newly chosen slot make a
  follower stand for election (staggered and jittered) and a leader
  demote itself;
- proposer crash windows from the plan: a crashed proposer does nothing
  and comes back as a follower.

:func:`mp_counter_masks` draws a tick's masks from the counter PRNG,
:func:`apply_tick_mp` is the transition over them, and
:func:`compact_mp_body` moves decided prefixes out of the window (long-log
mode, between chunks).  All three are plain PyTorch; the first two are the
plain version of the fused CUDA kernel ``csrc/fused_multipaxos_tick.cu``.
The gray-failure and partition knobs (``protocols.paxos.GRAY_KNOBS``) are
ported, with the pieces the single-decree ticks share, and so is the
bounded delay (``p_delay``: ``protocols.paxos.send_stamps`` on the four
sends, the readiness gates on PROMISE and ACCEPTED delivery and on the
request selection, over the ``until`` stamps of the three buffers), and
so are the observer planes (telemetry, exposure, the margin over the
per-slot tables, :func:`paxos_tpu_torch.check.mp_safety.mp_margin_observe`,
the client workload, coverage last on the post-tick state), with
Multi-Paxos' signals: four send kinds over three buffers, a candidacy
failure for a timeout, and a committed log slot to serve a client request.
Both tick functions take ``ablate`` (``protocols.paxos.ABLATE_FLAGS``), as
the single-decree ones do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paxos_tpu_torch.check.mp_safety import mp_learner_observe, mp_margin_observe
from paxos_tpu_torch.core import telemetry as tel_mod
from paxos_tpu_torch.core.ballot import ballot_round, make_ballot
from paxos_tpu_torch.core.messages import ACCEPT, PREPARE, MsgBuf
from paxos_tpu_torch.core.mp_state import (
    CANDIDATE,
    FOLLOW,
    LEAD,
    AcceptedBuf,
    MPLearnerState,
    MPProposerState,
    MultiPaxosState,
    PromiseBuf,
    bv_bal,
    bv_val,
    pack_bv,
)
from paxos_tpu_torch.core.streams import MULTI_PAXOS_STREAMS as S
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan, bits_below, links_dup
from paxos_tpu_torch.kernels import counter_prng as cp
from paxos_tpu_torch.kernels.quorum import majority, quorum_reached
from paxos_tpu_torch.obs import exposure as exp_mod
from paxos_tpu_torch.protocols.paxos import (
    check_supported,
    corrupt,
    in_block_iota,
    partition_cuts,
    recover,
    send_stamps,
    skewed_timers,
    with_coverage,
)
from paxos_tpu_torch.transport import inmemory as net
from paxos_tpu_torch.workload import generator as wload_mod


def own_slot_value(pid, slot):
    """Distinct command per (proposer, global slot), so duels are observable."""
    return (pid + 1) * 1000 + slot


@dataclasses.dataclass
class MPTickMasks:
    """One Multi-Paxos tick's randomness (instance-minor; None = off)."""

    sel_score: torch.Tensor  # (2, P, A, I) int32 request-selection entropy
    busy: Optional[torch.Tensor]  # (1, 1, A, I) bool False = acceptor idles
    dup_req: Optional[torch.Tensor]  # (2, P, A, I) bool request redelivered
    prom_deliver: Optional[torch.Tensor]  # (P, A, I) bool PROMISE not held
    accd_deliver: Optional[torch.Tensor]  # (P, A, I) bool ACCEPTED not held
    keep_prom: Optional[torch.Tensor]  # (P, A, I) bool PROMISE not dropped
    keep_accd: Optional[torch.Tensor]  # (P, A, I) bool ACCEPTED not dropped
    keep_prep: Optional[torch.Tensor]  # (P, A, I) bool PREPARE not dropped
    keep_acc: Optional[torch.Tensor]  # (P, A, I) bool ACCEPT not dropped
    jitter: torch.Tensor  # (P, I) int32 election-threshold jitter
    backoff: torch.Tensor  # (P, I) int32 post-failure retreat
    # Gray failures (None unless the knob is on).  With p_flaky > 0 the
    # keep_* and dup_req masks above are None and delivery is decided by
    # these raw bits against the plan's per-link thresholds.
    link_bits: Optional[torch.Tensor] = None  # (4, P, A, I) int32: sends of
    #   kind 0 PROMISE, 1 ACCEPTED, 2 PREPARE, 3 ACCEPT
    dup_bits: Optional[torch.Tensor] = None  # (2, P, A, I) int32 request dup
    corrupt: Optional[torch.Tensor] = None  # (A, I) bool payload perturbed
    # Bounded delay (None unless p_delay > 0), link_bits' kind axis.
    delay_bits: Optional[torch.Tensor] = None  # (4, P, A, I) int32 delay draw
    lat_bits: Optional[torch.Tensor] = None  # (4, P, A, I) int32 latency draw
    arrival_bits: Optional[torch.Tensor] = None  # (P, I) int32 client arrivals (workload)


def mp_counter_masks(
    cfg: FaultConfig, tick_seed, state: MultiPaxosState, block=None,
    ablate: frozenset = frozenset(),
) -> MPTickMasks:
    """Draw a tick's masks from the counter PRNG (``tick_seed``, ``block``
    and ``ablate`` as in
    :func:`paxos_tpu_torch.protocols.paxos.counter_masks`; "prng" also
    zeroes the election jitter).  With ``p_flaky > 0`` the uniform drop and
    duplication masks are not drawn: the per-link raw bits take their
    place.  The client arrivals are drawn where the state carries the
    workload plane."""
    check_supported(cfg, "multipaxos")
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    slot = (2, n_prop, n_acc, n_inst)
    edge = (n_prop, n_acc, n_inst)
    if "prng" in ablate:
        zeros = torch.zeros((n_prop, n_inst), dtype=torch.int32, device=state.device)
        return MPTickMasks(
            sel_score=in_block_iota(n_inst, block, state.device).expand(slot), busy=None,
            dup_req=None, prom_deliver=None, accd_deliver=None, keep_prom=None,
            keep_accd=None, keep_prep=None, keep_acc=None, jitter=zeros, backoff=zeros,
        )
    kw = dict(block=block, device=state.device)
    n_jitter = max(cfg.backoff_max, 1)
    flaky = cfg.p_flaky > 0.0

    def uniform(draw, stream, shape, p):
        return None if flaky else draw(tick_seed, S[stream], shape, p, **kw)

    return MPTickMasks(
        sel_score=cp.counter_bits(tick_seed, S["SEL"], slot, **kw),
        busy=cp.bern_not(tick_seed, S["BUSY"], (1, 1, n_acc, n_inst), cfg.p_idle, **kw),
        dup_req=uniform(cp.bern, "DUP_REQ", slot, cfg.p_dup),
        prom_deliver=cp.bern_not(tick_seed, S["PROM_DELIVER"], edge, cfg.p_hold, **kw),
        accd_deliver=cp.bern_not(tick_seed, S["ACCD_DELIVER"], edge, cfg.p_hold, **kw),
        keep_prom=uniform(cp.bern_not, "KEEP_PROM", edge, cfg.p_drop),
        keep_accd=uniform(cp.bern_not, "KEEP_ACCD", edge, cfg.p_drop),
        keep_prep=uniform(cp.bern_not, "KEEP_PREP", edge, cfg.p_drop),
        keep_acc=uniform(cp.bern_not, "KEEP_ACC", edge, cfg.p_drop),
        jitter=cp.randint(tick_seed, S["JITTER"], (n_prop, n_inst), n_jitter, **kw),
        backoff=cp.randint(tick_seed, S["BACKOFF"], (n_prop, n_inst), 2 * n_jitter, **kw),
        link_bits=(
            cp.counter_bits(tick_seed, S["LINK_BITS"], (4,) + edge, **kw) if flaky else None
        ),
        dup_bits=cp.counter_bits(tick_seed, S["DUP_BITS"], slot, **kw) if links_dup(cfg) else None,
        corrupt=cp.bern(tick_seed, S["CORRUPT"], (n_acc, n_inst), cfg.p_corrupt, **kw),
        delay_bits=(
            cp.counter_bits(tick_seed, S["DELAY_BITS"], (4,) + edge, **kw)
            if cfg.p_delay > 0.0 else None
        ),
        lat_bits=(
            cp.counter_bits(tick_seed, S["LAT_BITS"], (4,) + edge, **kw)
            if cfg.p_delay > 0.0 else None
        ),
        arrival_bits=(
            cp.counter_bits(tick_seed, S["ARRIVAL"], (n_prop, n_inst), **kw)
            if state.wload is not None else None
        ),
    )


def _stamped(until: Optional[torch.Tensor], sent: torch.Tensor, stamps: Optional[torch.Tensor]):
    """A buffer's ``until`` after a send ``sent`` (P, A, I) stamped with
    ``stamps`` (0, deliverable at once, where delay is off); None for a
    buffer without stamps."""
    if until is None:
        return None
    return torch.where(sent, 0 if stamps is None else stamps, until)


def _and(mask: torch.Tensor, other: Optional[torch.Tensor]) -> torch.Tensor:
    return mask if other is None else mask & other


def apply_tick_mp(
    state: MultiPaxosState, masks: MPTickMasks, plan: FaultPlan, cfg: FaultConfig,
    ablate: frozenset = frozenset(),
) -> MultiPaxosState:
    """The Multi-Paxos transition for one tick over pre-sampled masks.

    ``ablate`` removes components as in
    :func:`paxos_tpu_torch.protocols.paxos.apply_tick`; without the learner
    the proposers read a chosen count of 0, as the reference's ablated tick
    gives them."""
    check_supported(cfg, "multipaxos")
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    n_slots = state.log_len
    quorum = majority(n_acc)
    dev = state.device
    i32 = torch.int32

    prop = state.proposer
    alive = plan.alive(state.tick)  # (A, I)
    p_alive = plan.prop_alive(state.tick)  # (P, I)
    equiv = plan.equivocate  # (A, I)
    # Stale-snapshot recovery or amnesia of promised and the whole slot log.
    acc = recover(state.acceptor, state, plan, cfg)

    # ---- Link faults: partition cuts, and per-link loss and duplication
    #      on flaky links (kinds 0 PROMISE, 1 ACCEPTED, 2 PREPARE, 3
    #      ACCEPT) in place of the uniform masks ----
    link_req, link_rep = partition_cuts(plan, cfg, state.tick)
    if cfg.p_flaky > 0.0:
        keep_prom, keep_accd, keep_prep, keep_acc = (
            ~bits_below(masks.link_bits[k], plan.link_drop) for k in range(4)
        )
        dup_req = None
        if masks.dup_bits is not None:
            dup_req = bits_below(masks.dup_bits, plan.link_dup[None])
    else:
        keep_prom, keep_accd = masks.keep_prom, masks.keep_accd
        keep_prep, keep_acc, dup_req = masks.keep_prep, masks.keep_acc, masks.dup_req

    # ---- Bounded delay: this tick's send stamps (kinds 0 PROMISE, 1
    #      ACCEPTED, 2 PREPARE, 3 ACCEPT) ----
    stamps = None
    if cfg.p_delay > 0.0:
        stamps = send_stamps(masks.delay_bits, masks.lat_bits, plan, cfg, state.tick)

    def kind(k):
        return None if stamps is None else stamps[k]

    # ---- Reply delivery decided and cleared before any new send; a reply
    #      still delayed, or on a cut link, stays in flight ----
    prom_del = _and(_and(state.promises.present, masks.prom_deliver), net.ready(state.promises, state.tick))
    accd_del = _and(_and(state.accepted.present, masks.accd_deliver), net.ready(state.accepted, state.tick))
    prom_del, accd_del = _and(prom_del, link_rep), _and(accd_del, link_rep)
    if "consume" in ablate:
        promises, accepted = state.promises, state.accepted
    else:
        promises = dataclasses.replace(state.promises, present=state.promises.present & ~prom_del)
        accepted = dataclasses.replace(state.accepted, present=state.accepted.present & ~accd_del)

    # ---- Acceptor half-tick over the requests that have arrived; a cut
    #      link's requests stay in flight ----
    if "select" in ablate:
        sel = torch.zeros_like(state.requests.present)
    else:
        req_present = _and(state.requests.present, net.ready(state.requests, state.tick))
        sel = net.select_from_scores(req_present, masks.sel_score, masks.busy)
        sel = sel & alive[None, None]
        if link_req is not None:
            sel = sel & link_req[None]

    def gather(x):
        return torch.where(sel, x, 0).sum(dim=(0, 1), dtype=i32)

    msg_bal = gather(state.requests.bal)  # (A, I)
    msg_val = gather(state.requests.v1)
    msg_slot = gather(state.requests.v2)
    is_prep = sel[PREPARE].any(dim=0)
    is_acc = sel[ACCEPT].any(dim=0)
    msg_bal, msg_val = corrupt(masks, cfg, msg_bal, msg_val, is_prep, is_acc)

    ok_prep_h = is_prep & ~equiv & (msg_bal > acc.promised)
    ok_prep = ok_prep_h | (is_prep & equiv)
    ok_acc_h = is_acc & ~equiv & (msg_bal >= acc.promised)
    ok_acc = ok_acc_h | (is_acc & equiv)

    promised = torch.where(ok_prep_h, msg_bal, acc.promised)
    promised = torch.where(ok_acc_h, torch.maximum(promised, msg_bal), promised)
    slot_ids = torch.arange(n_slots, dtype=i32, device=dev)[None, :, None]  # (1, L, 1)
    wr = ok_acc[:, None] & (msg_slot[:, None] == slot_ids)  # (A, L, I)
    log = torch.where(wr, pack_bv(msg_bal, msg_val)[:, None], acc.log)

    # PROMISE carries the log as it stood before this tick's accept write;
    # equivocators send a zeroed payload.
    if "sends" not in ablate:
        prom_send = _and(sel[PREPARE] & ok_prep[None], keep_prom)  # (P, A, I)
        payload_bv = torch.where(equiv[:, None], 0, acc.log)  # (A, L, I)
        promises = PromiseBuf(
            present=promises.present | prom_send,
            bal=torch.where(prom_send, msg_bal[None], promises.bal),
            p_bv=torch.where(prom_send[:, :, None], payload_bv[None], promises.p_bv),
            until=_stamped(promises.until, prom_send, kind(0)),
        )
        accd_send = _and(sel[ACCEPT] & ok_acc[None], keep_accd)
        accepted = AcceptedBuf(
            present=accepted.present | accd_send,
            bal=torch.where(accd_send, msg_bal[None], accepted.bal),
            slot=torch.where(accd_send, msg_slot[None], accepted.slot),
            val=torch.where(accd_send, msg_val[None], accepted.val),
            until=_stamped(accepted.until, accd_send, kind(1)),
        )
    if "consume" in ablate:
        requests = state.requests
    else:
        requests = net.consume(state.requests, sel, stay=dup_req)
    acc = dataclasses.replace(acc, promised=promised, log=log)

    # ---- Learner / checker ----
    if "learner" in ablate:
        learner = state.learner
        chosen_count = torch.zeros((n_inst,), dtype=i32, device=dev)
    else:
        learner = mp_learner_observe(
            state.learner, ok_acc, msg_bal, msg_slot, msg_val, state.tick, quorum
        )
        chosen_count = learner.chosen.sum(dim=0, dtype=i32)  # (I,), of the new learner
    if "proposer" in ablate:
        return dataclasses.replace(
            state, acceptor=acc, learner=learner, requests=requests, promises=promises,
            accepted=accepted, tick=state.tick + 1,
        )

    # ---- Proposer half-tick ----
    bits = (1 << torch.arange(n_acc, dtype=i32, device=dev)).view(1, n_acc, 1)
    cur_bal = prop.bal[:, None]  # (P, 1, I)
    pv_ok = prom_del & (state.promises.bal == cur_bal) & (prop.phase == CANDIDATE)[:, None]
    heard = prop.heard | torch.where(pv_ok, bits, 0).sum(dim=1, dtype=i32)
    cand_bv = torch.where(pv_ok[:, :, None], state.promises.p_bv, 0).amax(dim=1)  # (P, L, I)
    recov_bv = torch.maximum(prop.recov_bv, cand_bv)
    av_ok = (
        accd_del
        & (state.accepted.bal == cur_bal)
        & (state.accepted.slot == prop.commit_idx[:, None])
        & (prop.phase == LEAD)[:, None]
    )
    heard = heard | torch.where(av_ok, bits, 0).sum(dim=1, dtype=i32)

    p1_done = (prop.phase == CANDIDATE) & quorum_reached(heard, quorum)
    slot_done = (prop.phase == LEAD) & quorum_reached(heard, quorum) & (prop.commit_idx < n_slots)

    # Progress lease: a newly chosen slot resets every proposer's timer.
    progressed = chosen_count[None] > prop.last_chosen_count
    lease_timer = torch.where(progressed, 0, prop.lease_timer + 1)
    last_chosen_count = torch.maximum(prop.last_chosen_count, chosen_count[None])

    log_full = chosen_count[None] >= n_slots  # (1, I)
    if cfg.log_total:
        # Long-log mode: the global log is also exhausted once the compacted
        # prefix plus the window's chosen slots reach log_total.
        log_full = log_full | ((state.base + chosen_count)[None] >= cfg.log_total)
    lease_out = lease_timer > cfg.lease_len

    pid = torch.arange(n_prop, dtype=i32, device=dev)[:, None].expand_as(prop.bal)
    start_elec = (
        (prop.phase == FOLLOW)
        & p_alive
        & ~log_full
        & (lease_timer > cfg.lease_len + pid * 3 + masks.jitter)
    )
    new_bal = make_ballot(ballot_round(prop.bal) + cfg.ballot_stride, pid)

    timeout, backoff = skewed_timers(masks, plan, cfg)
    candidate_timer = torch.where(prop.phase == CANDIDATE, prop.candidate_timer + 1, 0)
    cand_fail = (prop.phase == CANDIDATE) & (candidate_timer > timeout) & ~p1_done
    # Exposure: a skewed timeout is effective where the candidacy-failure
    # decision differs from the unskewed deadline's (before the timer resets).
    timeout_delta = None
    if state.exposure is not None and cfg.timeout_skew > 0:
        timeout_delta = cand_fail ^ (
            (prop.phase == CANDIDATE) & (candidate_timer > cfg.timeout) & ~p1_done
        )
    demote = (prop.phase == LEAD) & lease_out & ~slot_done & ~log_full

    # Phase writes in precedence order: the last one wins.
    phase = torch.where(start_elec, CANDIDATE, prop.phase)
    phase = torch.where(p1_done, LEAD, phase)
    phase = torch.where(cand_fail | demote, FOLLOW, phase)
    phase = torch.where(~p_alive, FOLLOW, phase)  # crashed -> follower on recovery

    bal_next = torch.where(start_elec, new_bal, prop.bal)
    commit_idx = torch.where(p1_done, 0, prop.commit_idx)
    commit_idx = torch.where(slot_done, commit_idx + 1, commit_idx)
    heard = torch.where(p1_done | slot_done | start_elec | cand_fail | demote, 0, heard)
    recov_bv = torch.where(start_elec[:, None], 0, recov_bv)
    lease_timer = torch.where(start_elec | p1_done | slot_done, 0, lease_timer)
    # A failed candidacy or demotion retreats below the election threshold
    # by a random backoff (the timer may go negative).
    lease_timer = torch.where(cand_fail | demote, cfg.lease_len - backoff, lease_timer)
    candidate_timer = torch.where(start_elec, 0, candidate_timer)

    # ---- Emit: new candidates broadcast Prepare(b) once ----
    edge = (n_prop, n_acc, n_inst)
    zeros = torch.zeros((n_prop, 1, n_inst), dtype=i32, device=dev)
    prep_mask = (start_elec & p_alive)[:, None].expand(edge)
    if "sends" not in ablate:
        requests = net.send(
            requests, PREPARE,
            send_mask=prep_mask,
            bal=bal_next[:, None], v1=zeros, v2=zeros, keep=keep_prep, until=kind(2),
        )
    # Leaders re-broadcast the current slot's Accept every tick.
    is_lead = (phase == LEAD) & p_alive & (commit_idx < n_slots)
    if cfg.log_total:
        # Never drive a slot past the global log end.
        is_lead = is_lead & (state.base[None] + commit_idx < cfg.log_total)
    ci = torch.clamp(commit_idx, max=n_slots - 1)  # (P, I)
    ci_hot = ci[:, None] == torch.arange(n_slots, dtype=i32, device=dev)[None, :, None]
    rbv = torch.where(ci_hot, recov_bv, 0).sum(dim=1, dtype=i32)  # (P, I) packed
    # Commands are keyed by global slot (base + window index).
    pval = torch.where(rbv > 0, bv_val(rbv), own_slot_value(pid, state.base[None] + ci))
    if "sends" not in ablate:
        requests = net.send(
            requests, ACCEPT,
            send_mask=is_lead[:, None].expand(edge),
            bal=bal_next[:, None], v1=pval[:, None], v2=ci[:, None], keep=keep_acc,
            until=kind(3),
        )

    prop = MPProposerState(
        bal=bal_next,
        phase=phase,
        heard=heard,
        commit_idx=commit_idx,
        recov_bv=recov_bv,
        lease_timer=lease_timer,
        last_chosen_count=last_chosen_count,
        candidate_timer=candidate_timer,
    )
    # ---- Observers: from signals the tick already produced. ----
    planes = _observer_planes(
        state, masks, plan, cfg, learner, acc, ~equiv, quorum,
        sel=sel, kinds=(is_prep, is_acc), promise=ok_prep, accept=ok_acc,
        sends=(sel[PREPARE] & ok_prep[None], sel[ACCEPT] & ok_acc[None], prep_mask,
               is_lead[:, None].expand(edge)),
        keeps=(keep_prom, keep_accd, keep_prep, keep_acc), dup_req=dup_req,
        links=(link_req, link_rep), leader=p1_done | demote, timeout=cand_fail,
        serve=slot_done, timeout_delta=timeout_delta, stamps=stamps,
    )
    return with_coverage(MultiPaxosState(
        acceptor=acc,
        proposer=prop,
        learner=learner,
        requests=requests,
        promises=promises,
        accepted=accepted,
        tick=state.tick + 1,
        base=state.base,
        coverage=state.coverage,
        **planes,
    ))


def _observer_planes(
    state: MultiPaxosState, masks: MPTickMasks, plan: FaultPlan, cfg: FaultConfig, learner,
    acc, honest, quorum: int, *, sel, kinds: tuple, promise, accept, sends: tuple, keeps: tuple,
    dup_req, links: tuple, leader, timeout, serve, timeout_delta, stamps,
) -> dict:
    """The observer planes of a Multi-Paxos tick (all but coverage, which
    hashes the post-tick state: ``with_coverage``), each None where the
    state carries none, from the tick's own signals: ``sends``, the four
    send kinds' masks (P, A, I), PROMISE, ACCEPTED, PREPARE and ACCEPT,
    which ``keeps`` (keep_prom, keep_accd, keep_prep, keep_acc) decide; the
    requests selected (``sel``), the only kind that ``dup_req`` duplicates;
    the partition's per-direction ``links``; telemetry's events; the
    proposers whose committed slot serves a queued client request
    (``serve``); the post-tick acceptors ``acc``, whose highest accepted
    ballot over the log partners the promise fence in the margin; exposure's
    skewed-timeout delta; this tick's send ``stamps`` (None without
    delay).  They draw nothing but the workload's arrivals."""
    tel, exp = state.telemetry, state.exposure
    lc = tel_mod.lane_count
    dropped = dups = None
    if keeps[0] is not None:
        dropped = sum(lc(m & ~k) for m, k in zip(sends, keeps))
    if dup_req is not None:
        dups = lc(sel & dup_req)
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
        events = {}
        if keeps[0] is not None:
            events["drop"] = (sum(lc(~k) for k in keeps), dropped)
        if dup_req is not None:
            events["dup"] = (lc(dup_req), dups)
        if cfg.p_corrupt > 0.0:
            events["corrupt"] = (masks.corrupt, effective_corrupt)
        link_req, link_rep = links
        if link_req is not None:  # the cut stalled what was in flight
            events["partition"] = (
                lc(~link_req) + lc(~link_rep),
                lc(state.requests.present & ~link_req[None])
                + lc(state.promises.present & ~link_rep)
                + lc(state.accepted.present & ~link_rep),
            )
        if timeout_delta is not None:
            events["timeout"] = (plan.ptimeout != 0, timeout_delta)
        if cfg.stale_k > 0:  # every restore rewrites durable state
            rec = plan.recovering(state.tick)
            events["stale"] = (rec, rec)
        if stamps is not None:  # delays drawn; messages stalled behind their stamp
            events["delay"] = (
                lc(stamps > 0),
                sum(
                    lc(buf.present & ~net.ready(buf, state.tick))
                    for buf in (state.requests, state.promises, state.accepted)
                ),
            )
        exp = exp_mod.record(exp, **events)
    mar = state.margin
    if mar is not None:
        mar = mp_margin_observe(
            mar, state.learner, learner, acc.promised, bv_bal(acc.log).amax(dim=1), honest, quorum,
        )
    wl = state.wload
    if wl is not None:  # a leader's committed slot serves one queued request
        wl = wload_mod.observe(wl, state.tick, serve=serve, arrival_bits=masks.arrival_bits)
    return dict(telemetry=tel, exposure=exp, margin=mar, wload=wl)


# ---- Decided-prefix compaction (long-log mode) ----


def _shift_slots(x: torch.Tensor, shift: torch.Tensor, dim: int, fill=0) -> torch.Tensor:
    """Shift the log-slot dimension ``dim`` of ``x`` down by a per-instance
    ``shift`` (I,), filling the vacated tail with ``fill``: a shift, not a
    roll (compacted slots are gone)."""
    n = x.shape[dim]
    view = [1] * x.dim()
    view[dim] = n
    src = torch.arange(n, dtype=torch.int64, device=x.device).view(view) + shift.to(torch.int64)
    got = torch.gather(x, dim, src.clamp(max=n - 1).expand_as(x))
    return torch.where(src < n, got, torch.full_like(x, fill))


def compact_mp_body(state: MultiPaxosState):
    """Compact each instance's contiguous chosen prefix out of the window.

    Returns ``(state', shift, evicted_vals)``: ``shift`` (I,) is the prefix
    length removed, ``evicted_vals`` (L, I) the removed slots' chosen values
    (rows ``l < shift``), and ``state'`` has every slot-indexed array
    shifted down with ``base += shift``.  In-flight ACCEPTs and ACCEPTEDs
    re-base their slot (those for compacted slots drop), in-flight PROMISEs
    drop unless the shift is 0, and a leader whose slot was compacted under
    it forgets its ACCEPTED votes.  The input is not modified."""
    lrn, prop, acc = state.learner, state.proposer, state.acceptor
    n_slots = state.log_len
    shift = torch.cumprod(lrn.chosen.to(torch.int32), dim=0).sum(dim=0, dtype=torch.int32)
    sl = torch.arange(n_slots, dtype=torch.int32, device=state.device)[:, None]
    evicted = torch.where(sl < shift, lrn.chosen_val, 0)

    def dec(x):  # window-relative cursors move down with the window
        return torch.clamp(x - shift[None], min=0)

    req = state.requests
    acc_slot = req.v2[ACCEPT] - shift[None, None]
    v2 = req.v2.clone()
    v2[ACCEPT] = acc_slot
    present = req.present.clone()
    present[ACCEPT] = req.present[ACCEPT] & (acc_slot >= 0)
    accd_slot = state.accepted.slot - shift[None, None]

    # The observer planes pass through unchanged.
    out = dataclasses.replace(
        state,
        acceptor=dataclasses.replace(acc, log=_shift_slots(acc.log, shift, 1)),
        proposer=dataclasses.replace(
            prop,
            commit_idx=dec(prop.commit_idx),
            last_chosen_count=dec(prop.last_chosen_count),
            recov_bv=_shift_slots(prop.recov_bv, shift, 1),
            heard=torch.where(
                (prop.phase == LEAD) & (shift[None] > prop.commit_idx), 0, prop.heard
            ),
        ),
        learner=MPLearnerState(
            lt_bv=_shift_slots(lrn.lt_bv, shift, 0),
            lt_mask=_shift_slots(lrn.lt_mask, shift, 0),
            chosen=_shift_slots(lrn.chosen, shift, 0, fill=False),
            chosen_val=_shift_slots(lrn.chosen_val, shift, 0),
            chosen_tick=_shift_slots(lrn.chosen_tick, shift, 0, fill=-1),
            violations=lrn.violations,
            evictions=lrn.evictions,
        ),
        requests=MsgBuf(bal=req.bal, v1=req.v1, v2=v2, present=present, until=req.until),
        promises=dataclasses.replace(
            state.promises, present=state.promises.present & (shift == 0)
        ),
        accepted=dataclasses.replace(
            state.accepted, slot=accd_slot, present=state.accepted.present & (accd_slot >= 0)
        ),
        base=state.base + shift,
    )
    return out, shift, evicted
