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
The observer planes and the gray, delay, stale-snapshot and amnesia knobs
are not ported (:func:`paxos_tpu_torch.protocols.paxos.check_supported`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paxos_tpu_torch.check.mp_safety import mp_learner_observe
from paxos_tpu_torch.core.ballot import ballot_round, make_ballot
from paxos_tpu_torch.core.messages import ACCEPT, PREPARE, MsgBuf
from paxos_tpu_torch.core.mp_state import (
    CANDIDATE,
    FOLLOW,
    LEAD,
    AcceptedBuf,
    MPAcceptorState,
    MPLearnerState,
    MPProposerState,
    MultiPaxosState,
    PromiseBuf,
    bv_val,
    pack_bv,
)
from paxos_tpu_torch.core.streams import MULTI_PAXOS_STREAMS as S
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan
from paxos_tpu_torch.kernels import counter_prng as cp
from paxos_tpu_torch.kernels.quorum import majority, quorum_reached
from paxos_tpu_torch.protocols.paxos import check_supported
from paxos_tpu_torch.transport import inmemory as net


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


def mp_counter_masks(cfg: FaultConfig, tick_seed, state: MultiPaxosState, block=None) -> MPTickMasks:
    """Draw a tick's masks from the counter PRNG (``tick_seed`` and
    ``block`` as in :func:`paxos_tpu_torch.protocols.paxos.counter_masks`)."""
    check_supported(cfg, "multipaxos")
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    slot = (2, n_prop, n_acc, n_inst)
    edge = (n_prop, n_acc, n_inst)
    kw = dict(block=block, device=state.device)
    n_jitter = max(cfg.backoff_max, 1)
    return MPTickMasks(
        sel_score=cp.counter_bits(tick_seed, S["SEL"], slot, **kw),
        busy=cp.bern_not(tick_seed, S["BUSY"], (1, 1, n_acc, n_inst), cfg.p_idle, **kw),
        dup_req=cp.bern(tick_seed, S["DUP_REQ"], slot, cfg.p_dup, **kw),
        prom_deliver=cp.bern_not(tick_seed, S["PROM_DELIVER"], edge, cfg.p_hold, **kw),
        accd_deliver=cp.bern_not(tick_seed, S["ACCD_DELIVER"], edge, cfg.p_hold, **kw),
        keep_prom=cp.bern_not(tick_seed, S["KEEP_PROM"], edge, cfg.p_drop, **kw),
        keep_accd=cp.bern_not(tick_seed, S["KEEP_ACCD"], edge, cfg.p_drop, **kw),
        keep_prep=cp.bern_not(tick_seed, S["KEEP_PREP"], edge, cfg.p_drop, **kw),
        keep_acc=cp.bern_not(tick_seed, S["KEEP_ACC"], edge, cfg.p_drop, **kw),
        jitter=cp.randint(tick_seed, S["JITTER"], (n_prop, n_inst), n_jitter, **kw),
        backoff=cp.randint(tick_seed, S["BACKOFF"], (n_prop, n_inst), 2 * n_jitter, **kw),
    )


def _and(mask: torch.Tensor, other: Optional[torch.Tensor]) -> torch.Tensor:
    return mask if other is None else mask & other


def apply_tick_mp(
    state: MultiPaxosState, masks: MPTickMasks, plan: FaultPlan, cfg: FaultConfig
) -> MultiPaxosState:
    """The Multi-Paxos transition for one tick over pre-sampled masks."""
    check_supported(cfg, "multipaxos")
    n_acc, n_inst = state.acceptor.promised.shape
    n_prop = state.proposer.bal.shape[0]
    n_slots = state.log_len
    quorum = majority(n_acc)
    dev = state.device
    i32 = torch.int32

    acc, prop = state.acceptor, state.proposer
    alive = plan.alive(state.tick)  # (A, I)
    p_alive = plan.prop_alive(state.tick)  # (P, I)
    equiv = plan.equivocate  # (A, I)

    # ---- Reply delivery decided and cleared before any new send ----
    prom_del = _and(state.promises.present, masks.prom_deliver)
    accd_del = _and(state.accepted.present, masks.accd_deliver)
    promises = dataclasses.replace(state.promises, present=state.promises.present & ~prom_del)
    accepted = dataclasses.replace(state.accepted, present=state.accepted.present & ~accd_del)

    # ---- Acceptor half-tick ----
    sel = net.select_from_scores(state.requests.present, masks.sel_score, masks.busy)
    sel = sel & alive[None, None]

    def gather(x):
        return torch.where(sel, x, 0).sum(dim=(0, 1), dtype=i32)

    msg_bal = gather(state.requests.bal)  # (A, I)
    msg_val = gather(state.requests.v1)
    msg_slot = gather(state.requests.v2)
    is_prep = sel[PREPARE].any(dim=0)
    is_acc = sel[ACCEPT].any(dim=0)

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
    prom_send = _and(sel[PREPARE] & ok_prep[None], masks.keep_prom)  # (P, A, I)
    payload_bv = torch.where(equiv[:, None], 0, acc.log)  # (A, L, I)
    promises = PromiseBuf(
        present=promises.present | prom_send,
        bal=torch.where(prom_send, msg_bal[None], promises.bal),
        p_bv=torch.where(prom_send[:, :, None], payload_bv[None], promises.p_bv),
    )
    accd_send = _and(sel[ACCEPT] & ok_acc[None], masks.keep_accd)
    accepted = AcceptedBuf(
        present=accepted.present | accd_send,
        bal=torch.where(accd_send, msg_bal[None], accepted.bal),
        slot=torch.where(accd_send, msg_slot[None], accepted.slot),
        val=torch.where(accd_send, msg_val[None], accepted.val),
    )
    requests = net.consume(state.requests, sel, stay=masks.dup_req)
    acc = MPAcceptorState(promised=promised, log=log)

    # ---- Learner / checker ----
    learner = mp_learner_observe(
        state.learner, ok_acc, msg_bal, msg_slot, msg_val, state.tick, quorum
    )
    chosen_count = learner.chosen.sum(dim=0, dtype=i32)  # (I,), of the new learner

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

    candidate_timer = torch.where(prop.phase == CANDIDATE, prop.candidate_timer + 1, 0)
    cand_fail = (prop.phase == CANDIDATE) & (candidate_timer > cfg.timeout) & ~p1_done
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
    lease_timer = torch.where(cand_fail | demote, cfg.lease_len - masks.backoff, lease_timer)
    candidate_timer = torch.where(start_elec, 0, candidate_timer)

    # ---- Emit: new candidates broadcast Prepare(b) once ----
    edge = (n_prop, n_acc, n_inst)
    zeros = torch.zeros((n_prop, 1, n_inst), dtype=i32, device=dev)
    requests = net.send(
        requests, PREPARE,
        send_mask=(start_elec & p_alive)[:, None].expand(edge),
        bal=bal_next[:, None], v1=zeros, v2=zeros, keep=masks.keep_prep,
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
    requests = net.send(
        requests, ACCEPT,
        send_mask=is_lead[:, None].expand(edge),
        bal=bal_next[:, None], v1=pval[:, None], v2=ci[:, None], keep=masks.keep_acc,
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
    return MultiPaxosState(
        acceptor=acc,
        proposer=prop,
        learner=learner,
        requests=requests,
        promises=promises,
        accepted=accepted,
        tick=state.tick + 1,
        base=state.base,
    )


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

    out = MultiPaxosState(
        acceptor=MPAcceptorState(promised=acc.promised, log=_shift_slots(acc.log, shift, 1)),
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
        requests=MsgBuf(bal=req.bal, v1=req.v1, v2=v2, present=present),
        promises=dataclasses.replace(
            state.promises, present=state.promises.present & (shift == 0)
        ),
        accepted=dataclasses.replace(
            state.accepted, slot=accd_slot, present=state.accepted.present & (accd_slot >= 0)
        ),
        tick=state.tick,
        base=state.base + shift,
    )
    return out, shift, evicted
