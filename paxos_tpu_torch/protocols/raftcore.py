"""Raft-core tick (counterpart of ``paxos_tpu/protocols/raftcore.py``).

Leader election with the log-comparison election restriction, then
append/ack replication of one log entry, over the same masks, transport
and fault machinery as single-decree Paxos.  Mask roles map onto Paxos'
``TickMasks`` fields: keep_prom -> VOTE, keep_accd -> ACK, keep_p1 ->
REQVOTE, keep_p2 -> APPEND.  All quorums are majorities (``q1``/``q2`` do
not apply).  The gray-failure and partition arms are the Paxos tick's,
through the pieces the three ticks share: stale recovery restores the
voters' (voted, entry term, entry value), and corruption flips an APPEND's
value and moves a REQVOTE's term up one.  Observer planes and unported
knobs are absent, as in the Paxos tick.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.check.safety import learner_observe, raft_voter_invariants
from paxos_tpu_torch.core.ballot import ballot_round, make_ballot
from paxos_tpu_torch.core.raft_state import (
    ACK,
    APPEND,
    CAND,
    DONE,
    LEAD,
    REQVOTE,
    VOTE,
    RaftState,
)
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan
from paxos_tpu_torch.kernels.quorum import majority, quorum_reached
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


def apply_tick_raft(
    state: RaftState, masks: TickMasks, plan: FaultPlan, cfg: FaultConfig
) -> RaftState:
    """The pure Raft-core transition for one tick over pre-sampled masks."""
    check_supported(cfg, "raftcore")
    check_no_stamps(state, "raftcore")
    n_acc, n_inst = state.acceptor.voted.shape
    n_prop = state.proposer.bal.shape[0]
    quorum = majority(n_acc)
    dev = state.device

    equiv = plan.equivocate  # (A, I)
    voter = recover(state.acceptor, state, plan, cfg)
    links = gray_links(masks, plan, cfg, state.tick)
    delivered, replies = deliver(state, masks, links)

    # ---- Voter half-tick: select one request per (instance, voter) ----
    sel = select(state, masks, plan, links)

    def gather(x):
        return torch.where(sel, x, 0).sum(dim=(0, 1), dtype=torch.int32)

    msg_bal = gather(state.requests.bal)  # (A, I)
    msg_v1 = gather(state.requests.v1)  # (A, I): REQVOTE cand_last / APPEND value
    is_rv = sel[REQVOTE].any(dim=0)
    is_ap = sel[APPEND].any(dim=0)
    msg_bal, msg_v1 = corrupt(masks, cfg, msg_bal, msg_v1, is_rv, is_ap)

    # RequestVote: one vote per term + election restriction.  Equivocators
    # grant everything and hide their entry.
    grant_h = is_rv & ~equiv & (msg_bal > voter.voted) & (msg_v1 >= voter.ent_term)
    grant = grant_h | (is_rv & equiv)
    # AppendEntries: accept from any term not below the vote fence.
    ok_ap_h = is_ap & ~equiv & (msg_bal >= voter.voted)
    ok_ap = ok_ap_h | (is_ap & equiv)

    voted = torch.where(grant_h, msg_bal, voter.voted)
    voted = torch.where(ok_ap_h, torch.maximum(voted, msg_bal), voted)
    ent_term = torch.where(ok_ap, msg_bal, voter.ent_term)
    ent_val = torch.where(ok_ap, msg_v1, voter.ent_val)

    # Vote replies go to every solicitor (grant or denial), carrying the
    # voter's pre-update entry: 2 * ent_term + granted, entry value.
    vote_payload_t = torch.where(equiv, 0, voter.ent_term)
    vote_payload_v = torch.where(equiv, 0, voter.ent_val)
    replies = net.send(
        replies, VOTE,
        send_mask=sel[REQVOTE],
        bal=msg_bal[None],
        v1=(vote_payload_t * 2 + grant.to(torch.int32))[None],
        v2=vote_payload_v[None],
        keep=links.keep_prom,
    )
    replies = net.send(
        replies, ACK,
        send_mask=sel[APPEND] & ok_ap[None],
        bal=msg_bal[None], v1=msg_v1[None], v2=torch.zeros_like(msg_v1)[None],
        keep=links.keep_accd,
    )
    requests = net.consume(state.requests, sel, stay=links.dup_req)
    voter_new = dataclasses.replace(voter, voted=voted, ent_term=ent_term, ent_val=ent_val)

    # ---- Learner / safety checker (append-accept events, majority commit) ----
    learner = learner_observe(state.learner, ok_ap, msg_bal, msg_v1, state.tick, quorum)
    inv_viol = raft_voter_invariants(voter, voter_new, honest=~equiv)
    learner = dataclasses.replace(learner, violations=learner.violations + inv_viol)

    # ---- Candidate half-tick: fold all delivered replies ----
    cand = state.proposer
    bits = (1 << torch.arange(n_acc, dtype=torch.int32, device=dev)).view(1, n_acc, 1)
    cur_bal = cand.bal[:, None]  # (P, 1, I)
    vote_v1 = state.replies.v1[VOTE]
    vote_ok = (
        delivered[VOTE]
        & (state.replies.bal[VOTE] == cur_bal)
        & (cand.phase == CAND)[:, None]
    )  # (P, A, I)
    granted = vote_ok & (torch.remainder(vote_v1, 2) == 1)
    ack_ok = (
        delivered[ACK]
        & (state.replies.bal[ACK] == cur_bal)
        & (cand.phase == LEAD)[:, None]
    )
    heard = (
        cand.heard
        | torch.where(granted, bits, 0).sum(dim=1, dtype=torch.int32)
        | torch.where(ack_ok, bits, 0).sum(dim=1, dtype=torch.int32)
    )

    # Adopt the highest-term entry among vote replies (grants and denials);
    # the value rides along by a max, and a zero max never upgrades.
    rep_t = torch.where(vote_ok, torch.div(vote_v1, 2, rounding_mode="floor"), 0)
    cand_t = rep_t.amax(dim=1)  # (P, I)
    cand_v = torch.where(
        (rep_t == cand_t[:, None]) & vote_ok, state.replies.v2[VOTE], 0
    ).amax(dim=1)
    upgrade = cand_t > cand.ent_term
    ent_term_c = torch.where(upgrade, cand_t, cand.ent_term)
    ent_val_c = torch.where(upgrade, cand_v, cand.ent_val)

    elected = (cand.phase == CAND) & quorum_reached(heard, quorum)
    committed = (cand.phase == LEAD) & quorum_reached(heard, quorum)

    timer = torch.where(cand.phase == DONE, cand.timer, cand.timer + 1)
    timeout, backoff = skewed_timers(masks, plan, cfg)
    expired = (cand.phase != DONE) & ~elected & ~committed & (timer > timeout)
    pid = torch.arange(n_prop, dtype=torch.int32, device=dev)[:, None]
    new_bal = make_ballot(ballot_round(cand.bal) + cfg.ballot_stride, pid)

    # A new leader proposes its adopted entry if it has one, else its own
    # value, and records that proposal as its own entry at its term.
    v_lead = torch.where(ent_term_c > 0, ent_val_c, cand.own_val)
    phase = torch.where(elected, LEAD, cand.phase)
    phase = torch.where(committed, DONE, phase)
    phase = torch.where(expired, CAND, phase)
    prop_val = torch.where(elected, v_lead, cand.prop_val)
    decided_val = torch.where(committed, cand.prop_val, cand.decided_val)
    ent_term_c = torch.where(elected, cand.bal, ent_term_c)
    ent_val_c = torch.where(elected, v_lead, ent_val_c)
    bal_next = torch.where(expired, new_bal, cand.bal)
    heard = torch.where(elected | expired, 0, heard)
    timer = torch.where(elected, 0, timer)
    timer = torch.where(expired, -backoff, timer)

    # Emit: leaders re-broadcast AppendEntries every tick; expired
    # candidates broadcast RequestVote at the next term with their entry term.
    zeros = torch.zeros((n_prop, 1, n_inst), dtype=torch.int32, device=dev)
    requests = net.send(
        requests, APPEND,
        send_mask=(phase == LEAD)[:, None].expand(n_prop, n_acc, n_inst),
        bal=bal_next[:, None], v1=prop_val[:, None], v2=zeros,
        keep=links.keep_p2,
    )
    requests = net.send(
        requests, REQVOTE,
        send_mask=expired[:, None].expand(n_prop, n_acc, n_inst),
        bal=bal_next[:, None], v1=ent_term_c[:, None], v2=zeros,
        keep=links.keep_p1,
    )
    cand = dataclasses.replace(
        cand,
        bal=bal_next,
        phase=phase,
        prop_val=prop_val,
        heard=heard,
        ent_term=ent_term_c,
        ent_val=ent_val_c,
        timer=timer,
        decided_val=decided_val,
    )
    return RaftState(
        acceptor=voter_new,
        proposer=cand,
        learner=learner,
        requests=requests,
        replies=replies,
        tick=state.tick + 1,
    )
