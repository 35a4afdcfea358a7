"""Vectorized safety checking (counterpart of ``paxos_tpu/check/safety.py``).

The learner is omniscient: it sees every accept event and counts votes per
(ballot, value) pair in a bounded K-slot table.  A second distinct chosen
value counts as an agreement violation; :func:`acceptor_invariants` checks
the acceptor-local invariants of honest acceptors every tick, and
:func:`raft_voter_invariants` those of Raft-core's voters.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.core.ballot import ballot_round
from paxos_tpu_torch.core.state import AcceptorState, LearnerState
from paxos_tpu_torch.utils.bitops import popcount


def first_true(mask: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Boolean mask selecting the first True along ``axis`` (all-False-safe)."""
    n = mask.shape[axis]
    shape = [1] * mask.dim()
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).view(shape)
    masked = torch.where(mask, idx, n)
    first = masked.amin(dim=axis, keepdim=True)
    return mask & (masked == first)


def learner_observe(
    learner: LearnerState,
    ev_flag: torch.Tensor,  # (A, I) bool: acceptor a accepted this tick
    ev_bal: torch.Tensor,  # (A, I) int32
    ev_val: torch.Tensor,  # (A, I) int32
    tick: torch.Tensor,  # () int32
    quorum: int,
    fast_quorum: "int | None" = None,
) -> LearnerState:
    """Fold this tick's accept events into the learner table.

    With ``fast_quorum`` set (Fast Paxos), a slot whose ballot is of round
    0, the fast round, needs ``fast_quorum`` voters to be chosen; classic
    rounds need ``quorum``.  Thresholds are recomputed from the table's
    ballots before and after the fold."""
    n_acc = ev_flag.shape[0]
    lt_bal, lt_val, lt_mask = learner.lt_bal, learner.lt_val, learner.lt_mask
    evictions = learner.evictions

    def slot_quorum(bal: torch.Tensor):
        if fast_quorum is None:
            return quorum
        return torch.where(ballot_round(bal) == 0, fast_quorum, quorum)

    pre_chosen_slots = popcount(lt_mask) >= slot_quorum(lt_bal)  # (K, I)

    # At most one accept event per acceptor per tick, so a sequential fold
    # over the small acceptor axis is exact: a second acceptor hitting a
    # just-inserted pair matches it.
    for a in range(n_acc):
        b, v = ev_bal[a], ev_val[a]
        f = ev_flag[a] & (b > 0)
        match = (lt_bal == b[None]) & (lt_val == v[None]) & (b[None] > 0)
        any_match = match.any(dim=0)
        min_bal = lt_bal.amin(dim=0)  # empty slots (bal 0) win first
        ins_slot = first_true(lt_bal == min_bal[None], axis=0)
        can_insert = (min_bal == 0) | (b > min_bal)
        do_insert = f & ~any_match & can_insert
        missed = f & ~any_match & ~can_insert
        bit = 1 << a

        lt_mask = torch.where(match & f[None], lt_mask | bit, lt_mask)
        ins = ins_slot & do_insert[None]
        lt_bal = torch.where(ins, b[None], lt_bal)
        lt_val = torch.where(ins, v[None], lt_val)
        lt_mask = torch.where(ins, bit, lt_mask)
        evictions = (
            evictions
            + missed.to(torch.int32)
            + (do_insert & (min_bal != 0)).to(torch.int32)
        )

    chosen_slots = popcount(lt_mask) >= slot_quorum(lt_bal)
    newly_chosen = chosen_slots & ~pre_chosen_slots
    any_new = newly_chosen.any(dim=0)

    # First newly chosen value (slot order: deterministic).
    first_val = torch.where(first_true(newly_chosen, axis=0), lt_val, 0).sum(
        dim=0, dtype=torch.int32
    )
    chosen_val = torch.where(
        learner.chosen, learner.chosen_val, torch.where(any_new, first_val, 0)
    )
    chosen = learner.chosen | any_new
    chosen_tick = torch.where(
        learner.chosen,
        learner.chosen_tick,
        torch.where(any_new, tick.to(torch.int32), -1),
    )

    # Agreement: every newly chosen slot must carry THE chosen value.
    viol = (newly_chosen & (lt_val != chosen_val[None]) & chosen[None]).sum(
        dim=0, dtype=torch.int32
    )
    return dataclasses.replace(
        learner,
        lt_bal=lt_bal,
        lt_val=lt_val,
        lt_mask=lt_mask,
        chosen=chosen,
        chosen_val=chosen_val,
        chosen_tick=chosen_tick,
        violations=learner.violations + viol,
        evictions=evictions,
    )


def margin_observe(
    margin,
    pre: LearnerState,
    post: LearnerState,
    promised: torch.Tensor,  # (A, I) int32 promise fence (Raft: voted)
    acc_bal: torch.Tensor,  # (A, I) int32 accepted ballot (Raft: ent_term)
    honest: torch.Tensor,  # (A, I) bool
    quorum: int,
    fast_quorum: "int | None" = None,
):
    """Fold one tick's distance-to-violation signals into the margin
    sketch (``obs.margin.MarginState``) from the post-:func:`learner_observe`
    table ``post``, the pre-tick learner ``pre`` (for decide edges) and the
    post-tick acceptor fence; draws nothing."""
    from paxos_tpu_torch.obs.margin import SENTINEL

    lt_bal, lt_val = post.lt_bal, post.lt_val
    votes = popcount(post.lt_mask)  # (K, I)
    if fast_quorum is None:
        sq = torch.full_like(lt_bal, quorum)
    else:
        sq = torch.where(ballot_round(lt_bal) == 0, fast_quorum, quorum).to(torch.int32)
    live = lt_bal > 0

    # Quorum slack of the best competing row: a live pair on a decided
    # instance whose value is not the chosen one (0: the violation fired).
    competing = live & post.chosen[None] & (lt_val != post.chosen_val[None])
    slack = torch.clamp(sq - votes, min=0)
    tick_slack = torch.where(competing, slack, SENTINEL).amin(dim=0)
    qslack_min = torch.minimum(margin.qslack_min, tick_slack)

    # Near split: two live rows or more, of distinct values, each within
    # one vote of quorum.
    hot = live & (votes >= sq - 1)
    vmin = torch.where(hot, lt_val, SENTINEL).amin(dim=0)
    vmax = torch.where(hot, lt_val, 0).amax(dim=0)
    near = (hot.sum(dim=0, dtype=torch.int32) >= 2) & (vmin != vmax)
    near_split = margin.near_split + near.to(torch.int32)

    # Ballot-race margin on the decide tick: the winning row's ballot over
    # the best rival row's; an unopposed decide records nothing.
    decided_now = post.chosen & ~pre.chosen
    win_rows = (votes >= sq) & live & (lt_val == post.chosen_val[None])
    win_bal = torch.where(win_rows, lt_bal, 0).amax(dim=0)
    rival_bal = torch.where(live & ~win_rows, lt_bal, 0).amax(dim=0)
    gap = torch.clamp(win_bal - rival_bal, min=0)
    tick_gap = torch.where(decided_now & (rival_bal > 0), gap, SENTINEL)
    bal_gap_min = torch.minimum(margin.bal_gap_min, tick_gap)

    # Headroom on the acceptance bound over honest acceptors holding a pair.
    pslack = torch.where(honest & (acc_bal > 0), promised - acc_bal, SENTINEL).amin(dim=0)
    promise_slack_min = torch.minimum(margin.promise_slack_min, pslack)
    return dataclasses.replace(
        margin,
        qslack_min=qslack_min.to(torch.int32),
        near_split=near_split,
        bal_gap_min=bal_gap_min.to(torch.int32),
        promise_slack_min=promise_slack_min.to(torch.int32),
    )


def acceptor_invariants(
    old: AcceptorState, new: AcceptorState, honest: torch.Tensor
) -> torch.Tensor:
    """(I,) int32 count of per-tick acceptor-local invariant breaks.

    - promise monotonicity: ``promised`` never decreases;
    - acceptance bound: ``acc_bal <= promised`` after every transition;
    - accepted pair consistency: a nil ballot never carries a value.
    """
    mono = new.promised < old.promised
    bound = new.acc_bal > new.promised
    nilpair = (new.acc_bal == 0) & (new.acc_val != 0)
    bad = (mono | bound | nilpair) & honest
    return bad.sum(dim=0, dtype=torch.int32)


def raft_voter_invariants(old, new, honest: torch.Tensor) -> torch.Tensor:
    """(I,) int32 count of per-tick Raft voter invariant breaks over
    :class:`~paxos_tpu_torch.core.raft_state.VoterState` transitions
    (honest voters only).

    - vote-fence monotonicity: ``voted`` never decreases;
    - entry bound: a stored entry's term never exceeds the vote fence;
    - entry-term monotonicity: overwrites only by equal-or-higher terms;
    - nil pair: an empty entry (term 0) never carries a value.
    """
    mono = new.voted < old.voted
    bound = new.ent_term > new.voted
    ent_mono = new.ent_term < old.ent_term
    nilpair = (new.ent_term == 0) & (new.ent_val != 0)
    bad = (mono | bound | ent_mono | nilpair) & honest
    return bad.sum(dim=0, dtype=torch.int32)
