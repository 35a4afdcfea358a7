"""Per-slot safety checking for Multi-Paxos logs (counterpart of
``paxos_tpu/check/mp_safety.py``).

The agreement oracle of :mod:`paxos_tpu_torch.check.safety` lifted to a
log axis: every (instance, slot) pair is its own consensus instance,
tracked by a K-row table per slot of packed (ballot, value) pairs and
voter bitmasks.  The eviction victim is the first row of the event's slot
holding the minimum packed pair.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.check.safety import first_true
from paxos_tpu_torch.core.mp_state import MPLearnerState, bv_bal, bv_val, pack_bv
from paxos_tpu_torch.utils.bitops import popcount

_EMPTY_MIN = 0x7FFFFFFF  # the row minimum of a slot no row belongs to


def mp_learner_observe(
    learner: MPLearnerState,
    ev_flag: torch.Tensor,  # (A, I) bool: acceptor a accepted this tick
    ev_bal: torch.Tensor,  # (A, I) int32
    ev_slot: torch.Tensor,  # (A, I) int32 log slot index
    ev_val: torch.Tensor,  # (A, I) int32
    tick: torch.Tensor,  # () int32
    quorum: int,
) -> MPLearnerState:
    """Fold this tick's accept events into the per-slot tables.

    The fold runs acceptor by acceptor over the table viewed as
    (L*K, I); re-confirmations of a slot's chosen value (read from the
    pre-tick ``chosen``) are skipped; ``evictions`` counts both an insert
    that displaces a row and an event no row can take."""
    n_acc = ev_flag.shape[0]
    n_slots, k, n_inst = learner.lt_bv.shape
    dev = learner.lt_bv.device
    evictions = learner.evictions
    slot_ids = torch.arange(n_slots, dtype=torch.int32, device=dev)[:, None]  # (L, 1)
    lk = n_slots * k
    lt_bv = learner.lt_bv.reshape(lk, n_inst)
    lt_mask = learner.lt_mask.reshape(lk, n_inst)
    row_slot = (torch.arange(lk, dtype=torch.int32, device=dev) // k)[:, None]  # (LK, 1)

    pre_chosen_rows = popcount(lt_mask) >= quorum  # (LK, I)

    for a in range(n_acc):
        b, s, v = ev_bal[a], ev_slot[a], ev_val[a]  # (I,)
        bv = pack_bv(b, v)
        f = ev_flag[a] & (b > 0) & (s >= 0) & (s < n_slots)
        oh_slot = s[None] == slot_ids  # (L, I)
        # Re-confirming a slot's chosen value cannot disagree: skipped.
        ch_s = (learner.chosen & oh_slot).any(dim=0)
        cv_s = torch.where(oh_slot, learner.chosen_val, 0).sum(dim=0, dtype=torch.int32)
        f = f & ~(ch_s & (v == cv_s))

        oh_row = s[None] == row_slot  # (LK, I)
        match = oh_row & (lt_bv == bv[None]) & f[None]
        any_match = match.any(dim=0)
        min_bv = torch.where(oh_row, lt_bv, _EMPTY_MIN).amin(dim=0)  # (I,)
        can_insert = (min_bv == 0) | (b > bv_bal(min_bv))
        do_insert = f & ~any_match & can_insert
        missed = f & ~any_match & ~can_insert
        bit = 1 << a

        ins = first_true(oh_row & (lt_bv == min_bv[None]), axis=0) & do_insert[None]
        lt_mask = torch.where(ins, bit, torch.where(match, lt_mask | bit, lt_mask))
        lt_bv = torch.where(ins, bv[None], lt_bv)
        evictions = (
            evictions
            + missed.to(torch.int32)
            + (do_insert & (min_bv != 0)).to(torch.int32)
        )

    lt_bv = lt_bv.reshape(n_slots, k, n_inst)
    lt_mask = lt_mask.reshape(n_slots, k, n_inst)
    pre_chosen_rows = pre_chosen_rows.reshape(n_slots, k, n_inst)
    newly = (popcount(lt_mask) >= quorum) & ~pre_chosen_rows  # (L, K, I)
    any_new = newly.any(dim=1)  # (L, I)

    lt_v = bv_val(lt_bv)
    first_val = torch.where(first_true(newly, axis=1), lt_v, 0).sum(dim=1, dtype=torch.int32)
    chosen_val = torch.where(
        learner.chosen, learner.chosen_val, torch.where(any_new, first_val, 0)
    )
    chosen = learner.chosen | any_new
    chosen_tick = torch.where(
        learner.chosen,
        learner.chosen_tick,
        torch.where(any_new, tick.to(torch.int32), -1),
    )
    viol = (newly & (lt_v != chosen_val[:, None]) & chosen[:, None]).sum(
        dim=(0, 1), dtype=torch.int32
    )
    return dataclasses.replace(
        learner,
        lt_bv=lt_bv,
        lt_mask=lt_mask,
        chosen=chosen,
        chosen_val=chosen_val,
        chosen_tick=chosen_tick,
        violations=learner.violations + viol,
        evictions=evictions,
    )
