"""The campaign harness (counterpart of ``paxos_tpu/harness/run.py``).

``run`` builds the state and fault plan on the device, advances the state
through the fused engine in pipelined dispatches, and reduces the report on
the device, so the whole report crosses to the host in one ``.cpu()``
transfer.  Config acceptance (layout bounds, tick budget) matches the
reference, so a campaign the port accepts replays on the reference too.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from paxos_tpu_torch.core.device import resolve_device
from paxos_tpu_torch.core.fp_state import FastPaxosState
from paxos_tpu_torch.core.raft_state import RaftState
from paxos_tpu_torch.core.state import DONE, LaneState, PaxosState
from paxos_tpu_torch.faults.injector import FaultPlan
from paxos_tpu_torch.harness.config import (
    OBSERVER_PLANES,
    SimConfig,
    validate_pipeline_depth,
)
from paxos_tpu_torch.harness.pipeline import pipelined_run
from paxos_tpu_torch.kernels.fused_tick import FUSED_CHUNKS, REPORT_BALLOT_LIMIT
from paxos_tpu_torch.protocols.paxos import check_supported

# Signed width of learner.chosen_tick in the reference's single-decree
# packed layouts (paxos, fastpaxos, raftcore): the campaign tick budget
# both packages accept.
CHOSEN_TICK_BITS = 19

# The ported protocols and their state types (summarize is shared: all
# three use DONE = 2 and decided_val).
STATE_TYPES = {"paxos": PaxosState, "fastpaxos": FastPaxosState, "raftcore": RaftState}

# Plan knobs FaultPlan.none cannot reproduce: the reference samples them
# with jax.random, so such a plan must be carried across (``plan=``).
_SAMPLED_PLAN_KNOBS = (
    "p_crash", "p_crash_prop", "p_part", "p_equiv", "p_asym", "p_flaky",
    "p_corrupt", "timeout_skew", "backoff_skew", "stale_k", "p_delay",
)


class MeasurementCorrupted(RuntimeError):
    """A campaign's measurements stopped being trustworthy (ballots reached
    the report-time limit)."""


def _check_ported(cfg: SimConfig) -> None:
    if cfg.protocol not in STATE_TYPES:
        raise NotImplementedError(
            f"protocol {cfg.protocol!r} is not ported yet (ROADMAP queue A "
            "slice 4)"
        )
    for plane in OBSERVER_PLANES:
        if getattr(cfg, plane) is not None:
            raise NotImplementedError(
                f"the {plane} plane is not ported yet (ROADMAP queue A slice 5 "
                "item 13)"
            )
    check_supported(cfg.fault)


def _check_packed_layout_bounds(cfg: SimConfig) -> None:
    """Config-time guards of the reference's packed field widths."""
    f = cfg.fault
    if f.timeout + max(f.timeout_skew, 0) >= 4095:
        raise ValueError(
            f"timeout={f.timeout} + timeout_skew={f.timeout_skew} overflows "
            "the packed 13-bit proposer timer; keep timeout + skew < 4095"
        )
    if f.backoff_max * max(f.backoff_skew, 1) > 2048:
        raise ValueError(
            f"backoff_max={f.backoff_max} * backoff_skew={f.backoff_skew} "
            "overflows the packed 13-bit signed proposer timer; keep the "
            "product <= 2048"
        )


def check_tick_budget(protocol: str, ticks: int) -> None:
    """Ticks per campaign must fit the reference's packed chosen_tick."""
    if protocol not in STATE_TYPES:
        raise NotImplementedError(
            f"protocol {protocol!r} is not ported yet (ROADMAP queue A slice 4)"
        )
    cap = (1 << (CHOSEN_TICK_BITS - 1)) - 1
    if ticks > cap:
        raise ValueError(
            f"tick budget {ticks} overflows the packed {CHOSEN_TICK_BITS}-bit "
            f"learner.chosen_tick field for {protocol}; keep ticks per "
            f"campaign <= {cap}"
        )


def init_state(cfg: SimConfig, device=None) -> LaneState:
    """The protocol's initial state, as the reference's ``init_state``."""
    _check_ported(cfg)
    _check_packed_layout_bounds(cfg)
    return STATE_TYPES[cfg.protocol].init(
        cfg.n_inst, cfg.n_prop, cfg.n_acc, cfg.k_slots,
        device=resolve_device(device),
    )


def init_plan(cfg: SimConfig, device=None) -> FaultPlan:
    """The fault-free plan, exact when no plan knob is on; otherwise the
    plan must come from the reference (``run(..., plan=...)``)."""
    on = [k for k in _SAMPLED_PLAN_KNOBS if getattr(cfg.fault, k)]
    if on:
        raise ValueError(
            f"FaultConfig knobs {on} need a sampled fault plan, which the port "
            "does not draw yet (ROADMAP queue A slice 6 item 15): pass plan= "
            "(e.g. interop.plan_from_numpy of the reference's plan)"
        )
    return FaultPlan.none(
        cfg.n_inst, cfg.n_acc, cfg.n_prop, device=resolve_device(device)
    )


def make_advance(cfg: SimConfig, plan: FaultPlan, engine: str = "fused") -> Callable:
    """``advance(state, n_ticks)`` for an engine (fused only): the serial
    dispatch that the shrinker and the CLI drive (ROADMAP queue A items 16
    and 17)."""
    grouped = make_advance_grouped(cfg, plan, engine)
    return lambda state, n: grouped(state, n, 1)


def make_advance_grouped(cfg: SimConfig, plan: FaultPlan, engine: str = "fused") -> Callable:
    """``advance(state, n_ticks, groups)``: ``groups`` chunks in one
    dispatch, which for the fused engine is one chunk of n_ticks * groups
    ticks (ticks are chunk-invariant)."""
    if engine == "xla":
        raise NotImplementedError(
            "the XLA engine draws from jax.random and is not ported yet "
            "(ROADMAP queue A slice 6 item 15)"
        )
    if engine != "fused":
        raise ValueError(f"unknown engine: {engine!r}")
    chunk = FUSED_CHUNKS[cfg.protocol]

    def advance(state, n, g=1):
        return chunk(state, cfg.seed, plan, cfg.fault, n * g)

    return advance


def all_chosen_flag(state: LaneState) -> torch.Tensor:
    """0-d bool device tensor: every lane's learner chose a value."""
    return state.learner.chosen.all()


_STATS = (
    "ticks", "n_chosen", "violations", "evictions", "choose_tick_sum",
    "max_ballot", "n_decided", "proposer_disagree",
)


def summarize_device(state: LaneState) -> tuple:
    """Device half of :func:`summarize`: one int64 vector of exact counts."""
    lrn, prop = state.learner, state.proposer
    chosen = lrn.chosen
    done = prop.phase == DONE
    i64 = torch.int64
    stats = torch.stack([
        state.tick.to(i64),
        chosen.sum(dtype=i64),
        lrn.violations.sum(dtype=i64),
        lrn.evictions.sum(dtype=i64),
        torch.where(chosen, lrn.chosen_tick, 0).sum(dtype=i64),
        prop.bal.max().to(i64),
        done.any(dim=0).sum(dtype=i64),
        (done & chosen[None] & (prop.decided_val != lrn.chosen_val[None]))
        .any(dim=0)
        .sum(dtype=i64),
    ])
    meta = {"n_inst": chosen.shape[-1], "ballot_limit": REPORT_BALLOT_LIMIT}
    return stats, meta


def summarize_host(host: list, meta: dict) -> dict[str, Any]:
    """Format the fetched counts; the fractions are float32 like the
    reference's reductions.  Raises :class:`MeasurementCorrupted` when a
    ballot reached the report-time limit."""
    s = dict(zip(_STATS, (int(v) for v in host)))
    n = meta["n_inst"]
    f32 = np.float32
    out = {
        "n_inst": n,
        "ticks": s["ticks"],
        "chosen_frac": float(f32(s["n_chosen"]) / f32(n)),
        "violations": s["violations"],
        "evictions": s["evictions"],
        "mean_choose_tick": (
            float(f32(s["choose_tick_sum"]) / f32(max(s["n_chosen"], 1)))
            if s["n_chosen"]
            else -1.0
        ),
        "decided_frac": float(f32(s["n_decided"]) / f32(n)),
        "proposer_disagree": s["proposer_disagree"],
    }
    out["checker_complete"] = out["evictions"] == 0
    limit = meta["ballot_limit"]
    if s["max_ballot"] >= limit:
        raise MeasurementCorrupted(
            f"ballot overflowed the packed lane-state layout (bal >= {limit}): "
            "ballot compares are no longer trustworthy for this campaign; "
            "shorten the campaign"
        )
    return out


def summarize(state: LaneState) -> dict[str, Any]:
    """Reduce the state to the report: device reductions, one transfer."""
    stats, meta = summarize_device(state)
    return summarize_host(stats.cpu().tolist(), meta)


def run(
    cfg: SimConfig,
    total_ticks: int = 64,
    chunk: int = 64,
    until_all_chosen: bool = False,
    max_ticks: int = 4096,
    return_state: bool = False,
    engine: str = "fused",
    pipeline_depth: int = 1,
    plan: "FaultPlan | None" = None,
    device=None,
):
    """Init, advance in pipelined chunks, return the report.

    ``device`` defaults to CUDA (and raises without a GPU); ``"cpu"`` runs
    the plain PyTorch versions.  ``plan`` overrides the fault-free plan:
    configs with crash, partition or equivocation knobs need one, carried
    across from the reference with :mod:`paxos_tpu_torch.interop`.
    """
    depth = validate_pipeline_depth(pipeline_depth)
    check_tick_budget(cfg.protocol, max_ticks if until_all_chosen else total_ticks)
    state = init_state(cfg, device)
    if plan is None:
        plan = init_plan(cfg, state.device)
    else:
        plan = FaultPlan(*(leaf.to(state.device) for leaf in plan.leaves()))
    advance = make_advance_grouped(cfg, plan, engine)
    budget = max_ticks if until_all_chosen else total_ticks
    state = pipelined_run(
        state, advance, budget=budget, chunk=chunk, depth=depth,
        done_fn=all_chosen_flag if until_all_chosen else None,
    )
    report = summarize(state)
    report["config_fingerprint"] = cfg.fingerprint()
    report["engine"] = engine
    if depth > 1:
        report["pipeline_depth"] = depth
    if return_state:
        return report, state
    return report
