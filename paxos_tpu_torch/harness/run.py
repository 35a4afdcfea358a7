"""The campaign harness (counterpart of ``paxos_tpu/harness/run.py``).

``run`` builds the state and fault plan on the device, advances the state
through the fused engine in pipelined dispatches, and reduces the report on
the device, so the whole report crosses to the host in one ``.cpu()``
transfer.  Config acceptance (layout bounds, value and tick budgets)
matches the reference, so a campaign the port accepts replays on the
reference too.  A long-log Multi-Paxos config (``fault.log_total > 0``)
compacts decided prefixes out of the window after every chunk and reports
its replication progress.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from paxos_tpu_torch.check.liveness import liveness_device, liveness_host, window_valid_mask
from paxos_tpu_torch.core.ballot import MAX_PROPOSERS
from paxos_tpu_torch.core.device import resolve_device
from paxos_tpu_torch.core.fp_state import FastPaxosState
from paxos_tpu_torch.core.mp_state import BV_SHIFT, MultiPaxosState
from paxos_tpu_torch.core.raft_state import RaftState
from paxos_tpu_torch.core.sp_state import SynchPaxosState
from paxos_tpu_torch.core.state import DONE, LaneState, PaxosState
from paxos_tpu_torch.core.telemetry import TelemetryState, telemetry_device, telemetry_host
from paxos_tpu_torch.faults.injector import FaultPlan
from paxos_tpu_torch.harness.config import SimConfig, validate_pipeline_depth
from paxos_tpu_torch.harness.pipeline import pipelined_run
from paxos_tpu_torch.kernels.fused_tick import FUSED_CHUNKS, report_ballot_limit
from paxos_tpu_torch.obs.coverage import CoverageState, coverage_device, coverage_host
from paxos_tpu_torch.obs.exposure import FaultExposure, exposure_device, exposure_host
from paxos_tpu_torch.obs.margin import MarginState, margin_device, margin_host
from paxos_tpu_torch.obs.slo import slo_device, slo_host
from paxos_tpu_torch.protocols.multipaxos import compact_mp_body
from paxos_tpu_torch.protocols.paxos import check_supported
from paxos_tpu_torch.workload.generator import WloadState

# Signed width of learner.chosen_tick in the reference's packed layouts:
# the campaign tick budget both packages accept.
CHOSEN_TICK_BITS = {
    "paxos": 19, "fastpaxos": 19, "raftcore": 19, "synchpaxos": 19, "multipaxos": 18,
}

# The ported protocols and their state types (the single-decree four share
# DONE = 2 and decided_val in summarize).
STATE_TYPES = {
    "paxos": PaxosState,
    "fastpaxos": FastPaxosState,
    "raftcore": RaftState,
    "synchpaxos": SynchPaxosState,
    "multipaxos": MultiPaxosState,
}

# Plan knobs FaultPlan.none cannot reproduce: the reference samples them
# with jax.random, so such a plan must be carried across (``plan=``).
# (p_corrupt reads no plan field: FaultPlan.none serves it.)
_SAMPLED_PLAN_KNOBS = (
    "p_crash", "p_crash_prop", "p_part", "p_equiv", "p_asym", "p_flaky",
    "timeout_skew", "backoff_skew", "stale_k", "p_delay",
)


def sampled_plan_knobs(fault) -> list:
    """The knobs of ``fault`` whose plan the reference samples, so that
    :func:`init_plan` cannot build it."""
    return [k for k in _SAMPLED_PLAN_KNOBS if getattr(fault, k)]


class MeasurementCorrupted(RuntimeError):
    """A campaign's measurements stopped being trustworthy (ballots reached
    the report-time limit)."""


def _check_ported(cfg: SimConfig) -> None:
    if cfg.protocol not in STATE_TYPES:
        raise NotImplementedError(
            f"protocol {cfg.protocol!r} is not ported yet (ROADMAP queue A "
            "slice 4)"
        )
    check_supported(cfg.fault, cfg.protocol)


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
    if cfg.protocol == "multipaxos" and cfg.log_len >= 64:
        raise ValueError(
            f"log_len={cfg.log_len} overflows the packed 6-bit commit_idx "
            "field; keep the window < 64 slots"
        )


def _check_value_budget(cfg: SimConfig) -> None:
    """Multi-Paxos commands, own_slot_value(pid, global slot), must fit the
    packed pair's value field and the reference's 13-bit packed value."""
    top = max(cfg.fault.log_total, cfg.log_len)
    max_val = MAX_PROPOSERS * 1000 + top
    if max_val >= (1 << BV_SHIFT):
        raise ValueError(
            f"log_total={cfg.fault.log_total} overflows the packed (ballot, "
            f"value) layout: own_slot_value can reach {max_val} >= "
            f"2^{BV_SHIFT}; keep log_total <= "
            f"{(1 << BV_SHIFT) - MAX_PROPOSERS * 1000 - 1}"
        )
    max_val = cfg.n_prop * 1000 + top
    if max_val >= (1 << 13):
        raise ValueError(
            f"n_prop={cfg.n_prop} with log_total={cfg.fault.log_total} "
            f"overflows the packed 13-bit value field: own_slot_value can "
            f"reach {max_val} >= 2^13; shrink the log or the proposer count"
        )


def check_tick_budget(protocol: str, ticks: int) -> None:
    """Ticks per campaign must fit the reference's packed chosen_tick."""
    if protocol not in STATE_TYPES:
        raise NotImplementedError(
            f"protocol {protocol!r} is not ported yet (ROADMAP queue A slice 4)"
        )
    bits = CHOSEN_TICK_BITS[protocol]
    cap = (1 << (bits - 1)) - 1
    if ticks > cap:
        raise ValueError(
            f"tick budget {ticks} overflows the packed {bits}-bit "
            f"learner.chosen_tick field for {protocol}; keep ticks per "
            f"campaign <= {cap}"
        )


def init_state(cfg: SimConfig, device=None, wload_plan=None) -> LaneState:
    """The protocol's initial state, as the reference's ``init_state``
    (with its buffers' delay stamps when ``p_delay > 0``, the acceptors'
    (voters') snapshot shadows when ``stale_k > 0``, and the observer
    planes the config turns on).  The workload plane needs its plan,
    ``wload_plan`` = (mode, phase), (P, I) int32 each: the reference
    samples it with ``jax.random``, which the port does not (ROADMAP item
    15), so it is carried across or drawn from the same distribution."""
    _check_ported(cfg)
    _check_packed_layout_bounds(cfg)
    device = resolve_device(device)
    if cfg.planes_on():
        return _with_planes(_init_protocol_state(cfg, device), cfg, device, wload_plan)
    return _init_protocol_state(cfg, device)


def _with_planes(state: LaneState, cfg: SimConfig, device, wload_plan) -> LaneState:
    """``state`` with the observer planes of ``cfg``, as the reference's
    ``init_state`` adds them."""
    n = cfg.n_inst
    kw = {}
    if cfg.telemetry.enabled():
        kw["telemetry"] = TelemetryState.init(n, cfg.telemetry, device)
    if cfg.coverage.enabled():
        kw["coverage"] = CoverageState.init(n, cfg.coverage, device)
    if cfg.exposure.enabled():
        kw["exposure"] = FaultExposure.init(n, device)
    if cfg.margin.enabled():
        kw["margin"] = MarginState.init(n, device)
    if cfg.workload.enabled():
        if wload_plan is None:
            raise ValueError(
                "the workload plane needs its plan, wload_plan=(mode, phase), which the "
                "port does not draw yet (ROADMAP queue A slice 6 item 15): carry the "
                "reference's across or draw it from the same distribution"
            )
        mode, phase = wload_plan
        kw["wload"] = WloadState.init(n, cfg.n_prop, cfg.workload, mode, phase, device)
    return dataclasses.replace(state, **kw)


def _init_protocol_state(cfg: SimConfig, device) -> LaneState:
    if cfg.protocol == "multipaxos":
        _check_value_budget(cfg)
        return MultiPaxosState.init(
            cfg.n_inst, cfg.n_prop, cfg.n_acc, cfg.log_len, k=cfg.k_slots,
            lease_init=cfg.fault.lease_len, device=device, stale=cfg.fault.stale_k > 0,
            delay=cfg.fault.p_delay > 0.0,
        )
    kw = {}
    if STATE_TYPES[cfg.protocol].takes_stamps:
        kw["delay"] = cfg.fault.p_delay > 0.0
    if STATE_TYPES[cfg.protocol].takes_snapshots:
        kw["stale"] = cfg.fault.stale_k > 0
    return STATE_TYPES[cfg.protocol].init(
        cfg.n_inst, cfg.n_prop, cfg.n_acc, cfg.k_slots, device=device, **kw
    )


def init_plan(cfg: SimConfig, device=None) -> FaultPlan:
    """The fault-free plan, exact when no plan knob is on; otherwise the
    plan must come from the reference (``run(..., plan=...)``)."""
    on = sampled_plan_knobs(cfg.fault)
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


def make_advance_grouped(
    cfg: SimConfig, plan: FaultPlan, engine: str = "fused", compact: bool = False
) -> Callable:
    """``advance(state, n_ticks, groups)``: ``groups`` chunks in one
    dispatch.  Without ``compact`` that is one chunk of n_ticks * groups
    ticks (ticks are chunk-invariant).  With ``compact`` (long-log
    Multi-Paxos) every chunk of ``n_ticks`` is followed by the
    decided-prefix compaction, so the compaction cadence is the chunk,
    whatever the grouping."""
    if engine == "xla":
        raise NotImplementedError(
            "the XLA engine draws from jax.random and is not ported yet "
            "(ROADMAP queue A slice 6 item 15)"
        )
    if engine != "fused":
        raise ValueError(f"unknown engine: {engine!r}")
    chunk = FUSED_CHUNKS[cfg.protocol]
    if compact:
        if cfg.protocol != "multipaxos":
            raise ValueError("decided-prefix compaction is a Multi-Paxos long-log mode")

        def advance_compact(state, n, g=1):
            for _ in range(g):
                state = compact_mp_body(chunk(state, cfg.seed, plan, cfg.fault, n))[0]
            return state

        return advance_compact

    def advance(state, n, g=1):
        return chunk(state, cfg.seed, plan, cfg.fault, n * g)

    return advance


def all_chosen_flag(state: LaneState) -> torch.Tensor:
    """0-d bool device tensor: every lane's learner chose a value (every
    window slot, for Multi-Paxos)."""
    return state.learner.chosen.all()


class LongLog:
    """Chunk-boundary protocol of long-log Multi-Paxos: decided prefixes
    compact out of the window after every chunk
    (``make_advance_grouped(compact=True)``), a run is done when every
    instance's ``base`` reached ``log_total``, and reports carry the
    replication fields (:func:`summarize` with ``log_total``)."""

    def __init__(self, cfg: SimConfig):
        self.log_total = cfg.fault.log_total

    def done_flag(self, state: MultiPaxosState) -> torch.Tensor:
        """0-d bool device tensor: every instance replicated the whole log."""
        return (state.base >= self.log_total).all()


def make_longlog(cfg: SimConfig) -> "LongLog | None":
    if cfg.protocol == "multipaxos" and cfg.fault.log_total > 0:
        return LongLog(cfg)
    return None


_STATS = (
    "ticks", "n_chosen", "violations", "evictions", "choose_tick_sum",
    "max_ballot", "n_decided", "proposer_disagree", "slots_replicated",
    "n_replicated",
)


def summarize_device(state: LaneState, liveness: bool = False, log_total: int = 0) -> tuple:
    """Device half of :func:`summarize`: one int64 vector of exact counts,
    and with ``liveness`` the liveness block's counts after them
    (:func:`paxos_tpu_torch.check.liveness.liveness_device`).

    Multi-Paxos counts slots: ``chosen`` is (L, I), ``n_decided`` counts
    lanes whose whole window is chosen, or with ``log_total`` the decided
    slot-lanes (compacted prefix plus in-window chosen real slots)."""
    lrn, prop = state.learner, state.proposer
    chosen = lrn.chosen
    i64 = torch.int64
    zero = torch.zeros((), dtype=i64, device=chosen.device)
    n_inst = chosen.shape[-1]
    if isinstance(state, MultiPaxosState):
        base = state.base
        if log_total > 0:
            valid = window_valid_mask(chosen.shape, base, log_total)
            n_decided = (chosen & valid).sum(dtype=i64)
            decided_den = n_inst * log_total
        else:
            n_decided = chosen.all(dim=0).sum(dtype=i64)
            decided_den = n_inst
        disagree = zero
        replicated = (base.sum(dtype=i64), (base >= log_total).sum(dtype=i64))
    else:
        done = prop.phase == DONE
        n_decided = done.any(dim=0).sum(dtype=i64)
        decided_den = n_inst
        disagree = (
            (done & chosen[None] & (prop.decided_val != lrn.chosen_val[None]))
            .any(dim=0)
            .sum(dtype=i64)
        )
        replicated = (zero, zero)
    stats = torch.stack([
        state.tick.to(i64),
        chosen.sum(dtype=i64),
        lrn.violations.sum(dtype=i64),
        lrn.evictions.sum(dtype=i64),
        torch.where(chosen, lrn.chosen_tick, 0).sum(dtype=i64),
        prop.bal.max().to(i64),
        n_decided,
        disagree,
        *replicated,
    ])
    mp = isinstance(state, MultiPaxosState)
    meta = {
        "n_inst": n_inst,
        "n_chosen_den": chosen.numel(),
        "decided_den": decided_den,
        "ballot_limit": report_ballot_limit("multipaxos" if mp else "paxos"),
        "log_total": log_total if mp else 0,
        "liveness": liveness,
    }
    parts = [stats]
    if liveness:
        block = liveness_device(
            lrn, state.tick, base=state.base if mp else None, log_total=log_total
        )
        meta["liveness_len"] = block.numel()
        parts.append(block)
    # The observer planes' blocks, each reduced on the device, flattened
    # after the rest: (block, key, count) per field in meta.
    meta["plane_fields"] = []
    for name, dev in _plane_blocks(state):
        for key, x in dev.items():
            x = x.reshape(-1).to(i64)
            meta["plane_fields"].append((name, key, x.numel()))
            parts.append(x)
    if state.planes:
        meta["coverage_words"] = state.coverage.bitmap.shape[0] if state.coverage is not None else 0
    return torch.cat(parts) if len(parts) > 1 else stats, meta


def _plane_blocks(state: LaneState) -> list:
    """(report block, device dict) of each observer plane ``state``
    carries, in the reference's report order."""
    out = []
    for name, field, device_fn in (
        ("telemetry", "telemetry", telemetry_device), ("coverage", "coverage", coverage_device),
        ("exposure", "exposure", exposure_device), ("margin", "margin", margin_device),
        ("slo", "wload", slo_device),
    ):
        plane = getattr(state, field, None)
        if plane is not None:
            out.append((name, device_fn(plane)))
    return out


_PLANE_HOST = {
    "telemetry": telemetry_host, "exposure": exposure_host, "margin": margin_host,
    "slo": slo_host,
}
# The fields a report block reads as scalars (the others as lists).
_SCALAR_FIELDS = {
    "telemetry": ("seq",), "coverage": ("union_bits", "lane_bits", "new_bits"),
    "margin": (
        "min_quorum_slack", "near_miss_lanes", "zero_slack_lanes", "contested_lanes",
        "near_split_ticks", "near_split_lanes", "min_ballot_gap", "min_promise_slack",
    ),
    "slo": ("queue_depth", "depth_peak"),
}


def _planes_host(host: list, meta: dict) -> dict:
    """The observer planes' report blocks from their fetched counts."""
    blocks, k = {}, 0
    for name, key, count in meta["plane_fields"]:
        vals = host[k:k + count]
        k += count
        blocks.setdefault(name, {})[key] = (
            vals[0] if key in _SCALAR_FIELDS.get(name, ()) else vals
        )
    out = {}
    for name, dev in blocks.items():
        if name == "coverage":
            out[name] = coverage_host(dev, meta["coverage_words"])
        else:
            out[name] = _PLANE_HOST[name](dev)
    return out


def summarize_host(host: list, meta: dict) -> dict[str, Any]:
    """Format the fetched counts; the fractions are float32 like the
    reference's reductions.  Raises :class:`MeasurementCorrupted` when a
    ballot reached the report-time limit."""
    s = dict(zip(_STATS, (int(v) for v in host[: len(_STATS)])))
    n = meta["n_inst"]
    f32 = np.float32
    log_total = meta["log_total"]
    if log_total:
        # The reference adds the compacted prefix and the in-window slots
        # as two float32 sums.
        decided = f32(s["slots_replicated"]) + f32(s["n_decided"])
    else:
        decided = f32(s["n_decided"])
    out = {
        "n_inst": n,
        "ticks": s["ticks"],
        "chosen_frac": float(f32(s["n_chosen"]) / f32(meta["n_chosen_den"])),
        "violations": s["violations"],
        "evictions": s["evictions"],
        "mean_choose_tick": (
            float(f32(s["choose_tick_sum"]) / f32(max(s["n_chosen"], 1)))
            if s["n_chosen"]
            else -1.0
        ),
        "decided_frac": float(decided / f32(meta["decided_den"])),
        "proposer_disagree": s["proposer_disagree"],
    }
    out["checker_complete"] = out["evictions"] == 0
    if log_total:
        out["log_total"] = log_total
        out["slots_replicated"] = s["slots_replicated"]
        out["replicated_frac"] = float(f32(s["n_replicated"]) / f32(n))
    limit = meta["ballot_limit"]
    if s["max_ballot"] >= limit:
        raise MeasurementCorrupted(
            f"ballot overflowed the packed lane-state layout (bal >= {limit}): "
            "ballot compares are no longer trustworthy for this campaign; "
            "shorten the campaign"
        )
    rest = host[len(_STATS):]
    if meta["liveness"]:
        out.update(liveness_host(rest[:meta["liveness_len"]], s["ticks"], log_total > 0))
        rest = rest[meta["liveness_len"]:]
    out.update(_planes_host(rest, meta))
    return out


def summarize(state: LaneState, liveness: bool = False, log_total: int = 0) -> dict[str, Any]:
    """Reduce the state to the report: device reductions, one transfer.
    ``liveness`` appends the decided-by curve, the decision-latency
    histogram and the stuck-lane count
    (:func:`paxos_tpu_torch.check.liveness.liveness_host`).
    ``log_total > 0`` (long-log Multi-Paxos) reports global replication
    progress: ``decided_frac`` over the whole log, ``slots_replicated``
    and ``replicated_frac``; it makes the liveness block window-relative
    (``slots_compacted``, and the never-decidable tail rows of the window
    masked out)."""
    stats, meta = summarize_device(state, liveness=liveness, log_total=log_total)
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
    liveness: bool = False,
    wload_plan=None,
):
    """Init, advance in pipelined chunks, return the report.

    ``device`` defaults to CUDA (and raises without a GPU); ``"cpu"`` runs
    the plain PyTorch versions.  ``plan`` overrides the fault-free plan:
    the configs whose knobs the reference samples a plan for need one
    (:func:`sampled_plan_knobs`: crash windows, equivocators, link delays,
    and the gray-failure and partition configs ``config_partition``,
    ``config_gray_chaos`` and ``config_stale`` on any protocol that takes
    them), carried across from the reference with
    :mod:`paxos_tpu_torch.interop` or drawn from the same distribution.  A
    long-log Multi-Paxos config compacts after every ``chunk`` ticks, and
    ``until_all_chosen`` then waits for the whole log to replicate.
    ``liveness`` adds the liveness block to the report (:func:`summarize`).
    The observer planes the config turns on (any protocol) add their blocks
    (``telemetry``, ``coverage``, ``exposure``, ``margin``, ``slo``); the
    workload plane needs ``wload_plan`` (:func:`init_state`).
    """
    depth = validate_pipeline_depth(pipeline_depth)
    check_tick_budget(cfg.protocol, max_ticks if until_all_chosen else total_ticks)
    state = init_state(cfg, device, wload_plan)
    if plan is None:
        plan = init_plan(cfg, state.device)
    else:
        plan = plan.to(state.device)
    ll = make_longlog(cfg)
    advance = make_advance_grouped(cfg, plan, engine, compact=bool(ll))
    done_fn = None
    if until_all_chosen:
        done_fn = ll.done_flag if ll else all_chosen_flag
    budget = max_ticks if until_all_chosen else total_ticks
    state = pipelined_run(
        state, advance, budget=budget, chunk=chunk, depth=depth, done_fn=done_fn
    )
    report = summarize(state, liveness=liveness, log_total=cfg.fault.log_total)
    report["config_fingerprint"] = cfg.fingerprint()
    report["engine"] = engine
    if depth > 1:
        report["pipeline_depth"] = depth
    if return_state:
        return report, state
    return report
