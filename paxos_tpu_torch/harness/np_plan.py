"""Fault plans drawn from numpy with the reference's plan distribution.

The reference samples a config's fault plan with ``jax.random``
(``paxos_tpu/faults/injector.py`` ``FaultPlan.sample``), a stream the port
does not have yet (ROADMAP item 15, so ``harness.run.init_plan`` raises
for a config whose plan is sampled).  Until it lands, these functions draw
the same distribution from a numpy stream: the crash windows,
equivocators, per-link latency caps and the partition and gray-failure
fields a config's knobs need.  They share the reference's distribution,
not its numbers; the tests carry the reference's own plans across where
they compare bit for bit.  ``chip_smoke.py``, the ablation entry point
and the tests draw their plans here.
"""

from __future__ import annotations

import numpy as np
import torch


def fault_plan(
    n_inst: int, n_acc: int, n_prop: int, p_equiv: float, seed: int, p_crash: float = 0.0,
    p_crash_prop: float = 0.0, max_start: int = 32, max_len: int = 16, device="cuda",
    p_delay: float = 0.0, delay_max: int = 4, gray=None,
):
    """A plan from a fixed numpy seed: equivocators with probability
    ``p_equiv``; with probability ``p_crash`` per (acceptor, lane) and
    ``p_crash_prop`` per (proposer, lane) a crash window starting in
    U[0, max_start) and lasting U[1, max_len] ticks; with ``p_delay`` > 0,
    each (proposer, acceptor, lane) link slow with probability ``p_delay``,
    its latency cap drawn from U[1, delay_max], every other link's cap 0
    (drawn last, so plans without delay are unchanged); and with ``gray``
    (a FaultConfig) the partition and gray-failure fields its knobs need,
    drawn after all of those (:func:`gray_plan_fields`)."""
    from paxos_tpu_torch.faults.injector import NEVER, FaultPlan

    plan = FaultPlan.none(n_inst, n_acc, n_prop, device=device)
    rng = np.random.default_rng(seed)

    def windows(shape, p):
        crash = rng.random(shape) < p
        start = rng.integers(0, max_start, shape)
        end = start + rng.integers(1, max_len + 1, shape)
        return (
            torch.from_numpy(np.where(crash, start, NEVER).astype(np.int32)).to(device),
            torch.from_numpy(np.where(crash, end, NEVER).astype(np.int32)).to(device),
        )

    plan.equivocate = torch.from_numpy(rng.random((n_acc, n_inst)) < p_equiv).to(device)
    plan.crash_start, plan.crash_end = windows((n_acc, n_inst), p_crash)
    if p_crash_prop > 0.0:
        plan.pcrash_start, plan.pcrash_end = windows((n_prop, n_inst), p_crash_prop)
    if p_delay > 0.0:
        edge = (n_prop, n_acc, n_inst)
        slow = rng.random(edge) < p_delay
        cap = rng.integers(1, max(delay_max, 1) + 1, edge)
        plan.link_delay = torch.from_numpy(np.where(slow, cap, 0).astype(np.int32)).to(device)
    if gray is not None:
        for name, value in gray_plan_fields(rng, gray, n_inst, n_acc, n_prop).items():
            setattr(plan, name, torch.from_numpy(value).to(device))
    return plan


def gray_plan_fields(rng, f, n_inst: int, n_acc: int, n_prop: int) -> dict:
    """The partition and gray-failure plan fields that the knobs of
    FaultConfig ``f`` need, drawn from ``rng`` with the JAX package's
    ``FaultPlan.sample`` distribution: with ``p_part`` a partition window
    per lane with probability ``p_part`` (start U[0, part_max_start),
    length U[1, part_max_len]) and a fair side for every acceptor and
    proposer; with ``p_asym`` the cut one-way with probability ``p_asym``,
    cutting requests or replies alike (``part_dir`` 1 or 2, else 0); with
    ``p_flaky`` each link flaky with probability ``p_flaky``, its drop rate
    U[0, 1) * ``flaky_drop`` and, where duplication is live, its dup rate
    U[0, 1) * ``flaky_dup`` (healthy links: ``p_drop``, ``p_dup``), as
    thresholds through the port's ``rate_threshold``; with ``timeout_skew``
    an extra timeout U[0, timeout_skew] per proposer and lane, with
    ``backoff_skew`` a backoff multiplier U[1, backoff_skew]."""
    from paxos_tpu_torch.faults.injector import NEVER, links_dup, rate_threshold

    out = {}
    lane, edge, prop = (n_inst,), (n_prop, n_acc, n_inst), (n_prop, n_inst)
    if f.p_part > 0.0:
        parts = rng.random(lane) < f.p_part
        start = rng.integers(0, max(f.part_max_start, 1), lane)
        end = np.minimum(start + rng.integers(1, max(f.part_max_len, 1) + 1, lane), NEVER - 1)
        out["part_start"] = np.where(parts, start, NEVER).astype(np.int32)
        out["part_end"] = np.where(parts, end, NEVER).astype(np.int32)
        out["aside"] = rng.random((n_acc, n_inst)) < 0.5
        out["pside"] = rng.random(prop) < 0.5
    if f.p_asym > 0.0:
        one_way = rng.random(lane) < f.p_asym
        cut_req = rng.random(lane) < 0.5
        out["part_dir"] = np.where(one_way, np.where(cut_req, 1, 2), 0).astype(np.int32)
    if f.p_flaky > 0.0:
        flaky = rng.random(edge) < f.p_flaky

        def thresholds(top, base):
            rate = np.where(flaky, rng.random(edge, dtype=np.float32) * np.float32(top), np.float32(base))
            return rate_threshold(torch.from_numpy(rate.astype(np.float32))).numpy()

        out["link_drop"] = thresholds(f.flaky_drop, f.p_drop)
        if links_dup(f):
            out["link_dup"] = thresholds(f.flaky_dup, f.p_dup)
    if f.timeout_skew > 0:
        out["ptimeout"] = rng.integers(0, f.timeout_skew + 1, prop).astype(np.int32)
    if f.backoff_skew > 1:
        out["pboff"] = rng.integers(1, f.backoff_skew + 1, prop).astype(np.int32)
    return out


def config_plan(cfg, seed: int, device="cuda"):
    """``cfg``'s own plan distribution (the JAX package's
    ``FaultPlan.sample``: crash starts U[0, crash_max_start), lengths
    U[1, crash_max_len]; slow links with p ``p_delay``, caps
    U[1, delay_max]; the partition and gray-failure fields of
    :func:`gray_plan_fields`) drawn from a numpy stream."""
    f = cfg.fault
    return fault_plan(
        cfg.n_inst, cfg.n_acc, cfg.n_prop, f.p_equiv, seed, f.p_crash, f.p_crash_prop,
        f.crash_max_start, f.crash_max_len, device, f.p_delay, f.delay_max, gray=f,
    )
