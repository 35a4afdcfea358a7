"""Open-loop client arrivals and on-device queue accounting (counterpart of
``paxos_tpu/workload/generator.py``; default off).

Per (proposer, instance):

- arrivals (:func:`arrival_threshold`): one Bernoulli draw a tick (the
  ``ARRIVAL`` stream of the tick's mask sampler) against a threshold set by
  the lane's class (``mode``): Poisson (a constant rate), bursty (a
  ``burst_len``-tick window at ``burst_rate`` every ``period`` ticks) or
  diurnal (a triangle wave between the two rates), at the lane's ``phase``;
- a bounded queue (:func:`observe`) of enqueue-tick stamps: a tick serves
  first (on the proposer's commit edge), then enqueues; an arrival that
  finds the queue full is shed; a serve banks its latency, queue delay
  included, into a per-class log2 histogram (``obs.slo`` reduces it).

The class and phase of each lane are the workload's plan: the reference
samples them with ``jax.random`` (ROADMAP item 15, not ported), so
:meth:`WloadState.init` takes them as given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paxos_tpu_torch.faults.injector import bits_below
from paxos_tpu_torch.kernels.counter_prng import M32, to_i32

# Workload classes in mode order (the rows of the per-class histogram).
CLASSES = ("poisson", "bursty", "diurnal")
MIXES = ("off",) + CLASSES + ("mixed",)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Static workload knobs; ``mix="off"`` disables the plane.  A named
    mix pins every lane to that class, ``"mixed"`` samples one a lane."""

    mix: str = "off"
    rate: float = 0.05  # baseline arrival probability a tick
    burst_rate: float = 0.5  # peak probability (bursty window, diurnal crest)
    period: int = 32  # bursty / diurnal cycle, ticks
    burst_len: int = 8  # bursty window, ticks
    queue_cap: int = 8  # queue depth a proposer
    hist_bins: int = 16  # log2 latency buckets (bucket b: [2^b, 2^(b+1)))
    slo_p99_ticks: int = 0  # per-class p99 SLO; 0: no gating

    def enabled(self) -> bool:
        return self.mix != "off"

    def validate(self) -> None:
        if self.mix not in MIXES:
            raise ValueError(f"workload mix {self.mix!r} not in {MIXES}")
        if self.enabled():
            if not 2 <= self.period:
                raise ValueError("workload period must be >= 2 ticks")
            if not 1 <= self.burst_len <= self.period:
                raise ValueError("workload burst_len must be in [1, period]")
            if not 1 <= self.queue_cap <= 64:
                raise ValueError("workload queue_cap must be in [1, 64]")
            if not 2 <= self.hist_bins <= 24:
                raise ValueError("workload hist_bins must be in [2, 24]")
            if not 0.0 <= self.rate <= 1.0:
                raise ValueError("workload rate must be in [0, 1]")
            if not 0.0 <= self.burst_rate <= 1.0:
                raise ValueError("workload burst_rate must be in [0, 1]")


def rate_to_threshold(p: float) -> int:
    """uint32 Bernoulli threshold of rate ``p`` (Python ``round``, as the
    reference's)."""
    return max(0, min(int(round(p * float(1 << 32))), (1 << 32) - 1))


def threshold_terms(cfg: WorkloadConfig) -> tuple:
    """(t_lo, t_hi, step): the baseline and peak thresholds, and the
    diurnal class's threshold step a tick of its triangle (an int, possibly
    negative), as uint32-valued ints but the step."""
    t_lo = rate_to_threshold(cfg.rate)
    t_hi = rate_to_threshold(cfg.burst_rate)
    return t_lo, t_hi, (t_hi - t_lo) // max(cfg.period // 2, 1)


@dataclasses.dataclass
class WloadState:
    mode: torch.Tensor  # (P, I) int32 class, an index of CLASSES
    phase: torch.Tensor  # (P, I) int32 cycle offset in [0, period)
    ring: torch.Tensor  # (Q, P, I) int32 enqueue-tick stamps (circular)
    head: torch.Tensor  # (P, I) int32 read index in [0, Q)
    depth: torch.Tensor  # (P, I) int32 queue depth in [0, Q]
    depth_peak: torch.Tensor  # (P, I) int32 running max of depth
    offered: torch.Tensor  # (P, I) int32 arrivals
    done: torch.Tensor  # (P, I) int32 requests served
    shed: torch.Tensor  # (P, I) int32 arrivals dropped on a full queue
    hist: torch.Tensor  # (C*B, I) int32 per-class log2 latency buckets
    cfg: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)

    @classmethod
    def init(cls, n_inst: int, n_prop: int, cfg: WorkloadConfig, mode, phase,
             device="cpu") -> "WloadState":
        """An empty queue on the workload plan ``mode`` and ``phase`` ((P, I)
        int32 each, tensors or numpy arrays; a mix other than "mixed" pins
        every lane's class)."""
        cfg.validate()
        shape = (n_prop, n_inst)
        mode, phase = _plan_tensor(mode, device), _plan_tensor(phase, device)
        if tuple(mode.shape) != shape or tuple(phase.shape) != shape:
            raise ValueError(f"workload mode and phase must be {shape}")
        if cfg.mix != "mixed" and bool((mode != CLASSES.index(cfg.mix)).any()):
            raise ValueError(f"workload mix {cfg.mix!r} pins every lane's mode")
        if bool(((mode < 0) | (mode >= len(CLASSES))).any()) or bool(
            ((phase < 0) | (phase >= cfg.period)).any()
        ):
            raise ValueError("workload mode or phase out of range")

        def z(*lead):
            return torch.zeros(lead + shape, dtype=torch.int32, device=device)

        return cls(
            mode=mode, phase=phase, ring=z(cfg.queue_cap), head=z(),
            depth=z(), depth_peak=z(), offered=z(), done=z(), shed=z(),
            hist=torch.zeros((len(CLASSES) * cfg.hist_bins, n_inst), dtype=torch.int32,
                             device=device),
            cfg=cfg,
        )

    def leaves(self) -> list:
        return [self.mode, self.phase, self.ring, self.head, self.depth, self.depth_peak,
                self.offered, self.done, self.shed, self.hist]


def _plan_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)


def arrival_threshold(wl: WloadState, tick) -> torch.Tensor:
    """(P, I) int32 bit pattern of this tick's uint32 arrival threshold."""
    cfg = wl.cfg
    t_lo, t_hi, step = threshold_terms(cfg)
    pos = torch.remainder(tick + wl.phase.to(torch.int64), cfg.period)
    thr = torch.full_like(pos, t_lo)
    thr = torch.where((wl.mode == 1) & (pos < cfg.burst_len), t_hi, thr)
    tri = torch.minimum(pos, cfg.period - pos)
    thr = torch.where(wl.mode == 2, (t_lo + step * tri) & M32, thr)
    return to_i32(thr)


def observe(wl: WloadState, tick, serve: torch.Tensor, arrival_bits: torch.Tensor) -> WloadState:
    """One tick of the queue: serve first (``serve``, the proposer's commit
    edge, pops the head stamp and banks its latency), then enqueue this
    tick's arrival (``arrival_bits`` against :func:`arrival_threshold`), so
    the least latency is 1 tick."""
    cfg = wl.cfg
    cap, bins = cfg.queue_cap, cfg.hist_bins
    dev = wl.head.device
    rowq = torch.arange(cap, dtype=torch.int32, device=dev)[:, None, None]

    pop = serve & (wl.depth > 0)
    stamp = torch.where(rowq == wl.head[None], wl.ring, 0).sum(dim=0, dtype=torch.int32)
    latency = tick - stamp
    bucket = torch.zeros_like(latency)
    for k in range(1, bins):
        bucket += (latency >= (1 << k)).to(torch.int32)
    hist_row = wl.mode * bins + bucket  # (P, I)
    rowh = torch.arange(wl.hist.shape[0], dtype=torch.int32, device=dev)[:, None, None]
    hist = wl.hist + ((rowh == hist_row[None]) & pop[None]).sum(dim=1, dtype=torch.int32)
    head1 = wl.head + 1
    head = torch.where(pop, torch.where(head1 >= cap, head1 - cap, head1), wl.head)
    depth = wl.depth - pop.to(torch.int32)

    arrival = bits_below(arrival_bits, arrival_threshold(wl, tick))
    room = depth < cap
    enq = arrival & room
    slot = head + depth
    slot = torch.where(slot >= cap, slot - cap, slot)
    ring = torch.where((rowq == slot[None]) & enq[None], tick.to(torch.int32), wl.ring)
    depth = depth + enq.to(torch.int32)
    return dataclasses.replace(
        wl,
        ring=ring,
        head=head.to(torch.int32),
        depth=depth,
        depth_peak=torch.maximum(wl.depth_peak, depth),
        offered=wl.offered + arrival.to(torch.int32),
        done=wl.done + pop.to(torch.int32),
        shed=wl.shed + (arrival & ~room).to(torch.int32),
        hist=hist,
    )
