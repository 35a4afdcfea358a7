"""On-device flight recorder and event counters (counterpart of
``paxos_tpu/core/telemetry.py``; default off).

- :class:`TelemetryState`: per-lane int32 tensors, an event-kind counter
  matrix, a packed event ring (the flight recorder) with its cursor and
  word count, and a ticks-to-decide histogram;
- :func:`record`: one tick's update from signals the tick already
  produced; it draws nothing, so the plane cannot move a schedule;
- host decoders (:func:`decode_word`, :func:`decode_lane`,
  :func:`counter_totals`, :func:`hist_totals`) and the report's two halves
  (:func:`telemetry_device`, reductions on the device; :func:`telemetry_host`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Event kinds: bit i of a ring word's high half, and row i of the counters.
EVENTS = (
    "promise", "accept", "decide", "conflict", "leader", "timeout", "drop", "dup", "corrupt",
    "part_cut", "part_heal", "recover",
)
N_EVENTS = len(EVENTS)

# Ring word: (event bitmask << EVENT_SHIFT) | (tick & TICK_MASK).
EVENT_SHIFT = 16
TICK_MASK = (1 << EVENT_SHIFT) - 1

# Decide-latency histogram: bucket min(tick // HIST_TICKS_PER_BIN, bins - 1).
HIST_TICKS_PER_BIN = 8


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry knobs, all off by default; any knob on allocates the
    counters, the ring and the histogram are gated on their own."""

    counters: bool = False
    ring_depth: int = 0
    hist_bins: int = 0

    def enabled(self) -> bool:
        return self.counters or self.ring_depth > 0 or self.hist_bins > 0


@dataclasses.dataclass
class TelemetryState:
    counters: torch.Tensor  # (E, I) int32 per event kind
    ring: Optional[torch.Tensor] = None  # (D, I) int32 packed event words
    cursor: Optional[torch.Tensor] = None  # (I,) int32 next ring slot in [0, D)
    seq: Optional[torch.Tensor] = None  # (I,) int32 words ever written
    hist: Optional[torch.Tensor] = None  # (B, I) int32 decide-latency bins

    @classmethod
    def init(cls, n_inst: int, tcfg: TelemetryConfig, device="cpu") -> "TelemetryState":
        def zeros(*shape):
            return torch.zeros(shape + (n_inst,), dtype=torch.int32, device=device)

        ring_on = tcfg.ring_depth > 0
        return cls(
            counters=zeros(N_EVENTS),
            ring=zeros(tcfg.ring_depth) if ring_on else None,
            cursor=zeros() if ring_on else None,
            seq=zeros() if ring_on else None,
            hist=zeros(tcfg.hist_bins) if tcfg.hist_bins > 0 else None,
        )

    def leaves(self) -> list:
        return [x for x in (self.counters, self.ring, self.cursor, self.seq, self.hist)
                if x is not None]


def lane_count(x: torch.Tensor) -> torch.Tensor:
    """A bool or int event signal with any leading axes, summed to (I,) int32."""
    x = x.to(torch.int32)
    if x.dim() > 1:
        x = x.sum(dim=tuple(range(x.dim() - 1)), dtype=torch.int32)
    return x


def record(
    tel: TelemetryState, tick, *, promise=None, accept=None, decide=None, conflict=None,
    leader=None, timeout=None, drop=None, dup=None, corrupt=None, part_cut=None,
    part_heal=None, recover=None,
) -> TelemetryState:
    """One tick's update.  Each keyword is None (the event does not apply or
    its knob is off) or a bool or int32 tensor whose last axis is the
    instances, its leading axes summed to a count a lane.  The counters add
    the counts; the ring takes one word a lane where any event happened
    (the OR of the tick's event bits with the tick); the histogram adds
    ``decide`` into bucket ``tick // HIST_TICKS_PER_BIN``."""
    counts = (promise, accept, decide, conflict, leader, timeout, drop, dup, corrupt,
              part_cut, part_heal, recover)
    counters = tel.counters.clone()
    word_bits = torch.zeros_like(counters[0])
    for e, c in enumerate(counts):
        if c is None:
            continue
        c = lane_count(c)
        counters[e] += c
        word_bits |= torch.where(c > 0, 1 << e, 0).to(torch.int32)
    tel = dataclasses.replace(tel, counters=counters)
    if tel.ring is not None:
        depth = tel.ring.shape[0]
        has = word_bits != 0
        word = (word_bits << EVENT_SHIFT) | (tick & TICK_MASK)
        rows = torch.arange(depth, dtype=torch.int32, device=word.device)[:, None]
        hit = (rows == tel.cursor[None]) & has[None]
        step = has.to(torch.int32)
        nxt = tel.cursor + step
        tel = dataclasses.replace(
            tel,
            ring=torch.where(hit, word[None], tel.ring),
            cursor=torch.where(nxt >= depth, 0, nxt).to(torch.int32),
            seq=tel.seq + step,
        )
    if tel.hist is not None and decide is not None:
        bins = tel.hist.shape[0]
        bucket = torch.clamp(tick // HIST_TICKS_PER_BIN, max=bins - 1)
        rows = torch.arange(bins, dtype=torch.int32, device=tel.hist.device)[:, None]
        tel = dataclasses.replace(
            tel, hist=tel.hist + torch.where(rows == bucket, lane_count(decide)[None], 0)
        )
    return tel


def fault_lane_events(plan, cfg, tick) -> dict:
    """The fault plan's edge events at ``tick`` as :func:`record` keywords
    (``part_cut``, ``part_heal``, ``recover``), each None where its knob is
    off."""
    out = {"part_cut": None, "part_heal": None, "recover": None}
    if cfg.p_part > 0.0:
        out["part_cut"] = plan.part_start == tick
        out["part_heal"] = plan.part_end == tick
    rec = None
    if cfg.p_crash > 0.0:
        rec = lane_count(plan.crash_end == tick)
    if cfg.p_crash_prop > 0.0:
        prec = lane_count(plan.pcrash_end == tick)
        rec = prec if rec is None else rec + prec
    out["recover"] = rec
    return out


# ---- Host decoding and the report ----


def decode_word(word: int) -> dict:
    """One packed ring word -> {"tick": int, "events": [names]}."""
    word = int(word)
    bits = (word >> EVENT_SHIFT) & ((1 << N_EVENTS) - 1)
    return {
        "tick": word & TICK_MASK,
        "events": [EVENTS[i] for i in range(N_EVENTS) if (bits >> i) & 1],
    }


def decode_lane(tel: TelemetryState, lane: int) -> list:
    """Lane ``lane``'s recorded events, oldest first (empty without a ring)."""
    if tel.ring is None:
        return []
    ring = tel.ring[:, lane].cpu().tolist()
    cursor, seq = int(tel.cursor[lane]), int(tel.seq[lane])
    words = ring[:seq] if seq <= len(ring) else ring[cursor:] + ring[:cursor]
    return [decode_word(w) for w in words]


def counter_totals(tel: TelemetryState) -> dict:
    """Event counts summed over lanes: {name: int}."""
    totals = tel.counters.sum(dim=-1, dtype=torch.int64).cpu().tolist()
    return dict(zip(EVENTS, totals))


def hist_saturation(counts: list) -> dict:
    """Overflow of a decoded decide-latency histogram: its last bin is a
    catch-all, so a count there means the in-range bins under-describe
    the tail."""
    if len(counts) < 2:
        return {"overflow": 0, "saturated": False}
    overflow = int(counts[-1])
    return {"overflow": overflow, "saturated": overflow > 0}


def hist_totals(tel: TelemetryState, with_saturation: bool = False):
    """The decide-latency histogram summed over lanes (and, with
    ``with_saturation``, :func:`hist_saturation` of it)."""
    counts = [] if tel.hist is None else tel.hist.sum(dim=-1, dtype=torch.int64).cpu().tolist()
    return (counts, hist_saturation(counts)) if with_saturation else counts


def telemetry_device(tel: TelemetryState) -> dict:
    """Device half of the report: reductions only (int64 sums, exact where
    the reference's int32 sums would wrap)."""
    dev = {"counters": tel.counters.sum(dim=-1, dtype=torch.int64)}
    if tel.hist is not None:
        dev["hist"] = tel.hist.sum(dim=-1, dtype=torch.int64)
    if tel.seq is not None:
        dev["seq"] = tel.seq.sum(dtype=torch.int64)
    return dev


def telemetry_host(host: dict) -> dict:
    """Format the fetched :func:`telemetry_device` dict."""
    report = {"counters": {name: int(v) for name, v in zip(EVENTS, host["counters"])}}
    if "hist" in host:
        report["hist"] = [int(v) for v in host["hist"]]
        report["hist_ticks_per_bin"] = HIST_TICKS_PER_BIN
        sat = hist_saturation(report["hist"])
        report["hist_overflow"] = sat["overflow"]
        report["hist_saturated"] = sat["saturated"]
    if "seq" in host:
        report["events_recorded"] = int(host["seq"])
    return report
