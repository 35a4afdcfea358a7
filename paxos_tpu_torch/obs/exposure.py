"""Fault-exposure counters (counterpart of ``paxos_tpu/obs/exposure.py``;
default off): per lane and fault class, the faults **injected** (the
mask fired) and the faults **effective** (the fault changed something a
participant did or saw).

Classes, in row order (:data:`CLASSES`):

- ``drop``: drop decisions on send edges / live sends they discarded;
- ``dup``: slots flagged for redelivery / flagged slots being consumed;
- ``corrupt``: corruption masks / corruptions of a payload an acceptor read;
- ``partition``: link directions cut / messages in flight the cut stalled;
- ``timeout``: proposers with a timer skew / expiry decisions the skew changed;
- ``stale``: snapshot restores (injected == effective);
- ``delay``: delays drawn on send edges / messages stalled behind a stamp.

:func:`record` draws nothing, so the plane cannot move a schedule.
"""

from __future__ import annotations

import dataclasses

import torch

from paxos_tpu_torch.core.telemetry import lane_count
from paxos_tpu_torch.faults.injector import links_dup

CLASSES = ("drop", "dup", "corrupt", "partition", "timeout", "stale", "delay")


@dataclasses.dataclass(frozen=True)
class ExposureConfig:
    counters: bool = False

    def enabled(self) -> bool:
        return self.counters


@dataclasses.dataclass
class FaultExposure:
    injected: torch.Tensor  # (C, I) int32 fault events sampled, per class
    effective: torch.Tensor  # (C, I) int32 events that fired

    @classmethod
    def init(cls, n_inst: int, device="cpu") -> "FaultExposure":
        shape = (len(CLASSES), n_inst)
        return cls(
            injected=torch.zeros(shape, dtype=torch.int32, device=device),
            effective=torch.zeros(shape, dtype=torch.int32, device=device),
        )

    def leaves(self) -> list:
        return [self.injected, self.effective]


def _accumulate(arr: torch.Tensor, counts: dict) -> torch.Tensor:
    arr = arr.clone()
    for c, name in enumerate(CLASSES):
        v = counts.get(name)
        if v is not None:
            arr[c] += lane_count(v)
    return arr


def record(exp: FaultExposure, **classes) -> FaultExposure:
    """Add one tick's ``(injected, effective)`` pair per class name; each
    element is a bool event tensor or an (I,) int32 count (leading axes
    summed), or None for zero.  Omitted classes add nothing."""
    unknown = set(classes) - set(CLASSES)
    if unknown:
        raise ValueError(f"unknown exposure classes: {sorted(unknown)}")
    inj = {k: v[0] for k, v in classes.items() if v is not None}
    eff = {k: v[1] for k, v in classes.items() if v is not None}
    return FaultExposure(_accumulate(exp.injected, inj), _accumulate(exp.effective, eff))


def exposure_device(exp: FaultExposure) -> dict:
    """Device half of the report: totals per class and the lanes where a
    fault of the class was effective at least once."""
    return {
        "injected": exp.injected.sum(dim=-1, dtype=torch.int64),
        "effective": exp.effective.sum(dim=-1, dtype=torch.int64),
        "lanes_exposed": (exp.effective > 0).sum(dim=-1, dtype=torch.int64),
    }


def exposure_host(host: dict) -> dict:
    """Format the fetched :func:`exposure_device` dict."""
    return {"classes": {
        name: {
            "injected": int(host["injected"][c]),
            "effective": int(host["effective"][c]),
            "lanes_exposed": int(host["lanes_exposed"][c]),
        }
        for c, name in enumerate(CLASSES)
    }}


def exposure_lit(fcfg) -> dict:
    """Which classes a fault config can inject: {class: bool}."""
    return {
        "drop": fcfg.p_drop > 0.0 or (fcfg.p_flaky > 0.0 and fcfg.flaky_drop > 0.0),
        "dup": fcfg.p_dup > 0.0 or links_dup(fcfg),
        "corrupt": fcfg.p_corrupt > 0.0,
        "partition": fcfg.p_part > 0.0,
        "timeout": fcfg.timeout_skew > 0,
        "stale": fcfg.stale_k > 0,
        "delay": fcfg.p_delay > 0.0,
    }


def annotate_lit(report: dict, fcfg) -> dict:
    """The report with ``lit`` (the classes whose knob is on) and
    ``vacuous`` (lit classes that never were effective)."""
    lit = exposure_lit(fcfg)
    out = dict(report)
    out["lit"] = sorted(n for n, on in lit.items() if on)
    out["vacuous"] = sorted(
        n for n, on in lit.items() if on and report["classes"][n]["effective"] == 0
    )
    return out
