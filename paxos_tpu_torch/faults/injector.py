"""Fault config and plan (counterpart of ``paxos_tpu/faults/injector.py``).

:class:`FaultConfig` mirrors the reference's static knobs field for field,
with the same defaults, so a config converts by ``dataclasses.asdict``.
:class:`FaultPlan` holds the per-run crash windows, equivocation flags and
partition windows and sides, and the reference's optional gray-failure
fields, each present when a knob gates it on: the one-way cut direction
(``part_dir``, ``p_asym``), the per-link loss and duplication thresholds
(``link_drop``, ``link_dup``, ``p_flaky``), the per-proposer timer skew
(``ptimeout``, ``pboff``) and the per-link latency caps of the
bounded-delay channel (``link_delay``, ``p_delay``).  The port does not
sample plans yet (the reference draws them with ``jax.random``):
:meth:`FaultPlan.none` is exact for configs with no plan knob, and any
other plan is carried across from the reference as numpy arrays
(:meth:`FaultPlan.from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NEVER = (1 << 31) - 1  # int32 max: "no crash / no partition"
INT32_MIN = -(1 << 31)


def rate_threshold(rate) -> torch.Tensor:
    """uint32 threshold (as int32 bit pattern) with P(bits < t) ~= rate,
    quantized through float32 like the reference."""
    t = torch.clamp(torch.as_tensor(rate, dtype=torch.float32), 0.0, 1.0)
    t = torch.minimum(t * float(1 << 32), torch.tensor(float((1 << 32) - 256)))
    u = t.to(torch.int64)  # float32 -> integer truncates toward zero
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def bits_below(bits: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """True where uint32(bits) < uint32(threshold), both int32 bit patterns
    (sign-flip unsigned compare)."""
    return (bits ^ INT32_MIN) < (threshold ^ INT32_MIN)


def links_dup(cfg: "FaultConfig") -> bool:
    """Per-link duplication is live: flaky links exist and some dup rate > 0."""
    return cfg.p_flaky > 0.0 and (cfg.p_dup > 0.0 or cfg.flaky_dup > 0.0)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static fault probabilities and protocol timing knobs (mirror)."""

    p_drop: float = 0.0
    p_dup: float = 0.0
    p_idle: float = 0.0
    p_hold: float = 0.0
    p_crash: float = 0.0
    p_crash_prop: float = 0.0
    crash_max_start: int = 32
    crash_max_len: int = 16
    crash_forever: bool = False
    amnesia: bool = False
    p_part: float = 0.0
    part_max_start: int = 32
    part_max_len: int = 16
    p_equiv: float = 0.0
    p_asym: float = 0.0
    p_flaky: float = 0.0
    flaky_drop: float = 0.5
    flaky_dup: float = 0.0
    p_corrupt: float = 0.0
    timeout_skew: int = 0
    backoff_skew: int = 0
    stale_k: int = 0
    p_delay: float = 0.0
    delay_max: int = 4
    delta: int = 4
    sp_unsafe_fast: bool = False
    timeout: int = 10
    backoff_max: int = 8
    ballot_stride: int = 1
    q1: int = 0
    q2: int = 0
    q_fast: int = 0
    lease_len: int = 24
    log_total: int = 0


_BASE_FIELDS = (
    "crash_start", "crash_end", "equivocate", "pcrash_start", "pcrash_end",
    "part_start", "part_end", "aside", "pside",
)
_BOOL_FIELDS = frozenset({"equivocate", "aside", "pside"})
# The reference's optional plan fields in flatten order, each with the knob
# test that puts it in a sampled plan.
_OPTIONAL_FIELDS = (
    ("part_dir", lambda f: f.p_asym > 0.0),
    ("link_drop", lambda f: f.p_flaky > 0.0),
    ("link_dup", links_dup),
    ("ptimeout", lambda f: f.timeout_skew > 0),
    ("pboff", lambda f: f.backoff_skew > 1),
    ("link_delay", lambda f: f.p_delay > 0.0),
)
OPTIONAL_FIELDS = tuple(name for name, _ in _OPTIONAL_FIELDS)


def optional_fields(cfg: "FaultConfig") -> list:
    """The optional plan fields a plan sampled for ``cfg`` holds, in
    flatten order."""
    return [name for name, on in _OPTIONAL_FIELDS if on(cfg)]


@dataclasses.dataclass
class FaultPlan:
    """Per-run static fault schedule, instance-minor like the state."""

    crash_start: torch.Tensor  # (A, I) int32 tick; NEVER if no crash
    crash_end: torch.Tensor  # (A, I) int32 tick; NEVER if permanent
    equivocate: torch.Tensor  # (A, I) bool
    pcrash_start: torch.Tensor  # (P, I) int32 proposer crash window
    pcrash_end: torch.Tensor  # (P, I) int32
    part_start: torch.Tensor  # (I,) int32 partition window; NEVER if none
    part_end: torch.Tensor  # (I,) int32
    aside: torch.Tensor  # (A, I) bool acceptor's side of the cut
    pside: torch.Tensor  # (P, I) bool proposer's side of the cut
    # The gray-failure fields, None when the knob that gates them is off.
    # (I,) int32 cut direction: 0 two-way, 1 only requests P->A cut, 2 only
    # replies A->P cut (p_asym).
    part_dir: Optional[torch.Tensor] = None
    # (P, A, I) int32 per-link drop and duplication thresholds, uint32 in
    # int32 bit patterns (p_flaky; link_dup also needs a dup rate > 0).
    link_drop: Optional[torch.Tensor] = None
    link_dup: Optional[torch.Tensor] = None
    ptimeout: Optional[torch.Tensor] = None  # (P, I) int32 extra timeout ticks
    pboff: Optional[torch.Tensor] = None  # (P, I) int32 backoff multiplier >= 1
    # (P, A, I) int32 per-link latency cap in ticks, 0 = the link never
    # delays (p_delay).
    link_delay: Optional[torch.Tensor] = None

    @classmethod
    def none(
        cls, n_inst: int, n_acc: int, n_prop: int = 1, device="cpu",
        cfg: "FaultConfig | None" = None,
    ) -> "FaultPlan":
        """The fault-free plan.  With ``cfg``, the fields its knobs gate on
        are present but benign (no cut direction, every link at the uniform
        ``p_drop`` / ``p_dup`` threshold, no skew, ``link_delay`` all 0), so
        the plan has the structure of one the reference samples for
        ``cfg``."""

        def never(shape):
            return torch.full(shape, NEVER, dtype=torch.int32, device=device)

        def false(shape):
            return torch.zeros(shape, dtype=torch.bool, device=device)

        def full(shape, value):
            return torch.full(shape, int(value), dtype=torch.int32, device=device)

        acc, prop, lane = (n_acc, n_inst), (n_prop, n_inst), (n_inst,)
        edge = (n_prop, n_acc, n_inst)
        benign = {
            "part_dir": lambda f: full(lane, 0),
            "link_drop": lambda f: full(edge, rate_threshold(f.p_drop)),
            "link_dup": lambda f: full(edge, rate_threshold(f.p_dup)),
            "ptimeout": lambda f: full(prop, 0),
            "pboff": lambda f: full(prop, 1),
            "link_delay": lambda f: full(edge, 0),
        }
        gray = {name: benign[name](cfg) for name in (optional_fields(cfg) if cfg else ())}
        return cls(
            crash_start=never(acc), crash_end=never(acc),
            equivocate=false(acc),
            pcrash_start=never(prop), pcrash_end=never(prop),
            part_start=never(lane), part_end=never(lane),
            aside=false(acc), pside=false(prop),
            **gray,
        )

    @classmethod
    def from_numpy(cls, leaves, device="cpu", cfg: "FaultConfig | None" = None) -> "FaultPlan":
        """A plan from the reference's plan leaves in flatten order.

        The reference's optional fields follow the nine base fields, each
        present when a knob of its config gates it on, so which fields the
        leaves past the ninth are (a tenth leaf may be ``part_dir`` or
        ``link_delay`` alike) comes from ``cfg``; without it the plan has
        the base fields only."""
        leaves = list(leaves)
        names = _BASE_FIELDS + tuple(optional_fields(cfg) if cfg else ())
        if len(leaves) != len(names):
            raise ValueError(
                f"plan has {len(leaves)} leaves; a plan for this config has "
                f"{len(names)} ({', '.join(names)}): pass the config (cfg=) "
                "whose knobs gate the optional fields"
            )
        fields = {}
        for name, leaf in zip(names, leaves):
            dtype = torch.bool if name in _BOOL_FIELDS else torch.int32
            arr = np.asarray(leaf)
            want = np.bool_ if dtype is torch.bool else np.int32
            if arr.dtype != want:
                raise ValueError(f"plan field {name}: dtype {arr.dtype}, want {want}")
            fields[name] = torch.from_numpy(arr.copy()).to(device)
        return cls(**fields)

    def leaves(self) -> list:
        """The reference's flatten order (absent optional fields dropped)."""
        names = _BASE_FIELDS + OPTIONAL_FIELDS
        return [getattr(self, n) for n in names if getattr(self, n) is not None]

    def to(self, device) -> "FaultPlan":
        return FaultPlan(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    def alive(self, tick) -> torch.Tensor:
        """(A, I) bool: acceptor is up at ``tick``."""
        return ~((self.crash_start <= tick) & (tick < self.crash_end))

    def link_ok(self, tick, direction: "str | None" = None) -> torch.Tensor:
        """(P, A, I) bool: the proposer<->acceptor link delivers at ``tick``.

        False only inside the lane's partition window for pairs on opposite
        sides of the cut.  ``direction`` (``"req"``: proposer -> acceptor,
        ``"rep"``: acceptor -> proposer) reads a one-way cut from
        ``part_dir``: 1 cuts requests only, 2 replies only, 0 both; without
        a direction or a ``part_dir`` the cut is two-way."""
        cut = (self.part_start <= tick) & (tick < self.part_end)  # (I,)
        if direction is not None and self.part_dir is not None:
            spares = 2 if direction == "req" else 1
            cut = cut & (self.part_dir != spares)
        same = self.pside[:, None] == self.aside[None]  # (P, A, I)
        return same | ~cut[None, None]

    def prop_alive(self, tick) -> torch.Tensor:
        """(P, I) bool: proposer is up at ``tick``."""
        return ~((self.pcrash_start <= tick) & (tick < self.pcrash_end))

    def recovering(self, tick) -> torch.Tensor:
        """(A, I) bool: acceptor comes back up exactly at ``tick``."""
        return self.crash_end == tick
