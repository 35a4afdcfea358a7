"""Fault config and plan (counterpart of ``paxos_tpu/faults/injector.py``).

:class:`FaultConfig` mirrors the reference's static knobs field for field,
with the same defaults, so a config converts by ``dataclasses.asdict``.
:class:`FaultPlan` holds the per-run crash windows, equivocation flags and
partition sides, and the per-link latency caps of the bounded-delay channel
(``link_delay``, present when ``p_delay > 0``).  The port does not sample
plans yet (the reference draws them with ``jax.random``):
:meth:`FaultPlan.none` is exact for configs with no crash, partition,
equivocation or delay knob, and any other plan is carried across from the
reference as numpy arrays (:meth:`FaultPlan.from_numpy`).  The other
gray-failure plan fields are not ported yet.
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
# test that puts it in a sampled plan; of these only link_delay is ported.
_OPTIONAL_FIELDS = (
    ("part_dir", lambda f: f.p_asym > 0.0),
    ("link_drop", lambda f: f.p_flaky > 0.0),
    ("link_dup", lambda f: f.p_flaky > 0.0 and (f.p_dup > 0.0 or f.flaky_dup > 0.0)),
    ("ptimeout", lambda f: f.timeout_skew > 0),
    ("pboff", lambda f: f.backoff_skew > 1),
    ("link_delay", lambda f: f.p_delay > 0.0),
)


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
    # (P, A, I) int32 per-link latency cap in ticks, 0 = the link never
    # delays (p_delay); None when the config samples no delays.
    link_delay: Optional[torch.Tensor] = None

    @classmethod
    def none(
        cls, n_inst: int, n_acc: int, n_prop: int = 1, device="cpu",
        cfg: "FaultConfig | None" = None,
    ) -> "FaultPlan":
        """The fault-free plan.  With ``cfg``, the fields its knobs gate on
        are present but benign (``link_delay`` all 0), so the plan has the
        structure of one the reference samples for ``cfg``."""

        def never(shape):
            return torch.full(shape, NEVER, dtype=torch.int32, device=device)

        def false(shape):
            return torch.zeros(shape, dtype=torch.bool, device=device)

        acc, prop, lane = (n_acc, n_inst), (n_prop, n_inst), (n_inst,)
        delay = cfg is not None and cfg.p_delay > 0.0
        return cls(
            crash_start=never(acc), crash_end=never(acc),
            equivocate=false(acc),
            pcrash_start=never(prop), pcrash_end=never(prop),
            part_start=never(lane), part_end=never(lane),
            aside=false(acc), pside=false(prop),
            link_delay=(
                torch.zeros((n_prop, n_acc, n_inst), dtype=torch.int32, device=device)
                if delay else None
            ),
        )

    @classmethod
    def from_numpy(cls, leaves, device="cpu", cfg: "FaultConfig | None" = None) -> "FaultPlan":
        """A plan from the reference's plan leaves in flatten order.

        The reference's optional fields follow the nine base fields, each
        present when a knob of its config gates it on, so which field a
        tenth leaf is (``part_dir`` and ``link_delay`` alike) comes from
        ``cfg``; without it the plan has the base fields only."""
        leaves = list(leaves)
        optional = [n for n, on in _OPTIONAL_FIELDS if cfg is not None and on(cfg)]
        unported = [n for n in optional if n != "link_delay"]
        if unported:
            raise NotImplementedError(
                f"plan fields {unported} are not ported to paxos_tpu_torch yet "
                "(gray-failure plan fields: ROADMAP queue A, slice 5 item 12)"
            )
        names = _BASE_FIELDS + tuple(optional)
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
        out = [getattr(self, name) for name in _BASE_FIELDS]
        return out if self.link_delay is None else out + [self.link_delay]

    def to(self, device) -> "FaultPlan":
        return FaultPlan(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    def alive(self, tick) -> torch.Tensor:
        """(A, I) bool: acceptor is up at ``tick``."""
        return ~((self.crash_start <= tick) & (tick < self.crash_end))

    def prop_alive(self, tick) -> torch.Tensor:
        """(P, I) bool: proposer is up at ``tick``."""
        return ~((self.pcrash_start <= tick) & (tick < self.pcrash_end))

    def recovering(self, tick) -> torch.Tensor:
        """(A, I) bool: acceptor comes back up exactly at ``tick``."""
        return self.crash_end == tick
