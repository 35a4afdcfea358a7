"""Fault config and plan (counterpart of ``paxos_tpu/faults/injector.py``).

:class:`FaultConfig` mirrors the reference's static knobs field for field,
with the same defaults, so a config converts by ``dataclasses.asdict``.
:class:`FaultPlan` holds the per-run crash windows, equivocation flags and
partition sides.  The port does not sample plans yet (the reference draws
them with ``jax.random``): :meth:`FaultPlan.none` is exact for configs with
no crash, partition or equivocation knob, and any other plan is carried
across from the reference as numpy arrays (:meth:`FaultPlan.from_numpy`).
The gray-failure plan fields are not ported yet.
"""

from __future__ import annotations

import dataclasses

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

    @classmethod
    def none(
        cls, n_inst: int, n_acc: int, n_prop: int = 1, device="cpu"
    ) -> "FaultPlan":
        """The fault-free plan."""

        def never(shape):
            return torch.full(shape, NEVER, dtype=torch.int32, device=device)

        def false(shape):
            return torch.zeros(shape, dtype=torch.bool, device=device)

        acc, prop, lane = (n_acc, n_inst), (n_prop, n_inst), (n_inst,)
        return cls(
            crash_start=never(acc), crash_end=never(acc),
            equivocate=false(acc),
            pcrash_start=never(prop), pcrash_end=never(prop),
            part_start=never(lane), part_end=never(lane),
            aside=false(acc), pside=false(prop),
        )

    @classmethod
    def from_numpy(cls, leaves, device="cpu") -> "FaultPlan":
        """A plan from the reference's plan leaves in flatten order."""
        leaves = list(leaves)
        if len(leaves) != len(_BASE_FIELDS):
            raise NotImplementedError(
                f"plan has {len(leaves)} leaves; only the {len(_BASE_FIELDS)} "
                "base fields are ported (gray-failure plan fields: ROADMAP "
                "queue A, slice 5 item 12)"
            )
        fields = {}
        for name, leaf in zip(_BASE_FIELDS, leaves):
            dtype = torch.bool if name in _BOOL_FIELDS else torch.int32
            arr = np.asarray(leaf)
            want = np.bool_ if dtype is torch.bool else np.int32
            if arr.dtype != want:
                raise ValueError(f"plan field {name}: dtype {arr.dtype}, want {want}")
            fields[name] = torch.from_numpy(arr.copy()).to(device)
        return cls(**fields)

    def leaves(self) -> list:
        return [getattr(self, name) for name in _BASE_FIELDS]

    def alive(self, tick) -> torch.Tensor:
        """(A, I) bool: acceptor is up at ``tick``."""
        return ~((self.crash_start <= tick) & (tick < self.crash_end))

    def prop_alive(self, tick) -> torch.Tensor:
        """(P, I) bool: proposer is up at ``tick``."""
        return ~((self.pcrash_start <= tick) & (tick < self.pcrash_end))

    def recovering(self, tick) -> torch.Tensor:
        """(A, I) bool: acceptor comes back up exactly at ``tick``."""
        return self.crash_end == tick
