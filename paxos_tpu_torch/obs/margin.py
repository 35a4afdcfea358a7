"""Near-miss safety margin (counterpart of ``paxos_tpu/obs/margin.py``;
default off): per lane, running extrema of the distance to a violation.

- ``qslack_min``: least quorum slack (``quorum - votes``) of a competing
  learner-table row, a live pair on a decided instance whose value is not
  the chosen one; 0 is a violation, :data:`SENTINEL` while none competed;
- ``near_split``: ticks on which two distinct values each sat within one
  vote of quorum;
- ``bal_gap_min``: least winner-over-rival ballot gap on a decide tick;
- ``promise_slack_min``: least ``promised - acc_bal`` over honest
  acceptors holding an accepted pair.

The fold is ``check.safety.margin_observe``; it draws nothing.
"""

from __future__ import annotations

import dataclasses

import torch

# "No competitor observed" marker of the running minima (int32 max).
SENTINEL = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class MarginConfig:
    counters: bool = False

    def enabled(self) -> bool:
        return self.counters


@dataclasses.dataclass
class MarginState:
    qslack_min: torch.Tensor  # (I,) int32
    near_split: torch.Tensor  # (I,) int32
    bal_gap_min: torch.Tensor  # (I,) int32
    promise_slack_min: torch.Tensor  # (I,) int32

    @classmethod
    def init(cls, n_inst: int, device="cpu") -> "MarginState":
        def full():
            return torch.full((n_inst,), SENTINEL, dtype=torch.int32, device=device)

        return cls(
            qslack_min=full(),
            near_split=torch.zeros((n_inst,), dtype=torch.int32, device=device),
            bal_gap_min=full(),
            promise_slack_min=full(),
        )

    def leaves(self) -> list:
        return [self.qslack_min, self.near_split, self.bal_gap_min, self.promise_slack_min]


def margin_device(m: MarginState) -> dict:
    """Device half of the report: reductions only."""
    i64 = torch.int64
    return {
        "min_quorum_slack": m.qslack_min.min(),
        "near_miss_lanes": (m.qslack_min <= 1).sum(dtype=i64),
        "zero_slack_lanes": (m.qslack_min == 0).sum(dtype=i64),
        "contested_lanes": (m.qslack_min < SENTINEL).sum(dtype=i64),
        "near_split_ticks": m.near_split.sum(dtype=i64),
        "near_split_lanes": (m.near_split > 0).sum(dtype=i64),
        "min_ballot_gap": m.bal_gap_min.min(),
        "min_promise_slack": m.promise_slack_min.min(),
    }


# Report keys whose SENTINEL means "never observed" (None on the host).
_MIN_KEYS = ("min_quorum_slack", "min_ballot_gap", "min_promise_slack")


def margin_host(host: dict) -> dict:
    """Format the fetched :func:`margin_device` dict."""
    out = {}
    for k, v in host.items():
        v = int(v)
        out[k] = None if (k in _MIN_KEYS and v == SENTINEL) else v
    return out
