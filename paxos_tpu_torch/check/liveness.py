"""Liveness statistics (counterpart of ``paxos_tpu/check/liveness.py``):
decided-by-tick curves and stuck-instance detection from the learner's
``chosen`` and ``chosen_tick``.

- :func:`decided_by`: the fraction of instances chosen by tick ``k``;
- :func:`chosen_tick_histogram`: the decision-latency distribution, the
  undecided in the last bin;
- :func:`stuck_mask`: instances still undecided after a tick budget, which
  under a fair scheduler mark a livelock.

Every function takes the single-decree learner, ``chosen`` (I,), and the
Multi-Paxos one, (L, I), where it counts slot-lanes.  A long-log learner
holds the residual window only, and rows whose global slot ``base + l`` is
past ``log_total`` can never be decided: the optional ``valid`` mask
(:func:`window_valid_mask`) drops them from denominators, histograms and
stuck counts.

:func:`liveness_device` reduces on the device to integer counts only (the
decided counts, their denominator, the histogram, the stuck count), so the
report's whole block crosses to the host in the same flat int64 tensor as
the rest of the report (``harness.run.summarize``); :func:`liveness_host`
forms the fractions there as the reference does, a float32 count over a
float32 denominator, which is exact while a count stays below 2^24.
"""

from __future__ import annotations

import torch

N_POINTS = 8  # points of the decided-by curve
N_BINS = 16  # histogram bins, the last one the undecided


def window_valid_mask(chosen_shape, base: torch.Tensor, log_total: int) -> torch.Tensor:
    """(L, I) bool: window rows whose global slot index is a real log slot.

    ``base`` is the per-instance count of compacted (decided) slots; row
    ``l`` of instance ``i`` holds global slot ``base[i] + l``, which exists
    only while it is ``< log_total``."""
    sl = torch.arange(chosen_shape[0], dtype=torch.int32, device=base.device)[:, None]
    return (base[None, :] + sl) < log_total


def _fraction(count: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """float32 ``count / max(den, 1)``, as the reference's float32 sums."""
    return count.to(torch.float32) / torch.clamp(den, min=1).to(torch.float32)


def _decided_count(learner, k, valid=None) -> tuple:
    """(count, denominator), int64: the (valid) instances chosen at tick <=
    ``k``, and the (valid) instances."""
    ok = learner.chosen & (learner.chosen_tick <= k)
    if valid is None:
        return ok.sum(dtype=torch.int64), torch.tensor(ok.numel(), device=ok.device)
    return (ok & valid).sum(dtype=torch.int64), valid.sum(dtype=torch.int64)


def decided_by(learner, k, valid=None) -> torch.Tensor:
    """Fraction of (valid) instances chosen at tick <= ``k`` (float32
    scalar)."""
    return _fraction(*_decided_count(learner, k, valid))


def chosen_tick_histogram(learner, n_bins: int, bin_width, valid=None) -> torch.Tensor:
    """(n_bins,) int64 histogram of decision ticks, the undecided in the
    last bin; with ``valid``, never-decidable rows belong to no bin."""
    t = torch.where(learner.chosen, learner.chosen_tick, torch.iinfo(torch.int32).max)
    binned = torch.clamp(torch.div(t, bin_width, rounding_mode="floor"), 0, n_bins - 1)
    w = torch.ones_like(binned, dtype=torch.int64) if valid is None else valid.to(torch.int64)
    hist = torch.zeros((n_bins,), dtype=torch.int64, device=t.device)
    return hist.index_add_(0, binned.flatten().to(torch.int64), w.flatten())


def stuck_mask(learner, budget_ticks, now, valid=None) -> torch.Tensor:
    """bool mask: still undecided although ``budget_ticks`` have elapsed."""
    stuck = ~learner.chosen & (torch.as_tensor(now) >= budget_ticks)
    return stuck if valid is None else stuck & valid


def curve_ticks(now, n_points: int = N_POINTS, n_bins: int = N_BINS) -> tuple:
    """(ticks, bin_width) of a report at tick ``now`` (a tensor): the
    curve's ``n_points`` tick points evenly spaced to ``now``, and the bin
    width that puts every decided tick (<= now - 1) in bins 0 to n_bins - 2,
    so the last bin holds only the undecided."""
    now = torch.clamp(torch.as_tensor(now, dtype=torch.int32), min=1)
    idx = torch.arange(1, n_points + 1, dtype=torch.int32, device=now.device)
    ticks = torch.clamp(torch.div(now * idx, n_points, rounding_mode="floor"), min=1)
    bin_width = torch.clamp(-torch.div(-now, n_bins - 1, rounding_mode="floor"), min=1)
    return ticks, bin_width


def liveness_device(
    learner, now, n_points: int = N_POINTS, n_bins: int = N_BINS, base=None, log_total: int = 0,
) -> torch.Tensor:
    """Device half of :func:`liveness_report`: one int64 vector, no host
    transfer: the ``n_points`` decided counts, their denominator, the
    ``n_bins`` histogram counts, the stuck count, and the compacted slots
    (``base``'s sum; 0 unless the log is long).  ``now`` may be a device
    scalar (``state.tick``): the tick points and bin width are computed on
    the device (:func:`curve_ticks`), and again by :func:`liveness_host`
    from the tick the report carries.  Read it with
    :func:`liveness_host`."""
    ticks, bin_width = curve_ticks(now, n_points, n_bins)
    valid = None
    if log_total > 0 and base is not None:
        valid = window_valid_mask(learner.chosen.shape, base, log_total)
    decided = [_decided_count(learner, ticks[k], valid) for k in range(n_points)]
    compacted = base.sum(dtype=torch.int64) if valid is not None else torch.zeros_like(decided[0][0])
    return torch.cat([
        torch.stack([count for count, _ in decided] + [decided[0][1]]),
        chosen_tick_histogram(learner, n_bins, bin_width, valid),
        torch.stack([stuck_mask(learner, now, now, valid).sum(dtype=torch.int64), compacted]),
    ])


def liveness_host(host, now: int, window_relative: bool = False, n_points: int = N_POINTS,
                  n_bins: int = N_BINS) -> dict:
    """The report block of a fetched :func:`liveness_device` vector (a
    list of ints) at tick ``now``: ``decided_by_curve``, ``n_points``
    (tick, fraction) pairs, the fraction rounded to 6 places;
    ``chosen_tick_hist`` and ``hist_bin_width``; ``stuck_lanes``; and,
    ``window_relative`` (a long log), ``liveness_window_relative`` and
    ``slots_compacted``."""
    host = [int(v) for v in host]
    ticks, bin_width = curve_ticks(torch.tensor(now, dtype=torch.int32), n_points, n_bins)
    counts, den = host[:n_points], host[n_points]
    hist = host[n_points + 1 : n_points + 1 + n_bins]
    stuck, compacted = host[n_points + 1 + n_bins :]
    curve = _fraction(torch.tensor(counts), torch.tensor(den)).tolist()
    out = {
        "decided_by_curve": [(int(k), round(float(f), 6)) for k, f in zip(ticks.tolist(), curve)],
        "chosen_tick_hist": hist,
        "hist_bin_width": int(bin_width),
        "stuck_lanes": stuck,
    }
    if window_relative:
        out["liveness_window_relative"] = True
        out["slots_compacted"] = compacted
    return out


def liveness_report(
    learner, now, n_points: int = N_POINTS, n_bins: int = N_BINS, base=None, log_total: int = 0,
) -> dict:
    """The liveness block of a run report, host-side plain values (see
    :func:`liveness_host`).  A livelock regression shows as a flattening
    curve and growing ``stuck_lanes``.  A long log (``log_total > 0`` with
    per-instance ``base``) makes every statistic window-relative: compacted
    slots are reported as ``slots_compacted``, and rows past the end of the
    log are masked out rather than counted as stuck."""
    dev = liveness_device(learner, now, n_points, n_bins, base, log_total)
    return liveness_host(
        dev.cpu().tolist(), int(now), log_total > 0 and base is not None, n_points, n_bins
    )
