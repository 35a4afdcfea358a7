"""SLO reductions of the client workload (counterpart of
``paxos_tpu/obs/slo.py``): :func:`slo_device` reduces the queue counters
per class on the device, :func:`slo_host` turns the per-class log2
histograms into client-latency percentiles (the bucket's inclusive upper
edge, in ticks) and goodput ratios."""

from __future__ import annotations

import torch

from paxos_tpu_torch.workload.generator import CLASSES, WloadState

PERCENTILES = (50, 95, 99)


def slo_device(wl: WloadState) -> dict:
    """Device half of the report: per-class offered, served and shed
    totals, lanes, the summed histogram, the live queue depth and its peak."""
    n_classes = len(CLASSES)
    rows = torch.arange(n_classes, dtype=torch.int32, device=wl.mode.device)[:, None, None]
    cls = rows == wl.mode[None]  # (C, P, I)

    def per_class(x):
        return torch.where(cls, x[None], 0).sum(dim=(1, 2), dtype=torch.int64)

    return {
        "offered": per_class(wl.offered),
        "done": per_class(wl.done),
        "shed": per_class(wl.shed),
        "lanes": cls.sum(dim=(1, 2), dtype=torch.int64),
        "hist": wl.hist.sum(dim=-1, dtype=torch.int64),
        "queue_depth": wl.depth.sum(dtype=torch.int64),
        "depth_peak": wl.depth_peak.max(),
    }


def _bucket_edge(b: int) -> int:
    """Inclusive upper edge (ticks) of log2 bucket ``b``: [2^b, 2^(b+1))."""
    return (1 << (b + 1)) - 1


def _percentile_ticks(hist, q: int) -> int:
    """The q-th percentile latency of a log2 histogram, as its bucket's
    upper edge; -1 when the class served nothing."""
    total = int(sum(hist))
    if total == 0:
        return -1
    need = (total * q + 99) // 100
    cum = 0
    for b, n in enumerate(hist):
        cum += int(n)
        if cum >= need:
            return _bucket_edge(b)
    return _bucket_edge(len(hist) - 1)


def slo_host(host: dict) -> dict:
    """Format the fetched :func:`slo_device` dict."""
    flat = [int(v) for v in host["hist"]]
    bins = len(flat) // len(CLASSES)
    classes = {}
    for c, name in enumerate(CLASSES):
        hist = flat[c * bins:(c + 1) * bins]
        offered, done = int(host["offered"][c]), int(host["done"][c])
        row = {
            "lanes": int(host["lanes"][c]),
            "offered": offered,
            "done": done,
            "shed": int(host["shed"][c]),
            "goodput": (done / offered) if offered else 0.0,
            "hist": hist,
        }
        for q in PERCENTILES:
            row[f"p{q}_ticks"] = _percentile_ticks(hist, q)
        classes[name] = row
    offered = sum(r["offered"] for r in classes.values())
    done = sum(r["done"] for r in classes.values())
    return {
        "classes": classes,
        "offered": offered,
        "done": done,
        "shed": sum(r["shed"] for r in classes.values()),
        "goodput": (done / offered) if offered else 0.0,
        "queue_depth": int(host["queue_depth"]),
        "depth_peak": int(host["depth_peak"]),
        "p99_ticks": max(
            (r["p99_ticks"] for r in classes.values() if r["done"] > 0), default=-1
        ),
    }
