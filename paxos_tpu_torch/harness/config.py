"""Typed run configs (counterpart of ``paxos_tpu/harness/config.py``).

:class:`SimConfig` mirrors the reference's fields.  The observer planes
(telemetry, coverage, exposure, margin, workload) are not ported: their
fields exist so a config converts field for field, and default to None
(off); :func:`paxos_tpu_torch.harness.run.run` rejects a config that sets
one.  :meth:`SimConfig.fingerprint` equals the reference's for configs with
every plane off.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

from paxos_tpu_torch.faults.injector import FaultConfig

# The reference's packed layout version per protocol: part of its config
# fingerprint, kept so fingerprints agree across the packages.
LAYOUT_VERSIONS = {
    "paxos": "paxos-packed-v4",
    "fastpaxos": "fastpaxos-packed-v4",
    "raftcore": "raftcore-packed-v4",
    "multipaxos": "multipaxos-packed-v4",
    "synchpaxos": "synchpaxos-packed-v1",
}

OBSERVER_PLANES = ("telemetry", "coverage", "exposure", "margin", "workload")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One fuzzing run: protocol, topology, scale, faults, timing."""

    n_inst: int = 1024
    n_prop: int = 1
    n_acc: int = 3
    k_slots: int = 8
    log_len: int = 8
    seed: int = 0
    protocol: str = "paxos"
    fault: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    telemetry: Optional[dict] = None
    coverage: Optional[dict] = None
    exposure: Optional[dict] = None
    margin: Optional[dict] = None
    workload: Optional[dict] = None

    def fingerprint(self) -> str:
        d = dataclasses.asdict(self)
        for plane in OBSERVER_PLANES:
            if d[plane] is None:
                del d[plane]
        if self.protocol not in LAYOUT_VERSIONS:
            raise NotImplementedError(
                f"protocol {self.protocol!r} is not ported yet (ROADMAP queue "
                "A slice 4)"
            )
        d["layout_version"] = LAYOUT_VERSIONS[self.protocol]
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def validate_pipeline_depth(depth) -> int:
    """A dispatch-pipeline depth is an integer >= 1."""
    if isinstance(depth, bool) or not isinstance(depth, int):
        raise ValueError(f"pipeline depth must be an integer >= 1, got {depth!r}")
    if depth < 1:
        raise ValueError(f"pipeline depth must be >= 1, got {depth}")
    return depth


def config1_no_faults(n_inst: int = 1024, seed: int = 0) -> SimConfig:
    """Config 1: single-decree, 3 acceptors, 1 proposer, no faults."""
    return SimConfig(n_inst=n_inst, n_prop=1, n_acc=3, seed=seed)


def config2_dueling_drop(n_inst: int = 131_072, seed: int = 0) -> SimConfig:
    """Config 2: 5 acceptors, 2 dueling proposers, 10% message drop."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        fault=FaultConfig(p_drop=0.1, p_idle=0.2, p_hold=0.2),
    )


def config3_multipaxos(n_inst: int = 1_048_576, seed: int = 0) -> SimConfig:
    """Config 3: Multi-Paxos log replication, leader lease + leader crash
    (5 acceptors, 2 proposers, an 8-slot log)."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        log_len=8,
        k_slots=4,
        seed=seed,
        protocol="multipaxos",
        fault=FaultConfig(
            p_drop=0.05,
            p_idle=0.1,
            p_hold=0.1,
            p_crash=0.1,
            p_crash_prop=0.4,  # leader crash is the config's point
            crash_max_start=150,
            crash_max_len=40,
            lease_len=24,
        ),
    )


def config3_long(
    n_inst: int = 262_144, seed: int = 0, log_total: int = 256, window: int = 16
) -> SimConfig:
    """Config 3-long: Multi-Paxos over a ``log_total``-slot log through a
    ``window``-slot window; decided prefixes compact out after every chunk
    (``protocols.multipaxos.compact_mp_body``).  Config 3's faults, with
    crash windows spread over the longer run."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        log_len=window,
        k_slots=4,
        seed=seed,
        protocol="multipaxos",
        fault=FaultConfig(
            p_drop=0.05,
            p_idle=0.1,
            p_hold=0.1,
            p_crash=0.1,
            p_crash_prop=0.4,
            crash_max_start=2000,
            crash_max_len=60,
            lease_len=24,
            log_total=log_total,
        ),
    )


def config4_byzantine(n_inst: int = 4096, seed: int = 0) -> SimConfig:
    """Config 4: acceptor equivocation, to validate the checker."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        fault=FaultConfig(p_idle=0.2, p_hold=0.2, p_equiv=0.25),
    )


def config_ffp(
    q1: int, q2: int, q_fast: int, n_inst: int = 16_384, seed: int = 0
) -> SimConfig:
    """Fast Flexible Paxos: explicit classic + fast quorums over 5 acceptors.

    Safe iff ``q1 + q2 > 5`` and ``q1 + 2*q_fast > 10``; an unsafe triple is
    a bug-injection mode that must light up the safety checker.
    """
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        protocol="fastpaxos",
        fault=FaultConfig(
            p_idle=0.2, p_hold=0.2, p_drop=0.1, q1=q1, q2=q2, q_fast=q_fast
        ),
    )


def config5_sweep(n_inst: int = 65_536, seed: int = 0) -> tuple:
    """Config 5: Paxos vs Fast Paxos vs Raft-core under identical fault masks."""
    fault = FaultConfig(p_drop=0.1, p_idle=0.2, p_hold=0.2)
    return tuple(
        SimConfig(n_inst=n_inst, n_prop=2, n_acc=5, seed=seed, protocol=p, fault=fault)
        for p in ("paxos", "fastpaxos", "raftcore")
    )


def config_delay_chaos(
    n_inst: int = 4096, seed: int = 0, violate_delta: bool = False
) -> SimConfig:
    """Bounded-delay chaos for SynchPaxos: per-link latency under loss.

    A send is delayed w.p. ``p_delay`` by 1..``delay_max`` extra ticks,
    capped per link by the plan's ``link_delay``.  The default cell keeps
    latencies inside the synchrony window ``delta``, so the fast path still
    lands; ``violate_delta`` sets the window below the latencies, so the
    honest protocol must fall back safely (and the ``sp_unsafe_fast``
    planted bug becomes catchable)."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        protocol="synchpaxos",
        fault=FaultConfig(
            p_drop=0.1,
            p_idle=0.1,
            p_delay=0.8 if violate_delta else 0.4,
            delay_max=8 if violate_delta else 2,
            delta=4 if violate_delta else 6,
            timeout=8,
        ),
    )
