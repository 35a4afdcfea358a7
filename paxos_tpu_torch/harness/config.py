"""Typed run configs (counterpart of ``paxos_tpu/harness/config.py``).

:class:`SimConfig` mirrors the reference's fields, the observer planes'
configs included (telemetry, coverage, exposure, margin, workload; each
off by default).  The planes are ported on Paxos;
:func:`paxos_tpu_torch.harness.run.run` rejects a plane on another
protocol.  :meth:`SimConfig.fingerprint` equals the reference's: a plane
that is off drops out of it, as there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from paxos_tpu_torch.core.telemetry import TelemetryConfig
from paxos_tpu_torch.faults.injector import FaultConfig
from paxos_tpu_torch.obs.coverage import CoverageConfig
from paxos_tpu_torch.obs.exposure import ExposureConfig
from paxos_tpu_torch.obs.margin import MarginConfig
from paxos_tpu_torch.workload.generator import WorkloadConfig

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
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)
    coverage: CoverageConfig = dataclasses.field(default_factory=CoverageConfig)
    exposure: ExposureConfig = dataclasses.field(default_factory=ExposureConfig)
    margin: MarginConfig = dataclasses.field(default_factory=MarginConfig)
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)

    def planes_on(self) -> tuple:
        """The observer planes the config turns on (``OBSERVER_PLANES``)."""
        return tuple(p for p in OBSERVER_PLANES if getattr(self, p).enabled())

    def fingerprint(self) -> str:
        d = dataclasses.asdict(self)
        for plane in OBSERVER_PLANES:
            if d[plane] == dataclasses.asdict(type(getattr(self, plane))()):
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


def config_partition(n_inst: int = 65_536, seed: int = 0) -> SimConfig:
    """Network partitions: per-instance bipartition windows, drop and duels.
    Messages crossing the cut stall until the partition heals
    (``FaultPlan.link_ok``)."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        fault=FaultConfig(
            p_drop=0.05,
            p_idle=0.1,
            p_hold=0.1,
            p_part=0.8,
            part_max_start=40,
            part_max_len=30,
        ),
    )


def config_gray_chaos(n_inst: int = 65_536, seed: int = 0) -> SimConfig:
    """Gray-failure chaos: one-way cuts (``p_asym``), per-link loss and
    duplication rates (``p_flaky``, ``flaky_drop``, ``flaky_dup``) and
    per-proposer timeout and backoff skew, all at once.  Chaos, not a bug:
    safety must hold at any length, and lanes decide once the cuts heal."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        fault=FaultConfig(
            p_idle=0.1,
            p_hold=0.1,
            p_dup=0.05,
            p_part=0.5,
            part_max_start=40,
            part_max_len=30,
            p_asym=0.7,
            p_flaky=0.4,
            flaky_drop=0.4,
            flaky_dup=0.2,
            timeout_skew=6,
            backoff_skew=3,
        ),
    )


def config_corrupt(n_inst: int = 4096, seed: int = 0) -> SimConfig:
    """Bug injection: in-flight payload corruption (``p_corrupt``).  An
    ACCEPT's value flips a bit and a PREPARE's ballot moves up one between
    send and process, so acceptors vote for values nobody proposed, which
    the agreement checker must flag."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        fault=FaultConfig(p_drop=0.1, p_idle=0.2, p_hold=0.2, p_corrupt=0.2, timeout=6),
    )


def config_stale(n_inst: int = 4096, seed: int = 0) -> SimConfig:
    """Bug injection: stale-snapshot recovery (amnesia generalized).  A
    crashed acceptor recovers to its image as of the last multiple of
    ``stale_k`` ticks, losing up to ``stale_k`` ticks of promises and
    accepts; the checker must flag the consequences."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        fault=FaultConfig(
            p_drop=0.1,
            p_idle=0.1,
            p_hold=0.1,
            timeout=6,
            stale_k=8,
            p_crash=0.4,
            crash_max_start=60,
            crash_max_len=20,
        ),
    )


def apply_fault_overrides(cfg: SimConfig, overrides) -> SimConfig:
    """Apply generic ``key=value`` fault-knob overrides to a config.

    The CLI's ``--fault`` escape hatch: any :class:`FaultConfig` field by
    name, value coerced to the field's current type (bool fields accept
    true/false/1/0).  Unknown keys raise ``ValueError`` listing the valid
    knobs, so a typo'd knob fails loudly instead of silently fuzzing the
    wrong space.
    """
    if not overrides:
        return cfg
    valid = {f.name for f in dataclasses.fields(FaultConfig)}
    patch = {}
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"fault override must be key=value, got {item!r}")
        if key not in valid:
            raise ValueError(
                f"unknown fault knob {key!r}; valid: {', '.join(sorted(valid))}"
            )
        cur = getattr(cfg.fault, key)
        if isinstance(cur, bool):
            if raw.lower() not in {"true", "false", "1", "0"}:
                raise ValueError(f"{key} is a flag; use {key}=true/false")
            val: object = raw.lower() in {"true", "1"}
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        else:
            val = raw
        patch[key] = val
    return dataclasses.replace(
        cfg, fault=dataclasses.replace(cfg.fault, **patch)
    )


def config_flex(q1: int, q2: int, n_inst: int = 16_384, seed: int = 0) -> SimConfig:
    """Flexible Paxos: explicit phase-1 / phase-2 quorums over 5 acceptors.
    Safe iff ``q1 + q2 > 5``; an unsafe pair is a bug-injection mode the
    checker must catch."""
    return SimConfig(
        n_inst=n_inst,
        n_prop=2,
        n_acc=5,
        seed=seed,
        fault=FaultConfig(p_idle=0.2, p_hold=0.2, q1=q1, q2=q2),
    )
