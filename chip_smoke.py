#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure, so any failed phase exits non-zero):

1. build: the four kernels of ``paxos_tpu_torch/kernels/csrc`` and the
   fused kernels' draw-counting builds, one nvcc each, all started
   together; each kernel's ``ptxas -v`` registers and spills;
2. ceiling: the int32 probe (K6) against its plain version byte for byte,
   then the card's int32 operation rate from two iteration counts, printed
   beside the published peak that the bounds divide by;
3. golden: config2, Fast Paxos and Raft-core (config5) at 256 lanes, seed
   7, 32 ticks through their kernels must give the recorded state digests;
4. kernel vs plain: every kernel instantiation against the plain PyTorch
   version on the card, byte for byte, including a per-tick ballot clamp
   with a block offset, and at full width (1<<20 lanes x 64 ticks), timed,
   with the counter-PRNG draws of the timed ticks counted by each kernel's
   measuring build for its operation bound;
5. main paths: the flagship campaign (config2) and the config5 sweep's
   Fast Paxos and Raft-core campaigns (1<<20 lanes, 4096 ticks, chunk 64,
   pipeline depth 16) through ``run``, each with every launch count set to
   0 before and read after; reports deterministic over 3 repeats, no
   violations; the two lowest-numbered stream blocks that evicted must
   equal, digest for digest, what the JAX package computes for them
   (``EVICTION_PINS``, checked by tests/test_torch_evictions.py); then
   once more under torch.profiler for the device's busy and idle time;
6. checker: config4's equivocation, an unsafe Fast Flexible Paxos quorum
   triple, and Raft-core equivocation must each report violations.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and last the ``{"ok": true, "device": ...}`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Recorded state digests: 256 lanes, seed 7, 32 ticks (the JAX package's
# tests/test_gray.py _GOLDEN_CTR).
GOLDENS = {
    "paxos": "db6db6f40f16eb7b",
    "fastpaxos": "72beea3ccdacab94",
    "raftcore": "eb285905571b709f",
}
FULL_LANES = 1 << 20
MAIN_PATH_REPEATS = 3
MAIN_TICKS, MAIN_CHUNK, MAIN_DEPTH = 4096, 64, 16
# The flagship campaign (seed 0) fills one lane's 8-slot learner table:
# lane 838 of stream block 963.
MAIN_EVICTION_LANES = [986950]
# Per main path: its total evictions, and for the two lowest-numbered
# stream blocks that evicted, the evicting lanes inside the block and the
# block's state digest after the campaign, as the JAX package computes
# them (tests/test_torch_evictions.py holds the same numbers and checks
# them against the JAX package).
EVICTION_PINS = {
    "paxos": (1, {963: ([838], "8c8a818261f3d84c")}),
    "fastpaxos": (138, {5: ([862], "659e8267fff0c143"), 17: ([213], "0727753391be6bf5")}),
    "raftcore": (0, {}),
}
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and
# int32 ALU throughput: 132 SMs x 64 INT32 lanes x 1.98 GHz x 2 (an IMAD,
# IADD3 or LOP3 instruction does two of the counted operations, so this
# is an upper bound on the rate).  The bounds divide by these; the rate
# K6 measures is printed beside them.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9 * 2
# The int32 operation census of each tick (scripts/roofline.py tick_census,
# in ROOFLINE.json), per protocol.
CENSUS_CASES = {
    "paxos": "config2-paxos",
    "fastpaxos": "config5-fastpaxos",
    "raftcore": "config5-raftcore",
}
# The census's share of counter_masks, which draws every mask element of
# every tick, per protocol: (operations, mask elements) per lane-tick, as
# scripts/roofline.py's census_jaxpr counts them (tests/test_torch_census.py
# computes them with the JAX package).  The kernels draw lazily, so the
# bound counts the draws a run makes at this cost per element instead.
MASK_CENSUS = {
    "paxos": (1228.064453125, 87.0),
    "fastpaxos": (1228.064453125, 87.0),
    "raftcore": (1228.064453125, 87.0),
}
KERNEL_SOURCE = "paxos_tpu_torch/kernels/csrc/{}.cu"
# pl.pallas_call of the JAX package's fused engine (fused_chunk), which
# each protocol binds through fused_fns; and the int32 probe.
FUSED_PALLAS_CALL = "paxos_tpu/kernels/fused_tick.py:345"
REPLACES = {
    "paxos": FUSED_PALLAS_CALL + " (_kernel :201, packed_fns('paxos'))",
    "fastpaxos": FUSED_PALLAS_CALL + " (_kernel :201, fused_fns('fastpaxos') :655)",
    "raftcore": FUSED_PALLAS_CALL + " (_kernel :201, fused_fns('raftcore') :660)",
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def digest(leaves) -> str:
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(leaf.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def block_leaves(state, blk: int, block: int = 1024) -> list:
    """The leaves of stream block ``blk`` of ``state`` (tick included)."""
    lo = blk * block
    return [x[..., lo:lo + block].contiguous() if x.dim() else x for x in state.leaves()]


def max_abs_err(a: list, b: list) -> int:
    """Largest |difference| over two lists of leaves (0 = byte-identical)."""
    err = 0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"leaf mismatch {x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def timed(fn, reps: int = 1) -> tuple:
    """(result, ms per call) with CUDA events around ``reps`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = None
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def tick_ops_per_lane(protocol: str, draws_per_lane_tick: "float | None" = None) -> float:
    """int32 operations per lane-tick of the unpacked tick: the ALU +
    reduction census of scripts/roofline.py (recorded in ROOFLINE.json),
    without its packed-codec share, which the unpacked port does not
    execute.  The census draws every mask element of every tick; given the
    draws a kernel made per lane-tick, its mask share is counted for
    those draws only, at the census's cost per element."""
    cases = json.loads(Path("ROOFLINE.json").read_text())["cases"]
    c = next(c for c in cases if c["case"] == CENSUS_CASES[protocol])
    ops = c["alu_per_lane_tick"] + c["reduce_per_lane_tick"] - c["codec_alu_per_lane_tick"]
    if draws_per_lane_tick is None:
        return ops
    mask_ops, mask_elems = MASK_CENSUS[protocol]
    return ops - mask_ops + draws_per_lane_tick * mask_ops / mask_elems


def main_config(protocol: str, n_inst: int = FULL_LANES, seed: int = 0):
    from paxos_tpu_torch.harness import config as C

    if protocol == "paxos":
        return C.config2_dueling_drop(n_inst, seed)
    return C.config5_sweep(n_inst, seed)[("paxos", "fastpaxos", "raftcore").index(protocol)]


def reset_launches() -> None:
    from paxos_tpu_torch.kernels.fused_tick import FUSED_WRAPPERS
    from paxos_tpu_torch.kernels.int32_ceiling import int32_ceiling

    for wrapper in FUSED_WRAPPERS.values():
        wrapper.launches = 0
    int32_ceiling.launches = 0


def read_launches() -> dict:
    from paxos_tpu_torch.kernels.fused_tick import FUSED_WRAPPERS
    from paxos_tpu_torch.kernels.int32_ceiling import int32_ceiling

    out = {p: w.launches for p, w in FUSED_WRAPPERS.items()}
    out["int32_ceiling"] = int32_ceiling.launches
    return out


def phase_build() -> dict:
    """Build every kernel, one nvcc each, all started together."""
    from paxos_tpu_torch.kernels import build
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS, COUNT_DRAWS

    names = [b.kernel for b in BINDINGS.values()] + ["int32_ceiling"]
    builds = [(name, ()) for name in names] + [(b.kernel, COUNT_DRAWS) for b in BINDINGS.values()]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda nd: build.build(*nd), builds))
    secs = time.perf_counter() - t0
    log(f"build: {len(names)} kernels and {len(BINDINGS)} draw-counting builds in {secs:.1f} s "
        "(nvcc, sm_90a, in parallel)")
    keys = ("entry function", "registers", "spill")
    ptxas = {}
    for name in names:
        report = build.ptxas_report(name)
        ptxas[name] = [ln.strip() for ln in report.splitlines() if any(k in ln for k in keys)]
        for ln in ptxas[name]:
            log(f"ptxas {name}: {ln}")
    return {"build_s": secs, "ptxas": ptxas}


def phase_ceiling() -> dict:
    """K6 against its plain version at full size, then the int32 rate."""
    from paxos_tpu_torch.kernels.int32_ceiling import (
        ITERS,
        OPS_PER_ITER,
        SHAPE,
        ceiling_reference,
        int32_ceiling,
        int32_ops_per_s,
    )

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, SHAPE, dtype=np.int64).astype(np.int32)).cuda()
    iters = ITERS[0]
    plain, plain_ms = timed(lambda: ceiling_reference(x, iters))
    int32_ceiling(x, iters)  # warm
    kern, kern_ms = timed(lambda: int32_ceiling(x, iters), reps=5)
    err = max_abs_err([kern], [plain])
    log(f"ceiling: kernel vs plain {SHAPE} x {iters} iterations, max_abs_err {err}")
    if err != 0:
        raise AssertionError("int32_ceiling disagrees with its plain version")
    rate = int32_ops_per_s()
    n_ops = x.numel() * iters * OPS_PER_ITER
    bytes_ms = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    log(
        f"ceiling: measured {rate:.4g} int32 op/s ({rate / INT32_OPS_PER_S:.3f} of the "
        f"published-peak {INT32_OPS_PER_S:.4g}); kernel {kern_ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {max(bytes_ms, ops_ms):.3f} ms at the published peak"
    )
    return {
        "ops_per_s": rate, "max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "shape": f"int32 {SHAPE} x {iters} iterations; rate from {ITERS[0]} and {ITERS[1]}",
    }


def phase_golden() -> None:
    from paxos_tpu_torch.harness.run import init_plan, init_state
    from paxos_tpu_torch.kernels.fused_tick import FUSED_WRAPPERS

    for protocol, want in GOLDENS.items():
        cfg = main_config(protocol, 256, 7)
        state = init_state(cfg, "cuda")
        state = FUSED_WRAPPERS[protocol](
            state, cfg.seed, init_plan(cfg, "cuda"), cfg.fault, 32, block=256
        )
        got = digest(state.leaves())
        log(f"golden: {protocol} 256 lanes seed 7 32 ticks digest {got} (want {want})")
        if got != want:
            raise AssertionError(f"{protocol} golden digest {got} != {want}")


def fault_plan(n_inst: int, n_acc: int, n_prop: int, p_equiv: float, seed: int, p_crash: float = 0.0):
    """A plan from a fixed numpy seed: equivocators with probability
    ``p_equiv`` and, with probability ``p_crash``, a crash window in the
    first 48 ticks."""
    from paxos_tpu_torch.faults.injector import NEVER, FaultPlan

    plan = FaultPlan.none(n_inst, n_acc, n_prop, device="cuda")
    rng = np.random.default_rng(seed)
    plan.equivocate = torch.from_numpy(rng.random((n_acc, n_inst)) < p_equiv).cuda()
    crash = rng.random((n_acc, n_inst)) < p_crash
    start = rng.integers(0, 32, (n_acc, n_inst))
    end = start + rng.integers(1, 17, (n_acc, n_inst))
    plan.crash_start = torch.from_numpy(np.where(crash, start, NEVER).astype(np.int32)).cuda()
    plan.crash_end = torch.from_numpy(np.where(crash, end, NEVER).astype(np.int32)).cuda()
    return plan


def near_limit_state(cfg, rnd: int):
    """``cfg``'s initial state with every proposer in phase 1 at ballot
    round ``rnd`` and its PREPARE (REQVOTE) broadcast in flight."""
    from paxos_tpu_torch.harness.run import init_state

    st = init_state(cfg, "cuda")
    pid = torch.arange(cfg.n_prop, dtype=torch.int32, device="cuda")[:, None]
    st.proposer.bal.copy_((rnd * 8 + pid + 1).expand_as(st.proposer.bal))
    st.proposer.phase.zero_()
    st.requests.bal[0] = st.proposer.bal[:, None, :]
    st.requests.present[0] = True
    return st


def compare(name, cfg, plan, n_ticks, block=1024, reps=0, init=None, ceiling=None, **kw) -> dict:
    """Kernel vs plain on the card from the same initial state; ``kw`` are
    the wrapper's ``blk0`` and ``clamp_per_tick``.  With ``reps``, also
    the kernel's steady-state time over ``reps`` further chunks and their
    bound: the bytes, and the operations of the census with the draws
    those chunks make, over the published peak (and over the measured
    ``ceiling`` beside it)."""
    from paxos_tpu_torch.core.state import state_bytes_per_lane
    from paxos_tpu_torch.harness.run import init_state
    from paxos_tpu_torch.kernels.fused_tick import (
        BINDINGS,
        FUSED_WRAPPERS,
        draw_census,
        reference_chunk,
    )

    wrapper = FUSED_WRAPPERS[cfg.protocol]
    init = init_state(cfg, "cuda") if init is None else init
    plain, plain_ms = timed(
        lambda: reference_chunk(
            init, cfg.seed, plan, cfg.fault, n_ticks, blk_id=kw.get("blk0", 0),
            block=block, clamp_per_tick=kw.get("clamp_per_tick", False),
            apply_fn=BINDINGS[cfg.protocol].apply_fn,
        )
    )
    st = init.clone()
    torch.cuda.synchronize()
    kern, kern_ms = timed(lambda: wrapper(st, cfg.seed, plan, cfg.fault, n_ticks, block=block, **kw))
    err = max_abs_err(kern.leaves(), plain.leaves())
    log(f"{name}: {cfg.n_inst} lanes x {n_ticks} ticks, kernel vs plain max_abs_err {err}")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    out = {"max_abs_err": err, "plain_ms": plain_ms, "first_ms": kern_ms}
    if reps:
        # The draws of the timed chunks: the measuring build over the same
        # ticks from a copy of the compared state, which must end where
        # the timed chunks end.
        counted = kern.clone()
        draws = draw_census(cfg.protocol, counted, cfg.seed, plan, cfg.fault, reps * n_ticks, block=block)
        # Steady state: further chunks continuing from the compared state.
        _, out["ms"] = timed(
            lambda: wrapper(kern, cfg.seed, plan, cfg.fault, n_ticks, block=block), reps
        )
        if max_abs_err(counted.leaves(), kern.leaves()) != 0:
            raise AssertionError(f"{name}: the draw-counting build took another path")
        plan_bytes = sum(l.element_size() * l.numel() for l in (plan.crash_start, plan.crash_end, plan.equivocate))
        n_bytes = 2 * state_bytes_per_lane(init) * cfg.n_inst + plan_bytes
        draws_per_lane_tick = draws / (cfg.n_inst * reps * n_ticks)
        ops_per_lane_tick = tick_ops_per_lane(cfg.protocol, draws_per_lane_tick)
        n_ops = ops_per_lane_tick * cfg.n_inst * n_ticks
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / INT32_OPS_PER_S * 1e3
        measured_ops_ms = n_ops / ceiling * 1e3
        out.update(
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            bound_ms_measured_rate=max(bytes_ms, measured_ops_ms),
            bytes_ms=bytes_ms, ops_ms=ops_ms, ops_per_lane_tick=ops_per_lane_tick,
            ops_per_lane_tick_all_masks=tick_ops_per_lane(cfg.protocol),
            draws_per_lane_tick=draws_per_lane_tick,
            state_bytes_per_lane=state_bytes_per_lane(init),
        )
        log(
            f"{name}: kernel {out['ms']:.3f} ms/chunk (first {kern_ms:.3f}), plain "
            f"{plain_ms:.1f} ms, bound {out['bound_ms']:.3f} ms ({out['bound_by']}; bytes "
            f"{bytes_ms:.3f} ms, int32 ops {ops_ms:.3f} ms at the published peak, "
            f"{measured_ops_ms:.3f} ms at the measured rate); {draws_per_lane_tick:.3f} draws "
            f"per lane-tick of {MASK_CENSUS[cfg.protocol][1]:g} mask elements, "
            f"{ops_per_lane_tick:.1f} ops per lane-tick ({out['ops_per_lane_tick_all_masks']:.1f} "
            "with every mask drawn)"
        )
    return out


def phase_compare(ceiling: float) -> dict:
    """Every instantiation against the plain version; the full-width
    comparison of each fused kernel, timed, is returned per protocol."""
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import init_plan

    cfg1 = C.config1_no_faults(4096, 3)
    compare("paxos config1 (1,3,8)", cfg1, init_plan(cfg1, "cuda"), 64)
    cfg4 = C.config4_byzantine(4096, 5)
    compare("paxos config4 (2,5,8)", cfg4, fault_plan(4096, 5, 2, 0.25, 4), 300)
    for protocol in ("fastpaxos", "raftcore"):
        small = dataclasses.replace(main_config(protocol, 4096, 11), n_acc=3)
        compare(
            f"{protocol} (2,3,8) with crashes and equivocators", small,
            fault_plan(4096, 3, 2, 0.25, 5, p_crash=0.3), 128,
        )
    # The per-tick ballot clamp (chunks over 6144 ticks) and a nonzero block
    # offset, which the main paths do not take, from near-limit ballots.
    for protocol in ("paxos", "fastpaxos", "raftcore"):
        cfgc = main_config(protocol, 4096, 13)
        compare(
            f"{protocol} per-tick clamp, blk0=5", cfgc, init_plan(cfgc, "cuda"), 96,
            init=near_limit_state(cfgc, 4094), blk0=5, clamp_per_tick=True,
        )
    full = {}
    for protocol in ("paxos", "fastpaxos", "raftcore"):
        cfg = main_config(protocol, FULL_LANES, 7)
        full[protocol] = compare(
            f"{protocol} full width", cfg, init_plan(cfg, "cuda"), 64, reps=5, ceiling=ceiling
        )
    return full


def check_evictions(protocol: str, report: dict, state) -> dict:
    """The main path's evictions against the pins: total, the two
    lowest-numbered evicting stream blocks, their lanes and digests."""
    total, pinned = EVICTION_PINS[protocol]
    lanes = torch.nonzero(state.learner.evictions).flatten().tolist()
    blocks = sorted({lane // 1024 for lane in lanes})[:2]
    found = {
        blk: ([lane - blk * 1024 for lane in lanes if lane // 1024 == blk], digest(block_leaves(state, blk)))
        for blk in blocks
    }
    log(
        f"{protocol} main path: evictions {report['evictions']} on {len(lanes)} lanes in "
        f"{len({lane // 1024 for lane in lanes})} stream blocks; lowest blocks {found}"
    )
    if report["evictions"] != total or found != pinned:
        raise AssertionError(
            f"{protocol} evictions {report['evictions']} {found}, pinned {total} {pinned}"
        )
    if protocol == "paxos" and lanes != MAIN_EVICTION_LANES:
        raise AssertionError(f"evictions on lanes {lanes}, recorded {MAIN_EVICTION_LANES}")
    return {str(blk): d for blk, (_, d) in found.items()}


def phase_main_path(protocol: str) -> dict:
    from paxos_tpu_torch.harness.run import run

    cfg = main_config(protocol)
    walls, launches, report, state = [], {}, None, None
    for _ in range(MAIN_PATH_REPEATS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rep_report, state = run(
            cfg, engine="fused", total_ticks=MAIN_TICKS, chunk=MAIN_CHUNK,
            pipeline_depth=MAIN_DEPTH, return_state=True,
        )
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_launches()
        if report is not None and rep_report != report:
            raise AssertionError(f"{protocol} main path not deterministic: {rep_report} != {report}")
        report = rep_report
    wall = sorted(walls)[len(walls) // 2]
    log(f"{protocol} main path report: {json.dumps(report)}")
    rate = cfg.n_inst * MAIN_TICKS / wall
    log(
        f"{protocol} main path: median {wall:.4f} s wall of {[round(w, 4) for w in walls]}, "
        f"{rate:.4g} quorum-rounds/s, launches {launches}"
    )
    if report["ticks"] != MAIN_TICKS or not 0.0 <= report["chosen_frac"] <= 1.0:
        raise AssertionError(f"malformed report {report}")
    if report["violations"] != 0:
        raise AssertionError(f"{protocol} main path must be safe: {report}")
    if launches[protocol] == 0:
        raise AssertionError(f"the {protocol} main path never launched its fused kernel")
    if sum(launches.values()) != launches[protocol]:
        raise AssertionError(f"the {protocol} main path launched other kernels: {launches}")
    digests = check_evictions(protocol, report, state)
    return {"launches": launches[protocol], "all_launches": launches, "wall_s": wall,
            "walls_s": walls, "rounds_per_s": rate, "report": report,
            "eviction_block_digests": digests}


def phase_main_path_profile(protocol: str) -> dict:
    """The main path once more under torch.profiler: the fused kernel's
    share of device time and the device's idle share of the wall time
    (the profiler's own host cost inflates the wall a little)."""
    from torch.profiler import ProfilerActivity, profile

    from paxos_tpu_torch.harness.run import run

    cfg = main_config(protocol)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(cfg, total_ticks=MAIN_TICKS, chunk=MAIN_CHUNK, pipeline_depth=MAIN_DEPTH)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    kernel_name = f"fused_{protocol}_kernel"
    kernel_us = sum(e.self_device_time_total for e in events if kernel_name in e.key)
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6, "kernel_s": kernel_us / 1e6}
    if busy_us == 0:
        log(f"{protocol} profile: the profiler recorded no device time (not measured)")
        return out
    out["idle_share"] = 1.0 - busy_us / wall_us
    log(
        f"{protocol} profile: wall {out['wall_s']:.3f} s, device busy {out['device_busy_s']:.3f} s "
        f"(fused kernel {out['kernel_s']:.3f} s), device idle share {out['idle_share']:.4f}"
    )
    return out


def phase_checker() -> dict:
    """Bug-injection configs must light up the safety checker."""
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import run

    out = {}
    cfg = C.config4_byzantine(4096)
    plan = fault_plan(cfg.n_inst, cfg.n_acc, cfg.n_prop, cfg.fault.p_equiv, 0)
    out["config4"] = run(cfg, total_ticks=300, plan=plan)["violations"]
    # q1 + 2 * q_fast = 9 <= 2n: two values can be choosable in recovery.
    out["fastpaxos config_ffp(3,3,3)"] = run(C.config_ffp(3, 3, 3, 8192, 1), total_ticks=256)["violations"]
    cfg = main_config("raftcore", 4096, 0)
    cfg = dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, p_equiv=0.5))
    plan = fault_plan(cfg.n_inst, cfg.n_acc, cfg.n_prop, 0.5, 1)
    out["raftcore p_equiv=0.5"] = run(cfg, total_ticks=300, plan=plan)["violations"]
    for name, violations in out.items():
        log(f"checker: {name} violations {violations}")
        if violations <= 0:
            raise AssertionError(f"{name} must light up the safety checker")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 1
    if not Path("paxos_tpu_torch").is_dir():
        log("run from the repository root: paxos_tpu_torch/ not found")
        return 1
    t0 = time.perf_counter()
    built = phase_build()
    ceiling = phase_ceiling()
    phase_golden()
    full = phase_compare(ceiling["ops_per_s"])
    main_paths = {p: phase_main_path(p) for p in ("paxos", "fastpaxos", "raftcore")}
    profiles = {p: phase_main_path_profile(p) for p in main_paths}
    checker = phase_checker()
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS

    kernels = []
    for protocol, mp in main_paths.items():
        kernel, f = BINDINGS[protocol].kernel, full[protocol]
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": KERNEL_SOURCE.format(kernel),
            "replaces": REPLACES[protocol],
            "launches": mp["launches"],
            "max_abs_err": f["max_abs_err"],
            "tolerance": 0,  # int32/bool state: byte-identical to the plain version
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "bound_ms_measured_rate": f["bound_ms_measured_rate"],
            "library_ms": None,  # no single PyTorch call computes a tick
            "shape": f"{protocol} {FULL_LANES} lanes x 64 ticks, block 1024",
            "ops_per_lane_tick": f["ops_per_lane_tick"],
            "ops_per_lane_tick_all_masks": f["ops_per_lane_tick_all_masks"],
            "draws_per_lane_tick": f["draws_per_lane_tick"],
            "state_bytes_per_lane": f["state_bytes_per_lane"],
            "ptxas": built["ptxas"][kernel],
            "main_path_wall_s": mp["wall_s"],
            "main_path_walls_s": mp["walls_s"],
            "main_path_rounds_per_s": mp["rounds_per_s"],
            "main_path_report": mp["report"],
            "main_path_eviction_block_digests": mp["eviction_block_digests"],
            "main_path_profile": profiles[protocol],
        })
    # K6 measures the card; no main path launches it (each path's check
    # above), so its count is read from the last main path's run.
    k6_launches = main_paths["raftcore"]["all_launches"]["int32_ceiling"]
    kernels.append({
        "name": "int32_ceiling",
        "route": "cuda",
        "source": KERNEL_SOURCE.format("int32_ceiling"),
        "replaces": "scripts/roofline.py:207 (vpu_ceiling :180)",
        "launches": k6_launches,
        "max_abs_err": ceiling["max_abs_err"],
        "tolerance": 0,
        "ms": ceiling["ms"],
        "plain_ms": ceiling["plain_ms"],
        "bound_ms": ceiling["bound_ms"],
        "bound_by": ceiling["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the probe body
        "shape": ceiling["shape"],
        "int32_ops_per_s": ceiling["ops_per_s"],
        "int32_ops_per_s_published_peak": INT32_OPS_PER_S,
        "ptxas": built["ptxas"]["int32_ceiling"],
    })
    log(f"summary: checker {checker}; build {built['build_s']:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated()} B; total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
