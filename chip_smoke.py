#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure, so any failed phase exits non-zero):

1. build the fused kernel from ``paxos_tpu_torch/kernels/csrc`` with nvcc;
2. golden: config2 at 256 lanes, seed 7, 32 ticks through the kernel must
   give the recorded state digest ``db6db6f40f16eb7b``;
3. kernel vs plain: every kernel instantiation against the plain PyTorch
   version on the card, byte for byte, config2 at 1<<20 lanes x 64 ticks;
4. main path: the flagship campaign (config2, 1<<20 lanes, 4096 ticks,
   chunk 64, pipeline depth 16) through ``run``, with launch counts; its
   evictions must be the recorded ones, and each stream block that evicted
   is replayed with the plain version on the card (same dispatches, same
   ballot clamps) and must equal that block of the final state byte for
   byte; then once more under torch.profiler for the device's busy and
   idle time;
5. checker: config4 with a fixed-seed equivocation plan must report
   violations.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and last the ``{"ok": true, "device": ...}`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

GOLDEN_CONFIG2 = "db6db6f40f16eb7b"  # config2, 256 lanes, seed 7, 32 ticks
FULL_LANES = 1 << 20
MAIN_PATH_REPEATS = 3
MAIN_TICKS, MAIN_CHUNK, MAIN_DEPTH = 4096, 64, 16
# The flagship campaign (seed 0) fills one lane's 8-slot learner table:
# lane 838 of stream block 963.  The plain version gives the same eviction.
MAIN_EVICTION_LANES = [986950]
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and
# int32 ALU throughput: 132 SMs x 64 INT32 lanes x 1.98 GHz x 2 (an IMAD,
# IADD3 or LOP3 instruction does two of the counted operations, so this
# is an upper bound on the rate).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9 * 2


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def digest(state) -> str:
    h = hashlib.sha256()
    for leaf in state.leaves():
        h.update(leaf.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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


def tick_ops_per_lane() -> float:
    """int32 operations per lane-tick of the unpacked config2 tick: the
    ALU + reduction census of scripts/roofline.py (recorded in
    ROOFLINE.json), without its packed-codec share, which the unpacked port
    does not execute.  The census draws every mask of every slot, where the
    kernel draws lazily, so it overcounts the kernel's operations."""
    cases = json.loads(Path("ROOFLINE.json").read_text())["cases"]
    c = next(c for c in cases if c["case"] == "config2-paxos")
    return c["alu_per_lane_tick"] + c["reduce_per_lane_tick"] - c["codec_alu_per_lane_tick"]


def phase_build() -> dict:
    from paxos_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build("fused_paxos_tick")
    secs = time.perf_counter() - t0
    report = build.ptxas_report("fused_paxos_tick")
    keys = ("entry function", "registers", "spill")
    lines = [ln.strip() for ln in report.splitlines() if any(k in ln for k in keys)]
    log(f"build: {secs:.1f} s (nvcc, sm_90a)")
    for ln in lines:
        log(f"ptxas: {ln}")
    return {"build_s": secs, "ptxas": lines}


def phase_golden() -> None:
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import init_plan, init_state
    from paxos_tpu_torch.kernels.fused_tick import fit_block, fused_paxos_chunk

    cfg = C.config2_dueling_drop(256, 7)
    state = init_state(cfg, "cuda")
    block = fit_block(1024, 256)
    state = fused_paxos_chunk(state, cfg.seed, init_plan(cfg, "cuda"), cfg.fault, 32, block=block)
    got = digest(state)
    log(f"golden: config2 256 lanes seed 7 32 ticks digest {got} (want {GOLDEN_CONFIG2})")
    if got != GOLDEN_CONFIG2:
        raise AssertionError(f"golden digest {got} != {GOLDEN_CONFIG2}")


def equivocation_plan(n_inst: int, n_acc: int, n_prop: int, p: float, seed: int):
    from paxos_tpu_torch.faults.injector import FaultPlan

    plan = FaultPlan.none(n_inst, n_acc, n_prop, device="cuda")
    rng = np.random.default_rng(seed)
    plan.equivocate = torch.from_numpy(rng.random((n_acc, n_inst)) < p).cuda()
    return plan


def near_limit_state(cfg, rnd: int):
    """``cfg``'s initial state with every proposer at ballot round ``rnd``
    (and its PREPAREs in flight at that ballot)."""
    from paxos_tpu_torch.harness.run import init_state

    st = init_state(cfg, "cuda")
    pid = torch.arange(cfg.n_prop, dtype=torch.int32, device="cuda")[:, None]
    st.proposer.bal.copy_((rnd * 8 + pid + 1).expand_as(st.proposer.bal))
    st.requests.bal[0] = st.proposer.bal[:, None, :]
    return st


def compare(name, cfg, plan, n_ticks, block=1024, reps=0, init=None, **kw) -> dict:
    """Kernel vs plain on the card from the same initial state; ``kw`` are
    the wrapper's ``blk0`` and ``clamp_per_tick``."""
    from paxos_tpu_torch.core.state import state_bytes_per_lane
    from paxos_tpu_torch.harness.run import init_state
    from paxos_tpu_torch.kernels.fused_tick import fused_paxos_chunk, reference_chunk

    init = init_state(cfg, "cuda") if init is None else init
    plain, plain_ms = timed(
        lambda: reference_chunk(
            init, cfg.seed, plan, cfg.fault, n_ticks, blk_id=kw.get("blk0", 0),
            block=block, clamp_per_tick=kw.get("clamp_per_tick", False),
        )
    )
    st = init.clone()
    torch.cuda.synchronize()
    kern, kern_ms = timed(
        lambda: fused_paxos_chunk(st, cfg.seed, plan, cfg.fault, n_ticks, block=block, **kw)
    )
    err = max_abs_err(kern.leaves(), plain.leaves())
    log(f"{name}: {cfg.n_inst} lanes x {n_ticks} ticks, kernel vs plain max_abs_err {err}")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    out = {"max_abs_err": err, "plain_ms": plain_ms, "first_ms": kern_ms}
    if reps:
        # Steady state: further chunks continuing from the compared state.
        _, out["ms"] = timed(
            lambda: fused_paxos_chunk(kern, cfg.seed, plan, cfg.fault, n_ticks, block=block),
            reps,
        )
        plan_bytes = sum(l.element_size() * l.numel() for l in (plan.crash_start, plan.crash_end, plan.equivocate))
        n_bytes = 2 * state_bytes_per_lane(init) * cfg.n_inst + plan_bytes
        n_ops = tick_ops_per_lane() * cfg.n_inst * n_ticks
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / INT32_OPS_PER_S * 1e3
        out.update(
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            bytes_ms=bytes_ms, ops_ms=ops_ms, state_bytes_per_lane=state_bytes_per_lane(init),
        )
        log(
            f"{name}: kernel {out['ms']:.3f} ms/chunk (first {kern_ms:.3f}), plain "
            f"{plain_ms:.1f} ms, bound {out['bound_ms']:.3f} ms ({out['bound_by']}; bytes "
            f"{bytes_ms:.3f} ms, int32 ops {ops_ms:.3f} ms)"
        )
    return out


def phase_compare() -> dict:
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import init_plan

    cfg1 = C.config1_no_faults(4096, 3)
    compare("config1 (1,3,8)", cfg1, init_plan(cfg1, "cuda"), 64)
    cfg4 = C.config4_byzantine(4096, 5)
    compare("config4 (2,5,8)", cfg4, equivocation_plan(4096, 5, 2, 0.25, 4), 300)
    # The per-tick ballot clamp (chunks over 6144 ticks) and a nonzero block
    # offset, which the main path does not take, from near-limit ballots.
    cfgc = C.config2_dueling_drop(4096, 13)
    compare(
        "config2 per-tick clamp, blk0=5", cfgc, init_plan(cfgc, "cuda"), 96,
        init=near_limit_state(cfgc, 4094), blk0=5, clamp_per_tick=True,
    )
    cfg2 = C.config2_dueling_drop(FULL_LANES, 7)
    return compare("config2 full width", cfg2, init_plan(cfg2, "cuda"), 64, reps=5)


def replay_block(cfg, state, blk: int) -> int:
    """Stream block ``blk`` of the main path through the plain version on
    the card, with the main path's dispatches and ballot clamps; returns
    its max_abs_err against that block of the main path's ``state``."""
    from paxos_tpu_torch.harness.run import init_plan, init_state
    from paxos_tpu_torch.kernels.fused_tick import DEFAULT_BLOCK, reference_chunk, saturate_ballots

    sub = dataclasses.replace(cfg, n_inst=DEFAULT_BLOCK)
    st, plan = init_state(sub, state.device), init_plan(sub, state.device)
    per_dispatch = MAIN_CHUNK * MAIN_DEPTH
    assert MAIN_TICKS % per_dispatch == 0
    for _ in range(MAIN_TICKS // per_dispatch):
        st = saturate_ballots(st)
        st = reference_chunk(
            st, cfg.seed, plan, cfg.fault, per_dispatch, blk_id=blk, block=DEFAULT_BLOCK
        )
        st = saturate_ballots(st)
    lo = blk * DEFAULT_BLOCK
    main = [x[..., lo:lo + DEFAULT_BLOCK] if x.dim() else x for x in state.leaves()]
    return max_abs_err(main, st.leaves())


def phase_main_path() -> dict:
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import run
    from paxos_tpu_torch.kernels.fused_tick import DEFAULT_BLOCK, fused_paxos_chunk

    cfg = C.config2_dueling_drop(FULL_LANES, seed=0)
    walls, launches, report, state = [], 0, None, None
    for _ in range(MAIN_PATH_REPEATS):
        torch.cuda.synchronize()
        fused_paxos_chunk.launches = 0
        t0 = time.perf_counter()
        rep_report, state = run(
            cfg, engine="fused", total_ticks=MAIN_TICKS, chunk=MAIN_CHUNK,
            pipeline_depth=MAIN_DEPTH, return_state=True,
        )
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = fused_paxos_chunk.launches
        if report is not None and rep_report != report:
            raise AssertionError(f"main path not deterministic: {rep_report} != {report}")
        report = rep_report
    wall = sorted(walls)[len(walls) // 2]
    log(f"main path report: {json.dumps(report)}")
    rate = cfg.n_inst * MAIN_TICKS / wall
    log(
        f"main path: median {wall:.4f} s wall of {[round(w, 4) for w in walls]}, "
        f"{rate:.4g} quorum-rounds/s, {launches} kernel launches per run"
    )
    if report["ticks"] != MAIN_TICKS or not 0.0 <= report["chosen_frac"] <= 1.0:
        raise AssertionError(f"malformed report {report}")
    if report["violations"] != 0:
        raise AssertionError(f"config2 must be safe: {report}")
    if launches == 0:
        raise AssertionError("the main path never launched the fused kernel")
    lanes = torch.nonzero(state.learner.evictions).flatten().tolist()
    log(f"main path: evictions {report['evictions']} on lanes {lanes[:16]}")
    if report["evictions"] != len(MAIN_EVICTION_LANES) or lanes != MAIN_EVICTION_LANES:
        raise AssertionError(f"evictions on lanes {lanes}, recorded {MAIN_EVICTION_LANES}")
    replayed = {}
    for blk in sorted({lane // DEFAULT_BLOCK for lane in lanes}):
        t0 = time.perf_counter()
        replayed[blk] = err = replay_block(cfg, state, blk)
        log(
            f"main path: stream block {blk} replayed by the plain version in "
            f"{time.perf_counter() - t0:.1f} s, max_abs_err {err}"
        )
        if err != 0:
            raise AssertionError(f"stream block {blk}: kernel disagrees with the plain version")
    return {"launches": launches, "wall_s": wall, "walls_s": walls, "rounds_per_s": rate,
            "evictions": report["evictions"], "replayed_blocks": replayed}


def phase_main_path_profile() -> dict:
    """The main path once more under torch.profiler: the fused kernel's
    share of device time and the device's idle share of the wall time
    (the profiler's own host cost inflates the wall a little)."""
    from torch.profiler import ProfilerActivity, profile

    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import run

    cfg = C.config2_dueling_drop(FULL_LANES, seed=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(cfg, total_ticks=MAIN_TICKS, chunk=MAIN_CHUNK, pipeline_depth=MAIN_DEPTH)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    kernel_us = sum(e.self_device_time_total for e in events if "fused_paxos_kernel" in e.key)
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6, "kernel_s": kernel_us / 1e6}
    if busy_us == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return out
    out["idle_share"] = 1.0 - busy_us / wall_us
    log(
        f"profile: wall {out['wall_s']:.3f} s, device busy {out['device_busy_s']:.3f} s "
        f"(fused kernel {out['kernel_s']:.3f} s), device idle share {out['idle_share']:.4f}"
    )
    return out


def phase_checker() -> None:
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import run

    cfg = C.config4_byzantine(4096)
    plan = equivocation_plan(cfg.n_inst, cfg.n_acc, cfg.n_prop, cfg.fault.p_equiv, 0)
    report = run(cfg, total_ticks=300, plan=plan)
    log(f"checker: config4 violations {report['violations']}")
    if report["violations"] <= 0:
        raise AssertionError("config4 equivocation must light up the safety checker")


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
    phase_golden()
    full = phase_compare()
    main_path = phase_main_path()
    profiled = phase_main_path_profile()
    phase_checker()
    kernel = {
        "name": "fused_paxos_tick",
        "route": "cuda",
        "source": "paxos_tpu_torch/kernels/csrc/fused_paxos_tick.cu",
        "replaces": "paxos_tpu/kernels/fused_tick.py:345",
        "launches": main_path["launches"],
        "max_abs_err": full["max_abs_err"],
        "tolerance": 0,  # int32/bool state: byte-identical to the plain version
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
        "shape": f"config2 {FULL_LANES} lanes x 64 ticks, block 1024",
        "build_s": built["build_s"],
        "ptxas": built["ptxas"],
        "main_path_wall_s": main_path["wall_s"],
        "main_path_walls_s": main_path["walls_s"],
        "main_path_rounds_per_s": main_path["rounds_per_s"],
        "main_path_evictions": main_path["evictions"],
        "main_path_replayed_blocks_max_abs_err": main_path["replayed_blocks"],
        "main_path_profile": profiled,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
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
