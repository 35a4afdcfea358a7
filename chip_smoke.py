#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure, so any failed phase exits non-zero):

1. build: the six kernels of ``paxos_tpu_torch/kernels/csrc`` and the
   fused kernels' draw-counting builds, one nvcc each, all started
   together, the phase-clock builds of K1 to K5, and the ablated builds of
   K1 and K5 (``-DFUSED_ABLATE``, one per component of the tick, each
   with its draw-counting build); each kernel's
   ``ptxas -v`` registers and spills, and the launch geometry per
   instantiation of the kernels, each of which stages a column per lane
   in shared memory (K1 to K5: lanes a CUDA block, staged rows, shared
   bytes, blocks an SM holds);
2. ceiling: the int32 probe (K6) against its plain version byte for byte,
   then the card's int32 operation rate from two iteration counts, printed
   beside the published peak that the bounds divide by;
3. golden: config2, Fast Paxos and Raft-core (config5) at 256 lanes, seed
   7, 32 ticks through their kernels must give the recorded state digests,
   and config3 (Multi-Paxos) and config_delay_chaos (SynchPaxos) the
   digests the JAX package gives on this script's numpy plans
   (``MP_GOLDEN``, ``SP_GOLDEN``); config2 and config5's Fast Paxos and
   Raft-core cells with every observer plane on, through K1's, K2's and
   K3's observed instantiations, the goldens in all but the planes, and
   config3 and config_delay_chaos so through K5's and K4's, the goldens in
   all but the planes and the observed goldens in full (``MP_OBS_GOLDEN``,
   ``SP_OBS_GOLDEN``);
4. kernel vs plain: every kernel instantiation against the plain PyTorch
   version on the card, byte for byte, including a per-tick ballot clamp
   with a block offset, config4's equivocators with and without crash
   windows, Multi-Paxos long logs compacted between chunks,
   SynchPaxos with and without delay stamps, with delta violated, and
   with duplicates, uneven quorums and a ballot stride, Paxos, Fast Paxos
   and Raft-core with duplicates and a ballot stride (Paxos and Fast Paxos
   also with uneven quorums), Multi-Paxos with duplicates, uneven quorums
   and a ballot stride (:func:`mp_knob_configs`), the gray-failure and
   partition arms of K1 to K5 on each knob alone and on the configs that
   set them (K2 to K5 also on every knob at once, K4's with its stamps,
   and K4 on delay across a cut in every lane; :func:`gray_knob_configs`;
   K5 also on the JAX package's own two cases of tests/test_gray.py), the
   bounded-delay channel of K1, K2, K3 and K5 on config_delay_chaos (K5:
   its fault config on config3's cell) in both regimes, with drops and
   duplicates, across a cut, and with every gray knob
   (:func:`delay_knob_configs`), the observed instantiations of K1 to K5
   (every observer plane on) on config_gray_chaos, config_corrupt,
   config_stale and config_delay_chaos (K2, K3 and K5 also on their cell,
   K5 on config3's with each fault config) at 1<<16 lanes and under the
   per-tick clamp, each also against the planes-off kernel (the planes
   move no schedule),
   and at full width
   (1<<20 lanes x 64 ticks) on each main path's config, config3-long
   compacted after every chunk, timed, with the counter-PRNG
   draws of the timed ticks counted by each kernel's measuring build for
   its operation floor (``DRAW_OPS``; no kernel may beat its bound), and
   its slot-array (delay-stamp) touches for the census estimate; timed so
   in the steady state and on the first chunk, where the lanes still
   send (for K4 in the delta-violating regime too), K1 to K5 with the
   split of a lane's cycles by phase of the tick from their phase-clock
   builds; the column load and store alone (a launch of 0 ticks) of K1 to
   K4, and K5 on config3 and config3-long; a path's first chunk is
   compared once, then timed from copies of its initial state in the same
   call;
5. ablation: each ablated build of K1 (config2) and K5 (config3) against
   the plain tick without the same component, byte for byte, at 1<<16
   lanes over two 64-tick chunks from stream block 5, then timed with its
   bound (the build without the PRNG must draw nothing); and the ablation
   entry point's table (``python -m paxos_tpu_torch.scripts.ablate_fused``,
   ``time_variant``) for both at full width, the first chunk and the
   steady state, printed as one ``{"ablation": ...}`` line, each ablated
   build's launches counted from 0 around it (none may be 0);
6. main paths: the flagship campaign (config2), the config5 sweep's Fast
   Paxos and Raft-core campaigns, config3 (Multi-Paxos, leader lease and
   leader crash), config3-long (a 256-slot log through a 16-slot
   window, compacted after every chunk), SynchPaxos on
   config_delay_chaos (bounded delay; its fast-path rate is printed),
   config_gray_chaos's fault config (one-way partitions, flaky links, timer
   skew) on Paxos, Fast Paxos, Raft-core, config3's Multi-Paxos cell and
   config_delay_chaos's SynchPaxos cell (the arms instantiations of K1 to
   K5; the last two through ``run(..., liveness=True)``, their liveness
   blocks printed), and config_delay_chaos on Paxos, Fast Paxos and
   Raft-core and its fault config on config3's Multi-Paxos cell (the
   stamped instantiations of K1, K2, K3 and K5; the last through
   ``run(..., liveness=True)``), and config2 and config5's Fast Paxos and
   Raft-core cells, config3's Multi-Paxos cell and config_delay_chaos's
   SynchPaxos cell with every observer plane on (``observed-paxos``,
   ``observed-fastpaxos``, ``observed-raftcore``, ``observed-multipaxos``,
   ``observed-synchpaxos``: the observed instantiations of K1, K2, K3, K5
   and K4; their telemetry, coverage, exposure, margin and slo blocks
   printed and checked against each other, their protocol state pinned as
   their planes-off path's), and config3-long so (``observed-multipaxos-long``,
   K5's observed long-log instantiation, compacted after every chunk), at
   1<<20 lanes, chunk 64, pipeline depth 16 and 4096 ticks (config3-long
   1024), through ``run``,
   each with every launch count set to 0 before and read after; reports
   deterministic over 3 repeats, no violations; the two lowest-numbered
   stream blocks that evicted must equal, digest for digest, what the JAX
   package computes for them (``EVICTION_PINS``, checked by
   tests/test_torch_evictions.py and the files named there), and so must
   stream block 0 of most paths (``BLOCK0_DIGESTS``); then once more under torch.profiler
   for the device's busy and idle time;
7. checker: config4's equivocation, an unsafe Fast Flexible Paxos quorum
   triple, Raft-core equivocation and Multi-Paxos equivocation must each
   report violations (Multi-Paxos: the count the JAX package gives,
   ``MP_CHECKER_VIOLATIONS``), and SynchPaxos' planted ``sp_unsafe_fast``
   bug proposer disagreements at the JAX package's count
   (``SP_CHECKER_DISAGREE``); Paxos' bug injections, payload
   corruption, stale-snapshot recovery and unsafe Flexible Paxos quorums,
   must each report violations; and payload corruption and stale-snapshot
   recovery on Fast Paxos, Raft-core
   and SynchPaxos (K2's, K3's and K4's arms) the violations of the plain
   tick and of the JAX package (``FR_CHECKER_VIOLATIONS``), stale
   recovery's summed over Paxos and Fast Paxos as the JAX package's pin
   sums it (``STALE_SUM``), and so on config3's cell (K5's arms,
   ``MP_GRAY_CHECKER_VIOLATIONS``).

Configs with crash windows, equivocators, link delays, partitions or the
gray-failure plan fields run on plans drawn here from numpy
(:func:`config_plan`): the config's own distribution, from another stream
than the JAX package's ``FaultPlan.sample``.

Prints the ``{"ablation": ...}`` line, one ``{"kernels": [...]}`` line (an
entry per main path: its kernel's instantiation on the path's config; an
entry per ablated build, with the ablation table's launches), the card's name and power limit, and last the
``{"ok": true, "device": ...}`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from paxos_tpu_torch.core.device import card_line
from paxos_tpu_torch.harness.np_plan import config_plan, fault_plan, gray_plan_fields  # noqa: F401

# Recorded state digests: 256 lanes, seed 7, 32 ticks (the JAX package's
# tests/test_gray.py _GOLDEN_CTR).
GOLDENS = {
    "paxos": "db6db6f40f16eb7b",
    "fastpaxos": "72beea3ccdacab94",
    "raftcore": "eb285905571b709f",
}
# config3 at 256 lanes, seed 7, 32 ticks, block 256 on config_plan(cfg, 7)
# (tests/test_torch_multipaxos.py computes it with the JAX package).
MP_GOLDEN = "3e755a68b483cd90"
# config_delay_chaos at 256 lanes, seed 7, 32 ticks, block 256 on
# config_plan(cfg, 7) (tests/test_torch_synchpaxos.py computes it with the
# JAX package).
SP_GOLDEN = "01e6b169dab4d6cb"
# The same two runs with every observer plane on (obs_planes; the workload
# on wload_plan's numpy plan): the state but the planes gives MP_GOLDEN and
# SP_GOLDEN, the whole state these (tests/test_torch_obs_multipaxos.py and
# tests/test_torch_obs_synchpaxos.py compute them with the JAX package).
MP_OBS_GOLDEN = "57133b49a36ccfad"
SP_OBS_GOLDEN = "7f2e470acbe52f3c"
FULL_LANES = 1 << 20
MAIN_PATH_REPEATS = 3
MAIN_TICKS, MAIN_CHUNK, MAIN_DEPTH = 4096, 64, 16
LONG_TICKS = 1024  # config3-long: 16 compactions


@dataclasses.dataclass(frozen=True)
class MainPath:
    """A main path: its protocol and ticks, its config (a function of
    ``harness/config.py``, and the config's index where that returns a
    sweep, run on the path's protocol; ``fault``: the config function whose
    fault config replaces the config's, as the JAX package's audit puts a
    fault config on every protocol), and the census case (``ROOFLINE.json``)
    of the estimate printed beside its kernel's bound.
    ``compact``: decided prefixes compact out after every chunk.
    ``fast_path``: the path's fast-path rate (SynchPaxos) is printed.
    ``liveness``: the path runs through ``run(..., liveness=True)``, and its
    liveness block is printed.  Every path is also timed at full width, a
    path's kernel entry is the first path of its protocol."""

    protocol: str
    ticks: int
    config: str
    census: str
    sweep_index: "int | None" = None
    compact: bool = False
    fast_path: bool = False
    # Chunks of the full-width comparison: more than 1 compares a chunk
    # from a state past the initial one too.
    compare_chunks: int = 1
    fault: "str | None" = None
    liveness: bool = False
    # The observer planes on (obs_planes): the path runs its kernel's
    # observed instantiation and prints the report's plane blocks.
    planes: bool = False


# The observer planes of the observed paths, at the settings the JAX
# package's users take: the flight recorder with counters, a 16-word ring
# and 8 histogram bins (its tests/test_telemetry.py), 64 coverage words
# (its CLI's and fleet worker's default), the exposure and margin counters
# (which its guided fuzzer turns on), and the "mixed" client workload at
# WorkloadConfig's defaults.
def obs_planes() -> dict:
    from paxos_tpu_torch.core.telemetry import TelemetryConfig
    from paxos_tpu_torch.obs.coverage import CoverageConfig
    from paxos_tpu_torch.obs.exposure import ExposureConfig
    from paxos_tpu_torch.obs.margin import MarginConfig
    from paxos_tpu_torch.workload.generator import WorkloadConfig

    return dict(
        telemetry=TelemetryConfig(counters=True, ring_depth=16, hist_bins=8),
        coverage=CoverageConfig(words=64), exposure=ExposureConfig(counters=True),
        margin=MarginConfig(counters=True), workload=WorkloadConfig(mix="mixed"),
    )


PLANE_BLOCKS = ("telemetry", "coverage", "exposure", "margin", "slo")


MAIN_PATHS = {
    "paxos": MainPath("paxos", MAIN_TICKS, "config2_dueling_drop", "config2-paxos"),
    "fastpaxos": MainPath("fastpaxos", MAIN_TICKS, "config5_sweep", "config5-fastpaxos", 1),
    "raftcore": MainPath("raftcore", MAIN_TICKS, "config5_sweep", "config5-raftcore", 2),
    "config3": MainPath("multipaxos", MAIN_TICKS, "config3_multipaxos", "config3-multipaxos"),
    "config3long": MainPath(
        "multipaxos", LONG_TICKS, "config3_long", "config3long-multipaxos", compact=True
    ),
    "synchpaxos": MainPath(
        "synchpaxos", MAIN_TICKS, "config_delay_chaos", "delaychaos-synchpaxos", fast_path=True
    ),
    "graychaos": MainPath(
        "paxos", MAIN_TICKS, "config_gray_chaos", "graychaos-paxos", compare_chunks=2
    ),
    "graychaos-fastpaxos": MainPath(
        "fastpaxos", MAIN_TICKS, "config5_sweep", "graychaos-fastpaxos", 1, compare_chunks=2,
        fault="config_gray_chaos",
    ),
    "graychaos-raftcore": MainPath(
        "raftcore", MAIN_TICKS, "config5_sweep", "graychaos-raftcore", 2, compare_chunks=2,
        fault="config_gray_chaos",
    ),
    "graychaos-multipaxos": MainPath(
        "multipaxos", MAIN_TICKS, "config3_multipaxos", "graychaos-multipaxos",
        compare_chunks=2, fault="config_gray_chaos", liveness=True,
    ),
    "graychaos-synchpaxos": MainPath(
        "synchpaxos", MAIN_TICKS, "config_delay_chaos", "graychaos-synchpaxos", fast_path=True,
        compare_chunks=2, fault="config_gray_chaos", liveness=True,
    ),
    "delaychaos-paxos": MainPath(
        "paxos", MAIN_TICKS, "config_delay_chaos", "delaychaos-paxos", compare_chunks=2,
    ),
    "delaychaos-fastpaxos": MainPath(
        "fastpaxos", MAIN_TICKS, "config_delay_chaos", "delaychaos-fastpaxos", compare_chunks=2,
    ),
    "delaychaos-raftcore": MainPath(
        "raftcore", MAIN_TICKS, "config_delay_chaos", "delaychaos-raftcore", compare_chunks=2,
    ),
    "delaychaos-multipaxos": MainPath(
        "multipaxos", MAIN_TICKS, "config3_multipaxos", "delaychaos-multipaxos",
        compare_chunks=2, fault="config_delay_chaos", liveness=True,
    ),
    "observed-paxos": MainPath(
        "paxos", MAIN_TICKS, "config2_dueling_drop", "config2-paxos", compare_chunks=2,
        planes=True,
    ),
    "observed-fastpaxos": MainPath(
        "fastpaxos", MAIN_TICKS, "config5_sweep", "config5-fastpaxos", 1, compare_chunks=2,
        planes=True,
    ),
    "observed-raftcore": MainPath(
        "raftcore", MAIN_TICKS, "config5_sweep", "config5-raftcore", 2, compare_chunks=2,
        planes=True,
    ),
    "observed-multipaxos": MainPath(
        "multipaxos", MAIN_TICKS, "config3_multipaxos", "config3-multipaxos", compare_chunks=2,
        planes=True,
    ),
    "observed-synchpaxos": MainPath(
        "synchpaxos", MAIN_TICKS, "config_delay_chaos", "delaychaos-synchpaxos", fast_path=True,
        compare_chunks=2, planes=True,
    ),
    "observed-multipaxos-long": MainPath(
        "multipaxos", LONG_TICKS, "config3_long", "config3long-multipaxos", compact=True,
        compare_chunks=2, planes=True,
    ),
}
# The report keys of the liveness block (harness.run.summarize(liveness=)).
LIVENESS_KEYS = ("decided_by_curve", "chosen_tick_hist", "hist_bin_width", "stuck_lanes")
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
    "config3": (0, {}),
    "config3long": (0, {}),
    "synchpaxos": (4, {595: ([129], "3da7a9c3d5cad789"), 821: ([636], "f9da58d7938887dd")}),
    "graychaos": (56, {90: ([430], "45f077b32e2cf14b"), 104: ([582], "f732a5e3e62d60a0")}),
    "graychaos-fastpaxos": (
        336, {1: ([161], "31978ee56bdbb58a"), 6: ([576, 747], "c2630ba35a33c636")}
    ),
    "graychaos-raftcore": (0, {}),
    "graychaos-multipaxos": (0, {}),
    "graychaos-synchpaxos": (
        52, {138: ([769], "87311d95168824ae"), 188: ([479], "9025712b1c6682d1")}
    ),
    "delaychaos-paxos": (1, {709: ([162], "252e7af2de48f22d")}),
    "delaychaos-fastpaxos": (
        136, {16: ([517], "3a8fda3a396da1a3"), 18: ([620], "11184a3d14ece49d")}
    ),
    "delaychaos-raftcore": (0, {}),
    "delaychaos-multipaxos": (0, {}),
    # The observed paths: the planes move no schedule, so each path's
    # protocol state (the digest leaves out the planes) is its planes-off
    # path's.
    "observed-paxos": (1, {963: ([838], "8c8a818261f3d84c")}),
    "observed-fastpaxos": (138, {5: ([862], "659e8267fff0c143"), 17: ([213], "0727753391be6bf5")}),
    "observed-raftcore": (0, {}),
    "observed-multipaxos": (0, {}),
    "observed-synchpaxos": (4, {595: ([129], "3da7a9c3d5cad789"), 821: ([636], "f9da58d7938887dd")}),
    "observed-multipaxos-long": (0, {}),
}
# The state digest of stream block 0 after each Multi-Paxos main path, the
# SynchPaxos ones, the gray-chaos ones and the delay-chaos ones, as the JAX
# package computes it (tests/test_torch_evictions.py,
# tests/test_torch_gray_evictions.py, tests/test_torch_fr_gray_evictions.py,
# tests/test_torch_mp_gray_pins.py, tests/test_torch_delay_gray_pins.py,
# tests/test_torch_delay_pins.py).
BLOCK0_DIGESTS = {
    "config3": "883d8be41b65a537", "config3long": "42961f14b71b0d5d",
    "synchpaxos": "77bdd097d024b69b", "graychaos": "92c059e4a486f4a2",
    "graychaos-fastpaxos": "1be08342ba47756d", "graychaos-raftcore": "8e15a5b6acc869d0",
    "graychaos-multipaxos": "3488379663f97567", "graychaos-synchpaxos": "ec7f809a37d50f00",
    "delaychaos-paxos": "7b1972db532f308e", "delaychaos-fastpaxos": "2c4b187ef8be3555",
    "delaychaos-raftcore": "dc97be812c0ca2bb", "delaychaos-multipaxos": "a87821b69a0cc584",
    # The observed paths: their planes-off path's block (the digest leaves
    # out the planes).
    "observed-multipaxos": "883d8be41b65a537", "observed-synchpaxos": "77bdd097d024b69b",
    "observed-multipaxos-long": "42961f14b71b0d5d",
}
# Violations of config3 at 1024 lanes, seed 3, with p_equiv 0.4 over 300
# ticks on config_plan(cfg, 3) (tests/test_torch_multipaxos.py computes
# the count with the JAX package).
MP_CHECKER_VIOLATIONS = 1043
# SynchPaxos' planted bug (sp_unsafe_fast) under delta-violating delays
# with p_drop 0.4, 1024 lanes, seed 3, over SP_CHECKER_TICKS ticks on
# config_plan(cfg, 3): the proposer disagreements the JAX package's fused
# reference reports (tests/test_torch_synchpaxos.py).
SP_CHECKER_TICKS = 256
SP_CHECKER_DISAGREE = 15
# The bug injections on Fast Paxos, Raft-core and SynchPaxos (the arms of
# K2, K3 and K4):
# (config, protocol, lanes, seed, ticks) -> the violations the JAX
# package's fused stream gives on config_plan(cfg, seed), a stream block of
# 1024 lanes at a time (tests/test_torch_fr_gray_pins.py computes them):
# payload corruption at the JAX package's pin size, stale-snapshot recovery
# at its tests/test_gray.py pin (4096 lanes, seed 3, 192 ticks), which sums
# Paxos and Fast Paxos (STALE_SUM).  Raft-core's and SynchPaxos' stale
# recovery breaks agreement at this size in neither package.
FR_CHECKER_VIOLATIONS = {
    ("config_corrupt", "fastpaxos", 1024, 0, 256): 45,
    ("config_corrupt", "raftcore", 1024, 0, 256): 514,
    ("config_corrupt", "synchpaxos", 1024, 0, 256): 109,
    ("config_stale", "paxos", 4096, 3, 192): 0,
    ("config_stale", "fastpaxos", 4096, 3, 192): 27,
    ("config_stale", "raftcore", 4096, 3, 192): 0,
    ("config_stale", "synchpaxos", 4096, 3, 192): 0,
}
STALE_SUM = 27  # config_stale(4096, 3) over 192 ticks: Paxos plus Fast Paxos
# The same bug injections' fault configs on config3's cell (K5's arms):
# (config, lanes, seed, ticks) -> the violations the JAX package's fused
# stream gives on config_plan(cfg, seed), a stream block of 256 lanes at a
# time (tests/test_torch_mp_gray.py computes them), at
# FR_CHECKER_VIOLATIONS' sizes.  Stale recovery breaks no agreement of
# Multi-Paxos at that size in either package.
MP_GRAY_CHECKER_VIOLATIONS = {
    ("config_corrupt", 1024, 0, 256): 1517,
    ("config_stale", 4096, 3, 192): 0,
}
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and
# int32 ALU throughput: 132 SMs x 64 INT32 lanes x 1.98 GHz x 2 (an IMAD,
# IADD3 or LOP3 instruction does two of the counted operations, so this
# is an upper bound on the rate).  The bounds divide by these; the rate
# K6 measures is printed beside them.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9 * 2
# The int32 operations of one counter-PRNG draw (fused_common.cuh
# counter_bits) with its launch-constant terms hoisted, and the compare
# that makes it a mask bit: the position add, the seed xor, three
# xor-shifts of two operations each, two multiplies and the compare
# (tests/test_torch_census.py counts them in the source).  A kernel draws a
# mask only where the outcome depends on it, so the draws its measuring
# build counts are work the run's data needs: at DRAW_OPS each they are
# the operation floor of a fused kernel's bound.  The rest of a tick's
# work depends on the data in ways that no count here bounds from below;
# the census of the vectorised tick (tick_ops_per_lane) is printed beside
# the bound, and is no floor (a kernel skips the arms and slots a tick
# does not reach).
DRAW_OPS = 11
# The census estimate printed beside each fused kernel's bound.
# Per census case of the int32 operation census of one tick
# (scripts/roofline.py tick_census, in ROOFLINE.json), the shares that the
# census counts for every element every tick and a kernel only where it
# runs them; tests/test_torch_census.py computes both with the JAX package.
# MASK_CENSUS: the share of counter_masks, which draws every mask element:
# (operations, mask elements) per lane-tick, as census_jaxpr counts them.
# The kernels draw lazily, so the estimate counts the draws a run makes at
# this cost per element instead.
MASK_CENSUS = {
    "config2-paxos": (1228.064453125, 87.0),
    "config5-fastpaxos": (1228.064453125, 87.0),
    "config5-raftcore": (1228.064453125, 87.0),
    "config3-multipaxos": (1261.3046875, 89.0),
    "config3long-multipaxos": (1261.3046875, 89.0),
    "delaychaos-synchpaxos": (1883.078125, 147.0),
    "graychaos-paxos": (1578.056640625, 127.0),
    "graychaos-fastpaxos": (1578.056640625, 127.0),
    "graychaos-raftcore": (1578.056640625, 127.0),
    "graychaos-multipaxos": (1371.265625, 109.0),
    "graychaos-synchpaxos": (1578.056640625, 127.0),
    "delaychaos-paxos": (1883.078125, 147.0),
    "delaychaos-fastpaxos": (1883.078125, 147.0),
    "delaychaos-raftcore": (1883.078125, 147.0),
    "delaychaos-multipaxos": (1881.3359375, 149.0),
}
# Census cases that ROOFLINE.json does not hold, recorded here with the
# same keys: scripts/roofline.py tick_census(config_delay_chaos(1024), 1024)
# on SynchPaxos, which gives the same figures for violate_delta, and on
# Paxos, Fast Paxos and Raft-core, and tick_census(config_gray_chaos(1024),
# 1024) on Paxos, on Fast Paxos, Raft-core and SynchPaxos (config5's cells
# and config_delay_chaos's with config_gray_chaos's fault config), and at
# 256 on Multi-Paxos (config3's cell with either's fault config)
# (tests/test_torch_census.py recomputes them with the JAX package).
CENSUS_CASES = {
    "delaychaos-synchpaxos": {
        "case": "delaychaos-synchpaxos", "block": 1024,
        "alu_per_lane_tick": 4887.126953125, "codec_alu_per_lane_tick": 881.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 516.0,
        "unpacked_bytes_per_lane": 925.0,
    },
    "graychaos-paxos": {
        "case": "graychaos-paxos", "block": 1024,
        "alu_per_lane_tick": 4054.0888671875, "codec_alu_per_lane_tick": 881.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 356.0,
        "unpacked_bytes_per_lane": 765.0,
    },
    "graychaos-fastpaxos": {
        "case": "graychaos-fastpaxos", "block": 1024,
        "alu_per_lane_tick": 4590.1142578125, "codec_alu_per_lane_tick": 865.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 372.0,
        "unpacked_bytes_per_lane": 773.0,
    },
    "graychaos-raftcore": {
        "case": "graychaos-raftcore", "block": 1024,
        "alu_per_lane_tick": 4261.0927734375, "codec_alu_per_lane_tick": 881.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 356.0,
        "unpacked_bytes_per_lane": 765.0,
    },
    "graychaos-multipaxos": {
        "case": "graychaos-multipaxos", "block": 256,
        "alu_per_lane_tick": 6373.4375, "codec_alu_per_lane_tick": 3474.0,
        "reduce_per_lane_tick": 912.0, "state_bytes_per_lane": 904.0,
        "unpacked_bytes_per_lane": 1400.0,
    },
    "graychaos-synchpaxos": {
        "case": "graychaos-synchpaxos", "block": 1024,
        "alu_per_lane_tick": 4218.0888671875, "codec_alu_per_lane_tick": 881.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 356.0,
        "unpacked_bytes_per_lane": 765.0,
    },
    "delaychaos-paxos": {
        "case": "delaychaos-paxos", "block": 1024,
        "alu_per_lane_tick": 4703.1259765625, "codec_alu_per_lane_tick": 881.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 516.0,
        "unpacked_bytes_per_lane": 925.0,
    },
    "delaychaos-fastpaxos": {
        "case": "delaychaos-fastpaxos", "block": 1024,
        "alu_per_lane_tick": 5239.1513671875, "codec_alu_per_lane_tick": 865.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 532.0,
        "unpacked_bytes_per_lane": 933.0,
    },
    "delaychaos-raftcore": {
        "case": "delaychaos-raftcore", "block": 1024,
        "alu_per_lane_tick": 4910.1298828125, "codec_alu_per_lane_tick": 881.0,
        "reduce_per_lane_tick": 277.0, "state_bytes_per_lane": 516.0,
        "unpacked_bytes_per_lane": 925.0,
    },
    "delaychaos-multipaxos": {
        "case": "delaychaos-multipaxos", "block": 256,
        "alu_per_lane_tick": 7297.5625, "codec_alu_per_lane_tick": 3474.0,
        "reduce_per_lane_tick": 912.0, "state_bytes_per_lane": 1064.0,
        "unpacked_bytes_per_lane": 1560.0,
    },
}
# SLOT_CENSUS (Multi-Paxos): the share of the slot-indexed arrays (log,
# PROMISE payloads, recovery rows, learner table, chosen values and ticks),
# which the vectorised tick rewrites whole every tick and K5 touches only
# where the tick reads or writes a slot: (operations per lane-tick,
# slot-array elements per lane).  The census is linear in the window
# length, 528.125 operations per slot over 28 elements; the estimate
# counts the elements the measuring build touches at this cost per element.
SLOT_CENSUS = {
    "config3-multipaxos": (4225.0, 224.0),
    "config3long-multipaxos": (8450.0, 448.0),
    "graychaos-multipaxos": (4225.0, 224.0),
    "delaychaos-multipaxos": (4225.0, 224.0),
}
# STAMP_CENSUS (every protocol with delay): the share of the delay stamps
# (the stamp draw, the readiness compares and the stamp writes), which the
# vectorised tick computes for all 40 stamp elements every tick and the
# kernels only where they read a stamp that may have come due or write
# one: the census of the config less that of the same config with p_delay
# 0, net of the mask shares of both, (operations per lane-tick, stamp
# elements per lane).
STAMP_CENSUS = {
    "delaychaos-synchpaxos": (820.015625, 40.0),
    "delaychaos-paxos": (800.015625, 40.0),
    "delaychaos-fastpaxos": (800.015625, 40.0),
    "delaychaos-raftcore": (800.015625, 40.0),
    "delaychaos-multipaxos": (780.0546875, 40.0),
}
# Per census case, the share of the state elements a kernel touches
# outside its registers: the estimate counts the touches its measuring
# build counts at the census's cost per element, the slot arrays' and
# the stamps' summed where a case has both (K5 counts both in one count).
TOUCH_CENSUS = {
    case: tuple(map(sum, zip(*(d[case] for d in (SLOT_CENSUS, STAMP_CENSUS) if case in d))))
    for case in {**SLOT_CENSUS, **STAMP_CENSUS}
}
KERNEL_SOURCE = "paxos_tpu_torch/kernels/csrc/{}.cu"
# pl.pallas_call of the JAX package's fused engine (fused_chunk), which
# each protocol binds through fused_fns; and the int32 probe.
FUSED_PALLAS_CALL = "paxos_tpu/kernels/fused_tick.py:345"
REPLACES = {
    "paxos": FUSED_PALLAS_CALL + " (_kernel :201, packed_fns('paxos'))",
    "fastpaxos": FUSED_PALLAS_CALL + " (_kernel :201, fused_fns('fastpaxos') :655)",
    "raftcore": FUSED_PALLAS_CALL + " (_kernel :201, fused_fns('raftcore') :660)",
    "multipaxos": FUSED_PALLAS_CALL + " (_kernel :201, fused_fns('multipaxos') :670)",
    "synchpaxos": FUSED_PALLAS_CALL + " (_kernel :201, fused_fns('synchpaxos') :665)",
}


# The ablation variants of the JAX package's fused engine (fused_fns(p,
# ablate)) and the flags in its ticks, which the ablated builds of K1 and K5
# port.
ABLATED_REPLACES = {
    "paxos": FUSED_PALLAS_CALL + (
        " (_kernel :201, fused_fns('paxos', ablate) :623-687; the flags, "
        "paxos_tpu/protocols/paxos.py:170-215, :305-330, :421-432, :486, :505-535, :621)"
    ),
    "multipaxos": FUSED_PALLAS_CALL + (
        " (_kernel :201, fused_fns('multipaxos', ablate) :623-687; the flags, "
        "paxos_tpu/protocols/multipaxos.py:158-180, :252-262, :357-380, :421, :461-490, :611, :636)"
    ),
}
# The main path whose config each ablated kernel runs on (the JAX
# package's scripts/ablate_fused.py defaults: config2, config3), and the
# lanes of its comparison.
ABLATION_PATHS = {"paxos": "paxos", "multipaxos": "config3"}
ABLATION_LANES = 1 << 16


# The observer arms of each tick that the observed instantiations compute.
OBSERVER_ARMS = {
    "paxos": "; its observer arms, paxos_tpu/protocols/paxos.py:592-600, :652-771",
    "fastpaxos": "; its observer arms, paxos_tpu/protocols/fastpaxos.py:332-341, :393-505",
    "raftcore": "; its observer arms, paxos_tpu/protocols/raftcore.py:283-290, :346-460",
    "multipaxos": (
        "; its observer arms, paxos_tpu/protocols/multipaxos.py:244-248, :568-580, :658-774 "
        "(mp_margin_observe, paxos_tpu/check/mp_safety.py:139-200)"
    ),
    "synchpaxos": "; its observer arms, paxos_tpu/protocols/synchpaxos.py:280-292, :363-468",
}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def digest(leaves) -> str:
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(leaf.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def block_leaves(state, blk: int, block: int) -> list:
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


def tick_ops_per_lane(
    case: str, draws_per_lane_tick: "float | None" = None,
    touches_per_lane_tick: "float | None" = None,
) -> float:
    """int32 operations per lane-tick of the unpacked tick of census
    ``case``: the ALU + reduction census of scripts/roofline.py (recorded
    in ROOFLINE.json, or in ``CENSUS_CASES`` for a case it lacks).  Its
    ``alu_per_lane_tick`` is already net of the
    packed-codec share, which the unpacked port does not execute
    (scripts/roofline.py:143-144 records ``(alu - codec_alu) / block``), so
    nothing more is subtracted.  The census draws every mask element and
    rewrites every slot-array element (computes every delay stamp) every
    tick; given the draws and the slot-array (stamp) touches a kernel made
    per lane-tick, those shares are counted for what it made only, at the
    census's cost per element."""
    cases = json.loads(Path("ROOFLINE.json").read_text())["cases"]
    c = CENSUS_CASES.get(case) or next(c for c in cases if c["case"] == case)
    ops = c["alu_per_lane_tick"] + c["reduce_per_lane_tick"]
    for per_lane_tick, share in (
        (draws_per_lane_tick, MASK_CENSUS), (touches_per_lane_tick, TOUCH_CENSUS)
    ):
        if per_lane_tick is not None and case in share:
            share_ops, share_elems = share[case]
            ops += per_lane_tick * share_ops / share_elems - share_ops
    return ops


def main_config(path: str, n_inst: int = FULL_LANES, seed: int = 0):
    """The config of main path ``path`` (a key of ``MAIN_PATHS``)."""
    from paxos_tpu_torch.harness import config as C

    mp = MAIN_PATHS[path]
    cfg = getattr(C, mp.config)(n_inst, seed)
    cfg = cfg if mp.sweep_index is None else cfg[mp.sweep_index]
    if cfg.protocol != mp.protocol:  # a config function of another protocol, on this one
        cfg = dataclasses.replace(cfg, protocol=mp.protocol)
    if mp.fault is not None:
        cfg = dataclasses.replace(cfg, fault=getattr(C, mp.fault)(n_inst, seed).fault)
    if mp.planes:
        cfg = dataclasses.replace(cfg, **obs_planes())
    return cfg


def wload_plan(cfg, seed: int, device="cuda"):
    """The client workload's plan of ``cfg`` (mode, phase; (P, I) int32
    each) from the JAX package's distribution, drawn from numpy: a class
    uniform over the three where the mix is "mixed" (else the mix's), a
    phase uniform over [0, period); None when the plane is off."""
    from paxos_tpu_torch.core.streams import ROOT_WLOAD
    from paxos_tpu_torch.workload.generator import CLASSES

    w = cfg.workload
    if not w.enabled():
        return None
    rng = np.random.default_rng([seed, ROOT_WLOAD])
    shape = (cfg.n_prop, cfg.n_inst)
    if w.mix == "mixed":
        mode = rng.integers(0, len(CLASSES), shape, dtype=np.int32)
    else:
        mode = np.full(shape, CLASSES.index(w.mix), np.int32)
    phase = rng.integers(0, w.period, shape, dtype=np.int32)
    return torch.from_numpy(mode).to(device), torch.from_numpy(phase).to(device)


def path_state(cfg, device="cuda"):
    """``cfg``'s initial state, its observer planes included (the workload
    on :func:`wload_plan`'s plan)."""
    from paxos_tpu_torch.harness.run import init_state

    return init_state(cfg, device, wload_plan(cfg, cfg.seed, device))


def without_planes(state):
    """``state`` without its observer planes (the same tensors otherwise)."""
    return dataclasses.replace(state, **{name: None for name in state.planes}) if state.planes else state


def with_planes(cfg):
    """``cfg`` with every observer plane on (:func:`obs_planes`)."""
    return dataclasses.replace(cfg, **obs_planes())


def reset_launches() -> None:
    from paxos_tpu_torch.kernels.fused_tick import FUSED_WRAPPERS
    from paxos_tpu_torch.kernels.int32_ceiling import int32_ceiling

    for wrapper in FUSED_WRAPPERS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "ablated_launches"):
            wrapper.ablated_launches.clear()
    int32_ceiling.launches = 0


def read_launches() -> dict:
    from paxos_tpu_torch.kernels.fused_tick import FUSED_WRAPPERS
    from paxos_tpu_torch.kernels.int32_ceiling import int32_ceiling

    out = {p: w.launches for p, w in FUSED_WRAPPERS.items()}
    out["int32_ceiling"] = int32_ceiling.launches
    return out


def ablated_builds() -> list:
    """(protocol, ablate) of every ablated build: each flag of
    ``ABLATE_FLAGS`` alone, on K1 and K5."""
    from paxos_tpu_torch.kernels.fused_tick import ABLATE_KEYS
    from paxos_tpu_torch.protocols.paxos import ABLATE_FLAGS

    return [(p, frozenset({flag})) for p in ABLATE_KEYS for flag in ABLATE_FLAGS]


def phase_build() -> dict:
    """Build every kernel, one nvcc each, all started together: the six
    kernels, the fused kernels' draw-counting and phase-clock builds, and
    the ablated builds of K1 and K5 with their draw-counting builds."""
    from paxos_tpu_torch.kernels import build
    from paxos_tpu_torch.kernels.fused_tick import (
        BINDINGS,
        COUNT_DRAWS,
        PHASE_CLOCKS,
        PHASES,
        ablate_defines,
    )

    names = [b.kernel for b in BINDINGS.values()] + ["int32_ceiling"]
    ablated = [(BINDINGS[p].kernel, ablate_defines(a)) for p, a in ablated_builds()]
    builds = (
        [(name, ()) for name in names]
        + [(b.kernel, COUNT_DRAWS) for b in BINDINGS.values()]
        + [(BINDINGS[p].kernel, PHASE_CLOCKS) for p in PHASES]
        + ablated + [(kernel, defines + COUNT_DRAWS) for kernel, defines in ablated]
    )
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda nd: build.build(*nd), builds))
    secs = time.perf_counter() - t0
    log(f"build: {len(names)} kernels, {len(BINDINGS)} draw-counting, {len(PHASES)} "
        f"phase-clock and {len(ablated)} ablated builds (each with its draw-counting build) in "
        f"{secs:.1f} s (nvcc, sm_90a, in parallel)")
    keys = ("entry function", "registers", "spill")
    ptxas = {}
    for name, defines in [(name, ()) for name in names] + ablated:
        report = build.ptxas_report(name, defines)
        tag = name + "".join(f" -D{d}" for d in defines)
        ptxas[tag] = [ln.strip() for ln in report.splitlines() if any(k in ln for k in keys)]
        for ln in ptxas[tag]:
            log(f"ptxas {tag}: {ln}")
    return {"build_s": secs, "ptxas": ptxas}


def phase_geometry() -> dict:
    """The launch geometry of the kernels, each of which stages a column
    per lane in shared memory (K5, K4, K1, K2, K3), at every
    instantiation: lanes a CUDA block, staged rows a lane, shared bytes a
    block, and the blocks one SM holds (the card's occupancy query); K1 to
    K4 must hold the blocks their registers are capped for."""
    from paxos_tpu_torch.kernels.fused_tick import (
        FR_STAGING,
        MP_STAGING,
        SP_STAGING,
        blocks_per_sm,
    )

    tables = {"multipaxos": MP_STAGING, "synchpaxos": SP_STAGING, **FR_STAGING}
    out = {protocol: [] for protocol in tables}
    for protocol, table in tables.items():
        for shape, st in table.items():
            blocks = blocks_per_sm(protocol, shape)
            row = {
                "shape": list(shape), "threads": st.threads, "staged_rows": st.rows,
                "smem_bytes": st.smem_bytes, "blocks_per_sm": blocks,
                "warps_per_sm": blocks * st.threads // 32,
            }
            if protocol == "multipaxos":
                row["stage_prom"] = st.stage_prom
                what = f"PROMISE payloads {'staged' if st.stage_prom else 'in global memory'}"
            else:
                row["min_blocks"] = st.min_blocks
                what = f"registers capped for {st.min_blocks} blocks"
            out[protocol].append(row)
            log(f"geometry {protocol} {shape}: {st.threads} lanes a block, {st.rows} staged rows "
                f"a lane ({what}), {st.smem_bytes} B shared a block, {blocks} blocks an SM "
                f"({blocks * st.threads // 32} warps)")
            if blocks < (1 if protocol == "multipaxos" else st.min_blocks):
                raise AssertionError(f"{protocol} {shape} at {st}: {blocks} blocks an SM")
    return out


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
    # The observer planes draw nothing but the client arrivals: with every
    # plane on, K1's, K2's and K3's observed instantiations leave the
    # protocol state as the golden has it.
    for protocol, want in GOLDENS.items():
        cfg = with_planes(main_config(protocol, 256, 7))
        state = FUSED_WRAPPERS[protocol](
            path_state(cfg), cfg.seed, init_plan(cfg, "cuda"), cfg.fault, 32, block=256
        )
        got = digest(without_planes(state).leaves())
        log(f"golden: {protocol} with every observer plane on, the state but the planes: "
            f"digest {got} (want {want})")
        if got != want:
            raise AssertionError(f"observed {protocol} golden digest {got} != {want}")
    # K5 and K4 on chip_smoke's numpy plans, planes off and (their observed
    # instantiations) every plane on: the state but the planes is the
    # planes-off golden, the whole state the observed one.
    for path, protocol, want, want_obs in (
        ("config3", "multipaxos", MP_GOLDEN, MP_OBS_GOLDEN),
        ("synchpaxos", "synchpaxos", SP_GOLDEN, SP_OBS_GOLDEN),
    ):
        cfg = main_config(path, 256, 7)
        state = FUSED_WRAPPERS[protocol](
            init_state(cfg, "cuda"), cfg.seed, config_plan(cfg, 7), cfg.fault, 32, block=256
        )
        got = digest(state.leaves())
        log(f"golden: {protocol} {path} 256 lanes seed 7 32 ticks digest {got} "
            f"(want {want})")
        if got != want:
            raise AssertionError(f"{protocol} golden digest {got} != {want}")
        cfg = with_planes(cfg)
        state = FUSED_WRAPPERS[protocol](
            path_state(cfg), cfg.seed, config_plan(cfg, 7), cfg.fault, 32, block=256
        )
        got, got_obs = digest(without_planes(state).leaves()), digest(state.leaves())
        log(f"golden: {protocol} {path} with every observer plane on: the state but the planes "
            f"{got} (want {want}), the whole state {got_obs} (want {want_obs})")
        if got != want or got_obs != want_obs:
            raise AssertionError(f"observed {protocol} golden digests {got} {got_obs}")


def main_plan(cfg, device="cuda"):
    """A main path's plan: :func:`config_plan` at the config's seed where
    the config has a knob whose plan is sampled (crashes, equivocators,
    link delays, partitions, one-way cuts, flaky links, timer skew), else
    None (``run`` builds the fault-free plan itself, inside the timed
    window)."""
    from paxos_tpu_torch.harness.run import sampled_plan_knobs

    if sampled_plan_knobs(cfg.fault):
        return config_plan(cfg, cfg.seed, device)
    return None


def near_limit_state(cfg, rnd: int, device="cuda"):
    """``cfg``'s initial state with every proposer in phase 1 at ballot
    round ``rnd`` and its PREPARE (REQVOTE) broadcast in flight."""
    st = path_state(cfg, device)
    pid = torch.arange(cfg.n_prop, dtype=torch.int32, device=device)[:, None]
    st.proposer.bal.copy_((rnd * 8 + pid + 1).expand_as(st.proposer.bal))
    st.proposer.phase.zero_()
    st.requests.bal[0] = st.proposer.bal[:, None, :]
    st.requests.present[0] = True
    return st


def near_limit_state_mp(cfg, rnd: int, device="cuda"):
    """``cfg``'s initial Multi-Paxos state with every proposer at ballot
    round ``rnd`` and a lease timer past every election threshold, so
    elections start at once and push ballots over the report limit."""
    st = path_state(cfg, device)
    pid = torch.arange(cfg.n_prop, dtype=torch.int32, device=device)[:, None]
    st.proposer.bal.copy_((rnd * 8 + pid + 1).expand_as(st.proposer.bal))
    st.proposer.lease_timer.fill_(cfg.fault.lease_len + 3 * cfg.n_prop + cfg.fault.backoff_max)
    return st


def plain_chunk(cfg, state, plan, n_ticks, block, blk0=0, clamp_per_tick=False, ablate=frozenset()):
    """The plain version of ``cfg.protocol``'s kernel (without the
    components ``ablate`` names)."""
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS, fused_fns, reference_chunk

    apply_fn, mask_fn, _ = fused_fns(cfg.protocol, frozenset(ablate))
    return reference_chunk(
        state, cfg.seed, plan, cfg.fault, n_ticks, blk_id=blk0, block=block,
        clamp_per_tick=clamp_per_tick, apply_fn=apply_fn, mask_fn=mask_fn,
        ballot_limit=BINDINGS[cfg.protocol].ballot_limit,
    )


def compare(
    name, cfg, plan, n_ticks, block=None, reps=0, init=None, ceiling=None, census=None,
    compact=False, chunks=1, from_init=False, first_chunk=False, ablate=frozenset(), **kw,
) -> dict:
    """Kernel vs plain on the card from the same initial state over
    ``chunks`` chunks of ``n_ticks``, each chunk checked; ``kw`` are the
    wrapper's ``blk0`` and ``clamp_per_tick``; ``block`` defaults to the
    protocol's, ``plan`` (None) to the fault-free one; ``ablate``: the
    kernel's ablated build against the plain tick without the same
    components.  ``compact``: the decided-prefix
    compaction follows every chunk, as on a long log.  Times are of the
    chunks alone.  With ``reps``, also the
    kernel's steady-state time over ``reps``
    further chunks (``from_init``: the compared first chunk again, ``reps``
    times from copies of the initial state, where the lanes still send;
    ``first_chunk``: both, the first chunk's under ``first_chunk``)
    and their bound: the larger of the bytes those chunks need (but for a
    lane K1 settles, :func:`settled_lanes`, each lane's state read and
    written once) and the draws they make at ``DRAW_OPS`` each over the
    published peak (over the measured
    ``ceiling`` beside it), which the timed chunks must not beat; the
    operations of census ``census``, with the draws and slot-array
    (delay-stamp) touches counted, beside it; for a kernel with a
    phase-clock build (K1 to K5), where a lane's cycles go over those
    chunks (:func:`phase_split`)."""
    from paxos_tpu_torch.core.state import state_bytes_per_lane
    from paxos_tpu_torch.harness.run import init_plan
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS, FUSED_WRAPPERS, PHASES, draw_census
    from paxos_tpu_torch.protocols.multipaxos import compact_mp_body

    def after(st):
        return compact_mp_body(st)[0] if compact else st

    ablate = frozenset(ablate)
    wrapper = FUSED_WRAPPERS[cfg.protocol]
    if ablate:
        wrapper = functools.partial(wrapper, ablate=ablate)
    block = BINDINGS[cfg.protocol].block if block is None else block
    plan = init_plan(cfg, "cuda") if plan is None else plan
    init = path_state(cfg, "cuda") if init is None else init
    from_start = from_init or first_chunk
    start = init.clone() if from_start else None
    # With the observer planes on, the planes-off kernel from the same state
    # must give the same protocol state (the planes move no schedule).
    bare = without_planes(init.clone()) if init.planes else None
    plain, kern, plain_ms, kern_ms, err = init, init.clone(), 0.0, 0.0, 0
    first_state, first_plain_ms, first_kern_ms = None, 0.0, 0.0
    for c in range(chunks):
        plain, t_plain = timed(
            lambda: plain_chunk(cfg, plain, plan, n_ticks, block, ablate=ablate, **kw)
        )
        torch.cuda.synchronize()
        kern, t_kern = timed(
            lambda: wrapper(kern, cfg.seed, plan, cfg.fault, n_ticks, block=block, **kw)
        )
        if bare is not None:
            bare = after(wrapper(bare, cfg.seed, plan, cfg.fault, n_ticks, block=block, **kw))
        err = max(err, max_abs_err(kern.leaves(), plain.leaves()))
        if c == 0 and from_start:  # what the chunks timed from the initial state must end in
            first_state, first_plain_ms, first_kern_ms = kern.clone(), t_plain, t_kern
        plain, kern = after(plain), after(kern)
        plain_ms, kern_ms = plain_ms + t_plain, kern_ms + t_kern
    if bare is not None and max_abs_err(without_planes(kern).leaves(), bare.leaves()) != 0:
        raise AssertionError(f"{name}: the observer planes moved the schedule")
    err = max(err, max_abs_err(kern.leaves(), plain.leaves()))
    compacted = (
        f", compacted after each (mean base {plain.base.float().mean().item():.2f} of "
        f"{cfg.fault.log_total})" if compact else ""
    )
    log(f"{name}: {cfg.n_inst} lanes x {chunks} x {n_ticks} ticks{compacted}, "
        f"kernel vs plain max_abs_err {err}")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")

    def measure(from_init: bool, label: str, plain_ms: float, kern_ms: float) -> dict:
        """The timed chunks' time and bound (``from_init``: the compared
        first chunk from copies of the initial state, else the steady
        state, further chunks continuing from the compared state)."""
        end = first_state if from_init else kern
        out = {"max_abs_err": err, "plain_ms": plain_ms, "first_ms": kern_ms}
        # Where a lane's cycles go over the timed chunks: the phase-clock
        # build from a copy of their first state, launch for launch (a long
        # log compacted after each), which must end where they end.
        if cfg.protocol in PHASES and not ablate:
            out["phase_split"], clocked = phase_split(
                label, cfg, (start if from_init else end).clone(), plan, n_ticks,
                1 if from_init else reps, block, after,
            )
        # The draws and touches of the timed chunks: the measuring build
        # over the same ticks from a copy of the compared state (of the
        # initial state, from_init), which must end where the timed chunks
        # end (where the compared chunk ended).
        if from_init:
            counted, timed_ticks = start.clone(), n_ticks
            draws, touches = draw_census(
                cfg.protocol, counted, cfg.seed, plan, cfg.fault, n_ticks, block=block,
                ablate=ablate,
            )
        else:
            counted, draws, touches, timed_ticks = end.clone(), 0, 0, reps * n_ticks
            for _ in range(reps if compact else 1):
                d, t = draw_census(
                    cfg.protocol, counted, cfg.seed, plan, cfg.fault,
                    (1 if compact else reps) * n_ticks, block=block, ablate=ablate,
                )
                draws, touches, counted = draws + d, touches + t, after(counted)
        # The timed chunks: the compared chunk again from copies of its
        # initial state (from_init), or the steady state, further chunks
        # continuing from the compared state; on a long log each chunk is
        # timed alone and compacted after.
        if from_init:
            chunk_ms = []
            for _ in range(reps):
                st = start.clone()
                chunk_ms.append(
                    timed(lambda: wrapper(st, cfg.seed, plan, cfg.fault, n_ticks, block=block))[1]
                )
            out["ms"] = sum(chunk_ms) / reps
        elif compact:
            chunk_ms, compact_ms = [], []
            for _ in range(reps):
                _, t = timed(lambda: wrapper(end, cfg.seed, plan, cfg.fault, n_ticks, block=block))
                end, c = timed(lambda: after(end))
                chunk_ms.append(t)
                compact_ms.append(c)
            out["ms"], out["compact_ms"] = sum(chunk_ms) / reps, sum(compact_ms) / reps
        else:
            _, out["ms"] = timed(
                lambda: wrapper(end, cfg.seed, plan, cfg.fault, n_ticks, block=block), reps
            )
        if max_abs_err(counted.leaves(), end.leaves()) != 0:
            raise AssertionError(f"{label}: the draw-counting build took another path")
        if cfg.protocol in PHASES and not ablate and max_abs_err(clocked.leaves(), end.leaves()) != 0:
            raise AssertionError(f"{label}: the phase-clock build took another path")
        read = ["crash_start", "crash_end", "equivocate"]
        if cfg.protocol == "multipaxos":
            read += ["pcrash_start", "pcrash_end"]
        if plan.link_delay is not None:  # the stamped instantiations read the caps
            read += ["link_delay"]
        read += gray_plan_reads(cfg.fault)  # the arms read the partition and gray leaves
        plan_bytes = sum(getattr(plan, n).element_size() * getattr(plan, n).numel() for n in read)
        # Each lane's state read and written once, its plan read once; but a
        # lane K1 settles at the timed chunks' entry (counted on their last
        # state, where the most are) needs only settled_lane_bytes read, and
        # its observer planes read and written once.
        settled = 0
        if cfg.protocol == "paxos":
            settled = int(settled_lanes(start if from_init else end).sum())
        lane_bytes = 2 * state_bytes_per_lane(init) + plan_bytes / cfg.n_inst
        settled_bytes = settled_lane_bytes(init) + 2 * obs_lane_bytes(init)
        n_bytes = (cfg.n_inst - settled) * lane_bytes + settled * settled_bytes
        lane_ticks = cfg.n_inst * timed_ticks
        draws_per_lane_tick, touches_per_lane_tick = draws / lane_ticks, touches / lane_ticks
        ops_per_lane_tick = draws_per_lane_tick * DRAW_OPS
        census_per_lane_tick = tick_ops_per_lane(census, draws_per_lane_tick, touches_per_lane_tick)
        lane_chunk = cfg.n_inst * n_ticks
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_per_lane_tick * lane_chunk / INT32_OPS_PER_S * 1e3
        measured_ops_ms = ops_per_lane_tick * lane_chunk / ceiling * 1e3
        out.update(
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            bound_ms_measured_rate=max(bytes_ms, measured_ops_ms),
            bytes_ms=bytes_ms, ops_ms=ops_ms, ops_per_lane_tick=ops_per_lane_tick,
            census_ms=census_per_lane_tick * lane_chunk / INT32_OPS_PER_S * 1e3,
            census_ops_per_lane_tick=census_per_lane_tick,
            ops_per_lane_tick_census=tick_ops_per_lane(census),
            draws_per_lane_tick=draws_per_lane_tick,
            slot_touches_per_lane_tick=touches_per_lane_tick,
            state_bytes_per_lane=state_bytes_per_lane(init), settled_lanes=settled,
        )
        log(
            f"{label}: kernel {out['ms']:.3f} ms/chunk (first {kern_ms:.3f}), plain "
            f"{plain_ms:.1f} ms, bound {out['bound_ms']:.3f} ms ({out['bound_by']}; bytes "
            f"{bytes_ms:.3f} ms with {settled} lanes settled, draw ops {ops_ms:.3f} ms at "
            f"the published peak, {measured_ops_ms:.3f} ms at the measured rate); "
            f"{draws_per_lane_tick:.3f} draws "
            f"per lane-tick of {MASK_CENSUS[census][1]:g} mask elements, "
            f"{touches_per_lane_tick:.3f} slot-array and delay-stamp touches per lane-tick; "
            f"census {out['census_ms']:.3f} ms at the published peak, no floor "
            f"({census_per_lane_tick:.1f} ops per lane-tick, "
            f"{out['ops_per_lane_tick_census']:.1f} with every mask drawn)"
            + (f"; compaction {out['compact_ms']:.3f} ms/chunk" if compact else "")
        )
        if out["ms"] < out["bound_ms"]:
            raise AssertionError(f"{label}: {out['ms']:.3f} ms beats its bound, which is no floor")
        return out

    if not reps:
        return {"max_abs_err": err, "plain_ms": plain_ms, "first_ms": kern_ms}
    if from_init:
        return measure(True, name, plain_ms, kern_ms)
    out = measure(False, name, plain_ms, kern_ms)
    if first_chunk:
        out["first_chunk"] = measure(True, f"{name}, first chunk", first_plain_ms, first_kern_ms)
    return out


def gray_plan_reads(fault) -> list:
    """The partition and gray-failure plan leaves the arms of K1 to K5
    read for ``fault``: the partition windows and sides where
    ``p_part`` > 0, and the optional fields its knobs put in the plan."""
    from paxos_tpu_torch.faults.injector import optional_fields

    reads = ["part_start", "part_end", "aside", "pside"] if fault.p_part > 0.0 else []
    return reads + [n for n in optional_fields(fault) if n != "link_delay"]


def settled_lanes(state) -> torch.Tensor:
    """(I,) bool: the Paxos lanes that K1 settles at a chunk's entry, every
    proposer done (with ``best_bal`` >= 0) and no message in flight.  A
    settled lane stays so, and a chunk changes none of its state but the
    learner's scalars; K1 loads no column word for it."""
    prop = state.proposer
    return (
        ((prop.phase == 2) & (prop.best_bal >= 0)).all(0)
        & ~state.requests.present.flatten(0, 2).any(0)
        & ~state.replies.present.flatten(0, 2).any(0)
    )


def resending_lanes(state) -> torch.Tensor:
    """(I,) bool: the Multi-Paxos lanes whose whole window is chosen and
    that still have a leader below the window's end, which re-sends its
    slot's ACCEPT every tick (a leader is demoted only while the log is not
    full)."""
    prop = state.proposer
    return state.learner.chosen.all(0) & ((prop.phase == 2) & (prop.commit_idx < state.log_len)).any(0)


def obs_lane_bytes(state) -> int:
    """Bytes of observer-plane state a lane carries (0 without planes)."""
    return sum(leaf.element_size() * (leaf.numel() // state.n_inst) for leaf in state.obs_leaves())


def settled_lane_bytes(state) -> int:
    """The bytes a chunk must read of a settled Paxos lane, and it need
    write none: the words that say it is settled (phases, best ballots,
    presence), those its invariant check reads (the acceptor leaves and the
    equivocation bits), and whether its learner has chosen."""
    p, a = state.n_prop, state.n_acc
    return 4 * 2 * p + 2 * (2 * p * a) + 4 * 3 * a + a + 1


def phase_split(name, cfg, state, plan, n_ticks, launches, block, after=lambda st: st) -> tuple:
    """Where a lane's cycles go: the kernel's phase-clock build over
    ``launches`` chunks of ``n_ticks`` from ``state``, each followed by
    ``after`` (a long log's compaction), as cycles a lane-tick (the column
    load and store spread over the chunk's ticks) and each phase's share
    of them; and the state the chunks end in."""
    from paxos_tpu_torch.kernels.fused_tick import phase_clocks

    total = {}
    for _ in range(launches):
        clocks = phase_clocks(cfg.protocol, state, cfg.seed, plan, cfg.fault, n_ticks, block=block)
        total = {k: total.get(k, 0) + v for k, v in clocks.items()}
        state = after(state)
    cycles = sum(total.values())
    out = {
        "cycles_per_lane_tick": cycles / (cfg.n_inst * n_ticks * launches),
        "share": {k: v / cycles for k, v in total.items()},
    }
    log(f"{name}: phase clocks {out['cycles_per_lane_tick']:.1f} cycles a lane-tick: "
        + ", ".join(f"{k} {v:.1%}" for k, v in out["share"].items()))
    return out, state


def phase_compare(ceiling: float) -> dict:
    """Every instantiation against the plain version; the full-width
    comparison of each main path's kernel on its config, timed, is
    returned per path."""
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import init_plan, init_state
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS
    from paxos_tpu_torch.protocols.paxos import GRAY_PROTOCOLS

    cfg1 = C.config1_no_faults(4096, 3)
    compare("paxos config1 (1,3,8)", cfg1, init_plan(cfg1, "cuda"), 64)
    cfg4 = C.config4_byzantine(4096, 5)
    compare("paxos config4 (2,5,8)", cfg4, fault_plan(4096, 5, 2, 0.25, 4), 300)
    compare(
        "paxos config4 (2,5,8) with crashes", cfg4,
        fault_plan(4096, 5, 2, 0.25, 4, p_crash=0.3), 300,
    )
    for protocol in ("fastpaxos", "raftcore"):
        small = dataclasses.replace(main_config(protocol, 4096, 11), n_acc=3)
        compare(
            f"{protocol} (2,3,8) with crashes and equivocators", small,
            fault_plan(4096, 3, 2, 0.25, 5, p_crash=0.3), 128,
        )
    # K4: config_delay_chaos's (2,5,8) with delay stamps in both regimes,
    # the planted bug, (2,5,8) without stamps (SynchPaxos with delay off),
    # and three acceptors with stamps.
    for seed, violate in ((5, False), (6, True)):
        cfgd = C.config_delay_chaos(4096, seed, violate_delta=violate)
        compare(f"synchpaxos (2,5,8) stamped, violate_delta={violate}", cfgd,
                config_plan(cfgd, seed), 200)
    cfgu = sp_checker_config(4096)
    compare("synchpaxos (2,5,8) sp_unsafe_fast", cfgu, config_plan(cfgu, 7), 200)
    cfgo = sp_delay_off_config(4096, 8)
    compare("synchpaxos (2,5,8) delay off, unstamped", cfgo, init_plan(cfgo, "cuda"), 200)
    cfg3 = dataclasses.replace(C.config_delay_chaos(4096, 9), n_acc=3)
    compare("synchpaxos (2,3,8) stamped", cfg3, config_plan(cfg3, 9), 200)
    # The knobs no main path sets: duplicated requests and replies, uneven
    # quorums, and a ballot stride with a longer backoff.
    for name, cfgk in sp_knob_configs(4096, 10).items():
        compare(f"synchpaxos (2,5,8) stamped, {name}", cfgk, config_plan(cfgk, 10), 200)
    for protocol in ("paxos", "fastpaxos", "raftcore"):
        for name, cfgk in fr_knob_configs(protocol, 4096, 10).items():
            compare(f"{protocol} (2,5,8) {name}", cfgk, init_plan(cfgk, "cuda"), 200)
    # The gray-failure and partition arms of K1 to K5: each knob alone and
    # the configs that set them, over two chunks.
    for protocol in GRAY_PROTOCOLS:
        for name, cfgk in gray_knob_configs(4096, 12, protocol).items():
            shape = ",".join(map(str, BINDINGS[protocol].kernel_shape(init_state(cfgk, "cpu"), cfgk.fault)))
            compare(f"{protocol} ({shape}) {name}", cfgk, config_plan(cfgk, 12), 96, chunks=2)
    # The bounded-delay channel of K1, K2, K3 and K5 (their stamped
    # instantiations), over two chunks.
    for protocol in ("paxos", "fastpaxos", "raftcore", "multipaxos"):
        for name, cfgk in delay_knob_configs(4096, 14, protocol).items():
            shape = ",".join(map(str, BINDINGS[protocol].kernel_shape(init_state(cfgk, "cpu"), cfgk.fault)))
            compare(f"{protocol} ({shape}) {name}", cfgk, config_plan(cfgk, cfgk.seed), 96, chunks=2)
    # K5's arms on the JAX package's own fused-kernel cases
    # (tests/test_gray.py): every gray knob with crash windows on config3 at
    # 64 lanes, seed 5, 24 ticks in one stream block, and flaky links at
    # zero rates (the uniform case through the per-link path), 128 lanes,
    # seed 9.
    every = main_config("config3", 64, 5)
    every = dataclasses.replace(every, fault=dataclasses.replace(every.fault, **GRAY_ALL))
    compare("multipaxos (2,5,8,4,1) test_gray every gray knob", every, config_plan(every, 5), 24,
            block=64)
    zero = main_config("config3", 128, 9)
    zero = dataclasses.replace(zero, fault=dataclasses.replace(
        zero.fault, p_drop=0.0, p_dup=0.0, p_flaky=0.5, flaky_drop=0.0, flaky_dup=0.0))
    compare("multipaxos (2,5,8,4,1) test_gray zero-rate flaky links", zero, config_plan(zero, 9),
            64, block=128)
    # The observed instantiations of K1 to K5 (every observer plane on) on
    # the configs that light every exposure class between them (drop, dup,
    # corrupt, partition, timeout, stale, delay), K2's, K3's and K5's also on
    # their cell (K5 takes each fault config on config3's cell), at 1<<16
    # lanes over two chunks; and from near-limit ballots under the per-tick
    # clamp with a block offset.
    for protocol in OBSERVER_ARMS:
        names = ("config_gray_chaos", "config_corrupt", "config_stale", "config_delay_chaos")
        cell = {"fastpaxos": "fastpaxos", "raftcore": "raftcore", "multipaxos": "config3"}.get(protocol)
        for name in names if cell is None else ("cell",) + names:
            if name == "cell":
                cfgo = with_planes(main_config(cell, 1 << 16, 16))
            elif protocol == "multipaxos":
                cfgo = with_planes(dataclasses.replace(
                    main_config("config3", 1 << 16, 16), fault=getattr(C, name)(1 << 16, 16).fault
                ))
            else:
                cfgo = with_planes(dataclasses.replace(getattr(C, name)(1 << 16, 16), protocol=protocol))
            shape = ",".join(map(str, BINDINGS[protocol].kernel_shape(path_state(cfgo, "cpu"), cfgo.fault)))
            compare(f"{protocol} ({shape}) observed, {name}", cfgo, config_plan(cfgo, 16), 64, chunks=2)
        # K5's and K4's stamped arms with the planes (K1's to K3's the card
        # tests hold): every gray knob with the delay.
        every = {
            "multipaxos": lambda: delay_knob_configs(1 << 16, 16, "multipaxos")["every gray knob, p_delay 0.4"],
            "synchpaxos": lambda: gray_knob_configs(1 << 16, 16, "synchpaxos")["every gray knob, stamped"],
        }.get(protocol)
        if every is not None:
            cfgo = with_planes(every())
            shape = ",".join(map(str, BINDINGS[protocol].kernel_shape(path_state(cfgo, "cpu"), cfgo.fault)))
            compare(f"{protocol} ({shape}) observed, every gray knob, stamped", cfgo,
                    config_plan(cfgo, 16), 64, chunks=2)
        if protocol == "multipaxos":
            cfgo = with_planes(main_config("config3", 4096, 13))
            plan, init = config_plan(cfgo, 13), near_limit_state_mp(cfgo, 254)
        else:
            cfgo = with_planes(main_config(protocol, 4096, 13))
            plan, init = main_plan(cfgo) or init_plan(cfgo, "cuda"), near_limit_state(cfgo, 4094)
        compare(
            f"{protocol} observed per-tick clamp, blk0=5", cfgo, plan, 96,
            init=init, blk0=5, clamp_per_tick=True,
        )
    # The per-tick ballot clamp (chunks over 6144 ticks) and a nonzero block
    # offset, which the main paths do not take, from near-limit ballots.
    for protocol in ("paxos", "fastpaxos", "raftcore", "synchpaxos"):
        cfgc = main_config(protocol, 4096, 13)
        compare(
            f"{protocol} per-tick clamp, blk0=5", cfgc,
            main_plan(cfgc) or init_plan(cfgc, "cuda"), 96,
            init=near_limit_state(cfgc, 4094), blk0=5, clamp_per_tick=True,
        )
    # K5: config3's (2,5,8,4), three acceptors with equivocators, the
    # long-log windows (2,5,4,4) and (2,5,16,4) compacted between chunks,
    # and near-limit ballots under the per-tick clamp (2047).
    cfg3 = main_config("config3", 4096, 5)
    compare("multipaxos config3 (2,5,8,4)", cfg3, config_plan(cfg3, 5), 300)
    eq3 = dataclasses.replace(cfg3, n_acc=3, fault=dataclasses.replace(cfg3.fault, p_equiv=0.3))
    compare("multipaxos (2,3,8,4) with equivocators", eq3, config_plan(eq3, 6), 200)
    for window, log_total in ((4, 64), (16, 256)):
        cfgl = C.config3_long(4096, 6, log_total=log_total, window=window)
        compare(
            f"multipaxos long log (2,5,{window},4)", cfgl, config_plan(cfgl, 6), 64,
            compact=True, chunks=6,
        )
    cfgc = main_config("config3", 4096, 13)
    compare(
        "multipaxos per-tick clamp, blk0=5", cfgc, config_plan(cfgc, 13), 96,
        init=near_limit_state_mp(cfgc, 254), blk0=5, clamp_per_tick=True,
    )
    # The knobs no main path sets (duplicated requests, uneven quorums, a
    # ballot stride with a shorter backoff and timeout), crash windows off.
    for name, cfgk in mp_knob_configs(4096, 10).items():
        compare(f"multipaxos (2,5,8,4) {name}", cfgk, init_plan(cfgk, "cuda"), 200)
    full = {}
    for path, mp in MAIN_PATHS.items():
        cfg = main_config(path, FULL_LANES, 7)
        # Also the first chunk, where the lanes still send (on a long log
        # every chunk does, so the steady state is that chunk already).
        full[path] = compare(
            f"{path} full width", cfg, main_plan(cfg), 64, reps=5, ceiling=ceiling,
            census=mp.census, compact=mp.compact, chunks=mp.compare_chunks,
            first_chunk=not mp.compact,
        )
    for path in MAIN_PATHS:
        full[path]["load_store_ms"] = time_load_store(path)
    # K4's busiest chunk: the first of the delta-violating regime, where the
    # fast path misses its window and lanes fall back to classic rounds.
    cfgv = C.config_delay_chaos(FULL_LANES, 7, violate_delta=True)
    full["synchpaxos"]["first_chunk_violate_delta"] = compare(
        "synchpaxos violate_delta full width, first chunk", cfgv, config_plan(cfgv, 7), 64,
        reps=5, ceiling=ceiling, census=MAIN_PATHS["synchpaxos"].census, from_init=True,
    )
    return full


def phase_ablation(ceiling: float) -> tuple:
    """Each ablated build of K1 and K5 (``ablated_builds``) against the
    plain tick without the same component, byte for byte, at
    ``ABLATION_LANES`` lanes of its path's config, seed 7, over two 64-tick
    chunks from stream block 5, then timed over 5 steady chunks with its
    bound (the draws of its own draw-counting build; the build without the
    PRNG draws none); and the ablation entry point's table
    (``paxos_tpu_torch.scripts.ablate_fused``) at full width for both
    kernels, the first chunk and the steady state, which must launch every
    ablated build (its launches, counted from 0 around the table, are
    returned beside its comparison)."""
    from paxos_tpu_torch.kernels.fused_tick import ABLATE_KEYS, FUSED_WRAPPERS
    from paxos_tpu_torch.scripts.ablate_fused import ablation_table

    out = {}
    for protocol, ablate in ablated_builds():
        path = ABLATION_PATHS[protocol]
        cfg = main_config(path, ABLATION_LANES, 7)
        (flag,) = ablate
        out[protocol, flag] = got = compare(
            f"{protocol} ablated no-{flag}", cfg, main_plan(cfg), 64, reps=5, ceiling=ceiling,
            census=MAIN_PATHS[path].census, chunks=2, ablate=ablate, blk0=5,
        )
        if flag == "prng" and got["draws_per_lane_tick"] != 0:
            raise AssertionError(f"{protocol} without the PRNG still draws: {got['draws_per_lane_tick']}")
    tables = {}
    reset_launches()
    for protocol in ABLATE_KEYS:
        name = "config2" if protocol == "paxos" else "config3"
        tables[protocol] = ablation_table(protocol, name, FULL_LANES, 256, 3, torch.device("cuda"))
    for protocol, ablate in ablated_builds():
        (flag,) = ablate
        launches = FUSED_WRAPPERS[protocol].ablated_launches.get(ablate, 0)
        if launches == 0:
            raise AssertionError(f"the ablation table never launched {protocol}'s build without {flag}")
        row = next(r for r in tables[protocol]["rows"] if r["variant"] == f"no-{flag}")
        out[protocol, flag].update(
            launches=launches, main_path_us_per_tick=row["us_per_tick"],
            main_path_first_us_per_tick=row["first_us_per_tick"],
        )
    for protocol, table in tables.items():
        for row in table["rows"]:
            log(f"ablation {protocol} {table['config']} {FULL_LANES} lanes x 256 ticks: "
                f"{row['variant']} {row['us_per_tick']:.3f} us/tick share {row['share']:.4f}; "
                f"first chunk {row['first_us_per_tick']:.3f} us/tick share "
                f"{row['first_share']:.4f}"
                + (f"; launches {out[protocol, row['variant'][3:]]['launches']}"
                   if row["variant"] != "full" else ""))
    return out, tables


def time_load_store(path: str, reps: int = 5) -> float:
    """A kernel's column load and store alone, ms: a launch of 0 ticks on
    main path ``path``'s config at full width from the state after one
    chunk reads and writes every lane's state once (K1 to K4: what they
    store; K1 no column of a lane it settles) and runs no tick, so the
    state must come back byte for byte.  The
    launches go around the wrapper and so are not counted."""
    from paxos_tpu_torch.harness.run import init_plan
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS, _launch

    cfg = main_config(path, FULL_LANES, 7)
    protocol = MAIN_PATHS[path].protocol
    block, plan = BINDINGS[protocol].block, main_plan(cfg) or init_plan(cfg, "cuda")
    state = path_state(cfg, "cuda")
    _launch(protocol, state, cfg.seed, plan, cfg.fault, MAIN_CHUNK, block, 0, False)
    state.tick.add_(MAIN_CHUNK)
    before = state.clone()

    def load_store():
        _launch(protocol, state, cfg.seed, plan, cfg.fault, 0, block, 0, False)

    load_store()  # untimed: the first launch loads the kernel
    _, ms = timed(load_store, reps)
    if max_abs_err(state.leaves(), before.leaves()) != 0:
        raise AssertionError(f"the {path} kernel's 0-tick launch changed the state")
    log(f"{path} column load and store alone (0 ticks): {ms:.3f} ms a launch "
        f"(mean of {reps}), state unchanged")
    return ms


def check_evictions(path: str, report: dict, state) -> dict:
    """The main path's evictions against the pins: total, the two
    lowest-numbered evicting stream blocks, their lanes and digests."""
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS

    block = BINDINGS[MAIN_PATHS[path].protocol].block
    total, pinned = EVICTION_PINS[path]
    state = without_planes(state)  # the pins hold the protocol state
    lanes = torch.nonzero(state.learner.evictions).flatten().tolist()
    blocks = sorted({lane // block for lane in lanes})[:2]
    found = {
        blk: (
            [lane - blk * block for lane in lanes if lane // block == blk],
            digest(block_leaves(state, blk, block)),
        )
        for blk in blocks
    }
    log(
        f"{path} main path: evictions {report['evictions']} on {len(lanes)} lanes in "
        f"{len({lane // block for lane in lanes})} stream blocks; lowest blocks {found}"
    )
    if report["evictions"] != total or found != pinned:
        raise AssertionError(
            f"{path} evictions {report['evictions']} {found}, pinned {total} {pinned}"
        )
    if path in ("paxos", "observed-paxos") and lanes != MAIN_EVICTION_LANES:
        raise AssertionError(f"evictions on lanes {lanes}, recorded {MAIN_EVICTION_LANES}")
    out = {str(blk): d for blk, (_, d) in found.items()}
    if path in BLOCK0_DIGESTS:
        got = digest(block_leaves(state, 0, block))
        log(f"{path} main path: stream block 0 digest {got} (want {BLOCK0_DIGESTS[path]})")
        if got != BLOCK0_DIGESTS[path]:
            raise AssertionError(f"{path} stream block 0 digest {got} != {BLOCK0_DIGESTS[path]}")
        out["0"] = got
    return out


def run_main_path(path: str, plan, **kw):
    """One campaign of main path ``path`` through ``run`` on ``plan``."""
    from paxos_tpu_torch.harness.run import run

    cfg = main_config(path)
    return run(
        cfg, engine="fused", total_ticks=MAIN_PATHS[path].ticks, chunk=MAIN_CHUNK,
        pipeline_depth=MAIN_DEPTH, plan=plan, liveness=MAIN_PATHS[path].liveness,
        wload_plan=wload_plan(cfg, cfg.seed), **kw,
    )


def phase_main_path(path: str) -> dict:
    protocol, ticks = MAIN_PATHS[path].protocol, MAIN_PATHS[path].ticks
    cfg = main_config(path)
    plan = main_plan(cfg)
    walls, launches, report, state = [], {}, None, None
    for _ in range(MAIN_PATH_REPEATS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rep_report, state = run_main_path(path, plan, return_state=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_launches()
        if report is not None and rep_report != report:
            raise AssertionError(f"{path} main path not deterministic: {rep_report} != {report}")
        report = rep_report
    wall = sorted(walls)[len(walls) // 2]
    log(f"{path} main path report: {json.dumps(report)}")
    rate = cfg.n_inst * ticks / wall
    log(
        f"{path} main path: median {wall:.4f} s wall of {[round(w, 4) for w in walls]}, "
        f"{rate:.4g} quorum-rounds/s, launches {launches}"
    )
    if report["ticks"] != ticks or not 0.0 <= report["chosen_frac"] <= 1.0:
        raise AssertionError(f"malformed report {report}")
    if report["violations"] != 0 or report["proposer_disagree"] != 0:
        raise AssertionError(f"{path} main path must be safe: {report}")
    if launches[protocol] == 0:
        raise AssertionError(f"the {path} main path never launched its fused kernel")
    if sum(launches.values()) != launches[protocol]:
        raise AssertionError(f"the {path} main path launched other kernels: {launches}")
    digests = check_evictions(path, report, state)
    out = {"launches": launches[protocol], "all_launches": launches, "wall_s": wall,
           "walls_s": walls, "rounds_per_s": rate, "report": report,
           "eviction_block_digests": digests}
    if protocol == "multipaxos":
        out["resending_lanes"] = int(resending_lanes(state).sum())
        log(f"{path} main path: {out['resending_lanes']} lanes with every slot chosen still have "
            "a leader re-sending its slot's ACCEPT")
    if MAIN_PATHS[path].liveness:
        out["liveness"] = {k: report[k] for k in LIVENESS_KEYS}
        log(f"{path} main path liveness: {json.dumps(out['liveness'])}")
        if report["stuck_lanes"] != report["chosen_tick_hist"][-1]:
            raise AssertionError(f"{path}: stuck lanes outside the histogram's last bin")
    if MAIN_PATHS[path].planes:
        out["planes"] = {k: report[k] for k in PLANE_BLOCKS}
        for k in PLANE_BLOCKS:
            log(f"{path} main path {k}: {json.dumps(report[k])}")
        check_plane_report(path, report, cfg, state)
    if MAIN_PATHS[path].fast_path:
        from paxos_tpu_torch.protocols.synchpaxos import fast_path_rate

        out["fast_path_rate"] = fast_path_rate(state)
        log(f"{path} main path: fast-path rate {out['fast_path_rate']}")
    return out


def check_plane_report(path: str, report: dict, cfg, state) -> None:
    """The observer blocks of a campaign with every plane on must hold
    together: every lane (every Multi-Paxos slot) decided once
    (telemetry's decides and latency histogram against the learner's
    chosen count, on a long log with the slots compacted out of the
    window), the drops counted (exposure's effective drops are
    telemetry's), the coverage sketch filled, and no agreement violation
    seen (no zero quorum slack)."""
    n, ticks = cfg.n_inst, report["ticks"]
    tel, cov, exp, mar, slo = (report[k] for k in PLANE_BLOCKS)
    decided = int(state.learner.chosen.sum())
    if getattr(state, "base", None) is not None:  # a long log's compacted, decided prefix
        decided += int(state.base.sum())
    problems = []
    if tel["counters"]["decide"] != decided or sum(tel["hist"]) != decided:
        problems.append(f"decides {tel['counters']['decide']}, hist {sum(tel['hist'])}, chosen {decided}")
    if exp["classes"]["drop"]["effective"] != tel["counters"]["drop"]:
        problems.append("exposure's effective drops are not telemetry's drops")
    edges = 4 * cfg.n_prop * cfg.n_acc * ticks * n  # drop decisions drawn on every send edge
    if not 0 < exp["classes"]["drop"]["injected"] < edges:
        problems.append(f"drop decisions {exp['classes']['drop']['injected']} of {edges}")
    if not 0 < cov["bits_set"] <= cov["bits_total"] or cov["new_bits"] < cov["bits_set"]:
        problems.append(f"coverage {cov}")
    if mar["zero_slack_lanes"] != 0 or slo["offered"] != slo["done"] + slo["shed"] + slo["queue_depth"]:
        problems.append(f"margin {mar} / slo totals {slo['offered']} {slo['done']} {slo['shed']}")
    if problems:
        raise AssertionError(f"{path} plane blocks disagree: {problems}")


def phase_main_path_profile(path: str) -> dict:
    """The main path once more under torch.profiler: the fused kernel's
    share of device time and the device's idle share of the wall time
    (the profiler's own host cost inflates the wall a little)."""
    from torch.profiler import ProfilerActivity, profile

    protocol = MAIN_PATHS[path].protocol
    plan = main_plan(main_config(path))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_main_path(path, plan)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only: a PyTorch operator's own entry also carries
    # the device time of the kernels it launched, which would count twice.
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    kernel_name = f"fused_{protocol}_kernel"
    kernel_us = sum(e.self_device_time_total for e in events if kernel_name in e.key)
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6, "kernel_s": kernel_us / 1e6}
    if busy_us == 0:
        log(f"{path} profile: the profiler recorded no device time (not measured)")
        return out
    out["idle_share"] = 1.0 - busy_us / wall_us
    log(
        f"{path} profile: wall {out['wall_s']:.3f} s, device busy {out['device_busy_s']:.3f} s "
        f"(fused kernel {out['kernel_s']:.3f} s), device idle share {out['idle_share']:.4f}"
    )
    return out


def phase_checker() -> dict:
    """Bug-injection configs must light up the safety checker."""
    from paxos_tpu_torch.harness import config as C
    from paxos_tpu_torch.harness.run import init_plan, init_state, run

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
    cfg = mp_checker_config()
    mp = "multipaxos config3 p_equiv=0.4"
    out[mp] = run(cfg, total_ticks=300, plan=config_plan(cfg, cfg.seed))["violations"]
    for name, violations in out.items():
        log(f"checker: {name} violations {violations}")
        if violations <= 0:
            raise AssertionError(f"{name} must light up the safety checker")
    if out[mp] != MP_CHECKER_VIOLATIONS:
        raise AssertionError(f"{mp}: {out[mp]} violations, the JAX package gives {MP_CHECKER_VIOLATIONS}")
    # SynchPaxos' planted bug: the learner plane stays blind, the
    # cross-proposer check must fire.
    cfg = sp_checker_config()
    sp = "synchpaxos sp_unsafe_fast violate_delta p_drop=0.4 proposer_disagree"
    report = run(cfg, total_ticks=SP_CHECKER_TICKS, plan=config_plan(cfg, cfg.seed))
    out[sp] = report["proposer_disagree"]
    log(f"checker: {sp} {out[sp]} (violations {report['violations']})")
    if out[sp] != SP_CHECKER_DISAGREE:
        raise AssertionError(f"{sp}: {out[sp]}, the JAX package gives {SP_CHECKER_DISAGREE}")
    # Paxos' bug injections on K1's arms (config_flex on its default
    # instantiation; sizes in paxos_checker_cases).
    for name, cfg, ticks in paxos_checker_cases():
        report = run(cfg, total_ticks=ticks, plan=main_plan(cfg))
        out[name] = report["violations"]
        log(f"checker: {name} violations {out[name]}")
        if out[name] <= 0:
            raise AssertionError(f"{name} must light up the safety checker")
    # Fast Paxos' and Raft-core's bug injections on K2's and K3's arms (and
    # Paxos' stale case of the JAX package's summed pin): the kernel through
    # run, the plain tick on the card and the JAX package must agree.
    counts = {}
    for key, want in FR_CHECKER_VIOLATIONS.items():
        cfg, ticks = fr_checker_config(*key[:4]), key[4]
        plan = main_plan(cfg) or init_plan(cfg, "cuda")
        counts[key] = run(cfg, total_ticks=ticks, plan=plan)["violations"]
        plain = plain_chunk(cfg, init_state(cfg, "cuda"), plan, ticks, 1024)
        plain_viol = int(plain.learner.violations.sum())
        label = "{1} {0}({2}, {3}) {4} ticks".format(*key)
        out[label] = counts[key]
        log(f"checker: {label} violations {counts[key]} (plain tick {plain_viol}, JAX package {want})")
        if counts[key] != plain_viol or counts[key] != want:
            raise AssertionError(f"{label}: kernel {counts[key]}, plain {plain_viol}, the JAX package gives {want}")
    # The same on config3's cell, K5's arms against its plain tick (stream
    # blocks of 256 lanes) and the JAX package.
    for key, want in MP_GRAY_CHECKER_VIOLATIONS.items():
        cfg, ticks = mp_gray_checker_config(*key[:3]), key[3]
        plan = main_plan(cfg) or init_plan(cfg, "cuda")
        got = run(cfg, total_ticks=ticks, plan=plan)["violations"]
        plain = plain_chunk(cfg, init_state(cfg, "cuda"), plan, ticks, 256)
        plain_viol = int(plain.learner.violations.sum())
        label = "multipaxos {0}({1}, {2}) {3} ticks".format(*key)
        out[label] = got
        log(f"checker: {label} violations {got} (plain tick {plain_viol}, JAX package {want})")
        if got != plain_viol or got != want:
            raise AssertionError(f"{label}: kernel {got}, plain {plain_viol}, the JAX package gives {want}")
    stale = sum(v for (name, protocol, *_), v in counts.items()
                if name == "config_stale" and protocol in ("paxos", "fastpaxos"))
    out["config_stale(4096, 3) 192 ticks, Paxos plus Fast Paxos"] = stale
    log(f"checker: config_stale(4096, 3) over 192 ticks, Paxos plus Fast Paxos: {stale} violations "
        f"(the JAX package's sum {STALE_SUM})")
    if stale != STALE_SUM or stale <= 0:
        raise AssertionError(f"stale sum {stale}, the JAX package gives {STALE_SUM}")
    return out


def fr_checker_config(name: str, protocol: str, n_inst: int, seed: int):
    """Bug-injection config ``name`` of ``harness/config.py`` on
    ``protocol``'s tick (``FR_CHECKER_VIOLATIONS``)."""
    from paxos_tpu_torch.harness import config as C

    return dataclasses.replace(getattr(C, name)(n_inst, seed), protocol=protocol)


def paxos_checker_cases() -> list:
    """(name, config, ticks) of Paxos' bug injections that the checker must
    catch, each on its numpy plan: payload corruption at 1024 lanes over
    256 ticks and the unsafe Flexible Paxos quorums 2/2 at 8192 lanes over
    256 ticks (the JAX package's pin sizes), and stale-snapshot recovery at
    65536 lanes over 256 ticks: on Paxos alone it breaks agreement on a
    few lanes in ten thousand (none at the JAX package's 4096-lane pin,
    which sums Paxos and Fast Paxos)."""
    from paxos_tpu_torch.harness import config as C

    return [
        ("paxos config_corrupt", C.config_corrupt(1024, 0), 256),
        ("paxos config_stale", C.config_stale(65536, 0), 256),
        ("paxos config_flex(2,2)", C.config_flex(2, 2, 8192, 11), 256),
    ]


def sp_delay_off_config(n_inst: int, seed: int):
    """SynchPaxos without delay (its state carries no stamps): loss, idling
    and a short timeout."""
    from paxos_tpu_torch.faults.injector import FaultConfig
    from paxos_tpu_torch.harness.config import SimConfig

    return SimConfig(
        n_inst=n_inst, n_prop=2, n_acc=5, seed=seed, protocol="synchpaxos",
        fault=FaultConfig(p_drop=0.25, p_idle=0.1, timeout=6, delta=3),
    )


def sp_knob_configs(n_inst: int, seed: int) -> dict:
    """config_delay_chaos with each knob its main path leaves at its
    default: p_dup 0.2, q1/q2 = 2/4, ballot_stride 3 with backoff_max 3."""
    from paxos_tpu_torch.harness import config as C

    cfg = C.config_delay_chaos(n_inst, seed)
    knobs = {
        "p_dup 0.2": dict(p_dup=0.2),
        "q1/q2 2/4": dict(q1=2, q2=4),
        "ballot_stride 3, backoff_max 3": dict(ballot_stride=3, backoff_max=3),
    }
    return {
        name: dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, **kv))
        for name, kv in knobs.items()
    }


def fr_knob_configs(protocol: str, n_inst: int, seed: int) -> dict:
    """config2's Paxos cell or config5's Fast Paxos or Raft-core cell with
    each knob its main path leaves at its default: p_dup 0.2, ballot_stride
    3 with backoff_max 3 (Paxos also with timeout 5), for Paxos q1/q2 =
    2/4 and 4/2, and for Fast Paxos q1/q2/q_fast = 4/2/4 (a safe triple of
    ``config_ffp``); Raft-core's quorums are majorities, so it takes no
    q1/q2."""
    cfg = main_config(protocol, n_inst, seed)
    knobs = {"p_dup 0.2": dict(p_dup=0.2)}
    if protocol == "paxos":
        knobs["ballot_stride 3, backoff_max 3, timeout 5"] = dict(
            ballot_stride=3, backoff_max=3, timeout=5
        )
        knobs["q1/q2 2/4"] = dict(q1=2, q2=4)
        knobs["q1/q2 4/2"] = dict(q1=4, q2=2)
    else:
        knobs["ballot_stride 3, backoff_max 3"] = dict(ballot_stride=3, backoff_max=3)
    if protocol == "fastpaxos":
        knobs["q1/q2/q_fast 4/2/4"] = dict(q1=4, q2=2, q_fast=4)
    return {
        name: dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, **kv))
        for name, kv in knobs.items()
    }


# Every gray-failure and partition knob at once, with crash windows: the
# JAX package's fused-kernel case (tests/test_gray.py
# test_fused_matches_reference_under_gray), put on config5's cells.
GRAY_ALL = dict(
    p_part=0.5, part_max_start=20, part_max_len=12, p_asym=0.7, p_flaky=0.4, flaky_drop=0.4,
    flaky_dup=0.2, p_dup=0.05, timeout_skew=4, backoff_skew=3, p_corrupt=0.05, stale_k=8,
    p_crash=0.2, crash_max_start=20, crash_max_len=8,
)


def gray_knob_configs(n_inst: int, seed: int, protocol: str = "paxos") -> dict:
    """The knob cases of the gray-failure and partition arms of K1
    (Paxos), K2 (Fast Paxos), K3 (Raft-core) or K5 (Multi-Paxos), each on
    ``protocol``'s tick: each knob of ``config_gray_chaos`` alone on the
    config's own base (idling, holds, p_dup 0.05): a two-way partition, a
    one-way one, flaky links without and with duplication, timeout skew and
    backoff skew; then ``config_gray_chaos`` itself, ``config_partition``,
    ``config_corrupt``, ``config_stale`` (stale_k with crash windows),
    amnesia (``config_stale`` with stale_k 0 and amnesia on); for Paxos
    ``config_flex(4, 2)``, for Fast Paxos and Raft-core every knob at once
    on the config5 cell (``GRAY_ALL``).  Multi-Paxos takes each case's fault
    config on config3's cell (K5 packs at most 4 voter masks a slot, and
    the Paxos configs' learner tables have 8 rows), and every knob at once
    on it.  SynchPaxos (K4) takes each case's fault config on its own cell
    (``config_delay_chaos``'s, without its delay: unstamped), then every
    knob at once on that cell with its delay (stamped), and the delay
    composed with a partition in every lane (:func:`delay_cut_config`)."""
    from paxos_tpu_torch.harness import config as C

    if protocol == "synchpaxos":
        cell = main_config("synchpaxos", n_inst, seed)
        out = {
            name: dataclasses.replace(cell, fault=cfg.fault)
            for name, cfg in gray_knob_configs(n_inst, seed).items() if name != "config_flex(4, 2)"
        }
        out["every gray knob, stamped"] = dataclasses.replace(
            cell, fault=dataclasses.replace(cell.fault, **GRAY_ALL)
        )
        out["delay across a cut, stamped"] = delay_cut_config("synchpaxos", n_inst, seed)
        return out
    if protocol == "multipaxos":
        cell = main_config("config3", n_inst, seed)
        out = {
            name: dataclasses.replace(cell, fault=cfg.fault)
            for name, cfg in gray_knob_configs(n_inst, seed).items() if name != "config_flex(4, 2)"
        }
        out["every gray knob"] = dataclasses.replace(
            cell, fault=dataclasses.replace(cell.fault, **GRAY_ALL)
        )
        return out
    if protocol != "paxos":
        cell = main_config(protocol, n_inst, seed)
        out = {
            name: dataclasses.replace(cfg, protocol=protocol)
            for name, cfg in gray_knob_configs(n_inst, seed).items() if name != "config_flex(4, 2)"
        }
        out["every gray knob"] = dataclasses.replace(
            cell, fault=dataclasses.replace(cell.fault, **GRAY_ALL)
        )
        return out
    chaos = C.config_gray_chaos(n_inst, seed)
    off = dict(p_part=0.0, p_asym=0.0, p_flaky=0.0, timeout_skew=0, backoff_skew=0)
    knobs = {
        "p_part two-way": dict(p_part=0.5),
        "p_asym": dict(p_part=0.5, p_asym=0.7),
        "p_flaky without dup": dict(p_flaky=0.4, flaky_dup=0.0, p_dup=0.0),
        "p_flaky with dup": dict(p_flaky=0.4),
        "timeout_skew 6": dict(timeout_skew=6),
        "backoff_skew 3": dict(backoff_skew=3),
    }
    out = {
        name: dataclasses.replace(chaos, fault=dataclasses.replace(chaos.fault, **{**off, **kv}))
        for name, kv in knobs.items()
    }
    stale = C.config_stale(n_inst, seed)
    out.update({
        "config_gray_chaos": chaos,
        "config_partition": C.config_partition(n_inst, seed),
        "config_corrupt": C.config_corrupt(n_inst, seed),
        "config_stale": stale,
        "amnesia": dataclasses.replace(
            stale, fault=dataclasses.replace(stale.fault, stale_k=0, amnesia=True)
        ),
        "config_flex(4, 2)": C.config_flex(4, 2, n_inst, seed),
    })
    return out


def delay_config(protocol: str, n_inst: int, seed: int, **knobs):
    """The JAX package's tests/test_delay.py ``delay_cfg``: 2 proposers, 5
    acceptors, p_delay 0.6 and delay_max 3 unless ``knobs`` say otherwise,
    every other knob at its default."""
    from paxos_tpu_torch.faults.injector import FaultConfig
    from paxos_tpu_torch.harness.config import SimConfig

    knobs = {"p_delay": 0.6, "delay_max": 3, **knobs}
    return SimConfig(
        n_inst=n_inst, n_prop=2, n_acc=5, seed=seed, protocol=protocol, fault=FaultConfig(**knobs)
    )


def delay_cut_config(protocol: str, n_inst: int, seed: int):
    """Delay across a partition in every lane, loss off
    (tests/test_delay.py ``test_delay_conservation_across_cut_and_heal``):
    every message is delivered in the end, so every lane decides."""
    return delay_config(
        protocol, n_inst, seed, p_part=1.0, part_max_start=8, part_max_len=8, timeout=6
    )


def delay_knob_configs(n_inst: int, seed: int, protocol: str = "paxos") -> dict:
    """The cases of the bounded-delay channel of K1, K2, K3 or K5 (their
    stamped instantiations), each on ``protocol``'s tick:
    ``config_delay_chaos`` in both delay regimes, delay with drops and
    duplicates (tests/test_delay.py ``test_delay_composes_with_drop_safely``,
    its own seed 1), delay across a cut in every lane
    (:func:`delay_cut_config`), and every gray knob at once on the
    protocol's main cell (config2's, config5's) with p_delay 0.4 (the last
    two on the arms).  Multi-Paxos takes each case's fault config on
    config3's cell (K5 packs at most 4 voter masks a slot)."""
    from paxos_tpu_torch.harness import config as C

    if protocol == "multipaxos":
        cell = main_config("config3", n_inst, seed)
        return {
            name: dataclasses.replace(cell, fault=cfg.fault)
            for name, cfg in delay_knob_configs(n_inst, seed, "fastpaxos").items()
        }
    flag = main_config(protocol, n_inst, seed)
    return {
        "config_delay_chaos": main_config(f"delaychaos-{protocol}", n_inst, seed),
        "config_delay_chaos violate_delta": dataclasses.replace(
            C.config_delay_chaos(n_inst, seed, violate_delta=True), protocol=protocol
        ),
        "delay with drops and duplicates": delay_config(
            protocol, n_inst, 1, p_drop=0.15, p_dup=0.1, p_delay=0.5, delay_max=4, timeout=6
        ),
        "delay across a cut": delay_cut_config(protocol, n_inst, seed),
        "every gray knob, p_delay 0.4": dataclasses.replace(
            flag, fault=dataclasses.replace(flag.fault, **GRAY_ALL, p_delay=0.4)
        ),
    }


def sp_checker_config(n_inst: int = 1024):
    """config_delay_chaos at seed 3 with delta violated, the planted
    sp_unsafe_fast bug and p_drop 0.4."""
    from paxos_tpu_torch.harness import config as C

    cfg = C.config_delay_chaos(n_inst, 3, violate_delta=True)
    return dataclasses.replace(
        cfg, fault=dataclasses.replace(cfg.fault, sp_unsafe_fast=True, p_drop=0.4)
    )


def mp_checker_config(n_inst: int = 1024):
    """config3 at seed 3 with equivocating acceptors (p_equiv 0.4)."""
    cfg = main_config("config3", n_inst, 3)
    return dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, p_equiv=0.4))


def mp_gray_checker_config(name: str, n_inst: int, seed: int):
    """Bug-injection config ``name`` of ``harness/config.py``'s fault config
    on config3's cell (``MP_GRAY_CHECKER_VIOLATIONS``)."""
    from paxos_tpu_torch.harness import config as C

    return dataclasses.replace(
        main_config("config3", n_inst, seed), fault=getattr(C, name)(n_inst, seed).fault
    )


def mp_knob_configs(n_inst: int, seed: int) -> dict:
    """config3's cell without its crash windows, with each knob its main
    path leaves at its default: p_dup 0.2, q1/q2 = 2/4 (which the
    Multi-Paxos tick reads nowhere: its quorums are majorities), and
    ballot_stride 3 with backoff_max 3 and timeout 5."""
    cfg = main_config("config3", n_inst, seed)
    cfg = dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, p_crash=0.0, p_crash_prop=0.0))
    knobs = {
        "p_dup 0.2": dict(p_dup=0.2),
        "q1/q2 2/4": dict(q1=2, q2=4),
        "ballot_stride 3, backoff_max 3, timeout 5": dict(ballot_stride=3, backoff_max=3, timeout=5),
    }
    return {
        name: dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, **kv))
        for name, kv in knobs.items()
    }


def instantiation_ptxas(lines: list, protocol: str, shape: tuple) -> list:
    """The ``ptxas`` lines of the instantiation ``shape`` of K1 to K5
    (``(n_prop, n_acc, k_slots, stamped, arms)``, K5's with the log length
    before k_slots, K1's, K2's and K3's with ``observed`` last): the entry
    function whose
    mangled template arguments start with the shape and the stamps flag,
    with a ``Gray`` exactly where ``arms`` and an ``obs::Obs`` exactly
    where ``observed``."""
    from paxos_tpu_torch.kernels.fused_tick import BINDINGS

    observed = 0
    if BINDINGS[protocol].observed:
        *shape, observed = shape
    *dims, stamped, arms = shape
    head = f"fused_{protocol}_kernelI" + "".join(f"Li{d}E" for d in dims) + f"Lb{stamped}E"
    for j, line in enumerate(lines):
        if ("entry function" in line and head in line and ("Gray" in line) == bool(arms)
                and ("Obs" in line) == bool(observed)):
            return lines[j:j + 3]
    raise AssertionError(f"no ptxas report of the {protocol} kernel's instantiation {shape}")


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 1
    if not Path("paxos_tpu_torch").is_dir():
        log("run from the repository root: paxos_tpu_torch/ not found")
        return 1
    t0 = time.perf_counter()
    built = phase_build()
    geometry = phase_geometry()
    ceiling = phase_ceiling()
    phase_golden()
    full = phase_compare(ceiling["ops_per_s"])
    ablated, ablation = phase_ablation(ceiling["ops_per_s"])
    main_paths = {p: phase_main_path(p) for p in MAIN_PATHS}
    profiles = {p: phase_main_path_profile(p) for p in main_paths}
    checker = phase_checker()
    from paxos_tpu_torch.kernels.fused_tick import ABLATE_KEYS, BINDINGS, ablate_defines

    kernels = []
    # One entry per main path: its kernel's instantiation on the path's
    # config, with the path's full-width timing and run; a kernel's first
    # path names the kernel, a further one (config3-long, a gray-chaos path
    # on an arms instantiation) is named after its path.
    for path, mp in MAIN_PATHS.items():
        binding = BINDINGS[mp.protocol]
        first = next(p for p, m in MAIN_PATHS.items() if m.protocol == mp.protocol) == path
        cfg = main_config(path, 256)
        shape = binding.kernel_shape(path_state(cfg, "cpu"), cfg.fault)
        measured = full[path]
        ptxas = built["ptxas"][binding.kernel]
        entry = {
            "name": binding.kernel if first else f"{binding.kernel}[{path}]",
            "route": "cuda",
            "source": KERNEL_SOURCE.format(binding.kernel),
            "replaces": REPLACES[mp.protocol] + (OBSERVER_ARMS[mp.protocol] if mp.planes else ""),
            "launches": main_paths[path]["launches"],
            "max_abs_err": measured["max_abs_err"],
            "tolerance": 0,  # int32/bool state: byte-identical to the plain version
            "ms": measured["ms"],
            "plain_ms": measured["plain_ms"],
            "bound_ms": measured["bound_ms"],
            "bound_by": measured["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a tick
            **measured,  # the required keys above first, then the rest of the measurement
            "path": path,
            "instantiation": list(shape),
            "shape": f"{path} {FULL_LANES} lanes x 64 ticks, block {binding.block}"
            + (", compacted after every chunk" if mp.compact else ""),
            "census": mp.census,
            "main_path_wall_s": main_paths[path]["wall_s"],
            "main_path_walls_s": main_paths[path]["walls_s"],
            "main_path_rounds_per_s": main_paths[path]["rounds_per_s"],
            "main_path_report": main_paths[path]["report"],
            "main_path_fast_path_rate": main_paths[path].get("fast_path_rate"),
            "main_path_eviction_block_digests": main_paths[path]["eviction_block_digests"],
            "main_path_profile": profiles[path],
            "ptxas": instantiation_ptxas(ptxas, mp.protocol, shape),
        }
        if first and mp.protocol in geometry:
            entry["instantiations"] = geometry[mp.protocol]  # threads, smem_bytes, blocks_per_sm each
        kernels.append(entry)
    # One entry per ablated build: its launches are the ablation table's
    # (no main path launches one, each path's check above); its comparison
    # and timing at ABLATION_LANES lanes from stream block 5.
    for (protocol, flag), measured in ablated.items():
        binding = BINDINGS[protocol]
        path = ABLATION_PATHS[protocol]
        tag = binding.kernel + "".join(f" -D{d}" for d in ablate_defines(frozenset({flag})))
        kernels.append({
            "name": f"{binding.kernel}[no-{flag}]",
            "route": "cuda",
            "source": KERNEL_SOURCE.format(binding.kernel),
            "replaces": ABLATED_REPLACES[protocol],
            "launches": measured["launches"],
            "max_abs_err": measured["max_abs_err"],
            "tolerance": 0,
            "ms": measured["ms"],
            "plain_ms": measured["plain_ms"],
            "bound_ms": measured["bound_ms"],
            "bound_by": measured["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a tick
            **measured,
            "ablate": [flag],
            "instantiation": list(ABLATE_KEYS[protocol]),
            "shape": f"{path} {ABLATION_LANES} lanes x 2 x 64 ticks from stream block 5 "
            f"(plain_ms), then 5 steady 64-tick chunks (ms), block {binding.block}; launches "
            f"and main_path_*: the ablation table, {FULL_LANES} lanes x (1 + 3) x 256 ticks",
            "ptxas": built["ptxas"][tag],
        })
    # K6 measures the card; no main path launches it (each path's check
    # above), so its count is read from the last main path's run.
    k6_launches = main_paths["config3long"]["all_launches"]["int32_ceiling"]
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
    print(json.dumps({"ablation": ablation}))
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
