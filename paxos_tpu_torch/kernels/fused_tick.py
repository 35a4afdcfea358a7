"""Fused multi-tick engine (counterpart of ``paxos_tpu/kernels/fused_tick.py``).

One engine, bound once per protocol: ``fused_<protocol>_chunk`` advances
every instance ``n_ticks`` ticks of ``counter_masks`` + the protocol's
tick.  On a CUDA tensor it launches the protocol's hand-written kernel
``csrc/fused_<protocol>_tick.cu`` (one thread per instance, state resident
on chip for the whole chunk, updated in place) or raises; on a CPU
tensor it runs :func:`reference_chunk`, the plain PyTorch version.
``FUSED_CHUNKS[protocol]`` is the engine's chunk function, as
``_make_chunk`` is in the reference: it clamps ballots at the chunk
boundaries and switches to a per-tick clamp for very long chunks.
:func:`draw_census` runs a kernel's measuring build, which also counts
the counter-PRNG draws it makes and the slot-array elements it touches.

Streams: per-tick masks are keyed by (seed, tick, stream block id), with
``block`` lanes per stream block, so a campaign replays bit for bit across
the two packages.  The default block is the reference's per protocol:
1024 for the single-decree protocols, which draw from the single-decree
stream ids with ``counter_masks``, and 256 for Multi-Paxos, which draws
from its own ids with ``mp_counter_masks``.

Every fused kernel models the bounded-delay channel: each takes a state
with or without ``until`` stamps (an instantiation each, the ``stamped``
field of its ``KERNEL_SHAPES``) and the plan's ``link_delay`` when
``p_delay > 0``.  Every fused kernel models the gray-failure and partition arms
(``protocols.paxos.GRAY_KNOBS``), in an instantiation of its own that the
wrapper picks when a knob of theirs is on (the last field of the
``KERNEL_SHAPES``, ``arms``: :func:`gray_arms`); it reads the plan's
partition and gray leaves and, under ``stale_k``, the state's snapshot
shadows.

Every kernel keeps part of each lane's state in shared memory for the
whole chunk: the Multi-Paxos kernel its slot arrays, and the
single-decree kernels their message payloads and learner table; each its
delay stamps where the state carries them;
their launch geometry per instantiation (lanes a CUDA block, staged rows,
shared bytes) is ``MP_STAGING``, ``SP_STAGING`` and ``FR_STAGING``, which
the kernels' instantiations mirror; the wrapper passes them the shared
bytes.  :func:`phase_clocks` runs the phase-clock build of K1 to K5, which
splits a lane's cycles by phase of the tick.

Every fused kernel also computes the observer planes a state carries
(telemetry, coverage, exposure, margin, the client workload), in observed
instantiations of its own (the last field of its keys, ``observed``),
which take the planes' leaves as a separate argument (:func:`_obs_args`)
and keep their counters in the lane's column (:func:`obs_rows`; K5, K4 and
K2 keep most of them in registers, :func:`tally_obs_rows`).

:func:`fused_fns` binds a protocol's tick with components removed
(``ABLATE_FLAGS``), the reference's ablation variants: the Paxos and
Multi-Paxos wrappers take ``ablate``, which on a CUDA tensor launches the
kernel's ablated build (``-DFUSED_ABLATE=<bitmask>``, config2's or
config3's key only) and on a CPU tensor the ablated plain tick.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import torch

from paxos_tpu_torch.core.fp_state import FastPaxosState
from paxos_tpu_torch.core.mp_state import MultiPaxosState
from paxos_tpu_torch.core.raft_state import RaftState
from paxos_tpu_torch.core.sp_state import SynchPaxosState
from paxos_tpu_torch.core.state import LaneState, PaxosState
from paxos_tpu_torch.faults.injector import (
    FaultConfig,
    FaultPlan,
    links_dup,
    optional_fields,
    rate_threshold,
)
from paxos_tpu_torch.kernels import counter_prng as cp
from paxos_tpu_torch.protocols.fastpaxos import apply_tick_fast
from paxos_tpu_torch.protocols.multipaxos import apply_tick_mp, mp_counter_masks
from paxos_tpu_torch.protocols.paxos import (
    ABLATE_FLAGS,
    apply_tick,
    check_supported,
    counter_masks,
)
from paxos_tpu_torch.protocols.raftcore import apply_tick_raft
from paxos_tpu_torch.protocols.synchpaxos import apply_tick_sp

DEFAULT_BLOCK = 1024

# Worst-case proposer.bal growth per tick: make_ballot(round + 1, pid) moves
# a ballot by less than 2 * MAX_PROPOSERS.
BALLOT_GROWTH_PER_TICK = 16

# Shapes each CUDA kernel is instantiated for, the last three fields of each
# ``stamped`` (1: delay stamps, p_delay > 0), ``arms`` (1: the
# gray-failure and partition arms) and ``observed`` (1: the observer
# planes, at (2, 5, 8) or Multi-Paxos' (2, 5, 8, 4) with and without the
# stamps and the arms): Paxos, Fast Paxos and Raft-core (n_prop, n_acc,
# k_slots, stamped, arms, observed) of config2/config4 or config5,
# and config1 (Paxos) or (2, 3, 8), the three-acceptor shape the
# reference's own kernel tests run (tests/test_fused.py), with the arms
# and the stamps at (2, 5, 8), the shape of every config that sets them,
# each without and with the other; SynchPaxos the same of
# config_delay_chaos (with delay stamps) and of its delay-free runs, three
# acceptors, and the arms at (2, 5, 8) without stamps (config_gray_chaos)
# and with them; Multi-Paxos (n_prop, n_acc, log_len, k_slots, stamped,
# arms, observed) of config3, config3-long, the reference tests' 4-slot
# window, and three acceptors, with the arms, the stamps and the planes at
# config3's (2, 5, 8, 4), and the planes alone at config3-long's
# (2, 5, 16, 4).
_OBSERVED_SHAPES = ((2, 5, 8, 0, 0, 1), (2, 5, 8, 0, 1, 1), (2, 5, 8, 1, 0, 1), (2, 5, 8, 1, 1, 1))
_FR_SHAPES = (
    (2, 5, 8, 0, 0, 0), (2, 3, 8, 0, 0, 0), (2, 5, 8, 0, 1, 0), (2, 5, 8, 1, 0, 0),
    (2, 5, 8, 1, 1, 0),
) + _OBSERVED_SHAPES
KERNEL_SHAPES = {
    "paxos": (
        (2, 5, 8, 0, 0, 0), (1, 3, 8, 0, 0, 0), (2, 5, 8, 0, 1, 0), (2, 5, 8, 1, 0, 0),
        (2, 5, 8, 1, 1, 0),
    ) + _OBSERVED_SHAPES,
    "fastpaxos": _FR_SHAPES,
    "raftcore": _FR_SHAPES,
    "synchpaxos": (
        (2, 5, 8, 1, 0, 0), (2, 5, 8, 0, 0, 0), (2, 3, 8, 1, 0, 0), (2, 5, 8, 0, 1, 0),
        (2, 5, 8, 1, 1, 0),
    ) + _OBSERVED_SHAPES,
    "multipaxos": (
        (2, 5, 8, 4, 0, 0, 0), (2, 5, 16, 4, 0, 0, 0), (2, 5, 4, 4, 0, 0, 0), (2, 3, 8, 4, 0, 0, 0),
        (2, 5, 8, 4, 0, 1, 0), (2, 5, 8, 4, 1, 0, 0), (2, 5, 8, 4, 1, 1, 0),
    ) + tuple((2, 5, 8, 4) + key[3:] for key in _OBSERVED_SHAPES) + ((2, 5, 16, 4, 0, 0, 1),),
}
# The one key of each kernel that its ablated builds are instantiated for:
# config2's (K1) and config3's (K5), the reference's ablation targets.
ABLATE_KEYS = {"paxos": (2, 5, 8, 0, 0, 0), "multipaxos": (2, 5, 8, 4, 0, 0, 0)}

# The report-time ``max_ballot >= limit`` threshold of single-decree Paxos.
REPORT_BALLOT_LIMIT = (1 << 15) - 1

# The most shared memory one CUDA block of an H100 may use (227 KB).
SMEM_PER_BLOCK_MAX = 232_448
# The Multi-Paxos state leaves K5 keeps in shared memory for a whole chunk
# (csrc/fused_multipaxos_tick.cu ``Staged``), in column order, the delay
# stamps where the state carries them (``MP_STAMP_LEAVES``), and the
# PROMISE payloads, which it stages where ``MpStaging.stage_prom``.  The
# voter masks (acceptor bitmasks, under 2^8) of a slot share one word.
MP_STAGED_LEAVES = (
    "acceptor.log", "proposer.recov_bv", "learner.lt_bv", "learner.lt_mask",
    "learner.chosen_val", "learner.chosen_tick",
)
MP_STAMP_LEAVES = ("requests.until", "promises.until", "accepted.until")
MP_PROM_LEAF = "promises.p_bv"
MP_PACKED_LEAF = "learner.lt_mask"
MP_MASKS_PER_WORD = 4


def obs_rows(n_prop: int) -> int:
    """Words of a lane's column that K5's observed arms instantiations add
    for the planes' counters (``obs::Rows`` in csrc/fused_common.cuh),
    and an older source's observed columns of any kernel: the 12 event
    counters, the ring's cursor and word count, the 7 injected
    and 7 effective exposure counts, the 4 margins, coverage's new bits,
    and the client queue's 8 fields a proposer."""
    return 12 + 2 + 7 + 7 + 4 + 1 + 8 * n_prop


def tally_obs_rows(n_prop: int, arms: bool = False) -> int:
    """Words of a lane's column that an observed instantiation of K1 to K4,
    or of K5 without the arms, adds: the 4 margins and the client queue's 8
    fields a proposer (``obs::TallyRows``), the other counters of
    :func:`obs_rows` in registers for a launch (``obs::Tally``); K5's with
    the arms (``arms``), which spilled with them in registers, every one
    (:func:`obs_rows`)."""
    return obs_rows(n_prop) if arms else 4 + 8 * n_prop


@dataclasses.dataclass(frozen=True)
class MpStaging:
    """K5's launch geometry at one instantiation: ``threads`` lanes a CUDA
    block (a multiple of 32), whether the PROMISE payloads are staged, the
    int32 words of a lane's shared-memory column (``rows``: one per staged
    slot-array element and delay stamp) and the block's dynamic shared
    memory, ``rows * 4 * threads`` bytes."""

    threads: int
    stage_prom: bool
    rows: int
    smem_bytes: int


def mp_staged_rows(
    n_prop: int, n_acc: int, log_len: int, k_slots: int, stamped: int, stage_prom: bool,
    caps: bool = False, links: bool = False,
) -> int:
    """Words of a lane's column: the log (A*L), the recovery rows (P*L), the
    learner table's (ballot, value) pairs (L*K) and voter masks (L, a
    slot's K <= 4 masks in one word), the chosen values and ticks (L
    each), the stamps of the three buffers (2PA + PA + PA) where stamped,
    the links' latency caps (PA) where ``caps``, the arms'
    per-link drop and dup thresholds (PA each) and the proposers' backoff
    multipliers (P) where ``links``, and the PROMISE payloads (P*A*L)
    where staged."""
    if k_slots > MP_MASKS_PER_WORD:
        raise ValueError(
            f"K5 packs at most {MP_MASKS_PER_WORD} voter masks a slot, not {k_slots}: ROADMAP "
            "item 23 (K5 at k_slots above 4); the plain tick runs it on the CPU"
        )
    edges = n_prop * n_acc
    rows = (n_acc + n_prop + k_slots + 3) * log_len + (4 * edges if stamped else 0)
    rows += edges if caps else 0
    rows += 2 * edges + n_prop if links else 0
    return rows + (edges * log_len if stage_prom else 0)


def _mp_staging(
    shape: tuple, threads: int, stage_prom: bool, counter_rows: Callable = tally_obs_rows,
    links: bool = True, caps: bool = True,
) -> MpStaging:
    # The key: (P, A, L, K, stamped, arms, observed); an instantiation
    # without the planes stages the arms' per-link thresholds where the arms
    # are on (``links``) and its links' caps where stamped (``caps``; an
    # older source's column, which chip_ab.py launches, holds neither), the
    # planes add their counter rows (an older source's key may lack the
    # observed flag, and its column may hold every counter: counter_rows
    # gives them for n_prop and the arms flag).
    observed = len(shape) > 6 and bool(shape[6])
    caps = caps and not observed and bool(shape[4])
    links = links and not observed and len(shape) > 5 and bool(shape[5])
    rows = mp_staged_rows(*shape[:5], stage_prom, caps, links)
    if observed:
        rows += counter_rows(shape[0], shape[5])
    return MpStaging(threads, stage_prom, rows, rows * 4 * threads)


# K5's geometry per instantiation (n_prop, n_acc, log_len, k_slots,
# stamped, arms, observed), which the wrapper passes to the kernel.  The tick is a
# long dependent chain a lane, so the warps an SM holds set the pace; at
# 255 registers a thread it holds at most 8 (2 blocks of 128).  The
# payloads are staged where the SM still holds 8 warps; at (2, 5, 16, 4)
# the 224 words without them allow 8, with them 4 (64 lanes a block),
# which made the chunk slower (PERF.md §6).  The stamps (40 words) join
# the column; at (2, 5, 8, 4) with them, the payloads move to global
# memory as at (2, 5, 16, 4): the 152 words left take 2 blocks of 128 (8
# warps), where staging everything (232 words) allows 2 blocks of 96 (6
# warps; PERF.md §6 times both); with the links' caps 162 words (184 with
# the arms).  Staging the payloads beside stamps packed as 16-bit codes (217
# words at 2 x 128) ran the steady chunk 7% slower on delaychaos-multipaxos:
# the column moves 80 more words a lane a launch than the steady tick
# touches.  The arms instantiations add the links' drop and dup thresholds
# and the backoff multipliers to their default's column (214 words; the
# snapshot shadows stay in global memory).  The
# observed instantiations add the planes' counter rows (tally_obs_rows: 20
# words, the rest in registers; 49 with the arms) and stage the PROMISE
# payloads, which the coverage digest folds every tick: config3's observed
# key (212 words) takes 2 blocks of 128 (8 warps), whose steady chunk on
# observed-multipaxos ran 22.573 and 22.511 ms against 29.985 and 29.737
# at 96 x 2 and 25.265 and 26.171 at 128 x 2 with the payloads in global
# memory (132 words; one call of chip_ab.py --planes, PERF.md section 6);
# the others at (2, 5, 8, 4) (241 words with the arms, 252 stamped, 281
# both) fit 2 blocks of 96 only.  The long log's observed column is 404
# words (2 blocks of 64 lanes, 4 warps); without the payloads 244 words
# (2 blocks of 96) ran 71.236 and 71.278 ms against 69.153 and 69.164
# staged (the same call): it stays at 64 x 2 staged.
MP_STAGING = {
    (2, 5, 8, 4, 0, 0, 0): _mp_staging((2, 5, 8, 4, 0, 0, 0), 128, True),
    (2, 5, 16, 4, 0, 0, 0): _mp_staging((2, 5, 16, 4, 0, 0, 0), 128, False),
    (2, 5, 4, 4, 0, 0, 0): _mp_staging((2, 5, 4, 4, 0, 0, 0), 128, True),
    (2, 3, 8, 4, 0, 0, 0): _mp_staging((2, 3, 8, 4, 0, 0, 0), 128, True),
    (2, 5, 8, 4, 0, 1, 0): _mp_staging((2, 5, 8, 4, 0, 1, 0), 128, True),
    (2, 5, 8, 4, 1, 0, 0): _mp_staging((2, 5, 8, 4, 1, 0, 0), 128, False),
    (2, 5, 8, 4, 1, 1, 0): _mp_staging((2, 5, 8, 4, 1, 1, 0), 128, False),
    **{key: _mp_staging(key, 96, True) for key in KERNEL_SHAPES["multipaxos"] if key[6] and key[2] == 8},
    (2, 5, 8, 4, 0, 0, 1): _mp_staging((2, 5, 8, 4, 0, 0, 1), 128, True),
    (2, 5, 16, 4, 0, 0, 1): _mp_staging((2, 5, 16, 4, 0, 0, 1), 64, True),
}


# The SynchPaxos state leaves K4 keeps in shared memory for a whole chunk
# (``sd::SdStaged`` in csrc/fused_common.cuh), in column order, each with
# the message kinds it stages (None: every row of the leaf); the stamps only
# where the state carries them.  The kinds a leaf does not stage are those
# the tick only ever writes as 0 (``SP_ZERO_WORDS``): they get no row, and
# the column store writes 0 to them in the slots the chunk wrote.
SP_STAGED_LEAVES = (
    ("requests.bal", (0, 1)), ("requests.v1", (1,)), ("replies.bal", (0, 1)),
    ("replies.v1", (0, 1)), ("replies.v2", (0,)),
    ("requests.until", (0, 1)), ("replies.until", (0, 1)),
    ("learner.lt_bal", None), ("learner.lt_val", None), ("learner.lt_mask", None),
)
# PREPARE's v1, every request's v2, ACCEPTED's v2 (protocols/synchpaxos.py).
SP_ZERO_WORDS = (("requests.v1", (0,)), ("requests.v2", (0, 1)), ("replies.v2", (1,)))


@dataclasses.dataclass(frozen=True)
class ColumnStaging:
    """The launch geometry of K1 to K4 at one instantiation: ``threads``
    lanes a CUDA block (a multiple of 32), the int32 words of a lane's
    shared-memory column (``rows``), the block's dynamic shared memory
    (``rows * 4 * threads`` bytes), and ``min_blocks``, the blocks an SM is
    to hold, which caps a thread's registers (``__launch_bounds__``)."""

    threads: int
    rows: int
    smem_bytes: int
    min_blocks: int


def sp_staged_rows(n_prop: int, n_acc: int, k_slots: int, stamped: int) -> int:
    """Words of a lane's column: the request ballots (2PA) and ACCEPT
    values (PA), the reply ballots and first payloads (2PA each) and PROMISE
    second payloads (PA), the stamps of both buffers (2PA each) where
    stamped, and the learner table (3K)."""
    e = n_prop * n_acc
    return 8 * e + (4 * e if stamped else 0) + 3 * k_slots


def _sp_staging(
    shape: tuple, threads: int, min_blocks: int, counter_rows: Callable = tally_obs_rows
) -> ColumnStaging:
    # The key: (P, A, K, stamped, arms, observed); the arms add no row, the
    # planes their counters (an older source's key, which chip_ab.py
    # launches, may lack the observed flag, and its column may hold every
    # counter: counter_rows gives them for n_prop).
    rows = sp_staged_rows(*shape[:4])
    if len(shape) > 5 and shape[5]:
        rows += counter_rows(shape[0])
    return ColumnStaging(threads, rows, rows * 4 * threads, min_blocks)


def _sd_observed_geometry(protocol: str, shape: tuple) -> tuple:
    """(lanes a block, blocks an SM) of the observed instantiation
    ``shape`` of K1 to K4 (tally_obs_rows: 124 words, 164 stamped; K3 134
    and 174): with the arms, whose counters take their registers to 228 to
    255, 2 of 128; without them 3 of 128, stamped 3 of 96 on K4 and K3 and
    2 of 128 on K2 and K1 (whose stamped keys spilled 28 and 44 B at 3 of
    96: 9 warps leave a thread 168 registers, as 12 do, since each of an
    SM's four schedulers holds the registers of its own warps).  On the
    main paths the committed code at 3 blocks ran the steady chunk in 9.095
    / 9.118 ms (K2), 16.552 / 16.646 ms (K4) and 9.200 / 9.168 ms (K3)
    against 11.410 / 11.322, 17.795 / 17.754 and 11.867 / 11.837 at 2 of
    128, K3's stamped key 15.938 / 15.956 ms at 3 of 96 against 16.792 /
    16.782 (chip_ab.py --planes, PERF.md section 6)."""
    if shape[4] or (shape[3] and protocol in ("fastpaxos", "paxos")):
        return 128, 2
    return (96, 3) if shape[3] else (128, 3)


# K4's geometry per instantiation, which the wrapper passes to the kernel.
# As K5's, the tick is a long dependent chain a lane, so the warps an SM
# holds set the pace: 3 blocks of 128 lanes (12 warps), which caps a
# thread at 168 registers; the stamped (2, 5, 8) column (144 words, the
# learner table included) leaves room for no fourth block.  The arms
# instantiations keep their default's column (the snapshot shadows stay in
# global memory).  The observed instantiations add the planes' counters
# (tally_obs_rows) at _sd_observed_geometry's blocks.
SP_STAGING = {
    shape: _sp_staging(shape, *(_sd_observed_geometry("synchpaxos", shape) if shape[5] else (128, 3)))
    for shape in KERNEL_SHAPES["synchpaxos"]
}


# The Paxos, Fast Paxos and Raft-core state leaves K1, K2 and K3 keep in
# shared memory for a whole chunk (``sd::SdStaged`` in
# csrc/fused_common.cuh), in column order, each with the message kinds it
# stages (None: every row of the leaf), the stamps only where the state
# carries them: Paxos and Fast Paxos ``SP_STAGED_LEAVES``; Raft-core stages
# every request's v1: a REQVOTE carries the candidate's entry term.
FR_STAGED_LEAVES = {
    "paxos": SP_STAGED_LEAVES,
    "fastpaxos": SP_STAGED_LEAVES,
    "raftcore": (
        ("requests.bal", (0, 1)), ("requests.v1", (0, 1)), ("replies.bal", (0, 1)),
        ("replies.v1", (0, 1)), ("replies.v2", (0,)),
        ("requests.until", (0, 1)), ("replies.until", (0, 1)),
        ("learner.lt_bal", None), ("learner.lt_val", None), ("learner.lt_mask", None),
    ),
}
# The words each tick only ever writes as 0: Paxos and Fast Paxos a
# PREPARE's v1, every request's v2 and an ACCEPTED's v2
# (protocols/paxos.py, protocols/fastpaxos.py), Raft-core every request's
# v2 and an ACK's v2 (protocols/raftcore.py).
_PAXOS_ZERO_WORDS = (("requests.v1", (0,)), ("requests.v2", (0, 1)), ("replies.v2", (1,)))
FR_ZERO_WORDS = {
    "paxos": _PAXOS_ZERO_WORDS,
    "fastpaxos": _PAXOS_ZERO_WORDS,
    "raftcore": (("requests.v2", (0, 1)), ("replies.v2", (1,))),
}


def fr_staged_rows(
    protocol: str, n_prop: int, n_acc: int, k_slots: int, stamped: int = 0
) -> int:
    """Words of a K1, K2 or K3 lane's column: the request ballots (2PA) and
    staged values (PA, Raft-core 2PA), the reply ballots and first payloads
    (2PA each) and kind-0 second payloads (PA), the stamps of both buffers
    (2PA each) where stamped, and the learner table (3K)."""
    e = n_prop * n_acc
    return (9 if protocol == "raftcore" else 8) * e + (4 * e if stamped else 0) + 3 * k_slots


def _fr_staging(
    protocol: str, shape: tuple, threads: int, min_blocks: int, counter_rows: Callable = tally_obs_rows
) -> ColumnStaging:
    # The key: (P, A, K, stamped, arms, observed); an older source's, which
    # chip_ab.py launches, may lack the observed flag.  The planes add their
    # counter rows (most of them in registers, tally_obs_rows; an older
    # source every one in its column: counter_rows gives them).
    rows = fr_staged_rows(protocol, *shape[:4])
    if len(shape) > 5 and shape[5]:
        rows += counter_rows(shape[0])
    return ColumnStaging(threads, rows, rows * 4 * threads, min_blocks)


# K1's, K2's and K3's geometry per instantiation, which the wrapper passes
# to the kernel: K4's, 3 blocks of 128 lanes (12 warps) an SM, which caps a
# thread at 168 registers; K2's (2, 5, 8) column (104 words) leaves room
# for a fourth block (16 warps, 128 registers), which made its main path
# 12% faster (PERF.md §6).  K3's (114 words) does not.  K1's unstamped
# columns (104 and 48 words) take 4 blocks at both shapes.  The stamped
# (2, 5, 8) columns of K1 and K2 (144 words, 72 KiB a block) leave room for
# 3.  K3's (154 words) leaves room for 2 blocks of 128 lanes (8 warps) or
# 11 of 32 (11 warps, 184 registers a thread at most): on
# delaychaos-raftcore's steady chunk 128 x 2 ran 4.108 and 4.132 ms, 96 x
# 3 3.791 and 3.746, 32 x 11 3.448 and 3.473 (one call, PERF.md §6), so K3
# stamped takes 32 x 11.  Each arms instantiation keeps its default's
# column (the snapshot shadows stay in global memory), and its registers
# are capped for its default's blocks (the unstamped arms: 3).  The
# observed instantiations add the planes' counter rows (tally_obs_rows) and
# take _sd_observed_geometry's blocks.
FR_STAGING = {
    "paxos": {
        shape: _fr_staging(
            "paxos", shape,
            *(_sd_observed_geometry("paxos", shape) if shape[5] else (128, 4 if shape[3:5] == (0, 0) else 3)),
        )
        for shape in KERNEL_SHAPES["paxos"]
    },
    "fastpaxos": {
        (2, 5, 8, 0, 0, 0): _fr_staging("fastpaxos", (2, 5, 8, 0, 0, 0), 128, 4),
        (2, 3, 8, 0, 0, 0): _fr_staging("fastpaxos", (2, 3, 8, 0, 0, 0), 128, 3),
        (2, 5, 8, 0, 1, 0): _fr_staging("fastpaxos", (2, 5, 8, 0, 1, 0), 128, 3),
        (2, 5, 8, 1, 0, 0): _fr_staging("fastpaxos", (2, 5, 8, 1, 0, 0), 128, 3),
        (2, 5, 8, 1, 1, 0): _fr_staging("fastpaxos", (2, 5, 8, 1, 1, 0), 128, 3),
        **{
            shape: _fr_staging("fastpaxos", shape, *_sd_observed_geometry("fastpaxos", shape))
            for shape in _OBSERVED_SHAPES
        },
    },
    "raftcore": {
        (2, 5, 8, 0, 0, 0): _fr_staging("raftcore", (2, 5, 8, 0, 0, 0), 128, 3),
        (2, 3, 8, 0, 0, 0): _fr_staging("raftcore", (2, 3, 8, 0, 0, 0), 128, 3),
        (2, 5, 8, 0, 1, 0): _fr_staging("raftcore", (2, 5, 8, 0, 1, 0), 128, 3),
        (2, 5, 8, 1, 0, 0): _fr_staging("raftcore", (2, 5, 8, 1, 0, 0), 32, 11),
        (2, 5, 8, 1, 1, 0): _fr_staging("raftcore", (2, 5, 8, 1, 1, 0), 32, 11),
        **{
            shape: _fr_staging("raftcore", shape, *_sd_observed_geometry("raftcore", shape))
            for shape in _OBSERVED_SHAPES
        },
    },
}


def fit_block(block: int, n: int) -> int:
    """A stream block that divides ``n``: the request if it does, else the
    largest power of two <= the request that divides ``n``.

    Every dividing block passes verbatim, as in the reference's interpret
    mode (block floor 1), which recorded the golden digests."""
    if n % block == 0:
        return block
    b = min(block, n & -n)  # n & -n: largest power-of-two divisor of n
    return 1 << (b.bit_length() - 1)


def saturate_ballots(state: LaneState, limit: int = REPORT_BALLOT_LIMIT) -> LaneState:
    """Pin ``proposer.bal`` at the report-time ballot ``limit`` (sticky,
    since ballots are monotone), so an overflowed campaign reads exactly
    the limit and the report's guard fires."""
    prop = dataclasses.replace(state.proposer, bal=torch.clamp(state.proposer.bal, max=limit))
    return dataclasses.replace(state, proposer=prop)


def reference_chunk(
    state: LaneState,
    seed: int,
    plan: FaultPlan,
    cfg: FaultConfig,
    n_ticks: int,
    blk_id: int = 0,
    block: "int | None" = None,
    clamp_per_tick: bool = False,
    apply_fn: Callable = apply_tick,
    mask_fn: Callable = counter_masks,
    ballot_limit: int = REPORT_BALLOT_LIMIT,
) -> LaneState:
    """The plain version: ``n_ticks`` ticks of the fused stream, unclamped
    by default like the reference's ``reference_chunk``.

    ``apply_fn`` and ``mask_fn`` are the protocol's tick and mask sampler
    (default: single-decree Paxos); ``clamp_per_tick`` pins ballots at
    ``ballot_limit`` after every tick.  ``block`` lanes form one stream
    block (default: all lanes, one block with id ``blk_id``); lane ``i``
    draws under block id ``blk_id + i // block``, all blocks in one
    vectorised pass."""
    n_inst = state.n_inst
    block = n_inst if block is None else block
    for _ in range(n_ticks):
        seeds = cp.lane_seeds(seed, state.tick, blk_id, n_inst, block)
        masks = mask_fn(cfg, seeds, state, block=block)
        state = apply_fn(state, masks, plan, cfg)
        if clamp_per_tick:
            state = saturate_ballots(state, ballot_limit)
    return state


# ---- The CUDA kernels -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Binding:
    """One protocol bound to the engine: its tick, mask sampler, state and
    kernel, its default stream block (stream-relevant: the reference's
    ``fused_fns`` default), its report-time ballot limit, the width of
    the reference's packed ``proposer.bal`` field, which sets how long a
    chunk may run with the ballot clamp at its boundaries only, and the
    state attributes its kernel is instantiated over (``KERNEL_SHAPES``),
    followed, where ``arms`` is given, by ``arms(cfg)``: the instantiation
    the config's knobs need."""

    apply_fn: Callable
    mask_fn: Callable
    state_cls: type
    kernel: str  # csrc/<kernel>.cu
    entry: str  # its C entry point
    block: int = DEFAULT_BLOCK
    ballot_limit: int = REPORT_BALLOT_LIMIT
    proposer_bal_bits: int = 17  # core/state.py PAXOS_LAYOUT and kin
    shape_fields: tuple = ("n_prop", "n_acc", "k_slots")
    # Launch geometry per shape (MpStaging, ColumnStaging), whose shared bytes
    # are passed after the shape; None: the kernel's own fixed geometry.
    staging: "dict | None" = None
    arms: "Callable | None" = None
    # Whether the kernel has observed instantiations (the key's last field:
    # 1 where the state carries an observer plane), and its C entry takes
    # the observer arguments (_obs_args).
    observed: bool = False

    def kernel_shape(self, state: LaneState, cfg: "FaultConfig | None" = None) -> tuple:
        shape = tuple(getattr(state, f) for f in self.shape_fields)
        if self.arms is not None:
            shape += (self.arms(cfg or FaultConfig()),)
        if self.observed:
            shape += (int(bool(state.planes)),)
        return shape


def _gray_params(cfg: FaultConfig) -> list:
    """The gray-failure and partition parameters of the kernels, in the C
    entry points' order (``Params`` in ``csrc/fused_common.cuh``): the
    corruption knob, stale_k, then a flag per arm."""
    return [
        *_knob(cfg.p_corrupt), max(cfg.stale_k, 0), int(cfg.amnesia), int(cfg.p_part > 0.0),
        int(cfg.p_asym > 0.0), int(cfg.p_flaky > 0.0), int(links_dup(cfg)),
        int(cfg.timeout_skew > 0), int(cfg.backoff_skew > 1),
    ]


def gray_arms(cfg: FaultConfig) -> int:
    """1 when ``cfg`` turns on an arm of the gray-failure and partition
    instantiation of K1 to K5, else 0 (the default
    instantiation)."""
    return int(any(_gray_params(cfg)))


BINDINGS = {
    # ``stamped`` (1 when the buffers carry ``until``) and the arms pick
    # the instantiation.
    "paxos": Binding(
        apply_tick, counter_masks, PaxosState, "fused_paxos_tick", "fused_paxos_launch",
        shape_fields=("n_prop", "n_acc", "k_slots", "stamped"), staging=FR_STAGING["paxos"],
        arms=gray_arms, observed=True,
    ),
    "fastpaxos": Binding(
        apply_tick_fast, counter_masks, FastPaxosState, "fused_fastpaxos_tick",
        "fused_fastpaxos_launch", shape_fields=("n_prop", "n_acc", "k_slots", "stamped"),
        staging=FR_STAGING["fastpaxos"], arms=gray_arms, observed=True,
    ),
    "raftcore": Binding(
        apply_tick_raft, counter_masks, RaftState, "fused_raftcore_tick", "fused_raftcore_launch",
        shape_fields=("n_prop", "n_acc", "k_slots", "stamped"), staging=FR_STAGING["raftcore"],
        arms=gray_arms, observed=True,
    ),
    # core/sp_state.py SP_LAYOUT: the single-decree widths; as Paxos.
    "synchpaxos": Binding(
        apply_tick_sp, counter_masks, SynchPaxosState, "fused_synchpaxos_tick",
        "fused_synchpaxos_launch", shape_fields=("n_prop", "n_acc", "k_slots", "stamped"),
        staging=SP_STAGING, arms=gray_arms, observed=True,
    ),
    # core/mp_state.py MP_LAYOUT: an 11-bit report limit in a 12-bit field.
    "multipaxos": Binding(
        apply_tick_mp, mp_counter_masks, MultiPaxosState, "fused_multipaxos_tick",
        "fused_multipaxos_launch", block=256, ballot_limit=(1 << 11) - 1,
        proposer_bal_bits=12, shape_fields=("n_prop", "n_acc", "log_len", "k_slots", "stamped"),
        staging=MP_STAGING, arms=gray_arms, observed=True,
    ),
}
_entries: dict = {}


@functools.lru_cache(maxsize=None)
def fused_fns(protocol: str, ablate: frozenset = frozenset()) -> tuple:
    """(apply_fn, mask_fn, default_block) of ``protocol`` on the fused
    engine (the reference's ``fused_fns``): its tick and mask sampler with
    the components ``ablate`` names removed (``ABLATE_FLAGS``; Paxos and
    Multi-Paxos only, the reference's ablation targets), and its default
    stream block.  Cached, so each variant is one pair of partials."""
    if ablate and protocol not in ABLATE_KEYS:
        raise ValueError(f"ablation flags unsupported for {protocol!r}")
    unknown = set(ablate) - set(ABLATE_FLAGS)
    if unknown:
        raise ValueError(f"unknown ablate flags: {sorted(unknown)}")
    if protocol not in BINDINGS:
        raise ValueError(f"unknown protocol: {protocol!r}")
    b = BINDINGS[protocol]
    if not ablate:
        return b.apply_fn, b.mask_fn, b.block
    return (
        functools.partial(b.apply_fn, ablate=ablate), functools.partial(b.mask_fn, ablate=ablate),
        b.block,
    )


def ablate_defines(ablate: frozenset) -> tuple:
    """The build of a kernel without the components ``ablate`` names:
    ``FUSED_ABLATE`` set to their bitmask (bit i: ``ABLATE_FLAGS[i]``), or
    the default build (no define) for the empty set."""
    mask = sum(1 << ABLATE_FLAGS.index(flag) for flag in ablate)
    return (f"FUSED_ABLATE={mask}",) if mask else ()


def report_ballot_limit(protocol: str) -> int:
    """The report-time ``max_ballot >= limit`` threshold of ``protocol``."""
    return BINDINGS[protocol].ballot_limit


def ballot_hoist_safe_ticks(protocol: str = "paxos") -> int:
    """Largest chunk for which the boundary-only ballot clamp matches the
    reference's packed engine: the packed field's headroom over the report
    limit over the growth per tick, (2^17 - 1 - (2^15 - 1)) // 16 = 6144
    for the single-decree protocols, (2^12 - 1 - (2^11 - 1)) // 16 = 128
    for Multi-Paxos."""
    b = BINDINGS[protocol]
    headroom = (1 << b.proposer_bal_bits) - 1 - b.ballot_limit
    return headroom // BALLOT_GROWTH_PER_TICK

# The measuring build of every fused kernel (csrc/fused_common.cuh): it
# also counts the counter-PRNG draws the kernel makes and the slot-array
# elements it touches.
COUNT_DRAWS = ("FUSED_COUNT_DRAWS",)
# The phase-clock build: clock64() cycles per phase of the tick, in the
# order of the kernel's ``Phase`` enum (K5's enum names each phase as
# here); its reader returns PHASE_SLOTS counters (``kMaxPhases`` in
# csrc/fused_common.cuh), those past a kernel's phases 0.  The observed
# ticks of K1 to K5 split their planes into the counters (fault events,
# telemetry, exposure, the client workload), the margin, the coverage
# digest and its insert (``OBSERVER_SPLIT``).
PHASE_CLOCKS = ("FUSED_PHASE_CLOCKS",)
PHASE_SLOTS = 12
OBSERVER_SPLIT = ("observer counters", "margin", "digest", "coverage insert")
PHASES = {
    "paxos": (
        "column load", "reply delivery", "proposer fold", "acceptor half-tick",
        "learner", "proposer sends", *OBSERVER_SPLIT, "column store",
    ),
    "fastpaxos": (
        "column load", "reply delivery", "proposer fold", "acceptor half-tick",
        "learner", "proposer sends", *OBSERVER_SPLIT, "column store",
    ),
    "raftcore": (
        "column load", "reply delivery", "candidate fold", "voter half-tick",
        "learner", "candidate sends", *OBSERVER_SPLIT, "column store",
    ),
    "synchpaxos": (
        "column load", "stamp refresh", "reply delivery", "proposer fold",
        "acceptor half-tick", "learner", "proposer sends", *OBSERVER_SPLIT, "column store",
    ),
    "multipaxos": (
        "column load", "reply delivery", "proposer fold", "acceptor half-tick", "learner",
        "proposer half-tick", *OBSERVER_SPLIT, "column store",
    ),
}


def _entry(protocol: str, defines: tuple = ()):
    """Build (first use only) and bind a kernel's C entry point."""
    if (protocol, defines) not in _entries:
        from paxos_tpu_torch.kernels import build

        binding = BINDINGS[protocol]
        fn = getattr(build.load(binding.kernel, defines), binding.entry)
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_void_p,
        ] + ([
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ] if binding.observed else [])
        fn.restype = ctypes.c_int
        _entries[protocol, defines] = fn
    return _entries[protocol, defines]


def _knob(p: float) -> tuple:
    """(mode, uint32 threshold) of a Bernoulli knob: 0 off, 1 draw, 2 always."""
    if p <= 0.0:
        return 0, 0
    if p >= 1.0:
        return 2, 0
    return 1, cp.bern_threshold(p)


def _delay_knob(p: float) -> tuple:
    """(mode, uint32 threshold) of ``p_delay``: 0 off, 1 draw against the
    reference's ``rate_threshold`` (float32-rounded; never "always")."""
    if p <= 0.0:
        return 0, 0
    return 1, int(rate_threshold(p)) & cp.M32


def _kernel_params(
    cfg: FaultConfig, n_inst: int, n_acc: int, block: int, n_ticks: int,
    seed: int, blk0: int, clamp_per_tick: bool,
) -> list:
    """The kernels' integer parameters, in the C entry points' order
    (``Params`` in ``csrc/fused_common.cuh``)."""
    from paxos_tpu_torch.kernels.quorum import fast_quorum, majority

    quorum = majority(n_acc)
    return [
        n_inst, block, n_ticks, int(seed) & cp.M32, blk0, int(clamp_per_tick),
        cfg.timeout, max(cfg.backoff_max, 1), cfg.ballot_stride,
        cfg.q1 or quorum, cfg.q2 or quorum,
        *_knob(cfg.p_idle), *_knob(cfg.p_hold), *_knob(cfg.p_dup),
        *_knob(cfg.p_drop),
        cfg.q_fast or fast_quorum(n_acc),
        cfg.lease_len, cfg.log_total,
        *_delay_knob(cfg.p_delay), max(cfg.delay_max, 1), max(cfg.delta, 0),
        int(cfg.sp_unsafe_fast), *_gray_params(cfg),
    ]


# The plan leaves every kernel receives, in ``Plan``'s order
# (csrc/fused_common.cuh), each optional one passed as a null pointer when
# the plan has none: the single-decree kernels ignore the proposer crash
# windows, only the stamped instantiations read link_delay, and only the
# arms instantiations the partition and gray leaves after it (the per-link ones (P, A, I) and the skew (P, I) at the
# state's own n_prop and n_acc).
_PLAN_LEAVES = (
    "crash_start", "crash_end", "equivocate", "pcrash_start", "pcrash_end", "link_delay",
    "part_start", "part_end", "aside", "pside", "part_dir", "link_drop", "link_dup",
    "ptimeout", "pboff",
)


def _check_cuda_inputs(
    protocol: str, state: LaneState, plan: FaultPlan, cfg: FaultConfig,
    ablate: frozenset = frozenset(),
) -> None:
    shape = BINDINGS[protocol].kernel_shape(state, cfg)
    if ablate and shape != ABLATE_KEYS.get(protocol):
        raise NotImplementedError(
            f"the ablated builds of the {protocol} kernel are instantiated at "
            f"{ABLATE_KEYS.get(protocol)} only, not {shape} (another shape, or the arms, the "
            "stamps or the planes): ROADMAP item 23; the plain tick runs them on the CPU"
        )
    if protocol == "multipaxos" and shape[-1] and shape not in KERNEL_SHAPES[protocol]:
        raise NotImplementedError(
            f"K5 computes the observer planes at (2, 5, 8, 4) and (2, 5, 16, 4) only, not "
            f"{shape[:4]} (key {shape}): ROADMAP item 23, the rest of item 22; the plain tick "
            "computes them on the CPU"
        )
    if protocol == "multipaxos" and shape[:4] == (2, 5, 16, 4) and shape not in KERNEL_SHAPES[protocol]:
        raise NotImplementedError(
            f"K5 runs the long log's (2, 5, 16, 4) without the stamps and the arms only, not "
            f"key {shape}: ROADMAP item 23; the plain tick runs it on the CPU"
        )
    if shape not in KERNEL_SHAPES[protocol]:
        raise ValueError(
            f"the {protocol} CUDA kernel is instantiated for the shapes "
            f"{KERNEL_SHAPES[protocol]}, not {shape}: ROADMAP item 23 (the keys the card "
            "does not instantiate); the plain tick runs it on the CPU"
        )
    state.check_layout()
    n_inst = state.n_inst
    acc, prop, lane = (state.n_acc, n_inst), (state.n_prop, n_inst), (n_inst,)
    edge = (state.n_prop, state.n_acc, n_inst)
    for name, shape, dtype in (
        ("crash_start", acc, torch.int32), ("crash_end", acc, torch.int32),
        ("equivocate", acc, torch.bool), ("pcrash_start", prop, torch.int32),
        ("pcrash_end", prop, torch.int32), ("link_delay", edge, torch.int32),
        ("part_start", lane, torch.int32), ("part_end", lane, torch.int32),
        ("aside", acc, torch.bool), ("pside", prop, torch.bool), ("part_dir", lane, torch.int32),
        ("link_drop", edge, torch.int32), ("link_dup", edge, torch.int32),
        ("ptimeout", prop, torch.int32), ("pboff", prop, torch.int32),
    ):
        leaf = getattr(plan, name)
        if leaf is None:
            continue
        if leaf.shape != shape or leaf.dtype != dtype:
            raise ValueError(
                f"plan leaf {name} {tuple(leaf.shape)} {leaf.dtype}, expected {shape} {dtype}"
            )
    for name in optional_fields(cfg):
        if getattr(plan, name) is None:
            raise ValueError(f"the config's knobs need a plan with {name}")
    if cfg.stale_k > 0 and not state.snapshots:
        raise ValueError("stale_k > 0 needs a state with snapshot shadows (stale=True)")
    for leaf in state.leaves() + plan.leaves():
        if leaf.device != state.device or not leaf.is_contiguous():
            raise ValueError("state and plan must be contiguous on one CUDA device")


def warm_kernel(
    protocol: str, state: LaneState, seed: int, plan: FaultPlan, cfg: FaultConfig, block: int,
    ablate: frozenset = frozenset(),
) -> None:
    """Build (first use only), load and launch ``protocol``'s kernel (its
    ablated build where ``ablate`` names components) for 0 ticks on
    ``state``, which comes back as it was, so that a timed launch pays for
    none of it (the card loads a kernel's module at its first launch).
    CUDA tensors only; the wrapper's ``.launches`` is left as it is."""
    ablate = frozenset(ablate)
    fused_fns(protocol, ablate)  # the flags' checks
    _check_cuda_inputs(protocol, state, plan, cfg, ablate)
    _launch(protocol, state, seed, plan, cfg, 0, block, 0, False, ablate_defines(ablate))


def _fused_chunk(
    protocol: str, wrapper: Callable, state: LaneState, seed: int,
    plan: FaultPlan, cfg: FaultConfig, n_ticks: int, block: int, blk0: int,
    clamp_per_tick: bool, ablate: frozenset = frozenset(),
) -> LaneState:
    """One chunk of ``protocol``'s engine (without the components
    ``ablate`` names); a launch of the kernel adds one to
    ``wrapper.launches``, of an ablated build to
    ``wrapper.ablated_launches[ablate]``."""
    binding = BINDINGS[protocol]
    ablate = frozenset(ablate)
    apply_fn, mask_fn, _ = fused_fns(protocol, ablate)
    if not isinstance(state, binding.state_cls):
        raise TypeError(f"the {protocol} engine takes a {binding.state_cls.__name__}")
    check_supported(cfg, protocol)
    if state.n_inst % block:
        raise ValueError(f"block={block} does not divide n_inst={state.n_inst}")
    if state.device.type == "cpu":
        return reference_chunk(
            state, seed, plan, cfg, n_ticks, blk_id=blk0, block=block,
            clamp_per_tick=clamp_per_tick, apply_fn=apply_fn,
            mask_fn=mask_fn, ballot_limit=binding.ballot_limit,
        )
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    _check_cuda_inputs(protocol, state, plan, cfg, ablate)
    if n_ticks == 0:
        return state
    _launch(
        protocol, state, seed, plan, cfg, n_ticks, block, blk0, clamp_per_tick,
        ablate_defines(ablate),
    )
    if ablate:
        wrapper.ablated_launches[ablate] = wrapper.ablated_launches.get(ablate, 0) + 1
    else:
        wrapper.launches += 1
    state.tick.add_(n_ticks)  # every lane advanced by the same tick count
    return state


def _launch(
    protocol: str, state: LaneState, seed: int, plan: FaultPlan,
    cfg: FaultConfig, n_ticks: int, block: int, blk0: int,
    clamp_per_tick: bool, defines: tuple = (),
) -> None:
    """Launch ``protocol``'s kernel (the build ``defines`` name) on
    checked inputs, at the binding's geometry for the state's shape;
    raises if the launch fails or is refused."""
    binding = BINDINGS[protocol]
    fn = _entry(protocol, defines)
    leaves = state.protocol_leaves()
    ptrs = (ctypes.c_void_p * len(leaves))(*(t.data_ptr() for t in leaves))
    plan_ptrs = (ctypes.c_void_p * len(_PLAN_LEAVES))(*(
        None if getattr(plan, name) is None else getattr(plan, name).data_ptr()
        for name in _PLAN_LEAVES
    ))
    params = _kernel_params(
        cfg, state.n_inst, state.n_acc, block, n_ticks, seed, blk0,
        clamp_per_tick,
    )
    arr = (ctypes.c_longlong * len(params))(*params)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    shape = _launch_dims(binding, binding.kernel_shape(state, cfg))
    dims = (ctypes.c_int * len(shape))(*shape)
    extra = _obs_args(state, cfg) if binding.observed else ()
    with torch.cuda.device(state.device):
        rc = fn(
            dims, len(shape), ptrs, len(leaves), plan_ptrs,
            state.tick.data_ptr(), arr, len(params), stream, *extra,
        )
    if rc != 0:
        raise RuntimeError(f"{binding.kernel} launch failed: cudaError {rc}")


# The observer leaves an observed instantiation takes (``obs::Leaf`` in
# csrc/fused_common.cuh), in flatten order: (plane, field) each.
OBS_LEAVES = (
    ("telemetry", "counters"), ("telemetry", "ring"), ("telemetry", "cursor"),
    ("telemetry", "seq"), ("telemetry", "hist"), ("coverage", "bitmap"),
    ("coverage", "new_bits"), ("exposure", "injected"), ("exposure", "effective"),
    ("margin", "qslack_min"), ("margin", "near_split"), ("margin", "bal_gap_min"),
    ("margin", "promise_slack_min"), ("wload", "mode"), ("wload", "phase"), ("wload", "ring"),
    ("wload", "head"), ("wload", "depth"), ("wload", "depth_peak"), ("wload", "offered"),
    ("wload", "done"), ("wload", "shed"), ("wload", "hist"),
)


def _obs_args(state: LaneState, cfg: FaultConfig) -> tuple:
    """The observer arguments of a C entry with observed instantiations:
    the ``OBS_LEAVES`` pointers (null where a plane or part of it is off)
    and the sizes and flags ``obs::read_obs_args`` reads (ring depth,
    histogram bins, coverage words, the workload's cap, bins, period,
    burst, thresholds and diurnal step, telemetry's recover flags, the
    snapshot shadows); none for a state without planes."""
    if not state.planes:
        return None, 0, None, 0
    from paxos_tpu_torch.workload.generator import threshold_terms

    def leaf(plane, field):
        part = getattr(state, plane)
        x = None if part is None else getattr(part, field)
        return None if x is None else x.data_ptr()

    ptrs = (ctypes.c_void_p * len(OBS_LEAVES))(*(leaf(*pf) for pf in OBS_LEAVES))
    tel, cov, wl = state.telemetry, state.coverage, state.wload
    sizes = [
        0 if tel is None or tel.ring is None else tel.ring.shape[0],
        0 if tel is None or tel.hist is None else tel.hist.shape[0],
        0 if cov is None else cov.bitmap.shape[0],
    ]
    if wl is None:
        sizes += [0] * 7
    else:
        w = wl.cfg
        sizes += [w.queue_cap, w.hist_bins, w.period, w.burst_len, *threshold_terms(w)]
    sizes += [int(cfg.p_crash > 0.0), int(cfg.p_crash_prop > 0.0), int(state.snapshots)]
    params = (ctypes.c_longlong * len(sizes))(*sizes)
    return ptrs, len(OBS_LEAVES), params, len(sizes)


def _launch_dims(binding: Binding, shape: tuple) -> tuple:
    """The C entry point's ``dims``: the shape, then, where the kernel
    takes a launch geometry, the shared bytes a block of the binding's
    geometry for the shape (the shape fixes the rest)."""
    if binding.staging is None:
        return shape
    return shape + (binding.staging[shape].smem_bytes,)


def blocks_per_sm(protocol: str, shape: tuple) -> int:
    """Blocks of ``protocol``'s instantiation ``shape`` (at the binding's
    staging geometry) that one SM of the current CUDA device holds at once:
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the geometry's
    threads and shared bytes."""
    from paxos_tpu_torch.kernels import build

    binding = BINDINGS[protocol]
    if binding.staging is None:
        raise ValueError(f"the {protocol} kernel has no staging geometry")
    fn = getattr(build.load(binding.kernel), f"fused_{protocol}_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    full = _launch_dims(binding, tuple(shape))
    dims = (ctypes.c_int * len(full))(*full)
    out = ctypes.c_int(0)
    rc = fn(dims, len(full), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{binding.kernel} occupancy query failed: cudaError {rc}")
    return out.value


def _measure(
    protocol: str, defines: tuple, reader: str, n_out: int, state: LaneState, seed: int,
    plan: FaultPlan, cfg: FaultConfig, n_ticks: int, block: "int | None", blk0: int,
    clamp_per_tick: bool, ablate: frozenset = frozenset(),
) -> list:
    """One launch of ``protocol``'s measuring build ``defines`` (of its
    ablated build where ``ablate`` names components), which advances
    ``state`` in place exactly as the wrapper would, then its ``n_out``
    counters as its C ``reader`` returns (and clears) them.  CUDA tensors
    only; the wrapper's ``.launches`` is left as it is."""
    block = BINDINGS[protocol].block if block is None else block
    if state.device.type != "cuda":
        raise ValueError("a measuring build counts on the card: it needs a CUDA state")
    if not isinstance(state, BINDINGS[protocol].state_cls):
        raise TypeError(f"the {protocol} engine takes a {BINDINGS[protocol].state_cls.__name__}")
    fused_fns(protocol, frozenset(ablate))  # the flags' checks
    check_supported(cfg, protocol)
    _check_cuda_inputs(protocol, state, plan, cfg, ablate)
    defines = ablate_defines(frozenset(ablate)) + defines
    _launch(protocol, state, seed, plan, cfg, n_ticks, block, blk0, clamp_per_tick, defines)
    state.tick.add_(n_ticks)
    torch.cuda.synchronize(state.device)
    from paxos_tpu_torch.kernels import build

    read = getattr(build.load(BINDINGS[protocol].kernel, defines), reader)
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * n_out)()
    with torch.cuda.device(state.device):
        rc = read(out)
    if rc != 0:
        raise RuntimeError(f"reading {reader} failed: cudaError {rc}")
    return list(out)


def draw_census(
    protocol: str, state: LaneState, seed: int, plan: FaultPlan,
    cfg: FaultConfig, n_ticks: int, block: "int | None" = None, blk0: int = 0,
    clamp_per_tick: bool = False, ablate: frozenset = frozenset(),
) -> tuple:
    """(draws, slot touches): the counter-PRNG draws ``protocol``'s kernel
    makes over ``n_ticks`` ticks from ``state`` (the gray draws of K1 to
    K3's and K5's arms included: LINK_BITS where a flaky link sends,
    DUP_BITS where it delivers or selects, CORRUPT where an acceptor
    processes a request), and the state elements it touches: the slot-array
    elements Multi-Paxos reads or writes (the snapshot shadows of its log
    included), and every kernel's delay stamps of a stamped state (0 for an
    unstamped single-decree one, which counts none),
    summed over lanes and ticks: one launch of its measuring build
    (``_measure``).  The kernels draw a mask, and touch a slot, only where
    the outcome depends on it, so these are the PRNG and slot work the data
    needs.  ``block`` defaults to the protocol's; ``ablate``: the counts of
    the kernel's ablated build (its measuring build with the same
    components removed)."""
    draws, touches = _measure(
        protocol, COUNT_DRAWS, "fused_draws", 2, state, seed, plan, cfg, n_ticks, block, blk0,
        clamp_per_tick, ablate,
    )
    return draws, touches


def phase_clocks(
    protocol: str, state: LaneState, seed: int, plan: FaultPlan,
    cfg: FaultConfig, n_ticks: int, block: "int | None" = None, blk0: int = 0,
    clamp_per_tick: bool = False,
) -> dict:
    """Where a lane's cycles go: ``clock64()`` cycles per phase of the tick
    (``PHASES[protocol]``, in the tick's order), summed over lanes and over
    ``n_ticks`` ticks from ``state``, from one launch of the kernel's
    phase-clock build (``_measure``).  A lane's cycles include the time the
    SM gives other warps, so the split says where a lane waits, not what
    the SM executes."""
    phases = PHASES.get(protocol)
    if phases is None:
        raise ValueError(f"the {protocol} kernel has no phase-clock build (PHASES: {sorted(PHASES)})")
    cycles = _measure(
        protocol, PHASE_CLOCKS, "fused_phase_clocks", PHASE_SLOTS, state, seed, plan, cfg,
        n_ticks, block, blk0, clamp_per_tick,
    )
    if any(cycles[len(phases):]):
        raise RuntimeError(f"the {protocol} kernel clocked phases past its {len(phases)}")
    return dict(zip(phases, cycles[:len(phases)], strict=True))


def fused_paxos_chunk(
    state: PaxosState, seed: int, plan: FaultPlan, cfg: FaultConfig,
    n_ticks: int, block: int = DEFAULT_BLOCK, blk0: int = 0,
    clamp_per_tick: bool = False, ablate: frozenset = frozenset(),
) -> PaxosState:
    """Advance ``n_ticks`` ticks of Paxos; ``block`` is the stream block and
    ``blk0`` the id of the first.

    CUDA: launches ``csrc/fused_paxos_tick.cu`` on the current stream, at
    the geometry ``FR_STAGING["paxos"]`` gives the state's shape, updating
    the state's tensors in place (the input state is consumed) and
    returning it; ``.launches`` counts the launches (``.ablated_launches``
    those of each ablated build); a launch the card
    refuses raises.  A config with a gray-failure or partition knob on runs
    the kernel's arms instantiation (:func:`gray_arms`), on a plan with the
    leaves its knobs need; so do Fast Paxos, Raft-core, SynchPaxos and
    Multi-Paxos.  A state with delay stamps runs a stamped instantiation,
    and ``p_delay > 0`` needs a plan with ``link_delay``; so do the other
    four.  A state that carries an observer plane runs an observed
    instantiation, which computes every plane the state carries; so do the
    other four.  ``ablate`` (``ABLATE_FLAGS``) runs the kernel's ablated
    build, which removes those components of the tick, at config2's key
    only (``ABLATE_KEYS``; any other raises): it is not the protocol, and
    is for timing against the full kernel (``scripts/ablate_fused.py``).
    CPU: the plain :func:`reference_chunk` (ablated: :func:`fused_fns`'
    tick).  There is no fallback between the two: the device of the state
    decides."""
    return _fused_chunk(
        "paxos", fused_paxos_chunk, state, seed, plan, cfg, n_ticks, block,
        blk0, clamp_per_tick, ablate,
    )


fused_paxos_chunk.launches = 0
fused_paxos_chunk.ablated_launches = {}  # frozenset of flags: launches of that build


def fused_fastpaxos_chunk(
    state: FastPaxosState, seed: int, plan: FaultPlan, cfg: FaultConfig,
    n_ticks: int, block: int = DEFAULT_BLOCK, blk0: int = 0,
    clamp_per_tick: bool = False,
) -> FastPaxosState:
    """:func:`fused_paxos_chunk` for Fast Paxos (``csrc/fused_fastpaxos_tick.cu``,
    at the geometry ``FR_STAGING["fastpaxos"]`` gives the state's shape; a
    launch the card refuses raises)."""
    return _fused_chunk(
        "fastpaxos", fused_fastpaxos_chunk, state, seed, plan, cfg, n_ticks,
        block, blk0, clamp_per_tick,
    )


fused_fastpaxos_chunk.launches = 0


def fused_raftcore_chunk(
    state: RaftState, seed: int, plan: FaultPlan, cfg: FaultConfig,
    n_ticks: int, block: int = DEFAULT_BLOCK, blk0: int = 0,
    clamp_per_tick: bool = False,
) -> RaftState:
    """:func:`fused_paxos_chunk` for Raft-core (``csrc/fused_raftcore_tick.cu``,
    at the geometry ``FR_STAGING["raftcore"]`` gives the state's shape; a
    launch the card refuses raises)."""
    return _fused_chunk(
        "raftcore", fused_raftcore_chunk, state, seed, plan, cfg, n_ticks,
        block, blk0, clamp_per_tick,
    )


fused_raftcore_chunk.launches = 0


def fused_multipaxos_chunk(
    state: MultiPaxosState, seed: int, plan: FaultPlan, cfg: FaultConfig,
    n_ticks: int, block: int = BINDINGS["multipaxos"].block, blk0: int = 0,
    clamp_per_tick: bool = False, ablate: frozenset = frozenset(),
) -> MultiPaxosState:
    """:func:`fused_paxos_chunk` for Multi-Paxos
    (``csrc/fused_multipaxos_tick.cu``, at the geometry ``MP_STAGING``
    gives the state's shape; a launch the card refuses raises); the
    default stream block is the reference's 256, and the per-tick clamp
    pins ballots at 2047.  A gray-failure or partition knob, or a state
    with delay stamps, runs its instantiation at config3's shape only, and
    a state with an observer plane at config3's or config3-long's; any
    other shape raises (ROADMAP item 23).  ``ablate`` runs the ablated
    build at config3's key only."""
    return _fused_chunk(
        "multipaxos", fused_multipaxos_chunk, state, seed, plan, cfg, n_ticks,
        block, blk0, clamp_per_tick, ablate,
    )


fused_multipaxos_chunk.launches = 0
fused_multipaxos_chunk.ablated_launches = {}


def fused_synchpaxos_chunk(
    state: SynchPaxosState, seed: int, plan: FaultPlan, cfg: FaultConfig,
    n_ticks: int, block: int = DEFAULT_BLOCK, blk0: int = 0,
    clamp_per_tick: bool = False,
) -> SynchPaxosState:
    """:func:`fused_paxos_chunk` for SynchPaxos
    (``csrc/fused_synchpaxos_tick.cu``, at the geometry ``SP_STAGING``
    gives the state's shape; a launch the card refuses raises), on a state
    with or without delay stamps; ``p_delay > 0`` needs a plan with
    ``link_delay``.  A gray-failure or partition knob runs an arms
    instantiation at ``(2, 5, 8)``, stamped or not, and so does an observer
    plane its observed one."""
    return _fused_chunk(
        "synchpaxos", fused_synchpaxos_chunk, state, seed, plan, cfg, n_ticks,
        block, blk0, clamp_per_tick,
    )


fused_synchpaxos_chunk.launches = 0

FUSED_WRAPPERS = {
    "paxos": fused_paxos_chunk,
    "fastpaxos": fused_fastpaxos_chunk,
    "raftcore": fused_raftcore_chunk,
    "synchpaxos": fused_synchpaxos_chunk,
    "multipaxos": fused_multipaxos_chunk,
}


def _make_chunk(protocol: str) -> Callable:
    wrapper = FUSED_WRAPPERS[protocol]
    binding = BINDINGS[protocol]

    def chunk(
        state: LaneState, seed: int, plan: FaultPlan, cfg: FaultConfig,
        n_ticks: int,
    ) -> LaneState:
        block = fit_block(binding.block, state.n_inst)
        hoisted = n_ticks <= ballot_hoist_safe_ticks(protocol)
        state = saturate_ballots(state, binding.ballot_limit)
        state = wrapper(
            state, seed, plan, cfg, n_ticks, block=block,
            clamp_per_tick=not hoisted,
        )
        return saturate_ballots(state, binding.ballot_limit) if hoisted else state

    chunk.__name__ = f"{protocol}_chunk"
    chunk.__doc__ = (
        f"{protocol} on the fused engine: the chunk function both devices "
        f"share.  The stream block is {binding.block}, degraded by "
        ":func:`fit_block` where it does not divide ``n_inst``.  Ballots "
        f"are clamped at {binding.ballot_limit} at chunk entry and exit; a "
        f"chunk longer than {ballot_hoist_safe_ticks(protocol)} ticks "
        "clamps after every tick instead, as the reference's packed engine "
        "does."
    )
    return chunk


FUSED_CHUNKS = {protocol: _make_chunk(protocol) for protocol in FUSED_WRAPPERS}
paxos_chunk = FUSED_CHUNKS["paxos"]
