"""Fused multi-tick engine (counterpart of ``paxos_tpu/kernels/fused_tick.py``).

:func:`fused_paxos_chunk` advances every instance ``n_ticks`` ticks of
``counter_masks`` + ``apply_tick``.  On a CUDA tensor it launches the
hand-written kernel ``csrc/fused_paxos_tick.cu`` (one thread per instance,
state resident in registers for the whole chunk, updated in place) or
raises; on a CPU tensor it runs :func:`reference_chunk`, the plain PyTorch
version.  :func:`paxos_chunk` is the engine's chunk function, as
``_make_chunk`` is in the reference: it clamps ballots at the chunk
boundaries and switches to a per-tick clamp for very long chunks.

Streams: per-tick masks are keyed by (seed, tick, stream block id), with
``block`` lanes per stream block (default 1024, the reference's default),
so a campaign replays bit for bit across the two packages.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from paxos_tpu_torch.core.state import PaxosState
from paxos_tpu_torch.faults.injector import FaultConfig, FaultPlan
from paxos_tpu_torch.kernels import counter_prng as cp
from paxos_tpu_torch.protocols.paxos import apply_tick, check_supported, counter_masks

DEFAULT_BLOCK = 1024

# Worst-case proposer.bal growth per tick: make_ballot(round + 1, pid) moves
# a ballot by less than 2 * MAX_PROPOSERS.
BALLOT_GROWTH_PER_TICK = 16

# Width of the reference's packed proposer.bal field (core/state.py
# PAXOS_LAYOUT): the boundary-only clamp is exact only while a chunk cannot
# grow a ballot past it, so the switch point stays the reference's.
PROPOSER_BAL_BITS = 17

# (n_prop, n_acc, k_slots) shapes the CUDA kernel is instantiated for:
# config2/config4 and config1.
KERNEL_SHAPES = ((2, 5, 8), (1, 3, 8))

# The report-time ``max_ballot >= limit`` threshold of single-decree Paxos.
REPORT_BALLOT_LIMIT = (1 << 15) - 1


def fit_block(block: int, n: int) -> int:
    """A stream block that divides ``n``: the request if it does, else the
    largest power of two <= the request that divides ``n``.

    Every dividing block passes verbatim, as in the reference's interpret
    mode (block floor 1), which recorded the golden digests."""
    if n % block == 0:
        return block
    b = min(block, n & -n)  # n & -n: largest power-of-two divisor of n
    return 1 << (b.bit_length() - 1)


def ballot_hoist_safe_ticks() -> int:
    """Largest chunk for which the boundary-only ballot clamp matches the
    reference's packed engine: (2^17 - 1 - (2^15 - 1)) // 16 = 6144."""
    headroom = (1 << PROPOSER_BAL_BITS) - 1 - REPORT_BALLOT_LIMIT
    return headroom // BALLOT_GROWTH_PER_TICK


def saturate_ballots(state: PaxosState) -> PaxosState:
    """Pin ``proposer.bal`` at the report-time ballot limit (sticky, since
    ballots are monotone), so an overflowed campaign reads exactly the
    limit and the report's guard fires."""
    prop = dataclasses.replace(
        state.proposer, bal=torch.clamp(state.proposer.bal, max=REPORT_BALLOT_LIMIT)
    )
    return dataclasses.replace(state, proposer=prop)


def reference_chunk(
    state: PaxosState,
    seed: int,
    plan: FaultPlan,
    cfg: FaultConfig,
    n_ticks: int,
    blk_id: int = 0,
    block: "int | None" = None,
    clamp_per_tick: bool = False,
) -> PaxosState:
    """The plain version: ``n_ticks`` ticks of the fused stream, unclamped
    by default like the reference's ``reference_chunk``.

    ``block`` lanes form one stream block (default: all lanes, one block
    with id ``blk_id``); lane ``i`` draws under block id
    ``blk_id + i // block``, all blocks in one vectorised pass."""
    n_inst = state.n_inst
    block = n_inst if block is None else block
    for _ in range(n_ticks):
        seeds = cp.lane_seeds(seed, state.tick, blk_id, n_inst, block)
        masks = counter_masks(cfg, seeds, state, block=block)
        state = apply_tick(state, masks, plan, cfg)
        if clamp_per_tick:
            state = saturate_ballots(state)
    return state


# ---- The CUDA kernel -------------------------------------------------------

_KERNEL = "fused_paxos_tick"
_lib = None


def _library():
    """Build (first use only) and bind the kernel's C entry point."""
    global _lib
    if _lib is None:
        from paxos_tpu_torch.kernels import build

        lib = build.load(_KERNEL)
        fn = lib.fused_paxos_launch
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _knob(p: float) -> tuple:
    """(mode, uint32 threshold) of a Bernoulli knob: 0 off, 1 draw, 2 always."""
    if p <= 0.0:
        return 0, 0
    if p >= 1.0:
        return 2, 0
    return 1, cp.bern_threshold(p)


def _kernel_params(
    cfg: FaultConfig, n_inst: int, n_acc: int, block: int, n_ticks: int,
    seed: int, blk0: int, clamp_per_tick: bool,
) -> list:
    """The kernel's integer parameters, in the C entry point's order."""
    from paxos_tpu_torch.kernels.quorum import majority

    quorum = majority(n_acc)
    return [
        n_inst, block, n_ticks, int(seed) & cp.M32, blk0, int(clamp_per_tick),
        cfg.timeout, max(cfg.backoff_max, 1), cfg.ballot_stride,
        cfg.q1 or quorum, cfg.q2 or quorum,
        *_knob(cfg.p_idle), *_knob(cfg.p_hold), *_knob(cfg.p_dup),
        *_knob(cfg.p_drop),
    ]


def _check_cuda_inputs(state: PaxosState, plan: FaultPlan) -> None:
    shape = (state.n_prop, state.n_acc, state.k_slots)
    if shape not in KERNEL_SHAPES:
        raise ValueError(
            f"the CUDA kernel is instantiated for (n_prop, n_acc, k_slots) in "
            f"{KERNEL_SHAPES}, not {shape}"
        )
    state.check_layout()
    acc = (state.n_acc, state.n_inst)
    for leaf, dtype in (
        (plan.crash_start, torch.int32), (plan.crash_end, torch.int32),
        (plan.equivocate, torch.bool),
    ):
        if leaf.shape != acc or leaf.dtype != dtype:
            raise ValueError(f"plan leaf {tuple(leaf.shape)} {leaf.dtype}, expected {acc} {dtype}")
    for leaf in state.leaves() + plan.leaves():
        if leaf.device != state.device or not leaf.is_contiguous():
            raise ValueError("state and plan must be contiguous on one CUDA device")


def fused_paxos_chunk(
    state: PaxosState,
    seed: int,
    plan: FaultPlan,
    cfg: FaultConfig,
    n_ticks: int,
    block: int = DEFAULT_BLOCK,
    blk0: int = 0,
    clamp_per_tick: bool = False,
) -> PaxosState:
    """Advance ``n_ticks`` ticks; ``block`` is the stream block.

    CUDA: launches the kernel on the current stream, updating the state's
    tensors in place (the input state is consumed) and returning it.  CPU:
    the plain :func:`reference_chunk`.  There is no fallback between the
    two: the device of the state decides."""
    check_supported(cfg)
    if state.n_inst % block:
        raise ValueError(f"block={block} does not divide n_inst={state.n_inst}")
    if state.device.type == "cpu":
        return reference_chunk(
            state, seed, plan, cfg, n_ticks, blk_id=blk0, block=block,
            clamp_per_tick=clamp_per_tick,
        )
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    _check_cuda_inputs(state, plan)
    if n_ticks == 0:
        return state
    fn = _library().fused_paxos_launch
    leaves = state.leaves()[:-1]
    ptrs = (ctypes.c_void_p * len(leaves))(*(t.data_ptr() for t in leaves))
    plan_ptrs = (ctypes.c_void_p * 3)(
        plan.crash_start.data_ptr(), plan.crash_end.data_ptr(),
        plan.equivocate.data_ptr(),
    )
    params = _kernel_params(
        cfg, state.n_inst, state.n_acc, block, n_ticks, seed, blk0,
        clamp_per_tick,
    )
    arr = (ctypes.c_longlong * len(params))(*params)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    with torch.cuda.device(state.device):
        rc = fn(
            state.n_prop, state.n_acc, state.k_slots, ptrs, len(leaves),
            plan_ptrs, state.tick.data_ptr(), arr, len(params), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_paxos_tick launch failed: cudaError {rc}")
    fused_paxos_chunk.launches += 1
    state.tick.add_(n_ticks)  # every lane advanced by the same tick count
    return state


fused_paxos_chunk.launches = 0


def paxos_chunk(
    state: PaxosState,
    seed: int,
    plan: FaultPlan,
    cfg: FaultConfig,
    n_ticks: int,
) -> PaxosState:
    """paxos on the fused engine: the chunk function both devices share.

    The stream block is :data:`DEFAULT_BLOCK`, degraded by :func:`fit_block`
    where it does not divide ``n_inst``.  Ballots are clamped at chunk entry
    and exit; a chunk longer than :func:`ballot_hoist_safe_ticks` clamps
    after every tick instead, as the reference's packed engine does."""
    block = fit_block(DEFAULT_BLOCK, state.n_inst)
    hoisted = n_ticks <= ballot_hoist_safe_ticks()
    state = saturate_ballots(state)
    state = fused_paxos_chunk(
        state, seed, plan, cfg, n_ticks, block=block,
        clamp_per_tick=not hoisted,
    )
    return saturate_ballots(state) if hoisted else state


FUSED_CHUNKS = {"paxos": paxos_chunk}
