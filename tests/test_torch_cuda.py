"""The fused kernels (K1 to K5) against their plain versions on the card.

These tests need a CUDA GPU and skip without one; this module imports
nothing of JAX, so it runs on a machine that has only the port's stack:

    PAXOS_TPU_REAL=1 python -m pytest tests/test_torch_cuda.py tests/test_torch_ceiling.py -m cuda

(``PAXOS_TPU_REAL=1`` keeps tests/conftest.py from importing JAX.)  Each
kernel must equal its plain version byte for byte (tolerance 0: the state
is all int32/bool) from its main configuration, from its second
instantiated shape, and from near-limit ballots under the per-tick clamp
with a nonzero block offset, and must reproduce the golden digest.  K5
(Multi-Paxos) is held so at every instantiation: config3 with crash
windows, three acceptors with equivocators, long-log windows of 4 and 16
slots compacted between chunks, near-limit ballots clamped at 2047, and
on lane counts no CUDA block divides; a shared-memory request the card
refuses raises.
K4 (SynchPaxos) is held so with and without delay stamps, with delta
violated and the planted bug, with duplicates, uneven quorums and a ballot
stride, at three acceptors, under the clamp and on lane counts no CUDA
block divides; its geometry holds 12 warps an SM, a shared-memory request
the card refuses raises, and its phase-clock build advances the state as
the kernel does.  K2 and K3 (Fast Paxos, Raft-core), which keep their
payloads and learner table in a shared-memory column too, are held so on
duplicates and a ballot stride (Fast Paxos also on uneven quorums), at
every instantiation on lane counts no CUDA block divides, with the same
geometry, refusal and phase-clock checks, and so is K1 (Paxos), which
keeps its payloads and learner table in the same column, on duplicates, a
ballot stride with a shorter timeout and uneven quorums.  The arms
instantiations of K1 to K4 are held so on every gray-failure and
partition knob alone and on the configs that set them
(``gray_knob_configs``; K2 to K4 also on every knob at once, K4's with its
stamps), and give the gray-chaos main paths' block-0 digests; so is K5's,
on config3's cell, on every knob at once and on the JAX package's own two
cases, and K5 on the knobs its main paths leave at their defaults (p_dup,
q1/q2, a ballot stride).  The stamped instantiations of K1, K2, K3 and
K5 (their bounded-delay channel) are held so on ``delay_knob_configs`` and
give the delay-chaos main paths' block-0 digests.  A plan without
``link_delay`` under ``p_delay > 0``, a stamped state on an unstamped
instantiation and p_delay on an unstamped one are refused by K1 to K5
(K4: the first), and K5 refuses a stamped state at a shape other than
(2,5,8,4); K1 to K5 refuse a gray knob that reaches an instantiation
without its arms, an arms instantiation without a knob, and stale_k on a
state without snapshot shadows; K5 a gray config at a shape without its
arms (config_gray_chaos's own 8-row learner table).  K1's observed
instantiations (every observer plane on) are held so, observer leaves
included, on config2, config_gray_chaos, config_corrupt,
config_delay_chaos and every gray knob with p_delay, and leave the
protocol state as the planes-off kernel does; K1 refuses observer
arguments that do not fit.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    BLOCK0_DIGESTS,
    GOLDENS,
    MAIN_PATHS,
    MASK_CENSUS,
    GRAY_ALL,
    MP_GOLDEN,
    SLOT_CENSUS,
    SP_GOLDEN,
    STAMP_CENSUS,
    config_plan,
    delay_knob_configs,
    fault_plan,
    fr_knob_configs,
    gray_knob_configs,
    main_config,
    main_plan,
    mp_knob_configs,
    near_limit_state,
    near_limit_state_mp,
    path_state,
    plain_chunk,
    settled_lanes,
    sp_checker_config,
    sp_delay_off_config,
    sp_knob_configs,
    with_planes,
    without_planes,
)
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.obs.coverage import CoverageConfig, _hash_pos, digest_tree, lane_digest
from paxos_tpu_torch.protocols.multipaxos import compact_mp_body
from paxos_tpu_torch.protocols.paxos import ABLATE_FLAGS

LIMIT = (1 << 15) - 1
PROTOCOLS = ["paxos", "fastpaxos", "raftcore"]


def _second_shape(protocol, n, seed):
    if protocol == "paxos":
        return TC.config1_no_faults(n, seed)  # (1, 3, 8)
    return dataclasses.replace(main_config(protocol, n, seed), n_acc=3)  # (2, 3, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_kernel_matches_plain_on_cuda(protocol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    apply_fn = tfused.BINDINGS[protocol].apply_fn
    big, small = main_config(protocol, 8192, 7), _second_shape(protocol, 4096, 1)
    cases = (
        (big, 96, None, {}),
        (small, 64, None, {}),
        (big, 64, near_limit_state(big, 4094), dict(blk0=2, clamp_per_tick=True)),
    )
    for cfg, ticks, init, kw in cases:
        init = trun.init_state(cfg, "cuda") if init is None else init
        plan = trun.init_plan(cfg, "cuda")
        plain = tfused.reference_chunk(
            init, cfg.seed, plan, cfg.fault, ticks, block=1024, apply_fn=apply_fn,
            blk_id=kw.get("blk0", 0), clamp_per_tick=kw.get("clamp_per_tick", False),
        )
        before = wrapper.launches
        kern = wrapper(init.clone(), cfg.seed, plan, cfg.fault, ticks, block=1024, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        for a, b in zip(kern.leaves(), plain.leaves(), strict=True):
            assert torch.equal(a, b)
        if kw:
            assert int(kern.proposer.bal.max()) == LIMIT
    cfg = main_config(protocol, 256, 7)
    st = wrapper(trun.init_state(cfg, "cuda"), 7, trun.init_plan(cfg, "cuda"), cfg.fault, 32, block=256)
    h = hashlib.sha256()
    for leaf in st.leaves():
        h.update(leaf.cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == GOLDENS[protocol]


def _digest(state):
    h = hashlib.sha256()
    for leaf in state.leaves():
        h.update(leaf.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _assert_same(a, b):
    for x, y in zip(a.leaves(), b.leaves(), strict=True):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_multipaxos_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.fused_multipaxos_chunk
    cfg = main_config("config3", 8192, 7)
    eq3 = dataclasses.replace(cfg, n_acc=3, fault=dataclasses.replace(cfg.fault, p_equiv=0.3))
    cases = (
        (cfg, 160, None, {}),
        (eq3, 128, None, {}),
        (cfg, 96, near_limit_state_mp(cfg, 254), dict(blk0=2, clamp_per_tick=True)),
    )
    for c, ticks, init, kw in cases:
        init = trun.init_state(c, "cuda") if init is None else init
        plan = config_plan(c, c.seed + ticks)
        plain = plain_chunk(c, init, plan, ticks, 256, **kw)
        before = wrapper.launches
        kern = wrapper(init.clone(), c.seed, plan, c.fault, ticks, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _assert_same(kern, plain)
        if kw:
            assert int(kern.proposer.bal.max()) == 2047
    for window, log_total in ((4, 32), (16, 256)):
        c = TC.config3_long(4096, 2, log_total=log_total, window=window)
        plan = config_plan(c, 2)
        plain = trun.init_state(c, "cuda")
        kern = plain.clone()
        for _ in range(5):
            plain = compact_mp_body(plain_chunk(c, plain, plan, 48, 256))[0]
            kern = compact_mp_body(wrapper(kern, c.seed, plan, c.fault, 48))[0]
        _assert_same(kern, plain)
        assert int(kern.base.max()) > 0
    c = main_config("config3", 256, 7)
    st = wrapper(trun.init_state(c, "cuda"), 7, config_plan(c, 7), c.fault, 32)
    assert _digest(st) == MP_GOLDEN


def _mp_shape_config(shape, n, seed):
    """A Multi-Paxos config of K5's instantiation ``shape``: config3, three
    acceptors with equivocators, a long log through a 4- or 16-slot
    window, (the arms) the gray-chaos main path's config, or (the stamps)
    the delay-chaos one's, with the arms delay across a cut."""
    n_prop, n_acc, log_len, _, stamped, arms, observed = shape
    if observed:  # the same key's config with every observer plane on
        return with_planes(_mp_shape_config(shape[:6] + (0,), n, seed))
    if stamped:
        name = "delay across a cut" if arms else "config_delay_chaos"
        return delay_knob_configs(n, seed, "multipaxos")[name]
    if arms:
        return main_config("graychaos-multipaxos", n, seed)
    if log_len == 8:
        cfg = main_config("config3", n, seed)
        if n_acc == 3:
            cfg = dataclasses.replace(cfg, n_acc=3, fault=dataclasses.replace(cfg.fault, p_equiv=0.3))
        return cfg
    return TC.config3_long(n, seed, log_total=16 * log_len, window=log_len)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfused.KERNEL_SHAPES["multipaxos"])
def test_multipaxos_kernel_ragged_grid_on_cuda(shape):
    """K5 at every instantiation on 1000 lanes, which no CUDA block of its
    geometry divides (the last block runs part full), with a stream block
    of fit_block(256, 1000) = 8 lanes; long logs compacted between chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n = 1000
    assert n % tfused.MP_STAGING[shape].threads != 0
    cfg = _mp_shape_config(shape, n, 9)
    block = tfused.fit_block(256, n)
    plan = config_plan(cfg, 9)
    plain = path_state(cfg, "cuda")
    assert tfused.BINDINGS["multipaxos"].kernel_shape(plain, cfg.fault) == shape
    kern = plain.clone()
    long_log = cfg.fault.log_total > 0
    for _ in range(3):
        plain = plain_chunk(cfg, plain, plan, 64, block)
        kern = tfused.fused_multipaxos_chunk(kern, cfg.seed, plan, cfg.fault, 64, block=block)
        if long_log:
            plain, kern = compact_mp_body(plain)[0], compact_mp_body(kern)[0]
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    if long_log:
        assert int(kern.base.max()) > 0


@pytest.mark.cuda
def test_multipaxos_refused_launch_raises(monkeypatch):
    """A shared-memory request the card refuses (over 227 KB a block), or
    one too small for the staged rows, raises in the wrapper: the kernel
    never ran, the state is as it was, no launch is counted, and the next
    launch at the table's geometry runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cfg = main_config("config3", 1024, 3)
    plan = config_plan(cfg, 3)
    shape = (2, 5, 8, 4, 0, 0, 0)
    staging = tfused.MP_STAGING[shape]
    state = trun.init_state(cfg, "cuda")
    # advance once so that the refused launches would have something to change
    state = tfused.fused_multipaxos_chunk(state, cfg.seed, plan, cfg.fault, 16)
    before, launches = state.clone(), tfused.fused_multipaxos_chunk.launches
    for smem in (tfused.SMEM_PER_BLOCK_MAX + 1024, staging.smem_bytes - 4):
        monkeypatch.setitem(tfused.MP_STAGING, shape, dataclasses.replace(staging, smem_bytes=smem))
        with pytest.raises(RuntimeError, match="cudaError"):
            tfused.fused_multipaxos_chunk(state, cfg.seed, plan, cfg.fault, 16)
        torch.cuda.synchronize()
        _assert_same(state, before)
        assert tfused.fused_multipaxos_chunk.launches == launches
    monkeypatch.setitem(tfused.MP_STAGING, shape, staging)
    kern = tfused.fused_multipaxos_chunk(state, cfg.seed, plan, cfg.fault, 16)
    _assert_same(kern, plain_chunk(cfg, before, plan, 16, 256))


@pytest.mark.cuda
def test_multipaxos_geometry_fits_the_card():
    """Every geometry of K5 lets an SM hold 2 blocks: 8 warps (the most 255
    registers a thread allow) at 128 lanes a block (config3's observed
    column too, 212 words), 6 at 96 (the other observed columns, 241 to 281
    words), 4 at 64 (the long log's observed column, 404 words)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for shape, staging in tfused.MP_STAGING.items():
        assert tfused.blocks_per_sm("multipaxos", shape) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("path", PROTOCOLS + [
    "config3", "config3long", "delaychaos-paxos", "delaychaos-fastpaxos", "delaychaos-raftcore",
    "delaychaos-multipaxos",
])
def test_draw_census_build_follows_the_kernel(path):
    """The draw-counting build advances the state as the kernel does, counts
    no launch, draws at most every mask element of every tick, and touches
    slot arrays (Multi-Paxos) at most as often as the census rewrites them
    and delay stamps (the stamped instantiations) at most 4 * 2PA a
    lane-tick, the two summed on K5 with stamps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    mp = MAIN_PATHS[path]
    cfg = main_config(path, 8192, 5)
    plan, ticks = main_plan(cfg), 48
    plan = trun.init_plan(cfg, "cuda") if plan is None else plan
    wrapper = tfused.FUSED_WRAPPERS[mp.protocol]
    kern = wrapper(trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    before = wrapper.launches
    counted = trun.init_state(cfg, "cuda")
    draws, touches = tfused.draw_census(mp.protocol, counted, cfg.seed, plan, cfg.fault, ticks)
    assert wrapper.launches == before
    for a, b in zip(counted.leaves(), kern.leaves(), strict=True):
        assert torch.equal(a, b)
    lane_ticks = cfg.n_inst * ticks
    assert 0 < draws <= MASK_CENSUS[mp.census][1] * lane_ticks
    stamp_touches = 4 * 2 * cfg.n_prop * cfg.n_acc if mp.census in STAMP_CENSUS else 0
    if mp.protocol == "multipaxos":
        assert 0 < touches <= (SLOT_CENSUS[mp.census][1] + stamp_touches) * lane_ticks
    elif stamp_touches:
        assert 0 < touches <= stamp_touches * lane_ticks
    else:
        assert touches == 0  # the single-decree state sits in registers
    again = tfused.draw_census(mp.protocol, trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    assert again == (draws, touches)  # the counts are cleared after every read


@pytest.mark.cuda
def test_synchpaxos_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.fused_synchpaxos_chunk
    chaos = main_config("synchpaxos", 8192, 7)
    three = dataclasses.replace(main_config("synchpaxos", 4096, 3), n_acc=3)
    cases = (
        (chaos, 128, None, {}),  # (2,5,8) with stamps
        (TC.config_delay_chaos(4096, 4, violate_delta=True), 96, None, {}),
        (sp_checker_config(4096), 96, None, {}),
        (sp_delay_off_config(4096, 5), 96, None, {}),  # (2,5,8) without stamps
        (three, 96, None, {}),  # (2,3,8) with stamps
        (chaos, 64, near_limit_state(chaos, 4094), dict(blk0=2, clamp_per_tick=True)),
        # p_dup 0.2, q1/q2 = 2/4, ballot_stride 3 with backoff_max 3
        *((c, 96, None, {}) for c in sp_knob_configs(4096, 10).values()),
    )
    for c, ticks, init, kw in cases:
        init = trun.init_state(c, "cuda") if init is None else init
        assert init.stamped == int(c.fault.p_delay > 0)
        plan = main_plan(c) or trun.init_plan(c, "cuda")
        plain = plain_chunk(c, init, plan, ticks, 1024, **kw)
        before = wrapper.launches
        kern = wrapper(init.clone(), c.seed, plan, c.fault, ticks, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _assert_same(kern, plain)
        if kw:
            assert int(kern.proposer.bal.max()) == LIMIT
    c = main_config("synchpaxos", 256, 7)
    st = wrapper(trun.init_state(c, "cuda"), 7, config_plan(c, 7), c.fault, 32, block=256)
    assert _digest(st) == SP_GOLDEN


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfused.KERNEL_SHAPES["synchpaxos"])
def test_synchpaxos_kernel_ragged_grid_on_cuda(shape):
    """K4 at every instantiation on 1000 lanes, which no CUDA block of its
    geometry divides (the last block runs part full), with a stream block
    of fit_block(1024, 1000) = 8 lanes, over three chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n = 1000
    assert n % tfused.SP_STAGING[shape].threads != 0
    n_prop, n_acc, _, stamped, arms, observed = shape
    if arms:  # K4's arms: every knob at once with the stamps, else config_gray_chaos's
        name = "every gray knob, stamped" if stamped else "config_gray_chaos"
        cfg = gray_knob_configs(n, 9, "synchpaxos")[name]
    else:
        cfg = TC.config_delay_chaos(n, 9, violate_delta=True) if stamped else sp_delay_off_config(n, 9)
    cfg = dataclasses.replace(cfg, n_acc=n_acc)
    if observed:
        cfg = with_planes(cfg)
    block = tfused.fit_block(1024, n)
    plan = main_plan(cfg) or trun.init_plan(cfg, "cuda")
    plain = path_state(cfg, "cuda")
    assert tfused.BINDINGS["synchpaxos"].kernel_shape(plain, cfg.fault) == shape
    kern = plain.clone()
    for _ in range(3):
        plain = plain_chunk(cfg, plain, plan, 64, block)
        kern = tfused.fused_synchpaxos_chunk(kern, cfg.seed, plan, cfg.fault, 64, block=block)
    torch.cuda.synchronize()
    _assert_same(kern, plain)


@pytest.mark.cuda
def test_synchpaxos_refused_launch_raises(monkeypatch):
    """A shared-memory request the card refuses (over 227 KB a block), or
    one too small for K4's staged rows, raises in the wrapper: the kernel
    never ran, the state is as it was, no launch is counted, and the next
    launch at the table's geometry runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cfg = main_config("synchpaxos", 1024, 3)
    plan = main_plan(cfg)
    shape = (2, 5, 8, 1, 0, 0)
    staging = tfused.SP_STAGING[shape]
    state = tfused.fused_synchpaxos_chunk(trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, 16)
    before, launches = state.clone(), tfused.fused_synchpaxos_chunk.launches
    for smem in (tfused.SMEM_PER_BLOCK_MAX + 1024, staging.smem_bytes - 4):
        monkeypatch.setitem(tfused.SP_STAGING, shape, dataclasses.replace(staging, smem_bytes=smem))
        with pytest.raises(RuntimeError, match="cudaError"):
            tfused.fused_synchpaxos_chunk(state, cfg.seed, plan, cfg.fault, 16)
        torch.cuda.synchronize()
        _assert_same(state, before)
        assert tfused.fused_synchpaxos_chunk.launches == launches
    monkeypatch.setitem(tfused.SP_STAGING, shape, staging)
    kern = tfused.fused_synchpaxos_chunk(state, cfg.seed, plan, cfg.fault, 16)
    _assert_same(kern, plain_chunk(cfg, before, plan, 16, 1024))


@pytest.mark.cuda
def test_synchpaxos_geometry_fits_the_card():
    """Every geometry of K4 lets an SM hold the blocks its registers are
    capped for: 12 warps, 8 for the observed instantiations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for shape, staging in tfused.SP_STAGING.items():
        blocks = tfused.blocks_per_sm("synchpaxos", shape)
        assert blocks >= staging.min_blocks
        assert blocks * staging.threads // 32 >= staging.min_blocks * staging.threads // 32


@pytest.mark.cuda
def test_synchpaxos_phase_clocks_follow_the_kernel():
    """K4's phase-clock build advances the state as the kernel does,
    counts no launch, and splits a lane's cycles over every phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cfg = TC.config_delay_chaos(8192, 5, violate_delta=True)
    plan, ticks = main_plan(cfg), 48
    kern = tfused.fused_synchpaxos_chunk(trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    before = tfused.fused_synchpaxos_chunk.launches
    clocked = trun.init_state(cfg, "cuda")
    cycles = tfused.phase_clocks("synchpaxos", clocked, cfg.seed, plan, cfg.fault, ticks)
    assert tfused.fused_synchpaxos_chunk.launches == before
    _assert_same(clocked, kern)
    assert tuple(cycles) == tfused.PHASES["synchpaxos"]
    # The observers phase (K2's and K4's four: tfused.OBSERVER_SPLIT) runs in
    # the observed instantiations only.
    planes = ("observers",) + tfused.OBSERVER_SPLIT
    assert all((c == 0) if phase in planes else (c > 0) for phase, c in cycles.items())
    again = tfused.phase_clocks("synchpaxos", trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    assert sum(again.values()) < 2 * sum(cycles.values())  # cleared after every read


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_model():
    """K1 to K5 refuse a plan without link_delay under p_delay > 0, in the
    wrapper and in their C entry points (K4 and K1 on their main paths, K2,
    K3 and K5 on theirs); the C entries of K1, K2, K3 and K5 refuse p_delay
    on an unstamped instantiation and a stamped state on one; K5 a stamped
    state at a shape other than (2,5,8,4), in the wrapper (the long log's,
    naming ROADMAP item 23).  No refused launch changes the state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for path in ("synchpaxos", "delaychaos-paxos", "delaychaos-fastpaxos", "delaychaos-raftcore",
                 "delaychaos-multipaxos"):
        cfg = main_config(path, 1024, 1)
        protocol = MAIN_PATHS[path].protocol
        block = tfused.BINDINGS[protocol].block
        bare = tfused.FaultPlan.none(1024, 5, 2, device="cuda")
        with pytest.raises(ValueError, match="link_delay"):
            tfused.FUSED_WRAPPERS[protocol](trun.init_state(cfg, "cuda"), 1, bare, cfg.fault, 8)
        with pytest.raises(RuntimeError, match="cudaError"):
            tfused._launch(protocol, trun.init_state(cfg, "cuda"), 1, bare, cfg.fault, 8, block, 0, False)
    for path, plain_path in (("delaychaos-paxos", "paxos"), ("delaychaos-fastpaxos", "fastpaxos"),
                             ("delaychaos-raftcore", "raftcore"),
                             ("delaychaos-multipaxos", "config3")):
        cfg = main_config(path, 1024, 1)
        protocol = MAIN_PATHS[path].protocol
        block = tfused.BINDINGS[protocol].block
        plan = main_plan(cfg)
        unstamped = trun.init_state(main_config(plain_path, 1024, 1), "cuda")
        assert unstamped.stamped == 0
        before = unstamped.clone()
        with pytest.raises(RuntimeError, match="cudaError"):
            tfused._launch(protocol, unstamped, 1, plan, cfg.fault, 8, block, 0, False)
        _assert_same(unstamped, before)
        binding = tfused.BINDINGS[protocol]
        # A binding that keys a stamped state to the unstamped instantiation.
        fields = tuple("snapshots" if f == "stamped" else f for f in binding.shape_fields)
        tfused.BINDINGS[protocol] = dataclasses.replace(binding, shape_fields=fields)
        try:
            stamped = trun.init_state(cfg, "cuda")
            before = stamped.clone()
            assert tfused.BINDINGS[protocol].kernel_shape(stamped, cfg.fault)[-2:] == (0, 0)
            nodelay = dataclasses.replace(cfg.fault, p_delay=0.0)
            with pytest.raises(RuntimeError, match="cudaError"):
                tfused._launch(protocol, stamped, 1, plan, nodelay, 8, block, 0, False)
            _assert_same(stamped, before)
        finally:
            tfused.BINDINGS[protocol] = binding
    # (The long log's stamped key is one ROADMAP item 23 lists.)
    for other, error, match in ((dict(n_acc=3), ValueError, "instantiated"),
                                (dict(log_len=16), NotImplementedError, "item 23")):
        cfg = dataclasses.replace(main_config("delaychaos-multipaxos", 1024, 1), **other)
        state = trun.init_state(cfg, "cuda")
        assert state.stamped == 1
        with pytest.raises(error, match=match):
            tfused.fused_multipaxos_chunk(state, 1, config_plan(cfg, 1), cfg.fault, 8)


@pytest.mark.cuda
def test_synchpaxos_draw_census_build_follows_the_kernel():
    """K4's measuring build advances the state as the kernel does and
    counts its draws and its stamp touches (a refresh reads, a send writes,
    at most 4 * 2PA a lane-tick)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cfg = main_config("synchpaxos", 8192, 5)
    plan, ticks = main_plan(cfg), 48
    kern = tfused.fused_synchpaxos_chunk(trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    counted = trun.init_state(cfg, "cuda")
    draws, touches = tfused.draw_census("synchpaxos", counted, cfg.seed, plan, cfg.fault, ticks)
    _assert_same(counted, kern)
    lane_ticks = cfg.n_inst * ticks
    assert 0 < draws <= MASK_CENSUS[MAIN_PATHS["synchpaxos"].census][1] * lane_ticks
    assert 0 < touches <= 4 * 2 * cfg.n_prop * cfg.n_acc * lane_ticks


FR = ["paxos", "fastpaxos", "raftcore"]


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", FR)
def test_fr_kernel_matches_plain_on_knobs(protocol):
    """K1, K2 and K3 on the knobs no main path sets (``fr_knob_configs``):
    duplicated requests and replies, a ballot stride with a longer backoff
    (K1 also with timeout 5), for Paxos q1/q2 = 2/4 and 4/2 and for Fast
    Paxos q1/q2/q_fast = 4/2/4, over two chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    for cfg in fr_knob_configs(protocol, 4096, 10).values():
        plan = trun.init_plan(cfg, "cuda")
        plain = trun.init_state(cfg, "cuda")
        kern = plain.clone()
        for _ in range(2):
            plain = plain_chunk(cfg, plain, plan, 96, 1024)
            before = wrapper.launches
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, 96)
            assert wrapper.launches == before + 1
        torch.cuda.synchronize()
        _assert_same(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "protocol,shape", [(p, shape) for p in FR for shape in tfused.KERNEL_SHAPES[p]]
)
def test_fr_kernel_ragged_grid_on_cuda(protocol, shape):
    """K1, K2 and K3 at every instantiation on 1000 lanes, which no CUDA block of
    their geometry divides (the last block runs part full), with a stream
    block of fit_block(1024, 1000) = 8 lanes, crashes and equivocators,
    over three chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n = 1000
    assert n % tfused.FR_STAGING[protocol][shape].threads != 0
    n_prop, n_acc = shape[:2]
    cfg = dataclasses.replace(main_config(protocol, n, 9), n_prop=n_prop, n_acc=n_acc)
    stamped = shape[3] == 1  # the key: (P, A, K, stamped, arms, observed)
    arms = shape[4] == 1
    if stamped:  # the channel: config_delay_chaos, or every gray knob with p_delay
        name = "every gray knob, p_delay 0.4" if arms else "config_delay_chaos"
        cfg = dataclasses.replace(cfg, fault=delay_knob_configs(n, 9, protocol)[name].fault)
    elif arms:  # the arms: config_gray_chaos's knobs on this plan
        gray = gray_knob_configs(n, 9)["config_gray_chaos"].fault
        cfg = dataclasses.replace(cfg, fault=gray)
    if shape[5]:  # the observed instantiations: every plane on
        cfg = with_planes(cfg)
    block = tfused.fit_block(1024, n)
    plan = fault_plan(
        n, n_acc, n_prop, 0.2, 9, p_crash=0.2, p_delay=cfg.fault.p_delay,
        delay_max=cfg.fault.delay_max, gray=cfg.fault,
    )
    plain = path_state(cfg, "cuda")
    assert tfused.BINDINGS[protocol].kernel_shape(plain, cfg.fault) == shape
    kern = plain.clone()
    for _ in range(3):
        plain = plain_chunk(cfg, plain, plan, 64, block)
        kern = tfused.FUSED_WRAPPERS[protocol](kern, cfg.seed, plan, cfg.fault, 64, block=block)
    torch.cuda.synchronize()
    _assert_same(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", FR)
def test_fr_refused_launch_raises(protocol, monkeypatch):
    """A shared-memory request the card refuses (over 227 KB a block), or
    one too small for the staged rows, raises in the wrapper: the kernel
    never ran, the state is as it was, no launch is counted, and the next
    launch at the table's geometry runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    cfg = main_config(protocol, 1024, 3)
    plan = trun.init_plan(cfg, "cuda")
    table = tfused.FR_STAGING[protocol]
    shape = next(k for k in table if k[:3] == (2, 5, 8))  # K1's default (2, 5, 8, 0)
    staging = table[shape]
    state = wrapper(trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, 16)
    before, launches = state.clone(), wrapper.launches
    for smem in (tfused.SMEM_PER_BLOCK_MAX + 1024, staging.smem_bytes - 4):
        monkeypatch.setitem(table, shape, dataclasses.replace(staging, smem_bytes=smem))
        with pytest.raises(RuntimeError, match="cudaError"):
            wrapper(state, cfg.seed, plan, cfg.fault, 16)
        torch.cuda.synchronize()
        _assert_same(state, before)
        assert wrapper.launches == launches
    monkeypatch.setitem(table, shape, staging)
    kern = wrapper(state, cfg.seed, plan, cfg.fault, 16)
    _assert_same(kern, plain_chunk(cfg, before, plan, 16, 1024))


@pytest.mark.cuda
def test_fr_geometry_fits_the_card():
    """Every geometry of K1, K2 and K3 lets an SM hold the blocks its
    registers are capped for: 12 warps or more, 11 for K3's stamped
    column (11 blocks of 32 lanes), 8 for the observed ones (2 blocks of
    128 lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for protocol in FR:
        for shape, staging in tfused.FR_STAGING[protocol].items():
            blocks = tfused.blocks_per_sm(protocol, shape)
            warps = 8 if shape[5] else 11 if protocol == "raftcore" and shape[3] else 12
            assert blocks >= staging.min_blocks and blocks * staging.threads // 32 >= warps


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", FR)
def test_fr_phase_clocks_follow_the_kernel(protocol):
    """The phase-clock build of K1, K2 and K3 advances the state as the kernel
    does, counts no launch, and splits a lane's cycles over every phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    cfg = main_config(protocol, 8192, 5)
    plan, ticks = trun.init_plan(cfg, "cuda"), 48
    kern = wrapper(trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    before = wrapper.launches
    clocked = trun.init_state(cfg, "cuda")
    cycles = tfused.phase_clocks(protocol, clocked, cfg.seed, plan, cfg.fault, ticks)
    assert wrapper.launches == before
    _assert_same(clocked, kern)
    assert tuple(cycles) == tfused.PHASES[protocol]
    # The observers phase (K2's and K4's four: tfused.OBSERVER_SPLIT) runs in
    # the observed instantiations only.
    planes = ("observers",) + tfused.OBSERVER_SPLIT
    assert all((c == 0) if phase in planes else (c > 0) for phase, c in cycles.items())


@pytest.mark.cuda
def test_paxos_gray_arms_match_plain_on_cuda():
    """K1's arms instantiation against the plain tick on every gray-failure
    and partition knob alone (a two-way and a one-way partition, flaky
    links without and with duplication, timeout and backoff skew) and on
    config_gray_chaos, config_partition, config_corrupt, config_stale,
    amnesia and config_flex(4, 2) (the default instantiation), over two
    chunks on chip_smoke's numpy plans, and the gray-chaos block-0 digest
    after a whole campaign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.fused_paxos_chunk
    for name, cfg in gray_knob_configs(4096, 12).items():
        plan = config_plan(cfg, 12)
        plain = trun.init_state(cfg, "cuda")
        kern = plain.clone()
        for _ in range(2):
            plain = plain_chunk(cfg, plain, plan, 96, 1024)
            before = wrapper.launches
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, 96)
            assert wrapper.launches == before + 1, name
        torch.cuda.synchronize()
        _assert_same(kern, plain)
    cfg = main_config("graychaos")
    small = dataclasses.replace(cfg, n_inst=1024)
    full = main_plan(cfg)
    plan = tfused.FaultPlan(**{
        f.name: None if getattr(full, f.name) is None else getattr(full, f.name)[..., :1024].contiguous()
        for f in dataclasses.fields(full)
    })
    st = trun.init_state(small, "cuda")
    for _ in range(64):
        st = tfused.paxos_chunk(st, 0, plan, small.fault, 64)
    assert _digest(st) == BLOCK0_DIGESTS["graychaos"]


@pytest.mark.cuda
def test_kernels_refuse_gray_knobs_they_do_not_model():
    """K4 refuses, in its C entry, a gray knob on an instantiation without
    its arms (stamped or not), an arms instantiation with no knob on, and
    stale_k on a state without snapshot shadows (in the wrapper too), and
    a shape without an arms instantiation in the wrapper; K1 refuses the
    gray knobs in its C entry on its default instantiation, at a shape
    without an arms instantiation (the wrapper), and stale_k on a state
    without snapshot shadows (K2, K3 and K5 likewise:
    test_fr_arms_refuse_mismatched_launches,
    test_mp_arms_refuse_mismatched_launches).  No refused launch changes
    the state or counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    gray = gray_knob_configs(1024, 1)["config_gray_chaos"]
    sp_cases = gray_knob_configs(1024, 1, "synchpaxos")
    sp_binding, wrapper = tfused.BINDINGS["synchpaxos"], tfused.fused_synchpaxos_chunk
    launches = wrapper.launches
    for cfg, arms in (
        (sp_cases["config_gray_chaos"], 0), (sp_cases["every gray knob, stamped"], 0),
        (main_config("synchpaxos", 1024, 1), 1),
    ):
        state = trun.init_state(cfg, "cuda")
        before = state.clone()
        tfused.BINDINGS["synchpaxos"] = dataclasses.replace(sp_binding, arms=lambda f, arms=arms: arms)
        try:
            with pytest.raises(RuntimeError, match="cudaError"):
                tfused._launch("synchpaxos", state, 1, config_plan(cfg, 1), cfg.fault, 8, 1024, 0, False)
        finally:
            tfused.BINDINGS["synchpaxos"] = sp_binding
        torch.cuda.synchronize()
        _assert_same(state, before)
    stale = sp_cases["config_stale"]
    bare = trun.init_state(dataclasses.replace(stale, fault=gray.fault), "cuda")
    assert not bare.snapshots
    with pytest.raises(ValueError, match="snapshot"):
        wrapper(bare, 1, config_plan(stale, 1), stale.fault, 8)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfused._launch("synchpaxos", bare, 1, config_plan(stale, 1), stale.fault, 8, 1024, 0, False)
    three = dataclasses.replace(sp_cases["every gray knob, stamped"], n_acc=3)
    with pytest.raises(ValueError, match="instantiated"):
        wrapper(trun.init_state(three, "cuda"), 1, config_plan(three, 1), three.fault, 8)
    assert wrapper.launches == launches
    plan = config_plan(gray, 1)
    binding = tfused.BINDINGS["paxos"]
    tfused.BINDINGS["paxos"] = dataclasses.replace(binding, arms=lambda cfg: 0)
    try:
        with pytest.raises(RuntimeError, match="cudaError"):
            tfused._launch("paxos", trun.init_state(gray, "cuda"), 1, plan, gray.fault, 8, 1024, 0, False)
    finally:
        tfused.BINDINGS["paxos"] = binding
    small = dataclasses.replace(gray, n_prop=1, n_acc=3)
    with pytest.raises(ValueError, match="instantiated"):
        tfused.fused_paxos_chunk(trun.init_state(small, "cuda"), 1, config_plan(small, 1), small.fault, 8)
    stale = gray_knob_configs(1024, 1)["config_stale"]
    bare = trun.init_state(dataclasses.replace(stale, fault=gray.fault), "cuda")
    with pytest.raises(ValueError, match="snapshot"):
        tfused.fused_paxos_chunk(bare, 1, config_plan(stale, 1), stale.fault, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore"])
def test_fr_gray_arms_match_plain_on_cuda(protocol):
    """K2's and K3's arms instantiations against the plain tick on every
    gray-failure and partition knob alone (a two-way and a one-way
    partition, flaky links without and with duplication, timeout and
    backoff skew), on config_gray_chaos, config_partition, config_corrupt,
    config_stale (stale_k with crashes), amnesia and every knob at once,
    over two chunks on chip_smoke's numpy plans; and the gray-chaos main
    path's block-0 digest after a whole campaign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    for name, cfg in gray_knob_configs(4096, 12, protocol).items():
        plan = config_plan(cfg, 12)
        plain = trun.init_state(cfg, "cuda")
        assert tfused.BINDINGS[protocol].kernel_shape(plain, cfg.fault) == (2, 5, 8, 0, 1, 0), name
        kern = plain.clone()
        for _ in range(2):
            plain = plain_chunk(cfg, plain, plan, 96, 1024)
            before = wrapper.launches
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, 96)
            assert wrapper.launches == before + 1, name
        torch.cuda.synchronize()
        _assert_same(kern, plain)
    path = f"graychaos-{protocol}"
    cfg = main_config(path)
    small = dataclasses.replace(cfg, n_inst=1024)
    full = main_plan(cfg)
    plan = tfused.FaultPlan(**{
        f.name: None if getattr(full, f.name) is None else getattr(full, f.name)[..., :1024].contiguous()
        for f in dataclasses.fields(full)
    })
    st = trun.init_state(small, "cuda")
    for _ in range(64):
        st = tfused.FUSED_CHUNKS[protocol](st, 0, plan, small.fault, 64)
    assert _digest(st) == BLOCK0_DIGESTS[path]


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["paxos", "fastpaxos", "raftcore"])
def test_fr_arms_refuse_mismatched_launches(protocol):
    """K1, K2 and K3 refuse, in their C entries, a gray knob on an
    instantiation without its arms and an arms instantiation with no knob
    on; stale_k on a state without snapshot shadows in the wrapper and in
    the C entry; a shape without an arms instantiation in the wrapper.  No
    refused launch changes the state or counts.  The arms geometry holds 3
    blocks (12 warps) an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    gray = gray_knob_configs(1024, 1, protocol)["config_gray_chaos"]
    plain_cfg = dataclasses.replace(gray, fault=main_config(protocol, 1024, 1).fault)
    binding = tfused.BINDINGS[protocol]
    launches = wrapper.launches
    for cfg, arms in ((gray, 0), (plain_cfg, 1)):
        state = trun.init_state(cfg, "cuda")
        before = state.clone()
        tfused.BINDINGS[protocol] = dataclasses.replace(binding, arms=lambda f, arms=arms: arms)
        try:
            with pytest.raises(RuntimeError, match="cudaError"):
                tfused._launch(protocol, state, 1, config_plan(gray, 1), cfg.fault, 8, 1024, 0, False)
        finally:
            tfused.BINDINGS[protocol] = binding
        torch.cuda.synchronize()
        _assert_same(state, before)
    stale = gray_knob_configs(1024, 1, protocol)["config_stale"]
    bare = trun.init_state(dataclasses.replace(stale, fault=gray.fault), "cuda")
    assert not bare.snapshots
    with pytest.raises(ValueError, match="snapshot"):
        wrapper(bare, 1, config_plan(stale, 1), stale.fault, 8)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfused._launch(protocol, bare, 1, config_plan(stale, 1), stale.fault, 8, 1024, 0, False)
    small = dataclasses.replace(gray, n_acc=3) if protocol != "paxos" else dataclasses.replace(
        gray, n_prop=1, n_acc=3
    )
    with pytest.raises(ValueError, match="instantiated"):
        wrapper(trun.init_state(small, "cuda"), 1, config_plan(small, 1), small.fault, 8)
    assert wrapper.launches == launches
    arms_shape = (2, 5, 8, 0, 1, 0)
    staging = tfused.FR_STAGING[protocol][arms_shape]
    assert staging.min_blocks == 3
    assert tfused.blocks_per_sm(protocol, arms_shape) >= 3


def _waiting_stamps(state, seed):
    """``state`` at tick 1000 with random presence and stamps around it in
    its three buffers: some already passed, most a few ticks ahead, some
    more than 2^16 ticks ahead, some at the int32 limit."""
    rng = np.random.default_rng(seed)
    state.tick.fill_(1000)
    for buf in (state.requests, state.promises, state.accepted):
        shape = tuple(buf.until.shape)
        near = 1000 + rng.integers(-5, 12, shape)
        far = 1000 + rng.integers(1 << 16, 1 << 20, shape)
        until = np.where(rng.random(shape) < 0.05, far, near)
        until = np.where(rng.random(shape) < 0.02, (1 << 31) - 1, until)
        buf.until.copy_(torch.from_numpy(until.astype(np.int32)))
        buf.present.copy_(torch.from_numpy(rng.random(shape) < 0.5))
    return state


def _mp_launch_cases(cfg, key, waiting=False, block=256):
    """K5's instantiation ``key`` on ``cfg`` against the plain tick where a
    launch is short: three 1-tick launches, then a 0-tick launch that must
    leave the state as it was, from the initial state and after a 64-tick
    chunk; with ``waiting`` (a stamped key) also from a state whose stamps
    wait (:func:`_waiting_stamps`: the launch reads them, writes others and
    stores only those it wrote), over 64 ticks, one tick and 0 ticks, and
    over 64 ticks across the int32 wrap of the tick."""
    wrapper = tfused.fused_multipaxos_chunk
    plan = config_plan(cfg, cfg.seed)
    starts = [("init", trun.init_state(cfg, "cuda"))]
    starts.append(("after a chunk", wrapper(starts[0][1].clone(), cfg.seed, plan, cfg.fault, 64, block=block)))
    if waiting:
        starts.append(("waiting stamps", _waiting_stamps(trun.init_state(cfg, "cuda"), cfg.seed)))
        wrap = trun.init_state(cfg, "cuda")
        wrap.tick.fill_((1 << 31) - 40)
        starts.append(("across the int32 wrap", wrap))
    for name, start in starts:
        assert tfused.BINDINGS["multipaxos"].kernel_shape(start, cfg.fault) == key, name
        kern, plain = start.clone(), start.clone()
        for n_ticks in ((64, 1, 1) if waiting and name != "after a chunk" else (1, 1, 1)):
            plain = plain_chunk(cfg, plain, plan, n_ticks, block)
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, n_ticks, block=block)
            torch.cuda.synchronize()
            _assert_same(kern, plain)
        before = kern.clone()
        tfused._launch("multipaxos", kern, cfg.seed, plan, cfg.fault, 0, block, 0, False)
        torch.cuda.synchronize()
        _assert_same(kern, before)


@pytest.mark.cuda
def test_mp_gray_arms_match_plain_on_cuda():
    """K5's arms instantiation against the plain tick on every gray-failure
    and partition knob alone on config3's cell (a two-way and a one-way
    partition, flaky links without and with duplication, timeout and
    backoff skew), on config_gray_chaos's, config_partition's,
    config_corrupt's and config_stale's fault configs, amnesia and every
    knob at once, over two chunks on chip_smoke's numpy plans; on the JAX
    package's own cases (tests/test_gray.py: every knob with crash windows
    at 64 lanes, seed 5, 24 ticks in one stream block; flaky links at zero
    rates, 128 lanes, seed 9); 1-tick launches and a 0-tick launch, which
    must leave the state as it was, on the gray-chaos cell, and the arms
    with the stamps from a state whose stamps wait (_mp_launch_cases); and
    the gray-chaos main path's block-0 digest after a whole campaign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    _mp_launch_cases(main_config("graychaos-multipaxos", 4096, 17), (2, 5, 8, 4, 0, 1, 0))
    every = delay_knob_configs(4096, 17, "multipaxos")["every gray knob, p_delay 0.4"]
    _mp_launch_cases(every, (2, 5, 8, 4, 1, 1, 0), waiting=True)
    wrapper = tfused.fused_multipaxos_chunk
    cases = [(cfg, 96, 2, 256) for cfg in gray_knob_configs(4096, 12, "multipaxos").values()]
    every = main_config("config3", 64, 5)
    every = dataclasses.replace(every, fault=dataclasses.replace(every.fault, **GRAY_ALL))
    zero = main_config("config3", 128, 9)
    zero = dataclasses.replace(zero, fault=dataclasses.replace(
        zero.fault, p_drop=0.0, p_dup=0.0, p_flaky=0.5, flaky_drop=0.0, flaky_dup=0.0))
    cases += [(every, 24, 1, 64), (zero, 64, 1, 128)]
    for cfg, ticks, chunks, block in cases:
        plan = config_plan(cfg, cfg.seed)
        plain = trun.init_state(cfg, "cuda")
        assert tfused.BINDINGS["multipaxos"].kernel_shape(plain, cfg.fault) == (2, 5, 8, 4, 0, 1, 0)
        kern = plain.clone()
        for _ in range(chunks):
            plain = plain_chunk(cfg, plain, plan, ticks, block)
            before = wrapper.launches
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, ticks, block=block)
            assert wrapper.launches == before + 1
        torch.cuda.synchronize()
        _assert_same(kern, plain)
    cfg = main_config("graychaos-multipaxos")
    small = dataclasses.replace(cfg, n_inst=256)
    full = main_plan(cfg)
    plan = tfused.FaultPlan(**{
        f.name: None if getattr(full, f.name) is None else getattr(full, f.name)[..., :256].contiguous()
        for f in dataclasses.fields(full)
    })
    st = trun.init_state(small, "cuda")
    for _ in range(64):
        st = tfused.FUSED_CHUNKS["multipaxos"](st, 0, plan, small.fault, 64)
    assert _digest(st) == BLOCK0_DIGESTS["graychaos-multipaxos"]


@pytest.mark.cuda
def test_mp_arms_refuse_mismatched_launches():
    """K5 refuses, in its C entry, a gray knob on an instantiation without
    its arms and an arms instantiation with no knob on; stale_k on a state
    without snapshot shadows in the wrapper and in the C entry; and in the
    wrapper a gray config at a shape without an arms instantiation, such as
    config_gray_chaos's own 8-row learner table, which K5 does not pack:
    it raises, and runs no plain tick instead.  No refused launch changes
    the state or counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.fused_multipaxos_chunk
    gray = gray_knob_configs(1024, 1, "multipaxos")["config_gray_chaos"]
    plain_cfg = main_config("config3", 1024, 1)
    binding = tfused.BINDINGS["multipaxos"]
    launches = wrapper.launches
    for cfg, arms in ((gray, 0), (plain_cfg, 1)):
        state = trun.init_state(cfg, "cuda")
        before = state.clone()
        tfused.BINDINGS["multipaxos"] = dataclasses.replace(binding, arms=lambda f, arms=arms: arms)
        try:
            with pytest.raises(RuntimeError, match="cudaError"):
                tfused._launch("multipaxos", state, 1, config_plan(gray, 1), cfg.fault, 8, 256, 0, False)
        finally:
            tfused.BINDINGS["multipaxos"] = binding
        torch.cuda.synchronize()
        _assert_same(state, before)
    stale = gray_knob_configs(1024, 1, "multipaxos")["config_stale"]
    bare = trun.init_state(dataclasses.replace(stale, fault=gray.fault), "cuda")
    assert not bare.snapshots
    with pytest.raises(ValueError, match="snapshot"):
        wrapper(bare, 1, config_plan(stale, 1), stale.fault, 8)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfused._launch("multipaxos", bare, 1, config_plan(stale, 1), stale.fault, 8, 256, 0, False)
    for small in (
        dataclasses.replace(gray, n_acc=3),
        dataclasses.replace(gray, k_slots=8),
        dataclasses.replace(TC.config_gray_chaos(1024, 1), protocol="multipaxos"),
    ):
        state = trun.init_state(small, "cuda")
        before = state.clone()
        with pytest.raises(ValueError, match="instantiated"):
            wrapper(state, 1, config_plan(small, 1), small.fault, 8)
        _assert_same(state, before)
    assert wrapper.launches == launches
    assert tfused.blocks_per_sm("multipaxos", (2, 5, 8, 4, 0, 1, 0)) >= 2


@pytest.mark.cuda
def test_mp_knobs_match_plain_on_cuda():
    """K5 against the plain tick on the knobs no main path sets (ROADMAP
    C1): config3's cell without crash windows, with p_dup 0.2, with q1/q2
    2/4, and with ballot_stride 3, backoff_max 3 and timeout 5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for cfg in mp_knob_configs(4096, 10).values():
        plan = trun.init_plan(cfg, "cuda")
        plain = trun.init_state(cfg, "cuda")
        kern = plain.clone()
        for _ in range(2):
            plain = plain_chunk(cfg, plain, plan, 100, 256)
            kern = tfused.fused_multipaxos_chunk(kern, cfg.seed, plan, cfg.fault, 100)
        torch.cuda.synchronize()
        _assert_same(kern, plain)


def _block0_digest(path, n, chunks=64):
    """Stream block 0 of main path ``path`` on its kernel: the first ``n``
    lanes of its config and its plan, over ``chunks`` chunks of 64 ticks
    through the engine's chunk function."""
    protocol = MAIN_PATHS[path].protocol
    cfg = main_config(path)
    small = dataclasses.replace(cfg, n_inst=n)
    full = main_plan(cfg)
    plan = tfused.FaultPlan(**{
        f.name: None if getattr(full, f.name) is None else getattr(full, f.name)[..., :n].contiguous()
        for f in dataclasses.fields(full)
    })
    st = trun.init_state(small, "cuda")
    for _ in range(chunks):
        st = tfused.FUSED_CHUNKS[protocol](st, 0, plan, small.fault, 64)
    return _digest(st)


def _match_over_chunks(protocol, cases, ticks=96, chunks=2, block=1024):
    """Each config of ``cases`` (name: config) on ``protocol``'s kernel
    against the plain tick over ``chunks`` chunks on chip_smoke's numpy
    plan, ``block`` lanes a stream block, one launch counted a chunk;
    returns the instantiations run."""
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    shapes = set()
    for name, cfg in cases.items():
        plan = config_plan(cfg, cfg.seed)
        plain = trun.init_state(cfg, "cuda")
        shapes.add(tfused.BINDINGS[protocol].kernel_shape(plain, cfg.fault))
        kern = plain.clone()
        for _ in range(chunks):
            plain = plain_chunk(cfg, plain, plan, ticks, block)
            before = wrapper.launches
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, ticks, block=block)
            assert wrapper.launches == before + 1, name
        torch.cuda.synchronize()
        _assert_same(kern, plain)
    return shapes


@pytest.mark.cuda
def test_sp_gray_arms_match_plain_on_cuda():
    """K4's arms instantiations against the plain tick on every gray-failure
    and partition knob alone on config_delay_chaos's cell (unstamped), on
    config_gray_chaos's, config_partition's, config_corrupt's and
    config_stale's fault configs and amnesia, on every knob at once with the
    delay and on the delay across a cut in every lane (stamped), over two
    chunks on chip_smoke's numpy plans; and the graychaos-synchpaxos main
    path's block-0 digest after a whole campaign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    shapes = _match_over_chunks("synchpaxos", gray_knob_configs(4096, 12, "synchpaxos"))
    assert shapes == {(2, 5, 8, 0, 1, 0), (2, 5, 8, 1, 1, 0)}
    assert _block0_digest("graychaos-synchpaxos", 1024) == BLOCK0_DIGESTS["graychaos-synchpaxos"]


@pytest.mark.cuda
def test_paxos_delay_matches_plain_on_cuda():
    """K1's stamped instantiations (its bounded-delay channel) against the
    plain tick on config_delay_chaos in both delay regimes, delay with drops
    and duplicates, delay across a cut in every lane and every gray knob
    with p_delay 0.4 (the last two on the arms), over two chunks; the
    per-tick clamp with a block offset from near-limit ballots; and the
    delaychaos-paxos main path's block-0 digest after a whole campaign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    shapes = _match_over_chunks("paxos", delay_knob_configs(4096, 14))
    assert shapes == {(2, 5, 8, 1, 0, 0), (2, 5, 8, 1, 1, 0)}
    cfg = main_config("delaychaos-paxos", 4096, 13)
    plan = main_plan(cfg)
    init = near_limit_state(cfg, 4094)
    assert init.stamped == 1
    plain = plain_chunk(cfg, init, plan, 96, 1024, blk0=5, clamp_per_tick=True)
    kern = tfused.fused_paxos_chunk(init.clone(), cfg.seed, plan, cfg.fault, 96, blk0=5, clamp_per_tick=True)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    assert _block0_digest("delaychaos-paxos", 1024) == BLOCK0_DIGESTS["delaychaos-paxos"]


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore"])
def test_fr_delay_matches_plain_on_cuda(protocol):
    """K2's and K3's stamped instantiations (their bounded-delay channel)
    against the plain tick on config_delay_chaos in both delay regimes,
    delay with drops and duplicates, delay across a cut in every lane and
    every gray knob with p_delay 0.4 (the last two on the arms), over two
    chunks; the per-tick clamp with a block offset from near-limit ballots;
    and the delay-chaos main path's block-0 digest after a whole campaign.
    The stamped geometry holds the blocks its registers are capped for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    shapes = _match_over_chunks(protocol, delay_knob_configs(4096, 14, protocol))
    assert shapes == {(2, 5, 8, 1, 0, 0), (2, 5, 8, 1, 1, 0)}
    path = f"delaychaos-{protocol}"
    cfg = main_config(path, 4096, 13)
    plan = main_plan(cfg)
    init = near_limit_state(cfg, 4094)
    assert init.stamped == 1
    plain = plain_chunk(cfg, init, plan, 96, 1024, blk0=5, clamp_per_tick=True)
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    kern = wrapper(init.clone(), cfg.seed, plan, cfg.fault, 96, blk0=5, clamp_per_tick=True)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    assert _block0_digest(path, 1024) == BLOCK0_DIGESTS[path]
    for shape in ((2, 5, 8, 1, 0, 0), (2, 5, 8, 1, 1, 0)):
        staging = tfused.FR_STAGING[protocol][shape]
        assert tfused.blocks_per_sm(protocol, shape) >= staging.min_blocks


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["delaychaos-paxos", "delaychaos-fastpaxos", "delaychaos-raftcore", "synchpaxos"])
def test_stamped_kernels_match_plain_across_int32_wrap(path):
    """K1's to K4's stamped instantiations against the plain tick over two
    64-tick chunks from tick 2^31 - 40: at the tick where the int32 tick
    wraps to its least value, the plain tick's ``tick >= until`` turns
    every slot stamped before the wrap back to waiting, and the channel
    (sd::Channel) takes every slot's readiness anew there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cfg = main_config(path, 4096, 7)
    plan = main_plan(cfg) or config_plan(cfg, cfg.seed)
    wrapper = tfused.FUSED_WRAPPERS[MAIN_PATHS[path].protocol]
    kern = path_state(cfg, "cuda")
    assert kern.stamped == 1
    kern.tick.fill_((1 << 31) - 40)
    plain = kern.clone()
    for _ in range(2):
        plain = plain_chunk(cfg, plain, plan, 64, 1024)
        kern = wrapper(kern, cfg.seed, plan, cfg.fault, 64, block=1024)
        torch.cuda.synchronize()
        _assert_same(kern, plain)


@pytest.mark.cuda
def test_mp_delay_matches_plain_on_cuda():
    """K5's stamped instantiations against the plain tick on
    ``delay_knob_configs(n, seed, "multipaxos")`` (config3's cell with each
    case's fault config; the last two on the arms, every gray knob with the
    snapshot shadows too) over two chunks in stream blocks of 256; the
    per-tick clamp (2047) with a block offset from near-limit ballots;
    1-tick launches, a 0-tick launch that leaves the state as it was, a
    state whose stamps wait (some more than 2^16 ticks ahead) and ticks
    across the int32 wrap (_mp_launch_cases); and the delaychaos-multipaxos
    main path's block-0 digest after a whole campaign.  Its geometry holds
    2 blocks of 128 lanes an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    _mp_launch_cases(main_config("delaychaos-multipaxos", 4096, 17), (2, 5, 8, 4, 1, 0, 0),
                     waiting=True)
    cases = delay_knob_configs(4096, 14, "multipaxos")
    shapes = _match_over_chunks("multipaxos", cases, block=256)
    assert shapes == {(2, 5, 8, 4, 1, 0, 0), (2, 5, 8, 4, 1, 1, 0)}
    cfg = main_config("delaychaos-multipaxos", 4096, 13)
    plan = main_plan(cfg)
    init = near_limit_state_mp(cfg, 254)
    assert init.stamped == 1
    plain = plain_chunk(cfg, init, plan, 96, 256, blk0=5, clamp_per_tick=True)
    kern = tfused.fused_multipaxos_chunk(
        init.clone(), cfg.seed, plan, cfg.fault, 96, blk0=5, clamp_per_tick=True
    )
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    assert int(kern.proposer.bal.max()) == (1 << 11) - 1
    assert _block0_digest("delaychaos-multipaxos", 256) == BLOCK0_DIGESTS["delaychaos-multipaxos"]
    for shape in ((2, 5, 8, 4, 1, 0, 0), (2, 5, 8, 4, 1, 1, 0)):
        assert tfused.blocks_per_sm("multipaxos", shape) >= 2


@pytest.mark.cuda
def test_observed_paxos_matches_plain_on_cuda():
    """K1's observed instantiations (every observer plane on) against the
    plain tick, observer leaves included, over two chunks: config2
    (2,5,8,0,0,1), config_gray_chaos and config_corrupt (2,5,8,0,1,1),
    config_delay_chaos (2,5,8,1,0,1) and every gray knob with p_delay
    (2,5,8,1,1,1); the planes-off kernel from the same state gives the same
    protocol state; 1-tick launches, 0-tick launches that leave the state
    as it was, and launches in which lanes settle partway (the coverage
    insert in flight across the switch to the settled ticks) equal the
    plain tick on config2; each phase of the phase-clock build runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n = 4096
    cases = {
        "config2": main_config("paxos", n, 21),
        "config_gray_chaos": gray_knob_configs(n, 21)["config_gray_chaos"],
        "config_corrupt": gray_knob_configs(n, 21)["config_corrupt"],
        "config_delay_chaos": delay_knob_configs(n, 21)["config_delay_chaos"],
        "every gray knob, p_delay 0.4": delay_knob_configs(n, 21)["every gray knob, p_delay 0.4"],
    }
    shapes = set()
    for name, cfg in cases.items():
        cfg = with_planes(cfg)
        plan = config_plan(cfg, 21)
        plain = path_state(cfg, "cuda")
        shapes.add(tfused.BINDINGS["paxos"].kernel_shape(plain, cfg.fault))
        kern, bare = plain.clone(), without_planes(plain.clone())
        for _ in range(2):
            plain = plain_chunk(cfg, plain, plan, 64, 1024)
            kern = tfused.fused_paxos_chunk(kern, cfg.seed, plan, cfg.fault, 64)
            bare = tfused.fused_paxos_chunk(bare, cfg.seed, plan, cfg.fault, 64)
        torch.cuda.synchronize()
        _assert_same(kern, plain)
        _assert_same(without_planes(kern), bare)
        assert int(kern.exposure.injected.sum()) > 0 and int(kern.coverage.new_bits.sum()) > 0, name
    assert shapes == {(2, 5, 8, 0, 0, 1), (2, 5, 8, 0, 1, 1), (2, 5, 8, 1, 0, 1), (2, 5, 8, 1, 1, 1)}
    cfg = with_planes(main_config("paxos", n, 21))
    plan = config_plan(cfg, 21)
    plain = path_state(cfg, "cuda")
    kern, settled_partway = plain.clone(), 0
    for ticks in (1, 0, 1, 30, 0, 1, 40, 1):
        if ticks == 0:
            before = kern.clone()
            tfused._launch("paxos", kern, cfg.seed, plan, cfg.fault, 0, 1024, 0, False)
            torch.cuda.synchronize()
            _assert_same(kern, before)
            continue
        was = settled_lanes(kern)
        plain = plain_chunk(cfg, plain, plan, ticks, 1024)
        kern = tfused.fused_paxos_chunk(kern, cfg.seed, plan, cfg.fault, ticks)
        torch.cuda.synchronize()
        _assert_same(kern, plain)
        settled_partway += int((~was & settled_lanes(kern)).sum())
    assert settled_partway > 0
    cfg = with_planes(main_config("paxos", 8192, 5))
    plan = trun.init_plan(cfg, "cuda")
    kern = tfused.fused_paxos_chunk(path_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, 48)
    clocked = path_state(cfg, "cuda")
    cycles = tfused.phase_clocks("paxos", clocked, cfg.seed, plan, cfg.fault, 48)
    _assert_same(clocked, kern)
    assert all(c > 0 for c in cycles.values())


@pytest.mark.cuda
def test_observed_paxos_refuses_mismatched_observer_arguments(monkeypatch):
    """K1's C entry refuses, with the state left as it was: an observer
    argument count or size that does not fit (22 leaves, a ring depth
    without the ring or the ring without a depth, coverage words not a
    power of two, a plane passed in part, snapshot shadows the state does
    not carry), observer arguments to an instantiation that is not
    observed, and an observed instantiation without them; there is no
    fallback to another instantiation.  A plane leaf of the wrong dtype
    the wrapper refuses before the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    import ctypes

    cfg = with_planes(main_config("paxos", 1024, 2))
    plan = trun.init_plan(cfg, "cuda")
    real = tfused._obs_args

    def launch_with(obs_args, state=None):
        state = path_state(cfg, "cuda") if state is None else state
        before = state.clone()
        monkeypatch.setattr(tfused, "_obs_args", lambda st, f: obs_args(st, f))
        try:
            with pytest.raises(RuntimeError, match="cudaError"):
                tfused._launch("paxos", state, 1, plan, cfg.fault, 8, 1024, 0, False)
        finally:
            monkeypatch.setattr(tfused, "_obs_args", real)
        torch.cuda.synchronize()
        _assert_same(state, before)

    def edit(leaf_at=None, size_at=None, size=0, count=None):
        def args(st, f):
            ptrs, n, params, n_params = real(st, f)
            leaves = list(ptrs)
            if leaf_at is not None:
                leaves[leaf_at] = None
            sizes = list(params)
            if size_at is not None:
                sizes[size_at] = size
            n = len(leaves) if count is None else count
            return ((ctypes.c_void_p * len(leaves))(*leaves), n,
                    (ctypes.c_longlong * len(sizes))(*sizes), len(sizes))
        return args

    launch_with(edit(count=22))  # a wrong count
    launch_with(edit(leaf_at=1))  # a ring depth without the ring
    launch_with(edit(size_at=0, size=0))  # the ring without its depth
    launch_with(edit(size_at=2, size=48))  # coverage words not a power of two
    launch_with(edit(leaf_at=2))  # the ring's cursor missing: a plane in part
    launch_with(edit(leaf_at=14))  # the workload without its phase
    launch_with(edit(size_at=12, size=1))  # snapshot shadows the state does not carry
    launch_with(lambda st, f: (None, 0, None, 0))  # an observed launch without them
    bare = trun.init_state(main_config("paxos", 1024, 2), "cuda")
    launch_with(lambda st, f: real(path_state(cfg, "cuda"), f), state=bare)  # not observed
    # A plane leaf whose dtype or shape is not its plane's: the wrapper
    # refuses it before any launch (the C entry sees pointers, not shapes).
    state = path_state(cfg, "cuda")
    state.telemetry.cursor = state.telemetry.cursor.to(torch.int64)
    with pytest.raises(ValueError, match="leaf"):
        tfused.fused_paxos_chunk(state, 1, plan, cfg.fault, 8)


def _one_and_zero_ticks(protocol, cfg, plan, kern, plain, block):
    """A 1-tick launch from the compared states ``kern`` and ``plain``
    equals the plain tick, and a 0-tick launch after it leaves the state
    as it was (an observed instantiation that completes its coverage
    insert a tick late completes a launch's last insert after its loop)."""
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    plain = plain_chunk(cfg, plain, plan, 1, block)
    kern = wrapper(kern, cfg.seed, plan, cfg.fault, 1, block=block)
    before = kern.clone()
    tfused._launch(protocol, kern, cfg.seed, plan, cfg.fault, 0, block, 0, False)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    _assert_same(kern, before)


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore"])
def test_observed_fr_matches_plain_on_cuda(protocol):
    """K2's and K3's observed instantiations (every observer plane on)
    against the plain tick, observer leaves included, over two chunks, then
    a 1-tick and a 0-tick launch: config5's cell (2,5,8,0,0,1),
    config_gray_chaos and config_corrupt (2,5,8,0,1,1), config_stale (its
    snapshot shadows), config_delay_chaos (2,5,8,1,0,1) and every gray knob
    with p_delay (2,5,8,1,1,1); the planes-off kernel from the same state
    gives the same protocol state;
    the per-tick clamp with a block offset from near-limit ballots; the
    observers phase of the phase-clock build runs; and the C entry refuses
    observer arguments to an instantiation that is not observed and an
    observed launch without them, the state left as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n = 4096
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    cases = {
        "config5": main_config(protocol, n, 21),
        "config_gray_chaos": gray_knob_configs(n, 21, protocol)["config_gray_chaos"],
        "config_corrupt": gray_knob_configs(n, 21, protocol)["config_corrupt"],
        "config_stale": gray_knob_configs(n, 21, protocol)["config_stale"],
        "config_delay_chaos": delay_knob_configs(n, 21, protocol)["config_delay_chaos"],
        "every gray knob, p_delay 0.4": delay_knob_configs(n, 21, protocol)["every gray knob, p_delay 0.4"],
    }
    shapes = set()
    for name, cfg in cases.items():
        cfg = with_planes(cfg)
        plan = config_plan(cfg, 21)
        plain = path_state(cfg, "cuda")
        shapes.add(tfused.BINDINGS[protocol].kernel_shape(plain, cfg.fault))
        kern, bare = plain.clone(), without_planes(plain.clone())
        for _ in range(2):
            plain = plain_chunk(cfg, plain, plan, 64, 1024)
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, 64)
            bare = wrapper(bare, cfg.seed, plan, cfg.fault, 64)
        torch.cuda.synchronize()
        _assert_same(kern, plain)
        _assert_same(without_planes(kern), bare)
        assert int(kern.exposure.injected.sum()) > 0 and int(kern.coverage.new_bits.sum()) > 0, name
        _one_and_zero_ticks(protocol, cfg, plan, kern, plain, 1024)
    assert shapes == {(2, 5, 8, 0, 0, 1), (2, 5, 8, 0, 1, 1), (2, 5, 8, 1, 0, 1), (2, 5, 8, 1, 1, 1)}
    cfg = with_planes(main_config(protocol, n, 13))
    plan = trun.init_plan(cfg, "cuda")
    init = near_limit_state(cfg, 4094)
    plain = plain_chunk(cfg, init, plan, 96, 1024, blk0=5, clamp_per_tick=True)
    kern = wrapper(init.clone(), cfg.seed, plan, cfg.fault, 96, blk0=5, clamp_per_tick=True)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    cfg = with_planes(main_config(protocol, 8192, 5))
    plan = trun.init_plan(cfg, "cuda")
    kern = wrapper(path_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, 48)
    clocked = path_state(cfg, "cuda")
    cycles = tfused.phase_clocks(protocol, clocked, cfg.seed, plan, cfg.fault, 48)
    _assert_same(clocked, kern)
    assert all(c > 0 for c in cycles.values())
    real = tfused._obs_args
    observed = path_state(cfg, "cuda")
    for state, args in ((observed, lambda st, f: (None, 0, None, 0)),
                        (trun.init_state(main_config(protocol, 8192, 5), "cuda"),
                         lambda st, f: real(observed, f))):
        before = state.clone()
        tfused._obs_args = args
        try:
            with pytest.raises(RuntimeError, match="cudaError"):
                tfused._launch(protocol, state, 1, plan, cfg.fault, 8, 1024, 0, False)
        finally:
            tfused._obs_args = real
        torch.cuda.synchronize()
        _assert_same(state, before)


def _observed_cases(protocol, n, seed):
    """Each of K4's and K5's observed instantiations' cases: the protocol's
    cell, config_gray_chaos, config_corrupt and config_stale (its shadows)
    on its arms, config_delay_chaos on its stamps (SynchPaxos' cell), and
    every gray knob with the stamps."""
    gray = gray_knob_configs(n, seed, protocol)
    if protocol == "multipaxos":
        delay = delay_knob_configs(n, seed, protocol)
        cell, stamped = main_config("config3", n, seed), delay["config_delay_chaos"]
        every = delay["every gray knob, p_delay 0.4"]
    else:
        cell, stamped = sp_delay_off_config(n, seed), main_config("synchpaxos", n, seed)
        every = gray["every gray knob, stamped"]
    return {
        "cell": cell, "config_gray_chaos": gray["config_gray_chaos"],
        "config_corrupt": gray["config_corrupt"], "config_stale": gray["config_stale"],
        "config_delay_chaos": stamped, "every gray knob, stamped": every,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["multipaxos", "synchpaxos"])
def test_observed_mp_sp_match_plain_on_cuda(protocol):
    """K5's and K4's observed instantiations (every observer plane on)
    against the plain tick, observer leaves included, over two chunks, then
    a 1-tick and a 0-tick launch, at their four keys (``_observed_cases``);
    the planes-off kernel from the
    same state gives the same protocol state; the per-tick clamp with a
    block offset from near-limit ballots; the observers phase of the
    phase-clock build runs; and the C entry refuses a wrong observer
    argument count, observer arguments to an instantiation that is not
    observed and an observed launch without them, the state left as it
    was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n = 4096
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    block = tfused.BINDINGS[protocol].block
    shapes = set()
    for name, cfg in _observed_cases(protocol, n, 21).items():
        cfg = with_planes(cfg)
        plan = config_plan(cfg, 21)
        plain = path_state(cfg, "cuda")
        shapes.add(tfused.BINDINGS[protocol].kernel_shape(plain, cfg.fault))
        kern, bare = plain.clone(), without_planes(plain.clone())
        for _ in range(2):
            plain = plain_chunk(cfg, plain, plan, 64, block)
            kern = wrapper(kern, cfg.seed, plan, cfg.fault, 64, block=block)
            bare = wrapper(bare, cfg.seed, plan, cfg.fault, 64, block=block)
        torch.cuda.synchronize()
        _assert_same(kern, plain)
        _assert_same(without_planes(kern), bare)
        assert int(kern.exposure.injected.sum()) > 0 and int(kern.coverage.new_bits.sum()) > 0, name
        _one_and_zero_ticks(protocol, cfg, plan, kern, plain, block)
    head = (2, 5, 8, 4) if protocol == "multipaxos" else (2, 5, 8)
    assert shapes == {head + (s, r, 1) for s in (0, 1) for r in (0, 1)}
    if protocol == "multipaxos":
        cfg = with_planes(main_config("config3", n, 13))
        init, limit = near_limit_state_mp(cfg, 254), (1 << 11) - 1
    else:
        cfg = with_planes(main_config("synchpaxos", n, 13))
        init, limit = near_limit_state(cfg, 4094), LIMIT
    plan = config_plan(cfg, 13)
    plain = plain_chunk(cfg, init, plan, 96, block, blk0=5, clamp_per_tick=True)
    kern = wrapper(init.clone(), cfg.seed, plan, cfg.fault, 96, blk0=5, clamp_per_tick=True)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    assert int(kern.proposer.bal.max()) == limit
    cfg = with_planes(main_config("config3" if protocol == "multipaxos" else "synchpaxos", 8192, 5))
    plan = config_plan(cfg, 5)
    kern = wrapper(path_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, 48)
    clocked = path_state(cfg, "cuda")
    cycles = tfused.phase_clocks(protocol, clocked, cfg.seed, plan, cfg.fault, 48)
    _assert_same(clocked, kern)
    assert all(c > 0 for c in cycles.values())
    real = tfused._obs_args
    observed = path_state(cfg, "cuda")

    def short(st, f):
        ptrs, _, params, n_params = real(st, f)
        return ptrs, 22, params, n_params

    bare = trun.init_state(main_config("config3" if protocol == "multipaxos" else "synchpaxos", 8192, 5), "cuda")
    for state, args in ((observed, lambda st, f: (None, 0, None, 0)), (observed, short),
                        (bare, lambda st, f: real(observed, f))):
        before = state.clone()
        tfused._obs_args = args
        try:
            with pytest.raises(RuntimeError, match="cudaError"):
                tfused._launch(protocol, state, 1, plan, cfg.fault, 8, block, 0, False)
        finally:
            tfused._obs_args = real
        torch.cuda.synchronize()
        _assert_same(state, before)


@pytest.mark.cuda
def test_observed_multipaxos_elsewhere_raises_naming_item_22():
    """A Multi-Paxos state with an observer plane at a shape without an
    observed instantiation of K5 (a 4-slot window, three acceptors; the
    long log's 16-slot window has one) raises on the card, naming what is
    left of ROADMAP item 22, and runs no plain tick: the state is as it
    was and no launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.fused_multipaxos_chunk
    launches = wrapper.launches
    for cfg in (with_planes(TC.config3_long(1024, 1, log_total=64, window=4)),
                with_planes(dataclasses.replace(main_config("config3", 1024, 1), n_acc=3))):
        state = path_state(cfg, "cuda")
        before = state.clone()
        with pytest.raises(NotImplementedError, match="item 22"):
            wrapper(state, 1, config_plan(cfg, 1), cfg.fault, 8)
        _assert_same(state, before)
    assert wrapper.launches == launches


ABLATED = [(p, f) for p in ("paxos", "multipaxos") for f in ABLATE_FLAGS]


@pytest.mark.cuda
@pytest.mark.parametrize("protocol,flag", ABLATED, ids=[f"{p}-no-{f}" for p, f in ABLATED])
def test_ablated_builds_match_plain_on_cuda(protocol, flag):
    """Each ablated build of K1 (config2's key) and K5 (config3's, with its
    crash windows) against the plain tick without the same component, byte
    for byte, over two 64-tick chunks from stream block 5 on 4096 lanes;
    each launch counted as that build's; its draw-counting build advances
    the state as it does, and without the PRNG draws nothing; without the
    proposers the per-tick clamp still pins the ballots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    ablate = frozenset({flag})
    cfg = main_config("paxos" if protocol == "paxos" else "config3", 4096, 23)
    plan = main_plan(cfg) or trun.init_plan(cfg, "cuda")
    block = tfused.BINDINGS[protocol].block
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    launches, ablated = wrapper.launches, wrapper.ablated_launches.get(ablate, 0)
    plain = path_state(cfg, "cuda")
    kern = plain.clone()
    for _ in range(2):
        plain = plain_chunk(cfg, plain, plan, 64, block, blk0=5, ablate=ablate)
        kern = wrapper(kern, cfg.seed, plan, cfg.fault, 64, block=block, blk0=5, ablate=ablate)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    assert wrapper.ablated_launches[ablate] == ablated + 2
    assert wrapper.launches == launches
    counted = path_state(cfg, "cuda")
    draws, _ = tfused.draw_census(protocol, counted, cfg.seed, plan, cfg.fault, 64, ablate=ablate)
    once = wrapper(path_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, 64, block=block, ablate=ablate)
    torch.cuda.synchronize()
    _assert_same(counted, once)
    assert (draws == 0) == (flag == "prng")
    if flag == "proposer":
        init = near_limit_state(cfg, 4094) if protocol == "paxos" else near_limit_state_mp(cfg, 255)
        limit = (1 << 15) - 1 if protocol == "paxos" else (1 << 11) - 1
        init.proposer.bal.add_(20)  # over the limit: only the clamp moves a ballot
        plain = plain_chunk(cfg, init, plan, 32, block, blk0=5, clamp_per_tick=True, ablate=ablate)
        kern = wrapper(init.clone(), cfg.seed, plan, cfg.fault, 32, block=block, blk0=5,
                       clamp_per_tick=True, ablate=ablate)
        torch.cuda.synchronize()
        _assert_same(kern, plain)
        assert int(kern.proposer.bal.max()) == limit


@pytest.mark.cuda
def test_ablated_builds_refuse_other_keys():
    """An ablated launch at any key but config2's (K1) and config3's (K5)
    (another shape, the arms, the stamps, the planes) raises, naming ROADMAP
    item 23, before any launch: the state is as it was and no launch is
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cases = [("paxos", TC.config1_no_faults(1024, 1))] + [
        (main_config(path, 1024, 1).protocol, main_config(path, 1024, 1)) for path in (
            "graychaos", "delaychaos-paxos", "observed-paxos", "config3long",
            "graychaos-multipaxos", "delaychaos-multipaxos", "observed-multipaxos",
        )
    ]
    for protocol, cfg in cases:
        wrapper = tfused.FUSED_WRAPPERS[protocol]
        launches, ablated = wrapper.launches, dict(wrapper.ablated_launches)
        state = path_state(cfg, "cuda")
        before = state.clone()
        plan = main_plan(cfg) or trun.init_plan(cfg, "cuda")
        with pytest.raises(NotImplementedError, match="item 23"):
            wrapper(state, 1, plan, cfg.fault, 8, ablate=frozenset({"sends"}))
        _assert_same(state, before)
        assert wrapper.launches == launches and wrapper.ablated_launches == ablated


@pytest.mark.cuda
def test_observed_multipaxos_long_matches_plain_on_cuda():
    """K5's observed long-log instantiation (2,5,16,4,0,0,1) against the
    plain tick, observer leaves included, after each of three 64-tick
    chunks compacted after each (a launch's last coverage insert completes
    at its end, before the compaction shifts the window), on 16384 lanes;
    the planes-off kernel from the same state gives the same protocol
    state; the per-tick clamp with a block offset from near-limit ballots;
    every observer phase of the phase-clock build runs; 2 blocks of 64
    lanes an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    key = (2, 5, 16, 4, 0, 0, 1)
    assert tfused.blocks_per_sm("multipaxos", key) == 2
    wrapper = tfused.fused_multipaxos_chunk
    cfg = main_config("observed-multipaxos-long", 1 << 14, 24)
    plan = config_plan(cfg, 24)
    plain = path_state(cfg, "cuda")
    assert tfused.BINDINGS["multipaxos"].kernel_shape(plain, cfg.fault) == key
    kern, bare = plain.clone(), without_planes(plain.clone())
    for _ in range(3):
        plain = compact_mp_body(plain_chunk(cfg, plain, plan, 64, 256))[0]
        kern = compact_mp_body(wrapper(kern, cfg.seed, plan, cfg.fault, 64))[0]
        bare = compact_mp_body(wrapper(bare, cfg.seed, plan, cfg.fault, 64))[0]
        torch.cuda.synchronize()
        _assert_same(kern, plain)
        _assert_same(without_planes(kern), bare)
    assert int(kern.base.max()) > 0 and int(kern.coverage.new_bits.sum()) > 0
    cfgc = main_config("observed-multipaxos-long", 4096, 13)
    plan = config_plan(cfgc, 13)
    init = near_limit_state_mp(cfgc, 254)
    plain = plain_chunk(cfgc, init, plan, 96, 256, blk0=5, clamp_per_tick=True)
    kern = wrapper(init.clone(), cfgc.seed, plan, cfgc.fault, 96, blk0=5, clamp_per_tick=True)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    assert int(kern.proposer.bal.max()) == (1 << 11) - 1
    clocked = path_state(cfgc, "cuda")
    cycles = tfused.phase_clocks("multipaxos", clocked, cfgc.seed, plan, cfgc.fault, 48)
    once = wrapper(path_state(cfgc, "cuda"), cfgc.seed, plan, cfgc.fault, 48)
    torch.cuda.synchronize()
    _assert_same(clocked, once)
    assert all(c > 0 for c in cycles.values())


def _shared_word_lanes(state, words: int) -> int:
    """Lanes whose coverage digest of ``state`` puts both Bloom bits in one
    bitmap word of ``words``: K5 merges such an insert into one write."""
    digest = lane_digest(digest_tree(state))
    pos0, pos1 = (_hash_pos(digest, j, 32 * words) for j in range(2))
    return int(((pos0 >> 5) == (pos1 >> 5)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 64])
@pytest.mark.parametrize("path", [
    "observed-multipaxos", "observed-synchpaxos", "observed-fastpaxos", "observed-raftcore",
    "observed-paxos",
])
def test_observed_shared_bloom_word_on_cuda(path, words):
    """The coverage insert of K1 to K5 (a tick late) where a tick's
    two Bloom positions share a bitmap word: on each observed path's config
    (every plane on) with 64 coverage words, its own, and with 1, where
    every insert shares one, the plain ticks one at a time count the
    lane-ticks whose digest does so (about one in 64 at 64 words, on 4096
    lanes and 32 ticks), and the kernel over the same ticks equals them
    byte for byte, the bitmap and its new-bit count included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n, ticks = 4096, 32
    cfg = dataclasses.replace(main_config(path, n, 29), coverage=CoverageConfig(words=words))
    wrapper = tfused.FUSED_WRAPPERS[cfg.protocol]
    block = tfused.BINDINGS[cfg.protocol].block
    plan = config_plan(cfg, 29)
    plain = path_state(cfg, "cuda")
    kern = wrapper(plain.clone(), cfg.seed, plan, cfg.fault, ticks)
    shared = 0
    for _ in range(ticks):
        plain = plain_chunk(cfg, plain, plan, 1, block)
        shared += _shared_word_lanes(plain, words)
    torch.cuda.synchronize()
    _assert_same(kern, plain)
    assert shared == n * ticks if words == 1 else shared >= n * ticks // 128
    assert int(kern.coverage.new_bits.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", [
    "observed-multipaxos", "observed-multipaxos-long", "observed-synchpaxos", "observed-fastpaxos",
    "observed-raftcore", "observed-paxos",
])
def test_observed_deferred_insert_on_cuda(path):
    """The coverage insert of K1 to K5 completes a tick late (the
    launch's last tick's at its end): on 1000 lanes (a lane count no
    multiple of the 128, 96 or 64 lanes a block), 24 one-tick launches,
    each followed by a 0-tick launch that leaves the state as it was, and
    one 24-tick launch equal the plain tick byte for byte, observer leaves
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    n, block, ticks = 1000, 200, 24
    cfg = main_config(path, n, 17)
    wrapper, binding = tfused.FUSED_WRAPPERS[cfg.protocol], tfused.BINDINGS[cfg.protocol]
    plan = config_plan(cfg, 17)
    plain = path_state(cfg, "cuda")
    assert n % binding.staging[binding.kernel_shape(plain, cfg.fault)].threads
    once = wrapper(plain.clone(), cfg.seed, plan, cfg.fault, ticks, block=block)
    ticked = plain.clone()
    for _ in range(ticks):
        ticked = wrapper(ticked, cfg.seed, plan, cfg.fault, 1, block=block)
        before = ticked.clone()
        tfused._launch(cfg.protocol, ticked, cfg.seed, plan, cfg.fault, 0, block, 0, False)
        torch.cuda.synchronize()
        _assert_same(ticked, before)
    plain = plain_chunk(cfg, plain, plan, ticks, block)
    torch.cuda.synchronize()
    _assert_same(once, plain)
    _assert_same(ticked, plain)
    assert int(plain.coverage.new_bits.sum()) > 0


@pytest.mark.cuda
def test_ablation_entry_point_runs_on_cuda():
    """The ablation tool on the card at a small size: every variant's row
    for both kernels, the card's name and power limit beside them; a
    variant's first chunk is timed after its kernel was loaded (a 0-tick
    launch, which leaves the state as it was and counts no launch); each
    ablated build counts its own launches, the first chunk and the timed
    ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    from paxos_tpu_torch.scripts import ablate_fused

    for protocol, name in (("paxos", "config2"), ("multipaxos", "config3")):
        wrapper = tfused.FUSED_WRAPPERS[protocol]
        cfg = main_config("paxos" if protocol == "paxos" else "config3", 4096, 2)
        state, plan = path_state(cfg, "cuda"), main_plan(cfg) or trun.init_plan(cfg, "cuda")
        before, launches, ablated = state.clone(), wrapper.launches, dict(wrapper.ablated_launches)
        tfused.warm_kernel(protocol, state, cfg.seed, plan, cfg.fault, tfused.BINDINGS[protocol].block,
                           frozenset({"sends"}))
        torch.cuda.synchronize()
        _assert_same(state, before)
        assert wrapper.launches == launches and wrapper.ablated_launches == ablated
        table = ablate_fused.ablation_table(protocol, name, 1 << 14, 32, 1, torch.device("cuda"))
        for flag in ABLATE_FLAGS:
            key = frozenset({flag})
            assert wrapper.ablated_launches[key] == ablated.get(key, 0) + 2, flag
        assert table["platform"] == "cuda" and table["card"].startswith(table["device"])
        assert [r["variant"] for r in table["rows"]] == ["full"] + [f"no-{f}" for f in ABLATE_FLAGS]
        assert all(r["us_per_tick"] > 0 and r["first_us_per_tick"] > 0 for r in table["rows"])
