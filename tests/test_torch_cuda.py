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
instantiations of K1, K2 and K3 are held so on every gray-failure and
partition knob alone and on the configs that set them
(``gray_knob_configs``; K2 and K3 also on every knob at once), and give the
gray-chaos main paths' block-0 digests; so is K5's, on config3's cell, on
every knob at once and on the JAX package's own two cases, and K5 on the
knobs its main paths leave at their defaults (p_dup, q1/q2, a ballot
stride).  A plan without ``link_delay`` under ``p_delay > 0`` is refused,
and the other kernels refuse ``p_delay``; K4 refuses the gray knobs, and
K1 to K3 and K5 a gray knob that reaches an instantiation without its
arms, an arms instantiation without a knob, and stale_k on a state
without snapshot shadows; K5 a gray config at a shape without its arms
(config_gray_chaos's own 8-row learner table).
"""

import dataclasses
import hashlib

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
    config_plan,
    fault_plan,
    fr_knob_configs,
    gray_knob_configs,
    main_config,
    main_plan,
    mp_knob_configs,
    near_limit_state,
    near_limit_state_mp,
    plain_chunk,
    sp_checker_config,
    sp_delay_off_config,
    sp_knob_configs,
)
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols.multipaxos import compact_mp_body

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
    window, or (the arms) the gray-chaos main path's config."""
    n_prop, n_acc, log_len, _, arms = shape
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
    plain = trun.init_state(cfg, "cuda")
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
    shape = (2, 5, 8, 4, 0)
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
    """Every geometry of K5 lets an SM hold 8 warps, the most 255 registers
    a thread allow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for shape, staging in tfused.MP_STAGING.items():
        assert tfused.blocks_per_sm("multipaxos", shape) * staging.threads // 32 >= 8


@pytest.mark.cuda
@pytest.mark.parametrize("path", PROTOCOLS + ["config3", "config3long"])
def test_draw_census_build_follows_the_kernel(path):
    """The draw-counting build advances the state as the kernel does, counts
    no launch, draws at most every mask element of every tick, and touches
    slot arrays (Multi-Paxos only) at most as often as the census rewrites
    them."""
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
    if mp.protocol == "multipaxos":
        assert 0 < touches <= SLOT_CENSUS[mp.census][1] * lane_ticks
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
    n_prop, n_acc, _, stamped = shape
    cfg = TC.config_delay_chaos(n, 9, violate_delta=True) if stamped else sp_delay_off_config(n, 9)
    cfg = dataclasses.replace(cfg, n_acc=n_acc)
    block = tfused.fit_block(1024, n)
    plan = main_plan(cfg) or trun.init_plan(cfg, "cuda")
    plain = trun.init_state(cfg, "cuda")
    assert tfused.BINDINGS["synchpaxos"].kernel_shape(plain) == shape
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
    shape = (2, 5, 8, 1)
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
    capped for: 12 warps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for shape, staging in tfused.SP_STAGING.items():
        blocks = tfused.blocks_per_sm("synchpaxos", shape)
        assert blocks >= staging.min_blocks and blocks * staging.threads // 32 >= 12


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
    assert all(c > 0 for c in cycles.values())
    again = tfused.phase_clocks("synchpaxos", trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    assert sum(again.values()) < 2 * sum(cycles.values())  # cleared after every read


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_model():
    """K4 refuses a plan without link_delay under p_delay > 0, in the
    wrapper and in its C entry point; K1 to K3 and K5 refuse p_delay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cfg = main_config("synchpaxos", 1024, 1)
    bare = tfused.FaultPlan.none(1024, 5, 2, device="cuda")
    with pytest.raises(ValueError, match="link_delay"):
        tfused.fused_synchpaxos_chunk(trun.init_state(cfg, "cuda"), 1, bare, cfg.fault, 8)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfused._launch("synchpaxos", trun.init_state(cfg, "cuda"), 1, bare, cfg.fault, 8, 1024, 0, False)
    for path in PROTOCOLS + ["config3"]:
        c = main_config(path, 1024, 1)
        delayed = dataclasses.replace(c.fault, p_delay=0.3)
        protocol = MAIN_PATHS[path].protocol
        plan = main_plan(c) or trun.init_plan(c, "cuda")
        plan.link_delay = torch.ones((c.n_prop, c.n_acc, c.n_inst), dtype=torch.int32, device="cuda")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfused.FUSED_WRAPPERS[protocol](trun.init_state(c, "cuda"), 1, plan, delayed, 8)
        block = tfused.BINDINGS[protocol].block
        with pytest.raises(RuntimeError, match="cudaError"):
            tfused._launch(protocol, trun.init_state(c, "cuda"), 1, plan, delayed, 8, block, 0, False)


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
    if shape[3:] == (1,):  # K1's arms: config_gray_chaos's knobs on this plan
        gray = gray_knob_configs(n, 9)["config_gray_chaos"].fault
        cfg = dataclasses.replace(cfg, fault=gray)
    block = tfused.fit_block(1024, n)
    plan = fault_plan(n, n_acc, n_prop, 0.2, 9, p_crash=0.2, gray=cfg.fault)
    plain = trun.init_state(cfg, "cuda")
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
    registers are capped for: 12 warps or more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    for protocol in FR:
        for shape, staging in tfused.FR_STAGING[protocol].items():
            blocks = tfused.blocks_per_sm(protocol, shape)
            assert blocks >= staging.min_blocks and blocks * staging.threads // 32 >= 12


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
    assert all(c > 0 for c in cycles.values())


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
    """K4 refuses the gray-failure and partition knobs, in the wrapper
    (ROADMAP item 12) and in its C entry point; K1 refuses them in its C
    entry on its default instantiation, at a shape without an arms
    instantiation (the wrapper), and stale_k on a state without snapshot
    shadows (K2, K3 and K5 likewise: test_fr_arms_refuse_mismatched_launches,
    test_mp_arms_refuse_mismatched_launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    gray = gray_knob_configs(1024, 1)["config_gray_chaos"]
    for path in ["synchpaxos"]:
        c = main_config(path, 1024, 1)
        protocol = MAIN_PATHS[path].protocol
        plan = config_plan(dataclasses.replace(c, fault=gray.fault), 1)
        with pytest.raises(NotImplementedError, match="item 12"):
            tfused.FUSED_WRAPPERS[protocol](trun.init_state(c, "cuda"), 1, plan, gray.fault, 8)
        block = tfused.BINDINGS[protocol].block
        with pytest.raises(RuntimeError, match="cudaError"):
            tfused._launch(protocol, trun.init_state(c, "cuda"), 1, plan, gray.fault, 8, block, 0, False)
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
        assert tfused.BINDINGS[protocol].kernel_shape(plain, cfg.fault) == (2, 5, 8, 1), name
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
    staging = tfused.FR_STAGING[protocol][(2, 5, 8, 1)]
    assert staging.min_blocks == 3
    assert tfused.blocks_per_sm(protocol, (2, 5, 8, 1)) >= 3


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
    rates, 128 lanes, seed 9); and the gray-chaos main path's block-0
    digest after a whole campaign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
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
        assert tfused.BINDINGS["multipaxos"].kernel_shape(plain, cfg.fault) == (2, 5, 8, 4, 1)
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
    assert tfused.blocks_per_sm("multipaxos", (2, 5, 8, 4, 1)) >= 2


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
