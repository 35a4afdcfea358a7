"""K5's observed long-log instantiation and the ``observed-multipaxos-long``
main path (no GPU needed).

The key (2, 5, 16, 4, 0, 0, 1): config3-long's shape with the observer
planes.  Its column (``fused_tick.MP_STAGING``) is held against the
state's leaves and the card's shared memory; the path's config (config3-long
with every plane at the observed paths' settings) keys it; the plain tick
with every plane on runs the path's own config (a 256-slot log through a
16-slot window) through compacting chunks leaf for leaf as the JAX package
does; and a short campaign of the path through ``run`` gives plane blocks
that hold together (``chip_smoke.check_plane_report``, the compacted slots
counted as decided), with the protocol state of the planes-off campaign.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

import chip_smoke
from _torch_jax import _np_leaves, jax_plan_of, one_core, one_torch_thread  # noqa: F401  (autouse)
from test_torch_obs_paxos import FAST_COMPILE, both_initial_states, jax_config

from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu.protocols.multipaxos import compact_mp_body as j_compact
from paxos_tpu_torch import interop
from paxos_tpu_torch.core.mp_state import MultiPaxosState
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

KEY = (2, 5, 16, 4, 0, 0, 1)
PATH = "observed-multipaxos-long"
SM_SHARED, RESERVED = 233_472, 1024  # an H100 SM's shared memory, a block's reserve


def test_observed_long_log_geometry():
    """404 words a lane: the log (80), the recovery rows (32), the learner
    table (64) and its packed voter masks (16), the chosen values and ticks
    (32), the 160 PROMISE payload words and the planes' 20 counter rows
    (the margins and the client queue; the other counters live in
    registers); 2 blocks of 64 lanes an SM (4 warps), where 96 lanes would
    fit one block only.  Without the payloads (244 words) 2 blocks of 96
    fit, but the digest then reads them from global memory every tick: the
    card ran that geometry slower (PERF.md section 6)."""
    st = tfused.MP_STAGING[KEY]
    assert KEY in tfused.KERNEL_SHAPES["multipaxos"]
    state = MultiPaxosState.init(3, 2, 5, 16, 4)

    def lane_words(path):  # a leaf's words a lane (instance-minor)
        part, field = path.split(".")
        return math.prod(getattr(getattr(state, part), field).shape[:-1])

    words = {path: lane_words(path) for path in tfused.MP_STAGED_LEAVES + (tfused.MP_PROM_LEAF,)}
    words[tfused.MP_PACKED_LEAF] = 16  # four masks a word
    assert words == {
        "acceptor.log": 80, "proposer.recov_bv": 32, "learner.lt_bv": 64, "learner.lt_mask": 16,
        "learner.chosen_val": 16, "learner.chosen_tick": 16, "promises.p_bv": 160,
    }
    staged = sum(words.values()) + tfused.tally_obs_rows(KEY[0], KEY[5])
    assert (st.threads, st.stage_prom, st.rows) == (64, True, staged) == (64, True, 404)
    assert st.smem_bytes == 404 * 4 * 64 == 103_424 <= tfused.SMEM_PER_BLOCK_MAX
    assert 2 * (st.smem_bytes + RESERVED) <= SM_SHARED < 3 * (st.smem_bytes + RESERVED)
    assert 2 * (404 * 4 * 96 + RESERVED) > SM_SHARED
    unstaged = tfused._mp_staging(KEY, 96, False)
    assert unstaged.rows == 244 and unstaged.smem_bytes == 93_696
    assert 2 * (unstaged.smem_bytes + RESERVED) <= SM_SHARED
    assert tfused._launch_dims(tfused.BINDINGS["multipaxos"], KEY) == KEY + (103_424,)


def test_observed_long_log_path_keys_its_instantiation():
    """The path runs config3-long with every plane on, compacted after
    every chunk, through K5's observed long-log key; its protocol state is
    pinned as config3-long's (no eviction, its block 0)."""
    mp = chip_smoke.MAIN_PATHS[PATH]
    assert (mp.protocol, mp.ticks, mp.config, mp.compact, mp.compare_chunks, mp.planes) == (
        "multipaxos", chip_smoke.LONG_TICKS, "config3_long", True, 2, True
    )
    cfg = chip_smoke.main_config(PATH, 64, 0)
    bare = chip_smoke.main_config("config3long", 64, 0)
    assert dataclasses.replace(cfg, **{k: getattr(bare, k) for k in (
        "telemetry", "coverage", "exposure", "margin", "workload")}) == bare
    assert (cfg.log_len, cfg.fault.log_total) == (16, 256)
    state = chip_smoke.path_state(cfg, "cpu")
    assert tfused.BINDINGS["multipaxos"].kernel_shape(state, cfg.fault) == KEY
    tfused._check_cuda_inputs("multipaxos", state, chip_smoke.main_plan(cfg, "cpu"), cfg.fault)
    assert chip_smoke.EVICTION_PINS[PATH] == chip_smoke.EVICTION_PINS["config3long"]
    assert chip_smoke.BLOCK0_DIGESTS[PATH] == chip_smoke.BLOCK0_DIGESTS["config3long"]


def test_observed_long_log_matches_jax_over_compactions():
    """The path's config at 64 lanes, seed 7: three 24-tick chunks, each
    followed by the compaction, through the port's compacting dispatch
    against the JAX package's ``reference_chunk`` and ``compact_mp_body``,
    leaf for leaf after every chunk (tolerance 0)."""
    tcfg = chip_smoke.main_config(PATH, 64, 7)
    jcfg = jax_config(tcfg)
    jstate, state = both_initial_states(tcfg)
    plan = chip_smoke.config_plan(tcfg, 7, "cpu")
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    step = jax.jit(
        lambda st, pl: j_compact(j_reference_chunk(st, 7, pl, jcfg.fault, 24, apply_fn, mask_fn))[0],
        compiler_options=FAST_COMPILE,
    )
    advance = trun.make_advance_grouped(tcfg, plan, compact=True)
    jplan = jax_plan_of(plan)
    for _ in range(3):
        jstate = step(jstate, jplan)
        state = advance(state, 24, 1)
        for i, (w, g) in enumerate(zip(_np_leaves(jstate), interop.state_to_numpy(state), strict=True)):
            np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    assert int(state.base.max()) > 0  # prefixes compacted
    assert int(state.telemetry.seq.sum()) > 0 and int(state.coverage.new_bits.sum()) > 0


def test_observed_long_log_campaign_report_holds_together():
    """A short campaign of the path (64 lanes, 256 ticks in four compacting
    chunks): its plane blocks pass the chip's own check, which counts a
    long log's compacted slots as decided, and its protocol state is the
    planes-off campaign's."""
    cfg = chip_smoke.main_config(PATH, 64, 0)
    plan = chip_smoke.main_plan(cfg, "cpu")
    kw = dict(engine="fused", total_ticks=256, chunk=64, pipeline_depth=16, plan=plan,
              device="cpu", return_state=True)
    report, state = trun.run(cfg, wload_plan=chip_smoke.wload_plan(cfg, 0, "cpu"), **kw)
    assert report["violations"] == 0 and int(state.base.sum()) > 0
    chip_smoke.check_plane_report(PATH, report, cfg, state)
    assert report["telemetry"]["counters"]["decide"] > int(state.learner.chosen.sum())
    _, bare = trun.run(chip_smoke.main_config("config3long", 64, 0), **kw)
    assert chip_smoke.max_abs_err(chip_smoke.without_planes(state).leaves(), bare.leaves()) == 0


def test_long_log_arms_and_stamps_name_item_23():
    """The long log's keys with the arms or the stamps (config3-long under
    the gray-chaos or delay-chaos fault config, as the JAX CLI's
    ``--fault`` puts them there) are refused before any launch, naming
    ROADMAP item 23."""
    from paxos_tpu_torch.harness import config as C

    for fault, key in ((C.config_gray_chaos, (2, 5, 16, 4, 0, 1, 0)),
                       (C.config_delay_chaos, (2, 5, 16, 4, 1, 0, 0))):
        cfg = chip_smoke.main_config("config3long", 64, 2)
        cfg = dataclasses.replace(cfg, fault=dataclasses.replace(
            fault(64, 2).fault, log_total=cfg.fault.log_total, lease_len=cfg.fault.lease_len))
        state = chip_smoke.path_state(cfg, "cpu")
        assert tfused.BINDINGS["multipaxos"].kernel_shape(state, cfg.fault) == key
        with pytest.raises(NotImplementedError, match="item 23"):
            tfused._check_cuda_inputs("multipaxos", state, chip_smoke.config_plan(cfg, 2, "cpu"), cfg.fault)
