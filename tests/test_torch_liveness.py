"""The port's liveness report against the JAX package's.

- ``liveness_report`` (``liveness_device`` read by ``liveness_host``), and
  ``decided_by``, ``chosen_tick_histogram`` and ``stuck_mask`` alone, on
  learner leaves made from a numpy seed: the single-decree learner (I,)
  and the Multi-Paxos one (L, I), without and with a long log's ``valid``
  mask (``base`` and ``log_total``), at several report ticks;
- ``summarize(liveness=True)`` of a short ``run`` of each of the five
  protocols (config2, config5's Fast Paxos and Raft-core cells,
  config_delay_chaos, config3) and of config3-long (compacted after every
  chunk: the window-relative block), against the JAX package's
  ``summarize(liveness=True)`` of its fused stream from the same plan.

Counts and the block's tuples compare exactly (tolerance 0: the fractions
are float32 counts over float32 counts on both sides, rounded to 6
places); the report's other float32 fractions to a relative 1e-6, as
tests/test_torch_run.py compares them.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import jax_plan_of, one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu.check import liveness as jl
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.harness.run import summarize as j_summarize
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu.protocols.multipaxos import compact_mp_body as j_compact
from paxos_tpu_torch.check import liveness as tl
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun

FLOAT_FIELDS = ("chosen_frac", "mean_choose_tick", "decided_frac", "replicated_frac")


def _learners(rng, shape, now):
    """The same learner as the JAX package's and the port's: chosen with p
    0.7, chosen ticks in [0, now) where chosen and -1 elsewhere."""
    chosen = rng.random(shape) < 0.7
    tick = np.where(chosen, rng.integers(0, max(now, 1), shape), -1).astype(np.int32)
    j = SimpleNamespace(chosen=jnp.asarray(chosen), chosen_tick=jnp.asarray(tick))
    t = SimpleNamespace(chosen=torch.from_numpy(chosen), chosen_tick=torch.from_numpy(tick))
    return j, t


CASES = [
    (shape, now, long_log)
    for shape in ((512,), (8, 256))
    for now in (0, 7, 100, 4096)
    for long_log in ((False, True) if len(shape) == 2 else (False,))
]


@pytest.mark.parametrize("shape,now,long_log", CASES, ids=lambda v: str(v))
def test_liveness_block_matches_jax(shape, now, long_log):
    rng = np.random.default_rng(hash((shape, now, long_log)) % (1 << 32))
    jlrn, tlrn = _learners(rng, shape, now)
    base = log_total = None
    kw_j, kw_t = {}, {}
    if long_log:
        log_total = 12
        base = rng.integers(0, log_total + 1, shape[-1]).astype(np.int32)
        kw_j = dict(base=jnp.asarray(base), log_total=log_total)
        kw_t = dict(base=torch.from_numpy(base), log_total=log_total)
    want = jl.liveness_report(jlrn, now, **kw_j)
    got = tl.liveness_report(tlrn, torch.tensor(now, dtype=torch.int32), **kw_t)
    assert got == want
    assert ("slots_compacted" in got) == long_log
    if long_log:
        assert got["slots_compacted"] == int(base.sum())
    # The pieces alone, at a tick point and a bin width of the block.
    valid_j = valid_t = None
    if long_log:
        valid_j = jl.window_valid_mask(shape, kw_j["base"], log_total)
        valid_t = tl.window_valid_mask(shape, kw_t["base"], log_total)
        np.testing.assert_array_equal(np.asarray(valid_j), valid_t.numpy())
    for k in (0, now // 2, now):
        assert float(tl.decided_by(tlrn, k, valid_t)) == float(jl.decided_by(jlrn, k, valid_j))
    for width in (1, 5):
        np.testing.assert_array_equal(
            tl.chosen_tick_histogram(tlrn, 16, width, valid_t).numpy(),
            np.asarray(jl.chosen_tick_histogram(jlrn, 16, width, valid_j)),
        )
    np.testing.assert_array_equal(
        tl.stuck_mask(tlrn, 50, now, valid_t).numpy(),
        np.asarray(jl.stuck_mask(jlrn, 50, now, valid_j)),
    )


@functools.lru_cache(maxsize=None)
def _jax_chunk(protocol, fault, ticks, compact):
    apply_fn, mask_fn, _ = fused_fns(protocol)

    def chunk(st, seed, plan):
        st = j_reference_chunk(st, seed, plan, fault, ticks, apply_fn, mask_fn)
        return j_compact(st)[0] if compact else st

    return jax.jit(chunk)


RUNS = {
    "paxos": lambda: ("config2_dueling_drop", None),
    "fastpaxos": lambda: ("config5_sweep", 1),
    "raftcore": lambda: ("config5_sweep", 2),
    "synchpaxos": lambda: ("config_delay_chaos", None),
    "multipaxos": lambda: ("config3_multipaxos", None),
}


def _configs(name):
    if name == "config3long":
        kw = dict(n_inst=64, log_total=24, window=8, seed=4)
        return JC.config3_long(**kw), TC.config3_long(**kw)
    fn, index = RUNS[name]()
    jcfg, tcfg = getattr(JC, fn)(128, 5), getattr(TC, fn)(128, 5)
    if index is not None:
        jcfg, tcfg = jcfg[index], tcfg[index]
    return jcfg, tcfg


@pytest.mark.parametrize("name", [*RUNS, "config3long"])
def test_summarize_liveness_matches_jax(name):
    """A short campaign's report with the liveness block, key for key."""
    jcfg, tcfg = _configs(name)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    plan = chip_smoke.main_plan(tcfg, "cpu") or trun.init_plan(tcfg, "cpu")
    long_log = name == "config3long"
    chunk, chunks = 16, 3
    got = trun.run(
        tcfg, total_ticks=chunk * chunks, chunk=chunk, plan=plan, device="cpu", liveness=True
    )
    step = _jax_chunk(jcfg.protocol, jcfg.fault, chunk, long_log)
    jstate = j_init_state(jcfg)
    for _ in range(chunks):
        jstate = step(jstate, jcfg.seed, jax_plan_of(plan))
    want = j_summarize(jstate, liveness=True, log_total=jcfg.fault.log_total)
    want.update(config_fingerprint=jcfg.fingerprint(), engine="fused")
    assert set(want) == set(got), (sorted(want), sorted(got))
    for key, w in want.items():
        if key in FLOAT_FIELDS:
            assert got[key] == pytest.approx(w, rel=1e-6), key
        else:
            assert got[key] == w, key
    assert len(got["decided_by_curve"]) == 8 and len(got["chosen_tick_hist"]) == 16
    assert sum(got["chosen_tick_hist"]) > 0
    assert got.get("liveness_window_relative", False) == long_log
    # Without liveness the report has none of the block's keys.
    plain = trun.summarize(trun.init_state(tcfg, "cpu"), log_total=tcfg.fault.log_total)
    assert "decided_by_curve" not in plain and "stuck_lanes" not in plain


def test_liveness_block_on_the_gray_multipaxos_path():
    """The new main path's config (config3's shape with config_gray_chaos's
    fault config) at 256 lanes: the block with its cut lanes, key for key."""
    tcfg = chip_smoke.main_config("graychaos-multipaxos", 256, 3)
    jcfg = dataclasses.replace(
        JC.config3_multipaxos(256, 3), fault=JC.config_gray_chaos(256, 3).fault
    )
    assert jcfg.fingerprint() == tcfg.fingerprint()
    plan = chip_smoke.main_plan(tcfg, "cpu")
    got = trun.run(tcfg, total_ticks=64, chunk=32, plan=plan, device="cpu", liveness=True)
    jstate = _jax_chunk("multipaxos", jcfg.fault, 64, False)(
        j_init_state(jcfg), jcfg.seed, jax_plan_of(plan)
    )
    want = j_summarize(jstate, liveness=True)
    for key in ("decided_by_curve", "chosen_tick_hist", "hist_bin_width", "stuck_lanes"):
        assert got[key] == want[key], key
    assert got["stuck_lanes"] > 0  # cut lanes still undecided at tick 64
