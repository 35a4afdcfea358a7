"""The port's long-log Multi-Paxos against the JAX package, bit for bit.

Decided prefixes compact out of the window after every chunk
(``compact_mp_body``); the port's compaction, its chunk-by-chunk campaign
through ``make_advance_grouped(compact=True)`` and its ``run`` report
(``slots_replicated``, ``replicated_frac`` and the log-relative
``decided_frac`` included) must equal the JAX package's on the same plan.
"""

import functools

import jax
import numpy as np
import pytest
from test_torch_multipaxos import _assert_leaves_equal, _np, random_mp_leaves, to_jax

from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.harness.run import summarize as j_summarize
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu.protocols.multipaxos import compact_mp_body as j_compact
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.protocols.multipaxos import compact_mp_body
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)

FLOAT_FIELDS = ("chosen_frac", "mean_choose_tick", "decided_frac", "replicated_frac")


@functools.lru_cache(maxsize=None)
def jax_chunk_compact(fault):
    """One chunk of the JAX package's reference_chunk, then its compaction."""
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    return jax.jit(
        lambda st, seed, plan, n: j_compact(
            j_reference_chunk(st, seed, plan, fault, n, apply_fn, mask_fn)
        )[0]
    )


def _jax_plan(jcfg):
    leaves = [_np(x) for x in jax.tree.leaves(j_init_plan(jcfg))]
    return leaves, interop.plan_from_numpy(leaves)


@pytest.mark.parametrize("log_len", [4, 16])
def test_compact_mp_body_matches(log_len):
    """Random states with chosen prefixes of every length (none, partial,
    the whole window) and in-flight messages of every kind."""
    rng = np.random.default_rng(30 + log_len)
    n = 256
    leaves = random_mp_leaves(rng, 2, 5, log_len, 4, n)
    chosen = leaves[12]
    prefix = rng.integers(0, log_len + 1, n)
    chosen[:, :] = (np.arange(log_len)[:, None] < prefix[None]) | (rng.random(chosen.shape) < 0.2)
    want = jax.jit(j_compact)(to_jax(0, leaves))
    got = compact_mp_body(interop.state_from_numpy(leaves, protocol="multipaxos"))
    _assert_leaves_equal([_np(x) for x in jax.tree.leaves(want[0])], interop.state_to_numpy(got[0]))
    np.testing.assert_array_equal(_np(want[1]), got[1].numpy())
    np.testing.assert_array_equal(_np(want[2]), got[2].numpy())
    shift = got[1].numpy()
    assert shift.min() == 0 and shift.max() == log_len
    assert (got[0].requests.present.numpy() != leaves[20]).any()  # in-flight ACCEPTs dropped


def test_config3_long_chunk_by_chunk():
    """config3_long(32 lanes, an 8-slot log through a 4-slot window): the
    port's compacting dispatch, 8-tick chunks grouped 2 per dispatch,
    equals the JAX package's chunk + compaction, chunk after chunk."""
    jcfg = JC.config3_long(n_inst=32, log_total=8, window=4, seed=6)
    tcfg = TC.config3_long(n_inst=32, log_total=8, window=4, seed=6)
    leaves, plan = _jax_plan(jcfg)
    advance = trun.make_advance_grouped(tcfg, plan, compact=True)
    jstate, tstate = j_init_state(jcfg), trun.init_state(tcfg, "cpu")
    for _ in range(4):
        for _ in range(2):
            jstate = jax_chunk_compact(jcfg.fault)(jstate, 6, to_jax(1, leaves), 8)
        tstate = advance(tstate, 8, 2)
        _assert_leaves_equal([_np(x) for x in jax.tree.leaves(jstate)], interop.state_to_numpy(tstate))
    assert 0 < int(tstate.base.min()) and int(tstate.base.max()) == 8  # some lanes replicated it all


def _assert_report_matches(want, got):
    assert set(want) == set(got), (sorted(want), sorted(got))
    for key, w in want.items():
        if key in FLOAT_FIELDS:
            assert got[key] == pytest.approx(w, rel=1e-6), key
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("long_log", [True, False])
def test_run_report_matches_reference_summarize(long_log):
    if long_log:
        jcfg = JC.config3_long(n_inst=64, log_total=24, window=8, seed=4)
        tcfg = TC.config3_long(n_inst=64, log_total=24, window=8, seed=4)
    else:
        jcfg, tcfg = JC.config3_multipaxos(64, 4), TC.config3_multipaxos(64, 4)
    leaves, plan = _jax_plan(jcfg)
    got = trun.run(tcfg, total_ticks=48, chunk=16, pipeline_depth=2, plan=plan, device="cpu")
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    jstate = j_init_state(jcfg)
    if long_log:
        for _ in range(3):
            jstate = jax_chunk_compact(jcfg.fault)(jstate, 4, to_jax(1, leaves), 16)
    else:
        jstate = jax.jit(
            lambda st, plan: j_reference_chunk(st, 4, plan, jcfg.fault, 48, apply_fn, mask_fn)
        )(jstate, to_jax(1, leaves))
    want = j_summarize(jstate, log_total=jcfg.fault.log_total)
    want.update(config_fingerprint=jcfg.fingerprint(), engine="fused", pipeline_depth=2)
    _assert_report_matches(want, got)
    if long_log:
        assert 0 < got["slots_replicated"] < 64 * 24 and "replicated_frac" in got
    assert got["violations"] == 0


def test_until_all_chosen_waits_for_the_whole_log():
    """A long-log campaign with until_all_chosen stops once every instance
    replicated all log_total slots (LongLog.done_flag), probed per dispatch."""
    tcfg = TC.config3_long(n_inst=32, log_total=8, window=4, seed=6)
    _, plan = _jax_plan(JC.config3_long(n_inst=32, log_total=8, window=4, seed=6))
    report, state = trun.run(
        tcfg, chunk=8, until_all_chosen=True, max_ticks=512, plan=plan, device="cpu",
        return_state=True,
    )
    assert report["replicated_frac"] == 1.0 and report["slots_replicated"] == 32 * 8
    assert report["ticks"] < 512 and report["ticks"] % 8 == 0
    assert bool(trun.LongLog(tcfg).done_flag(state))
    assert trun.make_longlog(TC.config3_multipaxos(32)) is None
    with pytest.raises(ValueError, match="long-log"):
        trun.make_advance_grouped(TC.config2_dueling_drop(32), plan, compact=True)
