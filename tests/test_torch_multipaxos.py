"""The port's Multi-Paxos against the JAX package, bit for bit.

Every check holds the port's plain version (``mp_counter_masks`` +
``apply_tick_mp``, ``mp_learner_observe``, the fused chunk on the CPU)
against the JAX package's own functions and ``reference_chunk`` with
``fused_fns("multipaxos")``, never the Pallas interpreter, with tolerance 0
(the state is all int32/bool).  Random but protocol-shaped states are made
with numpy from fixed seeds and handed to both packages as the same leaves.
The long-log mode is in tests/test_torch_longlog.py; the CUDA kernel's own
tests need a card and live in tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paxos_tpu.check import mp_safety as jmp_safety
from paxos_tpu.core.mp_state import MPLearnerState as JLearner
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import check_tick_budget as j_check_tick_budget
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels import fused_tick as jfused
from paxos_tpu_torch import interop
from paxos_tpu_torch.check import mp_safety as tmp_safety
from paxos_tpu_torch.core.mp_state import MPLearnerState, MultiPaxosState
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import counter_prng as tcp
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols.multipaxos import apply_tick_mp, mp_counter_masks
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)

GOLDEN = "4b6525460815d9c5"  # tests/test_gray.py _GOLDEN_CTR["config3"]
N = 256
N_LEAVES = 30


def random_mp_leaves(rng, n_prop, n_acc, log_len, k, n, tick=40):
    """A protocol-shaped random Multi-Paxos state, as leaves in flatten
    order: ballots of a few rounds, packed pairs of own_slot_value
    commands (some disagreeing), learner rows below quorum on unchosen
    slots and chosen slots holding their value and tick, in-flight
    messages of every kind, a compacted base."""
    bals = np.array([r * 8 + p + 1 for r in range(4) for p in range(n_prop)], np.int32)
    vals = np.array([1000, 1001, 1002, 2000, 2003], np.int32)

    def bal(shape, zero=0.2):
        return np.where(rng.random(shape) < zero, 0, rng.choice(bals, size=shape)).astype(np.int32)

    def val(shape):
        return rng.choice(vals, size=shape).astype(np.int32)

    def bv(shape, zero=0.3):
        b = bal(shape, zero)
        return np.where(b > 0, (b << 16) | val(shape), 0).astype(np.int32)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    acc, prop, edge = (n_acc, n), (n_prop, n), (n_prop, n_acc, n)
    slot, lk = (2, n_prop, n_acc, n), (log_len, k, n)
    chosen = rng.random((log_len, n)) < 0.3
    lt_mask = ints(0, 1 << n_acc, lk)
    lt_mask = np.where(chosen[:, None], lt_mask, lt_mask & 0b11).astype(np.int32)
    return [
        bal(acc, 0.3), bv((n_acc, log_len, n)),
        bal(prop, 0.0), ints(0, 3, prop), ints(0, 1 << n_acc, prop), ints(0, log_len + 1, prop),
        bv((n_prop, log_len, n)), ints(-8, 40, prop), ints(0, log_len + 1, prop), ints(0, 12, prop),
        bv(lk, 0.4), lt_mask, chosen, np.where(chosen, val((log_len, n)), 0).astype(np.int32),
        np.where(chosen, ints(0, 30, (log_len, n)), -1).astype(np.int32),
        np.zeros(n, np.int32), np.zeros(n, np.int32),
        bal(slot), val(slot), ints(0, log_len, slot), rng.random(slot) < 0.6,
        rng.random(edge) < 0.5, bal(edge), bv((n_prop, n_acc, log_len, n)),
        rng.random(edge) < 0.5, bal(edge), ints(0, log_len, edge), val(edge),
        np.array(tick, np.int32), ints(0, 3, (n,)),
    ]


def _np(x):
    return np.asarray(jax.device_get(x))


def _digest(leaves):
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()[:16]


def _assert_leaves_equal(want, got):
    assert len(want) == len(got) == N_LEAVES
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")


@functools.lru_cache(maxsize=None)
def _treedefs():
    """The JAX package's Multi-Paxos state and plan structures (shape-free)."""
    jcfg = JC.config3_multipaxos(8)
    return jax.tree.structure(j_init_state(jcfg)), jax.tree.structure(j_init_plan(jcfg))


def to_jax(which: int, leaves):
    return jax.tree.unflatten(_treedefs()[which], [jnp.asarray(np.asarray(x)) for x in leaves])


def plan_leaves(cfg, seed):
    """chip_smoke's numpy plan of ``cfg``'s distribution, as numpy leaves."""
    return [x.numpy() for x in chip_smoke.config_plan(cfg, seed, "cpu").leaves()]


@functools.lru_cache(maxsize=None)
def jax_tick(fault):
    from paxos_tpu.protocols.multipaxos import apply_tick_mp as j_apply
    from paxos_tpu.protocols.multipaxos import mp_counter_masks as j_masks

    return jax.jit(lambda st, seed, plan: j_apply(st, j_masks(fault, seed, st), plan, fault))


@functools.lru_cache(maxsize=None)
def _jax_chunk(fault, clamp):
    """The JAX package's reference_chunk of Multi-Paxos, jitted once per
    config with the tick count traced; ``clamp`` adds its packed engine's
    per-tick ballot clamp (``_saturate_ballots``)."""
    apply_fn, mask_fn, _ = jfused.fused_fns("multipaxos")
    if clamp:
        codec = _mp_codec()
        plain = apply_fn

        def apply_fn(st, masks, plan, cfg):
            return jfused._saturate_ballots(codec, plain(st, masks, plan, cfg))

    return jax.jit(
        lambda st, seed, plan, blk, n: jfused.reference_chunk(
            st, seed, plan, fault, n, apply_fn, mask_fn, blk_id=blk
        )
    )


def jax_chunk(fault, n_ticks, clamp=False):
    return lambda st, seed, plan, blk: _jax_chunk(fault, clamp)(st, seed, plan, blk, n_ticks)


@functools.lru_cache(maxsize=None)
def _mp_codec():
    from paxos_tpu.utils import bitops

    return bitops.codec_for("multipaxos", j_init_state(JC.config3_multipaxos(8)))


def test_golden_digest_from_the_jax_plan():
    """config3 at 256 lanes, seed 7, 32 ticks gives the recorded digest on
    the plan the JAX package samples (with the threefry stream the golden
    was recorded under)."""
    jcfg, tcfg = JC.config3_multipaxos(N, 7), TC.config3_multipaxos(N, 7)
    with jax.threefry_partitionable(False):
        jplan = j_init_plan(jcfg)
    plan = interop.plan_from_numpy([_np(x) for x in jax.tree.leaves(jplan)])
    assert plan.pcrash_start.lt(32).any()  # proposers crash inside the window
    state = tfused.fused_multipaxos_chunk(trun.init_state(tcfg, "cpu"), 7, plan, tcfg.fault, 32)
    assert _digest(interop.state_to_numpy(state)) == GOLDEN


def test_numpy_plan_golden_is_the_jax_packages():
    """chip_smoke.py pins K5's golden on its own numpy plan; the JAX
    package's reference_chunk gives that digest from the same plan."""
    jcfg, tcfg = JC.config3_multipaxos(N, 7), TC.config3_multipaxos(N, 7)
    leaves = plan_leaves(tcfg, 7)
    want = jax_chunk(jcfg.fault, 32)(j_init_state(jcfg), 7, to_jax(1, leaves), 0)
    assert _digest(_np(x) for x in jax.tree.leaves(want)) == chip_smoke.MP_GOLDEN
    got = tfused.fused_multipaxos_chunk(
        trun.init_state(tcfg, "cpu"), 7, interop.plan_from_numpy(leaves), tcfg.fault, 32
    )
    assert _digest(interop.state_to_numpy(got)) == chip_smoke.MP_GOLDEN


@pytest.mark.parametrize("shape", [(2, 5, 4, 4), (2, 3, 8, 4)])
def test_apply_tick_mp_matches_tick_by_tick(shape):
    n_prop, n_acc, log_len, k = shape
    rng = np.random.default_rng(sum(shape))
    base = TC.config3_multipaxos(N, 4)
    fault = dataclasses.replace(base.fault, p_equiv=0.3, p_crash=0.3, crash_max_start=48)
    tcfg = dataclasses.replace(base, n_acc=n_acc, log_len=log_len, fault=fault)
    jcfg = dataclasses.replace(JC.config3_multipaxos(N, 4), n_acc=n_acc, log_len=log_len)
    jcfg = dataclasses.replace(jcfg, fault=jcfg.fault.__class__(**dataclasses.asdict(fault)))
    pl = plan_leaves(tcfg, 11)
    assert pl[2].any() and (pl[0] < 48).any() and (pl[3] < 48).any()
    leaves = random_mp_leaves(rng, n_prop, n_acc, log_len, k, N)
    jstate, jplan = to_jax(0, leaves), to_jax(1, pl)
    tstate0 = interop.state_from_numpy(leaves, protocol="multipaxos")
    tstate, tplan = tstate0, interop.plan_from_numpy(pl)
    for _ in range(4):
        tick = int(tstate.tick)
        jstate = jax_tick(jcfg.fault)(jstate, jnp.asarray(tcp.mix(4, tick, 0).numpy()), jplan)
        masks = mp_counter_masks(tcfg.fault, int(tcp.mix_u32(4, tick, 0)), tstate)
        tstate = apply_tick_mp(tstate, masks, tplan, tcfg.fault)
        _assert_leaves_equal([_np(x) for x in jax.tree.leaves(jstate)], interop.state_to_numpy(tstate))
    # The random states reach the recovery fold, the log writes, evictions
    # and the checker.
    assert not torch.equal(tstate.proposer.recov_bv, tstate0.proposer.recov_bv)
    assert not torch.equal(tstate.acceptor.log, tstate0.acceptor.log)
    assert int(tstate.learner.violations.sum()) > 0
    assert int(tstate.learner.evictions.sum()) > 0


def test_mp_learner_observe_matches():
    rng = np.random.default_rng(21)
    n_acc, log_len, k = 5, 8, 4
    leaves = random_mp_leaves(rng, 2, n_acc, log_len, k, N)[10:17]
    jl = jax.tree.unflatten(
        jax.tree.structure(JLearner.init(N, log_len, k)), [jnp.asarray(x) for x in leaves]
    )
    tl = MPLearnerState(*(torch.from_numpy(np.asarray(x).copy()) for x in leaves))
    ev_flag = rng.random((n_acc, N)) < 0.7
    # Few slots and many ballots: rows overflow (evictions), values clash
    # (violations), some events re-confirm chosen values, some fall out of
    # the window.
    ev_slot = rng.choice(np.array([0, 1, 1, 2, -1, 8], np.int32), (n_acc, N))
    ev_bal = rng.choice(np.array([0, 1, 2, 9, 10, 17, 25, 33], np.int32), (n_acc, N))
    ev_val = rng.choice(np.array([1000, 1001, 2000], np.int32), (n_acc, N))
    want = jax.jit(functools.partial(jmp_safety.mp_learner_observe, quorum=3))(
        jl, jnp.asarray(ev_flag), jnp.asarray(ev_bal), jnp.asarray(ev_slot),
        jnp.asarray(ev_val), jnp.int32(9),
    )
    got = tmp_safety.mp_learner_observe(
        tl, *(torch.from_numpy(x) for x in (ev_flag, ev_bal, ev_slot, ev_val)),
        torch.tensor(9, dtype=torch.int32), 3,
    )
    for w, g in zip(jax.tree.leaves(want), got.leaves(), strict=True):
        np.testing.assert_array_equal(_np(w), g.numpy())
    assert int(got.evictions.sum()) > 50 and int(got.violations.sum()) > 0
    assert not torch.equal(got.chosen, tl.chosen)


def test_near_limit_ballots_clamp_and_hoist_switch():
    """Multi-Paxos clamps ballots at 2047 and its packed 12-bit field leaves
    128 ticks of headroom: a longer chunk clamps after every tick, as the
    JAX package's packed engine does, and that differs from clamping at
    the chunk boundaries only."""
    codec = _mp_codec()
    assert tfused.report_ballot_limit("multipaxos") == jfused.report_ballot_limit("multipaxos") == 2047
    assert tfused.ballot_hoist_safe_ticks("multipaxos") == jfused.ballot_hoist_safe_ticks("multipaxos", codec) == 128
    assert tfused.ballot_hoist_safe_ticks() == 6144
    jcfg, tcfg = JC.config3_multipaxos(N, 13), TC.config3_multipaxos(N, 13)
    pl = plan_leaves(tcfg, 13)
    init = chip_smoke.near_limit_state_mp(tcfg, 254, device="cpu")
    chunk = tfused.FUSED_CHUNKS["multipaxos"]
    plan = interop.plan_from_numpy(pl)
    for n_ticks, per_tick in ((160, True), (96, False)):
        got = chunk(init.clone(), 13, plan, tcfg.fault, n_ticks)
        js = to_jax(0, interop.state_to_numpy(init))
        want = jax_chunk(jcfg.fault, n_ticks, clamp=per_tick)(js, 13, to_jax(1, pl), 0)
        if not per_tick:
            want = jfused._saturate_ballots(codec, want)
        _assert_leaves_equal([_np(x) for x in jax.tree.leaves(want)], interop.state_to_numpy(got))
        assert int(got.proposer.bal.max()) == 2047
    boundary = jfused._saturate_ballots(
        codec, jax_chunk(jcfg.fault, 160)(to_jax(0, interop.state_to_numpy(init)), 13, to_jax(1, pl), 0)
    )
    per_tick = chunk(init.clone(), 13, plan, tcfg.fault, 160)
    assert any(
        not np.array_equal(_np(w), g)
        for w, g in zip(jax.tree.leaves(boundary), interop.state_to_numpy(per_tick))
    )


def test_init_state_fingerprint_and_budgets_match():
    for jcfg, tcfg in (
        (JC.config3_multipaxos(N, 0), TC.config3_multipaxos(N, 0)),
        (JC.config3_long(64, 1), TC.config3_long(64, 1)),
    ):
        want = [_np(x) for x in jax.tree.leaves(j_init_state(jcfg))]
        tstate = trun.init_state(tcfg, "cpu")
        assert isinstance(tstate, MultiPaxosState)
        _assert_leaves_equal(want, interop.state_to_numpy(tstate))
        assert tcfg.fingerprint() == jcfg.fingerprint()
        assert dataclasses.asdict(tcfg.fault) == dataclasses.asdict(jcfg.fault)
        back = interop.state_from_numpy(want, protocol="multipaxos")
        _assert_leaves_equal(want, interop.state_to_numpy(back))
    # The tick budget is the 18-bit signed chosen_tick of Multi-Paxos.
    for ticks in (131071, 131072):
        outcomes = []
        for check in (j_check_tick_budget, trun.check_tick_budget):
            try:
                check("multipaxos", ticks)
                outcomes.append(True)
            except ValueError:
                outcomes.append(False)
        assert outcomes == [ticks == 131071] * 2
    # Config-time guards: the 6-bit commit_idx window and both value budgets.
    bad = (
        dataclasses.replace(TC.config3_multipaxos(64), log_len=64),
        TC.config3_long(64, log_total=60000),
        dataclasses.replace(TC.config3_long(64, log_total=2000), n_prop=7),
    )
    for tcfg in bad:
        jcfg = dataclasses.replace(
            JC.config3_long(64), n_prop=tcfg.n_prop, log_len=tcfg.log_len,
            fault=JC.config3_long(64).fault.__class__(**dataclasses.asdict(tcfg.fault)),
        )
        with pytest.raises(ValueError):
            j_init_state(jcfg)
        with pytest.raises(ValueError):
            trun.init_state(tcfg, "cpu")


def test_multiblock_stream_matches_per_block_reference():
    """256 lanes in 4 stream blocks of 64 in one pass equal the JAX
    reference run block by block with blk_id=b."""
    n, block, ticks, seed = 256, 64, 48, 5
    tcfg = TC.config3_multipaxos(n, seed)
    jcfg = JC.config3_multipaxos(block, seed)
    pl = plan_leaves(tcfg, seed)
    js = j_init_state(jcfg)
    per_block = []
    for b in range(4):
        jp = to_jax(1, [x[..., b * block:(b + 1) * block] for x in pl])
        per_block.append([_np(x) for x in jax.tree.leaves(jax_chunk(jcfg.fault, ticks)(js, seed, jp, b))])
    want = [np.concatenate(p, axis=-1) if p[0].ndim else p[0] for p in zip(*per_block)]
    got = tfused.fused_multipaxos_chunk(
        trun.init_state(tcfg, "cpu"), seed, interop.plan_from_numpy(pl), tcfg.fault, ticks, block=block
    )
    _assert_leaves_equal(want, interop.state_to_numpy(got))
    assert not np.array_equal(per_block[0][2], per_block[1][2])


def test_checker_pin_is_the_jax_packages():
    """chip_smoke.py's Multi-Paxos checker case (config3 with p_equiv 0.4,
    1024 lanes, 300 ticks, its numpy plan) reports the violations the JAX
    package counts, and they are many."""
    tcfg = chip_smoke.mp_checker_config()
    jcfg = dataclasses.replace(
        JC.config3_multipaxos(tcfg.n_inst, tcfg.seed),
        fault=JC.config3_multipaxos().fault.__class__(**dataclasses.asdict(tcfg.fault)),
    )
    pl = plan_leaves(tcfg, tcfg.seed)
    block = 256  # the port's stream block: the JAX reference runs block by block
    jcfg = dataclasses.replace(jcfg, n_inst=block)
    violations = 0
    for b in range(tcfg.n_inst // block):
        jp = to_jax(1, [x[..., b * block:(b + 1) * block] for x in pl])
        want = jax_chunk(jcfg.fault, 300)(j_init_state(jcfg), tcfg.seed, jp, b)
        assert int(_np(want.proposer.bal).max()) < 2047  # the run's clamps were the identity
        violations += int(_np(want.learner.violations).sum())
    assert violations == chip_smoke.MP_CHECKER_VIOLATIONS > 500
