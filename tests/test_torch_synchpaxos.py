"""The port's SynchPaxos and bounded-delay channel against the JAX package,
bit for bit.

Random but protocol-shaped states, with delay stamps in past, present and
future ticks, are made with numpy from fixed seeds and handed to both
packages as the same leaves, with the fault plan the JAX package samples
(its ``link_delay`` included); ``apply_tick_sp`` with ``counter_masks``,
``delay_stamps``, ``ready``, ``send(until=)``, the initial state, the
config fingerprint, the state and plan exchange, a multi-block stream and
``run`` reports must then agree exactly (tolerance 0: the state is all
int32/bool; the report's float32 fractions to a relative 1e-6).  The
golden digest and the checker count that ``chip_smoke.py`` pins for K4
are computed here with the JAX package.  JAX helpers are jitted once per
config and shape (the chunk's tick count is traced), and a JAX plan is
built from its leaves, not sampled again for its structure.  The CUDA
kernel's own tests need a card and live in tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import jax_plan_of, one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu.core.messages import MsgBuf as JMsgBuf
from paxos_tpu.faults.injector import FaultConfig as JFaultConfig
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.harness.run import summarize as j_summarize
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.core.messages import MsgBuf
from paxos_tpu_torch.core.sp_state import FAST, SynchPaxosState
from paxos_tpu_torch.faults.injector import FaultConfig
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import counter_prng as tcp
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols import paxos as tpaxos
from paxos_tpu_torch.protocols.synchpaxos import apply_tick_sp, fast_path_rate
from paxos_tpu_torch.transport import inmemory as tnet
from paxos_tpu_torch.utils.bitops import popcount

N = 256
TICK = 5
FLOAT_FIELDS = ("chosen_frac", "mean_choose_tick", "decided_frac")


def _chaos(n, seed, violate=False, **knobs):
    pair = JC.config_delay_chaos(n, seed, violate), TC.config_delay_chaos(n, seed, violate)
    return tuple(dataclasses.replace(c, fault=dataclasses.replace(c.fault, **knobs)) for c in pair)


def _delay_off(n, seed):
    """SynchPaxos without delay (no stamps), as ``chip_smoke.py`` runs it:
    loss, idling and a short timeout, as the JAX package's ballot-stride
    case runs it; the JAX config from the same fields."""
    tcfg = chip_smoke.sp_delay_off_config(n, seed)
    jcfg = JC.SimConfig(
        n_inst=n, n_prop=tcfg.n_prop, n_acc=tcfg.n_acc, seed=seed, protocol=tcfg.protocol,
        fault=JFaultConfig(**dataclasses.asdict(tcfg.fault)),
    )
    return jcfg, tcfg


# (JAX config, port config) pairs for one tick: both delay regimes, the
# planted bug under delta-violating delays, and SynchPaxos without delay.
CONFIGS = {
    "delay_chaos": lambda: _chaos(N, 3),
    "violate_delta": lambda: _chaos(N, 3, True),
    "violate_unsafe_fast": lambda: _chaos(N, 3, True, sp_unsafe_fast=True, p_drop=0.4),
    "delay_off": lambda: _delay_off(N, 3),
}


def random_state_leaves(rng, n_prop, n_acc, k, n, stamped, tick=TICK):
    """A protocol-shaped random SynchPaxos state, as leaves in flatten
    order: the leader's round-0 ballot and a few classic rounds, every
    phase (FAST included), timers around 0 and the window, PROMISE payloads
    that often match, and (``stamped``) delay stamps before, at and after
    ``tick``."""
    ballots = np.array([1] + [r * 8 + p + 1 for r in range(1, 4) for p in range(n_prop)], np.int32)
    vals = np.array([0, 100, 101], np.int32)

    def bal(shape, zero=0.2):
        b = rng.choice(ballots, size=shape)
        return np.where(rng.random(shape) < zero, 0, b).astype(np.int32)

    def val(shape):
        return rng.choice(vals, size=shape).astype(np.int32)

    def mask(shape):
        return rng.integers(0, 1 << n_acc, shape).astype(np.int32)

    acc, prop, kk = (n_acc, n), (n_prop, n), (k, n)
    slot = (2, n_prop, n_acc, n)
    pid = np.broadcast_to(np.arange(n_prop, dtype=np.int32)[:, None], prop)
    promised = bal(acc, 0.3)
    acc_bal = np.minimum(promised, bal(acc, 0.4))
    acc_bal[:, ::17] = promised[:, ::17] + 8  # a few acceptance-bound breaks
    prop_bal = bal(prop, 0.0)
    timer = np.where(rng.random(prop) < 0.3, 0, rng.integers(-8, 12, prop)).astype(np.int32)
    leaves = [
        promised, acc_bal, np.where(acc_bal > 0, val(acc), 0).astype(np.int32),
        prop_bal, rng.integers(0, 4, prop).astype(np.int32), (pid + 100).astype(np.int32),
        val(prop), mask(prop), bal(prop, 0.5), val(prop), timer, val(prop),
        bal(kk, 0.3), val(kk), mask(kk), rng.random(n) < 0.3, val((n,)),
        rng.integers(-1, 20, (n,)).astype(np.int32), np.zeros((n,), np.int32),
        np.zeros((n,), np.int32),
    ]
    stamps = np.array([0, tick - 2, tick, tick + 1, tick + 3], np.int32)
    for _ in range(2):  # requests, replies
        rbal = np.where(rng.random(slot) < 0.5, prop_bal[None, :, None, :], bal(slot)).astype(np.int32)
        leaves += [rbal, bal(slot), val(slot), rng.random(slot) < 0.6]
        if stamped:
            leaves.append(rng.choice(stamps, size=slot).astype(np.int32))
    leaves.append(np.array(tick, np.int32))
    return leaves


def _np(x):
    return np.asarray(jax.device_get(x))


@functools.lru_cache(maxsize=None)
def _state_treedef(stamped: bool):
    jcfg = _chaos(N, 0)[0] if stamped else _delay_off(N, 0)[0]
    return jax.tree.structure(j_init_state(jcfg))


def _to_jax_state(leaves):
    treedef = _state_treedef(len(leaves) == 31)
    return jax.tree.unflatten(treedef, [jnp.asarray(np.asarray(x)) for x in leaves])


def _jax_plan(jcfg):
    """The plan the JAX package samples for ``jcfg``, and its leaves."""
    jplan = j_init_plan(jcfg)
    return jplan, [_np(x) for x in jax.tree.leaves(jplan)]


def _digest(leaves):
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()[:16]


def _assert_leaves_equal(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")


@functools.lru_cache(maxsize=None)
def jax_tick(fault):
    from paxos_tpu.protocols.paxos import counter_masks
    from paxos_tpu.protocols.synchpaxos import apply_tick_sp as j_apply

    return jax.jit(lambda st, seed, plan: j_apply(st, counter_masks(fault, seed, st), plan, fault))


@functools.lru_cache(maxsize=None)
def _jax_chunk(fault):
    apply_fn, mask_fn, _ = fused_fns("synchpaxos")
    return jax.jit(
        lambda st, seed, plan, blk, n_ticks: j_reference_chunk(
            st, seed, plan, fault, n_ticks, apply_fn, mask_fn, blk_id=blk
        )
    )


def jax_chunk(fault, n_ticks):
    """The JAX package's fused reference over ``n_ticks`` ticks: one
    compile per config and shape, whatever the tick count."""
    return lambda st, seed, plan, blk: _jax_chunk(fault)(st, seed, plan, blk, n_ticks)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_tick_sp_matches(name):
    jcfg, tcfg = CONFIGS[name]()
    stamped = tcfg.fault.p_delay > 0
    rng = np.random.default_rng(300 + sorted(CONFIGS).index(name))
    leaves = random_state_leaves(rng, 2, 5, 8, N, stamped)
    jplan, plan_leaves = _jax_plan(jcfg)
    assert len(plan_leaves) == (10 if stamped else 9)
    tplan = interop.plan_from_numpy(plan_leaves, cfg=tcfg.fault)
    jstate = jax_tick(jcfg.fault)(
        _to_jax_state(leaves), jnp.asarray(tcp.mix(tcfg.seed, TICK, 0).numpy()), jplan
    )
    tstate0 = interop.state_from_numpy(leaves, protocol="synchpaxos")
    masks = tpaxos.counter_masks(tcfg.fault, int(tcp.mix_u32(tcfg.seed, TICK, 0)), tstate0)
    tstate = apply_tick_sp(tstate0, masks, tplan, tcfg.fault)
    _assert_leaves_equal([_np(x) for x in jax.tree.leaves(jstate)], interop.state_to_numpy(tstate))
    # The random states reach a fast decide, a window expiry and, with
    # delay, a stamped send and a slot held back by its stamp.
    ph0, ph1 = tstate0.proposer.phase, tstate.proposer.phase
    fast_decide = (ph0 == FAST) & (ph1 == 2)
    assert fast_decide.any()
    if tcfg.fault.sp_unsafe_fast:  # decides without a quorum
        assert (fast_decide & (popcount(tstate.proposer.heard) < 3)).any()
    else:
        assert ((ph0 == FAST) & (ph1 == 0)).any()
    if stamped:
        new_stamp = (tstate.requests.until > TICK) & (tstate.requests.until != tstate0.requests.until)
        new_stamp |= (tstate.replies.until > TICK) & (tstate.replies.until != tstate0.replies.until)
        assert new_stamp.any()
        held = tstate0.replies.present & (tstate0.replies.until > TICK) & tstate.replies.present
        assert held.any()


def test_delay_stamps_ready_and_send_match():
    from paxos_tpu.protocols.paxos import delay_stamps as j_delay_stamps
    from paxos_tpu.transport import inmemory_tpu as jnet

    jcfg, tcfg = _chaos(N, 4)
    rng = np.random.default_rng(41)
    state = interop.state_from_numpy(random_state_leaves(rng, 2, 5, 8, N, True), protocol="synchpaxos")
    masks = tpaxos.counter_masks(tcfg.fault, 12345, state)
    cap = rng.integers(0, 3, (2, 5, N)).astype(np.int32)
    plan = types.SimpleNamespace(link_delay=torch.from_numpy(cap))
    tick = torch.tensor(TICK, dtype=torch.int32)
    got = tpaxos.delay_stamps(masks, plan, tcfg.fault, tick)
    want = j_delay_stamps(
        types.SimpleNamespace(delay_bits=jnp.asarray(masks.delay_bits.numpy()),
                              lat_bits=jnp.asarray(masks.lat_bits.numpy())),
        types.SimpleNamespace(link_delay=jnp.asarray(cap)), jcfg.fault, jnp.int32(TICK),
    )
    for w, g in zip(want[:2], got, strict=True):
        np.testing.assert_array_equal(_np(w), g.numpy())
    assert (got[0] > 0).any() and (got[1] == 0).any()
    assert tpaxos.delay_stamps(masks, plan, FaultConfig(), tick) == (None, None)

    # ready, and send with a stamp (drops write nothing) or without one (0).
    buf = state.requests
    jbuf = JMsgBuf(*(jnp.asarray(x.numpy()) for x in buf.leaves()))
    np.testing.assert_array_equal(_np(jnet.ready(jbuf, jnp.int32(TICK))), tnet.ready(buf, tick).numpy())
    send_mask = rng.random((2, 5, N)) < 0.5
    keep = rng.random((2, 5, N)) < 0.7
    bal = rng.integers(1, 30, (2, 1, N)).astype(np.int32)
    for kind, until in ((1, got[0][1]), (0, None)):
        out = tnet.send(
            buf, kind, torch.from_numpy(send_mask), torch.from_numpy(bal), torch.from_numpy(bal),
            torch.zeros_like(torch.from_numpy(bal)), keep=torch.from_numpy(keep), until=until,
        )
        jout = jnet.send(
            jbuf, kind, jnp.asarray(send_mask), jnp.asarray(bal), jnp.asarray(bal),
            jnp.zeros_like(jnp.asarray(bal)), keep=jnp.asarray(keep),
            until=None if until is None else jnp.asarray(until.numpy()),
        )
        _assert_leaves_equal([_np(x) for x in jax.tree.leaves(jout)], [x.numpy() for x in out.leaves()])
        dropped = torch.from_numpy(send_mask & ~keep)
        assert torch.equal(out.until[kind][dropped], buf.until[kind][dropped])
    assert tnet.ready(MsgBuf.empty(N, 2, 5), tick) is None


def test_init_state_fingerprint_and_exchange_match():
    for jcfg, tcfg in (_chaos(N, 0), _chaos(N, 0, True), _delay_off(N, 0)):
        want = [_np(x) for x in jax.tree.leaves(j_init_state(jcfg))]
        tstate = trun.init_state(tcfg, "cpu")
        assert isinstance(tstate, SynchPaxosState)
        assert len(want) == (31 if tcfg.fault.p_delay else 29)
        _assert_leaves_equal(want, interop.state_to_numpy(tstate))
        assert tcfg.fingerprint() == jcfg.fingerprint()
        assert dataclasses.asdict(tcfg.fault) == dataclasses.asdict(jcfg.fault)
        back = interop.state_from_numpy(want, protocol="synchpaxos")
        assert back.stamped == int(tcfg.fault.p_delay > 0)
        _assert_leaves_equal(want, interop.state_to_numpy(back))
    # The plan the JAX package samples carries across with its link_delay,
    # told apart from part_dir (also an optional tenth leaf) by the config.
    jcfg, tcfg = _chaos(N, 2)
    _, plan_leaves = _jax_plan(jcfg)
    plan = interop.plan_from_numpy(plan_leaves, cfg=tcfg.fault)
    _assert_leaves_equal(plan_leaves, [x.numpy() for x in plan.leaves()])
    assert plan.link_delay.shape == (2, 5, N) and int(plan.link_delay.max()) == 2
    with pytest.raises(ValueError, match="cfg="):
        interop.plan_from_numpy(plan_leaves)
    with pytest.raises(ValueError, match="part_dir"):  # a config with p_asym wants 11 leaves
        interop.plan_from_numpy(plan_leaves, cfg=dataclasses.replace(tcfg.fault, p_asym=0.5))
    with pytest.raises(ValueError, match="plan="):
        trun.init_plan(tcfg, "cpu")
    none = tfused.FaultPlan.none(N, 5, 2, cfg=tcfg.fault)
    assert len(none.leaves()) == 10 and not none.link_delay.any()


def test_multiblock_stream_matches_per_block_reference():
    """256 lanes in 4 stream blocks of 64 in one pass equal the JAX
    reference run block by block with blk_id=b, each on its slice of the
    plan the JAX package samples for the 256 lanes."""
    n, block, ticks, seed = 256, 64, 48, 5
    jcfg, tcfg = _chaos(n, seed)
    jplan, plan_leaves = _jax_plan(jcfg)
    small = _chaos(block, seed)[0]
    plan_def = jax.tree.structure(jplan)  # the plan's structure, whatever its lanes
    js = j_init_state(small)
    per_block = []
    for b in range(4):
        jp = jax.tree.unflatten(plan_def, [jnp.asarray(x[..., b * block:(b + 1) * block]) for x in plan_leaves])
        per_block.append([_np(x) for x in jax.tree.leaves(jax_chunk(jcfg.fault, ticks)(js, seed, jp, b))])
    want = [np.concatenate(p, axis=-1) if p[0].ndim else p[0] for p in zip(*per_block)]
    got = tfused.reference_chunk(
        trun.init_state(tcfg, "cpu"), seed, interop.plan_from_numpy(plan_leaves, cfg=tcfg.fault),
        tcfg.fault, ticks, block=block, apply_fn=apply_tick_sp,
    )
    _assert_leaves_equal(want, interop.state_to_numpy(got))
    assert not np.array_equal(per_block[0][3], per_block[1][3])
    assert (got.requests.until > 0).any()


def _assert_report_matches(want, got):
    assert set(want) == set(got), (sorted(want), sorted(got))
    for key, w in want.items():
        if key in FLOAT_FIELDS:
            assert got[key] == pytest.approx(w, rel=1e-6), key
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("name", ["delay_chaos", "violate_unsafe_fast"])
def test_run_report_and_fast_path_rate_match_reference(name):
    from paxos_tpu.protocols.synchpaxos import fast_path_rate as j_fast_path_rate

    jcfg, tcfg = CONFIGS[name]()
    ticks = 96
    jplan, plan_leaves = _jax_plan(jcfg)
    got, state = trun.run(
        tcfg, total_ticks=ticks, chunk=32, pipeline_depth=2, device="cpu", return_state=True,
        plan=interop.plan_from_numpy(plan_leaves, cfg=tcfg.fault),
    )
    jstate = jax_chunk(jcfg.fault, ticks)(j_init_state(jcfg), jcfg.seed, jplan, 0)
    want = j_summarize(jstate)
    want.update(config_fingerprint=jcfg.fingerprint(), engine="fused", pipeline_depth=2)
    _assert_report_matches(want, got)
    _assert_leaves_equal([_np(x) for x in jax.tree.leaves(jstate)], interop.state_to_numpy(state))
    assert fast_path_rate(state) == j_fast_path_rate(jstate)
    if name == "delay_chaos":
        assert 0.5 < fast_path_rate(state) < 1.0 and got["violations"] == 0
    else:  # the planted bug: proposers disagree, the learner plane stays blind
        assert got["proposer_disagree"] > 0 and got["violations"] == 0


def test_chip_smoke_golden_and_checker_pins_match_jax_package():
    """``chip_smoke.SP_GOLDEN`` (256 lanes, seed 7, 32 ticks on its numpy
    plan) and ``chip_smoke.SP_CHECKER_DISAGREE`` (the planted bug's
    proposer disagreements on its numpy plan) as the JAX package's fused
    reference computes them; the port's plain version gives the same
    golden."""
    tcfg = chip_smoke.main_config("synchpaxos", 256, 7)
    plan = chip_smoke.config_plan(tcfg, 7, "cpu")
    jcfg = JC.config_delay_chaos(256, 7)
    jplan = jax_plan_of(plan)
    assert jax.tree.structure(jplan) == jax.tree.structure(_jax_plan(jcfg)[0])
    jstate = jax_chunk(jcfg.fault, 32)(j_init_state(jcfg), 7, jplan, 0)
    assert _digest([_np(x) for x in jax.tree.leaves(jstate)]) == chip_smoke.SP_GOLDEN
    tstate = tfused.fused_synchpaxos_chunk(trun.init_state(tcfg, "cpu"), 7, plan, tcfg.fault, 32, block=256)
    assert _digest(interop.state_to_numpy(tstate)) == chip_smoke.SP_GOLDEN

    tcfg = chip_smoke.sp_checker_config()
    ticks = chip_smoke.SP_CHECKER_TICKS
    plan = chip_smoke.config_plan(tcfg, tcfg.seed, "cpu")
    jcfg = JC.config_delay_chaos(tcfg.n_inst, tcfg.seed, True)
    jcfg = dataclasses.replace(jcfg, fault=dataclasses.replace(jcfg.fault, sp_unsafe_fast=True, p_drop=0.4))
    assert dataclasses.asdict(jcfg.fault) == dataclasses.asdict(tcfg.fault)
    report = j_summarize(jax_chunk(jcfg.fault, ticks)(j_init_state(jcfg), tcfg.seed, jax_plan_of(plan), 0))
    assert report["proposer_disagree"] == chip_smoke.SP_CHECKER_DISAGREE > 0
    assert report["violations"] == 0


def test_other_ticks_refuse_delay():
    """Every tick models the bounded delay as the SynchPaxos tick does, and
    every tick but SynchPaxos' raises on sp_unsafe_fast.  The Paxos tick
    takes a stamped state and p_delay: a stamped slot waits as in the
    SynchPaxos tick, and ``run`` asks for the sampled plan the delay needs;
    so do the Fast Paxos and Raft-core ticks, whose opening broadcast,
    stamped for a later tick, waits, and whose sends are stamped."""
    from paxos_tpu_torch.core.fp_state import FastPaxosState
    from paxos_tpu_torch.core.raft_state import RaftState
    from paxos_tpu_torch.protocols.fastpaxos import apply_tick_fast
    from paxos_tpu_torch.protocols.raftcore import apply_tick_raft

    leaves = random_state_leaves(np.random.default_rng(2), 2, 5, 8, 64, True)
    state = interop.state_from_numpy(leaves, protocol="synchpaxos")
    assert state.stamped == 1
    masks = tpaxos.counter_masks(TC.config_delay_chaos(64).fault, 1, state)
    plan = tfused.FaultPlan.none(64, 5, 2)
    paxos = interop.state_from_numpy(leaves, protocol="paxos")
    assert paxos.stamped == 1
    bug = dataclasses.replace(TC.config2_dueling_drop(64).fault, sp_unsafe_fast=True)
    with pytest.raises(NotImplementedError, match="ROADMAP .*item 10"):
        tpaxos.apply_tick(paxos, masks, plan, bug)
    chaos = TC.config_delay_chaos(64, 2)
    delay_plan = chip_smoke.config_plan(chaos, 2, "cpu")
    for cls, apply_fn in ((FastPaxosState, apply_tick_fast), (RaftState, apply_tick_raft)):
        st = cls.init(64, 2, 5, 8, delay=True)
        st.requests.until.copy_(torch.where(st.requests.present, 2, 0))  # arriving at tick 2
        delay_masks = tpaxos.counter_masks(chaos.fault, 1, st)
        out = apply_fn(st, delay_masks, delay_plan, chaos.fault)  # tick 0: nothing has arrived
        assert torch.equal(out.requests.present, st.requests.present)
        assert not out.replies.present.any()
        for _ in range(4):
            out = apply_fn(out, tpaxos.counter_masks(chaos.fault, 1, out), delay_plan, chaos.fault)
        assert out.replies.present.any() and (out.replies.until > 2).any()  # stamped replies
    # A stamped Paxos state: slots whose stamp is ahead of the tick wait.
    out = tpaxos.apply_tick(paxos, masks, plan, TC.config2_dueling_drop(64).fault)
    waiting = paxos.requests.present & (paxos.requests.until > paxos.tick)
    assert waiting.any() and (out.requests.present | ~waiting).all()
    cfg = TC.config2_dueling_drop(64)
    with pytest.raises(ValueError, match="sampled fault plan"):
        trun.run(dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, p_delay=0.3)), device="cpu")
    fp = TC.config5_sweep(64, 1)[1]
    with pytest.raises(ValueError, match="sampled fault plan"):
        trun.run(dataclasses.replace(fp, fault=dataclasses.replace(fp.fault, p_delay=0.3)), device="cpu")
