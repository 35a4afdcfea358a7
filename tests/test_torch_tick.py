"""One tick of the port against the JAX package, bit for bit.

Random but protocol-shaped states are made with numpy from fixed seeds and
handed to both packages as the same leaves; the transport, the safety
checker, ``counter_masks`` and ``apply_tick`` must then agree exactly
(tolerance 0: the state is all int32/bool).  The JAX side runs plain jitted
functions, each compiled once per config and shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paxos_tpu.check import safety as jsafety
from paxos_tpu.core.state import PaxosState as JPaxosState
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.kernels.counter_prng import mix as j_mix
from paxos_tpu.transport import inmemory_tpu as jnet
from paxos_tpu_torch import interop
from paxos_tpu_torch.check import safety as tsafety
from paxos_tpu_torch.core.state import AcceptorState, LearnerState
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.kernels import counter_prng as tcp
from paxos_tpu_torch.protocols import paxos as tpaxos
from paxos_tpu_torch.transport import inmemory as tnet
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)

N = 256
CONFIGS = {
    "config1": (JC.config1_no_faults, TC.config1_no_faults),
    "config2": (JC.config2_dueling_drop, TC.config2_dueling_drop),
    "config4": (JC.config4_byzantine, TC.config4_byzantine),
}


def random_state_leaves(rng, n_prop, n_acc, k, n, tick=5):
    """A protocol-shaped random state, as leaves in flatten order: ballots
    from a small set so replies often match proposers' ballots, values
    from the proposers' own values, some invariant-breaking acceptors."""
    ballots = np.array(
        [r * 8 + p + 1 for r in range(4) for p in range(n_prop)], np.int32
    )
    vals = np.array([0, 100, 101], np.int32)

    def bal(shape, zero=0.2):
        b = rng.choice(ballots, size=shape)
        return np.where(rng.random(shape) < zero, 0, b).astype(np.int32)

    def val(shape):
        return rng.choice(vals, size=shape).astype(np.int32)

    def bools(shape, p=0.5):
        return rng.random(shape) < p

    acc = (n_acc, n)
    prop = (n_prop, n)
    kk = (k, n)
    slot = (2, n_prop, n_acc, n)
    pid = np.broadcast_to(np.arange(n_prop, dtype=np.int32)[:, None], prop)
    promised = bal(acc, 0.3)
    acc_bal = np.minimum(promised, bal(acc, 0.4))
    acc_bal[:, ::17] = promised[:, ::17] + 8  # a few acceptance-bound breaks
    leaves = [
        promised,
        acc_bal,
        np.where(acc_bal > 0, val(acc), 0).astype(np.int32),
        (rng.integers(0, 4, prop) * 8 + pid + 1).astype(np.int32),
        rng.integers(0, 3, prop).astype(np.int32),
        (pid + 100).astype(np.int32),
        val(prop),
        rng.integers(0, 1 << n_acc, prop).astype(np.int32),
        bal(prop, 0.5),
        val(prop),
        rng.integers(-8, 13, prop).astype(np.int32),
        val(prop),
        bal(kk, 0.3),
        val(kk),
        rng.integers(0, 1 << n_acc, kk).astype(np.int32),
        bools((n,), 0.3),
        val((n,)),
        rng.integers(-1, 20, (n,)).astype(np.int32),
        np.zeros((n,), np.int32),
        np.zeros((n,), np.int32),
    ]
    for _ in range(2):  # requests, replies
        leaves += [bal(slot), np.where(bools(slot), bal(slot), val(slot)).astype(np.int32),
                   val(slot), bools(slot)]
    leaves.append(np.array(tick, np.int32))
    return leaves


def to_jax_state(leaves, n_prop, n_acc, k, n):
    treedef = jax.tree.structure(JPaxosState.init(n, n_prop, n_acc, k))
    return jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])


@functools.lru_cache(maxsize=None)
def jax_tick(fault):
    from paxos_tpu.protocols.paxos import apply_tick, counter_masks

    def f(state, tick_seed, plan):
        masks = counter_masks(fault, tick_seed, state)
        return apply_tick(state, masks, plan, fault), masks

    return jax.jit(f)


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counter_masks_and_apply_tick_match(name):
    jmake, tmake = CONFIGS[name]
    jcfg, tcfg = jmake(N, 3), tmake(N, 3)
    P, A, K = tcfg.n_prop, tcfg.n_acc, tcfg.k_slots
    rng = np.random.default_rng(100 + sorted(CONFIGS).index(name))
    leaves = random_state_leaves(rng, P, A, K, N)
    # config4's plan is the JAX package's sampled plan, carried across.
    jplan = j_init_plan(jcfg)
    plan_leaves = [_np(x) for x in jax.tree.leaves(jplan)]
    if name == "config4":
        assert plan_leaves[2].any(), "config4 plan must hold equivocators"
    tplan = interop.plan_from_numpy(plan_leaves)

    seed_u32 = int(tcp.mix_u32(tcfg.seed, 5, 0))
    jstate, jmasks = jax_tick(jcfg.fault)(
        to_jax_state(leaves, P, A, K, N), j_mix(jnp.int32(jcfg.seed), jnp.int32(5), jnp.int32(0)), jplan
    )
    tstate0 = interop.state_from_numpy(leaves)
    tmasks = tpaxos.counter_masks(tcfg.fault, seed_u32, tstate0)
    for field in ("sel_score", "busy", "deliver", "dup_req", "dup_rep", "keep_prom",
                  "keep_accd", "keep_p1", "keep_p2", "backoff"):
        want, got = getattr(jmasks, field), getattr(tmasks, field)
        if want is None:
            assert got is None, field
        else:
            np.testing.assert_array_equal(_np(want), got.numpy(), err_msg=field)
    tstate = tpaxos.apply_tick(tstate0, tmasks, tplan, tcfg.fault)
    want_leaves = [_np(x) for x in jax.tree.leaves(jstate)]
    got_leaves = interop.state_to_numpy(tstate)
    assert len(got_leaves) == len(want_leaves) == 29
    for i, (w, g) in enumerate(zip(want_leaves, got_leaves)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The random states exercise the checker's invariant arm.
    assert got_leaves[18].sum() > 0


def test_select_from_scores_matches():
    rng = np.random.default_rng(11)
    shape = (2, 2, 5, 512)
    present = rng.random(shape) < 0.4
    bits = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)
    bits[:, :, :, :8] = -(1 << 31)  # the INT32_MIN sentinel pattern
    busy = rng.random((1, 1, 5, 512)) < 0.8
    for b in (None, busy):
        want = jnet.select_from_scores(
            jnp.asarray(present), jnp.asarray(bits), None if b is None else jnp.asarray(b)
        )
        got = tnet.select_from_scores(
            torch.from_numpy(present), torch.from_numpy(bits),
            None if b is None else torch.from_numpy(b),
        )
        np.testing.assert_array_equal(_np(want), got.numpy())


def test_learner_observe_and_invariants_match():
    rng = np.random.default_rng(12)
    leaves = random_state_leaves(rng, 2, 5, 8, N)
    jl = jax.tree.leaves(to_jax_state(leaves, 2, 5, 8, N).learner)
    tl = LearnerState(*(torch.from_numpy(np.asarray(x).copy()) for x in leaves[12:20]))
    ev_flag = rng.random((5, N)) < 0.6
    ev_bal = rng.choice(np.array([0, 1, 2, 9, 10], np.int32), (5, N))
    ev_val = rng.choice(np.array([100, 101], np.int32), (5, N))
    from paxos_tpu.core.state import LearnerState as JLearner

    jlearner = jax.tree.unflatten(jax.tree.structure(JLearner.init(N, 8)), jl)
    want = jsafety.learner_observe(
        jlearner, jnp.asarray(ev_flag), jnp.asarray(ev_bal), jnp.asarray(ev_val),
        jnp.int32(9), 3,
    )
    got = tsafety.learner_observe(
        tl, torch.from_numpy(ev_flag), torch.from_numpy(ev_bal),
        torch.from_numpy(ev_val), torch.tensor(9, dtype=torch.int32), 3,
    )
    for w, g in zip(jax.tree.leaves(want), got.leaves()):
        np.testing.assert_array_equal(_np(w), g.numpy())
    assert got.evictions.sum() > 0  # full tables exercise the evict arm

    from paxos_tpu.core.state import AcceptorState as JAcc

    old = [leaves[j] for j in range(3)]
    new = [x + rng.integers(-2, 3, x.shape).astype(np.int32) for x in old]
    honest = rng.random((5, N)) < 0.8
    want_inv = jsafety.acceptor_invariants(
        JAcc(*(jnp.asarray(x) for x in old)), JAcc(*(jnp.asarray(x) for x in new)),
        jnp.asarray(honest),
    )
    got_inv = tsafety.acceptor_invariants(
        AcceptorState(*(torch.from_numpy(x) for x in old)),
        AcceptorState(*(torch.from_numpy(x) for x in new)),
        torch.from_numpy(honest),
    )
    np.testing.assert_array_equal(_np(want_inv), got_inv.numpy())


def test_first_true_matches():
    rng = np.random.default_rng(13)
    mask = rng.random((8, 300)) < 0.2
    for axis in (0, 1):
        np.testing.assert_array_equal(
            _np(jsafety.first_true(jnp.asarray(mask), axis=axis)),
            tsafety.first_true(torch.from_numpy(mask), axis=axis).numpy(),
        )


def test_interop_round_trip_and_init_state_match():
    jstate = JPaxosState.init(N, 2, 5, 8)
    want = [_np(x) for x in jax.tree.leaves(jstate)]
    from paxos_tpu_torch.core.state import PaxosState

    got = interop.state_to_numpy(PaxosState.init(N, 2, 5, 8))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)
    back = interop.state_to_numpy(interop.state_from_numpy(want))
    for w, g in zip(want, back):
        np.testing.assert_array_equal(w, g)
    with pytest.raises(NotImplementedError):
        interop.state_from_numpy(want[:-2])
    bad = list(want)
    bad[20] = bad[20][:, :, :4]  # requests.bal with 4 of 5 acceptors
    with pytest.raises(ValueError, match="leaf 20"):
        interop.state_from_numpy(bad)


def test_unported_knobs_raise():
    """Every tick that shares the single-decree mask sampler (Paxos, Fast
    Paxos, Raft-core, SynchPaxos) models the gray-failure and partition
    knobs and the bounded delay (its draws made where p_delay > 0, on a
    state with stamps or without); the planted SynchPaxos bug still raises
    on every other tick (ROADMAP item 10)."""
    import dataclasses

    from paxos_tpu_torch.core.fp_state import FastPaxosState
    from paxos_tpu_torch.core.raft_state import RaftState
    from paxos_tpu_torch.core.sp_state import SynchPaxosState

    cfg = TC.config2_dueling_drop(64)
    state = interop.state_from_numpy(random_state_leaves(np.random.default_rng(1), 2, 5, 8, 64))
    delayed = [state, SynchPaxosState.init(64, 2, 5, 8)]
    undelayed = [cls.init(64, 2, 5, 8, delay=True) for cls in (FastPaxosState, RaftState)]
    for knob, value in (("p_part", 0.5), ("p_flaky", 0.1), ("stale_k", 8), ("amnesia", True),
                        ("p_delay", 0.2), ("timeout_skew", 3), ("p_corrupt", 0.1)):
        bad = dataclasses.replace(cfg.fault, **{knob: value})
        for ported in delayed + undelayed:
            masks = tpaxos.counter_masks(bad, 1, ported)
            assert (masks.delay_bits is not None) == (knob == "p_delay")
            assert (masks.lat_bits is not None) == (knob == "p_delay")
    bug = dataclasses.replace(cfg.fault, sp_unsafe_fast=True)
    for other in [state] + undelayed:
        with pytest.raises(NotImplementedError, match="ROADMAP .*item 10"):
            tpaxos.counter_masks(bug, 1, other)
