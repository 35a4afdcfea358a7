"""The port's Fast Paxos against the JAX package, bit for bit.

Random but protocol-shaped states are made with numpy from fixed seeds and
handed to both packages as the same leaves; ``apply_tick_fast``, the
fast-quorum learner, the initial state, the counter-stream golden digest,
a multi-block stream and the config fingerprint must then agree exactly
(tolerance 0: the state is all int32/bool).  ``run`` reports are held to
the JAX package in tests/test_torch_sweep.py.  JAX helpers are jitted
once per config and shape.  The CUDA kernel's
own tests need a card and live in tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paxos_tpu.check import safety as jsafety
from paxos_tpu.core.state import LearnerState as JLearner
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.check import safety as tsafety
from paxos_tpu_torch.core.fp_state import FastPaxosState
from paxos_tpu_torch.core.state import LearnerState
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import counter_prng as tcp
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols import paxos as tpaxos
from paxos_tpu_torch.protocols.fastpaxos import apply_tick_fast

N = 256
GOLDEN = "72beea3ccdacab94"  # tests/test_gray.py _GOLDEN_CTR["fastpaxos"]


def _sweep(n, seed):
    return JC.config5_sweep(n, seed)[1], TC.config5_sweep(n, seed)[1]


def _with_fault(cfgs, **knobs):
    return tuple(dataclasses.replace(c, fault=dataclasses.replace(c.fault, **knobs)) for c in cfgs)


def _ffp(n, seed):
    return JC.config_ffp(3, 3, 3, n, seed), TC.config_ffp(3, 3, 3, n, seed)


# (JAX config, port config) pairs for one tick: the sweep's faults; an
# unsafe Fast Flexible Paxos quorum triple with equivocators and crash
# windows (a plan the JAX package samples).
CONFIGS = {
    "config5": lambda: _sweep(N, 3),
    "ffp333_equiv_crash": lambda: _with_fault(_ffp(N, 3), p_equiv=0.25, p_crash=0.3),
}


def random_state_leaves(rng, n_prop, n_acc, k, n, tick=5):
    """A protocol-shaped random Fast Paxos state, as leaves in flatten
    order: ballots from the fast ballot and a few classic rounds, values
    from the proposers' own values (plus one out of range), PROMISE
    payloads that often match, full rep_mask bitmasks."""
    ballots = np.array([1] + [r * 8 + p + 1 for r in range(1, 4) for p in range(n_prop)], np.int32)
    vals = np.array([0, 100, 101, 102], np.int32)

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
    leaves = [
        promised, acc_bal, np.where(acc_bal > 0, val(acc), 0).astype(np.int32),
        prop_bal, rng.integers(0, 4, prop).astype(np.int32), (pid + 100).astype(np.int32),
        val(prop), mask(prop), bal(prop, 0.5), mask((n_prop, n_prop, n)),
        rng.integers(-8, 13, prop).astype(np.int32), val(prop),
        bal(kk, 0.3), val(kk), mask(kk), rng.random(n) < 0.3, val((n,)),
        rng.integers(-1, 20, (n,)).astype(np.int32), np.zeros((n,), np.int32),
        np.zeros((n,), np.int32),
    ]
    for _ in range(2):  # requests, replies
        rbal = np.where(rng.random(slot) < 0.5, prop_bal[None, :, None, :], bal(slot)).astype(np.int32)
        leaves += [rbal, bal(slot), val(slot), rng.random(slot) < 0.5]
    leaves.append(np.array(tick, np.int32))
    return leaves


def _np(x):
    return np.asarray(jax.device_get(x))


@functools.lru_cache(maxsize=None)
def _treedefs():
    """The JAX package's state and fault-free plan structures (shape-free),
    so JAX inputs can be made from numpy leaves without eager JAX ops."""
    jcfg, _ = _sweep(N, 0)
    return jax.tree.structure(j_init_state(jcfg)), jax.tree.structure(j_init_plan(jcfg))


def _to_jax(which: int, leaves):
    return jax.tree.unflatten(_treedefs()[which], [jnp.asarray(np.asarray(x)) for x in leaves])


def _digest(leaves):
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()[:16]


def _assert_leaves_equal(want, got):
    assert len(want) == len(got) == 29
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")


@functools.lru_cache(maxsize=None)
def jax_tick(fault):
    from paxos_tpu.protocols.fastpaxos import apply_tick_fast as j_apply
    from paxos_tpu.protocols.paxos import counter_masks

    return jax.jit(lambda st, seed, plan: j_apply(st, counter_masks(fault, seed, st), plan, fault))


@functools.lru_cache(maxsize=None)
def jax_chunk(fault):
    apply_fn, mask_fn, _ = fused_fns("fastpaxos")
    return jax.jit(
        lambda st, seed, plan, n, blk: j_reference_chunk(st, seed, plan, fault, n, apply_fn, mask_fn, blk_id=blk)
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_tick_fast_matches(name):
    jcfg, tcfg = CONFIGS[name]()
    rng = np.random.default_rng(200 + sorted(CONFIGS).index(name))
    leaves = random_state_leaves(rng, 2, 5, 8, N)
    if jcfg.fault.p_equiv:  # a plan the JAX package samples
        jplan = j_init_plan(jcfg)
        plan_leaves = [_np(x) for x in jax.tree.leaves(jplan)]
    else:
        plan_leaves = [x.numpy() for x in trun.init_plan(tcfg, "cpu").leaves()]
        jplan = _to_jax(1, plan_leaves)
    if name == "ffp333_equiv_crash":
        assert plan_leaves[2].any() and (plan_leaves[0] <= 5).any()
    tplan = interop.plan_from_numpy(plan_leaves)
    jstate = jax_tick(jcfg.fault)(
        _to_jax(0, leaves), jnp.asarray(tcp.mix(tcfg.seed, 5, 0).numpy()), jplan
    )
    tstate0 = interop.state_from_numpy(leaves, protocol="fastpaxos")
    masks = tpaxos.counter_masks(tcfg.fault, int(tcp.mix_u32(tcfg.seed, 5, 0)), tstate0)
    tstate = apply_tick_fast(tstate0, masks, tplan, tcfg.fault)
    _assert_leaves_equal([_np(x) for x in jax.tree.leaves(jstate)], interop.state_to_numpy(tstate))
    # The random states reach the recovery fold and the checker.
    assert tstate.proposer.rep_mask.ne(tstate0.proposer.rep_mask).any()
    assert int(tstate.learner.violations.sum()) > 0


def test_learner_observe_fast_quorum_matches():
    rng = np.random.default_rng(12)
    leaves = random_state_leaves(rng, 2, 5, 8, N)
    jl = jax.tree.unflatten(jax.tree.structure(JLearner.init(N, 8)), [jnp.asarray(x) for x in leaves[12:20]])
    tl = LearnerState(*(torch.from_numpy(np.asarray(x).copy()) for x in leaves[12:20]))
    ev_flag = rng.random((5, N)) < 0.6
    ev_bal = rng.choice(np.array([0, 1, 9, 10, 17], np.int32), (5, N))
    ev_val = rng.choice(np.array([100, 101], np.int32), (5, N))
    for fq in (4, 3):  # the default majority-only learner: tests/test_torch_tick.py
        want = jax.jit(functools.partial(jsafety.learner_observe, quorum=3, fast_quorum=fq))(
            jl, jnp.asarray(ev_flag), jnp.asarray(ev_bal), jnp.asarray(ev_val), jnp.int32(9)
        )
        got = tsafety.learner_observe(
            tl, torch.from_numpy(ev_flag), torch.from_numpy(ev_bal), torch.from_numpy(ev_val),
            torch.tensor(9, dtype=torch.int32), 3, fast_quorum=fq,
        )
        for w, g in zip(jax.tree.leaves(want), got.leaves()):
            np.testing.assert_array_equal(_np(w), g.numpy())
    assert not torch.equal(got.chosen, tl.chosen)  # the fold chose values


def test_init_state_and_fingerprint_match():
    for jcfg, tcfg in (_sweep(N, 0), _ffp(N, 0)):
        want = [_np(x) for x in jax.tree.leaves(j_init_state(jcfg))]
        tstate = trun.init_state(tcfg, "cpu")
        assert isinstance(tstate, FastPaxosState)
        _assert_leaves_equal(want, interop.state_to_numpy(tstate))
        assert tcfg.fingerprint() == jcfg.fingerprint()
        assert dataclasses.asdict(tcfg.fault) == dataclasses.asdict(jcfg.fault)
    back = interop.state_from_numpy(want, protocol="fastpaxos")
    _assert_leaves_equal(want, interop.state_to_numpy(back))


def test_golden_digest_through_plain_version():
    _, tcfg = _sweep(256, 7)
    state = tfused.fused_fastpaxos_chunk(
        trun.init_state(tcfg, "cpu"), 7, trun.init_plan(tcfg, "cpu"), tcfg.fault, 32, block=256
    )
    assert _digest(interop.state_to_numpy(state)) == GOLDEN


def test_multiblock_stream_matches_per_block_reference():
    """256 lanes in 4 stream blocks of 64 in one pass equal the JAX
    reference run block by block with blk_id=b."""
    n, block, ticks, seed = 256, 64, 48, 5
    jcfg, _ = _sweep(block, seed)
    _, tcfg = _sweep(n, seed)
    small = TC.config5_sweep(block, seed)[1]
    js = _to_jax(0, interop.state_to_numpy(trun.init_state(small, "cpu")))
    jp = _to_jax(1, [x.numpy() for x in trun.init_plan(small, "cpu").leaves()])
    per_block = [[_np(x) for x in jax.tree.leaves(jax_chunk(jcfg.fault)(js, seed, jp, ticks, b))] for b in range(4)]
    want = [np.concatenate(p, axis=-1) if p[0].ndim else p[0] for p in zip(*per_block)]
    got = tfused.reference_chunk(
        trun.init_state(tcfg, "cpu"), seed, trun.init_plan(tcfg, "cpu"), tcfg.fault, ticks,
        block=block, apply_fn=apply_tick_fast,
    )
    _assert_leaves_equal(want, interop.state_to_numpy(got))
    assert not np.array_equal(per_block[0][3], per_block[1][3])
