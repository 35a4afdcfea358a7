"""The port's Raft-core against the JAX package, bit for bit.

Random but protocol-shaped states are made with numpy from fixed seeds and
handed to both packages as the same leaves; ``apply_tick_raft``, the voter
invariants, the initial state, the counter-stream golden digest, a
multi-block stream and the config fingerprint must then agree exactly
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
from paxos_tpu.core.raft_state import VoterState as JVoter
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.check import safety as tsafety
from paxos_tpu_torch.core.raft_state import RaftState, VoterState
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import counter_prng as tcp
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols import paxos as tpaxos
from paxos_tpu_torch.protocols.raftcore import apply_tick_raft

N = 256
GOLDEN = "eb285905571b709f"  # tests/test_gray.py _GOLDEN_CTR["raftcore"]


def _sweep(n, seed):
    return JC.config5_sweep(n, seed)[2], TC.config5_sweep(n, seed)[2]


def _with_fault(cfgs, **knobs):
    return tuple(dataclasses.replace(c, fault=dataclasses.replace(c.fault, **knobs)) for c in cfgs)


# (JAX config, port config) pairs for one tick: the sweep's faults; the
# same with duplicates, equivocators and crash windows (a plan the JAX
# package samples).
CONFIGS = {
    "config5": lambda: _sweep(N, 3),
    "dup_equiv_crash": lambda: _with_fault(_sweep(N, 3), p_dup=0.2, p_equiv=0.25, p_crash=0.3),
}


def random_state_leaves(rng, n_prop, n_acc, k, n, tick=5):
    """A protocol-shaped random Raft-core state, as leaves in flatten order:
    terms from a few rounds, values from the candidates' own values, VOTE
    payloads 2 * term + granted, reply terms that often match the
    candidates' terms, some invariant-breaking voters."""
    terms = np.array([r * 8 + p + 1 for r in range(4) for p in range(n_prop)], np.int32)
    vals = np.array([0, 100, 101], np.int32)

    def term(shape, zero=0.2):
        b = rng.choice(terms, size=shape)
        return np.where(rng.random(shape) < zero, 0, b).astype(np.int32)

    def val(shape):
        return rng.choice(vals, size=shape).astype(np.int32)

    def mask(shape):
        return rng.integers(0, 1 << n_acc, shape).astype(np.int32)

    acc, prop, kk = (n_acc, n), (n_prop, n), (k, n)
    slot = (2, n_prop, n_acc, n)
    pid = np.broadcast_to(np.arange(n_prop, dtype=np.int32)[:, None], prop)
    voted = term(acc, 0.3)
    ent_term = np.minimum(voted, term(acc, 0.4))
    ent_term[:, ::17] = voted[:, ::17] + 8  # a few entry-bound breaks
    cand_bal = term(prop, 0.0)
    leaves = [
        voted, ent_term, np.where(ent_term > 0, val(acc), 0).astype(np.int32),
        cand_bal, rng.integers(0, 3, prop).astype(np.int32), (pid + 100).astype(np.int32),
        val(prop), mask(prop), term(prop, 0.5), val(prop),
        rng.integers(-8, 13, prop).astype(np.int32), val(prop),
        term(kk, 0.3), val(kk), mask(kk), rng.random(n) < 0.3, val((n,)),
        rng.integers(-1, 20, (n,)).astype(np.int32), np.zeros((n,), np.int32),
        np.zeros((n,), np.int32),
    ]
    for _ in range(2):  # requests, replies
        rbal = np.where(rng.random(slot) < 0.5, cand_bal[None, :, None, :], term(slot)).astype(np.int32)
        v1 = np.where(rng.random(slot) < 0.5, 2 * term(slot) + rng.integers(0, 2, slot), val(slot))
        leaves += [rbal, v1.astype(np.int32), val(slot), rng.random(slot) < 0.5]
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
    from paxos_tpu.protocols.paxos import counter_masks
    from paxos_tpu.protocols.raftcore import apply_tick_raft as j_apply

    return jax.jit(lambda st, seed, plan: j_apply(st, counter_masks(fault, seed, st), plan, fault))


@functools.lru_cache(maxsize=None)
def jax_chunk(fault):
    apply_fn, mask_fn, _ = fused_fns("raftcore")
    return jax.jit(
        lambda st, seed, plan, n, blk: j_reference_chunk(st, seed, plan, fault, n, apply_fn, mask_fn, blk_id=blk)
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_tick_raft_matches(name):
    jcfg, tcfg = CONFIGS[name]()
    rng = np.random.default_rng(300 + sorted(CONFIGS).index(name))
    leaves = random_state_leaves(rng, 2, 5, 8, N)
    if jcfg.fault.p_equiv:  # a plan the JAX package samples
        jplan = j_init_plan(jcfg)
        plan_leaves = [_np(x) for x in jax.tree.leaves(jplan)]
    else:
        plan_leaves = [x.numpy() for x in trun.init_plan(tcfg, "cpu").leaves()]
        jplan = _to_jax(1, plan_leaves)
    if name == "dup_equiv_crash":
        assert plan_leaves[2].any() and (plan_leaves[0] <= 5).any()
    tplan = interop.plan_from_numpy(plan_leaves)
    jstate = jax_tick(jcfg.fault)(
        _to_jax(0, leaves), jnp.asarray(tcp.mix(tcfg.seed, 5, 0).numpy()), jplan
    )
    tstate0 = interop.state_from_numpy(leaves, protocol="raftcore")
    masks = tpaxos.counter_masks(tcfg.fault, int(tcp.mix_u32(tcfg.seed, 5, 0)), tstate0)
    tstate = apply_tick_raft(tstate0, masks, tplan, tcfg.fault)
    _assert_leaves_equal([_np(x) for x in jax.tree.leaves(jstate)], interop.state_to_numpy(tstate))
    # The random states reach elections, adoption and the checker.
    assert (tstate.proposer.ent_term != tstate0.proposer.ent_term).any()
    assert int(tstate.learner.violations.sum()) > 0


def test_raft_voter_invariants_match():
    rng = np.random.default_rng(14)
    old = [rng.choice(np.array([0, 1, 9, 10, 17], np.int32), (5, N)) for _ in range(3)]
    new = [x + rng.integers(-2, 3, x.shape).astype(np.int32) for x in old]
    new[2][:, ::7] = 0  # nil entries with and without a term
    honest = rng.random((5, N)) < 0.8
    want = jax.jit(jsafety.raft_voter_invariants)(
        JVoter(*(jnp.asarray(x) for x in old)), JVoter(*(jnp.asarray(x) for x in new)), jnp.asarray(honest)
    )
    got = tsafety.raft_voter_invariants(
        VoterState(*(torch.from_numpy(x) for x in old)), VoterState(*(torch.from_numpy(x) for x in new)),
        torch.from_numpy(honest),
    )
    np.testing.assert_array_equal(_np(want), got.numpy())
    assert 0 < int(got.sum()) < 5 * N


def test_init_state_and_fingerprint_match():
    jcfg, tcfg = _sweep(N, 0)
    want = [_np(x) for x in jax.tree.leaves(j_init_state(jcfg))]
    tstate = trun.init_state(tcfg, "cpu")
    assert isinstance(tstate, RaftState)
    _assert_leaves_equal(want, interop.state_to_numpy(tstate))
    assert tcfg.fingerprint() == jcfg.fingerprint()
    assert dataclasses.asdict(tcfg.fault) == dataclasses.asdict(jcfg.fault)
    back = interop.state_from_numpy(want, protocol="raftcore")
    _assert_leaves_equal(want, interop.state_to_numpy(back))


def test_golden_digest_through_plain_version():
    _, tcfg = _sweep(256, 7)
    state = tfused.fused_raftcore_chunk(
        trun.init_state(tcfg, "cpu"), 7, trun.init_plan(tcfg, "cpu"), tcfg.fault, 32, block=256
    )
    assert _digest(interop.state_to_numpy(state)) == GOLDEN


def test_multiblock_stream_matches_per_block_reference():
    """256 lanes in 4 stream blocks of 64 in one pass equal the JAX
    reference run block by block with blk_id=b."""
    n, block, ticks, seed = 256, 64, 48, 5
    jcfg, _ = _sweep(block, seed)
    _, tcfg = _sweep(n, seed)
    small = TC.config5_sweep(block, seed)[2]
    js = _to_jax(0, interop.state_to_numpy(trun.init_state(small, "cpu")))
    jp = _to_jax(1, [x.numpy() for x in trun.init_plan(small, "cpu").leaves()])
    per_block = [[_np(x) for x in jax.tree.leaves(jax_chunk(jcfg.fault)(js, seed, jp, ticks, b))] for b in range(4)]
    want = [np.concatenate(p, axis=-1) if p[0].ndim else p[0] for p in zip(*per_block)]
    got = tfused.reference_chunk(
        trun.init_state(tcfg, "cpu"), seed, trun.init_plan(tcfg, "cpu"), tcfg.fault, ticks,
        block=block, apply_fn=apply_tick_raft,
    )
    _assert_leaves_equal(want, interop.state_to_numpy(got))
    assert not np.array_equal(per_block[0][3], per_block[1][3])


def test_engine_wrappers_take_their_own_state():
    """A protocol's wrapper refuses another protocol's state, and on CPU
    tensors it runs the plain version without counting a launch."""
    _, tcfg = _sweep(64, 1)
    state, plan = trun.init_state(tcfg, "cpu"), trun.init_plan(tcfg, "cpu")
    with pytest.raises(TypeError, match="RaftState"):
        tfused.fused_raftcore_chunk(trun.init_state(TC.config5_sweep(64, 1)[1], "cpu"), 1, plan, tcfg.fault, 4)
    before = tfused.fused_raftcore_chunk.launches
    out = tfused.FUSED_CHUNKS["raftcore"](state, 1, plan, tcfg.fault, 4)
    assert int(out.tick) == 4 and tfused.fused_raftcore_chunk.launches == before
