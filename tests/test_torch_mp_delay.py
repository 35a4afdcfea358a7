"""The port's bounded-delay channel of the Multi-Paxos tick against the
JAX package, bit for bit.

The stamps ride on three buffers (requests, PROMISEs, ACCEPTEDs) and four
send kinds (0 PROMISE, 1 ACCEPTED, 2 PREPARE, 3 ACCEPT).  Each check
holds the port's plain version against the JAX package's own functions,
tolerance 0 (the state is all int32/bool):

- each case of ``chip_smoke.delay_knob_configs(n, seed, "multipaxos")``
  (config_delay_chaos's fault config on config3's cell in both delay
  regimes, delay with drops and duplicates, delay across a cut, every gray
  knob with p_delay 0.4), the port's ``reference_chunk`` against the JAX
  package's with ``fused_fns("multipaxos")`` on chip_smoke's numpy plan:
  the cases ``chip_smoke.py`` and tests/test_torch_cuda.py hold K5's
  stamped instantiations to the plain tick on;
- the ``delaychaos-multipaxos`` main path's config on the plan the JAX
  package samples;
- ``apply_tick_mp`` tick by tick on random stamped states at (2,5,4,4) and
  (2,3,8,4), with stamps in the past, at the tick and ahead of it;
- ``compact_mp_body`` on a stamped long-log state;
- the exchange of a stamped state (33 leaves, 35 with snapshot shadows).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import check_mp_against_jax, one_core, one_torch_thread  # noqa: F401
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.core.mp_state import MultiPaxosState
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import counter_prng as tcp
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols.multipaxos import apply_tick_mp, compact_mp_body, mp_counter_masks
from test_torch_multipaxos import random_mp_leaves

N, TICKS, SEED = 128, 48, 14
CASES = list(chip_smoke.delay_knob_configs(N, SEED, "multipaxos"))
# Where a stamped state's three stamp leaves sit in flatten order (with
# the acceptors' two leaves): requests.until, promises.until, accepted.until.
STAMP_AT = (21, 25, 30)


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", CASES)
def test_delay_case_matches_jax(name):
    tcfg = chip_smoke.delay_knob_configs(N, SEED, "multipaxos")[name]
    assert (tcfg.protocol, tcfg.log_len, tcfg.k_slots) == ("multipaxos", 8, 4)
    got = check_mp_against_jax(tcfg, TICKS, jax_plan=False)
    assert len(got.leaves()) == (35 if tcfg.fault.stale_k > 0 else 33)


def test_delay_chaos_path_matches_jax_on_its_plan():
    """config3's cell (k_slots 4) with config_delay_chaos's fault config
    (p_drop 0.1, p_idle 0.1, p_delay 0.4, delay_max 2, timeout 8), over two
    stream blocks of 256 lanes."""
    tcfg = chip_smoke.main_config("delaychaos-multipaxos", 512, 3)
    f = tcfg.fault
    assert (f.p_drop, f.p_idle, f.p_delay, f.delay_max, f.timeout) == (0.1, 0.1, 0.4, 2, 8)
    got = check_mp_against_jax(tcfg, 40, jax_plan=True, block=256)
    for buf in (got.requests, got.promises, got.accepted):
        assert (buf.until > 0).any()  # each buffer's sends were delayed


def _stamped_jcfg(n_acc=5, log_len=8, n=8):
    jcfg = dataclasses.replace(JC.config3_multipaxos(n, 4), n_acc=n_acc, log_len=log_len)
    return dataclasses.replace(jcfg, fault=dataclasses.replace(jcfg.fault, p_delay=0.5, delay_max=3))


@functools.lru_cache(maxsize=None)
def _treedefs(n_acc, log_len):
    """The JAX package's stamped Multi-Paxos state and its plan (shape-free)."""
    jcfg = _stamped_jcfg(n_acc, log_len)
    return jax.tree.structure(j_init_state(jcfg)), jax.tree.structure(j_init_plan(jcfg))


def _to_jax(which, leaves, n_acc, log_len):
    return jax.tree.unflatten(
        _treedefs(n_acc, log_len)[which], [jnp.asarray(np.asarray(x)) for x in leaves]
    )


def _stamped_leaves(rng, n_prop, n_acc, log_len, k, n, tick=40):
    """A random Multi-Paxos state with stamps on its three buffers, each in
    [tick - 3, tick + 3] or 0: past, due and future deliveries."""
    leaves = random_mp_leaves(rng, n_prop, n_acc, log_len, k, n, tick)
    shapes = ((2, n_prop, n_acc, n), (n_prop, n_acc, n), (n_prop, n_acc, n))
    for at, shape in zip(STAMP_AT, shapes, strict=True):
        stamp = rng.integers(tick - 3, tick + 4, shape)
        leaves.insert(at, np.where(rng.random(shape) < 0.3, 0, stamp).astype(np.int32))
    return leaves


@functools.lru_cache(maxsize=None)
def _jax_tick(fault):
    from paxos_tpu.protocols.multipaxos import apply_tick_mp as j_apply
    from paxos_tpu.protocols.multipaxos import mp_counter_masks as j_masks

    return jax.jit(lambda st, seed, plan: j_apply(st, j_masks(fault, seed, st), plan, fault))


@pytest.mark.parametrize("shape", [(2, 5, 4, 4), (2, 3, 8, 4)])
def test_apply_tick_mp_matches_tick_by_tick_with_stamps(shape):
    """Random stamped states, crash windows and equivocators, link caps on
    the plan: the stamps gate delivery and selection, and every send of the
    four kinds is stamped, as in the JAX package, tick by tick."""
    n_prop, n_acc, log_len, k = shape
    rng = np.random.default_rng(sum(shape) + 1)
    base = TC.config3_multipaxos(256, 4)
    fault = dataclasses.replace(
        base.fault, p_equiv=0.3, p_crash=0.3, crash_max_start=48, p_delay=0.5, delay_max=3
    )
    tcfg = dataclasses.replace(base, n_acc=n_acc, log_len=log_len, fault=fault)
    jfault = JC.FaultConfig(**dataclasses.asdict(fault))
    pl = [x.numpy() for x in chip_smoke.config_plan(tcfg, 11, "cpu").leaves()]
    leaves = _stamped_leaves(rng, n_prop, n_acc, log_len, k, 256)
    jstate, jplan = _to_jax(0, leaves, n_acc, log_len), _to_jax(1, pl, n_acc, log_len)
    tstate0 = interop.state_from_numpy(leaves, protocol="multipaxos")
    assert tstate0.stamped == 1 and len(tstate0.leaves()) == 33
    tstate, tplan = tstate0, interop.plan_from_numpy(pl, cfg=fault)
    for _ in range(4):
        tick = int(tstate.tick)
        jstate = _jax_tick(jfault)(jstate, jnp.asarray(tcp.mix(4, tick, 0).numpy()), jplan)
        masks = mp_counter_masks(fault, int(tcp.mix_u32(4, tick, 0)), tstate)
        tstate = apply_tick_mp(tstate, masks, tplan, fault)
        want, got = _np(jstate), interop.state_to_numpy(tstate)
        assert len(want) == len(got) == 33
        for i, (w, g) in enumerate(zip(want, got)):
            assert w.dtype == g.dtype and w.shape == g.shape, i
            np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The ticks stamped new sends of every buffer past the random stamps.
    for buf in (tstate.requests, tstate.promises, tstate.accepted):
        assert int(buf.until.max()) > 43
    assert not torch.equal(tstate.acceptor.log, tstate0.acceptor.log)


def test_compact_carries_the_stamps_unchanged():
    """``compact_mp_body`` on a stamped long-log state equals the JAX
    package's: the stamps ride along as they are, in-flight slots re-based
    or dropped around them."""
    from paxos_tpu.protocols.multipaxos import compact_mp_body as j_compact

    rng = np.random.default_rng(23)
    leaves = _stamped_leaves(rng, 2, 5, 8, 4, 256)
    chosen = leaves[12]
    chosen[:3, :128] = True  # a decided prefix on half the lanes
    state = interop.state_from_numpy(leaves, protocol="multipaxos")
    got, shift, evicted = compact_mp_body(state)
    want, j_shift, j_evicted = jax.jit(j_compact)(_to_jax(0, leaves, 5, 8))
    assert int(shift.max()) >= 3
    np.testing.assert_array_equal(np.asarray(j_shift), shift.numpy())
    np.testing.assert_array_equal(np.asarray(j_evicted), evicted.numpy())
    for i, (w, g) in enumerate(zip(_np(want), interop.state_to_numpy(got), strict=True)):
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    for at, buf in zip(STAMP_AT, (got.requests, got.promises, got.accepted), strict=True):
        assert (buf.until.numpy() == leaves[at]).all()


@pytest.mark.parametrize("stale", [False, True])
def test_stamped_state_exchange_holds_the_jax_leaf_order(stale):
    """A stamped Multi-Paxos state (33 leaves; with the shadows of
    ``promised`` and the slot log 35) crosses to and from the JAX package's
    flatten order, from a few ticks of a run so that the stamps are set."""
    cell = JC.config3_multipaxos(256, 3)
    fault = dataclasses.replace(
        JC.config_delay_chaos(256, 3).fault, stale_k=4 if stale else 0, p_crash=0.5 if stale else 0.0
    )
    jcfg = dataclasses.replace(cell, fault=fault)
    with jax.threefry_partitionable(False):
        jplan = j_init_plan(jcfg)
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    jstate = jax.jit(
        lambda st, pl: j_reference_chunk(st, 3, pl, jcfg.fault, 16, apply_fn, mask_fn)
    )(j_init_state(jcfg), jplan)
    leaves = _np(jstate)
    assert len(leaves) == (35 if stale else 33)
    state = interop.state_from_numpy(leaves, protocol="multipaxos")
    assert isinstance(state, MultiPaxosState) and state.stamped == 1 and state.snapshots == stale
    acc = 4 if stale else 2
    for at, buf in zip(STAMP_AT, (state.requests, state.promises, state.accepted), strict=True):
        assert (buf.until.numpy() == leaves[at - 2 + acc]).all()
        assert (buf.until > 0).any()  # the run stamped sends of each buffer
    for w, g in zip(leaves, interop.state_to_numpy(state), strict=True):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


def test_init_state_stamps_the_three_buffers():
    cfg = chip_smoke.main_config("delaychaos-multipaxos", 16)
    state = trun.init_state(cfg, "cpu")
    assert MultiPaxosState.takes_stamps and state.stamped == 1 and len(state.leaves()) == 33
    for buf in (state.requests, state.promises, state.accepted):
        assert buf.until is not None and not buf.until.any()
    assert tfused.BINDINGS["multipaxos"].kernel_shape(state, cfg.fault) == (2, 5, 8, 4, 1, 0, 0)
    plain = trun.init_state(chip_smoke.main_config("config3", 16), "cpu")
    assert plain.stamped == 0 and len(plain.leaves()) == 30
