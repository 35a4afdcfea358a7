"""The port's bounded-delay channel of the Fast Paxos and Raft-core ticks
against the JAX package, bit for bit.

Each case runs the fused stream through the port's ``reference_chunk``
with the plain tick and the JAX package's ``reference_chunk`` with
``fused_fns(protocol)``, from the same initial state (both buffers with
``until`` stamps), and the two must agree leaf for leaf (tolerance 0: the
state is all int32/bool):

- ``chip_smoke.delay_knob_configs(n, seed, protocol)`` on chip_smoke's
  numpy plan: config_delay_chaos in both delay regimes, delay with drops
  and duplicates, delay across a cut in every lane, and every gray knob at
  once on config5's cell with p_delay 0.4, the cases ``chip_smoke.py`` and
  tests/test_torch_cuda.py hold the stamped instantiations of K2 and K3 to
  the plain tick on;
- the ``delaychaos-fastpaxos`` and ``delaychaos-raftcore`` main paths'
  config on the plan the JAX package samples.

Also the exchange of a stamped state (31 leaves, 34 with snapshot
shadows) in the JAX package's flatten order, and ``init_state``'s stamps.
"""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from _torch_jax import check_against_jax, one_core, one_torch_thread  # noqa: F401
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

N, TICKS, SEED = 128, 48, 14
PROTOCOLS = ("fastpaxos", "raftcore")
CASES = [(p, name) for p in PROTOCOLS for name in chip_smoke.delay_knob_configs(N, SEED, p)]


@pytest.mark.parametrize("protocol,name", CASES)
def test_delay_case_matches_jax(protocol, name):
    tcfg = chip_smoke.delay_knob_configs(N, SEED, protocol)[name]
    assert tcfg.protocol == protocol and tcfg.fault.p_delay > 0
    got = check_against_jax(tcfg, TICKS, jax_plan=False)
    assert len(got) == (34 if tcfg.fault.stale_k > 0 else 31)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_delay_chaos_path_matches_jax_on_its_plan(protocol):
    """The main path's config (the JAX package's audit ``_delay``): p_drop
    0.1, p_idle 0.1, p_delay 0.4, delay_max 2, timeout 8, on config5's
    (2, 5, 8) topology."""
    tcfg = chip_smoke.main_config(f"delaychaos-{protocol}", 256, 3)
    f = tcfg.fault
    assert (f.p_drop, f.p_idle, f.p_delay, f.delay_max, f.timeout) == (0.1, 0.1, 0.4, 2, 8)
    assert (tcfg.protocol, tcfg.n_prop, tcfg.n_acc, tcfg.k_slots) == (protocol, 2, 5, 8)
    got = check_against_jax(tcfg, 32, jax_plan=True)
    assert int(got[17 + 4 + 3].max()) > 32  # requests.until: some send waits past the run


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("stale", [False, True])
def test_stamped_state_exchange_holds_the_jax_leaf_order(protocol, stale):
    """A stamped state (31 leaves; with snapshot shadows 34) crosses to and
    from the JAX package's flatten order, from a few ticks of a run so that
    the stamps are set."""
    base = JC.config_delay_chaos(64, 3)
    fault = dataclasses.replace(
        base.fault, stale_k=4 if stale else 0, p_crash=0.5 if stale else 0.0
    )
    jcfg = dataclasses.replace(base, protocol=protocol, fault=fault)
    with jax.threefry_partitionable(False):
        jplan = j_init_plan(jcfg)
    apply_fn, mask_fn, _ = fused_fns(protocol)
    jstate = jax.jit(
        lambda st, pl: j_reference_chunk(st, 3, pl, jcfg.fault, 12, apply_fn, mask_fn)
    )(j_init_state(jcfg), jplan)
    leaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    assert len(leaves) == (34 if stale else 31)
    state = interop.state_from_numpy(leaves, protocol=protocol)
    assert type(state) is tfused.BINDINGS[protocol].state_cls
    assert state.stamped == 1 and state.snapshots == stale
    acc = 6 if stale else 3
    assert (state.requests.until.numpy() == leaves[acc + 17 + 4]).all()
    assert (state.replies.until.numpy() == leaves[acc + 17 + 9]).all()
    assert (state.requests.until > 0).any() and (state.replies.until > 0).any()
    for w, g in zip(leaves, interop.state_to_numpy(state), strict=True):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_init_state_stamps_with_delay(protocol):
    """``init_state`` stamps a delaying config's state, its opening
    broadcast deliverable at once, and the wrapper keys it to the stamped
    instantiation; a delay-free config's state carries no stamps."""
    cfg = chip_smoke.main_config(f"delaychaos-{protocol}", 16)
    state = trun.init_state(cfg, "cpu")
    assert tfused.BINDINGS[protocol].state_cls.takes_stamps
    assert state.stamped == 1 and len(state.leaves()) == 31
    assert state.requests.present.any() and not state.requests.until.any()
    assert tfused.BINDINGS[protocol].kernel_shape(state, cfg.fault) == (2, 5, 8, 1, 0, 0)
    nodelay = trun.init_state(chip_smoke.main_config(protocol, 16), "cpu")
    assert nodelay.stamped == 0 and len(nodelay.leaves()) == 29
    assert tfused.BINDINGS[protocol].kernel_shape(nodelay) == (2, 5, 8, 0, 0, 0)
