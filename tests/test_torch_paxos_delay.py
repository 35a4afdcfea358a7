"""The port's bounded-delay channel of the Paxos tick against the JAX
package, bit for bit, and the delay's conservation property on the port.

Each case runs the fused stream through the port's ``reference_chunk``
with the plain Paxos tick and the JAX package's ``reference_chunk`` with
``fused_fns("paxos")``, from the same initial state (both buffers with
``until`` stamps), on chip_smoke's numpy plan, and the two must agree leaf
for leaf (tolerance 0: the state is all int32/bool).  The cases are
``chip_smoke.delay_knob_configs``: config_delay_chaos on Paxos in both
delay regimes, delay with drops and duplicates, delay across a cut in
every lane, and every gray knob at once with p_delay 0.4: the cases that
``chip_smoke.py`` and tests/test_torch_cuda.py hold K1's stamped
instantiations to the plain tick on.  Also the 31-leaf exchange of a
stamped Paxos state (34 with snapshot shadows), ``check_supported``'s
delay knob per protocol, and tests/test_delay.py's conservation property
(every message delivered in the end, so every lane decides) on the port's
``run`` for all five protocols.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import check_against_jax, one_core, one_torch_thread  # noqa: F401
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.core.state import PaxosState
from paxos_tpu_torch.faults.injector import FaultConfig
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols import paxos as tpaxos

N, TICKS, SEED = 128, 48, 14
CASES = list(chip_smoke.delay_knob_configs(N, SEED))


@pytest.mark.parametrize("name", CASES)
def test_delay_case_matches_jax(name):
    tcfg = chip_smoke.delay_knob_configs(N, SEED)[name]
    assert tcfg.protocol == "paxos" and tcfg.fault.p_delay > 0
    got = check_against_jax(tcfg, TICKS, jax_plan=False)
    assert len(got) == (34 if tcfg.fault.stale_k > 0 else 31)


def test_delay_chaos_path_matches_jax_on_its_plan():
    """The ``delaychaos-paxos`` main path's config on the plan the JAX
    package samples: p_drop 0.1, p_idle 0.1, p_delay 0.4, delay_max 2,
    timeout 8 (delta, which no Paxos tick reads, 6)."""
    tcfg = chip_smoke.main_config("delaychaos-paxos", 256, 3)
    f = tcfg.fault
    assert (f.p_drop, f.p_idle, f.p_delay, f.delay_max, f.timeout) == (0.1, 0.1, 0.4, 2, 8)
    check_against_jax(tcfg, 32, jax_plan=True)


@pytest.mark.parametrize("stale", [False, True])
def test_stamped_state_exchange_holds_the_jax_leaf_order(stale):
    """A Paxos state with delay stamps (31 leaves; with snapshot shadows 34)
    crosses to and from the JAX package's flatten order, from a few ticks
    of a run so that the stamps are set."""
    fault = dataclasses.replace(
        JC.config_delay_chaos(64, 3).fault, stale_k=4 if stale else 0, p_crash=0.5 if stale else 0.0
    )
    jcfg = dataclasses.replace(JC.config_delay_chaos(64, 3), protocol="paxos", fault=fault)
    with jax.threefry_partitionable(False):
        jplan = j_init_plan(jcfg)
    apply_fn, mask_fn, _ = fused_fns("paxos")
    jstate = jax.jit(
        lambda st, pl: j_reference_chunk(st, 3, pl, jcfg.fault, 12, apply_fn, mask_fn)
    )(j_init_state(jcfg), jplan)
    leaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    assert len(leaves) == (34 if stale else 31)
    state = interop.state_from_numpy(leaves, protocol="paxos")
    assert isinstance(state, PaxosState) and state.stamped == 1 and state.snapshots == stale
    acc = 6 if stale else 3
    assert (state.requests.until.numpy() == leaves[acc + 17 + 4]).all()
    assert (state.replies.until.numpy() == leaves[acc + 17 + 9]).all()
    assert (state.requests.until > 0).any()  # the run stamped sends
    for w, g in zip(leaves, interop.state_to_numpy(state), strict=True):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)
    # The layout is SynchPaxos' too; a Fast Paxos state's recovery masks
    # (P, P, I) do not fit a Paxos proposer's best_val (P, I).
    assert interop.state_from_numpy(leaves, protocol="synchpaxos").stamped == 1
    with pytest.raises(ValueError, match="leaf"):
        interop.state_from_numpy(leaves, protocol="fastpaxos")


def test_init_state_stamps_paxos_with_delay():
    cfg = chip_smoke.main_config("delaychaos-paxos", 16)
    state = trun.init_state(cfg, "cpu")
    assert PaxosState.takes_stamps and state.stamped == 1 and len(state.leaves()) == 31
    assert state.requests.present[0].all() and not state.requests.until.any()
    assert tfused.BINDINGS["paxos"].kernel_shape(state, cfg.fault) == (2, 5, 8, 1, 0, 0)
    nodelay = trun.init_state(chip_smoke.main_config("paxos", 16), "cpu")
    assert nodelay.stamped == 0 and len(nodelay.leaves()) == 29


@pytest.mark.parametrize("protocol", ["paxos", "fastpaxos", "raftcore", "synchpaxos", "multipaxos"])
def test_check_supported_takes_delay_on_paxos_and_synchpaxos(protocol):
    """p_delay is ported to every tick, Paxos and SynchPaxos first; the
    planted SynchPaxos bug stays refused on the others (queue A item 10)."""
    cfg = FaultConfig(p_delay=0.4, delay_max=2)
    tpaxos.check_supported(cfg, protocol)
    bug = FaultConfig(p_delay=0.4, sp_unsafe_fast=True)
    if protocol == "synchpaxos":
        tpaxos.check_supported(bug, protocol)
    else:
        with pytest.raises(NotImplementedError, match="item 10"):
            tpaxos.check_supported(bug, protocol)


def _conservation_report(protocol):
    """tests/test_delay.py's fused conservation case (64 lanes, seed 3,
    p_delay 0.6, delay_max 3, a partition in every lane, timeout 6, loss
    off; Multi-Paxos with that test's own k_slots 8, on the CPU) on the
    port's ``run`` on the plan the JAX package samples."""
    tcfg = chip_smoke.delay_cut_config(protocol, 64, 3)
    jcfg = dataclasses.replace(
        JC.config2_dueling_drop(64, 3), protocol=protocol, n_prop=2, n_acc=5, k_slots=8,
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )
    assert jcfg.fingerprint() == tcfg.fingerprint()
    with jax.threefry_partitionable(False):
        leaves = [np.asarray(x) for x in jax.tree.leaves(j_init_plan(jcfg))]
    plan = interop.plan_from_numpy(leaves, cfg=tcfg.fault)
    return trun.run(tcfg, until_all_chosen=True, max_ticks=384, chunk=64, plan=plan, device="cpu")


@pytest.mark.parametrize("protocol", ["paxos", "synchpaxos", "fastpaxos", "raftcore", "multipaxos"])
def test_delay_conserves_messages_across_cut_and_heal(protocol):
    """Delay and a cut lose nothing: every lane decides, safely."""
    report = _conservation_report(protocol)
    assert report["violations"] == 0
    assert report["chosen_frac"] == 1.0, (protocol, report["chosen_frac"])
    assert report["proposer_disagree"] == 0


def test_delay_stalls_and_cuts_never_clear_a_stamp():
    """One tick of the plain Paxos tick with every request slot waiting
    for its stamp: nothing is selected or consumed, and every stamp and
    presence bit stays; a cut on every link stalls the arrived requests
    alike."""
    cfg = chip_smoke.delay_cut_config("paxos", 32, 2)
    state = trun.init_state(cfg, "cpu")
    plan = chip_smoke.config_plan(cfg, 2, "cpu")
    state.requests.until.fill_(5)  # the opening PREPAREs arrive at tick 5
    after = chip_smoke.plain_chunk(cfg, state.clone(), plan, 1, 32)
    assert torch.equal(after.requests.present, state.requests.present)
    assert torch.equal(after.requests.until, state.requests.until)
    assert not after.replies.present.any()
    plan.part_start.zero_()
    plan.part_end.fill_(100)
    plan.aside.fill_(True)
    plan.pside.fill_(False)
    state.requests.until.zero_()
    cut = chip_smoke.plain_chunk(cfg, state.clone(), plan, 1, 32)
    assert torch.equal(cut.requests.present, state.requests.present)
    assert not cut.replies.present.any()
