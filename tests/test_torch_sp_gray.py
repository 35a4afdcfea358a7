"""The port's gray-failure and partition arms of the SynchPaxos tick
against the JAX package, bit for bit.

Each case runs the fused stream through the port's ``reference_chunk``
with the plain tick and the JAX package's ``reference_chunk`` with
``fused_fns("synchpaxos")``, from the same initial state (with the
snapshot shadows under stale_k, the delay stamps under p_delay), and the
two must agree leaf for leaf (tolerance 0: the state is all int32/bool):

- every gray knob at once with crash windows on config_delay_chaos's cell,
  with its delay (stamps and shadows: 34 leaves), as the JAX package's own
  fused-kernel test sets the knobs up (tests/test_gray.py), on the plan
  the JAX package samples, carried across with
  ``interop.plan_from_numpy(..., cfg=)``;
- ``config_gray_chaos``'s knobs on config_delay_chaos's cell (the
  ``graychaos-synchpaxos`` main path) on the JAX package's plan;
- each case of ``chip_smoke.gray_knob_configs(n, seed, "synchpaxos")``:
  each arm alone, the configs that combine them (unstamped), every knob at
  once with the delay and the delay across a cut in every lane (stamped),
  on chip_smoke's numpy plan: the cases that ``chip_smoke.py`` and
  tests/test_torch_cuda.py hold K4's arms instantiations to the plain tick
  on.

Also the 34-leaf exchange of a state with stamps and shadows (the leaf
order the C entry composes from two moves), K4's arms geometry, and the
checker's counts of payload corruption and stale recovery on SynchPaxos.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import check_against_jax, jax_config, one_core, one_torch_thread  # noqa: F401
from paxos_tpu.core.sp_state import SynchPaxosState as JSynchPaxosState
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.core.sp_state import SynchPaxosState
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

N, TICKS, SEED = 128, 48, 12
CASES = list(chip_smoke.gray_knob_configs(N, SEED, "synchpaxos"))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_every_gray_knob_with_delay_matches_jax_on_its_plan():
    cell = chip_smoke.main_config("synchpaxos", 64, 5)
    tcfg = dataclasses.replace(cell, fault=dataclasses.replace(cell.fault, **chip_smoke.GRAY_ALL))
    got = check_against_jax(tcfg, 24, jax_plan=True)
    assert len(got) == 34  # the stamps and the snapshot shadows ride along


def test_gray_chaos_matches_jax_on_its_plan():
    tcfg = chip_smoke.main_config("graychaos-synchpaxos", 256, 3)
    assert tcfg.fault == chip_smoke.main_config("graychaos", 256, 3).fault
    assert tcfg.fault.p_delay == 0.0 and tcfg.protocol == "synchpaxos"
    check_against_jax(tcfg, 32, jax_plan=True)


@pytest.mark.parametrize("name", CASES)
def test_gray_knob_case_matches_jax(name):
    tcfg = chip_smoke.gray_knob_configs(N, SEED, "synchpaxos")[name]
    assert tcfg.protocol == "synchpaxos"
    check_against_jax(tcfg, TICKS, jax_plan=False)


@pytest.mark.parametrize("stale,delay,n_leaves", [
    (False, False, 29), (True, False, 32), (False, True, 31), (True, True, 34),
])
def test_state_exchange_holds_the_jax_leaf_order(stale, delay, n_leaves):
    """A SynchPaxos state with or without snapshot shadows and delay stamps
    crosses to and from the JAX package's flatten order: the shadows after
    the acceptor's three leaves, each buffer's stamps after its four.  A
    state from a few ticks of a run, so that no two leaves are alike."""
    jcfg = dataclasses.replace(
        JC.config_delay_chaos(64, 3),
        fault=dataclasses.replace(
            JC.config_delay_chaos(64, 3).fault, p_delay=0.4 if delay else 0.0,
            stale_k=4 if stale else 0, p_crash=0.5 if stale else 0.0,
        ),
    )
    jstate = j_init_state(jcfg)
    assert isinstance(jstate, JSynchPaxosState)
    with jax.threefry_partitionable(False):
        jplan = j_init_plan(jcfg)
    apply_fn, mask_fn, _ = fused_fns("synchpaxos")
    jstate = jax.jit(
        lambda st, pl: j_reference_chunk(st, 3, pl, jcfg.fault, 12, apply_fn, mask_fn)
    )(jstate, jplan)
    leaves = _leaves(jstate)
    assert len(leaves) == n_leaves
    state = interop.state_from_numpy(leaves, protocol="synchpaxos")
    assert isinstance(state, SynchPaxosState)
    assert (state.snapshots, state.stamped) == (stale, int(delay))
    assert state.acceptor.snap_bal is None if not stale else torch.equal(
        state.acceptor.snap_bal, torch.from_numpy(leaves[4].copy())
    )
    if delay:
        until = leaves[(6 if stale else 3) + 17 + 4]
        assert (state.requests.until.numpy() == until).all()
    for w, g in zip(leaves, interop.state_to_numpy(state), strict=True):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


def test_init_state_allocates_shadows_and_stamps():
    """The port's SynchPaxos state takes the shadows (``stale=``) beside
    the stamps (``delay=``), as the JAX package's ``init_state`` does."""
    tcfg = chip_smoke.gray_knob_configs(8, 1, "synchpaxos")["every gray knob, stamped"]
    state = trun.init_state(tcfg, "cpu")
    assert SynchPaxosState.takes_snapshots and SynchPaxosState.takes_stamps
    assert state.snapshots and state.stamped == 1 and len(state.leaves()) == 34
    state.check_layout()
    want = [x.shape for x in jax.tree.leaves(j_init_state(jax_config(tcfg)))]
    assert [tuple(x.shape) for x in state.leaves()] == [tuple(s) for s in want]


def test_arms_geometry_is_pinned():
    """K4's arms instantiations: their default's column at ``(2,5,8)``
    (104 words without the stamps, 144 with them; the snapshot shadows stay
    in global memory), 128 lanes, registers capped for 3 blocks (12
    warps).  The wrapper picks one exactly when a gray-failure or
    partition knob is on, stamped where the state carries stamps."""
    table = tfused.SP_STAGING
    assert tuple(table) == tfused.KERNEL_SHAPES["synchpaxos"]
    for stamped, rows in ((0, 104), (1, 144)):
        arms, default = table[(2, 5, 8, stamped, 1, 0)], table[(2, 5, 8, stamped, 0, 0)]
        assert (arms.threads, arms.rows, arms.smem_bytes, arms.min_blocks) == (128, rows, rows * 512, 3)
        assert default.rows == rows
    binding = tfused.BINDINGS["synchpaxos"]
    for name, cfg in chip_smoke.gray_knob_configs(4, 1, "synchpaxos").items():
        state = trun.init_state(cfg, "cpu")
        assert binding.kernel_shape(state, cfg.fault) == (2, 5, 8, state.stamped, 1, 0), name
    plain = chip_smoke.main_config("synchpaxos", 4)
    assert binding.kernel_shape(trun.init_state(plain, "cpu"), plain.fault) == (2, 5, 8, 1, 0, 0)
    assert tfused._launch_dims(binding, (2, 5, 8, 0, 1, 0)) == (2, 5, 8, 0, 1, 0, 104 * 512)


@pytest.mark.parametrize("name", ["config_corrupt", "config_stale"])
def test_checker_counts_are_pinned_on_the_port(name):
    """``chip_smoke.FR_CHECKER_VIOLATIONS`` pins the SynchPaxos bug
    injections (the JAX package's counts, tests/test_torch_fr_gray_pins.py
    computes them): payload corruption fires the checker, stale recovery
    breaks no agreement at the pin's size; the port's ``run`` gives each
    count on chip_smoke's numpy plan."""
    size = {"config_corrupt": (1024, 0, 256), "config_stale": (4096, 3, 192)}[name]
    key = (name, "synchpaxos", *size)
    want = chip_smoke.FR_CHECKER_VIOLATIONS[key]
    assert (want > 0) == (name == "config_corrupt")
    n_inst, seed, ticks = size
    tcfg = chip_smoke.fr_checker_config(name, "synchpaxos", n_inst, seed)
    plan = chip_smoke.config_plan(tcfg, seed, "cpu")
    report = trun.run(tcfg, total_ticks=ticks, plan=plan, device="cpu")
    assert report["violations"] == want
