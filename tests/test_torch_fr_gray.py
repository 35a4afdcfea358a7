"""The port's gray-failure and partition arms of the Fast Paxos and
Raft-core ticks against the JAX package, bit for bit.

Each case runs the fused stream through the port's ``reference_chunk``
with the plain tick and the JAX package's ``reference_chunk`` with
``fused_fns(protocol)``, from the same initial state (with the snapshot
shadows under stale_k), and the two must agree leaf for leaf (tolerance
0: the state is all int32/bool):

- every gray knob at once with crash windows on config5's cell, as the JAX
  package's own fused-kernel test sets it up (tests/test_gray.py
  ``test_fused_matches_reference_under_gray``: 64 lanes, seed 5, 24 ticks)
  on the plan the JAX package samples, carried across with
  ``interop.plan_from_numpy(..., cfg=)``;
- ``config_gray_chaos``'s knobs on config5's cell (the gray-chaos main
  paths) at 256 lanes over 32 ticks, on the JAX package's plan;
- each case of ``chip_smoke.gray_knob_configs(n, seed, protocol)``: each
  arm alone (a two-way and a one-way partition, flaky links without and
  with duplication, timeout and backoff skew, payload corruption, stale
  recovery with crash windows, amnesia) and the configs that combine them,
  at 128 lanes over 48 ticks on chip_smoke's numpy plan, the cases that
  ``chip_smoke.py`` and tests/test_torch_cuda.py hold K2's and K3's arms
  instantiations to the plain tick on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from _torch_jax import jax_plan_of, one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

PROTOCOLS = ("fastpaxos", "raftcore")
N, TICKS, SEED = 128, 48, 12
CASES = [(p, name) for p in PROTOCOLS for name in chip_smoke.gray_knob_configs(N, SEED, p)]


def _jax_config(tcfg):
    """The JAX package's SimConfig with ``tcfg``'s fields."""
    return dataclasses.replace(
        JC.config2_dueling_drop(tcfg.n_inst, tcfg.seed),
        protocol=tcfg.protocol, n_prop=tcfg.n_prop, n_acc=tcfg.n_acc, k_slots=tcfg.k_slots,
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _check(tcfg, ticks, jax_plan: bool):
    """The plain tick against the JAX package over ``ticks`` ticks, on the
    plan the JAX package samples (``jax_plan``) or on chip_smoke's numpy
    plan; returns the final state's leaves."""
    jcfg = _jax_config(tcfg)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    state = trun.init_state(tcfg, "cpu")
    assert state.snapshots == (tcfg.fault.stale_k > 0)
    jstate = j_init_state(jcfg)
    init = _leaves(jstate)
    for w, g in zip(init, interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(w, g)
    if jax_plan:
        with jax.threefry_partitionable(False):
            jplan = j_init_plan(jcfg)
        plan = interop.plan_from_numpy(_leaves(jplan), cfg=tcfg.fault)
    else:
        plan = chip_smoke.config_plan(tcfg, tcfg.seed, "cpu")
        jplan = jax_plan_of(plan)
    apply_fn, mask_fn, _ = fused_fns(tcfg.protocol)
    want = jax.jit(
        lambda st, pl: j_reference_chunk(st, tcfg.seed, pl, jcfg.fault, ticks, apply_fn, mask_fn)
    )(jstate, jplan)
    got = tfused.reference_chunk(
        state, tcfg.seed, plan, tcfg.fault, ticks, apply_fn=tfused.BINDINGS[tcfg.protocol].apply_fn
    )
    want, got = _leaves(want), interop.state_to_numpy(got)
    assert len(want) == len(got) == len(init)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The case reaches its arm: the run moved the state.
    assert not all((a == b).all() for a, b in zip(got, init))
    return got


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_every_gray_knob_matches_jax_on_its_plan(protocol):
    cell = chip_smoke.main_config(protocol, 64, 5)
    tcfg = dataclasses.replace(cell, fault=dataclasses.replace(cell.fault, **chip_smoke.GRAY_ALL))
    got = _check(tcfg, 24, jax_plan=True)
    assert len(got) == 32  # the snapshot shadows ride along


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_gray_chaos_matches_jax_on_its_plan(protocol):
    tcfg = chip_smoke.main_config(f"graychaos-{protocol}", 256, 3)
    assert tcfg.fault == chip_smoke.main_config("graychaos", 256, 3).fault
    _check(tcfg, 32, jax_plan=True)


@pytest.mark.parametrize("protocol,name", CASES, ids=[f"{p}-{n}" for p, n in CASES])
def test_gray_knob_case_matches_jax(protocol, name):
    tcfg = chip_smoke.gray_knob_configs(N, SEED, protocol)[name]
    assert tcfg.protocol == protocol
    _check(tcfg, TICKS, jax_plan=False)


@pytest.mark.parametrize("protocol,rows", [("fastpaxos", 104), ("raftcore", 114)])
def test_arms_geometry_is_pinned(protocol, rows):
    """K2's and K3's arms instantiations: the default's column at
    ``(2,5,8)`` (the snapshot shadows stay in global memory), 128 lanes,
    registers capped for 3 blocks (12 warps).  The wrapper picks one
    exactly when a gray-failure or partition knob is on."""
    table = tfused.FR_STAGING[protocol]
    assert tuple(table) == tfused.KERNEL_SHAPES[protocol] == ((2, 5, 8, 0), (2, 3, 8, 0), (2, 5, 8, 1))
    arms, default = table[(2, 5, 8, 1)], table[(2, 5, 8, 0)]
    assert (arms.threads, arms.rows, arms.smem_bytes, arms.min_blocks) == (128, rows, rows * 512, 3)
    assert default.rows == rows
    binding = tfused.BINDINGS[protocol]
    state = trun.init_state(chip_smoke.main_config(protocol, 4), "cpu")
    assert binding.kernel_shape(state) == (2, 5, 8, 0)
    for name, cfg in chip_smoke.gray_knob_configs(4, 1, protocol).items():
        assert binding.kernel_shape(state, cfg.fault) == (2, 5, 8, 1), name
    assert tfused._launch_dims(binding, (2, 5, 8, 1)) == (2, 5, 8, 1, rows * 512)
