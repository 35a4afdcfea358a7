"""Helpers that the port's tests share to carry values into the JAX package."""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paxos_tpu.faults.injector import FaultPlan as JFaultPlan
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused


def jax_plan_of(tplan):
    """The JAX package's plan holding the leaves of the port's ``tplan``
    (no sampling)."""
    return JFaultPlan(**{
        f.name: None if getattr(tplan, f.name) is None else jnp.asarray(getattr(tplan, f.name).numpy())
        for f in dataclasses.fields(tplan)
    })


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def jax_config(tcfg):
    """The JAX package's SimConfig with ``tcfg``'s fields."""
    return dataclasses.replace(
        JC.config2_dueling_drop(tcfg.n_inst, tcfg.seed),
        protocol=tcfg.protocol, n_prop=tcfg.n_prop, n_acc=tcfg.n_acc, k_slots=tcfg.k_slots,
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )


def check_against_jax(tcfg, ticks, jax_plan: bool):
    """``tcfg``'s plain tick (the port's ``reference_chunk``) against the
    JAX package's ``reference_chunk`` with ``fused_fns``, leaf for leaf,
    over ``ticks`` ticks from the same initial state, on the plan the JAX
    package samples (``jax_plan``) or on chip_smoke's numpy plan; returns
    the final state's leaves."""
    jcfg = jax_config(tcfg)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    state = trun.init_state(tcfg, "cpu")
    assert state.snapshots == (tcfg.fault.stale_k > 0)
    assert state.stamped == (tcfg.fault.p_delay > 0)
    jstate = j_init_state(jcfg)
    init = _np_leaves(jstate)
    for w, g in zip(init, interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(w, g)
    if jax_plan:
        with jax.threefry_partitionable(False):
            jplan = j_init_plan(jcfg)
        plan = interop.plan_from_numpy(_np_leaves(jplan), cfg=tcfg.fault)
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
    want, got = _np_leaves(want), interop.state_to_numpy(got)
    assert len(want) == len(got) == len(init)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The case reaches its arm: the run moved the state.
    assert not all((a == b).all() for a, b in zip(got, init))
    return got


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the plain PyTorch versions of a test module
    (autouse where a module imports it).  Their tensors are small: one
    thread runs them as fast as eight, and the idle threads of a wider pool
    would spin on the cores the suite's other workers need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pin_threads(cores: set) -> None:
    """Set the CPU affinity of every thread of this process (Linux: the
    tasks under /proc/self/task) to ``cores``."""
    for task in Path("/proc/self/task").iterdir():
        try:
            os.sched_setaffinity(int(task.name), cores)
        except OSError:  # a thread that ended meanwhile, or one the system will not move
            pass


@pytest.fixture(autouse=True, scope="module")
def one_core():
    """Hold a test module that compiles and runs many JAX cases to one core
    (autouse where a module imports it; each pytest-xdist worker its own
    core, by its number), restored after.
    XLA spreads a compile or a vmapped run over every core of the machine,
    and the suite's other workers need them: under that load the JAX
    package's tests/test_fused.py::test_fused_segmented_multipaxos_longlog_compact
    can deadlock (ROADMAP C4).  New threads inherit the pin from the thread
    that starts them.  Without per-thread affinity (not Linux) it does
    nothing."""
    if not hasattr(os, "sched_setaffinity") or not Path("/proc/self/task").is_dir():
        yield
        return
    allowed = os.sched_getaffinity(0)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0").removeprefix("gw")
    cores = sorted(allowed)
    _pin_threads({cores[int(worker) % len(cores) if worker.isdigit() else 0]})
    try:
        yield
    finally:
        _pin_threads(allowed)
