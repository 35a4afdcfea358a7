"""Helpers that the port's tests share to carry values into the JAX package."""

import dataclasses
import os
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from paxos_tpu.faults.injector import FaultPlan as JFaultPlan


def jax_plan_of(tplan):
    """The JAX package's plan holding the leaves of the port's ``tplan``
    (no sampling)."""
    return JFaultPlan(**{
        f.name: None if getattr(tplan, f.name) is None else jnp.asarray(getattr(tplan, f.name).numpy())
        for f in dataclasses.fields(tplan)
    })


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
