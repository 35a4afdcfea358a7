"""Helpers that the port's tests share to carry values into the JAX package."""

import dataclasses

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
