"""Helpers that the port's tests share to carry values into the JAX package."""

import dataclasses

import jax.numpy as jnp

from paxos_tpu.faults.injector import FaultPlan as JFaultPlan


def jax_plan_of(tplan):
    """The JAX package's plan holding the leaves of the port's ``tplan``
    (no sampling)."""
    return JFaultPlan(**{
        f.name: None if getattr(tplan, f.name) is None else jnp.asarray(getattr(tplan, f.name).numpy())
        for f in dataclasses.fields(tplan)
    })
