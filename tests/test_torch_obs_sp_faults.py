"""The plain SynchPaxos tick with every observer plane on against the JAX
package, bit for bit, on config_corrupt and config_stale
(tests/test_torch_obs_synchpaxos.py's cases, the rest of them), and the
planes' schedule identity: with the planes on, the state but the planes
equals ``chip_smoke.SP_GOLDEN`` and the whole state
``chip_smoke.SP_OBS_GOLDEN``, both as the JAX package computes them; and
the port's margin leaves (at ``q2``, no fast quorum) and client-queue
leaves equal the JAX package's numpy replay oracles over its own
trajectory."""

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from _torch_jax import (  # noqa: F401  (one_core, one_torch_thread: autouse)
    _np_leaves,
    check_observed_against_jax,
    check_observed_replay,
    jax_plan_of,
    observed_config,
    one_core,
    one_torch_thread,
)
from test_torch_obs_paxos import FAST_COMPILE, jax_config
from test_torch_obs_synchpaxos import CASES, LIT, PROTOCOL

from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.kernels import fused_tick as tfused


@pytest.mark.parametrize("name", ["config_corrupt", "config_stale"])
def test_observed_synchpaxos_tick_matches_jax(name):
    check_observed_against_jax(PROTOCOL, CASES[name], LIT[name])


def test_planes_leave_the_golden_schedule():
    """config_delay_chaos at 256 lanes, seed 7, 32 ticks on chip_smoke's
    numpy plan with every plane on (the workload on chip_smoke's plan): the
    state but the planes has ``SP_GOLDEN`` and the whole state
    ``SP_OBS_GOLDEN``, and the JAX package gives both from the same state
    and plan."""
    tcfg = observed_config(PROTOCOL, CASES["config_delay_chaos"])
    plan = chip_smoke.config_plan(tcfg, 7, "cpu")
    state = chip_smoke.path_state(tcfg, "cpu")
    jcfg = jax_config(tcfg)
    jstate = jax.tree.unflatten(
        jax.tree.structure(j_init_state(jcfg)),
        [jnp.asarray(x) for x in interop.state_to_numpy(state)],
    )
    apply_fn, mask_fn, _ = fused_fns(PROTOCOL)
    want = jax.jit(
        lambda st, pl: j_reference_chunk(st, 7, pl, jcfg.fault, 32, apply_fn, mask_fn),
        compiler_options=FAST_COMPILE,
    )(jstate, jax_plan_of(plan))
    got = tfused.FUSED_CHUNKS[PROTOCOL](state, 7, plan, tcfg.fault, 32)
    assert got.planes == ("telemetry", "coverage", "exposure", "margin", "wload")
    assert chip_smoke.digest(chip_smoke.without_planes(got).leaves()) == chip_smoke.SP_GOLDEN
    assert chip_smoke.digest(got.leaves()) == chip_smoke.SP_OBS_GOLDEN
    want = [torch.from_numpy(x.copy()) for x in _np_leaves(want)]
    assert chip_smoke.digest(want) == chip_smoke.SP_OBS_GOLDEN
    assert chip_smoke.digest(want[:len(want) - len(got.obs_leaves())]) == chip_smoke.SP_GOLDEN


def test_margin_and_queue_match_the_numpy_replay():
    """Tick by tick on config_corrupt on SynchPaxos (violations fire, so
    slack 0 occurs), the margin at the majority quorum."""
    check_observed_replay(PROTOCOL, lambda n, s: C.config_corrupt(n, s))
