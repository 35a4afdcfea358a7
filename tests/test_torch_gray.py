"""The port's gray-failure and partition arms of the Paxos tick against
the JAX package, bit for bit.

``chip_smoke.gray_knob_configs`` gives each knob of ``config_gray_chaos``
alone (a two-way and a one-way partition, flaky links without and with
duplication, timeout and backoff skew) and ``config_gray_chaos``,
``config_partition``, ``config_corrupt``, ``config_stale``, amnesia and
``config_flex(4, 2)``; ``chip_smoke.py`` and tests/test_torch_cuda.py hold
K1's arms instantiation to the plain tick on the same cases.  Here 512
lanes run 96 ticks of the fused stream through the port's
``reference_chunk`` and the JAX package's ``reference_chunk`` with
``fused_fns("paxos")``, from the same initial state (with the snapshot
shadows under stale_k) on the plan the JAX package samples, carried across
with ``interop.plan_from_numpy(..., cfg=)``, and must agree leaf for leaf
(tolerance 0: the state is all int32/bool).  The plans, the directional
cuts and which protocols take the knobs: tests/test_torch_gray_plan.py.
"""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)

N, TICKS, SEED = 512, 96, 12
CONFIGS = chip_smoke.gray_knob_configs(N, SEED)


def _jax_config(tcfg):
    """The JAX package's SimConfig with ``tcfg``'s fields."""
    return dataclasses.replace(
        JC.config2_dueling_drop(tcfg.n_inst, tcfg.seed),
        n_prop=tcfg.n_prop, n_acc=tcfg.n_acc, k_slots=tcfg.k_slots,
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_paxos_tick_matches_jax_under_gray(name):
    tcfg = CONFIGS[name]
    jcfg = _jax_config(tcfg)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    jstate, jplan = j_init_state(jcfg), j_init_plan(jcfg)
    state = trun.init_state(tcfg, "cpu")
    assert state.snapshots == (tcfg.fault.stale_k > 0)
    init = _np_leaves(jstate)
    for w, g in zip(init, interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(w, g)
    plan = interop.plan_from_numpy(_np_leaves(jplan), cfg=tcfg.fault)
    apply_fn, mask_fn, _ = fused_fns("paxos")
    want = jax.jit(
        lambda st, pl: j_reference_chunk(st, SEED, pl, jcfg.fault, TICKS, apply_fn, mask_fn)
    )(jstate, jplan)
    got = tfused.reference_chunk(state, SEED, plan, tcfg.fault, TICKS)
    want, got = _np_leaves(want), interop.state_to_numpy(got)
    assert len(want) == len(got) == len(init)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The case reaches its arm: a cut stalls requests in flight, a flaky or
    # corrupting or recovering run differs from the same run without it.
    assert not all((a == b).all() for a, b in zip(got, init))
