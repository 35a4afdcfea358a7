"""The port's plain Fast Paxos and Raft-core ticks against the JAX package
on the knobs no main path sets, bit for bit.

``chip_smoke.fr_knob_configs`` gives config5's Fast Paxos and Raft-core
cells with p_dup 0.2 (duplicated requests and replies) and with
ballot_stride 3 and backoff_max 3, and the Fast Paxos cell with
q1/q2/q_fast = 4/2/4; ``chip_smoke.py`` and tests/test_torch_cuda.py hold
K2 and K3 to the plain versions on the same configs.  Here 512 lanes run
96 ticks of the fused stream through the port's ``reference_chunk`` and
the JAX package's ``reference_chunk`` with ``fused_fns(protocol)``, from
the same initial state and the same numpy plan
(``chip_smoke.config_plan``), and must agree leaf for leaf (tolerance 0:
the state is all int32/bool).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from _torch_jax import jax_plan_of, one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_state as _jax_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

N, TICKS, SEED = 512, 96, 10
CASES = [
    (protocol, name)
    for protocol in ("fastpaxos", "raftcore")
    for name in chip_smoke.fr_knob_configs(protocol, N, SEED)
]


def _jax_config(tcfg):
    index = chip_smoke.MAIN_PATHS[tcfg.protocol].sweep_index
    return dataclasses.replace(
        JC.config5_sweep(tcfg.n_inst, tcfg.seed)[index],
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )


@pytest.mark.parametrize("protocol,name", CASES, ids=[f"{p}-{n}" for p, n in CASES])
def test_fr_knobs_match_jax_reference(protocol, name):
    tcfg = chip_smoke.fr_knob_configs(protocol, N, SEED)[name]
    jcfg = _jax_config(tcfg)
    assert jcfg.protocol == tcfg.protocol == protocol
    assert dataclasses.asdict(jcfg.fault) == dataclasses.asdict(tcfg.fault)
    plan = chip_smoke.config_plan(tcfg, SEED, "cpu")
    state = trun.init_state(tcfg, "cpu")
    treedef = jax.tree.structure(_jax_init_state(jcfg))
    jstate = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in interop.state_to_numpy(state)])
    apply_fn, mask_fn, _ = fused_fns(protocol)
    want = jax.jit(
        lambda st, plan: j_reference_chunk(st, SEED, plan, jcfg.fault, TICKS, apply_fn, mask_fn)
    )(jstate, jax_plan_of(plan))
    got = tfused.reference_chunk(
        state, SEED, plan, tcfg.fault, TICKS, apply_fn=tfused.BINDINGS[protocol].apply_fn
    )
    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    got = interop.state_to_numpy(got)
    assert len(want) == len(got) == len(state.leaves())
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # Each case changes one knob of the main path's config, and the knob
    # shows in the run: the stride keeps every ballot round a multiple of 3
    # (the fast round is round 0) and moves some proposer past round 0.
    base = chip_smoke.main_config(protocol, N, SEED).fault
    assert tcfg.fault != base
    if tcfg.fault.ballot_stride == 3:
        rounds = (got[3].astype(np.int64) - 1) >> 3
        assert (rounds % 3 == 0).all() and (rounds > 0).any()
