"""The port's plain Paxos tick against the JAX package on the knobs no main
path sets, bit for bit.

``chip_smoke.fr_knob_configs("paxos", ...)`` gives config2 with p_dup 0.2
(duplicated requests and replies), with q1/q2 = 2/4 and 4/2, and with
ballot_stride 3, backoff_max 3 and timeout 5; ``chip_smoke.py`` and
tests/test_torch_cuda.py hold K1 to the plain version on the same configs.
Here 512 lanes run 96 ticks of the fused stream through the port's
``reference_chunk`` and the JAX package's ``reference_chunk`` with
``fused_fns("paxos")``, from the same initial state and the same numpy
plan (``chip_smoke.config_plan``), and must agree leaf for leaf
(tolerance 0: the state is all int32/bool).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from _torch_jax import jax_plan_of
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_state as _jax_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

N, TICKS, SEED = 512, 96, 10
CONFIGS = chip_smoke.fr_knob_configs("paxos", N, SEED)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paxos_knobs_match_jax_reference(name):
    tcfg = CONFIGS[name]
    jcfg = dataclasses.replace(
        JC.config2_dueling_drop(tcfg.n_inst, tcfg.seed),
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )
    assert jcfg.protocol == tcfg.protocol == "paxos"
    assert dataclasses.asdict(jcfg.fault) == dataclasses.asdict(tcfg.fault)
    plan = chip_smoke.config_plan(tcfg, SEED, "cpu")
    state = trun.init_state(tcfg, "cpu")
    treedef = jax.tree.structure(_jax_init_state(jcfg))
    jstate = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in interop.state_to_numpy(state)])
    apply_fn, mask_fn, _ = fused_fns("paxos")
    want = jax.jit(
        lambda st, plan: j_reference_chunk(st, SEED, plan, jcfg.fault, TICKS, apply_fn, mask_fn)
    )(jstate, jax_plan_of(plan))
    got = tfused.reference_chunk(state, SEED, plan, tcfg.fault, TICKS)
    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    got = interop.state_to_numpy(got)
    assert len(want) == len(got) == len(state.leaves())
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # Each case changes one knob of the main path's config, and the knob
    # shows in the run: the stride keeps every ballot round a multiple of 3
    # and moves some proposer past round 0; a duplicated request or reply
    # stays present after it is read, so more requests are left over.
    base = chip_smoke.main_config("paxos", N, SEED).fault
    assert tcfg.fault != base
    bal = got[3]
    if tcfg.fault.ballot_stride == 3:
        rounds = (bal.astype(np.int64) - 1) >> 3
        assert (rounds % 3 == 0).all() and (rounds > 0).any()
