"""The port's plain Multi-Paxos tick against the JAX package on the knobs
no main path sets, bit for bit.

``chip_smoke.mp_knob_configs`` gives config3's cell without its crash
windows, with p_dup 0.2 (duplicated requests), with q1/q2 = 2/4 (which
the Multi-Paxos tick reads nowhere: its quorums are majorities), and with
ballot_stride 3, backoff_max 3 and timeout 5; ``chip_smoke.py`` and
tests/test_torch_cuda.py hold K5 to the plain version on the same configs.
Here 512 lanes run 128 ticks of the fused stream, in stream blocks of 256
lanes, through the port's ``reference_chunk`` and the JAX package's
(tests/_torch_jax.py ``check_mp_against_jax``: each block at its block id),
from the same initial state and plan, and must agree leaf for leaf
(tolerance 0: the state is all int32/bool).
"""

import numpy as np
import pytest

import chip_smoke
from _torch_jax import check_mp_against_jax, one_core, one_torch_thread  # noqa: F401  (autouse)

N, TICKS, SEED, BLOCK = 512, 128, 10, 256
CONFIGS = chip_smoke.mp_knob_configs(N, SEED)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_multipaxos_knobs_match_jax_reference(name):
    tcfg = CONFIGS[name]
    got = check_mp_against_jax(tcfg, TICKS, jax_plan=False, block=BLOCK)
    # Each case changes one knob of the main path's config, and the knob
    # shows in the run: the stride moves every ballot round by 3 from NIL's
    # round -1, and some proposer past its first election; every lane still
    # decides its whole window.
    assert tcfg.fault != chip_smoke.main_config("config3", N, SEED).fault
    bal = got.proposer.bal.numpy()
    if tcfg.fault.ballot_stride == 3:
        rounds = (bal.astype(np.int64)[bal > 0] - 1) >> 3
        assert ((rounds + 1) % 3 == 0).all() and (rounds > 2).any()
    assert bool(got.learner.chosen.all())
