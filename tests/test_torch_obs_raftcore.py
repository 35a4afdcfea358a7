"""The plain Raft-core tick with every observer plane on against the JAX
package, bit for bit, and the planes' schedule identity.

Each case runs the fused stream through the port's ``reference_chunk``
and the JAX package's ``reference_chunk`` with ``fused_fns("raftcore")``,
at 256 lanes over 32 ticks from the same initial state (the JAX package's
workload plan carried across), on chip_smoke's numpy plan, with every
plane at the ``observed-raftcore`` main path's settings; the whole state
must agree leaf for leaf (tolerance 0).  The cases, config5's Raft-core
cell, config_gray_chaos, config_corrupt, config_stale and
config_delay_chaos on Raft-core, light every exposure class between them.
With the planes on, the state but the planes equals the golden
(tests/test_gray.py ``_GOLDEN_CTR["raftcore"]``); and the port's margin
leaves (the vote fence and the entry's term against the majority) and its
client-queue leaves equal the JAX package's numpy replay oracles
(``np_margin_tick``, ``np_replay_queue``) over the port's own
trajectory."""

import pytest

from _torch_jax import (  # noqa: F401  (one_core, one_torch_thread: autouse)
    check_observed_against_jax,
    check_observed_golden,
    check_observed_replay,
    one_core,
    one_torch_thread,
)
from paxos_tpu_torch.harness import config as C

PROTOCOL = "raftcore"
CASES = {
    "config5": lambda n, s: C.config5_sweep(n, s)[2],
    "config_gray_chaos": lambda n, s: C.config_gray_chaos(n, s),
    "config_corrupt": lambda n, s: C.config_corrupt(n, s),
    "config_stale": lambda n, s: C.config_stale(n, s),
    "config_delay_chaos": lambda n, s: C.config_delay_chaos(n, s),
}
LIT = {
    "config5": {"drop"},
    "config_gray_chaos": {"drop", "dup", "partition", "timeout"},
    "config_corrupt": {"corrupt"},
    "config_stale": {"stale"},
    "config_delay_chaos": {"drop", "delay"},
}


@pytest.mark.parametrize("name", CASES)
def test_observed_raftcore_tick_matches_jax(name):
    check_observed_against_jax(PROTOCOL, CASES[name], LIT[name])


def test_planes_leave_the_golden_schedule():
    """config5's Raft-core cell at 256 lanes, seed 7, 32 ticks with every
    plane on: the state but the planes has the golden digest."""
    check_observed_golden(PROTOCOL, CASES["config5"], "eb285905571b709f")


def test_margin_and_queue_match_the_numpy_replay():
    """Tick by tick on config_corrupt (violations fire, so slack 0
    occurs)."""
    check_observed_replay(PROTOCOL, lambda n, s: C.config_corrupt(n, s))
