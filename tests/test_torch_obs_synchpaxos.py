"""The plain SynchPaxos tick with every observer plane on against the JAX
package, bit for bit: config_delay_chaos's cell in both of its regimes
(inside the synchrony window, and violating it) and config_gray_chaos on
SynchPaxos (tests/test_torch_obs_sp_faults.py takes config_corrupt and
config_stale, the goldens and the numpy replay).

Each case runs the fused stream through the port's ``reference_chunk``
and the JAX package's ``reference_chunk`` with ``fused_fns("synchpaxos")``,
at 256 lanes over 32 ticks from the same initial state (the JAX package's
workload plan carried across), on chip_smoke's numpy plan, with every
plane at the ``observed-synchpaxos`` main path's settings; the whole state
must agree leaf for leaf (tolerance 0), and the case lights its exposure
classes (the skewed timeout against FAST's window ``delta``)."""

import pytest

from _torch_jax import (  # noqa: F401  (one_core, one_torch_thread: autouse)
    check_observed_against_jax,
    one_core,
    one_torch_thread,
)
from paxos_tpu_torch.harness import config as C

PROTOCOL = "synchpaxos"
CASES = {
    "config_delay_chaos": lambda n, s: C.config_delay_chaos(n, s),
    "config_delay_chaos_violate": lambda n, s: C.config_delay_chaos(n, s, violate_delta=True),
    "config_gray_chaos": lambda n, s: C.config_gray_chaos(n, s),
    "config_corrupt": lambda n, s: C.config_corrupt(n, s),
    "config_stale": lambda n, s: C.config_stale(n, s),
}
LIT = {
    "config_delay_chaos": {"drop", "delay"},
    "config_delay_chaos_violate": {"drop", "delay"},
    "config_gray_chaos": {"drop", "dup", "partition", "timeout"},
    "config_corrupt": {"corrupt"},
    "config_stale": {"stale"},
}


@pytest.mark.parametrize("name", ["config_delay_chaos", "config_delay_chaos_violate", "config_gray_chaos"])
def test_observed_synchpaxos_tick_matches_jax(name):
    check_observed_against_jax(PROTOCOL, CASES[name], LIT[name])
