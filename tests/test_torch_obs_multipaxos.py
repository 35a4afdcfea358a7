"""The plain Multi-Paxos tick with every observer plane on against the JAX
package, bit for bit: config3's cell and config3 under config_gray_chaos's
and config_corrupt's fault configs (tests/test_torch_obs_mp_faults.py
takes config_stale's and config_delay_chaos's, and the goldens;
tests/test_torch_obs_mp_planes.py the margin, the digest and the long
log).

Each case runs the fused stream through the port's ``reference_chunk``
and the JAX package's ``reference_chunk`` with ``fused_fns("multipaxos")``,
at 256 lanes over 32 ticks from the same initial state (the JAX package's
workload plan carried across), on chip_smoke's numpy plan, with every
plane at the ``observed-multipaxos`` main path's settings; the whole state
must agree leaf for leaf (tolerance 0), and the case lights its exposure
classes."""

import dataclasses

import pytest

from _torch_jax import (  # noqa: F401  (one_core, one_torch_thread: autouse)
    check_observed_against_jax,
    one_core,
    one_torch_thread,
)
from paxos_tpu_torch.harness import config as C

PROTOCOL = "multipaxos"


def _on_config3(fault):
    """config3's cell with ``fault``'s fault config (K5 packs config3's
    k_slots 4)."""
    return lambda n, s: dataclasses.replace(C.config3_multipaxos(n, s), fault=fault(n, s).fault)


CASES = {
    "config3": lambda n, s: C.config3_multipaxos(n, s),
    "config_gray_chaos": _on_config3(C.config_gray_chaos),
    "config_corrupt": _on_config3(C.config_corrupt),
    "config_stale": _on_config3(C.config_stale),
    "config_delay_chaos": _on_config3(C.config_delay_chaos),
}
LIT = {
    "config3": {"drop"},
    "config_gray_chaos": {"drop", "dup", "partition", "timeout"},
    "config_corrupt": {"corrupt"},
    "config_stale": {"stale"},
    "config_delay_chaos": {"drop", "delay"},
}


@pytest.mark.parametrize("name", ["config3", "config_gray_chaos", "config_corrupt"])
def test_observed_multipaxos_tick_matches_jax(name):
    check_observed_against_jax(PROTOCOL, CASES[name], LIT[name])
