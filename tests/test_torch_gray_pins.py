"""The JAX package's own pins of the gray-failure, partition and
bug-injection configs, reproduced on the port's ``run`` (CPU, the plain
Paxos tick), and the gray-chaos main path's stream blocks vouched for by
the JAX package.

Each campaign runs at the size, seed and length of the JAX package's test
(tests/test_gray.py, tests/test_partition.py, tests/test_flexpaxos.py) on
the plan the JAX package samples for it, carried across with
``interop.plan_from_numpy(..., cfg=)``; the port's fused stream is another
schedule than the JAX package's XLA engine, so the pins are the
properties, not the counts: payload corruption, stale-snapshot recovery
and unsafe Flexible Paxos quorums must light up the checker; partitions
and gray chaos must stay safe and decide every lane.  Stale-snapshot
recovery rarely breaks agreement on Paxos alone (the JAX package's pin
sums Paxos and Fast Paxos, whose port does not model it yet): neither
package's Paxos fires at that pin's 4096 lanes, seed 3, 192 ticks, so
its case here is 4096 lanes, seed 14, 256 ticks, where the port's does.
"""

import dataclasses

import jax
import numpy as np
import pytest

from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness.run import run
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)


def _configs(name):
    """(JAX config, port config) of a pin case."""
    if name == "flex(2,2)":
        return JC.config_flex(2, 2, n_inst=8192, seed=11), TC.config_flex(2, 2, 8192, 11)
    if name == "gray_chaos":  # tests/test_gray.py: k_slots 16 keeps the checker complete
        j, t = JC.config_gray_chaos(2048, 3), TC.config_gray_chaos(2048, 3)
        return dataclasses.replace(j, k_slots=16), dataclasses.replace(t, k_slots=16)
    size = {"corrupt": (1024, 0), "stale": (4096, 14), "partition": (8192, 4)}[name]
    return getattr(JC, f"config_{name}")(*size), getattr(TC, f"config_{name}")(*size)


def _port_run(name, **kw):
    jcfg, tcfg = _configs(name)
    assert dataclasses.asdict(jcfg.fault) == dataclasses.asdict(tcfg.fault)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    leaves = [np.asarray(x) for x in jax.tree.leaves(j_init_plan(jcfg))]
    plan = interop.plan_from_numpy(leaves, cfg=tcfg.fault)
    return run(tcfg, plan=plan, device="cpu", **kw)


@pytest.mark.parametrize(
    "name,ticks", [("corrupt", 256), ("stale", 256), ("flex(2,2)", 256)]
)
def test_bug_injections_light_up_the_checker(name, ticks):
    report = _port_run(name, total_ticks=ticks)
    assert report["violations"] > 0


def test_partition_safe_and_live_after_heal():
    """tests/test_partition.py: windows end by tick 70, every lane decides
    well within 1024 ticks, and nothing is unsafe."""
    report = _port_run("partition", until_all_chosen=True, max_ticks=1024)
    assert report["violations"] == report["evictions"] == report["proposer_disagree"] == 0
    assert report["chosen_frac"] == 1.0


def test_gray_chaos_safe_and_live():
    report = _port_run("gray_chaos", total_ticks=192)
    assert report["violations"] == report["evictions"] == report["proposer_disagree"] == 0
    assert report["chosen_frac"] == 1.0
