"""The port's ``run()`` and ``summarize()`` with the observer planes on,
against the JAX package's report blocks, and what the port refuses.

config2 at 256 lanes, seed 3, with every plane on as the observed-paxos
main path sets them: the port's ``run`` (two 32-tick chunks, its chunk
clamps the identity) against the JAX package's ``summarize`` of its own
``reference_chunk`` over the same 64 ticks from the same state (the JAX
package's workload plan carried across): the telemetry, coverage,
exposure, margin and slo blocks and the rest of the report must be equal.
The same for config5's Fast Paxos and Raft-core cells, config3's
Multi-Paxos cell and config_delay_chaos's SynchPaxos cell, whose ticks
compute the planes too.  A workload plane without its plan raises, naming
item 15; a state with planes crosses from the JAX package's leaves with the
config that made it, and a Fast Paxos, Raft-core, Multi-Paxos or
SynchPaxos state with planes crosses both ways."""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from _torch_jax import jax_plan_of, one_core, one_torch_thread  # noqa: F401
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.harness.run import summarize as j_summarize
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.core.telemetry import TelemetryConfig
from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.obs.exposure import annotate_lit
from paxos_tpu_torch.workload.generator import WorkloadConfig
from test_torch_obs_paxos import FAST_COMPILE, jax_config

N, TICKS = 256, 64


def run_against_jax(tcfg, seed, lit=("drop",)):
    """The port's ``run`` of ``tcfg`` (every plane on; two 32-tick chunks)
    against the JAX package's ``summarize`` of its own ``reference_chunk``
    over the same ticks from the same state: the final states leaf for
    leaf, then the plane blocks and the rest of the report, whose exposure
    block lights the classes ``lit``; returns the report and the port's
    state."""
    jcfg = jax_config(tcfg)
    jstate = j_init_state(jcfg)
    wl = (np.asarray(jstate.wload.mode), np.asarray(jstate.wload.phase))
    plan = chip_smoke.config_plan(tcfg, seed, "cpu")
    report, state = trun.run(
        tcfg, total_ticks=TICKS, chunk=32, device="cpu", plan=plan, wload_plan=wl,
        return_state=True,
    )
    apply_fn, mask_fn, _ = fused_fns(tcfg.protocol)
    jend = jax.jit(
        lambda st, pl: j_reference_chunk(st, seed, pl, jcfg.fault, TICKS, apply_fn, mask_fn),
        compiler_options=FAST_COMPILE,
    )(jstate, jax_plan_of(plan))
    for w, g in zip(jax.tree.leaves(jend), interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(np.asarray(w), g)
    want = j_summarize(jend)
    for block in chip_smoke.PLANE_BLOCKS:
        assert report[block] == want[block], block
    for key in ("ticks", "chosen_frac", "violations", "evictions", "mean_choose_tick",
                "decided_frac", "proposer_disagree", "checker_complete"):
        assert report[key] == want[key], key
    assert report["config_fingerprint"] == jcfg.fingerprint()
    # The blocks say something: drops seen and counted, decides, a sketch
    # of visited states, served client requests.
    assert report["exposure"]["classes"]["drop"]["effective"] == report["telemetry"]["counters"]["drop"] > 0
    assert report["telemetry"]["counters"]["decide"] == sum(report["telemetry"]["hist"]) > 0
    assert 0 < report["coverage"]["bits_set"] <= report["coverage"]["new_bits"]
    assert report["slo"]["done"] > 0 and report["slo"]["offered"] == (
        report["slo"]["done"] + report["slo"]["shed"] + report["slo"]["queue_depth"]
    )
    annotated = annotate_lit(report["exposure"], tcfg.fault)
    assert sorted(annotated["lit"]) == sorted(lit) and annotated["vacuous"] == []
    return report, state


def test_run_reports_the_planes_as_the_jax_package():
    report, state = run_against_jax(chip_smoke.with_planes(C.config2_dueling_drop(N, 3)), 3)
    # The same blocks with the liveness block beside them, from one transfer.
    again = trun.summarize(state, liveness=True)
    assert all(again[b] == report[b] for b in chip_smoke.PLANE_BLOCKS) and "stuck_lanes" in again


@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore"])
def test_run_reports_the_planes_of_fastpaxos_and_raftcore_as_the_jax_package(protocol):
    """config5's cell of ``protocol`` at 256 lanes, seed 3, every plane on."""
    tcfg = chip_smoke.with_planes(chip_smoke.main_config(protocol, N, 3))
    report, state = run_against_jax(tcfg, 3)
    assert state.protocol == protocol and state.planes == (
        "telemetry", "coverage", "exposure", "margin", "wload"
    )
    again = trun.summarize(state, liveness=True)
    assert all(again[b] == report[b] for b in chip_smoke.PLANE_BLOCKS) and "stuck_lanes" in again


@pytest.mark.parametrize("path,lit", [("config3", ("drop",)), ("synchpaxos", ("drop", "delay"))])
def test_run_reports_the_planes_of_multipaxos_and_synchpaxos_as_the_jax_package(path, lit):
    """config3's Multi-Paxos cell and config_delay_chaos's SynchPaxos cell
    at 256 lanes, seed 3, every plane on, whose ticks compute the planes
    since the port's plane refusal went: as Fast Paxos' and Raft-core's."""
    tcfg = chip_smoke.with_planes(chip_smoke.main_config(path, N, 3))
    report, state = run_against_jax(tcfg, 3, lit)
    assert state.planes == ("telemetry", "coverage", "exposure", "margin", "wload")
    again = trun.summarize(state, liveness=True)
    assert all(again[b] == report[b] for b in chip_smoke.PLANE_BLOCKS) and "stuck_lanes" in again


def test_workload_plane_needs_its_plan():
    cfg = dataclasses.replace(C.config2_dueling_drop(16, 1), workload=WorkloadConfig(mix="mixed"))
    with pytest.raises(ValueError, match="item 15"):
        trun.init_state(cfg, "cpu")
    with pytest.raises(ValueError, match="item 15"):
        trun.run(cfg, total_ticks=8, device="cpu")
    state = trun.init_state(cfg, "cpu", wload_plan=chip_smoke.wload_plan(cfg, 1, "cpu"))
    assert state.planes == ("wload",) and len(state.leaves()) == 29 + 10


def test_state_with_planes_crosses_from_the_jax_package():
    """The JAX package's initial state with every plane on (and with a
    partial telemetry plane) reads back as the port's, leaf for leaf, given
    the config; without it the leaf count is refused."""
    for tel in (TelemetryConfig(True, 16, 8), TelemetryConfig(False, 0, 4)):
        tcfg = dataclasses.replace(chip_smoke.with_planes(C.config2_dueling_drop(32, 2)), telemetry=tel)
        leaves = [np.asarray(x) for x in jax.tree.leaves(j_init_state(jax_config(tcfg)))]
        state = interop.state_from_numpy(leaves, protocol="paxos", cfg=tcfg)
        assert state.planes == ("telemetry", "coverage", "exposure", "margin", "wload")
        assert state.wload.cfg == tcfg.workload
        for w, g in zip(leaves, interop.state_to_numpy(state), strict=True):
            np.testing.assert_array_equal(w, g)
        with pytest.raises(NotImplementedError, match="leaves"):
            interop.state_from_numpy(leaves, protocol="paxos")


@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore", "multipaxos", "synchpaxos"])
def test_states_with_planes_cross_both_ways(protocol):
    """A Fast Paxos, Raft-core, Multi-Paxos (config3's cell) or SynchPaxos
    state with every plane on, its snapshot shadows and delay stamps, after
    16 ticks: its leaves read back from numpy as the same state (the config
    tells the planes apart), and the JAX package's initial state of the
    same config reads as the port's."""
    if protocol == "multipaxos":
        tcfg = dataclasses.replace(C.config3_multipaxos(32, 4), fault=C.config_stale(32, 4).fault)
        n_leaves = 53 + 2 + 3  # 30 protocol leaves and 23 planes', 2 shadows, 3 stamps
    else:
        tcfg = dataclasses.replace(C.config_stale(32, 4), protocol=protocol)
        n_leaves = 52 + 3 + 2  # 29 and 23, 3 shadows, 2 stamps
    tcfg = chip_smoke.with_planes(tcfg)
    tcfg = dataclasses.replace(tcfg, fault=dataclasses.replace(tcfg.fault, p_delay=0.4, delay_max=2))
    plan = chip_smoke.config_plan(tcfg, 4, "cpu")
    state = chip_smoke.path_state(tcfg, "cpu")
    assert state.snapshots and state.stamped and len(state.leaves()) == n_leaves
    state = trun.make_advance(tcfg, plan)(state, 16)
    leaves = interop.state_to_numpy(state)
    back = interop.state_from_numpy(leaves, protocol=protocol, cfg=tcfg)
    assert type(back) is type(state) and back.planes == state.planes
    for w, g in zip(leaves, interop.state_to_numpy(back), strict=True):
        np.testing.assert_array_equal(w, g)
    with pytest.raises(NotImplementedError, match="leaves"):
        interop.state_from_numpy(leaves, protocol=protocol)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(j_init_state(jax_config(tcfg)))]
    jstate = interop.state_from_numpy(jleaves, protocol=protocol, cfg=tcfg)
    assert jstate.planes == ("telemetry", "coverage", "exposure", "margin", "wload")
    assert jstate.wload.cfg == tcfg.workload
