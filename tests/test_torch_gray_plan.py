"""The gray-failure plan fields, the directional cuts and the snapshot
shadows of the port against the JAX package, and which protocols take the
gray-failure and partition knobs.

``FaultPlan.link_ok`` must give the JAX package's link view with and
without a direction, with and without ``part_dir``; a plan the JAX
package samples for a config lighting any subset of the optional fields
(``part_dir``, ``link_drop``, ``link_dup``, ``ptimeout``, ``pboff``,
``link_delay``) must carry across and back leaf for leaf, told apart by
the config, and ``FaultPlan.none(cfg=)`` must have the JAX package's
benign leaves; a ``stale_k`` state carries the snapshot shadows as the
JAX package's does; and ``check_supported`` must take every gray knob on
the Paxos, Fast Paxos, Raft-core and Multi-Paxos ticks and refuse it,
naming ROADMAP item 12, on SynchPaxos.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paxos_tpu.faults.injector import FaultPlan as JFaultPlan
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu_torch import interop
from paxos_tpu_torch.faults.injector import OPTIONAL_FIELDS, FaultConfig, FaultPlan
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols import paxos as tpaxos
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_link_ok_matches_jax_directional_cuts():
    """``link_ok`` with and without a direction, with ``part_dir`` of every
    value and without one, at ticks before, inside and after the windows."""
    rng = np.random.default_rng(3)
    n_prop, n_acc, n = 2, 5, 96
    start = rng.integers(0, 8, n).astype(np.int32)
    fields = dict(
        part_start=np.where(rng.random(n) < 0.7, start, np.iinfo(np.int32).max).astype(np.int32),
        part_end=(start + rng.integers(1, 6, n)).astype(np.int32),
        aside=rng.random((n_acc, n)) < 0.5, pside=rng.random((n_prop, n)) < 0.5,
    )
    tplan = FaultPlan.none(n, n_acc, n_prop)
    jplan = JFaultPlan.none(n, n_acc, n_prop)
    for k, v in fields.items():
        setattr(tplan, k, torch.from_numpy(v))
        jplan = jplan.replace(**{k: jnp.asarray(v)})
    part_dir = np.arange(n, dtype=np.int32) % 3
    for with_dir in (False, True):
        if with_dir:
            tplan.part_dir = torch.from_numpy(part_dir)
            jplan = jplan.replace(part_dir=jnp.asarray(part_dir))
        cut_seen = 0
        for tick in range(0, 16):
            for direction in (None, "req", "rep"):
                want = np.asarray(jplan.link_ok(jnp.int32(tick), direction))
                got = tplan.link_ok(torch.tensor(tick, dtype=torch.int32), direction).numpy()
                np.testing.assert_array_equal(want, got)
                cut_seen += int((~got).sum())
        assert cut_seen > 0


def _subset_config(subset) -> FaultConfig:
    """A config whose knobs put exactly the optional plan fields ``subset``
    in a sampled plan."""
    knobs = dict(p_dup=0.0, flaky_dup=0.0)
    if "part_dir" in subset:
        knobs.update(p_part=0.5, p_asym=0.6)
    if "link_drop" in subset:
        knobs.update(p_flaky=0.3, flaky_drop=0.4)
    if "link_dup" in subset:
        knobs.update(flaky_dup=0.2)
    if "ptimeout" in subset:
        knobs.update(timeout_skew=3)
    if "pboff" in subset:
        knobs.update(backoff_skew=3)
    if "link_delay" in subset:
        knobs.update(p_delay=0.3)
    return FaultConfig(**knobs)


# Every subset of the optional fields a plan can hold (link_dup only with
# link_drop: per-link duplication needs flaky links).
SUBSETS = [
    subset
    for r in range(len(OPTIONAL_FIELDS) + 1)
    for subset in itertools.combinations(OPTIONAL_FIELDS, r)
    if "link_dup" not in subset or "link_drop" in subset
]


@pytest.mark.parametrize("subset", SUBSETS, ids=["+".join(s) or "none" for s in SUBSETS])
def test_plan_leaves_round_trip_every_optional_subset(subset):
    """A plan the JAX package samples for a config lighting exactly
    ``subset`` carries across and back leaf for leaf, and the fault-free
    plan for that config has the JAX package's leaves (benign values)."""
    cfg = _subset_config(subset)
    jcfg = JC.FaultConfig(**dataclasses.asdict(cfg))
    n, n_acc, n_prop = 32, 5, 2
    jplan = JFaultPlan.sample(jax.random.PRNGKey(len(subset)), jcfg, n, n_acc, n_prop)
    leaves = _np_leaves(jplan)
    assert len(leaves) == 9 + len(subset)
    plan = interop.plan_from_numpy(leaves, cfg=cfg)
    assert [f for f in OPTIONAL_FIELDS if getattr(plan, f) is not None] == list(subset)
    for w, g in zip(leaves, plan.leaves(), strict=True):
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())
    for w, g in zip(
        _np_leaves(JFaultPlan.none(n, n_acc, n_prop, jcfg)),
        FaultPlan.none(n, n_acc, n_prop, cfg=cfg).leaves(), strict=True,
    ):
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())
    moved = plan.to("cpu")
    assert [f for f in OPTIONAL_FIELDS if getattr(moved, f) is not None] == list(subset)


@pytest.mark.parametrize("protocol", ["paxos", "fastpaxos", "raftcore", "synchpaxos", "multipaxos"])
def test_check_supported_takes_the_gray_knobs_on_paxos_only(protocol):
    """Each gray-failure and partition knob is legal on every tick: the
    Paxos, Fast Paxos, Raft-core, Multi-Paxos and, since ROADMAP item 12b,
    SynchPaxos ones; ``run`` takes it on each, and the bounded delay,
    p_delay, which every tick takes too, is no gray knob."""
    assert tpaxos.GRAY_PROTOCOLS == ("paxos", "fastpaxos", "raftcore", "synchpaxos", "multipaxos")
    assert "p_delay" not in tpaxos.GRAY_KNOBS
    for knob in tpaxos.GRAY_KNOBS:
        default = getattr(FaultConfig(), knob)
        value = True if isinstance(default, bool) else (8 if isinstance(default, int) else 0.3)
        tpaxos.check_supported(dataclasses.replace(FaultConfig(), **{knob: value}), protocol)
    base = chip_smoke.main_config({"multipaxos": "config3"}.get(protocol, protocol), 64, 1)
    gray = dataclasses.replace(base, fault=dataclasses.replace(base.fault, p_corrupt=0.1))
    plan = chip_smoke.config_plan(gray, 1, "cpu")
    report = trun.run(gray, total_ticks=8, device="cpu", plan=plan)
    assert report["ticks"] == 8


def test_snapshot_shadows_carry_across():
    """A stale_k state has the snapshot shadows after the acceptor leaves,
    as the JAX package's; ``state_from_numpy`` takes it back, a SynchPaxos
    state with them too (since ROADMAP item 12b), and a leaf count that is
    no state's layout raises."""
    jcfg, tcfg = JC.config_stale(64, 1), chip_smoke.gray_knob_configs(64, 1)["config_stale"]
    leaves = _np_leaves(j_init_state(jcfg))
    assert len(leaves) == 32
    state = interop.state_from_numpy(leaves)
    assert state.snapshots and len(state.acceptor.leaves()) == 6
    for w, g in zip(leaves, interop.state_to_numpy(trun.init_state(tcfg, "cpu")), strict=True):
        np.testing.assert_array_equal(w, g)
    sp_cfg = chip_smoke.gray_knob_configs(64, 1, "synchpaxos")["config_stale"]
    sp_leaves = _np_leaves(j_init_state(dataclasses.replace(jcfg, protocol="synchpaxos")))
    sp = interop.state_from_numpy(sp_leaves, protocol="synchpaxos")
    assert sp.snapshots and not sp.stamped and len(sp.acceptor.leaves()) == 6
    for w, g in zip(sp_leaves, interop.state_to_numpy(trun.init_state(sp_cfg, "cpu")), strict=True):
        np.testing.assert_array_equal(w, g)
    with pytest.raises(NotImplementedError):
        interop.state_from_numpy(leaves[:-2], protocol="synchpaxos")
    bare = trun.init_state(dataclasses.replace(tcfg, fault=FaultConfig()), "cpu")
    with pytest.raises(ValueError, match="snapshot"):
        tfused.reference_chunk(bare, 1, chip_smoke.config_plan(tcfg, 1, "cpu"), tcfg.fault, 1)
