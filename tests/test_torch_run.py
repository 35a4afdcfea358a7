"""The port's campaign harness against the JAX package, and the port's
independence from JAX.

``run(cfg, device="cpu")`` must report what the JAX package's
``summarize`` reports for its reference state after the same ticks: counts
exactly, the float32 fractions to a relative 1e-6 (the two packages may sum
in another order).
"""

import ast
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.harness.run import summarize as j_summarize
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FLOAT_FIELDS = ("chosen_frac", "mean_choose_tick", "decided_frac")


@functools.lru_cache(maxsize=None)
def jax_ref(fault):
    return jax.jit(
        lambda st, seed, plan, n: j_reference_chunk(st, seed, plan, fault, n)
    )


def _assert_report_matches(want, got):
    assert set(want) == set(got), (sorted(want), sorted(got))
    for key, w in want.items():
        if key in FLOAT_FIELDS:
            assert got[key] == pytest.approx(w, rel=1e-6), key
        else:
            assert got[key] == w, key


def test_run_report_matches_reference_summarize():
    jcfg, tcfg = JC.config2_dueling_drop(256, 7), TC.config2_dueling_drop(256, 7)
    ticks = 96
    got = trun.run(tcfg, total_ticks=ticks, chunk=32, pipeline_depth=2, device="cpu")
    jstate = jax_ref(jcfg.fault)(j_init_state(jcfg), 7, j_init_plan(jcfg), ticks)
    want = j_summarize(jstate)
    want.update(config_fingerprint=jcfg.fingerprint(), engine="fused", pipeline_depth=2)
    _assert_report_matches(want, got)
    assert dataclasses.asdict(tcfg.fault) == dataclasses.asdict(jcfg.fault)


def test_run_config4_with_carried_plan_matches_and_checker_fires():
    jcfg, tcfg = JC.config4_byzantine(256, 2), TC.config4_byzantine(256, 2)
    jplan = j_init_plan(jcfg)
    with pytest.raises(ValueError, match="plan="):
        trun.init_plan(tcfg, "cpu")
    plan = interop.plan_from_numpy([np.asarray(x) for x in jax.tree.leaves(jplan)])
    got, state = trun.run(tcfg, total_ticks=64, plan=plan, device="cpu", return_state=True)
    jstate = jax_ref(jcfg.fault)(j_init_state(jcfg), 2, jplan, 64)
    want = j_summarize(jstate)
    want.update(config_fingerprint=jcfg.fingerprint(), engine="fused")
    _assert_report_matches(want, got)
    assert got["violations"] > 0
    for w, g in zip(jax.tree.leaves(jstate), interop.state_to_numpy(state)):
        np.testing.assert_array_equal(np.asarray(w), g)


def test_run_until_all_chosen_config1():
    report = trun.run(
        TC.config1_no_faults(256), chunk=8, until_all_chosen=True, max_ticks=64,
        device="cpu",
    )
    assert report["chosen_frac"] == 1.0
    assert report["violations"] == 0 and report["evictions"] == 0
    assert report["ticks"] < 64 and report["ticks"] % 8 == 0  # probed per chunk


def test_make_advance_serial_matches_reference():
    """The serial dispatch, chunk by chunk, replays the reference's stream."""
    jcfg, tcfg = JC.config2_dueling_drop(128, 4), TC.config2_dueling_drop(128, 4)
    advance = trun.make_advance(tcfg, trun.init_plan(tcfg, "cpu"))
    state = trun.init_state(tcfg, "cpu")
    for _ in range(3):
        state = advance(state, 8)
    jstate = jax_ref(jcfg.fault)(j_init_state(jcfg), 4, j_init_plan(jcfg), 24)
    for w, g in zip(jax.tree.leaves(jstate), interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(np.asarray(w), g)


def test_config_acceptance_matches_reference():
    from paxos_tpu.harness.run import check_tick_budget as j_check

    for ticks in (262143, 262144):
        outcomes = []
        for check in (j_check, trun.check_tick_budget):
            try:
                check("paxos", ticks)
                outcomes.append(True)
            except ValueError:
                outcomes.append(False)
        assert outcomes[0] == outcomes[1]
    bad = dataclasses.replace(
        TC.config2_dueling_drop(64), fault=dataclasses.replace(TC.config2_dueling_drop(64).fault, timeout=5000)
    )
    with pytest.raises(ValueError, match="timer"):
        trun.init_state(bad, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trun.run(TC.config2_dueling_drop(64), engine="xla", device="cpu")
    cfg = TC.config5_sweep(64, 1)[1]  # every tick takes the delay (Fast Paxos here) ...
    with pytest.raises(ValueError, match="sampled fault plan"):
        trun.run(dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, p_delay=0.2)), device="cpu")
    cfg = TC.config2_dueling_drop(64)  # ... on the plan the reference samples
    with pytest.raises(ValueError, match="sampled fault plan"):
        trun.run(dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, p_delay=0.2)), device="cpu")


def test_run_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        trun.run(TC.config2_dueling_drop(256), total_ticks=8)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.init_state(TC.config2_dueling_drop(256))


_NO_JAX_CAMPAIGN = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "paxos_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import paxos_tpu_torch
for info in pkgutil.walk_packages(paxos_tpu_torch.__path__, "paxos_tpu_torch."):
    importlib.import_module(info.name)
from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.harness.run import run
for cfg in (C.config2_dueling_drop(128, 1),) + C.config5_sweep(128, 1)[1:]:
    report = run(cfg, total_ticks=16, device="cpu")
    assert report["ticks"] == 16 and report["violations"] == 0, report
import chip_smoke  # its numpy plans need nothing of JAX either
for cfg in (C.config3_multipaxos(128, 1), C.config3_long(128, 1), C.config_delay_chaos(128, 1)):
    report = run(cfg, total_ticks=16, plan=chip_smoke.config_plan(cfg, 1, "cpu"), device="cpu")
    assert report["ticks"] == 16 and report["violations"] == 0, report
print("ok")
"""


def test_port_runs_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CAMPAIGN], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=False,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_module_of_the_port_imports_jax():
    files = sorted((REPO / "paxos_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "paxos_tpu"), (path, mod)


def test_fused_chunk_registry_and_wrapper_counter():
    assert tfused.FUSED_CHUNKS["paxos"] is tfused.paxos_chunk
    for protocol, wrapper in tfused.FUSED_WRAPPERS.items():
        assert wrapper is getattr(tfused, f"fused_{protocol}_chunk")
        assert isinstance(wrapper.launches, int)
