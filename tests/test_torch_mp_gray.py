"""The port's gray-failure and partition arms of the Multi-Paxos tick
against the JAX package, bit for bit.

Each case runs the fused stream through the port's ``reference_chunk``
with the plain tick and the JAX package's ``reference_chunk`` with
``fused_fns("multipaxos")``, from the same initial state (with the
snapshot shadows of ``promised`` and the slot log under stale_k), and the
two must agree leaf for leaf (tolerance 0: the state is all int32/bool):

- the JAX package's own fused-kernel cases (tests/test_gray.py):
  ``test_fused_matches_reference_under_gray``, every gray knob with crash
  windows on config3 at 64 lanes, seed 5, 24 ticks in one stream block, on
  the plan the JAX package samples; and ``test_flaky_zero_rates_are_neutral``,
  flaky links at zero rates on config3 at 128 lanes, seed 9, which must
  also equal the uniform case (p_drop and p_dup 0) lane for lane;
- each case of ``chip_smoke.gray_knob_configs(n, seed, "multipaxos")``:
  each arm alone on config3's cell (a two-way and a one-way partition,
  flaky links without and with duplication, timeout and backoff skew), the
  configs that set them (config_gray_chaos, config_partition,
  config_corrupt, config_stale with crash windows, amnesia) and every knob
  at once, at 128 lanes over 48 ticks on chip_smoke's numpy plan, the cases
  ``chip_smoke.py`` and tests/test_torch_cuda.py hold K5's arms to the
  plain tick on;
- the bug injections' counts (``chip_smoke.MP_GRAY_CHECKER_VIOLATIONS``):
  config_corrupt's and config_stale's fault configs on config3's cell, the
  JAX package's fused stream over stream blocks of 256 lanes against the
  port's ``run``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import chip_smoke
from _torch_jax import (  # noqa: F401  (one_core, one_torch_thread: autouse)
    check_mp_against_jax,
    jax_plan_of,
    mp_jax_config,
    one_core,
    one_torch_thread,
    split_blocks,
)
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

N, TICKS, SEED = 128, 48, 12
CASES = list(chip_smoke.gray_knob_configs(N, SEED, "multipaxos"))
BLOCK = 256  # Multi-Paxos' stream block


def test_every_gray_knob_matches_jax_on_its_plan():
    """tests/test_gray.py's fused-kernel case on Multi-Paxos."""
    cell = chip_smoke.main_config("config3", 64, 5)
    tcfg = dataclasses.replace(cell, fault=dataclasses.replace(cell.fault, **chip_smoke.GRAY_ALL))
    got = check_mp_against_jax(tcfg, 24, jax_plan=True)
    assert len(got.leaves()) == 32  # the snapshot shadows ride along
    assert int(got.learner.violations.sum()) > 0  # corruption, stale recovery


def test_flaky_zero_rates_are_neutral():
    """tests/test_gray.py's zero-rate case on the counter stream: per-link
    thresholds at 0 give the uniform case's state, lane for lane."""
    base = chip_smoke.main_config("config3", 128, 9)
    plain = dataclasses.replace(base, fault=dataclasses.replace(base.fault, p_drop=0.0, p_dup=0.0))
    flaky = dataclasses.replace(plain, fault=dataclasses.replace(
        plain.fault, p_flaky=0.5, flaky_drop=0.0, flaky_dup=0.0))
    check_mp_against_jax(flaky, TICKS, jax_plan=True)
    plan = chip_smoke.config_plan(plain, 9, "cpu")
    uniform = tfused.reference_chunk(
        trun.init_state(plain, "cpu"), 9, plan, plain.fault, TICKS,
        apply_fn=tfused.BINDINGS["multipaxos"].apply_fn,
        mask_fn=tfused.BINDINGS["multipaxos"].mask_fn,
    )
    flaky_plan = chip_smoke.config_plan(flaky, 9, "cpu")
    flaky_run = tfused.reference_chunk(
        trun.init_state(flaky, "cpu"), 9, flaky_plan, flaky.fault, TICKS,
        apply_fn=tfused.BINDINGS["multipaxos"].apply_fn,
        mask_fn=tfused.BINDINGS["multipaxos"].mask_fn,
    )
    for w, g in zip(uniform.leaves(), flaky_run.leaves(), strict=True):
        assert bool((w == g).all())


@pytest.mark.parametrize("name", CASES)
def test_gray_knob_case_matches_jax(name):
    tcfg = chip_smoke.gray_knob_configs(N, SEED, "multipaxos")[name]
    assert tcfg.protocol == "multipaxos" and tcfg.k_slots == 4
    check_mp_against_jax(tcfg, TICKS, jax_plan=False)


@functools.lru_cache(maxsize=None)
def _jax_violations(key):
    """The JAX package's violations of ``key``'s campaign on chip_smoke's
    plan, over stream blocks of 256 lanes at their block ids."""
    name, n_inst, seed, ticks = key
    tcfg = chip_smoke.mp_gray_checker_config(name, n_inst, seed)
    jcfg = mp_jax_config(tcfg)
    plan = chip_smoke.config_plan(tcfg, seed, "cpu")
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    out = jax.jit(jax.vmap(
        lambda st, pl, blk: j_reference_chunk(st, seed, pl, jcfg.fault, ticks, apply_fn, mask_fn, blk_id=blk),
    ))(*split_blocks(j_init_state(jcfg), jax_plan_of(plan), n_inst, BLOCK))
    assert int(np.asarray(out.proposer.bal).max()) < (1 << 11) - 1  # the run's clamps were the identity
    return int(np.asarray(out.learner.violations).sum())


@pytest.mark.parametrize(
    "key", sorted(chip_smoke.MP_GRAY_CHECKER_VIOLATIONS), ids=lambda k: "-".join(map(str, k))
)
def test_bug_injection_counts_match_jax(key):
    name, n_inst, seed, ticks = key
    want = chip_smoke.MP_GRAY_CHECKER_VIOLATIONS[key]
    assert _jax_violations(key) == want
    tcfg = chip_smoke.mp_gray_checker_config(name, n_inst, seed)
    got = trun.run(tcfg, total_ticks=ticks, plan=chip_smoke.config_plan(tcfg, seed, "cpu"), device="cpu")
    assert got["violations"] == want
    if name == "config_corrupt":  # the checker fires on corruption
        assert want > 0
