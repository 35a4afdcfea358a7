"""The JAX package's counts of the bug injections on Fast Paxos and
Raft-core, reproduced by the port's ``run`` (CPU, the plain ticks), and
the port's ``apply_fault_overrides`` against the JAX package's.

``chip_smoke.FR_CHECKER_VIOLATIONS`` pins the violations of payload
corruption (``config_corrupt`` at the JAX package's pin size, 1024 lanes,
seed 0, 256 ticks) on Fast Paxos and Raft-core and of stale-snapshot
recovery (``config_stale`` at the JAX package's tests/test_gray.py pin,
4096 lanes, seed 3, 192 ticks) on Paxos, Fast Paxos and Raft-core, each on
``chip_smoke.config_plan``; ``chip_smoke.py`` holds K2's and K3's arms and
the plain ticks on the card to the same counts.  Here the JAX package
computes each count with its own fused stream (``reference_chunk`` with
``fused_fns``, one vmapped stream block of 1024 lanes at its block id, as
the fused engine runs), and the port's ``run`` must give it.  The JAX
package's pin sums stale recovery over Paxos and Fast Paxos
(``chip_smoke.STALE_SUM``); the sum is checked again on the plan the JAX
package samples itself.  Raft-core's stale recovery breaks agreement at
that size in neither package.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import chip_smoke
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns, reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness.run import run

BLOCK = 1024


def _jax_config(name, protocol, n_inst, seed):
    return dataclasses.replace(getattr(JC, name)(n_inst, seed), protocol=protocol)


@functools.lru_cache(maxsize=None)
def _blocks_run(name, protocol, seed, ticks):
    """The JAX package's fused stream over stream blocks of 1024 lanes,
    mapped over block ids."""
    cfg = _jax_config(name, protocol, BLOCK, seed)
    apply_fn, mask_fn, _ = fused_fns(protocol)
    return jax.jit(jax.vmap(
        lambda st, plan, blk: reference_chunk(st, seed, plan, cfg.fault, ticks, apply_fn, mask_fn, blk_id=blk),
        in_axes=(None, 0, 0),
    ))


def _jax_violations(key, leaves):
    """The JAX package's violations of ``key``'s campaign on the plan
    ``leaves`` (numpy, every lane)."""
    name, protocol, n_inst, seed, ticks = key
    cfg = _jax_config(name, protocol, BLOCK, seed)
    with jax.threefry_partitionable(False):
        tree = jax.tree.structure(j_init_plan(cfg))
    blocks = n_inst // BLOCK
    plans = jax.tree.unflatten(
        tree, [np.stack([x[..., b * BLOCK:(b + 1) * BLOCK] for b in range(blocks)]) for x in leaves]
    )
    out = _blocks_run(name, protocol, seed, ticks)(
        j_init_state(cfg), plans, np.arange(blocks, dtype=np.int32)
    )
    assert int(np.asarray(out.proposer.bal).max()) < (1 << 15) - 1  # the run's clamps were the identity
    return int(np.asarray(out.learner.violations).sum())


def _port_violations(key, plan):
    name, protocol, n_inst, seed, ticks = key
    return run(chip_smoke.fr_checker_config(name, protocol, n_inst, seed), total_ticks=ticks,
               plan=plan, device="cpu")["violations"]


@pytest.mark.parametrize(
    "key", sorted(chip_smoke.FR_CHECKER_VIOLATIONS), ids=lambda k: "-".join(map(str, k))
)
def test_bug_injection_counts_match_jax(key):
    name, protocol, n_inst, seed, _ = key
    tcfg = chip_smoke.fr_checker_config(name, protocol, n_inst, seed)
    jcfg = _jax_config(name, protocol, n_inst, seed)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    plan = chip_smoke.config_plan(tcfg, seed, "cpu")
    want = chip_smoke.FR_CHECKER_VIOLATIONS[key]
    assert _jax_violations(key, [x.numpy() for x in plan.leaves()]) == want
    assert _port_violations(key, plan) == want
    if name == "config_corrupt":  # the checker fires on corruption on both protocols
        assert want > 0


def test_stale_sum_matches_the_jax_pin():
    """tests/test_gray.py's pin: stale recovery at 4096 lanes, seed 3, over
    192 ticks, summed over Paxos and Fast Paxos, fires; on chip_smoke's
    plan the sum is STALE_SUM, and on the plan the JAX package samples the
    port's sum equals the JAX package's."""
    keys = [("config_stale", p, 4096, 3, 192) for p in ("paxos", "fastpaxos")]
    assert sum(chip_smoke.FR_CHECKER_VIOLATIONS[k] for k in keys) == chip_smoke.STALE_SUM > 0
    want = got = 0
    for key in keys:
        jcfg = _jax_config(*key[:4])
        with jax.threefry_partitionable(False):
            leaves = [np.asarray(x) for x in jax.tree.leaves(j_init_plan(jcfg))]
        want += _jax_violations(key, leaves)
        got += _port_violations(key, interop.plan_from_numpy(leaves, cfg=jcfg.fault))
    assert got == want


GOOD = [
    ["p_part=0.5", "p_asym=0.7", "p_flaky=0.4", "flaky_dup=0.2", "timeout_skew=6", "backoff_skew=3"],
    ["stale_k=8", "p_crash=0.4", "crash_max_start=60", "amnesia=false"],
    ["p_corrupt=0.2", "timeout=6", "amnesia=TRUE", "crash_forever=1"],
    [],
]
BAD = [["p_part"], ["p_prat=0.5"], ["amnesia=yes"], ["timeout=six"], ["p_drop=high"]]


@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore"])
def test_apply_fault_overrides_matches_jax(protocol):
    """The JAX CLI's ``--fault`` escape hatch, which puts gray knobs on
    config5-fastpaxos and config5-raftcore: the same fault config from the
    same overrides, and the same refusal of a malformed or unknown one."""
    from paxos_tpu.harness.config import apply_fault_overrides as j_apply

    index = ("paxos", "fastpaxos", "raftcore").index(protocol)
    jcfg, tcfg = JC.config5_sweep(4096, 1)[index], TC.config5_sweep(4096, 1)[index]
    for overrides in GOOD:
        want, got = j_apply(jcfg, overrides), TC.apply_fault_overrides(tcfg, overrides)
        assert dataclasses.asdict(want.fault) == dataclasses.asdict(got.fault)
        assert want.fingerprint() == got.fingerprint()
        assert got.protocol == protocol
    for overrides in BAD:
        with pytest.raises(ValueError) as want:
            j_apply(jcfg, overrides)
        with pytest.raises(ValueError) as got:
            TC.apply_fault_overrides(tcfg, overrides)
        assert str(got.value) == str(want.value)
    gray = TC.apply_fault_overrides(tcfg, GOOD[0])
    assert run(gray, total_ticks=8, plan=chip_smoke.config_plan(gray, 1, "cpu"), device="cpu")["ticks"] == 8
