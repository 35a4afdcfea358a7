"""The port's ablated Paxos and Multi-Paxos ticks against the JAX
package's on fault configs, bit for bit.

"sends" and "consume" remove the send and consume sites that the delay
stamps and the gray-failure arms (per-link drops and duplicates, cuts,
timer skew) also reach.  On config_delay_chaos and config_gray_chaos (on
Paxos; on Multi-Paxos their fault configs on config3's cell, as the
delaychaos-multipaxos and graychaos-multipaxos paths take them), with
chip_smoke's numpy plans, 128 lanes in two stream blocks of 64 from block
id 3 run 32 ticks through the port's ``reference_chunk`` with
``fused_fns(protocol, {flag})`` and through the JAX package's, and must
agree leaf for leaf (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from _torch_jax import check_ablated_against_jax, one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu_torch.harness import config as C

N, BLOCK, BLK0, TICKS, SEED = 128, 64, 3, 32, 10


def _config(protocol, fault):
    if protocol == "multipaxos":
        return chip_smoke.main_config(f"{fault.removeprefix('config_').replace('_', '')}-multipaxos", N, SEED)
    return dataclasses.replace(getattr(C, fault)(N, SEED), protocol="paxos")


@pytest.mark.parametrize("flag", ["sends", "consume"])
@pytest.mark.parametrize("fault", ["config_delay_chaos", "config_gray_chaos"])
@pytest.mark.parametrize("protocol", ["paxos", "multipaxos"])
def test_ablated_fault_configs_match_jax(protocol, fault, flag):
    cfg = _config(protocol, fault)
    assert cfg.protocol == protocol
    assert cfg.fault == dataclasses.replace(getattr(C, fault)(N, SEED).fault)
    plan = chip_smoke.config_plan(cfg, SEED, "cpu")
    got = check_ablated_against_jax(cfg, (flag,), TICKS, BLOCK, BLK0, plan)
    assert np.asarray(got[-1 if protocol == "paxos" else -2]) == TICKS
