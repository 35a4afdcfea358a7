"""The operation census behind ``chip_smoke.py``'s kernel bounds.

A fused kernel's operation bound counts the int32 work of one tick with
``scripts/roofline.py``'s census (recorded in ``ROOFLINE.json``), with its
mask share counted for the draws the kernel makes instead of for every
mask element.  ``chip_smoke.MASK_CENSUS`` pins that share per protocol;
this test recomputes it with the JAX package's ``counter_masks`` and the
census's own counting rules.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns

REPO = Path(__file__).resolve().parents[1]
BLOCK = 1024  # the fused block the census is taken at


def _roofline():
    spec = importlib.util.spec_from_file_location("roofline", REPO / "scripts" / "roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _census_config(protocol):
    if protocol == "paxos":
        return JC.config2_dueling_drop(BLOCK)
    return {c.protocol: c for c in JC.config5_sweep(BLOCK)}[protocol]


@pytest.mark.parametrize("protocol", sorted(chip_smoke.MASK_CENSUS))
def test_mask_census_matches_jax_counter_masks(protocol):
    cfg = _census_config(protocol)
    _, mask_fn, _ = fused_fns(protocol)
    state = j_init_state(cfg)

    def masks(st):
        return mask_fn(cfg.fault, jnp.int32(1), st)

    counts = _roofline().census_jaxpr(
        jax.make_jaxpr(masks)(state).jaxpr, {"alu": 0, "reduce": 0, "layout": 0}
    )
    elems = sum(int(np.prod(m.shape)) for m in jax.tree.leaves(jax.eval_shape(masks, state)))
    ops = (counts["alu"] + counts["reduce"]) / BLOCK
    assert chip_smoke.MASK_CENSUS[protocol] == (ops, elems / BLOCK)


def test_census_cases_are_recorded():
    cases = {c["case"]: c for c in json.loads((REPO / "ROOFLINE.json").read_text())["cases"]}
    for protocol, case in chip_smoke.CENSUS_CASES.items():
        assert cases[case]["block"] == BLOCK
        mask_ops, _ = chip_smoke.MASK_CENSUS[protocol]
        assert 0 < mask_ops < chip_smoke.tick_ops_per_lane(protocol)


@pytest.mark.parametrize("protocol", sorted(chip_smoke.MASK_CENSUS))
def test_lazy_census_counts_the_draws(protocol):
    """Every element drawn gives the census; no draw leaves its body."""
    ops = chip_smoke.tick_ops_per_lane(protocol)
    mask_ops, mask_elems = chip_smoke.MASK_CENSUS[protocol]
    assert chip_smoke.tick_ops_per_lane(protocol, mask_elems) == pytest.approx(ops, rel=1e-12)
    assert chip_smoke.tick_ops_per_lane(protocol, 0.0) == pytest.approx(ops - mask_ops, rel=1e-12)
