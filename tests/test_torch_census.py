"""The operation counts behind ``chip_smoke.py``'s kernel bounds.

A fused kernel's operation floor is the counter-PRNG draws its measuring
build counts at ``chip_smoke.DRAW_OPS`` each, the operations of
``counter_bits``.  Beside the bound ``chip_smoke.py`` prints an estimate
that is no floor: it counts the int32 work of one tick with
``scripts/roofline.py``'s census (recorded in ``ROOFLINE.json``), one case
per main path.  The census counts the vectorised tick, which draws every
mask element and (Multi-Paxos) rewrites every slot-array element every
tick, and (SynchPaxos with delay) computes every delay stamp every tick;
the kernels draw a mask, and touch a slot or a stamp, only where the
outcome depends on it, so the estimate counts those shares for what a
kernel's measuring build counts, at the census's cost per element.
``chip_smoke.MASK_CENSUS``, ``chip_smoke.SLOT_CENSUS`` and
``chip_smoke.STAMP_CENSUS`` pin the shares per case; these tests recompute
them with the JAX package: the mask share with ``counter_masks``
(Multi-Paxos: ``mp_counter_masks``) and the census's own counting rules,
the slot share from the census of the same config at twice the window,
since the census is linear in the window length, and the stamp share from
the census of the same config with p_delay 0, net of both mask shares.  A case ``ROOFLINE.json`` lacks (SynchPaxos on config_delay_chaos)
is recorded in ``chip_smoke.CENSUS_CASES`` and recomputed here with
``tick_census``.  All at the fused block the census is taken at, the protocol's
default.  The recorded ``alu_per_lane_tick`` is already net of the packed
codec's share (scripts/roofline.py records ``(alu - codec_alu) / block``),
so with every mask drawn and every slot (stamp) touched the count is the
recorded ALU + reduction census.
"""

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from _torch_jax import one_core  # noqa: F401  (autouse: one core)
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns

REPO = Path(__file__).resolve().parents[1]
# Census case -> the main path whose kernel's estimate counts it.
CASES = {mp.census: path for path, mp in chip_smoke.MAIN_PATHS.items()}


def _block(case):
    """The fused block the census is taken at: the protocol's default."""
    return fused_fns(chip_smoke.MAIN_PATHS[CASES[case]].protocol)[2]


def _roofline():
    spec = importlib.util.spec_from_file_location("roofline", REPO / "scripts" / "roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _census_config(case):
    """The JAX package's config of ``case``'s main path, one block wide."""
    mp = chip_smoke.MAIN_PATHS[CASES[case]]
    cfg = getattr(JC, mp.config)(_block(case))
    cfg = cfg if mp.sweep_index is None else cfg[mp.sweep_index]
    if mp.fault is not None:  # the path's fault config on the config's cell
        cfg = dataclasses.replace(cfg, fault=getattr(JC, mp.fault)(_block(case)).fault)
    return cfg


def _mask_share(cfg):
    """(operations, mask elements) per lane-tick of ``cfg``'s counter_masks,
    ``cfg`` one block wide."""
    _, mask_fn, _ = fused_fns(cfg.protocol)
    state = j_init_state(cfg)

    def masks(st):
        return mask_fn(cfg.fault, jnp.int32(1), st)

    counts = _roofline().census_jaxpr(
        jax.make_jaxpr(masks)(state).jaxpr, {"alu": 0, "reduce": 0, "layout": 0}
    )
    elems = sum(int(np.prod(m.shape)) for m in jax.tree.leaves(jax.eval_shape(masks, state)))
    return (counts["alu"] + counts["reduce"]) / cfg.n_inst, elems / cfg.n_inst


@pytest.mark.parametrize("case", sorted(chip_smoke.MASK_CENSUS))
def test_mask_census_matches_jax_counter_masks(case):
    assert chip_smoke.MASK_CENSUS[case] == _mask_share(_census_config(case))


def _roofline_json():
    return {c["case"]: c for c in json.loads((REPO / "ROOFLINE.json").read_text())["cases"]}


def _recorded():
    """Every census case: ROOFLINE.json's and chip_smoke's own."""
    return {**_roofline_json(), **chip_smoke.CENSUS_CASES}


def test_census_cases_are_recorded():
    cases = _recorded()
    assert not set(_roofline_json()) & set(chip_smoke.CENSUS_CASES)  # one source each
    assert all(case in cases for case in CASES)
    assert sorted(CASES) == sorted(chip_smoke.MASK_CENSUS)
    for share, protocol in ((chip_smoke.SLOT_CENSUS, "multipaxos"),
                            (chip_smoke.STAMP_CENSUS, "synchpaxos")):
        assert sorted(share) == sorted(
            c for c, path in CASES.items() if chip_smoke.MAIN_PATHS[path].protocol == protocol
        )
    assert chip_smoke.TOUCH_CENSUS == {**chip_smoke.SLOT_CENSUS, **chip_smoke.STAMP_CENSUS}
    for case in CASES:
        assert cases[case]["block"] == _block(case)
        mask_ops, _ = chip_smoke.MASK_CENSUS[case]
        touch_ops, _ = chip_smoke.TOUCH_CENSUS.get(case, (0.0, 0.0))
        assert 0 < mask_ops + touch_ops < chip_smoke.tick_ops_per_lane(case)


def _per_lane_tick(case, log_len):
    """alu + reduce per lane-tick of ``case``'s config at window ``log_len``."""
    cfg = dataclasses.replace(_census_config(case), log_len=log_len)
    c = _roofline().tick_census(cfg, _block(case))
    return c["alu_per_lane_tick"] + c["reduce_per_lane_tick"]


def _elems_per_lane(cfg):
    """State elements per lane of ``cfg``, one block wide."""
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(j_init_state(cfg))) / cfg.n_inst


def _slot_elems_per_lane(case, log_len):
    return _elems_per_lane(dataclasses.replace(_census_config(case), log_len=log_len))


@pytest.mark.parametrize("case", sorted(chip_smoke.SLOT_CENSUS))
def test_slot_census_matches_jax_window_scaling(case):
    """The slot share is what doubling the window adds: the census is linear
    in the window length (checked at half the window too)."""
    n_slots = _census_config(case).log_len
    at = {ell: _per_lane_tick(case, ell) for ell in (n_slots // 2, n_slots, 2 * n_slots)}
    c = _recorded()[case]
    assert at[n_slots] == c["alu_per_lane_tick"] + c["reduce_per_lane_tick"]
    slot_ops = at[2 * n_slots] - at[n_slots]
    assert at[n_slots // 2] == at[n_slots] - slot_ops / 2
    elems = _slot_elems_per_lane(case, 2 * n_slots) - _slot_elems_per_lane(case, n_slots)
    assert chip_smoke.SLOT_CENSUS[case] == (slot_ops, elems)


@pytest.mark.parametrize("case", sorted(chip_smoke.MASK_CENSUS))
def test_every_mask_drawn_counts_alu_plus_reduce(case):
    """The codec share is not subtracted a second time: with every mask
    drawn and every slot (stamp) touched the count is the recorded alu +
    reduce."""
    c = _recorded()[case]
    want = c["alu_per_lane_tick"] + c["reduce_per_lane_tick"]
    _, mask_elems = chip_smoke.MASK_CENSUS[case]
    _, touch_elems = chip_smoke.TOUCH_CENSUS.get(case, (0.0, 0.0))
    assert chip_smoke.tick_ops_per_lane(case) == want
    got = chip_smoke.tick_ops_per_lane(case, mask_elems, touch_elems)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", sorted(chip_smoke.MASK_CENSUS))
def test_lazy_census_counts_the_draws(case):
    """Every element drawn (touched) gives the census; no draw (touch)
    leaves the rest of it."""
    ops = chip_smoke.tick_ops_per_lane(case)
    mask_ops, mask_elems = chip_smoke.MASK_CENSUS[case]
    touch_ops, touch_elems = chip_smoke.TOUCH_CENSUS.get(case, (0.0, 0.0))
    assert chip_smoke.tick_ops_per_lane(case, mask_elems) == pytest.approx(ops, rel=1e-12)
    assert chip_smoke.tick_ops_per_lane(case, 0.0) == pytest.approx(ops - mask_ops, rel=1e-12)
    assert chip_smoke.tick_ops_per_lane(case, 0.0, 0.0) == pytest.approx(
        ops - mask_ops - touch_ops, rel=1e-12
    )
    assert chip_smoke.tick_ops_per_lane(case, None, touch_elems) == pytest.approx(ops, rel=1e-12)


@pytest.mark.parametrize("case", sorted(chip_smoke.CENSUS_CASES))
def test_chip_smoke_census_case_matches_jax_tick_census(case):
    """The recorded case is scripts/roofline.py's tick_census of its main
    path's config at the protocol's block; for config_delay_chaos the
    delta-violating regime counts the same, so one case serves both."""
    cfg = _census_config(case)
    want = chip_smoke.CENSUS_CASES[case]
    got = _roofline().tick_census(cfg, _block(case))
    for key in ("alu_per_lane_tick", "codec_alu_per_lane_tick", "reduce_per_lane_tick",
                "state_bytes_per_lane", "unpacked_bytes_per_lane"):
        assert got[key] == want[key], key
    assert want["block"] == _block(case) and want["case"] == case
    if cfg.protocol == "synchpaxos":
        violate = JC.config_delay_chaos(_block(case), violate_delta=True)
        again = _roofline().tick_census(violate, _block(case))
        assert all(again[k] == got[k] for k in ("alu_per_lane_tick", "reduce_per_lane_tick"))



@pytest.mark.parametrize("case", sorted(chip_smoke.STAMP_CENSUS))
def test_stamp_census_matches_jax_delay_off(case):
    """The stamp share is what turning the delay on adds to the census
    beyond the mask share of the delay draws, over the stamp elements the
    state gains; the same in both delay regimes."""
    block = _block(case)
    for violate in (False, True):
        on = JC.config_delay_chaos(block, violate_delta=violate)
        off = dataclasses.replace(on, fault=dataclasses.replace(on.fault, p_delay=0.0))
        net = {}
        for name, cfg in (("on", on), ("off", off)):
            c = _roofline().tick_census(cfg, block)
            net[name] = c["alu_per_lane_tick"] + c["reduce_per_lane_tick"] - _mask_share(cfg)[0]
        elems = _elems_per_lane(on) - _elems_per_lane(off)
        assert chip_smoke.STAMP_CENSUS[case] == (net["on"] - net["off"], elems)


def test_draw_ops_count_the_counter_hash():
    """``DRAW_OPS`` is the arithmetic of ``counter_bits`` less its three
    launch-constant terms (the stream's offset and its multiple, the seed's
    product), plus the compare that makes the draw a mask bit."""
    src = (REPO / "paxos_tpu_torch/kernels/csrc/fused_common.cuh").read_text()
    body = re.search(r"uint32_t counter_bits\(.*?\{(.*?)\n\}", src, re.S).group(1)
    ops = re.findall(r"\^=|\*=|>>|\+|\*", body)
    assert len(ops) == 13
    assert len(ops) - 3 + 1 == chip_smoke.DRAW_OPS
