"""The stream blocks of the ``graychaos-synchpaxos`` and
``delaychaos-paxos`` main paths, vouched for by the JAX package.

``chip_smoke.py`` runs config_gray_chaos's fault config on
config_delay_chaos's SynchPaxos cell (K4's arms, unstamped) and
config_delay_chaos on Paxos (K1's stamped instantiation), each at 1<<20
lanes, seed 0, over 4096 ticks on the card, and pins each path's evictions
and the lowest-numbered stream blocks that evicted (``EVICTION_PINS``) and
stream block 0 (``BLOCK0_DIGESTS``).  This test computes those blocks with
the JAX package's own ``reference_chunk``, one stream block of 1024 lanes
at its block id on its slice of chip_smoke's numpy plan, the whole
campaign straight; the main path's chunk clamps are the identity while
ballots stay below the report limit, which the test asserts.  It also
holds ``main_config``'s protocol replace to the configs the paths had
before it: a no-op on every path whose config function is its protocol's.
"""

import dataclasses
import hashlib

import jax
import numpy as np
import pytest

import chip_smoke
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns, reference_chunk
from _torch_jax import one_core  # noqa: F401  (autouse: one core)

BLOCK, TICKS, LIMIT = 1024, 4096, (1 << 15) - 1
PATHS = {
    "graychaos-synchpaxos": ("synchpaxos", "config_gray_chaos"),
    "delaychaos-paxos": ("paxos", None),
}


def _jax_config(path):
    protocol, fault = PATHS[path]
    cfg = dataclasses.replace(JC.config_delay_chaos(BLOCK, 0), protocol=protocol)
    return cfg if fault is None else dataclasses.replace(
        cfg, fault=getattr(JC, fault)(BLOCK, 0).fault
    )


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_blocks_match_jax_package(path):
    """Stream block 0 of the path and the lowest evicting blocks
    ``chip_smoke`` pins, with their evicting lanes, by the JAX package
    (one vmapped run over the blocks, each on its slice of chip_smoke's
    numpy plan)."""
    mp = chip_smoke.MAIN_PATHS[path]
    protocol, fault = PATHS[path]
    assert (mp.protocol, mp.config, mp.fault, mp.ticks) == (
        protocol, "config_delay_chaos", fault, TICKS
    )
    total, pinned = chip_smoke.EVICTION_PINS[path]
    assert total > 0 and 1 <= len(pinned) <= 2
    want = {0: ([], chip_smoke.BLOCK0_DIGESTS[path]), **pinned}
    blocks = sorted(want)
    tcfg = chip_smoke.main_config(path)
    jcfg = _jax_config(path)
    assert dataclasses.asdict(jcfg.fault) == dataclasses.asdict(tcfg.fault)
    assert (jcfg.protocol, jcfg.n_prop, jcfg.n_acc, jcfg.k_slots) == (
        tcfg.protocol, tcfg.n_prop, tcfg.n_acc, tcfg.k_slots
    )
    full = [x.numpy() for x in chip_smoke.config_plan(tcfg, 0, "cpu").leaves()]
    with jax.threefry_partitionable(False):
        tree = jax.tree.structure(j_init_plan(jcfg))
    plans = jax.tree.unflatten(
        tree, [np.stack([x[..., b * BLOCK:(b + 1) * BLOCK] for b in blocks]) for x in full]
    )
    apply_fn, mask_fn, _ = fused_fns(protocol)
    out = jax.jit(jax.vmap(
        lambda st, plan, blk: reference_chunk(st, 0, plan, jcfg.fault, TICKS, apply_fn, mask_fn, blk_id=blk),
        in_axes=(None, 0, 0),
    ))(j_init_state(jcfg), plans, np.array(blocks, np.int32))
    leaves = [np.asarray(x) for x in jax.tree.leaves(out)]
    assert int(np.asarray(out.proposer.bal).max()) < LIMIT  # the chunk clamps were the identity
    assert int(np.asarray(out.learner.violations).sum()) == 0
    got = {}
    for b, blk in enumerate(blocks):
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf[b]).tobytes())
        got[blk] = (np.nonzero(np.asarray(out.learner.evictions)[b])[0].tolist(), h.hexdigest()[:16])
    assert got == want


def test_main_config_protocol_replace_changes_no_earlier_path():
    """``main_config`` runs a config function of another protocol on the
    path's protocol (config_delay_chaos on Paxos, Fast Paxos and
    Raft-core); on every other path the
    config function already gives the path's protocol, so its config is as
    it was: the config function's own, with the path's fault config."""
    from paxos_tpu_torch.harness import config as C

    for path, mp in chip_smoke.MAIN_PATHS.items():
        cfg = getattr(C, mp.config)(256, 3)
        cfg = cfg if mp.sweep_index is None else cfg[mp.sweep_index]
        if mp.fault is not None:
            cfg = dataclasses.replace(cfg, fault=getattr(C, mp.fault)(256, 3).fault)
        if mp.planes:  # observed-paxos: every observer plane on the config's own
            cfg = chip_smoke.with_planes(cfg)
        got = chip_smoke.main_config(path, 256, 3)
        if mp.config == "config_delay_chaos" and mp.protocol != "synchpaxos":  # delaychaos-*
            assert cfg.protocol == "synchpaxos" and got == dataclasses.replace(cfg, protocol=mp.protocol)
        else:
            assert got == cfg, path
        assert got.protocol == mp.protocol
