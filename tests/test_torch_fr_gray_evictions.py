"""The Fast Paxos and Raft-core gray-chaos main paths' stream blocks,
vouched for by the JAX package.

``chip_smoke.py`` runs config_gray_chaos's fault config on config5's Fast
Paxos and Raft-core cells (1<<20 lanes, seed 0, 4096 ticks, k_slots 8:
one-way partitions, flaky links, timer skew) through the arms
instantiations of K2 and K3 on the card, and pins each path's evictions
and the two lowest-numbered stream blocks that evicted
(``EVICTION_PINS``) and stream block 0 (``BLOCK0_DIGESTS``).  This test
computes those blocks with the JAX package's own ``reference_chunk``, one
stream block of 1024 lanes at its block id on its slice of chip_smoke's
numpy plan, the whole campaign straight; the main path's chunk clamps are
the identity while ballots stay below the report limit, which the test
asserts.
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


@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore"])
def test_graychaos_blocks_match_jax_package(protocol):
    """Stream block 0 of the path and the two lowest evicting blocks
    ``chip_smoke`` pins, with their evicting lanes, by the JAX package
    (one vmapped run over the blocks, each on its slice of chip_smoke's
    numpy plan).  Raft-core's path evicts nowhere, so block 0 is its
    pin."""
    path = f"graychaos-{protocol}"
    mp = chip_smoke.MAIN_PATHS[path]
    assert (mp.protocol, mp.fault, mp.ticks) == (protocol, "config_gray_chaos", TICKS)
    total, pinned = chip_smoke.EVICTION_PINS[path]
    assert (total > 0 and len(pinned) == 2) if protocol == "fastpaxos" else (total, pinned) == (0, {})
    want = {0: ([], chip_smoke.BLOCK0_DIGESTS[path]), **pinned}
    blocks = sorted(want)
    tcfg = chip_smoke.main_config(path)
    assert tcfg.k_slots == 8  # the config's own learner table, not cut
    index = ("paxos", "fastpaxos", "raftcore").index(protocol)
    cell = JC.config5_sweep(BLOCK, 0)[index]
    jcfg = dataclasses.replace(cell, fault=JC.config_gray_chaos(BLOCK, 0).fault)
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
