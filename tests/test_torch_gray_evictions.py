"""The gray-chaos main path's stream blocks, vouched for by the JAX package.

``chip_smoke.py`` runs the gray-chaos main path (config_gray_chaos at
1<<20 lanes, seed 0, 4096 ticks, k_slots 8: one-way partitions, flaky
links, timer skew) through K1's arms instantiation on the card, and pins
its evictions and the two lowest-numbered stream blocks that evicted
(``EVICTION_PINS``) and stream block 0 (``BLOCK0_DIGESTS``).  This test
computes those blocks with the JAX package's own ``reference_chunk``, one
stream block of 1024 lanes at its block id on its slice of chip_smoke's
numpy plan, the whole campaign straight; the main path's chunk clamps are
the identity while ballots stay below the report limit, which the test
asserts.
"""

import hashlib

import jax
import numpy as np

import chip_smoke
from _torch_jax import one_core  # noqa: F401  (autouse: one core)
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns, reference_chunk

BLOCK, TICKS, LIMIT = 1024, 4096, (1 << 15) - 1


def test_graychaos_blocks_match_jax_package():
    """Stream block 0 of the gray-chaos main path and the two lowest
    evicting blocks ``chip_smoke`` pins, with their evicting lanes, by the
    JAX package (one vmapped run over the blocks, each on its slice of
    chip_smoke's numpy plan)."""
    path = chip_smoke.MAIN_PATHS["graychaos"]
    assert (path.protocol, path.config, path.ticks) == ("paxos", "config_gray_chaos", TICKS)
    total, pinned = chip_smoke.EVICTION_PINS["graychaos"]
    assert total > 0 and len(pinned) == 2
    want = {0: ([], chip_smoke.BLOCK0_DIGESTS["graychaos"]), **pinned}
    blocks = sorted(want)
    tcfg = chip_smoke.main_config("graychaos")
    assert tcfg.k_slots == 8  # the config's own learner table, not cut
    jcfg = JC.config_gray_chaos(BLOCK, 0)
    full = [x.numpy() for x in chip_smoke.config_plan(tcfg, 0, "cpu").leaves()]
    plans = jax.tree.unflatten(
        jax.tree.structure(j_init_plan(jcfg)),
        [np.stack([x[..., b * BLOCK:(b + 1) * BLOCK] for b in blocks]) for x in full],
    )
    apply_fn, mask_fn, _ = fused_fns("paxos")
    out = jax.jit(jax.vmap(
        lambda st, plan, blk: reference_chunk(st, 0, plan, jcfg.fault, TICKS, apply_fn, mask_fn, blk_id=blk),
        in_axes=(None, 0, 0),
    ))(j_init_state(jcfg), plans, np.array(blocks, np.int32))
    leaves = [np.asarray(x) for x in jax.tree.leaves(out)]
    assert int(np.asarray(out.proposer.bal).max()) < LIMIT  # the chunk clamps were the identity
    got = {}
    for b, blk in enumerate(blocks):
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf[b]).tobytes())
        got[blk] = (np.nonzero(np.asarray(out.learner.evictions)[b])[0].tolist(), h.hexdigest()[:16])
    assert got == want
