"""The main paths' evicting stream blocks, vouched for by the JAX package.

``chip_smoke.py`` runs each main path (config2 and the config5 sweep's Fast
Paxos and Raft-core: 1<<20 lanes, seed 0, 4096 ticks) through the port's
kernels on the card and checks the two lowest-numbered stream blocks that
evicted against the digests it pins (``EVICTION_PINS``).  This test computes those
digests with the JAX package's own ``reference_chunk``: one 1024-lane
block at its stream block id, 4096 ticks straight.  The main path's ballot
clamps at its dispatch boundaries are the identity while ballots stay
below the report limit, which the test asserts, so the two schedules are
the same.  Raft-core's main path evicts nowhere, so it pins no block.
"""

import functools
import hashlib

import jax
import numpy as np
import pytest

import chip_smoke
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns, reference_chunk

BLOCK, TICKS, LIMIT = 1024, 4096, (1 << 15) - 1

# Per main path: total evictions on the card, and for the two
# lowest-numbered evicting stream blocks, the evicting lanes inside the
# block and the block's final state digest.
PINS = chip_smoke.EVICTION_PINS


def _config(protocol: str):
    if protocol == "paxos":
        return JC.config2_dueling_drop(BLOCK, 0)
    return JC.config5_sweep(BLOCK, 0)[("paxos", "fastpaxos", "raftcore").index(protocol)]


@functools.lru_cache(maxsize=None)
def _blocks_run(protocol: str):
    """The JAX reference over one stream block, mapped over block ids."""
    cfg = _config(protocol)
    apply_fn, mask_fn, _ = fused_fns(protocol)
    return jax.jit(
        jax.vmap(
            lambda st, plan, blk: reference_chunk(
                st, 0, plan, cfg.fault, TICKS, apply_fn, mask_fn, blk_id=blk
            ),
            in_axes=(None, None, 0),
        )
    )


def test_chip_smoke_pins_these_blocks():
    assert sorted(PINS) == ["fastpaxos", "paxos", "raftcore"]
    assert chip_smoke.MAIN_EVICTION_LANES == [963 * BLOCK + 838]
    assert chip_smoke.MAIN_TICKS == TICKS


@pytest.mark.parametrize("protocol", [p for p, (_, blocks) in PINS.items() if blocks])
def test_evicting_blocks_match_jax_package(protocol):
    cfg = _config(protocol)
    pinned = PINS[protocol][1]
    blocks = np.array(sorted(pinned), np.int32)
    out = _blocks_run(protocol)(j_init_state(cfg), j_init_plan(cfg), blocks)
    leaves = [np.asarray(x) for x in jax.tree.leaves(out)]
    evictions = np.asarray(out.learner.evictions)
    for b, blk in enumerate(blocks.tolist()):
        lanes, want = pinned[blk]
        assert np.nonzero(evictions[b])[0].tolist() == lanes, blk
        assert int(np.asarray(out.proposer.bal)[b].max()) < LIMIT  # clamps were the identity
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf[b]).tobytes())
        assert h.hexdigest()[:16] == want, blk
