"""The main paths' evicting stream blocks, vouched for by the JAX package.

``chip_smoke.py`` runs each main path (config2, the config5 sweep's Fast
Paxos and Raft-core, config3, config3-long and SynchPaxos on
config_delay_chaos: 1<<20 lanes, seed 0, 4096 ticks, config3-long 1024)
through the port's kernels on the card and checks the two lowest-numbered
stream blocks that evicted against the digests it pins
(``EVICTION_PINS``), and stream block 0 of the Multi-Paxos and SynchPaxos
paths (``BLOCK0_DIGESTS``).  This test computes those digests with the JAX
package's own ``reference_chunk``: one stream block (1024 lanes, 256 for
Multi-Paxos, on the block's slice of chip_smoke's numpy plan) at its
stream block id, the whole campaign straight (config3-long: compacted
after every 64-tick chunk).  The main path's ballot clamps are the
identity while ballots stay below the report limit, which the test
asserts, so the two schedules are the same.  Raft-core's main path evicts
nowhere, nor do the Multi-Paxos paths, so they pin no block.
"""

import functools
import hashlib

import jax
import numpy as np
import pytest

import chip_smoke
from _torch_jax import one_core  # noqa: F401  (autouse: one core)
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns, reference_chunk
from paxos_tpu.protocols.multipaxos import compact_mp_body

BLOCK, TICKS, LIMIT = 1024, 4096, (1 << 15) - 1
MP_BLOCK, MP_LIMIT = 256, (1 << 11) - 1

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
    assert sorted(PINS) == sorted(chip_smoke.MAIN_PATHS)
    assert chip_smoke.MAIN_EVICTION_LANES == [963 * BLOCK + 838]
    assert chip_smoke.MAIN_TICKS == TICKS
    paths = chip_smoke.MAIN_PATHS
    assert (paths["config3"].protocol, paths["config3"].ticks) == ("multipaxos", TICKS)
    assert (paths["config3long"].protocol, paths["config3long"].ticks) == ("multipaxos", 1024)
    # config3-long, and the same with every observer plane on (its protocol
    # state pinned as config3-long's).
    assert [p for p, mp in paths.items() if mp.compact] == ["config3long", "observed-multipaxos-long"]
    # BASELINE.md's config3 soaks report no evictions at k_slots 4.
    assert PINS["config3"] == PINS["config3long"] == PINS["observed-multipaxos-long"] == (0, {})


def _mp_block_digest(path: str, blk: int):
    """Stream block ``blk`` of a Multi-Paxos main path, by the JAX package:
    its state digest and evicting lanes."""
    tcfg = chip_smoke.main_config(path)
    jcfg = JC.config3_multipaxos(MP_BLOCK, 0) if path == "config3" else JC.config3_long(MP_BLOCK, 0)
    lo = blk * MP_BLOCK
    plan = jax.tree.unflatten(
        jax.tree.structure(j_init_plan(jcfg)),
        [x.numpy()[..., lo:lo + MP_BLOCK] for x in chip_smoke.config_plan(tcfg, 0, "cpu").leaves()],
    )
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    ticks = chip_smoke.MAIN_PATHS[path].ticks
    chunk = ticks if path == "config3" else chip_smoke.MAIN_CHUNK

    def step(st):
        st = reference_chunk(st, 0, plan, jcfg.fault, chunk, apply_fn, mask_fn, blk_id=blk)
        return compact_mp_body(st)[0] if path == "config3long" else st

    step = jax.jit(step)
    st = j_init_state(jcfg)
    for _ in range(ticks // chunk):
        st = step(st)
    assert int(np.asarray(st.proposer.bal).max()) < MP_LIMIT
    h = hashlib.sha256()
    for leaf in jax.tree.leaves(st):
        h.update(np.asarray(leaf).tobytes())
    return np.nonzero(np.asarray(st.learner.evictions))[0].tolist(), h.hexdigest()[:16]


@pytest.mark.parametrize("path", ["config3", "config3long"])
def test_multipaxos_blocks_match_jax_package(path):
    """Stream block 0 of each Multi-Paxos main path (chip_smoke pins its
    digest, evicting or not) and any evicting block it pins."""
    want = {0: ([], chip_smoke.BLOCK0_DIGESTS[path]), **PINS[path][1]}
    for blk, pinned in want.items():
        assert _mp_block_digest(path, blk) == pinned, blk


@pytest.mark.parametrize(
    "protocol",
    [p for p, (_, blocks) in PINS.items() if blocks and p in ("paxos", "fastpaxos", "raftcore")],
)
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


def _sp_blocks(blocks: list):
    """Stream blocks ``blocks`` of the SynchPaxos main path, by the JAX
    package, each on its slice of chip_smoke's numpy plan (one vmapped
    run): per block, its evicting lanes and state digest."""
    tcfg = chip_smoke.main_config("synchpaxos")
    jcfg = JC.config_delay_chaos(BLOCK, 0)
    full = [x.numpy() for x in chip_smoke.config_plan(tcfg, 0, "cpu").leaves()]
    plans = jax.tree.unflatten(
        jax.tree.structure(j_init_plan(jcfg)),
        [np.stack([x[..., b * BLOCK:(b + 1) * BLOCK] for b in blocks]) for x in full],
    )
    apply_fn, mask_fn, _ = fused_fns("synchpaxos")
    run = jax.jit(jax.vmap(
        lambda st, plan, blk: reference_chunk(st, 0, plan, jcfg.fault, TICKS, apply_fn, mask_fn, blk_id=blk),
        in_axes=(None, 0, 0),
    ))
    out = run(j_init_state(jcfg), plans, np.array(blocks, np.int32))
    leaves = [np.asarray(x) for x in jax.tree.leaves(out)]
    assert int(np.asarray(out.proposer.bal).max()) < LIMIT  # clamps were the identity
    got = {}
    for b, blk in enumerate(blocks):
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf[b]).tobytes())
        got[blk] = (np.nonzero(np.asarray(out.learner.evictions)[b])[0].tolist(), h.hexdigest()[:16])
    return got


def test_synchpaxos_blocks_match_jax_package():
    """Stream block 0 of the SynchPaxos main path (it evicts nowhere) and
    the two lowest evicting blocks it pins, with their evicting lanes."""
    assert chip_smoke.MAIN_PATHS["synchpaxos"].ticks == TICKS
    want = {0: ([], chip_smoke.BLOCK0_DIGESTS["synchpaxos"]), **PINS["synchpaxos"][1]}
    assert _sp_blocks(sorted(want)) == want
