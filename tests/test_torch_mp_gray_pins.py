"""The Multi-Paxos gray-chaos main path's stream blocks, vouched for by the
JAX package, and the JAX CLI's ``--fault`` on config3.

``chip_smoke.py`` runs config_gray_chaos's fault config on config3's cell
(``graychaos-multipaxos``: 1<<20 lanes, seed 0, 4096 ticks, k_slots 4:
one-way partitions, flaky links, timer skew) through K5's arms
instantiation on the card, and pins the path's evictions and the two
lowest-numbered stream blocks that evicted (``EVICTION_PINS``) and stream
block 0 (``BLOCK0_DIGESTS``).  This test computes those blocks with the
JAX package's own ``reference_chunk``, one stream block of 256 lanes at its
block id on its slice of chip_smoke's numpy plan, the whole campaign
straight; the main path's chunk clamps are the identity while ballots stay
below the report limit, which the test asserts.
"""

import dataclasses
import hashlib

import jax
import numpy as np

import chip_smoke
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns, reference_chunk
from paxos_tpu_torch.harness import config as TC

BLOCK, TICKS, LIMIT = 256, 4096, (1 << 11) - 1
PATH = "graychaos-multipaxos"


def test_main_path_is_config3_under_gray_chaos():
    """config3's cell (its 4-row learner table, which K5 packs) with
    config_gray_chaos's fault config, through run(..., liveness=True)."""
    mp = chip_smoke.MAIN_PATHS[PATH]
    assert (mp.protocol, mp.config, mp.fault, mp.ticks) == (
        "multipaxos", "config3_multipaxos", "config_gray_chaos", TICKS
    )
    assert mp.liveness and mp.compare_chunks == 2
    tcfg = chip_smoke.main_config(PATH)
    jcfg = dataclasses.replace(
        JC.config3_multipaxos(chip_smoke.FULL_LANES, 0), fault=JC.config_gray_chaos(1, 0).fault
    )
    assert tcfg.fingerprint() == jcfg.fingerprint()
    assert (tcfg.n_prop, tcfg.n_acc, tcfg.log_len, tcfg.k_slots) == (2, 5, 8, 4)
    assert TC.config_gray_chaos(8, 0).k_slots == 8  # the config's own shape, which K5 refuses


def test_graychaos_multipaxos_blocks_match_jax_package():
    """Stream block 0 of the path and the evicting blocks ``chip_smoke``
    pins (none: the path evicts nowhere), by the JAX package."""
    total, pinned = chip_smoke.EVICTION_PINS[PATH]
    want = {0: ([], chip_smoke.BLOCK0_DIGESTS[PATH]), **pinned}
    blocks = sorted(want)
    tcfg = chip_smoke.main_config(PATH)
    jcfg = dataclasses.replace(JC.config3_multipaxos(BLOCK, 0), fault=JC.config_gray_chaos(BLOCK, 0).fault)
    full = [x.numpy() for x in chip_smoke.config_plan(tcfg, 0, "cpu").leaves()]
    with jax.threefry_partitionable(False):
        tree = jax.tree.structure(j_init_plan(jcfg))
    plans = jax.tree.unflatten(
        tree, [np.stack([x[..., b * BLOCK:(b + 1) * BLOCK] for b in blocks]) for x in full]
    )
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    out = jax.jit(jax.vmap(
        lambda st, plan, blk: reference_chunk(st, 0, plan, jcfg.fault, TICKS, apply_fn, mask_fn, blk_id=blk),
        in_axes=(None, 0, 0),
    ))(j_init_state(jcfg), plans, np.array(blocks, np.int32))
    leaves = [np.asarray(x) for x in jax.tree.leaves(out)]
    assert int(np.asarray(out.proposer.bal).max()) < LIMIT  # the chunk clamps were the identity
    assert int(np.asarray(out.learner.violations).sum()) == 0
    assert np.asarray(out.learner.chosen).all()  # every slot decided once the cuts healed
    got = {}
    for b, blk in enumerate(blocks):
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf[b]).tobytes())
        got[blk] = (np.nonzero(np.asarray(out.learner.evictions)[b])[0].tolist(), h.hexdigest()[:16])
    assert got == want
    assert total == sum(len(lanes) for lanes, _ in pinned.values()) == 0


def test_apply_fault_overrides_on_config3_matches_jax():
    """The JAX CLI's ``--fault`` puts the gray knobs on config3: the same
    fault config from the same overrides as the JAX package's."""
    from paxos_tpu.harness.config import apply_fault_overrides as j_apply

    jcfg, tcfg = JC.config3_multipaxos(4096, 1), TC.config3_multipaxos(4096, 1)
    for overrides in (
        ["p_part=0.5", "p_asym=0.7", "p_flaky=0.4", "flaky_dup=0.2", "timeout_skew=6"],
        ["stale_k=8", "p_crash=0.4", "backoff_skew=3"],
        ["p_corrupt=0.2", "amnesia=true"],
    ):
        want, got = j_apply(jcfg, overrides), TC.apply_fault_overrides(tcfg, overrides)
        assert dataclasses.asdict(want.fault) == dataclasses.asdict(got.fault)
        assert want.fingerprint() == got.fingerprint() and got.protocol == "multipaxos"
