"""The stream blocks of the ``delaychaos-fastpaxos``, ``delaychaos-raftcore``
and ``delaychaos-multipaxos`` main paths, vouched for by the JAX package.

``chip_smoke.py`` runs config_delay_chaos on Fast Paxos and Raft-core
(the stamped instantiations of K2 and K3) and config_delay_chaos's fault
config on config3's Multi-Paxos cell (K5's), each at 1<<20 lanes, seed 0,
over 4096 ticks on the card, and pins each path's evictions and the
lowest-numbered stream blocks that evicted (``EVICTION_PINS``) and stream
block 0 (``BLOCK0_DIGESTS``).  This test computes those blocks with the
JAX package's own ``reference_chunk``, one stream block at its block id on
its slice of chip_smoke's numpy plan, the whole campaign straight
(``_torch_jax.jax_path_blocks``).
"""

import dataclasses

import pytest

import chip_smoke
from _torch_jax import jax_path_blocks, one_core  # noqa: F401  (one_core: autouse)
from paxos_tpu.harness import config as JC

PATHS = ("delaychaos-fastpaxos", "delaychaos-raftcore", "delaychaos-multipaxos")


def _jax_config(path):
    """The path's config in the JAX package, at full width."""
    n = chip_smoke.FULL_LANES
    if path == "delaychaos-multipaxos":
        return dataclasses.replace(
            JC.config3_multipaxos(n, 0), fault=JC.config_delay_chaos(n, 0).fault
        )
    return dataclasses.replace(JC.config_delay_chaos(n, 0), protocol=path.split("-")[1])


@pytest.mark.parametrize("path", PATHS)
def test_path_blocks_match_jax_package(path):
    """Stream block 0 and the lowest evicting blocks ``chip_smoke`` pins,
    with their evicting lanes; a path that evicts nowhere pins none."""
    mp = chip_smoke.MAIN_PATHS[path]
    assert mp.ticks == 4096 and mp.compare_chunks == 2
    assert (mp.config, mp.fault) == (
        ("config3_multipaxos", "config_delay_chaos") if mp.protocol == "multipaxos"
        else ("config_delay_chaos", None)
    )
    total, pinned = chip_smoke.EVICTION_PINS[path]
    assert (total > 0) == (len(pinned) > 0) and len(pinned) <= 2
    want = {0: ([], chip_smoke.BLOCK0_DIGESTS[path]), **pinned}
    from paxos_tpu_torch.kernels import fused_tick as tfused

    binding = tfused.BINDINGS[mp.protocol]
    got = jax_path_blocks(path, _jax_config(path), sorted(want), binding.block, binding.ballot_limit)
    assert got == want
