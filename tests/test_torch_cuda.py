"""The fused kernels (K1 to K3) against their plain versions on the card.

These tests need a CUDA GPU and skip without one; this module imports
nothing of JAX, so it runs on a machine that has only the port's stack:

    PAXOS_TPU_REAL=1 python -m pytest tests/test_torch_cuda.py tests/test_torch_ceiling.py -m cuda

(``PAXOS_TPU_REAL=1`` keeps tests/conftest.py from importing JAX.)  Each
kernel must equal its plain version byte for byte (tolerance 0: the state
is all int32/bool) from its main configuration, from its second
instantiated shape, and from near-limit ballots under the per-tick clamp
with a nonzero block offset, and must reproduce the golden digest.
"""

import dataclasses
import hashlib

import pytest
import torch

from chip_smoke import GOLDENS, MASK_CENSUS, main_config, near_limit_state
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

LIMIT = (1 << 15) - 1
PROTOCOLS = ["paxos", "fastpaxos", "raftcore"]


def _second_shape(protocol, n, seed):
    if protocol == "paxos":
        return TC.config1_no_faults(n, seed)  # (1, 3, 8)
    return dataclasses.replace(main_config(protocol, n, seed), n_acc=3)  # (2, 3, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_kernel_matches_plain_on_cuda(protocol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    apply_fn = tfused.BINDINGS[protocol].apply_fn
    big, small = main_config(protocol, 8192, 7), _second_shape(protocol, 4096, 1)
    cases = (
        (big, 96, None, {}),
        (small, 64, None, {}),
        (big, 64, near_limit_state(big, 4094), dict(blk0=2, clamp_per_tick=True)),
    )
    for cfg, ticks, init, kw in cases:
        init = trun.init_state(cfg, "cuda") if init is None else init
        plan = trun.init_plan(cfg, "cuda")
        plain = tfused.reference_chunk(
            init, cfg.seed, plan, cfg.fault, ticks, block=1024, apply_fn=apply_fn,
            blk_id=kw.get("blk0", 0), clamp_per_tick=kw.get("clamp_per_tick", False),
        )
        before = wrapper.launches
        kern = wrapper(init.clone(), cfg.seed, plan, cfg.fault, ticks, block=1024, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        for a, b in zip(kern.leaves(), plain.leaves(), strict=True):
            assert torch.equal(a, b)
        if kw:
            assert int(kern.proposer.bal.max()) == LIMIT
    cfg = main_config(protocol, 256, 7)
    st = wrapper(trun.init_state(cfg, "cuda"), 7, trun.init_plan(cfg, "cuda"), cfg.fault, 32, block=256)
    h = hashlib.sha256()
    for leaf in st.leaves():
        h.update(leaf.cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == GOLDENS[protocol]


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_draw_census_build_follows_the_kernel(protocol):
    """The draw-counting build advances the state as the kernel does, counts
    no launch, and draws at most every mask element of every tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    cfg = main_config(protocol, 8192, 5)
    plan, ticks = trun.init_plan(cfg, "cuda"), 48
    wrapper = tfused.FUSED_WRAPPERS[protocol]
    kern = wrapper(trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    before = wrapper.launches
    counted = trun.init_state(cfg, "cuda")
    draws = tfused.draw_census(protocol, counted, cfg.seed, plan, cfg.fault, ticks)
    assert wrapper.launches == before
    for a, b in zip(counted.leaves(), kern.leaves(), strict=True):
        assert torch.equal(a, b)
    assert 0 < draws <= MASK_CENSUS[protocol][1] * cfg.n_inst * ticks
    again = tfused.draw_census(protocol, trun.init_state(cfg, "cuda"), cfg.seed, plan, cfg.fault, ticks)
    assert again == draws  # the count is cleared after every read
