"""The port's ablated Paxos tick against the JAX package's, bit for bit.

``fused_tick.fused_fns("paxos", ablate)`` binds the plain tick with a
component removed (``protocols.paxos.ABLATE_FLAGS``: the PRNG draws, the
selection, the sends, the consume, the learner, the proposer), as the JAX
package's ``fused_fns`` binds its own for ``scripts/ablate_fused.py``.  On
config2 (128 lanes in two stream blocks of 64 from block id 3, so that the
PRNG-free selection scores, each lane's index within its block, are
pinned) every flag and the empty set run 32 ticks through the port's
``reference_chunk`` and the JAX package's, vmapped over the blocks, and
must agree leaf for leaf (tolerance 0: the state is all int32/bool)
(tests/test_torch_ablate_faults.py: the fault configs).  K1's ablated
builds are held to these plain ticks on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import pytest

import chip_smoke
from _torch_jax import check_ablated_against_jax, one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.harness.run import init_plan
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols.paxos import ABLATE_FLAGS

N, BLOCK, BLK0, TICKS, SEED = 128, 64, 3, 32, 10


@pytest.fixture(scope="module")
def full():
    """config2's leaves after the unablated ticks."""
    cfg = C.config2_dueling_drop(N, SEED)
    return check_ablated_against_jax(cfg, (), TICKS, BLOCK, BLK0, init_plan(cfg, "cpu"))


@pytest.mark.parametrize("flag", ABLATE_FLAGS)
def test_ablated_paxos_matches_jax(flag, full):
    cfg = C.config2_dueling_drop(N, SEED)
    got = check_ablated_against_jax(cfg, (flag,), TICKS, BLOCK, BLK0, init_plan(cfg, "cpu"))
    # The component was on the path: removing it moved the state.
    assert not all((a == b).all() for a, b in zip(got, full))
    if flag == "learner":  # the learner's leaves stay as they started
        state = tfused.reference_chunk(
            chip_smoke.path_state(cfg, "cpu"), SEED, init_plan(cfg, "cpu"), cfg.fault, 1,
            apply_fn=tfused.fused_fns("paxos", frozenset({"learner"}))[0],
        )
        assert not bool(state.learner.chosen.any()) and int(state.learner.violations.sum()) == 0


def test_unablated_paxos_matches_jax(full):
    """The empty set is the protocol's own tick."""
    assert len(full) == 29 and int(full[-1]) == TICKS


def test_fused_fns_refuses_what_the_reference_refuses():
    """The JAX package's errors: flags on a protocol it does not ablate,
    an unknown flag, an unknown protocol; the empty set binds the plain
    tick itself, and each variant is one cached pair."""
    with pytest.raises(ValueError, match="ablation flags unsupported for 'fastpaxos'"):
        tfused.fused_fns("fastpaxos", frozenset({"prng"}))
    with pytest.raises(ValueError, match=r"unknown ablate flags: \['codec'\]"):
        tfused.fused_fns("paxos", frozenset({"codec", "prng"}))
    with pytest.raises(ValueError, match="unknown protocol: 'zab'"):
        tfused.fused_fns("zab")
    b = tfused.BINDINGS["paxos"]
    assert tfused.fused_fns("paxos") == (b.apply_fn, b.mask_fn, 1024)
    assert tfused.fused_fns("multipaxos")[2] == 256
    pair = tfused.fused_fns("paxos", frozenset({"prng"}))
    assert pair is tfused.fused_fns("paxos", frozenset({"prng"}))
    assert pair[0].keywords == {"ablate": frozenset({"prng"})}
    assert tfused.ablate_defines(frozenset()) == ()
    assert tfused.ablate_defines(frozenset({"prng", "proposer"})) == ("FUSED_ABLATE=33",)
    assert tfused.ablate_defines(frozenset({"learner"})) == ("FUSED_ABLATE=16",)
