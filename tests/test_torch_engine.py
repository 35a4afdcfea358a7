"""The port's fused engine against the JAX package's plain-XLA oracle.

``paxos_tpu.kernels.fused_tick.reference_chunk`` replays the fused stream
without Pallas; the port's ``reference_chunk`` (the plain version of its
CUDA kernel) and chunk function must reproduce it bit for bit (tolerance 0:
the state is all int32/bool), including across stream blocks and at the
ballot limit.  The kernel itself runs only on a CUDA card
(tests/test_torch_cuda.py).
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import MeasurementCorrupted as JMeasurementCorrupted
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.harness.run import summarize as j_summarize
from paxos_tpu.kernels import fused_tick as jfused
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused

GOLDEN_CONFIG2 = "db6db6f40f16eb7b"  # tests/test_gray.py _GOLDEN_CTR["config2"]
LIMIT = (1 << 15) - 1


@functools.lru_cache(maxsize=None)
def jax_ref(fault, clamp_per_tick=False):
    """The JAX reference chunk, jitted once per config (n_ticks and the
    block id are traced).  ``clamp_per_tick`` adds the packed engine's
    per-tick ballot saturation after every tick."""
    from paxos_tpu.kernels.counter_prng import mix
    from paxos_tpu.protocols.paxos import apply_tick, counter_masks

    if not clamp_per_tick:
        return jax.jit(
            lambda st, seed, plan, n, blk: jfused.reference_chunk(
                st, seed, plan, fault, n, blk_id=blk
            )
        )

    def chunk(st, seed, plan, n, blk):
        def body(_, s):
            s = apply_tick(s, counter_masks(fault, mix(seed, s.tick, blk), s), plan, fault)
            return s.replace(proposer=s.proposer.replace(bal=jnp.minimum(s.proposer.bal, LIMIT)))

        return jax.lax.fori_loop(0, n, body, st)

    return jax.jit(chunk)


def _leaves(jstate):
    return [np.asarray(jax.device_get(x)) for x in jax.tree.leaves(jstate)]


def _assert_same(want_leaves, tstate):
    got = interop.state_to_numpy(tstate)
    assert len(got) == len(want_leaves)
    for i, (w, g) in enumerate(zip(want_leaves, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")


def _digest(tstate):
    h = hashlib.sha256()
    for leaf in interop.state_to_numpy(tstate):
        h.update(leaf.tobytes())
    return h.hexdigest()[:16]


def test_reference_chunk_golden_and_64_ticks_match():
    jcfg, tcfg = JC.config2_dueling_drop(256, 7), TC.config2_dueling_drop(256, 7)
    tplan = trun.init_plan(tcfg, "cpu")
    t32 = tfused.reference_chunk(trun.init_state(tcfg, "cpu"), 7, tplan, tcfg.fault, 32)
    assert _digest(t32) == GOLDEN_CONFIG2
    t64 = tfused.reference_chunk(t32, 7, tplan, tcfg.fault, 32)
    want = jax_ref(jcfg.fault)(j_init_state(jcfg), 7, j_init_plan(jcfg), 64, 0)
    _assert_same(_leaves(want), t64)
    assert int(t64.learner.chosen.sum()) > 0


def test_multiblock_stream_matches_per_block_reference():
    """512 lanes in 4 stream blocks of 128 in one vectorised pass equal the
    reference run block by block with blk_id=b on lane slices."""
    n, block, ticks, seed = 512, 128, 48, 5
    jcfg = JC.config2_dueling_drop(block, seed)
    tcfg = TC.config2_dueling_drop(n, seed)
    ref = jax_ref(jcfg.fault)
    js, jp = j_init_state(jcfg), j_init_plan(jcfg)
    per_block = [_leaves(ref(js, seed, jp, ticks, b)) for b in range(n // block)]
    want = [
        np.concatenate(parts, axis=-1) if parts[0].ndim else parts[0]
        for parts in zip(*per_block)
    ]
    tstate = trun.init_state(tcfg, "cpu")
    tplan = trun.init_plan(tcfg, "cpu")
    got = tfused.reference_chunk(tstate, seed, tplan, tcfg.fault, ticks, block=block)
    _assert_same(want, got)
    # The engine's wrapper takes the plain path for CPU tensors: same stream.
    before = tfused.fused_paxos_chunk.launches
    got2 = tfused.fused_paxos_chunk(tstate, seed, tplan, tcfg.fault, ticks, block=block)
    _assert_same(want, got2)
    assert tfused.fused_paxos_chunk.launches == before
    # Blocks differ from one another (distinct streams per block id).
    assert not np.array_equal(per_block[0][3], per_block[1][3])


def _near_limit_leaves(rnd):
    """config2 at 256 lanes with every proposer at ballot round ``rnd``."""
    jcfg = JC.config2_dueling_drop(256, 3)
    st = j_init_state(jcfg)
    pid = jnp.arange(2, dtype=jnp.int32)[:, None]
    bal = jnp.broadcast_to(rnd * 8 + pid + 1, (2, 256)).astype(jnp.int32)
    req = st.requests.replace(bal=st.requests.bal.at[0].set(jnp.broadcast_to(bal[:, None], (2, 5, 256))))
    st = st.replace(proposer=st.proposer.replace(bal=bal), requests=req)
    return jcfg, st


def test_ballot_saturation_raises_in_both_packages():
    jcfg, jst = _near_limit_leaves(4095)  # ballots 32761 / 32762
    tcfg = TC.config2_dueling_drop(256, 3)
    jout = jax_ref(jcfg.fault)(jst, 3, j_init_plan(jcfg), 64, 0)
    assert int(jout.proposer.bal.max()) > LIMIT
    with pytest.raises(JMeasurementCorrupted):
        j_summarize(jout)
    tout = tfused.paxos_chunk(
        interop.state_from_numpy(_leaves(jst)), 3, trun.init_plan(tcfg, "cpu"), tcfg.fault, 64
    )
    # The boundary clamp leaves every tick unchanged and pins proposer.bal.
    want = _leaves(jout)
    want[3] = np.minimum(want[3], LIMIT)
    _assert_same(want, tout)
    with pytest.raises(trun.MeasurementCorrupted):
        trun.summarize(tout)
    # A handed-in state that already overflowed reads as at-limit.
    over = interop.state_from_numpy(_leaves(jout))
    out = tfused.paxos_chunk(over, 3, trun.init_plan(tcfg, "cpu"), tcfg.fault, 1)
    assert int(out.proposer.bal.max()) == LIMIT


def test_per_tick_clamp_matches_and_switch_point():
    jcfg, jst = _near_limit_leaves(4094)
    tcfg = TC.config2_dueling_drop(256, 3)
    jout = jax_ref(jcfg.fault, clamp_per_tick=True)(jst, 3, j_init_plan(jcfg), 40, 0)
    tout = tfused.reference_chunk(
        interop.state_from_numpy(_leaves(jst)), 3, trun.init_plan(tcfg, "cpu"),
        tcfg.fault, 40, clamp_per_tick=True,
    )
    _assert_same(_leaves(jout), tout)
    from paxos_tpu.utils import bitops

    codec = bitops.codec_for("paxos", jst)
    assert tfused.ballot_hoist_safe_ticks() == jfused.ballot_hoist_safe_ticks("paxos", codec) == 6144
    assert tfused.REPORT_BALLOT_LIMIT == jfused.report_ballot_limit("paxos")
    assert tfused.BALLOT_GROWTH_PER_TICK == jfused.BALLOT_GROWTH_PER_TICK


@pytest.mark.parametrize("n", [256, 512, 1000, 4096, 1 << 20, 96, 7])
def test_fit_block_matches_interpret_floor(n):
    for block in (1024, 512, 128, 100, 3, n):
        want = jfused.fit_block(block, n, interpret=True, warn=False)
        assert tfused.fit_block(block, n) == want
