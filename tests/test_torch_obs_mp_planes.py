"""The observer planes of the Multi-Paxos tick against the JAX package:
the margin over the (L, K) tables on crafted tables; the coverage digest's
leaves and their order; and a compacting long log, which carries the
planes through every compaction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import (  # noqa: F401  (one_core, one_torch_thread: autouse)
    _np_leaves,
    jax_plan_of,
    observed_config,
    one_core,
    one_torch_thread,
)
from test_torch_obs_multipaxos import PROTOCOL, _on_config3
from test_torch_obs_paxos import FAST_COMPILE, both_initial_states, jax_config

from paxos_tpu.check.mp_safety import mp_margin_observe as j_mp_margin_observe
from paxos_tpu.core.mp_state import MPLearnerState as JLearner
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu.obs.coverage import digest_tree as j_digest_tree
from paxos_tpu.obs.margin import MarginState as JMargin
from paxos_tpu.protocols.multipaxos import compact_mp_body as j_compact
from paxos_tpu_torch import interop
from paxos_tpu_torch.check.mp_safety import mp_margin_observe
from paxos_tpu_torch.core.mp_state import MPLearnerState
from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.obs.coverage import digest_tree
from paxos_tpu_torch.obs.margin import SENTINEL, MarginState


def _crafted_tables(rng, n_slots, k, n):
    """Learner tables with rival rows, near splits and decide edges: each
    slot's rows hold one of three values at a few ballots, with voter masks
    of every size; the pre-tick chosen slots are a subset of the post-tick
    ones, and some chosen values are a rival's."""
    bal = rng.integers(1, 40, (n_slots, k, n))
    val = rng.integers(1, 4, (n_slots, k, n))
    lt_bv = np.where(rng.random((n_slots, k, n)) < 0.8, (bal << 16) | val, 0).astype(np.int32)
    lt_mask = rng.integers(0, 32, (n_slots, k, n)).astype(np.int32)
    post = rng.random((n_slots, n)) < 0.5
    pre = post & (rng.random((n_slots, n)) < 0.5)
    chosen_val = np.where(post, rng.integers(0, 4, (n_slots, n)), 0).astype(np.int32)
    return lt_bv, lt_mask, pre, post, chosen_val


def test_mp_margin_observe_matches_jax():
    """The (L, K) margin fold on crafted tables (rivals, near splits, decide
    edges, honest and equivocating acceptors, running minima already below
    the tick's) against the JAX package's ``mp_margin_observe``, tolerance 0."""
    rng = np.random.default_rng(16)
    n_slots, k, n, n_acc = 8, 4, 512, 5
    lt_bv, lt_mask, pre, post, chosen_val = _crafted_tables(rng, n_slots, k, n)
    log = np.where(rng.random((n_acc, n_slots, n)) < 0.7, (rng.integers(1, 40, (n_acc, n_slots, n)) << 16) | 3, 0)
    promised = rng.integers(0, 48, (n_acc, n)).astype(np.int32)
    acc_bal = (log >> 16).max(axis=1).astype(np.int32)
    honest = rng.random((n_acc, n)) < 0.8
    margins = [rng.integers(0, 6, n).astype(np.int32) for _ in range(4)]
    margins = [np.where(rng.random(n) < 0.5, m, SENTINEL).astype(np.int32) for m in margins]

    def learner(cls, to, chosen):
        return cls(
            lt_bv=to(lt_bv), lt_mask=to(lt_mask), chosen=to(chosen), chosen_val=to(chosen_val),
            chosen_tick=to(np.full((n_slots, n), -1, np.int32)), violations=to(np.zeros(n, np.int32)),
            evictions=to(np.zeros(n, np.int32)),
        )

    want = j_mp_margin_observe(
        JMargin(*(jnp.asarray(m) for m in margins)), learner(JLearner, jnp.asarray, pre),
        learner(JLearner, jnp.asarray, post), jnp.asarray(promised), jnp.asarray(acc_bal),
        jnp.asarray(honest), 3,
    )
    got = mp_margin_observe(
        MarginState(*(torch.from_numpy(m) for m in margins)),
        learner(MPLearnerState, torch.from_numpy, pre), learner(MPLearnerState, torch.from_numpy, post),
        torch.from_numpy(promised), torch.from_numpy(acc_bal), torch.from_numpy(honest), 3,
    )
    for w, g in zip(_np_leaves(want), got.leaves(), strict=True):
        np.testing.assert_array_equal(w, g.numpy())
    # The crafted tables reach every counter: rivals on decided slots, near
    # splits, ballot races on deciding slots, honest promise slack.
    got_np = [g.numpy() for g in got.leaves()]
    assert (got_np[0] < margins[0]).any() and (got_np[1] > margins[1]).any()
    assert (got_np[2] < margins[2]).any() and (got_np[3] < margins[3]).any()


@pytest.mark.parametrize("delay", [False, True])
def test_coverage_digest_hashes_the_jax_leaves(delay):
    """The coverage digest's leaves (``digest_tree``) of a Multi-Paxos
    state with snapshot shadows, and stamps where ``delay``, are the JAX
    package's in its order, on a state past its first ticks; at (2,5,8,4)
    they are 296 words a lane without the shadows, 336 with the stamps."""
    fault = C.config_delay_chaos if delay else C.config_stale
    tcfg = observed_config(PROTOCOL, _on_config3(fault), n=64)
    state = chip_smoke.path_state(tcfg, "cpu")
    plan = chip_smoke.config_plan(tcfg, 7, "cpu")
    state = tfused.FUSED_CHUNKS[PROTOCOL](state, 7, plan, tcfg.fault, 12)
    jstate = jax.tree.unflatten(
        jax.tree.structure(j_init_state(jax_config(tcfg))),
        [jnp.asarray(x) for x in interop.state_to_numpy(state)],
    )
    want = _np_leaves(j_digest_tree(jstate))
    got = digest_tree(state)
    assert len(want) == len(got)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(w, g.numpy())
    words = sum(x.numel() // tcfg.n_inst for x in got)
    shadows = 0 if delay else 5 + 5 * 8
    assert words - shadows == (336 if delay else 296)


def test_compaction_carries_the_planes_on_a_long_log():
    """config3_long (a 16-slot log through an 8-slot window) at 64 lanes
    with every plane on: three 12-tick chunks, each followed by the
    compaction, through the port's compacting dispatch against the JAX
    package's ``reference_chunk`` and ``compact_mp_body``, leaf for leaf
    after every chunk; the planes pass through each compaction."""
    tcfg = observed_config(
        PROTOCOL, lambda n, s: C.config3_long(n_inst=n, seed=s, log_total=16, window=8), n=64
    )
    jcfg = jax_config(tcfg)
    jstate, state = both_initial_states(tcfg)
    plan = chip_smoke.config_plan(tcfg, 7, "cpu")
    apply_fn, mask_fn, _ = fused_fns(PROTOCOL)
    step = jax.jit(
        lambda st, pl: j_compact(j_reference_chunk(st, 7, pl, jcfg.fault, 12, apply_fn, mask_fn))[0],
        compiler_options=FAST_COMPILE,
    )
    advance = trun.make_advance_grouped(tcfg, plan, compact=True)
    jplan = jax_plan_of(plan)
    for _ in range(3):
        jstate = step(jstate, jplan)
        state = advance(state, 12, 1)
        for i, (w, g) in enumerate(zip(_np_leaves(jstate), interop.state_to_numpy(state), strict=True)):
            np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    assert int(state.base.max()) > 0  # prefixes compacted
    assert int(state.telemetry.seq.sum()) > 0 and int(state.coverage.new_bits.sum()) > 0
    assert int(state.wload.done.sum()) > 0
