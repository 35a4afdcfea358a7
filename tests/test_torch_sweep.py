"""The config-5 sweep's campaigns through the port's ``run`` against the
JAX package.

``run(cfg, device="cpu")`` must report what the JAX package's
``summarize`` reports for its ``reference_chunk`` state after the same
ticks: counts exactly, the float32 fractions to a relative 1e-6 (the two
packages may sum in another order).  Covers Fast Paxos and Raft-core at
the sweep's faults, the unsafe Fast Flexible Paxos triple
``config_ffp(3, 3, 3)``, and Raft-core with an equivocation plan carried
across from the JAX package.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.harness.run import summarize as j_summarize
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun

N, TICKS = 256, 96
FLOAT_FIELDS = ("chosen_frac", "mean_choose_tick", "decided_frac")


def _raft_equiv(n, seed):
    pair = JC.config5_sweep(n, seed)[2], TC.config5_sweep(n, seed)[2]
    return tuple(dataclasses.replace(c, fault=dataclasses.replace(c.fault, p_equiv=0.5)) for c in pair)


# (JAX config, port config) pairs.
CAMPAIGNS = {
    "fastpaxos": lambda: (JC.config5_sweep(N, 7)[1], TC.config5_sweep(N, 7)[1]),
    "raftcore": lambda: (JC.config5_sweep(N, 7)[2], TC.config5_sweep(N, 7)[2]),
    "ffp333": lambda: (JC.config_ffp(3, 3, 3, N, 1), TC.config_ffp(3, 3, 3, N, 1)),
    "raftcore_equiv": lambda: _raft_equiv(N, 2),
}


@functools.lru_cache(maxsize=None)
def jax_chunk(protocol, fault):
    apply_fn, mask_fn, _ = fused_fns(protocol)
    return jax.jit(lambda st, seed, plan, n: j_reference_chunk(st, seed, plan, fault, n, apply_fn, mask_fn))


def _to_jax(jax_tree, leaves):
    """numpy leaves in the structure of ``jax_tree`` (shapes only)."""
    return jax.tree.unflatten(jax.tree.structure(jax_tree), [jnp.asarray(x.numpy()) for x in leaves])


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_run_report_matches_reference_summarize(name):
    jcfg, tcfg = CAMPAIGNS[name]()
    # Initial states and fault-free plans cross as numpy (their equality
    # with the JAX package's is tested per protocol); a sampled plan comes
    # from the JAX package.
    tstate = trun.init_state(tcfg, "cpu")
    jstate0 = _to_jax(jax.eval_shape(lambda: j_init_state(jcfg)), tstate.leaves())
    if jcfg.fault.p_equiv:
        jplan = j_init_plan(jcfg)
        plan = interop.plan_from_numpy([np.asarray(x) for x in jax.tree.leaves(jplan)])
    else:
        plan = trun.init_plan(tcfg, "cpu")
        jplan = _to_jax(jax.eval_shape(lambda: j_init_plan(jcfg)), plan.leaves())
    got = trun.run(tcfg, total_ticks=TICKS, chunk=32, pipeline_depth=2, plan=plan, device="cpu")
    jstate = jax_chunk(jcfg.protocol, jcfg.fault)(jstate0, jcfg.seed, jplan, TICKS)
    want = j_summarize(jstate)
    want.update(config_fingerprint=jcfg.fingerprint(), engine="fused", pipeline_depth=2)
    assert set(want) == set(got), (sorted(want), sorted(got))
    for key, w in want.items():
        if key in FLOAT_FIELDS:
            assert got[key] == pytest.approx(w, rel=1e-6), key
        else:
            assert got[key] == w, key
    # Bug injection lights up the checker; the sweep's faults alone do not.
    assert (got["violations"] > 0) == (name in ("ffp333", "raftcore_equiv"))
