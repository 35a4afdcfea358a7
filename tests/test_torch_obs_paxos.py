"""The plain Paxos tick with every observer plane on against the JAX
package, bit for bit, and the planes' schedule identity.

Each case runs the fused stream through the port's ``reference_chunk``
and the JAX package's ``reference_chunk`` with ``fused_fns("paxos")``, at
256 lanes over 32 ticks from the same initial state (the JAX package's
workload plan carried across), on chip_smoke's numpy plan, with
telemetry (counters, a 16-word ring, 8 histogram bins), a 64-word
coverage sketch, the exposure and margin counters and the "mixed" client
workload, as the ``observed-paxos`` main path sets them; the whole state
must agree leaf for leaf (tolerance 0).  The cases, config2,
config_gray_chaos, config_corrupt, config_stale and config_delay_chaos on
Paxos, light every exposure class between them.  With the planes on, the
state but the planes equals the golden (tests/test_gray.py
``_GOLDEN_CTR["config2"]``); and the port's margin and client-queue
leaves equal the JAX package's numpy replay oracles (``np_margin_tick``,
``np_replay_queue``) over the port's own trajectory."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import FAST_COMPILE, jax_plan_of, one_core, one_torch_thread  # noqa: F401
from paxos_tpu.core.telemetry import TelemetryConfig as JTel
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu.obs import margin as jmar
from paxos_tpu.obs.coverage import CoverageConfig as JCov
from paxos_tpu.obs.exposure import ExposureConfig as JExp
from paxos_tpu.obs.margin import MarginConfig as JMar
from paxos_tpu.workload import generator as jgen
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.obs.exposure import CLASSES

N, TICKS = 256, 32
CASES = {
    "config2": lambda n, s: C.config2_dueling_drop(n, s),
    "config_gray_chaos": lambda n, s: C.config_gray_chaos(n, s),
    "config_corrupt": lambda n, s: C.config_corrupt(n, s),
    "config_stale": lambda n, s: C.config_stale(n, s),
    "config_delay_chaos": lambda n, s: C.config_delay_chaos(n, s),
}


def jax_config(tcfg):
    """The JAX package's SimConfig with ``tcfg``'s fields, planes included."""
    jcfg = dataclasses.replace(
        JC.config2_dueling_drop(tcfg.n_inst, tcfg.seed),
        protocol=tcfg.protocol, n_prop=tcfg.n_prop, n_acc=tcfg.n_acc, k_slots=tcfg.k_slots,
        log_len=tcfg.log_len, fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
        telemetry=JTel(**dataclasses.asdict(tcfg.telemetry)),
        coverage=JCov(**dataclasses.asdict(tcfg.coverage)),
        exposure=JExp(**dataclasses.asdict(tcfg.exposure)),
        margin=JMar(**dataclasses.asdict(tcfg.margin)),
        workload=jgen.WorkloadConfig(**dataclasses.asdict(tcfg.workload)),
    )
    assert jcfg.fingerprint() == tcfg.fingerprint()
    return jcfg


def observed(name, n=N, seed=7):
    return chip_smoke.with_planes(dataclasses.replace(CASES[name](n, seed), protocol="paxos"))


def both_initial_states(tcfg):
    """The JAX package's initial state (its workload plan sampled with
    jax.random) and the port's on that plan; they agree leaf for leaf."""
    jstate = j_init_state(jax_config(tcfg))
    wl = jstate.wload
    state = trun.init_state(tcfg, "cpu", wload_plan=(np.asarray(wl.mode), np.asarray(wl.phase)))
    for w, g in zip(jax.tree.leaves(jstate), interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(np.asarray(w), g)
    return jstate, state


@pytest.mark.parametrize("name", CASES)
def test_observed_paxos_tick_matches_jax(name):
    tcfg = observed(name)
    jcfg = jax_config(tcfg)
    jstate, state = both_initial_states(tcfg)
    plan = chip_smoke.config_plan(tcfg, tcfg.seed, "cpu")
    apply_fn, mask_fn, _ = fused_fns("paxos")
    want = jax.jit(
        lambda st, pl: j_reference_chunk(st, tcfg.seed, pl, jcfg.fault, TICKS, apply_fn, mask_fn),
        compiler_options=FAST_COMPILE,
    )(jstate, jax_plan_of(plan))
    got = tfused.reference_chunk(state, tcfg.seed, plan, tcfg.fault, TICKS)
    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    got_leaves = interop.state_to_numpy(got)
    assert len(want) == len(got_leaves) == 52 + 3 * (tcfg.fault.stale_k > 0) + 2 * (tcfg.fault.p_delay > 0)
    for i, (w, g) in enumerate(zip(want, got_leaves, strict=True)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The case lights the exposure classes of its knobs, and every plane moved.
    inj, eff = got.exposure.injected.sum(1).tolist(), got.exposure.effective.sum(1).tolist()
    lit = {c for c, i, e in zip(CLASSES, inj, eff) if i and e}
    want_lit = {
        "config2": {"drop"},
        "config_gray_chaos": {"drop", "dup", "partition", "timeout"},
        "config_corrupt": {"corrupt"},
        "config_stale": {"stale"},
        "config_delay_chaos": {"drop", "delay"},
    }[name]
    assert want_lit <= lit, lit
    assert int(got.telemetry.seq.sum()) > 0 and int(got.coverage.new_bits.sum()) > 0
    assert int(got.wload.offered.sum()) > 0 and int((got.margin.promise_slack_min < 1 << 30).sum()) > 0


def test_planes_leave_the_golden_schedule():
    """config2 at 256 lanes, seed 7, 32 ticks with every plane on: the
    state but the planes has the golden digest, and so has the state with
    the planes off."""
    tcfg = observed("config2")
    state = chip_smoke.path_state(tcfg, "cpu")
    plan = trun.init_plan(tcfg, "cpu")
    state = tfused.paxos_chunk(state, tcfg.seed, plan, tcfg.fault, TICKS)
    assert state.planes == ("telemetry", "coverage", "exposure", "margin", "wload")
    assert chip_smoke.digest(chip_smoke.without_planes(state).leaves()) == "db6db6f40f16eb7b"
    bare = trun.init_state(C.config2_dueling_drop(N, 7), "cpu")
    bare = tfused.paxos_chunk(bare, 7, plan, tcfg.fault, TICKS)
    assert chip_smoke.digest(bare.leaves()) == chip_smoke.GOLDENS["paxos"] == "db6db6f40f16eb7b"


def test_margin_and_queue_match_the_numpy_replay():
    """The port's plain tick with the margin and workload planes on, tick
    by tick on config_corrupt (violations fire, so slack 0 occurs): its
    margin leaves equal ``np_margin_tick`` folded over its own learner and
    acceptor trajectory, and its queue leaves ``np_replay_queue`` over its
    own arrivals and commit edges."""
    from paxos_tpu_torch.obs.margin import MarginConfig
    from paxos_tpu_torch.workload.generator import WorkloadConfig

    wl_cfg = WorkloadConfig(mix="mixed", queue_cap=4, rate=0.2, burst_rate=0.5)
    tcfg = dataclasses.replace(
        C.config_corrupt(N, 5), protocol="paxos", margin=MarginConfig(True), workload=wl_cfg
    )
    plan = chip_smoke.config_plan(tcfg, 5, "cpu")
    state = chip_smoke.path_state(tcfg, "cpu")
    honest = ~plan.equivocate.numpy()
    counters = jmar.np_margin_init(N)
    mode = state.wload.mode.numpy()
    arrivals, serves = [], []

    def learner(st):
        return {f.name: getattr(st.learner, f.name).numpy().copy()
                for f in dataclasses.fields(st.learner)}

    for _ in range(48):
        nxt = tfused.reference_chunk(state, tcfg.seed, plan, tcfg.fault, 1)
        counters = jmar.np_margin_tick(
            counters, learner(state), learner(nxt), nxt.acceptor.promised.numpy(),
            nxt.acceptor.acc_bal.numpy(), honest, 3,
        )
        arrivals.append((nxt.wload.offered - state.wload.offered).numpy().astype(bool))
        serves.append((nxt.wload.done - state.wload.done).numpy().astype(bool))
        state = nxt
    for name, want in counters.items():
        np.testing.assert_array_equal(want, getattr(state.margin, name).numpy(), err_msg=name)
    assert int(state.learner.violations.sum()) > 0 and int((state.margin.qslack_min == 0).sum()) > 0
    replay = jgen.np_replay_queue(
        jgen.WorkloadConfig(**dataclasses.asdict(wl_cfg)), mode, np.stack(arrivals), np.stack(serves)
    )
    for name in ("head", "depth", "depth_peak", "offered", "done", "shed", "hist"):
        np.testing.assert_array_equal(replay[name], getattr(state.wload, name).numpy(), err_msg=name)
    assert replay["done"].sum() > 0 and replay["shed"].sum() > 0
    assert torch.equal(state.wload.mode, torch.from_numpy(mode))
