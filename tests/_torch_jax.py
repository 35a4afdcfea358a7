"""Helpers that the port's tests share to carry values into the JAX package."""

import dataclasses
import hashlib
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paxos_tpu.faults.injector import FaultPlan as JFaultPlan
from paxos_tpu.harness import config as JC
from paxos_tpu.harness.run import init_plan as j_init_plan
from paxos_tpu.harness.run import init_state as j_init_state
from paxos_tpu.kernels.fused_tick import fused_fns
from paxos_tpu.kernels.fused_tick import reference_chunk as j_reference_chunk
from paxos_tpu_torch import interop
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import fused_tick as tfused


# XLA's lowest backend optimization level: a case compiles its loop once and
# runs it once, in about half the time and with the same integer results.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_plan_of(tplan):
    """The JAX package's plan holding the leaves of the port's ``tplan``
    (no sampling)."""
    return JFaultPlan(**{
        f.name: None if getattr(tplan, f.name) is None else jnp.asarray(getattr(tplan, f.name).numpy())
        for f in dataclasses.fields(tplan)
    })


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def jax_config(tcfg):
    """The JAX package's SimConfig with ``tcfg``'s fields."""
    return dataclasses.replace(
        JC.config2_dueling_drop(tcfg.n_inst, tcfg.seed),
        protocol=tcfg.protocol, n_prop=tcfg.n_prop, n_acc=tcfg.n_acc, k_slots=tcfg.k_slots,
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )


def check_against_jax(tcfg, ticks, jax_plan: bool):
    """``tcfg``'s plain tick (the port's ``reference_chunk``) against the
    JAX package's ``reference_chunk`` with ``fused_fns``, leaf for leaf,
    over ``ticks`` ticks from the same initial state, on the plan the JAX
    package samples (``jax_plan``) or on chip_smoke's numpy plan; returns
    the final state's leaves."""
    jcfg = jax_config(tcfg)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    state = trun.init_state(tcfg, "cpu")
    assert state.snapshots == (tcfg.fault.stale_k > 0)
    assert state.stamped == (tcfg.fault.p_delay > 0)
    jstate = j_init_state(jcfg)
    init = _np_leaves(jstate)
    for w, g in zip(init, interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(w, g)
    if jax_plan:
        with jax.threefry_partitionable(False):
            jplan = j_init_plan(jcfg)
        plan = interop.plan_from_numpy(_np_leaves(jplan), cfg=tcfg.fault)
    else:
        plan = chip_smoke.config_plan(tcfg, tcfg.seed, "cpu")
        jplan = jax_plan_of(plan)
    apply_fn, mask_fn, _ = fused_fns(tcfg.protocol)
    want = jax.jit(
        lambda st, pl: j_reference_chunk(st, tcfg.seed, pl, jcfg.fault, ticks, apply_fn, mask_fn)
    )(jstate, jplan)
    got = tfused.reference_chunk(
        state, tcfg.seed, plan, tcfg.fault, ticks, apply_fn=tfused.BINDINGS[tcfg.protocol].apply_fn
    )
    want, got = _np_leaves(want), interop.state_to_numpy(got)
    assert len(want) == len(got) == len(init)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The case reaches its arm: the run moved the state.
    assert not all((a == b).all() for a, b in zip(got, init))
    return got


def mp_jax_config(tcfg):
    """The JAX package's SimConfig with ``tcfg``'s fields."""
    return dataclasses.replace(
        JC.config3_multipaxos(tcfg.n_inst, tcfg.seed),
        n_prop=tcfg.n_prop, n_acc=tcfg.n_acc, log_len=tcfg.log_len, k_slots=tcfg.k_slots,
        fault=JC.FaultConfig(**dataclasses.asdict(tcfg.fault)),
    )


def check_mp_against_jax(tcfg, ticks, jax_plan: bool, block=None):
    """The plain Multi-Paxos tick against the JAX package over ``ticks`` ticks in
    stream blocks of ``block`` lanes (default: one block), on the plan the
    JAX package samples (``jax_plan``) or on chip_smoke's numpy plan;
    returns the port's final state."""
    jcfg = mp_jax_config(tcfg)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    state = trun.init_state(tcfg, "cpu")
    assert state.snapshots == (tcfg.fault.stale_k > 0)
    assert state.stamped == (tcfg.fault.p_delay > 0)
    jstate = j_init_state(jcfg)
    init = _np_leaves(jstate)
    for w, g in zip(init, interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(w, g)
    if jax_plan:
        with jax.threefry_partitionable(False):
            jplan = j_init_plan(jcfg)
        plan = interop.plan_from_numpy(_np_leaves(jplan), cfg=tcfg.fault)
    else:
        plan = chip_smoke.config_plan(tcfg, tcfg.seed, "cpu")
        jplan = jax_plan_of(plan)
    apply_fn, mask_fn, _ = fused_fns("multipaxos")
    jblock = block or tcfg.n_inst
    want = jax.jit(jax.vmap(
        lambda st, pl, blk: j_reference_chunk(
            st, tcfg.seed, pl, jcfg.fault, ticks, apply_fn, mask_fn, blk_id=blk
        ),
        in_axes=(0, 0, 0), out_axes=0,
    ))(*split_blocks(jstate, jplan, tcfg.n_inst, jblock))
    binding = tfused.BINDINGS["multipaxos"]
    got = tfused.reference_chunk(
        state, tcfg.seed, plan, tcfg.fault, ticks, block=block,
        apply_fn=binding.apply_fn, mask_fn=binding.mask_fn,
    )
    want, got_leaves = merge_blocks(want), interop.state_to_numpy(got)
    assert len(want) == len(got_leaves) == len(init)
    for i, (w, g) in enumerate(zip(want, got_leaves)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    # The case reaches its arm: the run moved the state.
    assert not all((a == b).all() for a, b in zip(got_leaves, init))
    return got


def split_blocks(jstate, jplan, n_inst, block):
    """The state and plan cut into stream blocks of ``block`` lanes (a
    leading block axis; the tick scalar repeated), with the block ids."""
    blocks = n_inst // block

    def cut(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return np.stack([x] * blocks)
        return np.stack([x[..., b * block:(b + 1) * block] for b in range(blocks)])

    return (
        jax.tree.map(cut, jstate), jax.tree.map(cut, jplan), np.arange(blocks, dtype=np.int32)
    )


def merge_blocks(tree):
    """Leaves of a block-split state, joined back along the lane axis."""
    out = []
    for x in jax.tree.leaves(tree):
        x = np.asarray(x)
        out.append(x[0] if x.ndim == 1 else np.concatenate(list(x), axis=-1))
    return out


def jax_path_blocks(path, jcfg, blocks, block, limit):
    """Stream blocks ``blocks`` (of ``block`` lanes) of main path ``path``
    at full width, seed 0, by the JAX package: its own ``reference_chunk``
    over the path's ticks straight, one vmapped run over the blocks, each at
    its block id on its slice of chip_smoke's numpy plan; the main path's
    chunk clamps are the identity while ballots stay below the report
    ``limit``, which this asserts, with no violation.  Returns {block:
    (evicting lanes inside it, state digest)}."""
    tcfg = chip_smoke.main_config(path)
    assert dataclasses.asdict(jcfg.fault) == dataclasses.asdict(tcfg.fault)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    full = [x.numpy() for x in chip_smoke.config_plan(tcfg, 0, "cpu").leaves()]
    small = dataclasses.replace(jcfg, n_inst=block)
    with jax.threefry_partitionable(False):
        tree = jax.tree.structure(j_init_plan(small))
    plans = jax.tree.unflatten(
        tree, [np.stack([x[..., b * block:(b + 1) * block] for b in blocks]) for x in full]
    )
    apply_fn, mask_fn, _ = fused_fns(tcfg.protocol)
    ticks = chip_smoke.MAIN_PATHS[path].ticks
    out = jax.jit(jax.vmap(
        lambda st, plan, blk: j_reference_chunk(
            st, 0, plan, jcfg.fault, ticks, apply_fn, mask_fn, blk_id=blk
        ),
        in_axes=(None, 0, 0),
    ))(j_init_state(small), plans, np.array(blocks, np.int32))
    leaves = [np.asarray(x) for x in jax.tree.leaves(out)]
    assert int(np.asarray(out.proposer.bal).max()) < limit  # the chunk clamps were the identity
    assert int(np.asarray(out.learner.violations).sum()) == 0
    got = {}
    for b, blk in enumerate(blocks):
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf[b]).tobytes())
        got[blk] = (np.nonzero(np.asarray(out.learner.evictions)[b])[0].tolist(), h.hexdigest()[:16])
    return got



def observed_config(protocol, make, n=256, seed=7):
    """The SimConfig ``make(n, seed)`` on ``protocol`` with every observer
    plane on at chip_smoke's settings (``obs_planes``)."""
    return chip_smoke.with_planes(dataclasses.replace(make(n, seed), protocol=protocol))


def check_observed_golden(protocol, make, golden, ticks=32):
    """``protocol``'s plain tick with every observer plane on (config
    ``make`` at 256 lanes, seed 7) over ``ticks`` ticks on the fault-free
    plan: the state but the planes must have the digest ``golden``, as the
    planes-off state has."""
    tcfg = observed_config(protocol, make)
    plan = trun.init_plan(tcfg, "cpu")
    got = tfused.FUSED_CHUNKS[protocol](chip_smoke.path_state(tcfg, "cpu"), tcfg.seed, plan,
                                        tcfg.fault, ticks)
    assert got.planes == ("telemetry", "coverage", "exposure", "margin", "wload")
    assert chip_smoke.digest(chip_smoke.without_planes(got).leaves()) == golden
    bare = trun.init_state(make(tcfg.n_inst, tcfg.seed), "cpu")
    bare = tfused.FUSED_CHUNKS[protocol](bare, tcfg.seed, plan, tcfg.fault, ticks)
    assert chip_smoke.digest(bare.leaves()) == chip_smoke.GOLDENS[protocol] == golden


def check_observed_against_jax(protocol, make, lit, ticks=32):
    """``protocol``'s plain tick with every observer plane on (config
    ``make`` at 256 lanes, seed 7) against the JAX package's
    ``reference_chunk`` with ``fused_fns(protocol)`` over ``ticks`` ticks
    from the same initial state (the JAX package's workload plan carried
    across), on chip_smoke's numpy plan: the whole state leaf for leaf, the
    exposure classes ``lit`` lit (injected and effective), and every plane
    moved."""
    from test_torch_obs_paxos import both_initial_states, jax_config

    from paxos_tpu_torch.obs.exposure import CLASSES

    tcfg = observed_config(protocol, make)
    binding = tfused.BINDINGS[protocol]
    jcfg = jax_config(tcfg)
    jstate, state = both_initial_states(tcfg)
    plan = chip_smoke.config_plan(tcfg, tcfg.seed, "cpu")
    apply_fn, mask_fn, _ = fused_fns(protocol)
    want = jax.jit(
        lambda st, pl: j_reference_chunk(st, tcfg.seed, pl, jcfg.fault, ticks, apply_fn, mask_fn),
        compiler_options=FAST_COMPILE,
    )(jstate, jax_plan_of(plan))
    got = tfused.reference_chunk(
        state, tcfg.seed, plan, tcfg.fault, ticks, apply_fn=binding.apply_fn,
        mask_fn=binding.mask_fn,
    )
    want = _np_leaves(want)
    got_leaves = interop.state_to_numpy(got)
    f = tcfg.fault
    if protocol == "multipaxos":  # 30 protocol leaves, 2 shadows, 3 stamps
        n_leaves = 53 + 2 * (f.stale_k > 0) + 3 * (f.p_delay > 0)
    else:
        n_leaves = 52 + 3 * (f.stale_k > 0) + 2 * (f.p_delay > 0)
    assert len(want) == len(got_leaves) == n_leaves
    for i, (w, g) in enumerate(zip(want, got_leaves, strict=True)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    inj, eff = got.exposure.injected.sum(1).tolist(), got.exposure.effective.sum(1).tolist()
    seen = {c for c, i, e in zip(CLASSES, inj, eff) if i and e}
    assert lit <= seen, seen
    assert int(got.telemetry.seq.sum()) > 0 and int(got.coverage.new_bits.sum()) > 0
    assert int(got.wload.offered.sum()) > 0 and int((got.margin.promise_slack_min < 1 << 30).sum()) > 0
    return got


def check_observed_replay(protocol, make, ticks=48):
    """``protocol``'s plain tick with the margin and workload planes on,
    tick by tick on config ``make`` at 256 lanes, seed 5 (one whose checker
    fires, so a quorum slack of 0 occurs): its margin leaves equal the JAX
    package's ``np_margin_tick`` folded over its own learner and acceptor
    (voter) trajectory, at the quorum its learner applies (Fast Paxos: the
    fast quorum on a round-0 slot), and its queue leaves ``np_replay_queue``
    over its own arrivals and commit edges."""
    from paxos_tpu.obs import margin as jmar
    from paxos_tpu.workload import generator as jgen
    from paxos_tpu_torch.kernels.quorum import fast_quorum, majority
    from paxos_tpu_torch.obs.margin import MarginConfig
    from paxos_tpu_torch.workload.generator import WorkloadConfig

    wl_cfg = WorkloadConfig(mix="mixed", queue_cap=4, rate=0.2, burst_rate=0.5)
    base = make(256, 5)
    tcfg = dataclasses.replace(base, protocol=protocol, margin=MarginConfig(True), workload=wl_cfg)
    plan = chip_smoke.config_plan(tcfg, 5, "cpu")
    state = chip_smoke.path_state(tcfg, "cpu")
    apply_fn = tfused.BINDINGS[protocol].apply_fn
    honest = ~plan.equivocate.numpy()
    counters = jmar.np_margin_init(tcfg.n_inst)
    mode = state.wload.mode.numpy()
    quorum = (tcfg.fault.q2 or majority(tcfg.n_acc)) if protocol == "fastpaxos" else majority(tcfg.n_acc)
    fast = dict(fast_quorum=tcfg.fault.q_fast or fast_quorum(tcfg.n_acc)) if protocol == "fastpaxos" else {}
    fence = ("voted", "ent_term") if protocol == "raftcore" else ("promised", "acc_bal")
    arrivals, serves = [], []

    def learner(st):
        return {f.name: getattr(st.learner, f.name).numpy().copy()
                for f in dataclasses.fields(st.learner)}

    for _ in range(ticks):
        nxt = tfused.reference_chunk(state, tcfg.seed, plan, tcfg.fault, 1, apply_fn=apply_fn)
        post = learner(nxt)
        if fast:
            fast["fast_round"] = ((post["lt_bal"] - 1) >> 3) == 0
        counters = jmar.np_margin_tick(
            counters, learner(state), post, getattr(nxt.acceptor, fence[0]).numpy(),
            getattr(nxt.acceptor, fence[1]).numpy(), honest, quorum, **fast,
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

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the plain PyTorch versions of a test module
    (autouse where a module imports it).  Their tensors are small: one
    thread runs them as fast as eight, and the idle threads of a wider pool
    would spin on the cores the suite's other workers need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pin_threads(cores: set) -> None:
    """Set the CPU affinity of every thread of this process (Linux: the
    tasks under /proc/self/task) to ``cores``."""
    for task in Path("/proc/self/task").iterdir():
        try:
            os.sched_setaffinity(int(task.name), cores)
        except OSError:  # a thread that ended meanwhile, or one the system will not move
            pass


@pytest.fixture(autouse=True, scope="module")
def one_core():
    """Hold a test module that compiles and runs many JAX cases to one core
    (autouse where a module imports it; each pytest-xdist worker its own
    core, by its number), restored after.
    XLA spreads a compile or a vmapped run over every core of the machine,
    and the suite's other workers need them: under that load the JAX
    package's tests/test_fused.py::test_fused_segmented_multipaxos_longlog_compact
    can deadlock (ROADMAP C4).  New threads inherit the pin from the thread
    that starts them.  Without per-thread affinity (not Linux) it does
    nothing."""
    if not hasattr(os, "sched_setaffinity") or not Path("/proc/self/task").is_dir():
        yield
        return
    allowed = os.sched_getaffinity(0)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0").removeprefix("gw")
    cores = sorted(allowed)
    _pin_threads({cores[int(worker) % len(cores) if worker.isdigit() else 0]})
    try:
        yield
    finally:
        _pin_threads(allowed)


def check_ablated_against_jax(tcfg, ablate, ticks, block, blk0, plan):
    """``tcfg``'s plain tick with the components ``ablate`` names removed
    (the port's ``fused_fns``) against the JAX package's ablated tick
    (its ``fused_fns``), leaf for leaf (tolerance 0), over ``ticks`` ticks
    from the same initial state on ``plan`` (a port plan, carried across
    leaf for leaf), in stream blocks of ``block`` lanes from block id
    ``blk0`` on; returns the final state's leaves."""
    ablate = frozenset(ablate)
    jcfg = mp_jax_config(tcfg) if tcfg.protocol == "multipaxos" else jax_config(tcfg)
    assert jcfg.fingerprint() == tcfg.fingerprint()
    state = trun.init_state(tcfg, "cpu")
    jstate = j_init_state(jcfg)
    init = _np_leaves(jstate)
    for w, g in zip(init, interop.state_to_numpy(state), strict=True):
        np.testing.assert_array_equal(w, g)
    apply_fn, mask_fn, _ = fused_fns(tcfg.protocol, ablate)
    jstates, jplans, blks = split_blocks(jstate, jax_plan_of(plan), tcfg.n_inst, block)
    want = jax.jit(jax.vmap(
        lambda st, pl, blk: j_reference_chunk(
            st, tcfg.seed, pl, jcfg.fault, ticks, apply_fn, mask_fn, blk_id=blk
        ),
    ), compiler_options=FAST_COMPILE)(jstates, jplans, blks + blk0)
    t_apply, t_mask, _ = tfused.fused_fns(tcfg.protocol, ablate)
    got = tfused.reference_chunk(
        state, tcfg.seed, plan, tcfg.fault, ticks, blk_id=blk0, block=block,
        apply_fn=t_apply, mask_fn=t_mask,
    )
    want, got = merge_blocks(want), interop.state_to_numpy(got)
    assert len(want) == len(got) == len(init)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=f"leaf {i}")
    return got
