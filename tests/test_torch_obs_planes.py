"""The port's observer planes (telemetry, exposure, margin, coverage, the
client workload and its SLO report) against the JAX package's, function
by function, on inputs made from a seed with numpy: the tick-time updates
(``record``, both ``observe``s, ``margin_observe``, ``lane_digest``,
``arrival_threshold``) and each ``*_device`` / ``*_host`` pair against the
JAX package's report on the same leaves.  Tolerance 0: every plane is
int32.  The coverage digest is checked on a stamped state with snapshot
shadows, whose leaves it folds.  Also the column rows K1's observed
instantiations keep for the planes' counters (``obs_rows``) against the
kernel source, and the observed instantiations of K1, K2 and K3 against
``FR_STAGING`` and the wrapper's keys."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_jax import one_core, one_torch_thread  # noqa: F401
from paxos_tpu.check import safety as jsafety
from paxos_tpu.core import telemetry as jtel
from paxos_tpu.core.state import LearnerState as JLearner
from paxos_tpu.core.state import PaxosState as JPaxosState
from paxos_tpu.obs import coverage as jcov
from paxos_tpu.obs import exposure as jexp
from paxos_tpu.obs import margin as jmar
from paxos_tpu.obs import slo as jslo
from paxos_tpu.workload import generator as jgen
from paxos_tpu_torch import interop
from paxos_tpu_torch.check.safety import margin_observe
from paxos_tpu_torch.core import telemetry as ttel
from paxos_tpu_torch.core.state import LearnerState, PaxosState
from paxos_tpu_torch.kernels import build
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.obs import coverage as tcov
from paxos_tpu_torch.obs import exposure as texp
from paxos_tpu_torch.obs import margin as tmar
from paxos_tpu_torch.obs import slo as tslo
from paxos_tpu_torch.workload import generator as tgen

I, P, A, K = 64, 2, 5, 8
RNG = np.random.default_rng(1414)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(want, got, what=""):
    want, got = np.asarray(want), got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, what
    np.testing.assert_array_equal(want, got, err_msg=what)


def _host(dev: dict) -> dict:
    """A device dict of the port fetched as the summarize boundary does."""
    return {k: (v.tolist() if v.dim() else int(v)) for k, v in dev.items()}


def _events(tick_rng):
    """One tick's telemetry keywords: bool (A, I) / (P, I) / (P, A, I)
    signals and int counts, with an event kind left out (None)."""
    b = lambda *s: tick_rng.random(s + (I,)) < 0.3  # noqa: E731
    return dict(
        promise=b(A), accept=b(A), decide=b(), conflict=tick_rng.integers(0, 3, I).astype(np.int32),
        leader=b(P), timeout=b(P), drop=tick_rng.integers(0, 4, I).astype(np.int32), dup=None,
        corrupt=b(A), part_cut=b(), part_heal=b(), recover=tick_rng.integers(0, 2, I).astype(np.int32),
    )


_j_record = jax.jit(lambda tel, tick, ev: jtel.record(tel, tick, **ev))


def test_telemetry_record_and_report_match_jax():
    """20 ticks of ``record`` (counters, a 5-deep ring that wraps, 4
    histogram bins past their overflow), then the report halves and the
    host decoders."""
    jcfg, tcfg = jtel.TelemetryConfig(True, 5, 4), ttel.TelemetryConfig(True, 5, 4)
    jstate, tstate = jtel.TelemetryState.init(I, jcfg), ttel.TelemetryState.init(I, tcfg)
    for t in range(20):
        ev = _events(np.random.default_rng([1414, t]))
        tick = 3 * t
        jstate = _j_record(jstate, jnp.int32(tick), {k: v for k, v in ev.items() if v is not None})
        tstate = ttel.record(tstate, torch.tensor(tick, dtype=torch.int32),
                             **{k: None if v is None else _t(v) for k, v in ev.items()})
    for w, g in zip(jax.tree.leaves(jstate), tstate.leaves(), strict=True):
        _eq(w, g, "telemetry leaf")
    assert int(tstate.seq.max()) > 5  # the ring wrapped
    assert ttel.telemetry_host(_host(ttel.telemetry_device(tstate))) == jtel.telemetry_report(jstate)
    assert ttel.decode_lane(tstate, 3) == jtel.decode_lane(jstate, 3)
    assert ttel.counter_totals(tstate) == jtel.counter_totals(jstate)
    assert ttel.hist_totals(tstate, True) == jtel.hist_totals(jstate, True)
    assert ttel.decode_word(0x7FF0123) == jtel.decode_word(0x7FF0123)


def test_fault_lane_events_match_jax():
    from paxos_tpu.faults.injector import FaultConfig as JFault

    from paxos_tpu_torch.faults.injector import FaultConfig as TFault

    plan = {k: RNG.integers(0, 6, s).astype(np.int32) for k, s in (
        ("part_start", (I,)), ("part_end", (I,)), ("crash_end", (A, I)), ("pcrash_end", (P, I)))}
    jplan = type("Plan", (), {k: jnp.asarray(v) for k, v in plan.items()})
    tplan = type("Plan", (), {k: _t(v) for k, v in plan.items()})
    for knobs in (dict(), dict(p_part=0.5), dict(p_crash=0.2, p_crash_prop=0.3)):
        want = jtel.fault_lane_events(jplan, JFault(**knobs), jnp.int32(3))
        got = ttel.fault_lane_events(tplan, TFault(**knobs), torch.tensor(3, dtype=torch.int32))
        assert want.keys() == got.keys()
        for k in want:
            assert (want[k] is None) == (got[k] is None), k
            if want[k] is not None:
                _eq(np.asarray(want[k]).astype(np.int32) if np.asarray(want[k]).dtype == bool
                    else want[k], got[k].to(torch.int32) if got[k].dtype == torch.bool else got[k], k)


_j_exp_record = jax.jit(lambda exp, ev: jexp.record(exp, **ev))


def test_exposure_record_and_report_match_jax():
    """Ten ticks of ``record`` over every class (bool event tensors of any
    leading shape, int counts, a class left out), then the report and
    ``annotate_lit`` on a config that lights some classes."""
    from paxos_tpu.faults.injector import FaultConfig as JFault

    from paxos_tpu_torch.faults.injector import FaultConfig as TFault

    jstate, tstate = jexp.FaultExposure.init(I), texp.FaultExposure.init(I)
    for t in range(10):
        r = np.random.default_rng([7, t])
        ev = {
            "drop": (r.random((P, A, I)) < 0.2, r.integers(0, 3, I).astype(np.int32)),
            "dup": (r.random((2, P, A, I)) < 0.1, r.random((P, A, I)) < 0.05),
            "corrupt": (r.random((A, I)) < 0.3, r.random((A, I)) < 0.1),
            "partition": (r.integers(0, 9, I).astype(np.int32), r.integers(0, 2, I).astype(np.int32)),
            "stale": (r.random((A, I)) < 0.1,) * 2,
            "delay": (r.random((2, 2, P, A, I)) < 0.2, r.integers(0, 5, I).astype(np.int32)),
        }
        jstate = _j_exp_record(jstate, ev)
        tstate = texp.record(tstate, **{k: (_t(a), _t(b)) for k, (a, b) in ev.items()})
    for w, g in zip(jax.tree.leaves(jstate), tstate.leaves(), strict=True):
        _eq(w, g, "exposure leaf")
    got = texp.exposure_host(_host(texp.exposure_device(tstate)))
    assert got == jexp.exposure_report(jstate)
    knobs = dict(p_drop=0.1, p_flaky=0.3, flaky_dup=0.1, p_corrupt=0.01)
    assert texp.annotate_lit(got, TFault(**knobs)) == jexp.annotate_lit(got, JFault(**knobs))
    with pytest.raises(ValueError, match="unknown"):
        texp.record(tstate, flood=(None, None))


def _learner(r, chosen_p=0.5):
    """A learner table with repeated (ballot, value) rows and chosen lanes."""
    bal = r.integers(0, 6, (K, I)).astype(np.int32) * (r.random((K, I)) < 0.8)
    return dict(
        lt_bal=bal.astype(np.int32), lt_val=r.integers(100, 103, (K, I)).astype(np.int32),
        lt_mask=r.integers(0, 32, (K, I)).astype(np.int32), chosen=r.random(I) < chosen_p,
        chosen_val=r.integers(100, 103, I).astype(np.int32),
        chosen_tick=r.integers(-1, 9, I).astype(np.int32),
        violations=np.zeros(I, np.int32), evictions=np.zeros(I, np.int32),
    )


_j_margin = jax.jit(
    lambda m, pre, post, pr, ab, h: jsafety.margin_observe(m, pre, post, pr, ab, h, 3),
)


def test_margin_observe_and_report_match_jax():
    """Eight folds of ``margin_observe`` on random learner tables (decide
    edges, competing rows, near splits, honest and equivocating acceptors,
    promised below the accepted ballot), then the report halves."""
    jm, tm = jmar.MarginState.init(I), tmar.MarginState.init(I)
    for t in range(8):
        r = np.random.default_rng([3, t])
        pre, post = _learner(r, 0.3), _learner(r, 0.6)
        pr, ab = r.integers(0, 9, (A, I)).astype(np.int32), r.integers(0, 9, (A, I)).astype(np.int32)
        honest = r.random((A, I)) < 0.8
        jm = _j_margin(jm, JLearner(**pre), JLearner(**post), pr, ab, honest)
        tm = margin_observe(
            tm, LearnerState(**{k: _t(v) for k, v in pre.items()}),
            LearnerState(**{k: _t(v) for k, v in post.items()}), _t(pr), _t(ab), _t(honest), 3,
        )
    for w, g in zip(jax.tree.leaves(jm), tm.leaves(), strict=True):
        _eq(w, g, "margin leaf")
    assert int(tm.near_split.sum()) > 0 and int((tm.qslack_min < tmar.SENTINEL).sum()) > 0
    assert tmar.margin_host(_host(tmar.margin_device(tm))) == jmar.margin_report(jm)
    fresh = tmar.MarginState.init(I)
    assert tmar.margin_host(_host(tmar.margin_device(fresh))) == jmar.margin_report(
        jmar.MarginState.init(I)
    )


def _wload(mix, r, **kw):
    jcfg, tcfg = jgen.WorkloadConfig(mix=mix, **kw), tgen.WorkloadConfig(mix=mix, **kw)
    jw = jgen.WloadState.init(I, P, jcfg, 5)
    return jw, tgen.WloadState.init(I, P, tcfg, np.asarray(jw.mode), np.asarray(jw.phase))


@pytest.mark.parametrize("mix,kw", [
    ("mixed", {}),
    ("diurnal", dict(rate=0.9, burst_rate=0.1, period=7, burst_len=3)),
    ("bursty", dict(queue_cap=2, hist_bins=4)),
])
def test_workload_observe_and_slo_match_jax(mix, kw):
    """40 ticks of the client queue (serves on random commit edges, the
    arrivals from random raw bits against ``arrival_threshold``, a queue
    that fills and sheds), then the SLO report halves."""
    jw, tw = _wload(mix, RNG, **kw)
    for w, g in zip(jax.tree.leaves(jw), tw.leaves(), strict=True):
        _eq(w, g, "initial workload leaf")
    observe = jax.jit(jgen.observe)
    for t in range(40):
        r = np.random.default_rng([9, t])
        serve = r.random((P, I)) < 0.2
        bits = r.integers(-(1 << 31), 1 << 31, (P, I), dtype=np.int64).astype(np.int32)
        tick = jnp.int32(t + 5)
        _eq(jgen.arrival_threshold(jw, tick), tgen.arrival_threshold(tw, torch.tensor(t + 5)), "thr")
        jw = observe(jw, tick, serve, bits)
        tw = tgen.observe(tw, torch.tensor(t + 5, dtype=torch.int32), _t(serve), _t(bits))
    for w, g in zip(jax.tree.leaves(jw), tw.leaves(), strict=True):
        _eq(w, g, "workload leaf")
    assert int(tw.done.sum()) > 0 and int(tw.shed.sum()) > 0
    assert tslo.slo_host(_host(tslo.slo_device(tw))) == jslo.slo_report(jw)


def test_workload_init_checks_its_plan():
    cfg = tgen.WorkloadConfig(mix="bursty")
    with pytest.raises(ValueError, match="pins"):
        tgen.WloadState.init(4, 2, cfg, np.zeros((2, 4), np.int32), np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="range"):
        tgen.WloadState.init(4, 2, tgen.WorkloadConfig(mix="mixed"), np.full((2, 4), 3, np.int32),
                             np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="burst_len"):
        tgen.WorkloadConfig(mix="mixed", period=4).validate()


def _stamped_state_with_shadows(r):
    """A Paxos state with delay stamps and snapshot shadows, every leaf
    random (the JAX package's flatten order), on both packages."""
    shape = PaxosState.init(I, P, A, K, stale=True, delay=True)
    leaves = []
    for x in shape.leaves()[:-1]:
        if x.dtype == torch.bool:
            leaves.append(r.random(tuple(x.shape)) < 0.5)
        else:
            leaves.append(r.integers(-(1 << 31), 1 << 31, tuple(x.shape), dtype=np.int64).astype(np.int32))
    leaves.append(np.int32(17))
    tstate = interop.state_from_numpy(leaves, protocol="paxos")
    jstruct = jax.tree.structure(JPaxosState.init(I, P, A, K, stale=True, delay=True))
    return jax.tree.unflatten(jstruct, [jnp.asarray(x) for x in leaves]), tstate


def test_coverage_digest_and_observe_match_jax():
    """``lane_digest`` of ``digest_tree`` on a stamped state with shadows
    (random words everywhere, bools as 0 and 1), then ``observe`` over a
    few such states into a 4-word sketch, and the report halves."""
    assert [name for name in tcov._DIGEST_FIELDS] == list(jcov._DIGEST_FIELDS)
    jcfg, tcfg = jcov.CoverageConfig(4), tcov.CoverageConfig(4)
    jc, tc = jcov.CoverageState.init(I, jcfg), tcov.CoverageState.init(I, tcfg)
    observe = jax.jit(jcov.observe)
    for t in range(3):
        jstate, tstate = _stamped_state_with_shadows(np.random.default_rng([11, t]))
        assert len(tcov.digest_tree(tstate)) == len(jax.tree.leaves(jcov.digest_tree(jstate))) == 25
        _eq(jax.jit(lambda s: jcov.lane_digest(jcov.digest_tree(s)))(jstate),
            tcov.lane_digest(tcov.digest_tree(tstate)), "digest")
        jc, tc = observe(jc, jstate), tcov.observe(tc, tstate)
    for w, g in zip(jax.tree.leaves(jc), tc.leaves(), strict=True):
        _eq(w, g, "coverage leaf")
    got = tcov.coverage_host(_host(tcov.coverage_device(tc)), 4)
    assert got == jcov.coverage_report(jc)
    assert tcov.host_sketch_estimate([5, 9, 5], 4) == jcov.host_sketch_estimate([5, 9, 5], 4)
    assert tcov.bloom_bound(128, 2, 10) == jcov.bloom_bound(128, 2, 10)
    with pytest.raises(ValueError, match="power of two"):
        tcov.CoverageConfig(48)


def test_observed_column_rows_match_the_kernel():
    """``obs_rows`` (the words an observed instantiation adds to a lane's
    column) is ``obs::Rows<P>::kRows`` of fused_common.cuh,
    ``tally_obs_rows`` (K1's to K4's, and K5's without the arms)
    ``obs::TallyRows``, and the plane sizes its C entry reads are
    ``_obs_args``'."""
    common = (build.CSRC / "fused_common.cuh").read_text()
    body = re.search(r"struct Rows \{(.*?)\};", common, re.S).group(1)
    assert "kWl = kNewBits + 1, kRows = kWl + 8 * P;" in body
    env = {"kEvents": 12, "kClasses": len(texp.CLASSES)}
    assert env["kEvents"] == len(ttel.EVENTS)
    rows = env["kEvents"] + 2 + 2 * env["kClasses"] + 4 + 1 + 8 * P
    assert tfused.obs_rows(P) == rows == 49
    # K5 keeps the margins and the client queue in the column
    # (obs::TallyRows), the other counters in registers, but with the arms
    # all of them; K1 to K4 keep them in registers at every key, with the
    # arms every counter.
    tally_rows = re.search(r"struct TallyRows \{(.*?)\};", common, re.S).group(1)
    assert "kMar = 0, kWl = 4, kRows = kWl + 8 * P;" in tally_rows
    assert tfused.tally_obs_rows(P) == 4 + 8 * P == 20
    assert tfused.tally_obs_rows(P, True) == tfused.obs_rows(P)
    src = (build.CSRC / "fused_multipaxos_tick.cu").read_text()
    assert "using CR = std::conditional_t<TALLY, obs::TallyRows<P>, obs::Rows<P>>;" in src
    assert "constexpr bool TALLY = !ARMS;" in src
    for kernel in ("fused_paxos_tick", "fused_fastpaxos_tick", "fused_raftcore_tick", "fused_synchpaxos_tick"):
        src = (build.CSRC / f"{kernel}.cu").read_text()
        assert "using CR = obs::TallyRows<P>;" in src
        assert "obs::Tally<STAMPED, ARMS> tally;" in src
    assert f"constexpr int kLeaves = {len(tfused.OBS_LEAVES)};" in common
    assert "constexpr int kParams = 13;" in common
    leaf_enum = re.search(r"enum Leaf \{(.*?)\};", common[common.index("namespace obs"):], re.S).group(1)
    assert len([x for x in leaf_enum.split(",") if x.strip()]) == len(tfused.OBS_LEAVES)
    state = dataclasses.replace(
        PaxosState.init(8, P, A, K),
        telemetry=ttel.TelemetryState.init(8, ttel.TelemetryConfig(True, 16, 8)),
    )
    ptrs, n, params, n_params = tfused._obs_args(state, tfused.FaultConfig(p_crash=0.1))
    assert (n, n_params) == (23, 13)
    assert list(params) == [16, 8, 0] + [0] * 7 + [1, 0, 0]
    assert [p is not None for p in ptrs][:7] == [True] * 5 + [False] * 2


@pytest.mark.parametrize("protocol,rows", [("paxos", 104), ("fastpaxos", 104), ("raftcore", 114)])
def test_observed_geometry_of_k1_k2_k3(protocol, rows):
    """The observed instantiations of K1, K2 and K3 (keys ending in
    ``observed``, at (2,5,8) with and without the stamps and the arms):
    the staged rows plus the counter rows, ``tally_obs_rows`` (K1 and K2
    124 words at 3 blocks of 128, stamped 164 at 2 of 128, with the arms
    124 and 164 at 2 of 128; K3 134 and 174 likewise, but its stamped key
    at 3 blocks of 96); the wrapper keys
    a state with a plane to them, and one at a shape without an observed
    instantiation (three acceptors) is refused before any launch."""
    table = tfused.FR_STAGING[protocol]
    observed = [k for k in tfused.KERNEL_SHAPES[protocol] if k[5]]
    assert observed == [(2, 5, 8, s, r, 1) for s in (0, 1) for r in (0, 1)]
    for key in observed:
        st = table[key]
        want = rows + 40 * key[3] + tfused.tally_obs_rows(2)  # most counters in registers
        threads, blocks = (
            (128, 3) if not key[3] and not key[4]
            else (96, 3) if key[3:5] == (1, 0) and protocol == "raftcore" else (128, 2)
        )
        assert (st.threads, st.rows, st.smem_bytes, st.min_blocks) == (
            threads, want, want * 4 * threads, blocks
        )
        assert tfused._launch_dims(tfused.BINDINGS[protocol], key) == key + (want * 4 * threads,)
    assert [table[k].rows for k in observed] == {
        "paxos": [124, 124, 164, 164], "fastpaxos": [124, 124, 164, 164], "raftcore": [134, 134, 174, 174],
    }[protocol]
    binding = tfused.BINDINGS[protocol]
    assert binding.observed
    cfg = dataclasses.replace(
        chip_smoke.with_planes(chip_smoke.main_config(protocol, 8, 1)), protocol=protocol
    )
    state = chip_smoke.path_state(cfg, "cpu")
    assert binding.kernel_shape(state, cfg.fault) == (2, 5, 8, 0, 0, 1)
    assert binding.kernel_shape(chip_smoke.without_planes(state), cfg.fault) == (2, 5, 8, 0, 0, 0)
    small = dataclasses.replace(cfg, n_acc=3)
    with pytest.raises(ValueError, match="instantiated"):
        tfused._check_cuda_inputs(
            protocol, chip_smoke.path_state(small, "cpu"), chip_smoke.main_plan(small, "cpu"), small.fault
        )


@pytest.mark.parametrize("protocol,head,rows,threads", [
    ("synchpaxos", (2, 5, 8), (124, 124, 164, 164), (128, 128, 96, 128)),
    ("multipaxos", (2, 5, 8, 4), (212, 241, 252, 281), (128, 96, 96, 96)),
])
def test_observed_geometry_of_k4_k5(protocol, head, rows, threads):
    """The observed instantiations of K4 and K5 (keys ending in
    ``observed``, at their (2,5,8) and (2,5,8,4) with and without the
    stamps and the arms): their planes-off column plus the counter rows
    (K4 ``tally_obs_rows``: 124 words at 3 blocks of 128, 164 stamped at 3 of
    96, with the arms 124 and 164 at 2 of 128, as K2's; K5
    ``tally_obs_rows`` on its slot arrays, stamps and PROMISE payloads,
    without the planes-off column's caps and link rows:
    212 words at 2 blocks of 128, 241 with the arms, 252 stamped and 281
    with both at 2 blocks of 96); the wrapper keys a state with
    a plane to them and one without to the planes-off keys.  (K5's observed
    long-log key, the planes alone at (2,5,16,4), is
    tests/test_torch_obs_mp_long.py's.)"""
    binding = tfused.BINDINGS[protocol]
    table = binding.staging
    observed = [k for k in tfused.KERNEL_SHAPES[protocol] if k[-1] and k[:len(head)] == head]
    assert observed == [head + (s, r, 1) for s in (0, 1) for r in (0, 1)]
    assert [table[k].rows for k in observed] == list(rows)
    assert [table[k].threads for k in observed] == list(threads)
    for key in observed:
        st = table[key]
        assert st.smem_bytes == st.rows * 4 * st.threads
        counters = tfused.tally_obs_rows(key[0], protocol == "multipaxos" and key[-2])
        bare = table[key[:-1] + (0,)]
        if protocol == "multipaxos":
            # K5's observed column stages the payloads and reads its links'
            # caps and thresholds from the plan; its planes-off column stages
            # the caps and the arms' link rows (fused_tick.mp_staged_rows).
            _, _, _, _, stamped, arms, _ = key
            assert st.rows == tfused.mp_staged_rows(*key[:5], True) + counters
            assert bare.rows == tfused.mp_staged_rows(
                *key[:5], bare.stage_prom, caps=bool(stamped), links=bool(arms)
            )
        else:
            assert st.rows == bare.rows + counters
        assert tfused._launch_dims(binding, key) == key + (st.smem_bytes,)
    assert binding.observed
    path = "config3" if protocol == "multipaxos" else "synchpaxos"
    cfg = chip_smoke.with_planes(chip_smoke.main_config(path, 8, 1))
    state = chip_smoke.path_state(cfg, "cpu")
    assert binding.kernel_shape(state, cfg.fault) == head + (state.stamped, 0, 1)
    assert binding.kernel_shape(chip_smoke.without_planes(state), cfg.fault) == head + (state.stamped, 0, 0)
    assert len(tfused._obs_args(state, cfg.fault)) == 4


@pytest.mark.parametrize("other", [dict(log_len=16), dict(log_len=4), dict(n_acc=3)])
def test_observed_multipaxos_elsewhere_names_item_22(other):
    """A Multi-Paxos state with a plane at a shape K5 has no observed
    instantiation for (the 4-slot window, three acceptors) is refused by the
    wrapper's instantiation lookup, host code that runs before any launch,
    with an error naming the shape and what is left of ROADMAP item 22;
    the long log's 16-slot window, item 22's own key, passes the lookup
    now; on the CPU the plain tick runs each."""
    cfg = dataclasses.replace(chip_smoke.with_planes(chip_smoke.main_config("config3", 8, 1)), **other)
    state = chip_smoke.path_state(cfg, "cpu")
    plan = chip_smoke.main_plan(cfg, "cpu")
    if cfg.log_len == 16:
        tfused._check_cuda_inputs("multipaxos", state, plan, cfg.fault)
        assert tfused.BINDINGS["multipaxos"].kernel_shape(state, cfg.fault) == (2, 5, 16, 4, 0, 0, 1)
    else:
        with pytest.raises(NotImplementedError, match=r"item 22") as err:
            tfused._check_cuda_inputs("multipaxos", state, plan, cfg.fault)
        assert str((cfg.n_prop, cfg.n_acc, cfg.log_len, cfg.k_slots)) in str(err.value)
    plain = tfused.FUSED_CHUNKS["multipaxos"](state, 1, chip_smoke.main_plan(cfg, "cpu"), cfg.fault, 4)
    assert int(plain.tick) == 4 and plain.planes == state.planes


def test_observed_paxos_at_config1_names_item_23():
    """K1's observed keys are all at (2,5,8): a state with a plane at
    config1's shape (1 proposer, 3 acceptors; the JAX CLI's ``run --config
    config1`` with a plane) is refused by the wrapper's instantiation
    lookup, host code that runs before any launch, with an error naming the
    key and ROADMAP item 23; on the CPU the plain tick runs it."""
    from paxos_tpu_torch.harness import config as TC
    from paxos_tpu_torch.harness.run import init_plan

    cfg = chip_smoke.with_planes(TC.config1_no_faults(8, 1))
    state = chip_smoke.path_state(cfg, "cpu")
    plan = init_plan(cfg, "cpu")
    assert tfused.BINDINGS["paxos"].kernel_shape(state, cfg.fault) == (1, 3, 8, 0, 0, 1)
    with pytest.raises(ValueError, match=r"not \(1, 3, 8, 0, 0, 1\): ROADMAP item 23"):
        tfused._check_cuda_inputs("paxos", state, plan, cfg.fault)
    plain = tfused.FUSED_CHUNKS["paxos"](state, 1, plan, cfg.fault, 4)
    assert int(plain.tick) == 4 and plain.planes == state.planes
