"""K1's, K2's and K3's shared-memory staging and phase clocks (no GPU
needed).

The Paxos, Fast Paxos and Raft-core kernels keep each lane's message
payloads and learner table in a shared-memory column for a whole chunk;
``fused_tick.FR_STAGING`` is their launch geometry per instantiation that
the wrapper passes to them (lanes a CUDA block, staged rows, shared bytes,
the blocks an SM is to hold).  The rows are held against the port's own
``PaxosState``, ``FastPaxosState`` and ``RaftState`` leaf shapes, the
geometry against the card's limits, the table against the instantiations
of ``csrc/fused_paxos_tick.cu``, ``csrc/fused_fastpaxos_tick.cu`` and
``csrc/fused_raftcore_tick.cu`` and the column order of
``sd::load_column`` in ``csrc/fused_common.cuh``, the words left out of
the column against the plain ticks, which must only ever write them as 0,
and the phase lists against the kernels.  K1's fold reads a proposer's
delivered PROMISE slots only, which equals the plain fold over every slot
where ``best_bal`` is not negative: the plain tick keeps it so.  K1
applies a chunk to a settled lane at once: the plain tick leaves such a
lane as it is, but for its acceptors' restores and snapshots under
stale-snapshot recovery or amnesia, which K1's arms instantiation applies
to a settled lane tick by tick.  The instantiations of the three are
keyed by shape, stamps, arms and observed flag, ``(n_prop, n_acc,
k_slots, stamped, arms, observed)``: an arms instantiation keeps its
default's column and caps its registers for 3 blocks, a stamped one
stages both buffers' delay stamps too (at ``(2,5,8)``: K1 and K2 144
words, 3 blocks of 128 lanes; K3 154 words, 11 blocks of 32), and an
observed one adds the planes' counter rows (``tally_obs_rows``; 3 blocks
of 128 without the stamps and the arms, else 2).
"""

import dataclasses
import math
import re

import pytest
import torch

import chip_smoke
from paxos_tpu_torch.core.fp_state import FastPaxosState
from paxos_tpu_torch.core.raft_state import RaftState
from paxos_tpu_torch.core.state import PaxosState
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import build
from paxos_tpu_torch.kernels import fused_tick as tfused
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)

FR = ("paxos", "fastpaxos", "raftcore")
STATES = {"paxos": PaxosState, "fastpaxos": FastPaxosState, "raftcore": RaftState}
SOURCES = {p: (build.CSRC / f"{tfused.BINDINGS[p].kernel}.cu").read_text() for p in FR}
COMMON = (build.CSRC / "fused_common.cuh").read_text()
TABLES = [(p, shape, st) for p in FR for shape, st in tfused.FR_STAGING[p].items()]
IDS = [f"{p}-" + "-".join(map(str, shape)) for p, shape, _ in TABLES]
SM_SHARED_BYTES = 233_472  # an H100 SM's shared memory
BLOCK_RESERVED_BYTES = 1024  # reserved by the runtime for each resident block
SM_THREADS_MAX = 2048
INSTANCES = {"paxos": "K1_INSTANCES", "fastpaxos": "K2_INSTANCES", "raftcore": "K3_INSTANCES"}


def _leaf(state, path):
    obj = state
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def _stamped(protocol, shape):
    """Whether instantiation ``shape`` (P, A, K, stamped, arms, observed)
    stages the delay stamps."""
    return shape[3] == 1


def _obs(protocol, shape):
    """The words observed instantiation ``shape`` adds to the column for
    the observer planes' counters (0 for any other): ``tally_obs_rows``
    (most counters in registers) of K1, K2 and K3 alike."""
    if not shape[5]:
        return 0
    return tfused.tally_obs_rows(shape[0])


def _state(protocol, shape):
    n_prop, n_acc, k_slots = shape[:3]  # then the stamps and the arms flag
    kw = {"delay": True} if _stamped(protocol, shape) else {}
    return STATES[protocol].init(3, n_prop, n_acc, k_slots, **kw)


def _staged(protocol, shape):
    """(leaf, kinds) of FR_STAGED_LEAVES that the instantiation stages: the
    stamps of a stamped state only."""
    return [
        (path, kinds) for path, kinds in tfused.FR_STAGED_LEAVES[protocol]
        if _stamped(protocol, shape) or not path.endswith(".until")
    ]


def _rows(state, path, kinds):
    """Words a lane of a leaf (instance-minor) in the column: the product of
    its other dims, or of the message kinds staged."""
    shape = _leaf(state, path).shape[:-1]
    return math.prod(shape) if kinds is None else len(kinds) * math.prod(shape[1:])


@pytest.mark.parametrize("protocol,shape,staging", TABLES, ids=IDS)
def test_staged_rows_match_the_state_leaves(protocol, shape, staging):
    state = _state(protocol, shape)
    staged = _staged(protocol, shape)
    rows = sum(_rows(state, path, kinds) for path, kinds in staged)
    assert staging.rows - _obs(protocol, shape) == rows == tfused.fr_staged_rows(
        protocol, *shape[:3], _stamped(protocol, shape)
    )
    assert staging.smem_bytes == staging.rows * 4 * staging.threads
    assert staging.smem_bytes <= tfused.SMEM_PER_BLOCK_MAX == 232_448
    assert staging.threads % 32 == 0 and 32 <= staging.threads <= 1024
    # The SM holds the blocks the registers are capped for: 12 warps or
    # more, but 11 for K3's stamped column, of which three blocks of 128
    # lanes overrun the SM's shared memory: 11 blocks of 32 lanes, the most
    # that fit; and 8 for the observed columns, of which one block more
    # overruns it too (without the stamps and the arms: 3 of 128 lanes; the
    # others 2 of 128), but for the unstamped arms keys (124 words, K3's
    # 134), whose registers (more than the 168 that 3 blocks leave) hold
    # them to 2 of 128.
    assert staging.min_blocks * (staging.smem_bytes + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert staging.min_blocks * staging.threads <= SM_THREADS_MAX
    observed = _obs(protocol, shape) > 0
    stamped_k3 = protocol == "raftcore" and _stamped(protocol, shape) and not observed
    assert staging.min_blocks * staging.threads // 32 >= (11 if stamped_k3 else 8 if observed else 12)
    register_bound = shape == (2, 5, 8, 0, 1, 1)
    if observed and not register_bound:
        assert (staging.min_blocks + 1) * (staging.smem_bytes + BLOCK_RESERVED_BYTES) > SM_SHARED_BYTES
    if stamped_k3:
        assert 3 * (staging.rows * 4 * 128 + BLOCK_RESERVED_BYTES) > SM_SHARED_BYTES
        assert (staging.min_blocks + 1) * (staging.smem_bytes + BLOCK_RESERVED_BYTES) > SM_SHARED_BYTES
    for path, _ in staged:
        assert _leaf(state, path).dtype == torch.int32
    assert 2 * shape[0] * shape[1] <= 32  # a buffer's presence fits one bitmask


@pytest.mark.parametrize("protocol", FR)
def test_zero_words_and_staged_kinds_cover_every_payload_once(protocol):
    """Each (payload leaf, kind) is staged or zero-only, never both."""
    covered = []
    for path, kinds in tfused.FR_STAGED_LEAVES[protocol] + tfused.FR_ZERO_WORDS[protocol]:
        if path.split(".")[1] in ("bal", "v1", "v2"):
            covered += [(path, k) for k in kinds]
    want = [(f"{buf}.{f}", k) for buf in ("requests", "replies") for f in ("bal", "v1", "v2") for k in (0, 1)]
    assert sorted(covered) == sorted(want)


def _zero_words(state, protocol):
    """The zero-only words of ``state``, as (leaf path, kind, tensor)."""
    return [
        (path, k, _leaf(state, path)[k])
        for path, kinds in tfused.FR_ZERO_WORDS[protocol] for k in kinds
    ]


@pytest.mark.parametrize("protocol", FR)
def test_zero_words_are_only_ever_written_as_zero(protocol):
    """The words the kernels keep no row for: the plain tick never reads
    them where the result depends on it, and writes them only as 0.  From
    a mid-run state with those words set to noise, 24 ticks of the plain
    version give every other leaf exactly as from the same state with them
    0, and each such word ends as its noise (never written) or 0."""
    cfg = chip_smoke.main_config(protocol, 256, 3)
    plan = chip_smoke.fault_plan(256, cfg.n_acc, cfg.n_prop, 0.2, 3, p_crash=0.2, device="cpu")
    clean = chip_smoke.plain_chunk(cfg, trun.init_state(cfg, "cpu"), plan, 8, 256)
    for _, _, word in _zero_words(clean, protocol):
        word.zero_()
    noisy = clean.clone()
    gen = torch.Generator().manual_seed(3)
    noise = []
    for _, _, word in _zero_words(noisy, protocol):
        word.copy_(torch.randint(1, 1000, word.shape, generator=gen, dtype=torch.int32))
        noise.append(word.clone())
    clean = chip_smoke.plain_chunk(cfg, clean, plan, 24, 256)
    noisy = chip_smoke.plain_chunk(cfg, noisy, plan, 24, 256)
    written = 0
    for (path, k, got), before in zip(_zero_words(noisy, protocol), noise, strict=True):
        assert ((got == before) | (got == 0)).all(), (path, k)
        written += int((got == 0).sum())
        got.zero_()
    assert written > 0  # the ticks did write some of them
    for a, b in zip(noisy.leaves(), clean.leaves(), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("protocol", FR)
def test_every_instantiation_has_a_geometry(protocol):
    assert tuple(tfused.FR_STAGING[protocol]) == tfused.KERNEL_SHAPES[protocol]
    assert tfused.BINDINGS[protocol].staging is tfused.FR_STAGING[protocol]


def _instances(protocol):
    """``K1_INSTANCES`` / ``K2_INSTANCES`` / ``K3_INSTANCES`` of the .cu,
    in order: (P, A, K, STAMPED, ARMS, B, MIN) each."""
    listed = re.search(rf"#define {INSTANCES[protocol]}\(X\)(.*?)\n\n", SOURCES[protocol], re.S).group(1)
    return [tuple(map(int, x.split(", "))) for x in re.findall(r"X\(([\d, ]+)\)", listed)]


@pytest.mark.parametrize("protocol", FR)
def test_source_instantiates_the_table(protocol):
    """The .cu lists exactly the table's geometries, one per shape, stamps
    flag, arms flag and observed flag, and the C entry points take the
    shape, the three flags and the shared bytes (7 ``dims``); an observed
    column adds the planes' counters."""
    want = [shape + (st.threads, st.min_blocks) for shape, st in tfused.FR_STAGING[protocol].items()]
    got = _instances(protocol)
    assert sorted(got) == sorted(want)
    n_key = len(tfused.KERNEL_SHAPES[protocol][0])  # the shape and its three flags
    shapes = [inst[:n_key] for inst in got]
    assert len(shapes) == len(set(shapes)) == len(tfused.KERNEL_SHAPES[protocol])
    src = SOURCES[protocol]
    assert "dims[3] == S_ && dims[4] == R_ && \\\n      dims[5] == O_)" in src
    assert src.count("n_dims != 7") == 2 and src.count("const int smem = dims[6];") == 2
    rv_v1 = "true" if protocol == "raftcore" else "false"
    assert f"using G = SdStaged<P, A, K, {rv_v1}, STAMPED>;" in src
    # the counter rows of an observed column: most counters in registers
    assert (f"(SdStaged<P, A, K, {rv_v1}, STAMPED>::kRows +\n     (has_arg<obs::Obs, Arms...> ? "
            f"obs::TallyRows<P>::kRows : 0)) * B * 4") in src
    assert "sd::Channel<P, A, B, G::kRqUntil, G::kRpUntil> ch;" in src


@pytest.mark.parametrize("protocol", FR)
def test_source_column_order_matches_the_leaves(protocol):
    """``sd::load_column`` stages the leaves in the table's order, each with
    the rows its leaf (its staged kinds) has a lane, from the leaf's first
    staged row, the stamps of a stamped state only; ``SdStaged``'s offsets
    follow the same order."""
    names = {
        "kRqBal": "requests.bal", "kRqV1": "requests.v1", "kRpBal": "replies.bal",
        "kRpV1": "replies.v1", "kRpV2": "replies.v2", "kRqUntil": "requests.until",
        "kRpUntil": "replies.until", "kLtBal": "learner.lt_bal",
        "kLtVal": "learner.lt_val", "kLtMask": "learner.lt_mask",
    }
    body = re.search(r"void load_column\(.*?\n}\n", COMMON[COMMON.index("namespace sd {"):], re.S).group(0)
    calls = re.findall(r"load_rows<([^,]+), ([^,]+), G::(\w+), UNROLL>\(col, L, (\w+), n, i\)", body)
    staged = tfused.FR_STAGED_LEAVES[protocol]
    stamps = [path for path, _ in staged if path.endswith(".until")]
    assert [names[leaf] for *_, leaf in calls if names[leaf] in stamps or "until" not in names[leaf]] == [
        path for path, _ in staged
    ]
    assert [off for _, _, off, _ in calls] == [leaf for *_, leaf in calls]
    kinds = dict(staged)
    for shape in tfused.FR_STAGING[protocol]:
        state = _state(protocol, shape)
        s, e = 2 * shape[0] * shape[1], shape[0] * shape[1]
        v1_from = 0 if protocol == "raftcore" else e
        env = {"0": 0, "G::S": s, "G::E": e, "K": shape[2], "G::kRqV1From": v1_from,
               "G::S - G::kRqV1From": s - v1_from}
        offset = 0
        for rows, first, _, leaf in calls:
            path = names[leaf]
            if (path, kinds.get(path)) not in _staged(protocol, shape):
                continue  # the stamps of a stamped state only
            assert env[rows] == _rows(state, path, kinds[path])
            start = 0 if kinds[path] is None else kinds[path][0] * e
            assert env[first] == start
            offset += env[rows]
        assert offset + _obs(protocol, shape) == tfused.FR_STAGING[protocol][shape].rows


@pytest.mark.parametrize("protocol", FR)
def test_phase_names_match_the_kernel(protocol):
    """``PHASES[protocol]`` names the .cu's ``Phase`` enum, in order, the
    tick marks every phase once, and the reader's slots hold them all."""
    src = SOURCES[protocol]
    body = re.sub(r"//[^\n]*", "", re.search(r"enum Phase \{(.*?)\};", src, re.S).group(1))
    phases = [p.strip() for p in body.replace("\n", " ").split(",") if p.strip()]
    assert phases[-1] == "kPhases"
    assert len(phases[:-1]) == len(tfused.PHASES[protocol])
    for phase in phases[:-1]:
        assert src.count(f"clk.mark({phase});") == 1
    assert "PhaseClock<kPhases> clk;" in src
    assert f"constexpr int kMaxPhases = {tfused.PHASE_SLOTS};" in COMMON
    assert all(len(p) <= tfused.PHASE_SLOTS for p in tfused.PHASES.values())


def test_launch_dims_carry_the_geometry():
    for protocol in FR:
        binding = tfused.BINDINGS[protocol]
        for shape, staging in tfused.FR_STAGING[protocol].items():
            assert tfused._launch_dims(binding, shape) == shape + (staging.smem_bytes,)


def test_measuring_builds_need_the_card_and_the_kernel(monkeypatch, tmp_path):
    """The occupancy query builds and asks the kernel's own library: without
    nvcc it raises, with no estimate to fall back on; the phase clocks
    count on the card only."""

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    for protocol in FR:
        with pytest.raises(RuntimeError, match="nvcc"):
            tfused.blocks_per_sm(protocol, (2, 5, 8))
        cfg = chip_smoke.main_config(protocol, 64, 1)
        state = trun.init_state(cfg, "cpu")
        with pytest.raises(ValueError, match="CUDA state"):
            tfused.phase_clocks(protocol, state, 1, trun.init_plan(cfg, "cpu"), cfg.fault, 8)


@pytest.mark.parametrize("path", ["paxos", "config4"])
def test_plain_paxos_tick_keeps_best_bal_non_negative(path):
    """The argument behind K1's rolled fold: ``proposer.best_bal`` starts at
    0 and takes only a candidate ballot above it, or 0 on expiry, so the
    plain tick never makes it negative.  Tick by tick on config2 (drops,
    holds, idling) and config4 (equivocators, crash windows) with
    duplicates, over many expiries and phase-1 upgrades."""
    from paxos_tpu_torch.harness import config as C

    if path == "paxos":
        cfg = chip_smoke.main_config("paxos", 512, 4)
    else:
        cfg = C.config4_byzantine(512, 4)
    cfg = dataclasses.replace(cfg, fault=dataclasses.replace(cfg.fault, p_dup=0.1, timeout=4))
    plan = chip_smoke.fault_plan(
        512, cfg.n_acc, cfg.n_prop, cfg.fault.p_equiv, 4, p_crash=0.2, device="cpu"
    )
    state = trun.init_state(cfg, "cpu")
    upgraded = 0
    for _ in range(96):
        before = state.proposer.best_bal.clone()
        state = chip_smoke.plain_chunk(cfg, state, plan, 1, 512)
        assert int(state.proposer.best_bal.min()) >= 0
        upgraded += int((state.proposer.best_bal > before).sum())
    assert upgraded > 0  # the fold did adopt previously-accepted ballots


def test_plain_paxos_tick_leaves_a_settled_lane_as_it_is():
    """The argument behind K1's settled lanes (``chip_smoke.settled_lanes``:
    every proposer done, nothing in flight), which it applies a chunk to at
    once and whose column it does not load: on config2 after 96 ticks,
    most lanes are settled, and 16 more ticks of the plain tick leave them
    settled and every leaf of theirs as it was (the learner's scalars
    included: a settled lane of a reachable state has chosen and breaks no
    invariant)."""
    cfg = chip_smoke.main_config("paxos", 512, 6)
    plan = trun.init_plan(cfg, "cpu")
    state = chip_smoke.plain_chunk(cfg, trun.init_state(cfg, "cpu"), plan, 96, 512)
    settled = chip_smoke.settled_lanes(state)
    assert settled.float().mean() > 0.5
    after = chip_smoke.plain_chunk(cfg, state.clone(), plan, 16, 512)
    assert chip_smoke.settled_lanes(after)[settled].all()
    for a, b in zip(after.lane_leaves(), state.lane_leaves(), strict=True):
        assert torch.equal(a[..., settled], b[..., settled])
    assert chip_smoke.settled_lane_bytes(state) == 122  # (2, 5, 8): 16 + 40 + 60 + 5 + 1


def test_k1_arms_geometry_is_pinned():
    """K1's arms instantiation: the default's 104-word column at ``(2,5,8)``
    (the snapshot shadows stay in global memory), 128 lanes, registers
    capped for 3 blocks (12 warps); the default instantiations keep 4
    blocks.  The wrapper picks it exactly when a gray-failure or partition
    knob is on.  The stamped instantiations (p_delay, K1's bounded-delay
    channel) stage the stamps too: 144 words, 72 KiB a block, 3 blocks, with
    and without the arms."""
    table = tfused.FR_STAGING["paxos"]
    assert tuple(table)[:5] == (
        (2, 5, 8, 0, 0, 0), (1, 3, 8, 0, 0, 0), (2, 5, 8, 0, 1, 0), (2, 5, 8, 1, 0, 0),
        (2, 5, 8, 1, 1, 0),
    )
    arms, default = table[(2, 5, 8, 0, 1, 0)], table[(2, 5, 8, 0, 0, 0)]
    assert (arms.threads, arms.rows, arms.smem_bytes, arms.min_blocks) == (128, 104, 53248, 3)
    assert (default.rows, default.min_blocks, table[(1, 3, 8, 0, 0, 0)].min_blocks) == (104, 4, 4)
    for key in ((2, 5, 8, 1, 0, 0), (2, 5, 8, 1, 1, 0)):
        st = table[key]
        assert (st.threads, st.rows, st.smem_bytes, st.min_blocks) == (128, 144, 73728, 3)
    binding = tfused.BINDINGS["paxos"]
    state = PaxosState.init(4, 2, 5, 8)
    assert binding.kernel_shape(state) == (2, 5, 8, 0, 0, 0)
    for name, cfg in chip_smoke.gray_knob_configs(64, 1).items():
        arms_on = int(name != "config_flex(4, 2)")
        assert binding.kernel_shape(state, cfg.fault) == (2, 5, 8, 0, arms_on, 0), name
    stamped = PaxosState.init(4, 2, 5, 8, delay=True)
    for name, cfg in chip_smoke.delay_knob_configs(64, 1).items():
        arms_on = int(name in ("delay across a cut", "every gray knob, p_delay 0.4"))
        assert binding.kernel_shape(stamped, cfg.fault) == (2, 5, 8, 1, arms_on, 0), name
    assert tfused._launch_dims(binding, (2, 5, 8, 0, 1, 0)) == (2, 5, 8, 0, 1, 0, 53248)
    assert tfused._launch_dims(binding, (2, 5, 8, 1, 0, 0)) == (2, 5, 8, 1, 0, 0, 73728)


@pytest.mark.parametrize("protocol", ["fastpaxos", "raftcore"])
def test_k2_k3_stamped_geometry_is_pinned(protocol):
    """K2's and K3's stamped instantiations (their bounded-delay channel)
    stage both buffers' stamps at ``(2,5,8)``: K2 144 words, 72 KiB a block
    of 128 lanes, 3 blocks; K3, which stages every request's v1, 154 words,
    in blocks of 32 lanes (19 KiB), 11 an SM; the arms' keeps its default's
    column.  The wrapper picks them by the state's stamps and the config's
    gray knobs."""
    table = tfused.FR_STAGING[protocol]
    threads, rows, smem, blocks = (
        (128, 144, 73728, 3) if protocol == "fastpaxos" else (32, 154, 19712, 11)
    )
    for key in ((2, 5, 8, 1, 0, 0), (2, 5, 8, 1, 1, 0)):
        st = table[key]
        assert (st.threads, st.rows, st.smem_bytes, st.min_blocks) == (threads, rows, smem, blocks)
    assert table[(2, 5, 8, 0, 1, 0)].rows == table[(2, 5, 8, 0, 0, 0)].rows == rows - 40
    binding = tfused.BINDINGS[protocol]
    stamped = STATES[protocol].init(4, 2, 5, 8, delay=True)
    for name, cfg in chip_smoke.delay_knob_configs(64, 1, protocol).items():
        arms_on = int(name in ("delay across a cut", "every gray knob, p_delay 0.4"))
        assert binding.kernel_shape(stamped, cfg.fault) == (2, 5, 8, 1, arms_on, 0), name
    assert tfused._launch_dims(binding, (2, 5, 8, 1, 0, 0)) == (2, 5, 8, 1, 0, 0, smem)


@pytest.mark.parametrize("name", ["config_stale", "amnesia"])
def test_plain_paxos_tick_changes_a_settled_lane_only_by_recovery(name):
    """The argument behind K1's settled lanes under stale-snapshot recovery
    and amnesia, whose arms instantiation runs a settled lane's remaining
    ticks one at a time with only the restores, the snapshots and the
    learner's invariant count: on the config after 40 ticks most lanes are
    settled, many with an acceptor recovering later in the chunk; 64 more
    ticks of the plain tick leave them settled and change nothing of theirs
    but the acceptors (and their snapshots), some of them; a wiped
    acceptor ends at 0 and a snapshot holds the state; the learner counts
    no invariant break."""
    cfg = chip_smoke.gray_knob_configs(1024, 11)[name]
    plan = chip_smoke.config_plan(cfg, 11, "cpu")
    state = chip_smoke.plain_chunk(cfg, trun.init_state(cfg, "cpu"), plan, 40, 1024)
    settled = chip_smoke.settled_lanes(state)
    recovering = ((plan.crash_end >= 40) & (plan.crash_end < 104)).any(0)
    assert settled.float().mean() > 0.5 and int((settled & recovering).sum()) > 100
    after = chip_smoke.plain_chunk(cfg, state.clone(), plan, 64, 1024)
    assert chip_smoke.settled_lanes(after)[settled].all()
    acc_leaves = len(state.acceptor.leaves())
    for k, (a, b) in enumerate(zip(after.lane_leaves(), state.lane_leaves(), strict=True)):
        if k >= acc_leaves:  # every leaf but the acceptors' is as it was
            assert torch.equal(a[..., settled], b[..., settled]), k
    acc = after.acceptor
    changed = torch.zeros_like(settled)
    for a, b in zip(acc.leaves(), state.acceptor.leaves(), strict=True):
        changed |= ~(a == b).all(0) & settled
    assert changed.any()  # the chunk did restore (wipe) or snapshot settled lanes
    if name == "amnesia":  # only a recovery changes a settled lane
        assert not (changed & ~recovering).any()
    assert int(after.learner.violations[settled].sum()) == int(state.learner.violations[settled].sum())
    if name == "amnesia":  # a recovered acceptor of a settled lane is wiped
        wiped = (plan.crash_end >= 40) & (plan.crash_end < 104) & settled[None]
        assert (acc.promised[wiped] == 0).all() and (acc.acc_val[wiped] == 0).all()
    else:  # the snapshot of tick 96 took the state, and a later restore gives it back
        for snap, cur in ((acc.snap_promised, acc.promised), (acc.snap_bal, acc.acc_bal),
                          (acc.snap_val, acc.acc_val)):
            assert torch.equal(snap[:, settled], cur[:, settled])
