"""K4's shared-memory staging and phase clocks (no GPU needed).

The SynchPaxos kernel keeps each lane's message payloads, delay stamps and
learner table in a shared-memory column for a whole chunk;
``fused_tick.SP_STAGING`` is the launch geometry per instantiation that
the wrapper passes to it (lanes a CUDA block, staged rows, shared bytes,
the blocks an SM is to hold).  The rows are held against the port's own
``SynchPaxosState`` leaf shapes, the geometry against the card's limits,
and the table against the instantiations and the phase list of
``csrc/fused_synchpaxos_tick.cu`` and the column order of
``sd::load_column`` in ``csrc/fused_common.cuh``, which K1's stamped
instantiations share.  The instantiations are keyed by shape, stamps,
arms and observer flag, ``(n_prop, n_acc, k_slots, stamped, arms,
observed)``; an arms instantiation keeps its default's column, an observed
one adds the planes' counters (``tally_obs_rows``) after it.
"""

import dataclasses
import math
import re

import pytest
import torch

from paxos_tpu_torch.core.sp_state import SynchPaxosState
from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import build
from paxos_tpu_torch.kernels import fused_tick as tfused

SOURCE = (build.CSRC / "fused_synchpaxos_tick.cu").read_text()
COMMON = (build.CSRC / "fused_common.cuh").read_text()
TABLES = list(tfused.SP_STAGING.items())
IDS = ["-".join(map(str, shape)) for shape, _ in TABLES]
SM_SHARED_BYTES = 233_472  # an H100 SM's shared memory
BLOCK_RESERVED_BYTES = 1024  # reserved by the runtime for each resident block
SM_THREADS_MAX = 2048


def _leaf(state, path):
    obj = state
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def _state(shape):
    n_prop, n_acc, k_slots, stamped, _, _ = shape  # then the arms and observer flags
    return SynchPaxosState.init(3, n_prop, n_acc, k_slots, delay=bool(stamped))


def _staged(shape):
    """(leaf, kinds) of SP_STAGED_LEAVES that the instantiation stages."""
    return [
        (path, kinds) for path, kinds in tfused.SP_STAGED_LEAVES
        if shape[3] or not path.endswith(".until")
    ]


def _rows(state, path, kinds):
    """Words a lane of a leaf (instance-minor) in the column: the product of
    its other dims, or of the message kinds staged."""
    shape = _leaf(state, path).shape[:-1]
    return math.prod(shape) if kinds is None else len(kinds) * math.prod(shape[1:])


@pytest.mark.parametrize("shape,staging", TABLES, ids=IDS)
def test_staged_rows_match_the_state_leaves(shape, staging):
    state = _state(shape)
    rows = sum(_rows(state, path, kinds) for path, kinds in _staged(shape))
    counters = tfused.tally_obs_rows(shape[0]) if shape[5] else 0
    rows += counters
    assert staging.rows == rows == tfused.sp_staged_rows(*shape[:4]) + counters
    assert counters in (0, 4 + 8 * shape[0])
    assert staging.smem_bytes == rows * 4 * staging.threads
    assert staging.smem_bytes <= tfused.SMEM_PER_BLOCK_MAX
    assert staging.threads % 32 == 0 and 32 <= staging.threads <= 1024
    # The SM holds the blocks the registers are capped for.
    assert staging.min_blocks * (staging.smem_bytes + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert staging.min_blocks * staging.threads <= SM_THREADS_MAX
    for path, _ in _staged(shape):
        assert _leaf(state, path).dtype == torch.int32
    assert 2 * shape[0] * shape[1] <= 32  # a buffer's presence fits one bitmask


def test_zero_words_and_staged_kinds_cover_every_payload_once():
    """Each (payload leaf, kind) is staged or zero-only, never both."""
    covered = []
    for path, kinds in tfused.SP_STAGED_LEAVES + tfused.SP_ZERO_WORDS:
        if path.split(".")[1] in ("bal", "v1", "v2"):
            covered += [(path, k) for k in kinds]
    want = [(f"{buf}.{f}", k) for buf in ("requests", "replies") for f in ("bal", "v1", "v2") for k in (0, 1)]
    assert sorted(covered) == sorted(want)


def test_every_instantiation_has_a_geometry():
    assert tuple(tfused.SP_STAGING) == tfused.KERNEL_SHAPES["synchpaxos"]
    assert tfused.BINDINGS["synchpaxos"].staging is tfused.SP_STAGING


def test_observed_geometry_is_k1s():
    """The observed instantiations, at (2,5,8) with and without the stamps
    and the arms, most counters in registers: 124 words (164 stamped), as
    K2's; without the arms 3 blocks of 128 lanes, stamped 3 of 96 (K2's at
    2 of 128); with the arms 2 blocks of 128, as K1's; the others keep their
    planes-off geometry (3 blocks)."""
    observed = [k for k in tfused.SP_STAGING if k[5]]
    assert observed == [(2, 5, 8, s, r, 1) for s in (0, 1) for r in (0, 1)]
    for key in observed:
        st = tfused.SP_STAGING[key]
        assert (st == tfused.FR_STAGING["fastpaxos"][key]) == (key != (2, 5, 8, 1, 0, 1))
        if key[4]:
            assert (st.threads, st.min_blocks) == (tfused.FR_STAGING["paxos"][key].threads, 2)
            assert (st.threads, st.rows, st.min_blocks) == (128, 124 + 40 * key[3], 2)
        else:
            assert (st.threads, st.rows, st.min_blocks) == ((96, 164, 3) if key[3] else (128, 124, 3))
    assert all(st.min_blocks == 3 for k, st in tfused.SP_STAGING.items() if not k[5])


def _instances():
    """``K4_INSTANCES`` of the .cu, in order: (P, A, K, stamped, arms,
    observed, B, MIN) each."""
    listed = re.search(r"#define K4_INSTANCES\(X\)(.*?)\n\n", SOURCE, re.S).group(1)
    return [tuple(map(int, x.split(", "))) for x in re.findall(r"X\(([\d, ]+)\)", listed)]


def test_source_instantiates_the_table():
    """``K4_INSTANCES`` in the .cu lists exactly the table's geometries."""
    want = [shape + (st.threads, st.min_blocks) for shape, st in TABLES]
    assert sorted(_instances()) == sorted(want)


def test_source_instantiates_each_shape_once():
    """The C entry point picks the instantiation by the shape, stamps, arms
    and observer flags alone, so none may have two geometries."""
    shapes = [inst[:6] for inst in _instances()]
    assert len(shapes) == len(set(shapes)) == len(tfused.KERNEL_SHAPES["synchpaxos"])
    assert "dims[0] == P_ && dims[1] == A_ && dims[2] == K_ && dims[3] == S_ && dims[4] == R_ &&" in SOURCE
    assert "dims[5] == O_)" in SOURCE
    assert SOURCE.count("n_dims != 7") == 2 and SOURCE.count("const int smem = dims[6];") == 2
    assert "using G = SdStaged<P, A, K, false, STAMPED>;" in SOURCE
    assert "(SdStaged<P, A, K, false, STAMPED>::kRows +" in SOURCE
    assert "(has_arg<obs::Obs, Arms...> ? obs::TallyRows<P>::kRows : 0)) * B * 4>;" in SOURCE


def test_source_column_order_matches_the_leaves():
    """``sd::load_column`` stages the leaves in the table's order, each with
    the rows its leaf (its staged kinds) has a lane, from the leaf's first
    staged row, the stamps of a stamped state only; ``SdStaged``'s offsets
    follow the same order."""
    names = {
        "kRqBal": "requests.bal", "kRqV1": "requests.v1", "kRpBal": "replies.bal",
        "kRpV1": "replies.v1", "kRpV2": "replies.v2", "kRqUntil": "requests.until",
        "kRpUntil": "replies.until", "kLtBal": "learner.lt_bal", "kLtVal": "learner.lt_val",
        "kLtMask": "learner.lt_mask",
    }
    assert "sd::load_column<P, A, K, false, 0, B, STAMPED>(col, L, n, i);" in SOURCE
    body = re.search(r"void load_column\(.*?\n}\n", COMMON[COMMON.index("namespace sd {"):], re.S).group(0)
    calls = re.findall(r"load_rows<([^,]+), ([^,]+), G::(\w+), UNROLL>\(col, L, (\w+), n, i\)", body)
    assert [names[leaf] for *_, leaf in calls] == [path for path, _ in tfused.SP_STAGED_LEAVES]
    assert [off for _, _, off, _ in calls] == [leaf for *_, leaf in calls]
    kinds = dict(tfused.SP_STAGED_LEAVES)
    for shape, _ in TABLES:
        state = _state(shape)
        e = shape[0] * shape[1]
        env = {"G::S": 2 * e, "G::E": e, "K": shape[2], "G::kRqV1From": e, "G::S - G::kRqV1From": e}
        for rows, first, _, leaf in calls:
            path = names[leaf]
            if (path, kinds[path]) not in _staged(shape):
                continue  # the stamps of a stamped state only
            assert env[rows] == _rows(state, path, kinds[path])
            start = 0 if kinds[path] is None else kinds[path][0] * env["G::E"]
            assert {"0": 0, **env}[first] == start


def test_phase_names_match_the_kernel():
    """``PHASES['synchpaxos']`` names the .cu's ``Phase`` enum, in order,
    and the tick marks every phase once."""
    body = re.sub(r"//[^\n]*", "", re.search(r"enum Phase \{(.*?)\};", SOURCE, re.S).group(1))
    phases = [p.strip() for p in body.replace("\n", " ").split(",") if p.strip()]
    assert phases[-1] == "kPhases"
    assert len(phases[:-1]) == len(tfused.PHASES["synchpaxos"])
    for phase in phases[:-1]:
        assert SOURCE.count(f"clk.mark({phase});") == 1


def test_launch_dims_carry_the_geometry():
    sp = tfused.BINDINGS["synchpaxos"]
    for shape, staging in tfused.SP_STAGING.items():
        assert tfused._launch_dims(sp, shape) == shape + (staging.smem_bytes,)


def test_measuring_builds_need_the_card_and_the_kernel(monkeypatch, tmp_path):
    """The occupancy query builds and asks the kernel's own library:
    without nvcc it raises, with no estimate to fall back on, and a binding
    without a geometry (chip_ab.py's, for a kernel source whose C entry
    takes no shared bytes) has none to ask for; every fused kernel has a
    phase-clock build, which counts on the card only."""

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfused.blocks_per_sm("synchpaxos", (2, 5, 8, 1, 0, 0))
    monkeypatch.setitem(
        tfused.BINDINGS, "paxos", dataclasses.replace(tfused.BINDINGS["paxos"], staging=None)
    )
    with pytest.raises(ValueError, match="no staging"):
        tfused.blocks_per_sm("paxos", (2, 5, 8))
    cfg = TC.config_delay_chaos(64, 1)
    state = trun.init_state(cfg, "cpu")
    assert set(tfused.PHASES) == set(tfused.BINDINGS)
    with pytest.raises(ValueError, match="phase-clock"):
        tfused.phase_clocks("int32_ceiling", state, 1, None, cfg.fault, 8)
    mp_cfg = TC.config3_multipaxos(64, 1)
    with pytest.raises(ValueError, match="CUDA state"):
        tfused.phase_clocks("multipaxos", trun.init_state(mp_cfg, "cpu"), 1, None, mp_cfg.fault, 8)
    with pytest.raises(ValueError, match="CUDA state"):
        tfused.phase_clocks("synchpaxos", state, 1, None, cfg.fault, 8)
