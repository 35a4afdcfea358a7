"""K5's shared-memory staging (no GPU needed).

The Multi-Paxos kernel keeps each lane's slot arrays in a shared-memory
column for a whole chunk; ``fused_tick.MP_STAGING`` is the launch geometry
per instantiation that the wrapper passes to it (lanes a CUDA block, staged
rows, shared bytes).  The rows are held against the port's own
``MultiPaxosState`` leaf shapes, the geometry against the card's limits,
and the table against the instantiations and the column order of
``csrc/fused_multipaxos_tick.cu``.  A table key is (n_prop, n_acc,
log_len, k_slots, stamped, arms, observed): the gray-failure and partition
arms are an instantiation of their own at config3's shape, with its
default's column, and so is the bounded-delay channel, whose 40 stamp
words a lane join the column while the PROMISE payloads go to global
memory, so that an SM still holds 2 blocks of 128 lanes; so are the
observer planes, whose counters (``obs_rows``, 49 words) join the column,
and at config3-long's shape too.
"""

import dataclasses
import math
import re

import pytest

from paxos_tpu_torch.core.mp_state import MultiPaxosState
from paxos_tpu_torch.kernels import build
from paxos_tpu_torch.kernels import fused_tick as tfused

SOURCE = (build.CSRC / "fused_multipaxos_tick.cu").read_text()
TABLES = list(tfused.MP_STAGING.items())
IDS = ["-".join(map(str, shape)) for shape, _ in TABLES]


def _leaf(state, path):
    obj = state
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def _rows(state, path):
    """Words a lane of a leaf (instance-minor) in the column: the product
    of its other dims, the voter masks a word per slot."""
    shape = _leaf(state, path).shape[:-1]
    if path == tfused.MP_PACKED_LEAF:
        return shape[0] * math.ceil(shape[1] / tfused.MP_MASKS_PER_WORD)
    return math.prod(shape)


@pytest.mark.parametrize("shape,staging", TABLES, ids=IDS)
def test_staged_rows_match_the_state_leaves(shape, staging):
    n_prop, n_acc, log_len, k_slots, stamped, _, observed = shape
    state = MultiPaxosState.init(3, n_prop, n_acc, log_len, k_slots, delay=bool(stamped))
    leaves = (
        tfused.MP_STAGED_LEAVES + (tfused.MP_STAMP_LEAVES if stamped else ())
        + ((tfused.MP_PROM_LEAF,) if staging.stage_prom else ())
    )
    rows = sum(_rows(state, path) for path in leaves) + (tfused.obs_rows(n_prop) if observed else 0)
    assert staging.rows == rows == (
        tfused.mp_staged_rows(*shape[:5], staging.stage_prom) + observed * tfused.obs_rows(n_prop)
    )
    assert staging.smem_bytes == rows * 4 * staging.threads
    assert staging.smem_bytes <= tfused.SMEM_PER_BLOCK_MAX
    assert staging.threads % 32 == 0 and 32 <= staging.threads <= 1024
    for path in leaves:
        assert _leaf(state, path).dtype.itemsize == 4  # int32 elements
    assert n_acc <= 8 and k_slots <= tfused.MP_MASKS_PER_WORD  # a slot's masks fit one word


def test_every_instantiation_has_a_geometry():
    assert tuple(tfused.MP_STAGING) == tfused.KERNEL_SHAPES["multipaxos"]
    # The arms, the stamps and the planes: config3's shape only, each arms
    # instantiation with its default's column; and the planes alone at
    # config3-long's.
    keys = [(s, r, o) for s in (0, 1) for r in (0, 1) for o in (0, 1)]
    assert [k for k in tfused.MP_STAGING if k[:4] != (2, 5, 8, 4)] == [
        (2, 5, 16, 4, 0, 0, 0), (2, 5, 4, 4, 0, 0, 0), (2, 3, 8, 4, 0, 0, 0),
        (2, 5, 16, 4, 0, 0, 1),
    ]
    assert sorted(k[4:] for k in tfused.MP_STAGING if k[:4] == (2, 5, 8, 4)) == keys
    for stamped in (0, 1):
        for observed in (0, 1):
            assert (
                tfused.MP_STAGING[(2, 5, 8, 4, stamped, 1, observed)]
                == tfused.MP_STAGING[(2, 5, 8, 4, stamped, 0, observed)]
            )


def test_stamped_geometry_keeps_two_blocks_an_sm():
    """The stamped column (152 words: 112 of slot arrays and 40 stamps, the
    PROMISE payloads in global memory) takes 2 blocks of 128 lanes an SM,
    as the default does; with the payloads staged too (232 words) 2 blocks
    of 128 would not fit."""
    sm_shared, reserved = 233_472, 1024
    for key in ((2, 5, 8, 4, 1, 0, 0), (2, 5, 8, 4, 1, 1, 0)):
        st = tfused.MP_STAGING[key]
        assert (st.threads, st.stage_prom, st.rows, st.smem_bytes) == (128, False, 152, 77824)
        assert 2 * (st.smem_bytes + reserved) <= sm_shared
    staged_all = tfused.mp_staged_rows(2, 5, 8, 4, 1, True)
    assert staged_all == 232 and 2 * (staged_all * 4 * 128 + reserved) > sm_shared
    default = tfused.MP_STAGING[(2, 5, 8, 4, 0, 0, 0)]
    assert 2 * (default.smem_bytes + reserved) <= sm_shared


def test_observed_geometry_keeps_two_blocks_an_sm():
    """The observed columns add the planes' counters (49 words) to a column
    with the PROMISE payloads staged: 241 words, 281 stamped, which 2 blocks
    of 96 lanes an SM hold (2 of 128 would not fit)."""
    sm_shared, reserved = 233_472, 1024
    for (stamped, arms), want in {
        (0, 0): (96, True, 241), (0, 1): (96, True, 241),
        (1, 0): (96, True, 281), (1, 1): (96, True, 281),
    }.items():
        st = tfused.MP_STAGING[(2, 5, 8, 4, stamped, arms, 1)]
        assert (st.threads, st.stage_prom, st.rows) == want
        assert st.smem_bytes == st.rows * 4 * st.threads
        assert 2 * (st.smem_bytes + reserved) <= sm_shared
    staged_all = tfused.mp_staged_rows(2, 5, 8, 4, 0, True) + tfused.obs_rows(2)
    assert staged_all == 241 and 2 * (staged_all * 4 * 128 + reserved) > sm_shared


def _instances():
    """``K5_INSTANCES`` of the .cu, in order: (P, A, L, K, STAMPED, ARMS, OBS,
    B, PROM) each."""
    listed = re.search(r"#define K5_INSTANCES\(X\)(.*?)\n\n", SOURCE, re.S).group(1)
    return [
        (int(p), int(a), int(l), int(k), int(st), int(r), int(o), int(b), s == "true")
        for p, a, l, k, st, r, o, b, s in re.findall(
            r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (true|false)\)", listed
        )
    ]


def test_source_instantiates_the_table():
    """``K5_INSTANCES`` in the .cu lists exactly the table's geometries."""
    want = [shape + (st.threads, st.stage_prom) for shape, st in TABLES]
    assert sorted(_instances()) == sorted(want)


def test_source_instantiates_each_shape_once():
    """The C entry point picks the instantiation by the shape and the stamps,
    arms and observer flags alone, so no shape may have two geometries."""
    shapes = [inst[:7] for inst in _instances()]
    assert len(shapes) == len(set(shapes)) == len(tfused.KERNEL_SHAPES["multipaxos"])
    assert (
        "dims[0] == P_ && dims[1] == A_ && dims[2] == L_ && dims[3] == K_ && dims[4] == S_ &&"
        in SOURCE
    )
    assert "dims[5] == R_ && dims[6] == O_)" in SOURCE
    assert SOURCE.count("n_dims != 8") == 2 and SOURCE.count("const int smem = dims[7];") == 2


def test_source_column_order_matches_the_leaves():
    """``load_column`` and ``store_column`` stage the leaves in the table's
    order (the stamps of a stamped state after the slot arrays), each with
    the row count its leaf has a lane."""
    names = {
        "kLog": "acceptor.log", "kRecov": "proposer.recov_bv", "kLtBv": "learner.lt_bv",
        "kLtMask": "learner.lt_mask", "kChosenVal": "learner.chosen_val",
        "kChosenTick": "learner.chosen_tick", "kRqUntil": "requests.until",
        "kPromUntil": "promises.until", "kAccdUntil": "accepted.until",
        "kPromBv": tfused.MP_PROM_LEAF,
    }
    want = list(tfused.MP_STAGED_LEAVES) + list(tfused.MP_STAMP_LEAVES) + [tfused.MP_PROM_LEAF]
    for fn, op in (("load_column", "load"), ("store_column", "store")):
        body = re.search(rf"void {fn}\(.*?\n}}\n", SOURCE, re.S).group(0)
        calls = re.findall(rf"{op}_(rows|masks)<([^>]+), G::(\w+)>\(col, L, Mp::(\w+), n, i\)", body)
        assert [names[leaf] for _, _, _, leaf in calls] == want
        assert [off for _, _, off, _ in calls] == [leaf for _, _, _, leaf in calls]
        assert [kind for kind, _, _, leaf in calls if names[leaf] == tfused.MP_PACKED_LEAF] == ["masks"]
        for shape, _ in TABLES:
            n_prop, n_acc, log_len, k_slots, stamped, _, _ = shape
            state = MultiPaxosState.init(3, n_prop, n_acc, log_len, k_slots, delay=bool(stamped))
            env = {"P": n_prop, "A": n_acc, "LOG": log_len, "K": k_slots}
            for kind, args, _, leaf in calls:
                if names[leaf] in tfused.MP_STAMP_LEAVES and not stamped:
                    continue  # the stamps of a stamped state only
                # load_rows<ROWS>: ROWS words; load_masks<LOG, K>: a word a slot
                words = eval(args.split(",")[0], {}, env)  # noqa: S307
                assert words == _rows(state, names[leaf])


def test_launch_dims_carry_the_geometry():
    mp = tfused.BINDINGS["multipaxos"]
    for shape, staging in tfused.MP_STAGING.items():
        assert tfused._launch_dims(mp, shape) == shape + (staging.smem_bytes,)
    # A binding without a geometry (chip_ab.py's, for a kernel source whose
    # C entry takes no shared bytes) passes the shape alone.
    paxos = dataclasses.replace(tfused.BINDINGS["paxos"], staging=None)
    assert tfused._launch_dims(paxos, (2, 5, 8)) == (2, 5, 8)


def test_occupancy_query_needs_the_kernel_build(monkeypatch, tmp_path):
    """The occupancy query builds and asks the kernel's own library: without
    nvcc it raises, with no estimate to fall back on."""

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfused.blocks_per_sm("multipaxos", (2, 5, 8, 4, 0, 0, 0))
