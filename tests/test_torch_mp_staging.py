"""K5's shared-memory staging (no GPU needed).

The Multi-Paxos kernel keeps each lane's slot arrays in a shared-memory
column for a whole chunk; ``fused_tick.MP_STAGING`` is the launch geometry
per instantiation that the wrapper passes to it (lanes a CUDA block, staged
rows, shared bytes).  The rows are held against the port's own
``MultiPaxosState`` leaf shapes, the geometry against the card's limits,
and the table against the instantiations and the column order of
``csrc/fused_multipaxos_tick.cu``.
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
    n_prop, n_acc, log_len, k_slots = shape
    state = MultiPaxosState.init(3, n_prop, n_acc, log_len, k_slots)
    leaves = tfused.MP_STAGED_LEAVES + ((tfused.MP_PROM_LEAF,) if staging.stage_prom else ())
    rows = sum(_rows(state, path) for path in leaves)
    assert staging.rows == rows == tfused.mp_staged_rows(*shape, staging.stage_prom)
    assert staging.smem_bytes == rows * 4 * staging.threads
    assert staging.smem_bytes <= tfused.SMEM_PER_BLOCK_MAX
    assert staging.threads % 32 == 0 and 32 <= staging.threads <= 1024
    for path in leaves:
        assert _leaf(state, path).dtype.itemsize == 4  # int32 elements
    assert n_acc <= 8 and k_slots <= tfused.MP_MASKS_PER_WORD  # a slot's masks fit one word


def test_every_instantiation_has_a_geometry():
    assert tuple(tfused.MP_STAGING) == tfused.KERNEL_SHAPES["multipaxos"]


def _instances():
    """``K5_INSTANCES`` of the .cu, in order: (P, A, L, K, B, PROM) each."""
    listed = re.search(r"#define K5_INSTANCES\(X\)(.*?)\n\n", SOURCE, re.S).group(1)
    return [
        (int(p), int(a), int(l), int(k), int(b), s == "true")
        for p, a, l, k, b, s in re.findall(
            r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (true|false)\)", listed
        )
    ]


def test_source_instantiates_the_table():
    """``K5_INSTANCES`` in the .cu lists exactly the table's geometries."""
    want = [shape + (st.threads, st.stage_prom) for shape, st in TABLES]
    assert sorted(_instances()) == sorted(want)


def test_source_instantiates_each_shape_once():
    """The C entry point picks the instantiation by the shape alone, so no
    shape may have two geometries."""
    shapes = [inst[:4] for inst in _instances()]
    assert len(shapes) == len(set(shapes)) == len(tfused.KERNEL_SHAPES["multipaxos"])
    assert "dims[0] == P_ && dims[1] == A_ && dims[2] == L_ && dims[3] == K_)" in SOURCE
    assert "n_dims != 5" in SOURCE and "const int smem = dims[4];" in SOURCE


def test_source_column_order_matches_the_leaves():
    """``load_column`` and ``store_column`` stage the leaves in the table's
    order, each with the row count its leaf has a lane."""
    names = {
        "kLog": "acceptor.log", "kRecov": "proposer.recov_bv", "kLtBv": "learner.lt_bv",
        "kLtMask": "learner.lt_mask", "kChosenVal": "learner.chosen_val",
        "kChosenTick": "learner.chosen_tick", "kPromBv": tfused.MP_PROM_LEAF,
    }
    want = list(tfused.MP_STAGED_LEAVES) + [tfused.MP_PROM_LEAF]
    for fn, op in (("load_column", "load"), ("store_column", "store")):
        body = re.search(rf"void {fn}\(.*?\n}}\n", SOURCE, re.S).group(0)
        calls = re.findall(rf"{op}_(rows|masks)<([^>]+), G::(\w+)>\(col, L, Mp::(\w+), n, i\)", body)
        assert [names[leaf] for _, _, _, leaf in calls] == want
        assert [off for _, _, off, _ in calls] == [leaf for _, _, _, leaf in calls]
        assert [kind for kind, _, _, leaf in calls if names[leaf] == tfused.MP_PACKED_LEAF] == ["masks"]
        for shape, _ in TABLES:
            n_prop, n_acc, log_len, k_slots = shape
            state = MultiPaxosState.init(3, n_prop, n_acc, log_len, k_slots)
            env = {"P": n_prop, "A": n_acc, "LOG": log_len, "K": k_slots}
            for kind, args, _, leaf in calls:
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
        tfused.blocks_per_sm("multipaxos", (2, 5, 8, 4))
