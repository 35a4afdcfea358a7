"""How the port names, and so rebuilds, its CUDA libraries (no nvcc needed).

A library's file name hashes its source, every local header the source
includes and the compiler flags, so an edited header or a ``-D`` variant
gets a library of its own.
"""

import pytest

from paxos_tpu_torch.harness import config as TC
from paxos_tpu_torch.harness import run as trun
from paxos_tpu_torch.kernels import build
from paxos_tpu_torch.kernels import fused_tick as tfused


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_sources_follow_local_includes(csrc):
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


def test_library_path_hashes_headers_and_defines(csrc):
    before = build.library_path("k")
    (csrc / "b.cuh").write_text("#pragma once\n// edited\n")
    edited = build.library_path("k")
    assert edited != before and edited.parent == csrc / "build"
    variant = build.library_path("k", ("FUSED_COUNT_DRAWS",))
    assert variant.name.startswith("k_fused_count_draws_") and variant != edited
    assert build.ptxas_report("k", ("FUSED_COUNT_DRAWS",)) == ""


def test_fused_kernels_share_the_common_header():
    for binding in tfused.BINDINGS.values():
        names = [p.name for p in build.sources(binding.kernel)]
        assert names == [f"{binding.kernel}.cu", "fused_common.cuh"]


def test_draw_census_needs_a_cuda_state():
    cfg = TC.config2_dueling_drop(64, 1)
    state, plan = trun.init_state(cfg, "cpu"), trun.init_plan(cfg, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.draw_census("paxos", state, 1, plan, cfg.fault, 4)
