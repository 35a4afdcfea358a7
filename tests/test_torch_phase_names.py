"""The phase-clock build's phase lists against the kernels' sources (no GPU
needed, no JAX).

``fused_tick.PHASES[protocol]`` names the phases a lane's cycles are split
into, in the order of the ``Phase`` enum of the protocol's kernel source
(``csrc/fused_<protocol>_tick.cu``), each marked once by the tick;
``fused_tick.PHASE_SLOTS`` is the reader's count, ``kMaxPhases`` in
``csrc/fused_common.cuh``.  The enums of K1 to K5 name each of their
phases (one comment an entry), their observed ticks' planes split into
four (``OBSERVER_SPLIT``); ``chip_ab.source_phases`` reads those names, so
that sources timed against each other are split by their own phases.
"""

import re
from pathlib import Path

import pytest

import chip_ab
from paxos_tpu_torch.kernels import build
from paxos_tpu_torch.kernels import fused_tick as tfused

CSRC = Path(build.__file__).parent / "csrc"
COMMON = (CSRC / "fused_common.cuh").read_text()


def _source(protocol: str) -> str:
    return (CSRC / f"{tfused.BINDINGS[protocol].kernel}.cu").read_text()


def _enum(src: str) -> list:
    """(identifier, name or None) of each ``Phase`` enum entry, in order."""
    body = re.search(r"enum Phase \{(.*?)\};", src, re.S).group(1)
    out = []
    for line in body.splitlines():
        code, _, comment = line.partition("//")
        names = [c.strip() for c in code.split(",") if c.strip()]
        out += [(ident, comment.strip() or None if len(names) == 1 else None) for ident in names]
    return out


@pytest.mark.parametrize("protocol", sorted(tfused.PHASES))
def test_phases_follow_the_enum(protocol):
    """One phase a ``Phase`` entry before ``kPhases``, each marked once by
    the tick, named as the enum names it where it does."""
    src = _source(protocol)
    entries = _enum(src)
    assert entries[-1][0] == "kPhases"
    entries = entries[:-1]
    assert len(entries) == len(tfused.PHASES[protocol])
    for (ident, name), phase in zip(entries, tfused.PHASES[protocol], strict=True):
        assert src.count(f"clk.mark({ident});") == 1, ident
        assert name in (None, phase)
    assert "PhaseClock<kPhases> clk;" in src
    assert chip_ab.source_phases(src, tfused.PHASES[protocol]) == tfused.PHASES[protocol]


@pytest.mark.parametrize("protocol", ["multipaxos", "synchpaxos", "fastpaxos", "raftcore", "paxos"])
def test_names_its_observer_split(protocol):
    """The enums of K1 to K5 name every phase, and their observed ticks'
    planes are the four phases before the column store, each marked once,
    in that order."""
    src = _source(protocol)
    entries = _enum(src)[:-1]
    assert all(name is not None for _, name in entries)
    assert tfused.OBSERVER_SPLIT == ("observer counters", "margin", "digest", "coverage insert")
    assert tfused.PHASES[protocol][-5:] == tfused.OBSERVER_SPLIT + ("column store",)
    assert "observers" not in tfused.PHASES[protocol]
    marks = [src.index(f"clk.mark({ident});") for ident, _ in entries[-5:]]
    assert marks == sorted(marks)


def test_phase_slots_hold_every_kernel():
    """``PHASE_SLOTS`` (12, K4's phases with its observers split) is
    ``kMaxPhases`` and holds the longest list."""
    assert f"constexpr int kMaxPhases = {tfused.PHASE_SLOTS};" in COMMON
    assert max(len(p) for p in tfused.PHASES.values()) == tfused.PHASE_SLOTS == 12
    assert len(tfused.PHASES["synchpaxos"]) == 12
    assert [len(tfused.PHASES[p]) for p in ("fastpaxos", "raftcore", "paxos")] == [11, 11, 11]


def test_an_unnamed_enum_keeps_its_observers_phase_whole():
    """A K5 source from before the split (one ``kPhObs``, no names) is
    split by its own eight phases, a K4 one by its own nine, a K2, K3 or K1
    one by its own eight; a kernel without an observers phase clocks
    none."""
    older = re.sub(
        r"enum Phase \{.*?\};",
        "enum Phase {\n  kPhLoad, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhProposer, "
        "kPhObs, kPhStore,\n  kPhases,\n};",
        _source("multipaxos"), flags=re.S,
    )
    phases = chip_ab.source_phases(older, tfused.PHASES["multipaxos"])
    assert phases == tfused.PHASES["multipaxos"][:6] + ("observers", "column store")
    bare = older.replace("kPhObs, ", "")
    assert chip_ab.source_phases(bare, tfused.PHASES["multipaxos"]) == (
        tfused.PHASES["multipaxos"][:6] + ("column store",)
    )
    for protocol, before in (
        ("synchpaxos", "kPhLoad, kPhRefresh, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhSends, "
                       "kPhObs,\n  kPhStore, kPhases,"),
        ("fastpaxos", "kPhLoad, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhSends, kPhObs, "
                      "kPhStore,\n  kPhases,"),
        ("raftcore", "kPhLoad, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhSends, kPhObs, "
                     "kPhStore,\n  kPhases,"),
        ("paxos", "kPhLoad, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhSends, kPhObs, "
                  "kPhStore,\n  kPhases,"),
    ):
        older = re.sub(r"enum Phase \{.*?\};", "enum Phase {\n  " + before + "\n};", _source(protocol),
                       flags=re.S)
        split = len(tfused.OBSERVER_SPLIT)
        assert chip_ab.source_phases(older, tfused.PHASES[protocol]) == (
            tfused.PHASES[protocol][:-split - 1] + ("observers", "column store")
        )


@pytest.mark.parametrize("protocol", ["synchpaxos", "fastpaxos", "raftcore", "paxos"])
def test_table_staging_reads_each_sources_counter_rows(protocol):
    """``chip_ab.table_staging`` launches a K4, K2, K3 or K1 source at its
    own table's geometry and counter rows: this source's as the wrapper's,
    and a parent's (every observed key at 2 blocks of 128, no
    ``obs::Tally``) with all 49 counters in its observed columns."""
    src = _source(protocol)
    staging = tfused.BINDINGS[protocol].staging
    assert chip_ab.table_staging(protocol, src, staging) == staging
    older = re.sub(r"X\((2, 5, 8, [01], [01], 1), \d+, \d\)", r"X(\1, 128, 2)", src)
    got = chip_ab.table_staging(protocol, older.replace("obs::Tally", "obs::Rows"), staging)
    for key, st in got.items():
        if key[5]:
            staged = (
                tfused.sp_staged_rows(*key[:4]) if protocol == "synchpaxos"
                else tfused.fr_staged_rows(protocol, *key[:4])
            )
            rows = staged + tfused.obs_rows(2)
            assert (st.threads, st.min_blocks, st.rows) == (128, 2, rows)
        else:
            assert st == staging[key]


def test_table_staging_reads_k5_lane_rows():
    """``chip_ab.table_staging`` launches a K5 source at its own column: this
    source's as the wrapper's (the arms' 22 link rows, the stamped keys'
    10 rows of caps, none of them where observed), and a source from before
    them (no ``LINKS``, no ``kCaps``) at its default's column for the
    arms key and 152 words for the stamped keys."""
    src = _source("multipaxos")
    staging = tfused.BINDINGS["multipaxos"].staging
    assert chip_ab.table_staging("multipaxos", src, staging) == staging
    older = src.replace("bool LINKS", "bool GRAY").replace("kCaps", "kCapRow")
    got = chip_ab.table_staging("multipaxos", older, staging)
    want = {(2, 5, 8, 4, 0, 1, 0): 192, (2, 5, 8, 4, 1, 0, 0): 152, (2, 5, 8, 4, 1, 1, 0): 152}
    for key, st in got.items():
        if key in want:
            assert (st.threads, st.stage_prom, st.rows) == (128, staging[key].stage_prom, want[key])
            assert staging[key].rows - st.rows == {192: 22, 152: 10 if not key[5] else 32}[want[key]]
        else:
            assert st == staging[key]
