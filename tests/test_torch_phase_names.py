"""The phase-clock build's phase lists against the kernels' sources (no GPU
needed, no JAX).

``fused_tick.PHASES[protocol]`` names the phases a lane's cycles are split
into, in the order of the ``Phase`` enum of the protocol's kernel source
(``csrc/fused_<protocol>_tick.cu``), each marked once by the tick;
``fused_tick.PHASE_SLOTS`` is the reader's count, ``kMaxPhases`` in
``csrc/fused_common.cuh``.  K5's enum names each of its phases (one
comment an entry), its observed tick's planes split into four;
``chip_ab.source_phases`` reads those names, so that sources timed
against each other are split by their own phases.
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


def test_multipaxos_names_its_observer_split():
    """K5's enum names every phase, and its observed tick's planes are the
    four phases before the column store."""
    entries = _enum(_source("multipaxos"))[:-1]
    assert all(name is not None for _, name in entries)
    assert tfused.PHASES["multipaxos"][-5:] == (
        "observer counters", "margin", "digest", "coverage insert", "column store",
    )
    assert "observers" not in tfused.PHASES["multipaxos"]


def test_phase_slots_hold_every_kernel():
    assert f"constexpr int kMaxPhases = {tfused.PHASE_SLOTS};" in COMMON
    assert max(len(p) for p in tfused.PHASES.values()) == tfused.PHASE_SLOTS


def test_an_unnamed_enum_keeps_its_observers_phase_whole():
    """A K5 source from before the split (one ``kPhObs``, no names) is
    split by its own eight phases; a kernel without an observers phase
    clocks none."""
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
