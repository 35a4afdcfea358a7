"""The port's ablated Multi-Paxos tick against the JAX package's, bit for
bit; the ablation entry point; and the refusal of ablated launches the
kernels have no build for.

On config3 (its crash windows on chip_smoke's numpy plan; 128 lanes in two
stream blocks of 64 from block id 3, so that the PRNG-free selection
scores are pinned) every flag of ``ABLATE_FLAGS`` and the empty set run
32 ticks through the port's ``reference_chunk`` with
``fused_fns("multipaxos", {flag})`` and through the JAX package's, and
must agree leaf for leaf (tolerance 0).  Without the learner the
proposers read a chosen count of 0, as the JAX package's ablated tick
gives them (its lease runs out and leaders demote).  The entry point
(``python -m paxos_tpu_torch.scripts.ablate_fused``) runs every variant
on the CPU at a small size and writes the reference tool's rows.
"""

import json

import pytest

import chip_smoke
from _torch_jax import check_ablated_against_jax, one_core, one_torch_thread  # noqa: F401  (autouse)
from paxos_tpu_torch.kernels import fused_tick as tfused
from paxos_tpu_torch.protocols.paxos import ABLATE_FLAGS
from paxos_tpu_torch.scripts import ablate_fused

N, BLOCK, BLK0, TICKS, SEED = 128, 64, 3, 32, 10


def _config3():
    cfg = chip_smoke.main_config("config3", N, SEED)
    return cfg, chip_smoke.config_plan(cfg, SEED, "cpu")


@pytest.fixture(scope="module")
def full():
    cfg, plan = _config3()
    return check_ablated_against_jax(cfg, (), TICKS, BLOCK, BLK0, plan)


@pytest.mark.parametrize("flag", ABLATE_FLAGS)
def test_ablated_multipaxos_matches_jax(flag, full):
    cfg, plan = _config3()
    got = check_ablated_against_jax(cfg, (flag,), TICKS, BLOCK, BLK0, plan)
    assert not all((a == b).all() for a, b in zip(got, full))  # the component was on the path


def test_unablated_multipaxos_matches_jax(full):
    assert len(full) == 30 and int(full[-2]) == TICKS


def test_ablated_launches_need_their_key():
    """An ablated launch is refused before any launch at every key but
    config2's (K1) and config3's (K5): another shape, the arms, the stamps
    or the planes (ROADMAP item 23); the unablated launch of the same state
    passes the check."""
    assert tfused.ABLATE_KEYS == {"paxos": (2, 5, 8, 0, 0, 0), "multipaxos": (2, 5, 8, 4, 0, 0, 0)}
    cases = {
        "config3": ("multipaxos", "config3", None),
        "config2": ("paxos", "paxos", None),
        "config3long": ("multipaxos", "config3long", "item 23"),
        "graychaos-multipaxos": ("multipaxos", "graychaos-multipaxos", "item 23"),
        "delaychaos-paxos": ("paxos", "delaychaos-paxos", "item 23"),
        "observed-multipaxos": ("multipaxos", "observed-multipaxos", "item 23"),
        "config1": ("paxos", None, "item 23"),
    }
    from paxos_tpu_torch.harness import config as C

    for name, (protocol, path, refused) in cases.items():
        cfg = chip_smoke.main_config(path, 64, 1) if path else C.config1_no_faults(64, 1)
        state = chip_smoke.path_state(cfg, "cpu")
        plan = chip_smoke.main_plan(cfg, "cpu") or chip_smoke.config_plan(cfg, 1, "cpu")
        tfused._check_cuda_inputs(protocol, state, plan, cfg.fault)
        if refused is None:
            tfused._check_cuda_inputs(protocol, state, plan, cfg.fault, frozenset({"sends"}))
        else:
            with pytest.raises(NotImplementedError, match=refused):
                tfused._check_cuda_inputs(protocol, state, plan, cfg.fault, frozenset({"sends"}))


@pytest.mark.parametrize("protocol", ["paxos", "multipaxos"])
def test_entry_point_writes_the_reference_rows(protocol, tmp_path, capsys):
    """The entry point on the CPU: every variant at a small size, the
    reference tool's JSON (its keys, and the rows ``full`` then
    ``no-<flag>`` in FLAGS' order with ``us_per_tick`` and ``share``, the
    first chunk's beside them), the warning that the times mean nothing,
    and no write to the reference's ABLATE.json."""
    record = tmp_path / "ablate.json"
    argv = ["--protocol", protocol, "--device", "cpu", "--n-inst", "128", "--ticks", "4",
            "--reps", "1", "--record", str(record)]
    assert ablate_fused.main(argv) == 0
    out = capsys.readouterr().out
    assert "WARNING" in out
    table = json.loads(record.read_text())
    assert json.loads(out.strip().splitlines()[-1]) == table
    assert table["protocol"] == protocol and table["platform"] == "cpu" and table["card"] is None
    assert table["config"] == ("config2" if protocol == "paxos" else "config3")
    assert (table["n_inst"], table["ticks_per_chunk"]) == (128, 4)
    assert [r["variant"] for r in table["rows"]] == ["full"] + [f"no-{f}" for f in ablate_fused.FLAGS]
    for row in table["rows"]:
        assert set(row) == {"variant", "us_per_tick", "share", "first_us_per_tick", "first_share"}
        assert row["us_per_tick"] > 0
        assert row["share"] == pytest.approx(1 - row["us_per_tick"] / table["rows"][0]["us_per_tick"])
    with pytest.raises(SystemExit, match="reference's TPU record"):
        ablate_fused.main(argv[:-1] + [str(ablate_fused.REFERENCE_RECORD)])
    with pytest.raises(SystemExit, match="is multipaxos, not paxos"):
        ablate_fused.main(["--protocol", "paxos", "--config", "config3", "--device", "cpu",
                           "--n-inst", "64", "--ticks", "2", "--reps", "1"])
