"""Ablation timing of the fused kernels' tick components (counterpart of
``scripts/ablate_fused.py``).

Each variant launches the kernel's ablated build
(``fused_tick.fused_fns(protocol, ablate)`` on the card: ``-DFUSED_ABLATE``,
each component removed at compile time), at config2's key for Paxos and
config3's for Multi-Paxos, the only keys the ablated builds are
instantiated for.  Flags (``protocols.paxos.ABLATE_FLAGS``):

- ``prng``:     constant masks instead of counter-PRNG draws
- ``select``:   acceptors select nothing (no request processing)
- ``sends``:    no reply or request writes
- ``consume``:  delivered and selected buffers never cleared
- ``learner``:  no learner and no acceptor invariants
- ``proposer``: no proposer half-tick

An ablated kernel is not the protocol (its schedule means nothing); its
only use is its time against the full kernel's at the same shapes.  A
component's share is ``1 - t_ablated / t_full``; work overlaps (sends feed
consume), so the shares need not sum to 1.  Each variant runs a chunk of
``--ticks`` from the initial state (the first chunk, where the lanes still
send), then the best of ``--reps`` further chunks (the steady state), both
per tick; the row of the steady state is the reference's.

Usage (on a CUDA card; ``--device cpu`` runs the plain versions, whose
times measure nothing):

    python -m paxos_tpu_torch.scripts.ablate_fused --protocol multipaxos
    python -m paxos_tpu_torch.scripts.ablate_fused --protocol paxos --record ablate.json
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from paxos_tpu_torch.core.device import card_line, resolve_device
from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.harness.np_plan import config_plan
from paxos_tpu_torch.harness.run import init_plan, init_state, sampled_plan_knobs
from paxos_tpu_torch.kernels import fused_tick
from paxos_tpu_torch.protocols.paxos import ABLATE_FLAGS

FLAGS = ABLATE_FLAGS
# The reference CLI's config names (paxos_tpu/harness/cli.py CONFIGS) of
# the configs whose keys the ablated builds are instantiated for
# (``fused_tick.ABLATE_KEYS``).
CONFIGS = {"config2": C.config2_dueling_drop, "config3": C.config3_multipaxos}
# The reference's record of TPU times, which this tool never writes.
REFERENCE_RECORD = Path(__file__).resolve().parents[2] / "ABLATE.json"


def variant_plan(cfg, device):
    """``cfg``'s plan: drawn from numpy with the reference's distribution
    where it samples one (crash windows, equivocators; item 15), else the
    fault-free plan."""
    if sampled_plan_knobs(cfg.fault):
        return config_plan(cfg, cfg.seed, device)
    return init_plan(cfg, device)


def time_variant(cfg, ablate, n_ticks: int, reps: int, device) -> tuple:
    """(first, best): seconds a tick of a chunk of ``n_ticks`` from
    ``cfg``'s initial state through the kernel without the components
    ``ablate`` names, and of the best of ``reps`` further chunks, each
    timed on the host clock to a synchronise (the reference's method); on
    the card the kernel is built, loaded and launched for 0 ticks first."""
    ablate = frozenset(ablate)
    binding = fused_tick.BINDINGS[cfg.protocol]
    wrapper = fused_tick.FUSED_WRAPPERS[cfg.protocol]
    block = fused_tick.fit_block(binding.block, cfg.n_inst)
    plan = variant_plan(cfg, device)
    state = init_state(cfg, device)
    if device.type == "cuda":  # the build and the module's load are set-up, not the first chunk
        fused_tick.warm_kernel(cfg.protocol, state, cfg.seed, plan, cfg.fault, block, ablate)
        torch.cuda.synchronize(device)

    def chunk(st):
        t0 = time.perf_counter()
        st = wrapper(st, cfg.seed, plan, cfg.fault, n_ticks, block=block, ablate=ablate)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return st, time.perf_counter() - t0

    state, first = chunk(state)
    best = float("inf")
    for _ in range(reps):
        state, t = chunk(state)
        best = min(best, t)
    return first / n_ticks, best / n_ticks


def ablation_table(protocol: str, name: str, n_inst: int, ticks: int, reps: int, device) -> dict:
    """Every variant's row, full first: ``us_per_tick`` and ``share`` of
    the steady state (the reference's row), ``first_us_per_tick`` and
    ``first_share`` of the first chunk."""
    cfg = CONFIGS[name](n_inst, 0)
    if cfg.protocol != protocol:
        raise SystemExit(f"config {name} is {cfg.protocol}, not {protocol}")
    first0, full = time_variant(cfg, (), ticks, reps, device)
    rows = [{"variant": "full", "us_per_tick": full * 1e6, "share": 0.0,
             "first_us_per_tick": first0 * 1e6, "first_share": 0.0}]
    for flag in FLAGS:
        first, t = time_variant(cfg, (flag,), ticks, reps, device)
        rows.append({"variant": f"no-{flag}", "us_per_tick": t * 1e6, "share": 1.0 - t / full,
                     "first_us_per_tick": first * 1e6, "first_share": 1.0 - first / first0})
    return {
        "protocol": protocol, "config": name, "n_inst": n_inst, "ticks_per_chunk": ticks,
        "platform": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card_line() if device.type == "cuda" else None,
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", choices=["paxos", "multipaxos"], default="paxos")
    ap.add_argument("--config", default=None, choices=sorted(CONFIGS),
                    help="config name (default: config2 for paxos, config3 for multipaxos)")
    ap.add_argument("--n-inst", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--record", default=None, help="write the table as JSON")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.record and Path(args.record).resolve() == REFERENCE_RECORD:
        raise SystemExit(f"{REFERENCE_RECORD.name} is the reference's TPU record; record elsewhere")
    device = resolve_device(args.device)
    n_inst = args.n_inst or ((1 << 20) if device.type == "cuda" else (1 << 10))
    name = args.config or ("config2" if args.protocol == "paxos" else "config3")
    if device.type != "cuda":
        print("# WARNING: not on a CUDA card: the plain versions' times measure nothing; "
              "this run only shows that every variant runs")
    out = ablation_table(args.protocol, name, n_inst, args.ticks, args.reps, device)
    if out["card"]:
        print(out["card"])
    for row in out["rows"]:
        print(f"{row['variant']:12s} {row['us_per_tick']:9.2f} us/tick   share "
              f"{row['share'] * 100:5.1f}%   first chunk {row['first_us_per_tick']:9.2f} us/tick  "
              f"share {row['first_share'] * 100:5.1f}%")
    print(json.dumps(out))
    if args.record:
        Path(args.record).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
