#!/usr/bin/env python3
"""Same-call A/B timing of the fused kernels' sources on one GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_ab.py parent=DIR new=paxos_tpu_torch/kernels/csrc \\
        [--paths fastpaxos raftcore] [--rounds 1]

Each ``NAME=DIR`` names a directory laid out as
``paxos_tpu_torch/kernels/csrc``: another commit's (``git archive``) or a
variant of this one's.  Each round runs the variants in the order given,
then reversed (A B B A), and each builds a path's kernel from its own
directory (``build.CSRC``; the libraries are named by their sources'
hash, so variants never share one) and measures, on the main path's
config (``chip_smoke.MAIN_PATHS``) through ``chip_smoke``'s own functions:

- the steady 64-tick chunk and the first chunk at 1<<20 lanes
  (``compare``, each byte for byte against the plain version, with the
  counted draws, and the phase split where the source has a phase-clock
  build);
- the column load and store alone, a 0-tick launch (``time_load_store``);
- the main path itself, reports and eviction pins checked
  (``phase_main_path``);
- each variant's ``ptxas -v`` lines.

The path ``ceiling`` times K6 (``phase_ceiling``) instead.  A source whose
C entry takes no shared bytes (a kernel before its column redesign) is
launched without them; sources from before the gray-failure and partition
arms get the parameters and plan leaves their ``fused_common.cuh`` reads
(``kParams``, ``kPlanLeaves``), and a kernel without its arms its default
instantiations only.  Prints the card's name and power limit, then as
its last line one JSON object of every measurement.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import re
import sys
from pathlib import Path

import chip_smoke as cs


# The wrapper's own parameter list, plan leaves and instantiated shapes,
# which use_sources cuts down to what an older source reads.
_WRAPPER = {}


def use_sources(csrc: Path, bindings: dict, phases: dict) -> None:
    """Point the build at ``csrc`` and the bindings at what its sources
    take: the shared bytes in ``dims`` where the C entry reads them, a
    phase-clock build where the kernel marks its phases, the parameters
    and plan leaves its ``fused_common.cuh`` reads, and the arms
    instantiations of K1 to K3 and K5 where their sources have them."""
    from paxos_tpu_torch.kernels import build, int32_ceiling
    from paxos_tpu_torch.kernels import fused_tick as tf

    if not _WRAPPER:
        _WRAPPER.update(
            params=tf._kernel_params, plan=tf._PLAN_LEAVES, shapes=dict(tf.KERNEL_SHAPES)
        )
    common = (csrc / "fused_common.cuh").read_text()
    n_params = int(re.search(r"constexpr int kParams = (\d+);", common).group(1))
    found = re.search(r"constexpr int kPlanLeaves = (\d+);", common)
    n_plan = int(found.group(1)) if found else 6
    tf._kernel_params = lambda *a: _WRAPPER["params"](*a)[:n_params]
    tf._PLAN_LEAVES = _WRAPPER["plan"][:n_plan]
    tf.KERNEL_SHAPES.update(_WRAPPER["shapes"])
    build.CSRC = csrc
    tf._entries.clear()
    int32_ceiling._fn = None
    for protocol, binding in bindings.items():
        src = (csrc / f"{binding.kernel}.cu").read_text()
        staged = "const int smem = dims[" in src
        staging = binding.staging if staged else None
        if binding.arms is not None and not re.search(r"dims\[\d\] == R_", src):
            # A kernel without the arms: its default instantiations, keyed
            # by shape (the arms flag is the key's last field).
            staging = staging and {k[:-1]: v for k, v in staging.items() if k[-1] == 0}
            tf.KERNEL_SHAPES[protocol] = tuple(
                k[:-1] for k in _WRAPPER["shapes"][protocol] if k[-1] == 0
            )
            binding = dataclasses.replace(binding, arms=None)
        tf.BINDINGS[protocol] = dataclasses.replace(binding, staging=staging)
        if protocol in phases and "clk.mark(" in src:
            tf.PHASES[protocol] = phases[protocol]
        else:
            tf.PHASES.pop(protocol, None)


def prebuild(paths: list) -> None:
    """Every build the paths need from the current sources, in parallel."""
    from paxos_tpu_torch.kernels import build
    from paxos_tpu_torch.kernels import fused_tick as tf

    builds = []
    for path in paths:
        if path == "ceiling":
            builds.append(("int32_ceiling", ()))
            continue
        protocol = cs.MAIN_PATHS[path].protocol
        kernel = tf.BINDINGS[protocol].kernel
        builds += [(kernel, ()), (kernel, tf.COUNT_DRAWS)]
        if protocol in tf.PHASES:
            builds.append((kernel, tf.PHASE_CLOCKS))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda nd: build.build(*nd), sorted(set(builds))))


def measure(variant: str, path: str) -> dict:
    from paxos_tpu_torch.kernels import build
    from paxos_tpu_torch.kernels import fused_tick as tf

    if path == "ceiling":
        out = cs.phase_ceiling()
        return {"ms": out["ms"], "ptxas": build.ptxas_report("int32_ceiling").splitlines()}
    mp = cs.MAIN_PATHS[path]
    kernel = tf.BINDINGS[mp.protocol].kernel
    cfg = cs.main_config(path, cs.FULL_LANES, 7)
    kw = dict(reps=5, ceiling=cs.INT32_OPS_PER_S, census=mp.census, compact=mp.compact)
    steady = cs.compare(f"{variant} {path} steady", cfg, cs.main_plan(cfg), 64, **kw)
    out = {
        "ms": steady["ms"],
        "draws_per_lane_tick": steady["draws_per_lane_tick"],
        "phase_split": steady.get("phase_split"),
        "bound_ms": steady["bound_ms"],
    }
    if not mp.compact:
        first = cs.compare(
            f"{variant} {path} first chunk", cfg, cs.main_plan(cfg), 64, from_init=True, **kw
        )
        out.update(
            first_ms=first["ms"], first_draws_per_lane_tick=first["draws_per_lane_tick"],
            first_phase_split=first.get("phase_split"),
        )
    out["load_store_ms"] = cs.time_load_store(path)
    main = cs.phase_main_path(path)
    out.update(main_path_wall_s=main["wall_s"], main_path_walls_s=main["walls_s"])
    keys = ("entry function", "registers", "spill")
    out["ptxas"] = [
        ln.strip() for ln in build.ptxas_report(kernel).splitlines() if any(k in ln for k in keys)
    ]
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="NAME=DIR, a directory of kernel sources")
    ap.add_argument("--paths", nargs="+", default=["fastpaxos", "raftcore"],
                    help=f"main paths ({', '.join(cs.MAIN_PATHS)}) or 'ceiling'")
    ap.add_argument("--rounds", type=int, default=1, help="A B B A rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.log("no CUDA device: torch.cuda.is_available() is False")
        return 1
    from paxos_tpu_torch.kernels import fused_tick as tf

    variants = [(v.split("=", 1)[0], Path(v.split("=", 1)[1]).resolve()) for v in args.variants]
    bindings, phases = dict(tf.BINDINGS), dict(tf.PHASES)
    order = (variants + variants[::-1]) * args.rounds
    results = []
    for k, (name, csrc) in enumerate(order):
        use_sources(csrc, bindings, phases)
        prebuild(args.paths)
        for path in args.paths:
            got = measure(name, path)
            results.append({"variant": name, "turn": k, "path": path, **got})
            cs.log(f"ab: {name} {path}: " + json.dumps({x: y for x, y in got.items() if x != "ptxas"}))
            for ln in got["ptxas"]:
                cs.log(f"ab: {name} ptxas: {ln}")
    card = cs.card_line()
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
