#!/usr/bin/env python3
"""Same-call A/B timing of the fused kernels' sources on one GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_ab.py parent=DIR new=paxos_tpu_torch/kernels/csrc \\
        [--paths fastpaxos raftcore] [--rounds 1] [--planes]

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

The path ``ceiling`` times K6 (``phase_ceiling``) instead.  With
``--ptxas`` it times nothing: it builds every kernel (default build) of
each variant, all in parallel, and prints whether each instantiation's
``ptxas -v`` lines (registers, stack, spills) are the first variant's,
the instantiations matched by their mangled names without the
anonymous namespace's per-build hash.  With
``--planes`` each path runs with every observer plane on
(``chip_smoke.obs_planes``), as a path ``observed-<path>`` (its kernel's
observed instantiation; the planes move no schedule, so its eviction pins
are the path's own).  A source whose
C entry takes no shared bytes (a kernel before its column redesign) is
launched without them; sources from before the gray-failure and partition
arms get the parameters and plan leaves their ``fused_common.cuh`` reads
(``kParams``, ``kPlanLeaves``), a kernel without its arms its default
instantiations only, and a kernel without its bounded-delay channel its
unstamped ones only, and a kernel without its observed instantiations its
other ones, keyed without the flag (and its phase list without the
observers phase; a kernel without a phase-clock build, K5 before it had
one, no phase split; an observers phase that the source clocks whole, as
each kernel did before it split it, whole).  A source whose
instantiation table (``K1_INSTANCES`` to ``K5_INSTANCES``) lists another
geometry than the wrapper's (lanes a block, blocks an SM, PROMISE payloads
staged or not), or whose observed columns hold another count of counter
rows (every kernel before it kept most counters in registers: 49), or
whose K5 column holds other lane rows (the arms' link rows, the caps:
every K5 before its arms' and channel's redesign has neither), is
launched at its own (:func:`table_staging`), so that two
geometries of one kernel, or a parent and its redesign, compare in one
call.  Prints the card's name and
power limit, then as its last line one JSON object of every measurement.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


# The wrapper's own parameter list, plan leaves and instantiated shapes,
# which use_sources cuts down to what an older source reads.
_WRAPPER = {}
# The instantiation table of each kernel whose geometry a source may change.
_TABLES = {"paxos": "K1", "fastpaxos": "K2", "raftcore": "K3", "synchpaxos": "K4", "multipaxos": "K5"}


def table_staging(protocol: str, src: str, staging: dict) -> dict:
    """``staging`` (the wrapper's geometry of ``protocol``'s kernel) with
    each instantiation at the lanes a block, blocks an SM (K1 to K4) or
    PROMISE staging (K5) that the source's table lists, where the table has
    this commit's fields: ``X(P, A, K, STAMPED, ARMS, B, MIN_BLOCKS)``,
    K5's ``X(P, A, L, K, STAMPED, ARMS, B, PROM)`` (each with OBSERVED
    after ARMS where the source has observed instantiations), and the
    counter rows of the source's observed columns."""
    from paxos_tpu_torch.kernels import fused_tick as tf

    found = re.search(rf"#define {_TABLES[protocol]}_INSTANCES\(X\)(.*?)\n\n", src, re.S)
    if found is None:
        return staging
    rows = re.findall(r"X\(([\w, ]+)\)", found.group(1))
    # An observed column holds every plane counter unless the source keeps
    # most of them in registers (obs::Tally: K1 to K5 do).
    if "obs::Tally" in src:
        counter_rows = tf.tally_obs_rows
    else:
        counter_rows = lambda n_prop, arms=False: tf.obs_rows(n_prop)  # noqa: E731
    # K5's column stages the arms' per-link thresholds where its kernel has
    # LINKS and the links' caps where its column has a kCaps row (an older
    # source does neither).
    lanes = dict(links="bool LINKS" in src, caps="kCaps" in src)
    out = dict(staging)
    for row in rows:
        fields = [f.strip() for f in row.split(",")]
        if protocol == "multipaxos" and len(fields) in (8, 9):  # keys may end in `observed`
            n_key = len(fields) - 2
            key, threads = tuple(map(int, fields[:n_key])), int(fields[n_key])
            if key in out:
                out[key] = tf._mp_staging(
                    key, threads, fields[n_key + 1] == "true", counter_rows, **lanes
                )
        elif protocol != "multipaxos" and len(fields) in (7, 8):  # keys may end in `observed`
            n_key = len(fields) - 2
            key, threads = tuple(map(int, fields[:n_key])), int(fields[n_key])
            if key in out and protocol == "synchpaxos":
                out[key] = tf._sp_staging(key, threads, int(fields[n_key + 1]), counter_rows)
            elif key in out:
                out[key] = tf._fr_staging(protocol, key, threads, int(fields[n_key + 1]), counter_rows)
    return out


def use_sources(csrc: Path, bindings: dict, phases: dict) -> None:
    """Point the build at ``csrc`` and the bindings at what its sources
    take: the shared bytes in ``dims`` where the C entry reads them, a
    phase-clock build where the kernel marks its phases, the parameters
    and plan leaves its ``fused_common.cuh`` reads, the arms instantiations
    where a kernel's source has them, and K1's stamped ones where its source
    has them."""
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
        if binding.observed and not re.search(r"dims\[\d\] == O_", src):
            # A kernel without its observed instantiations (an older K1, K2
            # or K3): keyed without the flag, its C entry without the
            # observer arguments.
            staging = staging and {k[:-1]: v for k, v in staging.items() if k[-1] == 0}
            tf.KERNEL_SHAPES[protocol] = tuple(
                k[:-1] for k in tf.KERNEL_SHAPES[protocol] if k[-1] == 0
            )
            binding = dataclasses.replace(binding, observed=False)
        if "stamped" in binding.shape_fields and not re.search(r"dims\[\d\]( != 0\))? == S_", src):
            # A kernel without the stamps flag (K1 before its bounded-delay
            # channel): its unstamped instantiations, keyed without the flag.
            at = binding.shape_fields.index("stamped")
            staging = staging and {
                k[:at] + k[at + 1:]: v for k, v in staging.items() if k[at] == 0
            }
            tf.KERNEL_SHAPES[protocol] = tuple(
                k[:at] + k[at + 1:] for k in tf.KERNEL_SHAPES[protocol] if k[at] == 0
            )
            binding = dataclasses.replace(
                binding, shape_fields=tuple(f for f in binding.shape_fields if f != "stamped")
            )
        if binding.arms is not None and not re.search(r"dims\[\d\] == R_", src):
            # A kernel without the arms: its default instantiations, keyed
            # by shape (the arms flag is the key's last field).
            staging = staging and {k[:-1]: v for k, v in staging.items() if k[-1] == 0}
            tf.KERNEL_SHAPES[protocol] = tuple(
                k[:-1] for k in tf.KERNEL_SHAPES[protocol] if k[-1] == 0
            )
            binding = dataclasses.replace(binding, arms=None)
        if staging and protocol in _TABLES:
            staging = table_staging(protocol, src, staging)
        tf.BINDINGS[protocol] = dataclasses.replace(binding, staging=staging)
        if protocol in phases and "clk.mark(" in src:
            tf.PHASES[protocol] = source_phases(src, phases[protocol])
        else:
            tf.PHASES.pop(protocol, None)


def source_phases(src: str, phases: tuple) -> tuple:
    """The phases a kernel source clocks: the names its ``Phase`` enum
    gives them (one comment an entry), or, where it names none, ``phases``
    as it marks them (the observers phase of K1 to K5 whole where the
    source had not split it, ``fused_tick.OBSERVER_SPLIT``; no observers
    phase where it has none)."""
    from paxos_tpu_torch.kernels import fused_tick as tf

    body = re.search(r"enum Phase \{(.*?)\};", src, re.S)
    names = re.findall(r"kPh\w+,\s*// (.+)", body.group(1)) if body else []
    if names:
        return tuple(name.strip() for name in names)
    out = []
    for ph in phases:
        ph = "observers" if ph in tf.OBSERVER_SPLIT else ph
        if (ph != "observers" or "kPhObs" in src) and ph not in out:
            out.append(ph)
    return tuple(out)


def observed_path(path: str) -> str:
    """Main path ``path`` with every observer plane on, registered in
    ``chip_smoke.MAIN_PATHS`` as ``observed-<path>`` (where it is not one
    already) with the path's own eviction pins."""
    name = path if path.startswith("observed-") else f"observed-{path}"
    if name not in cs.MAIN_PATHS:
        cs.MAIN_PATHS[name] = dataclasses.replace(cs.MAIN_PATHS[path], planes=True)
        cs.EVICTION_PINS[name] = cs.EVICTION_PINS[path]
        if path in cs.BLOCK0_DIGESTS:
            cs.BLOCK0_DIGESTS[name] = cs.BLOCK0_DIGESTS[path]
    return name


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


def ptxas_tables(variants: list) -> dict:
    """{variant: {kernel: {instantiation: ptxas lines}}}: every kernel's
    default build from each variant's sources, all built in parallel."""
    from paxos_tpu_torch.kernels import build

    kernels = sorted(p.stem for p in Path(build.CSRC).glob("*.cu"))

    def report(job):
        (name, csrc), kernel = job
        out = subprocess.run(
            [build.nvcc_path(), *build._flags(()), "-o",
             str(build.BUILD_DIR / f"ab_{name}_{kernel}.so"), str(csrc / f"{kernel}.cu")],
            capture_output=True, text=True, check=True,
        )
        table, cur = {}, None
        for line in (out.stdout + out.stderr).splitlines():
            found = re.search(r"entry function '(\S+)'", line)
            if found:
                cur = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "", found.group(1))
                table[cur] = []
            elif cur and ("registers" in line or "spill" in line):
                table[cur].append(line.strip())
        return name, kernel, table

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(v, k) for v in variants for k in kernels]
    out = {name: {} for name, _ in variants}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for name, kernel, table in pool.map(report, jobs):
            out[name][kernel] = table
    return out


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
    steady = cs.compare(
        f"{variant} {path} steady", cfg, cs.main_plan(cfg), 64, first_chunk=not mp.compact, **kw
    )
    out = {
        "ms": steady["ms"],
        "draws_per_lane_tick": steady["draws_per_lane_tick"],
        "phase_split": steady.get("phase_split"),
        "bound_ms": steady["bound_ms"],
    }
    if not mp.compact:
        first = steady["first_chunk"]
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
    ap.add_argument("--planes", action="store_true",
                    help="every observer plane on, each path run as observed-<path>")
    ap.add_argument("--ptxas", action="store_true",
                    help="compare every instantiation's ptxas lines with the first variant's")
    args = ap.parse_args(argv)
    if args.planes:
        args.paths = [observed_path(p) if p != "ceiling" else p for p in args.paths]
    if not torch.cuda.is_available():
        cs.log("no CUDA device: torch.cuda.is_available() is False")
        return 1
    from paxos_tpu_torch.kernels import fused_tick as tf

    variants = [(v.split("=", 1)[0], Path(v.split("=", 1)[1]).resolve()) for v in args.variants]
    if args.ptxas:
        tables = ptxas_tables(variants)
        first, same = variants[0][0], True
        for name, _ in variants[1:]:
            for kernel, table in tables[first].items():
                for inst, lines in table.items():
                    got = tables[name].get(kernel, {}).get(inst)
                    same = same and got == lines
                    cs.log(f"ab ptxas: {kernel} {inst}: {name} {got} {first} {lines} same {got == lines}")
                for inst in tables[name].get(kernel, {}).keys() - table.keys():
                    cs.log(f"ab ptxas: {kernel} {inst}: only in {name}: {tables[name][kernel][inst]}")
        cs.log(f"ab ptxas: every instantiation of {first} the same in every variant: {same}")
        print(json.dumps({"ptxas": tables, "same": same}))
        return 0
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
