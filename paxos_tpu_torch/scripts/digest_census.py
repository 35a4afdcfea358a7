"""How much of the coverage digest a prefix cache would have to refold.

The coverage digest (``obs/coverage.lane_digest``) is an FNV-1a fold of a
lane's state words in the reference's leaf order, once a tick.  A cache of
the chain's value at each word would let a tick refold only from the first
word that changed.  This census runs the plain Multi-Paxos tick on the CPU
one tick at a time and reports, over every lane-tick of a window of ticks,
the share of the digest's words from the first changed one to the end:
what such a cache would still fold.  The long log is compacted every 64
ticks (after ticks 64, 128, ...), as its main path compacts after every
chunk.

    python -m paxos_tpu_torch.scripts.digest_census --config config3long
    python -m paxos_tpu_torch.scripts.digest_census --config config3 --lanes 512
"""

from __future__ import annotations

import argparse

import torch

from paxos_tpu_torch.harness import config as C
from paxos_tpu_torch.harness.np_plan import config_plan
from paxos_tpu_torch.harness.run import init_state
from paxos_tpu_torch.kernels import fused_tick
from paxos_tpu_torch.obs.coverage import digest_tree
from paxos_tpu_torch.protocols.multipaxos import compact_mp_body

CONFIGS = {"config3": C.config3_multipaxos, "config3long": C.config3_long}
CHUNK = 64


def digest_words(state) -> torch.Tensor:
    """(W, I) int64: the words the digest folds, in its order."""
    leaves = digest_tree(state)
    return torch.cat([leaf.reshape(-1, state.n_inst).to(torch.int64) for leaf in leaves])


def refold_share(config: str, lanes: int, seed: int, start: int, stop: int) -> dict:
    """Over ticks [start, stop): the words a lane's digest folds, the mean
    share of them from a tick's first changed word on, and the share of
    lane-ticks that changed no word."""
    cfg = CONFIGS[config](lanes, seed)
    plan = config_plan(cfg, seed, "cpu")
    state, compact = init_state(cfg, "cpu"), cfg.fault.log_total != 0
    block = fused_tick.fit_block(fused_tick.BINDINGS["multipaxos"].block, lanes)
    refold = torch.zeros(lanes, dtype=torch.float64)
    unchanged, words = 0, 0
    for t in range(stop):
        if compact and t and t % CHUNK == 0:
            state = compact_mp_body(state)[0]
        before = digest_words(state) if t >= start else None
        state = fused_tick.fused_multipaxos_chunk(state, cfg.seed, plan, cfg.fault, 1, block=block)
        if before is None:
            continue
        after = digest_words(state)
        words = after.shape[0]
        changed = before != after
        first = torch.where(changed.any(0), changed.to(torch.int8).argmax(0), torch.tensor(words))
        refold += (words - first).to(torch.float64) / words
        unchanged += int((~changed.any(0)).sum())
    lane_ticks = lanes * (stop - start)
    return {
        "config": config, "lanes": lanes, "seed": seed, "ticks": [start, stop], "words": words,
        "refold_share": float(refold.sum() / lane_ticks), "unchanged_share": unchanged / lane_ticks,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="config3long")
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--start", type=int, default=64)
    ap.add_argument("--stop", type=int, default=256)
    args = ap.parse_args(argv)
    out = refold_share(args.config, args.lanes, args.seed, args.start, args.stop)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
