"""On-device coverage sketch (counterpart of ``paxos_tpu/obs/coverage.py``;
default off): every lane hashes its post-tick protocol state into a
per-lane Bloom bitmap, so a campaign reports how much distinct state it
visited.

The digest depends only on the lane's protocol state (not on the lane or
the tick), so the OR of the lanes' bitmaps is the Bloom filter of the union
of every visited state, and :func:`bloom_estimate` turns its fill into a
distinct-state estimate.  :func:`observe` draws nothing.

The plain version computes in int64 holding uint32 values (products mod
2^32 through ``counter_prng``'s 16-bit split), as the counter PRNG does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from paxos_tpu_torch.kernels.counter_prng import M32, _mul32, to_i32

K_HASHES = 2
# Per-hash xor salts.
_H_SALTS = (0x2545F491, 0x8B7F1C35)
# Leaf-mix and finalizer multipliers (FNV and splitmix32).
_FNV_BASIS = 0x811C9DC5
_FNV_PRIME = 0x01000193
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B

# The state fields the digest hashes, in this order (fields a protocol
# lacks are skipped): the protocol state, without the learner's accounting
# (chosen_tick is tick-dependent) and without the observers.
_DIGEST_FIELDS = (
    "acceptor", "proposer", "requests", "replies", "promises", "accepted", "base",
)


@dataclasses.dataclass(frozen=True)
class CoverageConfig:
    """``words``: the per-lane bitmap in int32 words, a power of two (0:
    the plane is off)."""

    words: int = 0

    def __post_init__(self):
        if self.words < 0:
            raise ValueError(f"coverage words must be >= 0, got {self.words}")
        if self.words and self.words & (self.words - 1):
            raise ValueError(f"coverage words must be a power of two, got {self.words}")

    def enabled(self) -> bool:
        return self.words > 0

    def bits(self) -> int:
        return 32 * self.words


@dataclasses.dataclass
class CoverageState:
    bitmap: torch.Tensor  # (W, I) int32 Bloom bit words
    new_bits: torch.Tensor  # (I,) int32 bits newly set, cumulative

    @classmethod
    def init(cls, n_inst: int, ccfg: CoverageConfig, device="cpu") -> "CoverageState":
        return cls(
            bitmap=torch.zeros((ccfg.words, n_inst), dtype=torch.int32, device=device),
            new_bits=torch.zeros((n_inst,), dtype=torch.int32, device=device),
        )

    def leaves(self) -> list:
        return [self.bitmap, self.new_bits]


def digest_tree(state) -> list:
    """The leaves the digest hashes, in the reference's flatten order:
    those of the ``_DIGEST_FIELDS`` sub-states the state has (snapshot
    shadows and delay stamps included where present)."""
    out = []
    for name in _DIGEST_FIELDS:
        part = getattr(state, name, None)
        if part is None:
            continue
        out.extend(part.leaves() if hasattr(part, "leaves") else [part])
    return out


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def _finalize(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 15)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def lane_digest(leaves: list) -> torch.Tensor:
    """(I,) int32 hash of every leaf's per-lane values: an FNV-1a-style fold
    over the leaves in order and each leaf's rows in row-major order (bools
    as 0 and 1), then a splitmix32 finalizer."""
    if not leaves:
        raise ValueError("lane_digest needs at least one leaf")
    n_inst = leaves[0].shape[-1]
    rows = torch.cat([_u32(leaf.reshape(-1, n_inst)) for leaf in leaves])
    h = torch.full((n_inst,), _FNV_BASIS, dtype=torch.int64, device=rows.device)
    for r in range(rows.shape[0]):
        h = _mul32(h ^ rows[r], _FNV_PRIME)
    return to_i32(_finalize(h))


def _hash_pos(digest: torch.Tensor, j: int, m: int) -> torch.Tensor:
    """Bloom hash ``j`` of a digest: a bit position in [0, m), m = 2^p."""
    x = _u32(digest) ^ _H_SALTS[j]
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    x = x ^ (x >> 16)
    return x & (m - 1)


def observe(cov: CoverageState, state) -> CoverageState:
    """Fold the lane's post-tick ``state`` into its sketch: set the digest's
    ``K_HASHES`` bits, and add the bits newly set to ``new_bits``."""
    digest = lane_digest(digest_tree(state))
    words = cov.bitmap.shape[0]
    rows = torch.arange(words, device=digest.device)[:, None]
    bitmap = _u32(cov.bitmap)
    for j in range(K_HASHES):
        pos = _hash_pos(digest, j, 32 * words)
        bitmap = bitmap | torch.where(rows == (pos >> 5)[None], (1 << (pos & 31))[None], 0)
    newly = _popcount64(bitmap ^ _u32(cov.bitmap)).sum(dim=0, dtype=torch.int32)
    return CoverageState(bitmap=to_i32(bitmap), new_bits=cov.new_bits + newly)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of uint32-valued int64s."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


# ---- Bloom math (host) ----


def bloom_estimate(m: int, k: int, bits_set: int) -> Optional[float]:
    """Distinct-insert estimate -(m/k) ln(1 - X/m); None when saturated."""
    if bits_set >= m:
        return None
    if bits_set <= 0:
        return 0.0
    return -(m / k) * math.log(1.0 - bits_set / m)


def bloom_bound(m: int, k: int, n: int, z: float = 4.0) -> float:
    """Confidence band (+-) on :func:`bloom_estimate` after n true inserts."""
    q = math.exp(-k * n / m)
    std_bits = math.sqrt(m * q * (1.0 - q))
    return z * std_bits / (k * q) + 2.0


def host_finalize(h: int) -> int:
    h &= M32
    h ^= h >> 16
    h = (h * _MIX1) & M32
    h ^= h >> 15
    h = (h * _MIX2) & M32
    h ^= h >> 16
    return h


def host_hash_pos(digest: int, j: int, m: int) -> int:
    """Python-int mirror of the Bloom hash ``j``."""
    x = (digest & M32) ^ _H_SALTS[j]
    x = (x * _MIX1) & M32
    x ^= x >> 15
    x = (x * _MIX2) & M32
    x ^= x >> 16
    return x & (m - 1)


def host_sketch_positions(values, words: int) -> set:
    """The bit positions a sketch of ``words`` words sets for the digests."""
    m = 32 * words
    return {host_hash_pos(int(v), j, m) for v in values for j in range(K_HASHES)}


def host_sketch_estimate(values, words: int) -> Optional[float]:
    """Bloom estimate of ``len(set(values))`` from the exact host sketch."""
    return bloom_estimate(32 * words, K_HASHES, len(host_sketch_positions(values, words)))


# ---- The report ----


def coverage_device(cov: CoverageState) -> dict:
    """Device half of the report: the lanes' OR (the union Bloom filter,
    the one place the plane mixes lanes), its set bits, the lanes' set
    bits and the new bits."""
    bits = _u32(cov.bitmap)
    union = torch.zeros_like(bits[:, 0])
    for b in range(32):  # OR over lanes, a bit at a time
        union |= ((bits >> b) & 1).amax(dim=1) << b
    return {
        "union_bits": _popcount64(union).sum(),
        "union_words": union,
        "lane_bits": _popcount64(bits).sum(),
        "new_bits": cov.new_bits.sum(dtype=torch.int64),
    }


def union_hex(words_arr) -> str:
    """The union bitmap as one hex integer (OR two of them: the union of
    two runs' visited sets)."""
    u = 0
    for i, w in enumerate(words_arr):
        u |= (int(w) & M32) << (32 * i)
    return f"{u:x}"


def coverage_host(host: dict, words: int) -> dict:
    """Format the fetched :func:`coverage_device` dict."""
    m = 32 * words
    bits_set = int(host["union_bits"])
    est = bloom_estimate(m, K_HASHES, bits_set)
    return {
        "bits_set": bits_set,
        "bits_total": m,
        "words": words,
        "hashes": K_HASHES,
        "saturation": round(bits_set / m, 6) if m else 0.0,
        "est_states": None if est is None else round(est, 1),
        "lane_bits": int(host["lane_bits"]),
        "new_bits": int(host["new_bits"]),
        "union_hex": union_hex(host["union_words"]),
    }
