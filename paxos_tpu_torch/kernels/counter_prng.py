"""Counter-based stateless PRNG (counterpart of
``paxos_tpu/kernels/counter_prng.py``), bit for bit.

A murmur3-finalizer hash of (seed, stream, element position).  The plain
version computes in int64 holding uint32 values: every product is taken
mod 2^32 without ever overflowing int64 (:func:`_mul32`), so shifts are
logical and nothing relies on integer wraparound.  Results convert to int32
bit patterns only at the end.

Stream identity: a mask of shape ``(..., n_inst)`` is hashed as if its last
axis were the stream block (``block``, default the whole axis): element
``(prefix, i)`` hashes position ``prefix * block + i % block`` under the
per-lane seed ``mix(seed, tick, blk0 + i // block)``.  One call therefore
draws the masks of every stream block at once, exactly as the reference
draws them one block at a time.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
STREAM_SALT_MULT = 0x9E3779B9


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for uint32-valued int64 ``x`` (tensor or int),
    split in 16-bit halves so no intermediate exceeds 2^49."""
    c &= M32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _u32(x):
    """uint32 value (int64 tensor or int) of an int32 / int / tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32-valued int64 -> int32 tensor with the same bit pattern."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def mix_u32(seed, tick, block):
    """splitmix32-style hash -> per-(seed, tick, block) stream seed, as a
    uint32 value.  Arguments may be ints or tensors (broadcast)."""
    h = (
        _mul32(_u32(seed), 0x9E3779B1)
        + _mul32(_u32(tick), 0x85EBCA77)
        + _mul32(_u32(block), 0xC2B2AE3D)
        + 0x165667B1
    ) & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    return h ^ (h >> 15)


def mix(seed, tick, block) -> torch.Tensor:
    """int32 stream seed, bit-identical to the reference's ``mix``."""
    h = mix_u32(seed, tick, block)
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64)
    return to_i32(h)


def lane_seeds(seed, tick, blk0, n_inst: int, block: int, device=None):
    """(n_inst,) uint32-valued int64: each lane's stream seed for ``tick``.

    Lane ``i`` belongs to stream block ``blk0 + i // block``; ``tick`` may
    be a 0-d tensor (no host sync)."""
    if n_inst % block:
        raise ValueError(f"block={block} does not divide n_inst={n_inst}")
    if device is None and isinstance(tick, torch.Tensor):
        device = tick.device
    blocks = blk0 + torch.arange(n_inst // block, dtype=torch.int64, device=device)
    return mix_u32(seed, tick, blocks).repeat_interleave(block)


def stream_salt(stream: int) -> int:
    """The uint32 salt ``counter_bits`` adds for stream ``stream``."""
    return (STREAM_SALT_MULT * (stream + 1)) & M32


def _position(shape, block: int, device) -> torch.Tensor:
    """int64 hash position of every element: ``prefix * block + i % block``."""
    lead, n = tuple(shape[:-1]), shape[-1]
    if n % block:
        raise ValueError(f"block={block} does not divide the last axis {n}")
    prefix = torch.arange(math.prod(lead), dtype=torch.int64, device=device)
    lane = torch.arange(n, dtype=torch.int64, device=device) % block
    return (prefix[:, None] * block + lane[None, :]).reshape(shape)


def counter_u32(seed, stream: int, shape, block=None, device=None):
    """Uniform uint32 bits (as int64) = hash of (seed, stream, position).

    ``seed`` is an int, a 0-d tensor, or a per-lane ``(shape[-1],)``
    tensor of stream seeds broadcast over the leading axes."""
    if isinstance(seed, torch.Tensor):
        device = seed.device
    block = shape[-1] if block is None else block
    x = (_position(shape, block, device) + stream_salt(stream)) & M32
    x = x ^ _mul32(_u32(seed), 0x85EBCA6B)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_bits(seed, stream: int, shape, block=None, device=None):
    """int32 bits, bit-identical to the reference's ``counter_bits``."""
    return to_i32(counter_u32(seed, stream, shape, block, device))


def bern_threshold(p: float) -> int:
    """uint32 threshold t with P(bits < t) = ``p``, rounded on the host with
    Python ``round`` (half to even) like the reference."""
    return min(int(round(p * float(1 << 32))), (1 << 32) - 1)


def bern(seed, stream: int, shape, p: float, block=None, device=None):
    """bool, True w.p. ``p``; None when ``p <= 0``; all True when ``p >= 1``."""
    if p <= 0.0:
        return None
    if isinstance(seed, torch.Tensor):
        device = seed.device
    if p >= 1.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    bits = counter_u32(seed, stream, shape, block, device)
    return bits < bern_threshold(p)


def bern_not(seed, stream: int, shape, p: float, block=None, device=None):
    """bool, True w.p. ``1 - p``; None when ``p <= 0``."""
    m = bern(seed, stream, shape, p, block, device)
    return None if m is None else ~m


def randint(seed, stream: int, shape, n: int, block=None, device=None):
    """int32 in [0, n): non-negative bits modulo the (small) range."""
    bits = counter_u32(seed, stream, shape, block, device)
    return ((bits & 0x7FFFFFFF) % max(n, 1)).to(torch.int32)
