"""The port's counter PRNG and bit helpers against the JAX package, bit for bit.

Inputs are made with numpy from fixed seeds and handed to both packages;
every comparison is exact (tolerance 0: all values are int32 or bool).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paxos_tpu.core import ballot as jballot
from paxos_tpu.faults import injector as jinj
from paxos_tpu.kernels import counter_prng as jcp
from paxos_tpu.kernels import quorum as jquorum
from paxos_tpu.utils import bitops as jbitops
from paxos_tpu_torch.core import ballot as tballot
from paxos_tpu_torch.faults import injector as tinj
from paxos_tpu_torch.kernels import counter_prng as tcp
from paxos_tpu_torch.kernels import quorum as tquorum
from paxos_tpu_torch.utils import bitops as tbitops
from _torch_jax import one_core, one_torch_thread  # noqa: F401  (autouse)

RNG_SEED = 20261016


def _i32(rng, shape):
    return rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64).astype(np.int32)


def _eq(jx, tx):
    np.testing.assert_array_equal(np.asarray(jax.device_get(jx)), tx.numpy())


def test_mix_matches():
    rng = np.random.default_rng(RNG_SEED)
    seed, tick, blk = (_i32(rng, (257,)) for _ in range(3))
    want = jcp.mix(jnp.asarray(seed), jnp.asarray(tick), jnp.asarray(blk))
    got = tcp.mix(torch.from_numpy(seed), torch.from_numpy(tick), torch.from_numpy(blk))
    assert got.dtype == torch.int32
    _eq(want, got)


@pytest.mark.parametrize(
    "shape", [(7,), (3, 128), (2, 2, 5, 256), (1, 1, 5, 64), (2, 1, 3, 96)]
)
def test_counter_bits_matches(shape):
    rng = np.random.default_rng(RNG_SEED + len(shape))
    for seed in _i32(rng, (3,)):
        for stream in (0, 4, 9, 15):
            want = jcp.counter_bits(jnp.int32(seed), stream, shape)
            got = tcp.counter_bits(int(seed), stream, shape)
            _eq(want, got)


def test_counter_bits_per_lane_blocks():
    """One call over 4 stream blocks equals the reference drawn per block
    under each block's own seed, concatenated along the lane axis."""
    rng = np.random.default_rng(RNG_SEED + 1)
    block, n_blocks = 128, 4
    seeds = _i32(rng, (n_blocks,))
    lane_seed = torch.from_numpy(np.repeat(seeds, block))
    shape = (2, 2, 5, block * n_blocks)
    got = tcp.counter_bits(lane_seed, 3, shape, block=block)
    want = np.concatenate(
        [
            np.asarray(jcp.counter_bits(jnp.int32(s), 3, shape[:-1] + (block,)))
            for s in seeds
        ],
        axis=-1,
    )
    np.testing.assert_array_equal(want, got.numpy())


def test_lane_seeds_match_mix_per_block():
    seed, tick, blk0, block, n = -123457, 77, 3, 64, 256
    got = tcp.to_i32(tcp.lane_seeds(seed, torch.tensor(tick, dtype=torch.int32), blk0, n, block))
    want = np.concatenate([
        np.full(block, int(jcp.mix(jnp.int32(seed), jnp.int32(tick), jnp.int32(blk0 + b))))
        for b in range(n // block)
    ])
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0, 0.2, 0.999999])
def test_bern_and_bern_not(p):
    shape = (2, 2, 5, 128)
    for seed in (0, 7, -5):
        for fn_j, fn_t in ((jcp.bern, tcp.bern), (jcp.bern_not, tcp.bern_not)):
            want = fn_j(jnp.int32(seed), 5, shape, p)
            got = fn_t(seed, 5, shape, p)
            if want is None:
                assert got is None
            else:
                assert got.dtype == torch.bool
                _eq(want, got)


@pytest.mark.parametrize("n", [1, 5, 8, 33])
def test_randint_matches(n):
    for seed in (1, -99):
        _eq(jcp.randint(jnp.int32(seed), 9, (2, 256), n), tcp.randint(seed, 9, (2, 256), n))


def test_popcount_and_quorum_match():
    rng = np.random.default_rng(RNG_SEED + 2)
    x = _i32(rng, (4, 300))
    x[0, :5] = [0, -1, 1 << 31 - 1, -(1 << 31), 31]
    _eq(jbitops.popcount(jnp.asarray(x)), tbitops.popcount(torch.from_numpy(x)))
    for n_acc in range(1, 8):
        assert tquorum.majority(n_acc) == jquorum.majority(n_acc)
    heard = rng.integers(0, 32, (2, 300)).astype(np.int32)
    for q in (1, 3, 5):
        _eq(
            jquorum.quorum_reached(jnp.asarray(heard), q),
            tquorum.quorum_reached(torch.from_numpy(heard), q),
        )


def test_ballots_match():
    rng = np.random.default_rng(RNG_SEED + 3)
    bal = rng.integers(-20, 5000, (500,)).astype(np.int32)
    _eq(jballot.ballot_round(jnp.asarray(bal)), tballot.ballot_round(torch.from_numpy(bal)))
    rnd = rng.integers(0, 4000, (2, 50)).astype(np.int32)
    pid = np.broadcast_to(np.arange(2, dtype=np.int32)[:, None], (2, 50)).copy()
    _eq(
        jballot.make_ballot(jnp.asarray(rnd), jnp.asarray(pid)),
        tballot.make_ballot(torch.from_numpy(rnd), torch.from_numpy(pid)),
    )
    assert tballot.MAX_PROPOSERS == jballot.MAX_PROPOSERS


def test_rate_threshold_and_bits_below_match():
    rates = np.array([-0.5, 0.0, 1e-9, 0.1, 0.25, 0.5, 0.999, 1.0, 1.5], np.float32)
    _eq(jinj.rate_threshold(jnp.asarray(rates)), tinj.rate_threshold(torch.from_numpy(rates)))
    rng = np.random.default_rng(RNG_SEED + 4)
    bits, thr = _i32(rng, (1000,)), _i32(rng, (1000,))
    _eq(
        jinj.bits_below(jnp.asarray(bits), jnp.asarray(thr)),
        tinj.bits_below(torch.from_numpy(bits), torch.from_numpy(thr)),
    )
    assert tinj.NEVER == int(jinj.NEVER)
