"""The int32 ceiling probe (K6) against the body of the JAX package's
``vpu_ceiling`` (``scripts/roofline.py:198-203``).

``vpu_ceiling`` builds its Pallas call inline for the TPU, so there is no
JAX function to call on the CPU: the body is restated here in numpy int32
with wrapping arithmetic, and the port's plain version must equal it
exactly.  The kernel itself runs only on a card
(``test_kernel_matches_plain_on_cuda``).
"""

import numpy as np
import pytest
import torch

from paxos_tpu_torch.kernels import int32_ceiling as k6


def numpy_body(x: np.ndarray, iters: int) -> np.ndarray:
    """scripts/roofline.py's loop body in numpy int32 (arrays wrap)."""
    x = x.astype(np.int32)
    for i in range(iters):
        x = x + np.int32(-1640531527)  # 0x9E3779B9 as int32
        x = x ^ (x << np.int32(13))
        x = x ^ (x >> np.int32(7))  # arithmetic shift
        x = np.maximum(x, x * np.int32(5))
        x = x + np.int32(i)
    return x


@pytest.mark.parametrize("iters", [0, 1, 37])
def test_ceiling_reference_matches_numpy_body(iters):
    rng = np.random.default_rng(iters)
    x = rng.integers(-(1 << 31), 1 << 31, (64, 257), dtype=np.int64).astype(np.int32)
    x[0, :4] = [-(1 << 31), (1 << 31) - 1, 0, -1]  # the edges of int32
    with np.errstate(over="ignore"):
        want = numpy_body(x, iters)
    got = k6.ceiling_reference(torch.from_numpy(x), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    x = torch.arange(-50, 50, dtype=torch.int32).reshape(4, 25)
    before = k6.int32_ceiling.launches
    assert torch.equal(k6.int32_ceiling(x, 5), k6.ceiling_reference(x, 5))
    assert k6.int32_ceiling.launches == before
    with pytest.raises(ValueError, match="int32"):
        k6.int32_ceiling(x.to(torch.int64), 5)
    with pytest.raises(ValueError, match="device measurement"):
        k6.int32_ops_per_s(device="cpu")
    assert k6.OPS_PER_ITER == 8 and k6.ITERS == (1024, 9216) and k6.SHAPE == (256, 16384)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernel has no CPU mode")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (256, 1000), dtype=np.int64).astype(np.int32))
    before = k6.int32_ceiling.launches
    got = k6.int32_ceiling(x.cuda(), 64)
    torch.cuda.synchronize()
    assert k6.int32_ceiling.launches == before + 1
    assert torch.equal(got.cpu(), k6.ceiling_reference(x, 64))
    assert k6.int32_ops_per_s(reps=2) > 0
