"""int32 ALU ceiling probe (counterpart of ``vpu_ceiling`` in
``scripts/roofline.py``).

:func:`int32_ceiling` runs ``iters`` iterations of a fixed body of 8
dependent int32 operations per element: on a CUDA tensor through the
hand-written kernel ``csrc/int32_ceiling.cu``, on a CPU tensor through
:func:`ceiling_reference`, its plain PyTorch version.
:func:`int32_ops_per_s` times the kernel at two iteration counts with CUDA
events and divides the work difference by the time difference, as the
reference's ``_delta_time`` does, so launch overhead cancels.  That rate is
the ceiling the fused kernels' operation bounds divide by.
"""

from __future__ import annotations

import ctypes

import torch

OPS_PER_ITER = 8  # the reference's count for one iteration of the body
SHAPE = (256, 16384)  # the reference's (rows, block * grid)
ITERS = (1024, 9216)  # the reference's two iteration counts

_KERNEL = "int32_ceiling"
_fn = None


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the int32 value of its low 32 bits, as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def ceiling_reference(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version: the body of ``scripts/roofline.py:198-203``,
    wrapping as int32 (computed in int64 and wrapped after every step, so
    nothing relies on overflow; ``>>`` is arithmetic)."""
    y = x.to(torch.int64)
    for i in range(iters):
        y = _wrap(y + 0x9E3779B9)
        y = y ^ _wrap(y << 13)
        y = y ^ (y >> 7)
        y = torch.maximum(y, _wrap(y * 5))
        y = _wrap(y + i)
    return y.to(torch.int32)


def _entry():
    global _fn
    if _fn is None:
        from paxos_tpu_torch.kernels import build

        fn = build.load(_KERNEL).int32_ceiling_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def int32_ceiling(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` iterations of the probe body over int32 ``x``, into a new
    tensor.  CUDA: the kernel (``.launches`` counts launches); CPU: the
    plain version.  There is no fallback between the two."""
    if x.dtype != torch.int32:
        raise ValueError(f"the probe takes int32, not {x.dtype}")
    if x.device.type == "cpu":
        return ceiling_reference(x, iters)
    if x.device.type != "cuda" or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("the probe takes a non-empty contiguous CUDA or CPU tensor")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _entry()(x.data_ptr(), out.data_ptr(), x.numel(), iters, stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: cudaError {rc}")
    int32_ceiling.launches += 1
    return out


int32_ceiling.launches = 0


def int32_ops_per_s(reps: int = 5, device="cuda") -> float:
    """Attainable int32 operations per second on the card: the best of
    ``reps`` differences between the kernel's times at the two iteration
    counts, each timed with CUDA events."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the ceiling is a device measurement: pass a CUDA device")
    x = torch.ones(SHAPE, dtype=torch.int32, device=dev)
    k1, k2 = ITERS

    def ms(iters: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        int32_ceiling(x, iters)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)

    ms(k1), ms(k2)  # build, load and warm both
    best = min(ms(k2) - ms(k1) for _ in range(reps))
    if best <= 0:
        raise RuntimeError(f"non-positive time difference {best} ms between {k1} and {k2} iterations")
    return x.numel() * (k2 - k1) * OPS_PER_ITER / (best * 1e-3)
