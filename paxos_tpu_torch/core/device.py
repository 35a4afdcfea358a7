"""Device resolution for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
There is no silent fallback: asking for CUDA on a machine without a GPU
raises, and only an explicit ``device="cpu"`` selects the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must actually exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paxos_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' to "
            "run the plain PyTorch reference"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
