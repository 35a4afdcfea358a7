"""paxos_tpu_torch — the PyTorch/CUDA port of the batched Paxos fuzzer.

A second package beside ``paxos_tpu`` (the JAX reference).  The layout
mirrors the reference so every module has an obvious counterpart:

- :mod:`paxos_tpu_torch.core` — ballots, message buffers, role state;
- :mod:`paxos_tpu_torch.kernels` — the counter PRNG, quorum helpers and the
  fused multi-tick engine, whose CUDA kernel lives in ``kernels/csrc``;
- :mod:`paxos_tpu_torch.transport` — select / send / consume over slots;
- :mod:`paxos_tpu_torch.faults` — fault config and plan;
- :mod:`paxos_tpu_torch.check` — the learner as safety oracle;
- :mod:`paxos_tpu_torch.protocols` — the single-decree Paxos tick;
- :mod:`paxos_tpu_torch.harness` — configs, the dispatch loop and ``run``;
- :mod:`paxos_tpu_torch.interop` — state and plan exchange as numpy arrays.

The package imports ``torch`` and ``numpy`` only.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``, which selects the
plain PyTorch versions of every kernel.
"""

__version__ = "0.1.0"
