"""PyTorch/CUDA port of the DynamicAdaptiveClimb reproduction.

A second package beside the JAX reference (``src/repro``), written for an
NVIDIA H100.  Its subpackages mirror the reference name for name, so each
port module has exactly one reference module; it imports ``torch`` and
numpy, never ``jax`` and nothing of the reference package.

Conventions:

* policy state is a dict of tensors with a leading lane axis ``[B, ...]``
  (the reference's ``vmap`` written out);
* every entry point takes an explicit ``device`` and runs on ``"cuda"``
  unless the caller passes ``device="cpu"``; on the CPU each kernel wrapper
  runs its plain PyTorch version, on a CUDA tensor it launches the kernel;
* trace data comes from numpy ``Generator`` s with explicit seeds.

Ported so far:

* the paper's trace replay: ``make_policy`` -> ``Engine.replay`` -> miss
  ratios -> ``mrr`` against FIFO, for Climb, AdaptiveClimb and
  DynamicAdaptiveClimb (hand-written Hopper kernel
  ``kernels/csrc/policy_step.cu``) and the twelve slot policies (plain
  torch; on CUDA their time loop is a CUDA graph of a chunk of steps);
* the sweep and report layer (``bench``: ``Scenario``, ``Sweep``,
  ``run_sweep``, the MRR tables) and the trace registry and real-trace
  ingestion (``data``), so the paper's Table III runs on the card;
* serving of the dense attention LMs (``configs``, ``models``,
  ``serving``, ``launch.serve``): prefill and decode with an unbounded KV
  cache or the DAC-bounded slot pool, attention on the hand-written
  kernels ``kernels/csrc/flash_attention.cu`` (prefill) and
  ``kernels/csrc/decode_attention.cu`` (decode, with the per-slot mass
  that is DAC's hit signal).
"""
