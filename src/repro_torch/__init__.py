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

The slice ported so far is the paper's trace replay: ``make_policy`` ->
``Engine.replay`` -> miss ratios -> ``mrr`` against FIFO, for Climb,
AdaptiveClimb and DynamicAdaptiveClimb (one hand-written Hopper kernel,
``kernels/csrc/policy_step.cu``) and FIFO/LRU (plain torch).
"""
