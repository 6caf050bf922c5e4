"""Hand-written Hopper kernels of the port, one module per TPU kernel of
the reference (``src/repro/kernels``).  Each module holds the kernel's
wrapper, its plain PyTorch version and a launch counter; the CUDA sources
live in ``csrc/`` and build at first use (:mod:`._build`).

Ported so far: ``policy_step`` (the reference's ``fused_policy_step``).
"""
