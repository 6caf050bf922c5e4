"""Hand-written Hopper kernels of the port, one module per TPU kernel of
the reference (``src/repro/kernels``).  Each module holds the kernel's
wrapper, its plain PyTorch version and a launch counter; the CUDA sources
live in ``csrc/`` and build at first use (:mod:`._build`).

Every TPU kernel of the reference is ported: ``policy_step`` (B1, the
reference's ``fused_policy_step``), ``flash_attention`` (B2,
``flash_attention_pallas``) and ``decode_attention`` (B3,
``decode_attention_pallas``).
"""
