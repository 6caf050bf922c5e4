"""Training entry point (port of ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --smoke --steps 16 --device cpu

Weights are random, from a ``torch.Generator`` seeded with the trainer's
seed; batches come from the stateless token pipeline.  ``--device``
defaults to ``cuda`` and never falls back to the CPU.  Training runs the
plain attention, as the reference trains through its jnp attention: kernel
B2 has no backward.

``--mesh pod|multipod`` trains sharded over the production mesh, (data
16, model 16) or (pod 2, data 16, model 16), one process a rank, each
started by ``torch.distributed.run`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``)::

  python -m torch.distributed.run --nnodes 32 --nproc-per-node 8 \
      --rdzv-backend c10d --rdzv-endpoint HOST:PORT \
      -m repro_torch.launch.train --arch deepseek-7b --mesh pod

Each rank joins the world through ``launch.mesh.init_distributed`` (NCCL
on a card), then builds the mesh, which needs 256 (512) ranks and says so
otherwise.  The reference's ``JAX_COORDINATOR`` (``jax.distributed``'s
multi-host start) has no counterpart: ``torch.distributed.run``'s
rendezvous is the coordinator.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    from ..train.trainer import _default_ckpt_dir

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moments", default="float32",
                    choices=["float32", "int8"])
    ap.add_argument("--remat", default="full")
    ap.add_argument("--ckpt-dir", default=_default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "pod", "multipod"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_arch
    from ..optim import AdamWConfig
    from ..train import TrainConfig, Trainer

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but no CUDA device is available")
    sctx = None
    if args.mesh != "none":
        from . import mesh as M
        if "RANK" in os.environ:        # started by torch.distributed.run
            dev = M.init_distributed(device=args.device)
        # a world of one (not started as ranks) is too small: it raises
        mesh = M.make_production_mesh(multi_pod=args.mesh == "multipod",
                                      device_type=dev.type)
        sctx = M.shard_ctx(mesh)
    cfg = get_arch(args.arch, smoke=args.smoke)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps, moment_dtype=args.moments)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       global_batch=args.batch, seq_len=args.seq,
                       n_microbatches=args.microbatches, remat=args.remat)
    trainer = Trainer(cfg, opt, tcfg, sctx=sctx, device=dev)
    trainer.run()
    hist = trainer.history
    if sctx is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:
            return
    if hist:
        print(f"[train] {args.arch}: step {hist[0]['step']}..."
              f"{hist[-1]['step']}  loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}  "
              f"stragglers={trainer.watchdog.flagged}")


if __name__ == "__main__":
    main()
