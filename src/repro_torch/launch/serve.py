"""Serving entry point (port of ``launch/serve.py``): prefill a batch of
prompts, then decode greedily with either the unbounded cache or the
paper's DynamicAdaptiveClimb bounded KV pool.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --smoke --prompt-len 64 --gen 32 --budget 48 --device cpu

Weights are random, from a ``torch.Generator`` seeded with ``--seed``;
prompts come from numpy with the same seed.  ``--device`` defaults to
``cuda``, where attention runs on kernels B2 (prefill) and B3 (decode).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--budget", type=int, default=0,
                    help=">0: bounded DAC KV pool with this many slots")
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_arch
    from ..models import init_params
    from ..serving import decode_step, prefill

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_arch(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    max_len = S + args.gen

    def embeds(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    kw = {}
    if cfg.embeds_input:
        kw["embeds"] = embeds(B, S, cfg.d_model)
    else:
        kw["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)).to(dev)

    sync()
    t0 = time.perf_counter()
    state, logits = prefill(params, cfg, max_len=max_len,
                            budget=args.budget, **kw)
    sync()
    print(f"[serve] prefill {B}x{S}: {time.perf_counter() - t0:.2f}s "
          f"(budget={args.budget or 'unbounded'}, device={dev})")

    tok = logits.argmax(-1)
    out = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        if cfg.embeds_input:
            state, logits = decode_step(params, cfg, state,
                                        embed=embeds(B, cfg.d_model),
                                        eps=args.eps)
        else:
            state, logits = decode_step(params, cfg, state, token=tok,
                                        eps=args.eps)
        tok = logits.argmax(-1)
        out.append(tok.cpu().numpy())
    sync()
    dt = time.perf_counter() - t0
    print(f"[serve] decoded {args.gen} tokens x {B} seqs in {dt:.2f}s "
          f"({args.gen * B / dt:.1f} tok/s)")
    if args.budget:
        ks = torch.stack([st["ctrl"]["k_active"] for st in state["layers"]])
        ks = ks.cpu().numpy()
        print(f"[serve] DAC active budgets: min={ks.min()} "
              f"median={np.median(ks):.0f} max={ks.max()} "
              f"(pool={args.budget})")
    print("[serve] sample tokens:", np.stack(out)[:8, 0].tolist())


if __name__ == "__main__":
    main()
