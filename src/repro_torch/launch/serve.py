"""Serving entry point (port of ``launch/serve.py``): prefill a batch of
prompts, then decode greedily with either the unbounded cache or the
paper's DynamicAdaptiveClimb bounded KV pool.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --smoke --prompt-len 64 --gen 32 --budget 48 --device cpu

Every configuration of ``repro_torch.configs`` serves: attention, MLA,
MoE, Mamba and xLSTM layers (recurrent layers keep O(1) state and ignore
``--budget``).  Weights are random, from a ``torch.Generator`` seeded
with ``--seed``; prompts come from numpy with the same seed.  ``--device``
defaults to ``cuda``, where attention and MLA prefill run on kernel B2
and attention decode on kernel B3.

:func:`main` prints the reference's lines and returns what they report as
a dict: the device, prefill and decode seconds, tok/s, every greedy token
(``[gen + 1, batch]``) and, bounded, each attention and MLA layer's
active budgets (``[layers, batch]``).
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
    pre_s = time.perf_counter() - t0
    print(f"[serve] prefill {B}x{S}: {pre_s:.2f}s "
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
    ks = [st["ctrl"]["k_active"] for st in state["layers"] if "ctrl" in st]
    if ks:                   # bounded, and the arch has attention layers
        ks = torch.stack(ks).cpu().numpy()
        print(f"[serve] DAC active budgets: min={ks.min()} "
              f"median={np.median(ks):.0f} max={ks.max()} "
              f"(pool={args.budget})")
    else:
        ks = None
    out = np.stack(out)
    print("[serve] sample tokens:", out[:8, 0].tolist())
    return {"arch": cfg.name, "device": str(dev), "batch": B, "prompt": S,
            "gen": args.gen, "budget": args.budget, "prefill_s": pre_s,
            "decode_s": dt, "tok_s": args.gen * B / dt, "tokens": out,
            "k_active": ks}


if __name__ == "__main__":
    main()
