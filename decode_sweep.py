"""Kernel B3's chunk length on an NVIDIA card: how many slots a split block
of ``decode_attention.cu`` should take; and, with ``--slot``, B3's
partial and merge over a slot-split cache.

For each case, B3's time (bf16, L2 cold, as ``chip_smoke.py`` times it) at
every chunk of ``CHUNKS`` and at the one ``decode_attention.chunk_len``
picks; at that one also the split and combine kernels' device ms
(``torch.profiler``) and, as a yardstick, PyTorch's own streaming read of
the same K and V.  The cases: the smoke's three timed ones, and three on
which ``chunk_len`` shortens the chunk below ``CHUNK`` (few batch rows
and kv heads).

    python3 decode_sweep.py     # one CUDA card; one JSON line a case

``--slot`` times ``decode_attention_partial`` (a rank's block) and
``decode_attention_merge`` (a rank's merge with its block's mass) at the
smoke's ``SLOT_SHAPES``, bf16, L2 cold, through the public functions of
the ``repro_torch`` under ``--src`` (default this tree's ``src``; another
tree's, to time two versions in one run), after holding each against its
plain version, beside PyTorch's own read of the block's K and V (two
reductions) as a yardstick; then B3 at the smoke's ``DECODE_TIMED``
cases, which the slot-split kernels must leave as they were.  ``--sweep`` also times this tree's partial
at each split of ``SLOT_SPLITS`` and on each body.  ``--ptxas`` prints the registers and
spills of the library's kernels where this run built it.

    python3 decode_sweep.py --slot [--src DIR] [--sweep] [--ptxas]

``--mla`` times deepseek-v2-236b's sharded decode step as ``chip_smoke.py``
phase 15 (b) serves it (full width, its first ``MLA_LAYERS`` layers, bf16,
B = 8 x 512, a (data 2, model 2) mesh of 4 gloo ranks sharing the card;
unbounded and a pool of 512), through the ``repro_torch`` under ``--src``:
the mean ms a step over ``MLA_STEPS`` steps, then the same steps again
with every collective of ``launch.mesh`` timed between synchronisations
(host ms, count and bytes a step by kind), and each rank's latent bytes.
One JSON line a regime; run it once per tree to compare trees in one
call.

    python3 decode_sweep.py --mla [--src DIR]

Exits non-zero with no result where CUDA is not available.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

CHUNKS = (32, 64, 128, 256, 512, 1024)
# name, B, S, H, Hkv, D, Dv, softcap, valid pattern (``cs.decode_valid``;
# ``full``: every slot valid, as after a bounded fill)
CASES = [
    ("deepseek-7b unbounded", 8, 2112, 32, 32, 128, 128, 0.0, "prefix"),
    ("deepseek-7b bounded", 8, 512, 32, 32, 128, 128, 0.0, "full"),
    ("gemma2-27b window", 1, 8192, 32, 16, 128, 128, 50.0, "window"),
    ("musicgen-medium d64", 8, 512, 24, 24, 64, 64, 0.0, "full"),
    ("qwen1.5-110b heads", 4, 1024, 64, 8, 128, 128, 0.0, "prefix"),
    ("mixtral-8x22b heads, B 1", 1, 4096, 48, 8, 128, 128, 0.0, "prefix"),
]


def kernel_ms(fn, flush, names, n=10):
    """Device ms per call of each kernel whose name holds one of ``names``,
    from ``torch.profiler`` over ``n`` calls of ``fn``, each after
    ``flush()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                out[name] += e.self_device_time_total / 1e3 / n
    return out


SLOT_SPLITS = (1, 2, 3, 4, 5, 6, 7, 8)   # blocks of a cluster, ``--sweep``


def ptxas_summary(log):
    """``[{"kernel", "registers", "spill_stores", "spill_loads"}]`` of each
    entry function in an ``nvcc -Xptxas -v`` log, names demangled where
    ``c++filt`` is found."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows.append({"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1]["spill_stores"], rows[-1]["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n
    return rows


def slot_cases(da, src, sweep, flush):
    """``--slot``: one JSON line a ``SLOT_SHAPES`` case, bf16."""
    import torch
    from repro_torch.launch import roofline as R
    dev = "cuda"
    for i, (name, B, S, H, Hkv, D, Dv, cap, pattern, n) in enumerate(
            cs.SLOT_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10 + i)
        dtype = torch.bfloat16
        q = cs.randn(gen, (B, H, D), dtype, dev)
        k = cs.randn(gen, (B, S // n, Hkv, D), dtype, dev)
        v = cs.randn(gen, (B, S // n, Hkv, Dv), dtype, dev)
        valid = cs.decode_valid(pattern, B, S, gen, dev)
        want = da.decode_attention_partial_plain(q, k, v, valid, 0,
                                                 softcap=cap)
        got = da.decode_attention_partial(q, k, v, valid, 0, softcap=cap)
        cs.part_err(got[0], want[0], f"{name} partial")
        cs.close_err(got[1], want[1], cs.ATTN_TOL["float32"],
                     f"{name} scores")
        part, sc = got
        hn = -(-H // n)
        parts = torch.stack([da.pad_heads(part, n)] * n)[:, :, :hn]
        parts = parts.contiguous()
        ml = torch.stack([part[..., -2:]] * n).contiguous()
        wo, wm = da.decode_attention_merge_plain(parts, ml, sc, dtype=dtype)
        go, gm = da.decode_attention_merge(parts, ml, sc, dtype=dtype)
        cs.close_err(go.float(), wo.float(), cs.ATTN_TOL["bfloat16"],
                     f"{name} merge o")
        cs.mass_err(gm, wm, wm.double().amax(-1, keepdim=True),
                    f"{name} merge mass")
        row = {"tree": src, "case": name, "shape": [B, S, H, Hkv, D, Dv],
               "dtype": "bfloat16", "blocks": n, "block_slots": S // n,
               "partial_ms": cs.cold_ms(lambda: da.decode_attention_partial(
                   q, k, v, valid, 0, softcap=cap), flush, reps=20),
               "partial_bound_ms": R.partial_bound(q, k, v, valid, 0)[0],
               "merge_ms": cs.cold_ms(lambda: da.decode_attention_merge(
                   parts, ml, sc, dtype=dtype), flush, reps=20),
               "merge_bound_ms": R.merge_bound(parts, ml, sc, dtype)[0],
               "partial_kernel_ms": kernel_ms(
                   lambda: da.decode_attention_partial(q, k, v, valid, 0,
                                                       softcap=cap),
                   flush, ("decode_attn_part", "decode_attn_split",
                           "decode_attn_fold")),
               "torch_sum_kv_ms": cs.cold_ms(lambda: (k.sum(), v.sum()),
                                             flush, reps=20),
               "merge_kernel_ms": kernel_ms(
                   lambda: da.decode_attention_merge(parts, ml, sc,
                                                     dtype=dtype),
                   flush, ("decode_attn_merge",))}
        if sweep:
            by = {}
            Sb = S // n
            for body in ("tensor", "cuda"):
                for c in SLOT_SPLITS:
                    chunk = -(-(-(-Sb // c)) // 16) * 16
                    split = (-(-Sb // chunk), chunk)
                    if f"{body} {split[0]}" in by:
                        continue

                    def call():
                        return da.launch_partial(q, k, v, valid, 0, cap,
                                                 D ** -0.5, split, body)
                    cs.part_err(call()[0], want[0],
                                f"{name} {body} split {split}")
                    by[f"{body} {split[0]}"] = cs.cold_ms(call, flush,
                                                          reps=20)
            row["partial_ms_by_body_and_splits"] = by
            row["rule"] = da.partial_plan(dtype, B, Sb, H, Hkv, D, Dv)
        print(json.dumps(row), flush=True)
        del q, k, v, valid, want, got, parts, ml, sc, part
    # B3 at the smoke's timed cases, which this kernel must leave as they
    # were (``sparse`` as after a bounded fill: every slot valid)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    for name, B, S, H, Hkv, D, Dv, cap, pattern in cs.DECODE_SHAPES:
        if name not in cs.DECODE_TIMED:
            continue
        q = cs.randn(gen, (B, H, D), torch.bfloat16, dev)
        k = cs.randn(gen, (B, S, Hkv, D), torch.bfloat16, dev)
        v = cs.randn(gen, (B, S, Hkv, Dv), torch.bfloat16, dev)
        valid = (torch.ones((B, S), dtype=torch.bool, device=dev)
                 if pattern == "sparse"
                 else cs.decode_valid(pattern, B, S, gen, dev))
        print(json.dumps({"tree": src, "b3_case": name, "ms": cs.cold_ms(
            lambda: da.decode_attention(q, k, v, valid, softcap=cap),
            flush, reps=20)}), flush=True)
    print(json.dumps({"tree": src, "empty_launch_ms": cs.cold_ms(
        lambda: da.noop_launch(dev), flush, reps=20)} if hasattr(
            da, "noop_launch") else {"tree": src}), flush=True)


MLA_ARCH, MLA_LAYERS, MLA_STEPS = "deepseek-v2-236b", 2, 16
MLA_B, MLA_S, MLA_BUDGET, MLA_WORLD = 8, 512, 512, 4


def mla_world(dev):
    """One rank of ``--mla``'s world: per regime the mean decode step
    (``chip_smoke.mg_serve_run``), then the same steps from a fresh
    prefill with every collective timed between synchronisations."""
    import dataclasses
    import time

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params
    from repro_torch.serving import decode_step, prefill
    mesh = M.make_test_mesh(2, 2)
    sctx = M.shard_ctx(mesh, mode="serve")
    cfg = dataclasses.replace(ARCHS[MLA_ARCH], n_layers=MLA_LAYERS)
    local = init_params(cfg, torch.Generator(device=dev).manual_seed(
        cs.SEED), device=dev, sctx=sctx)
    toks = cs.prompt_tokens(cfg, MLA_B, MLA_S + MLA_STEPS, dev, n=18)
    stats = {}

    def timed(f):
        def run(x, *a):
            cs._sync(dev)
            t0 = time.perf_counter()
            out = f(x, *a)
            cs._sync(dev)
            row = stats.setdefault(a[-1], [0, 0, 0.0])   # a[-1]: the kind
            row[0] += 1
            row[1] += x.numel() * x.element_size()
            row[2] += (time.perf_counter() - t0) * 1e3
            return out
        return run
    out = {}
    for regime, budget in (("unbounded", 0), ("bounded", MLA_BUDGET)):
        run = cs.mg_serve_run(local, cfg, sctx, toks, MLA_S, MLA_STEPS,
                              budget)
        row = {"step_ms": run["step_ms"], "latent_bytes": sum(
            st[k].numel() * st[k].element_size()
            for st in run["state"]["layers"] for k in ("latent", "krope"))}
        del run
        state, _ = prefill(local, cfg, tokens=toks[:, :MLA_S], budget=budget,
                           max_len=MLA_S + MLA_STEPS, sctx=sctx)
        stats.clear()
        gather, exchange = M._gather, M._exchange
        M._gather, M._exchange = timed(gather), timed(exchange)
        try:
            cs._sync(dev)
            t0 = time.perf_counter()
            for t in range(MLA_S, MLA_S + MLA_STEPS):
                state, _ = decode_step(local, cfg, state, token=toks[:, t],
                                       sctx=sctx)
            cs._sync(dev)
        finally:
            M._gather, M._exchange = gather, exchange
        row["step_ms_collectives_timed"] = \
            (time.perf_counter() - t0) * 1e3 / MLA_STEPS
        row["collectives_a_step"] = {
            kind: {"count": n / MLA_STEPS, "bytes": nb / MLA_STEPS,
                   "ms": ms / MLA_STEPS}
            for kind, (n, nb, ms) in stats.items()}
        out[regime] = row
        del state
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--slot", action="store_true")
    ap.add_argument("--mla", action="store_true")
    ap.add_argument("--src", default=str(cs.ROOT / "src"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import roofline as R

    dev = "cuda"
    print(cs.nvidia_smi_line(), flush=True)
    if args.mla:
        import os
        import tempfile
        from repro_torch.launch import mesh as M
        from repro_torch.kernels import flash_attention as fa
        fa._lib()                       # built once, before the ranks
        # as phase 15: four ranks' allocators share the card's memory
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        with tempfile.TemporaryDirectory() as tmp:
            ranks = M.launch_world(mla_world, MLA_WORLD, (dev,),
                                   init_file=f"{tmp}/init", backend="gloo",
                                   device=dev, timeout=600)
        for regime in ranks[0]:
            print(json.dumps({
                "tree": args.src, "arch": MLA_ARCH, "layers": MLA_LAYERS,
                "regime": regime, "mesh": {"data": 2, "model": 2},
                "B": MLA_B, "S": MLA_S, "steps": MLA_STEPS,
                "ranks": [r[regime] for r in ranks]}), flush=True)
        return 0
    if args.slot:
        flush_buf = torch.ones(cs.FLUSH_BYTES // 4, device=dev)
        da._lib()
        if args.ptxas:
            log = _build.library_path("decode_attention").with_suffix(".log")
            if log.exists():
                text = log.read_text()
                out = Path("chiprun_out")
                out.mkdir(exist_ok=True)
                (out / f"ptxas_{Path(args.src).resolve().parent.name}.log"
                 ).write_text(text)
                for row in ptxas_summary(text):
                    print(json.dumps({"tree": args.src, **row}), flush=True)
        slot_cases(da, args.src, args.sweep, lambda: flush_buf.sum())
        return 0
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush_buf = torch.ones(cs.FLUSH_BYTES // 4, device=dev)

    def flush():
        flush_buf.sum()
    for name, B, S, H, Hkv, D, Dv, cap, pattern in CASES:
        dtype = torch.bfloat16
        q = cs.randn(gen, (B, H, D), dtype, dev)
        k = cs.randn(gen, (B, S, Hkv, D), dtype, dev)
        v = cs.randn(gen, (B, S, Hkv, Dv), dtype, dev)
        valid = (torch.ones((B, S), dtype=torch.bool, device=dev)
                 if pattern == "full"
                 else cs.decode_valid(pattern, B, S, gen, dev))
        rule = da.chunk_len(B, Hkv, S)
        scale = D ** -0.5

        def call(c):
            return lambda: da.launch(q, k, v, valid, cap, scale, c)
        want = da.decode_attention_plain(q, k, v, valid, softcap=cap)
        for c in sorted({*CHUNKS, rule}):
            got = call(c)()
            cs.close_err(got[0].float(), want[0].float(),
                         cs.ATTN_TOL["bfloat16"], f"{name} chunk {c} o")
            cs.close_err(got[1], want[1], cs.MASS_TOL, f"{name} chunk {c} mass")
        sum_ms = cs.cold_ms(lambda: (k.sum(), v.sum()), flush)
        print(json.dumps({
            "case": name, "shape": [B, S, H, Hkv, D, Dv], "dtype": "bfloat16",
            "valid_slots": int(valid.sum()), "chunk_len": rule,
            "bound_ms": R.decode_bound(q, k, v, valid)[0],
            "ms_by_chunk": {c: cs.cold_ms(call(c), flush, reps=20)
                            for c in sorted({*CHUNKS, rule})},
            "blocks_by_chunk": {c: da.blocks_per_call(B, S, H, Hkv, D, Dv, c)
                                for c in sorted({*CHUNKS, rule})},
            "kernel_ms_at_rule": kernel_ms(call(rule), flush, (
                "decode_attn_split", "decode_attn_combine")),
            "torch_sum_kv_ms": sum_ms,
            "torch_sum_kv_gb_per_s": (k.numel() + v.numel())
            * k.element_size() / sum_ms / 1e6}), flush=True)
        del q, k, v, valid, want
    print(json.dumps({"event_pair_ms": cs.cold_ms(lambda: None, flush,
                                                  reps=20)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
