"""Kernel B3's chunk length on an NVIDIA card: how many slots a split block
of ``decode_attention.cu`` should take.

For each case, B3's time (bf16, L2 cold, as ``chip_smoke.py`` times it) at
every chunk of ``CHUNKS`` and at the one ``decode_attention.chunk_len``
picks; at that one also the split and combine kernels' device ms
(``torch.profiler``) and, as a yardstick, PyTorch's own streaming read of
the same K and V.  The cases: the smoke's three timed ones, and three on
which ``chunk_len`` shortens the chunk below ``CHUNK`` (few batch rows
and kv heads).

    python3 decode_sweep.py     # one CUDA card; one JSON line a case

Exits non-zero with no result where CUDA is not available.
"""
from __future__ import annotations

import json
import sys

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import roofline as R

    dev = "cuda"
    print(cs.nvidia_smi_line(), flush=True)
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
