"""Dry run of the production meshes (port of ``launch/dryrun.py``): one rank
of every (architecture x input shape x mesh) cell traced on fake tensors
in a fake world, nothing allocated; what the rank holds, the flops, HBM
bytes and collective wire bytes of one step (``launch.roofline``), and
which of them bounds the step on an H100, to JSON.

The reference lowers and compiles each cell for 256 (512) placeholder
devices and parses the partitioned HLO.  Here rank 0 of a fake world of
256 (512) ranks (torch's ``fake`` process group: its collectives move
nothing) builds its blocks of the parameters, optimizer state, inputs and
serve state under a ``FakeTensorMode`` on ``--device`` (default
``cuda``: fake tensors of the card's device type, nothing allocated on
it), then runs one real step of the port under
:class:`~repro_torch.launch.roofline.StepCounter`: ``make_train_step``,
``prefill`` (the plain attention) or ``decode_step`` (the plain
attention; ``--serve-sharding resident|fsdp``).  The ranks of a mesh run
the same program on blocks of one size, so rank 0's counts are every
rank's.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k \\
      --mesh pod --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all            # every cell
  python -m repro_torch.launch.report                  # summarize JSONs
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, SHAPES, TensorSpec, input_specs
from . import roofline

__all__ = ["TRAIN_KNOBS", "MESHES", "PASSES", "kernel_credit_bytes",
           "port_credit_bytes",
           "fake_world", "trace_cell", "summarize", "run_cell", "all_cells",
           "run_all", "tree_bytes"]

# per-arch execution knobs (microbatches divide the 256 train batch;
# int8 Adam moments for the >=50B archs so optimizer state fits HBM)
TRAIN_KNOBS = {
    "xlstm-125m": dict(n_micro=1, moments="float32"),
    "musicgen-medium": dict(n_micro=2, moments="float32"),
    "deepseek-7b": dict(n_micro=4, moments="float32"),
    "codeqwen1.5-7b": dict(n_micro=4, moments="float32"),
    "llava-next-mistral-7b": dict(n_micro=4, moments="float32"),
    "gemma2-27b": dict(n_micro=8, moments="float32"),
    "qwen1.5-110b": dict(n_micro=16, moments="int8"),
    "mixtral-8x22b": dict(n_micro=16, moments="int8"),
    "deepseek-v2-236b": dict(n_micro=16, moments="int8"),
    "jamba-1.5-large-398b": dict(n_micro=16, moments="int8"),
}

# mesh kind -> (ranks, multi_pod); "single" is one rank, unsharded
MESHES = {"pod": (256, False), "multipod": (512, True), "single": (1, None)}


def kernel_credit_bytes(cfg, cell, n_chips: int, passes: float, *,
                        tp_n: int = 16, bsz: int | None = None) -> float:
    """Per-chip HBM bytes of the flash/flash-decode kernels for every
    attention layer of one step: the analytic substitute for the plain
    attention's traffic (which materializes score tensors that the kernels
    keep on chip).  Model:
      full-seq:  passes x [ nq x (K+V) streamed + Q + O ]
      decode:    2K + V + Q + O  (stats pass re-reads K)
    Head/batch sharding divides per-chip bytes; windowed layers stream a
    band instead of the full prefix.  The reference's law, term for term;
    ``tp_n`` and ``bsz`` (the model and batch shards; default the
    production meshes') let one rank unsharded (1, 1) use it too.
    """
    bsz = 16 * (2 if n_chips == 512 else 1) if bsz is None else bsz
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode" and cell.bounded_budget:
        S = cell.bounded_budget          # the DAC pool bounds the KV read
    B_loc = B / bsz if B % bsz == 0 else B
    H = cfg.n_heads
    Hkv = cfg.n_kv_heads
    hd = cfg.head_dim
    H_loc = H / tp_n if H % tp_n == 0 else H
    Hkv_loc = Hkv / tp_n if Hkv % tp_n == 0 else Hkv
    bq = min(cfg.attn_chunk_q, S)
    total = 0.0
    # slot tables shard over 'model' when kv-heads don't divide it
    # (serve_state_shardings); the kernel streams only the local slots
    slot_div = tp_n if Hkv % tp_n else 1
    for spec in cfg.layer_specs():
        if spec.kind == "mla":
            width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            if cell.kind == "decode":
                total += B_loc * S * width * 2 * 2 / tp_n  # latent, sharded
                total += 2 * B_loc * H_loc * hd * 2
            else:
                nq = max(S // bq, 1)
                total += passes * (nq * B_loc * S * width * 2
                                   + 2 * B_loc * S * H_loc *
                                   (cfg.qk_nope_head_dim
                                    + cfg.qk_rope_head_dim) * 2)
        elif spec.kind == "attn":
            span = min(S, (spec.window or S) + bq)
            if cell.kind == "decode":
                kv = B_loc * min(S, spec.window or S) * Hkv_loc * hd * 2 \
                    / slot_div
                total += 3 * kv + 2 * B_loc * H_loc * hd * 2
            else:
                nq = max(S // bq, 1)
                kv_stream = nq * 2 * B_loc * span * Hkv_loc * hd * 2
                qo = 2 * B_loc * S * H_loc * hd * 2
                total += passes * (kv_stream + qo)
    return total


def port_credit_bytes(cfg, cell, n_chips: int, passes: float, *,
                      tp_n: int = 16, bsz: int | None = None) -> float:
    """The kernel credit of the port's step: :func:`kernel_credit_bytes`'
    law, term for term, on the blocks that the port's own placement gives
    a rank (``models.sharding.Local``; ``serve_state_shardings``' edges)
    where the reference's law assumes its own:

    * the heads split over ``model`` only where both the query and the KV
      heads divide it; otherwise every model rank runs all of them, over
      its block of a KV cache's slots (a ``model``-th of them, where the
      slots divide the axis, as the reference's; else every slot).  A
      window's band of a slot-split cache is credited as the busiest rank
      streams it, ``min(window, L / model)`` slots: the ranks step
      together;
    * MLA's latent is split by slots over ``model`` where the slots
      divide the axis (``Local.latent_block``), whatever the heads do,
      and each rank streams its block; else whole on every model rank;
    * MLA's prefill runs B2 on the per-head K (``qk_nope + qk_rope``) and
      V (``v_head_dim``) materialized from the latent, so B2 streams
      those, not the latent.

    Where the placements agree (both head counts divide ``model``, or one
    rank) it equals :func:`kernel_credit_bytes` but for MLA's prefill; an
    MLA decode whose slots divide ``model`` equals it too.  The merge of a
    slot-split cache's partials is not credited: it moves each head's
    ``Dv + 2`` floats a rank, not the cache."""
    bsz = 16 * (2 if n_chips == 512 else 1) if bsz is None else bsz
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode" and cell.bounded_budget:
        S = cell.bounded_budget          # the DAC pool bounds the KV read
    B_loc = B / bsz if B % bsz == 0 else B
    split = cfg.n_heads % tp_n == 0 and cfg.n_kv_heads % tp_n == 0
    H_loc = cfg.n_heads / tp_n if split else cfg.n_heads
    Hkv_loc = cfg.n_kv_heads / tp_n if split else cfg.n_kv_heads
    hd = cfg.head_dim
    bq = min(cfg.attn_chunk_q, S)
    # a KV cache's slots over 'model' where its heads do not split
    # (models.sharding.Local.kv_block): B3 streams the rank's block, or
    # as much of a window's band as one block can hold
    slot_div = tp_n if cfg.n_kv_heads % tp_n and S % tp_n == 0 else 1
    total = 0.0
    for spec in cfg.layer_specs():
        if spec.kind == "mla" and cell.kind == "decode":
            width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            # the rank's block of the latent's slots (Local.latent_block)
            blocks = tp_n if S % tp_n == 0 else 1
            total += B_loc * S * width * 2 * 2 / blocks
            total += 2 * B_loc * H_loc * hd * 2
            continue
        if spec.kind == "mla":           # B2 on the materialized heads
            D, Dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, \
                cfg.v_head_dim
            heads, kv_heads, window = H_loc, H_loc, None
        elif spec.kind == "attn":
            D = Dv = hd
            heads, kv_heads, window = H_loc, Hkv_loc, spec.window
        else:
            continue
        if cell.kind == "decode":        # 2K + V + Q + O
            kv = B_loc * min(S / slot_div, window or S) * kv_heads * 2
            total += kv * (2 * D + Dv) + B_loc * heads * (D + Dv) * 2
        else:
            span = min(S, (window or S) + bq)
            nq = max(S // bq, 1)
            kv_stream = nq * B_loc * span * kv_heads * (D + Dv) * 2
            qo = B_loc * S * heads * (D + Dv) * 2
            total += passes * (kv_stream + qo)
    return total


def _storages(tree) -> dict:
    """{storage id: bytes} of every tensor in ``tree`` (a storage that
    several tensors view counts once)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def tree_bytes(tree) -> int:
    """Bytes of the storages the tensors of ``tree`` hold, each once."""
    return sum(_storages(tree).values())


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake world of ``world`` ranks (torch's
    ``fake`` process group: collectives return at once and move nothing),
    destroyed on exit whatever happened.  Refuses where a process group is
    up already: a real world's collectives would run instead."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is up in this process: the dry "
                           "run joins a fake world of its own")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rows(specs, n):
    """Each rank's rows of the batch's specs (``n`` batch shards)."""
    out = {}
    for k, sp in specs.items():
        if sp.shape[0] % n:
            raise ValueError(f"{k}: batch {sp.shape[0]} does not split over "
                             f"{n} batch shards")
        out[k] = TensorSpec((sp.shape[0] // n,) + tuple(sp.shape[1:]),
                            sp.dtype)
    return out


def trace_cell(arch: str, shape, mesh_kind: str, remat: str = "full",
               extra: dict | None = None, device: str = "cuda",
               attribute: bool = False):
    """One cell's step on rank 0 of its mesh, on fake tensors, under a
    :class:`~.roofline.StepCounter`.  ``shape`` is a ``SHAPES`` name or a
    :class:`~repro_torch.configs.ShapeCell`; ``mesh_kind`` one of
    ``MESHES`` ("single": one rank, unsharded, no world).  Returns
    ``(analysis, n_chips, meta, memory)``: the counter's
    :meth:`~.roofline.StepCounter.result` (with ``rows`` when
    ``attribute``), the mesh's ranks, the cell's description and the
    rank's argument, output, alias and temporary bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = ARCHS[arch]
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    n_chips, multi_pod = MESHES[mesh_kind]
    knobs = dict(TRAIN_KNOBS[arch])
    knobs.update(extra or {})
    world = fake_world(n_chips) if n_chips > 1 else contextlib.nullcontext()
    with world:
        sctx = None
        if n_chips > 1:
            from .mesh import make_production_mesh, shard_ctx
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=torch.device(device).type)
            sctx = shard_ctx(mesh)
        meta = dict(arch=arch, shape=cell.name, mesh=mesh_kind,
                    n_chips=n_chips, remat=remat,
                    **{k: str(v) for k, v in knobs.items()})
        mode = FakeTensorMode()
        step, args = _cell_step(cfg, cell, sctx, knobs, remat, device, mode,
                                meta)
        counter = roofline.StepCounter(attribute=attribute)
        with mode, counter:
            out = step(*args)
        ana = counter.result()
        if attribute:
            ana["rows"] = {k: tuple(v) for k, v in counter.rows.items()}
    arg = _storages(args)
    outs = _storages(out)
    alias = sum(n for k, n in outs.items() if k in arg)
    fresh = sum(outs.values()) - alias
    memory = {"argument_bytes": sum(arg.values()),
              "argument_storages": len(arg),
              "output_bytes": sum(outs.values()),
              "temp_bytes": max(0, ana["peak_live_bytes"] - fresh),
              "alias_bytes": alias}
    return ana, n_chips, meta, memory


def _cell_step(cfg, cell, sctx, knobs, remat, device, mode, meta):
    """The cell's step function and its arguments (fake tensors built
    under ``mode``); sets ``meta``'s model flops."""
    from ..models import init_params_shape, param_count
    from ..serving.serve_step import decode_step, prefill, serve_state_specs

    active = param_count(cfg, active_only=True)
    inputs = input_specs(cfg, cell)
    if cell.kind == "train":
        from ..models.convert import stacked_view
        from ..optim import adamw
        from ..train.train_step import make_train_step, placement
        # each microbatch must still split over every batch shard
        bsz = 1 if sctx is None else sctx._bsz()
        knobs["n_micro"] = min(int(knobs["n_micro"]),
                               max(1, cell.global_batch // bsz))
        meta["n_micro"] = str(knobs["n_micro"])
        opt_cfg = adamw.AdamWConfig(moment_dtype=knobs["moments"],
                                    total_steps=10000)
        params = init_params_shape(cfg, sctx, device, mode)
        place = None if sctx is None else placement(cfg, sctx)
        with mode:
            opt = adamw.init(stacked_view(params, cfg), opt_cfg, place)
            batch = {k: sp.make(device)
                     for k, sp in _rows(inputs, bsz).items()}
        step = make_train_step(cfg, opt_cfg, sctx=sctx,
                               n_microbatches=int(knobs["n_micro"]),
                               remat=remat)
        meta["model_flops"] = 6 * active * cell.global_batch * cell.seq_len
        return step, (params, opt, batch)
    if cell.kind == "prefill":
        params = init_params_shape(cfg, sctx, device, mode)
        with mode:
            batch = {k: sp.make(device) for k, sp in inputs.items()}

        @torch.no_grad()
        def step(params, batch):
            return prefill(params, cfg, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"), max_len=cell.seq_len,
                           budget=0, impl="plain", sctx=sctx)
        meta["model_flops"] = 2 * active * cell.global_batch * cell.seq_len
        return step, (params, batch)
    if knobs.get("serve_sharding", "resident") == "resident" and sctx:
        # inference placement: weights resident, no FSDP gather a token
        sctx = dataclasses.replace(sctx, mode="serve")
        meta["serve_sharding"] = "resident"
    B = cell.global_batch
    params = init_params_shape(cfg, sctx, device, mode)
    state = serve_state_specs(cfg, B, cell.seq_len, cell.bounded_budget,
                              sctx=sctx, device=device, mode=mode)
    with mode:
        inp = {k: sp.make(device) for k, sp in inputs.items()}

    @torch.no_grad()
    def step(params, state, inp):
        return decode_step(params, cfg, state, token=inp.get("token"),
                           embed=inp.get("embed"), impl="plain", sctx=sctx)
    meta["model_flops"] = 2 * active * B
    meta["bounded_budget"] = cell.bounded_budget
    return step, (params, state, inp)


PASSES = {"train": 4.0, "prefill": 1.0, "decode": 1.0}


def summarize(ana, n_chips, meta, memory, cell, cfg) -> dict:
    """The reference's ``memory`` and ``roofline`` (with
    ``kernel_credited``) sections of one traced cell."""
    terms = ana["terms"]
    model_flops_chip = meta["model_flops"] / n_chips
    mem = dict(memory)
    mem["total_nonaliased_gb"] = round(
        (memory["argument_bytes"] + memory["output_bytes"]
         + memory["temp_bytes"] - memory["alias_bytes"]) / 2**30, 3)
    rf = {
        "flops_per_chip": ana["flops"],
        "hbm_bytes_per_chip": ana["hbm_bytes"],
        "wire_bytes_per_chip": ana["wire_bytes"],
        "collective_bytes": ana["collective_bytes"],
        "collective_counts": ana["collective_counts"],
        "hbm_by_op": ana.get("hbm_by_op", {}),
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "dominant": roofline.dominant_term(terms),
        "model_flops_per_chip": model_flops_chip,
        "useful_flops_ratio": (model_flops_chip / ana["flops"])
        if ana["flops"] else 0.0,
        "roofline_fraction": (model_flops_chip / roofline.PEAK_FLOPS)
        / max(max(terms.values()), 1e-30),
        "flops_by_rate": ana["flops_by_rate"],
        "wire_by_link": ana["wire_by_link"],
        "sum_wire_bytes": ana["sum_wire_bytes"],
        "sum_ring_allreduce_bytes": ana["sum_ring_allreduce_bytes"],
    }
    # kernel credit: B2 and B3 keep attention's intermediates on chip; the
    # plain attention traced here writes them to HBM.  The port's step is
    # credited on its own placement's blocks (port_credit_bytes)
    attn_inner = ana.get("hbm_attention_inner", 0.0)
    shards = {} if n_chips > 1 else {"tp_n": 1, "bsz": 1}
    k_bytes = port_credit_bytes(cfg, cell, n_chips, PASSES[cell.kind],
                                **shards)
    mem_credited = (ana["hbm_bytes"] - attn_inner + k_bytes) \
        / roofline.HBM_BW
    terms_k = dict(terms, memory_s=mem_credited)
    rf["kernel_credited"] = {
        "attention_inner_bytes": attn_inner,
        "kernel_bytes": k_bytes,
        "memory_s": mem_credited,
        "dominant": roofline.dominant_term(terms_k),
        "roofline_fraction": (model_flops_chip / roofline.PEAK_FLOPS)
        / max(max(terms_k.values()), 1e-30),
    }
    return {"memory": mem, "roofline": rf}


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str,
             remat: str = "full", tag: str = "", extra: dict | None = None,
             device: str = "cuda"):
    """Trace one cell and write its JSON (``<arch>__<shape>__<mesh>.json``
    in ``out_dir``); a failure is recorded in the file, not raised."""
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, name + ".json")
    t0 = time.perf_counter()
    try:
        ana, n_chips, meta, memory = trace_cell(arch, shape, mesh_kind,
                                                remat=remat, extra=extra,
                                                device=device)
        result = {**meta, "ok": True, "device": device,
                  "trace_s": round(time.perf_counter() - t0, 2),
                  **summarize(ana, n_chips, meta, memory, SHAPES[shape],
                              ARCHS[arch]),
                  "peak_live_bytes": ana["peak_live_bytes"]}
    except Exception as e:  # noqa: BLE001 -- cell failures are data
        result = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                  "ok": False, "device": device,
                  "trace_s": round(time.perf_counter() - t0, 2),
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    if tag:
        result["tag"] = tag
    from ..bench.results import atomic_write_json
    atomic_write_json(path, result)
    dom = result.get("roofline", {}).get("dominant", "-")
    rf = result.get("roofline", {}).get("roofline_fraction", 0)
    print(f"[dryrun] {name}: ok={result['ok']} dominant={dom} "
          f"roofline_frac={rf:.3f} ({time.perf_counter() - t0:.0f}s)",
          flush=True)
    return result


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh_kind in ("pod", "multipod"):
                yield arch, shape, mesh_kind


def _done(path) -> bool:
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return bool(json.load(f).get("ok"))


# --all: cells traced at once (a process each) and the seconds a cell may
# take (jamba's and xlstm's train_4k and prefill_32k do not finish in it:
# their Python loops over chunks and tokens)
JOBS = min(8, os.cpu_count() or 1)
CELL_TIMEOUT = 900.0


def run_all(out_dir, skip_done=False, args=()):
    """Every cell, each in a process of its own (``JOBS`` at once).  A
    process that dies before writing its cell's JSON, or is stopped after
    ``CELL_TIMEOUT`` seconds, leaves one that records why."""
    cells = [c for c in all_cells()
             if not (skip_done and _done(os.path.join(
                 out_dir, "__".join(c) + ".json")))]
    # the quick cells first (decode, then prefill, then train; fewer
    # layers first), so that a cut run leaves the most cells done
    order = {"decode": 0, "prefill": 1, "train": 2}
    cells.sort(key=lambda c: (order[SHAPES[c[1]].kind],
                              ARCHS[c[0]].n_layers))
    running = []
    while cells or running:
        while cells and len(running) < JOBS:
            arch, shape, mesh_kind = cells.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                   "--out", out_dir, *args]
            running.append(((arch, shape, mesh_kind), time.perf_counter(),
                            subprocess.Popen(cmd)))
        time.sleep(0.5)
        for item in list(running):
            cell, t0, proc = item
            took = time.perf_counter() - t0
            late = took > CELL_TIMEOUT
            if proc.poll() is None and not late:
                continue
            if late:
                proc.kill()
            proc.wait()
            running.remove(item)
            path = os.path.join(out_dir, "__".join(cell) + ".json")
            if late or (proc.returncode and not os.path.exists(path)):
                why = (f"the trace did not finish in {CELL_TIMEOUT:.0f} s"
                       if late else f"the cell's process exited with code "
                       f"{proc.returncode}")
                from ..bench.results import atomic_write_json
                atomic_write_json(path, {
                    "arch": cell[0], "shape": cell[1], "mesh": cell[2],
                    "ok": False, "trace_s": round(took, 2), "error": why})
                print(f"[dryrun] {'__'.join(cell)}: ok=False ({why})",
                      flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Trace one rank of each production-mesh cell on fake "
                    "tensors and write its memory and roofline terms.")
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--tag", default="")
    ap.add_argument("--n-micro", type=int, default=0)
    ap.add_argument("--serve-sharding", default="resident",
                    choices=["resident", "fsdp"],
                    help="decode param placement (fsdp = weights gathered "
                         "each step, as in training)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device type (nothing is "
                         "allocated on it)")
    args = ap.parse_args(argv)

    extra = {"n_micro": args.n_micro} if args.n_micro else {}
    extra["serve_sharding"] = args.serve_sharding
    if args.all:
        run_all(args.out, args.skip_done,
                ["--remat", args.remat, "--device", args.device,
                 "--serve-sharding", args.serve_sharding]
                + (["--n-micro", str(args.n_micro)] if args.n_micro else []))
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    res = run_cell(args.arch, args.shape, args.mesh, args.out,
                   remat=args.remat, tag=args.tag, extra=extra,
                   device=args.device)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
