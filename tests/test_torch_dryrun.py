"""The port's launch layer (``launch/dryrun.py``, ``roofline.py``,
``profile.py``, ``report.py``) against the reference's on the CPU.

What the reference reckons from shapes alone (input specs, parameter
counts, the kernels' credited bytes, each rank's parameter and serve-state
bytes under its ``PartitionSpec`` s on ``jax.sharding.AbstractMesh``, the
roofline laws and the report's table) the port must give exactly, at full
width: its side is built on fake tensors in a fake world of 256 (512)
ranks, nothing allocated.  The step counter's flops are held to a
closed-form count of a smoke prefill's products and to the reference's
HLO analysis of the same cell, and its record of the collectives on a
fake world to the same record on rank 0 of a real gloo world.
"""
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh as RAbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import _torch_worlds as worlds  # noqa: E402
from repro import configs as RC  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.serving import serve_step as ref_serve  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import profile as P  # noqa: E402
from repro_torch.launch import report as port_report  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.models import init_params_shape, param_count  # noqa: E402
from repro_torch.serving.serve_step import (  # noqa: E402
    kv_bytes, serve_state_specs)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(PC.ARCHS)
SHAPES = sorted(PC.SHAPES)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
WORLD_TIMEOUT = 120
# the counter against the reference's HLO analysis of the same prefill:
# XLA's count adds one flop per fusion output element (elementwise work
# the counter leaves out), so the two agree to this relative tolerance
HLO_FLOPS_RTOL = 0.05


# -- input specs, parameter counts --------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    """Shapes as the reference's; dtypes too, but serving's token ids,
    which are int64 (``launch.serve``)."""
    want = RC.input_specs(RC.ARCHS[arch], shape)
    got = PC.input_specs(PC.ARCHS[arch], shape)
    assert sorted(got) == sorted(want)
    serving = PC.SHAPES[shape].kind != "train"
    for k, sp in got.items():
        assert sp.shape == tuple(want[k].shape), k
        ref_dt = str(jnp.dtype(want[k].dtype))
        if serving and k in ("token", "tokens"):
            assert (ref_dt, sp.dtype) == ("int32", torch.int64), k
        else:
            assert str(sp.dtype).removeprefix("torch.") == ref_dt, k


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_reference(arch, active_only):
    assert param_count(PC.ARCHS[arch], active_only=active_only) == \
        ref_model.param_count(RC.ARCHS[arch], active_only=active_only)


# -- the kernels' credit -----------------------------------------------------

@pytest.fixture(scope="module")
def ref_credits():
    """The reference's ``kernel_credit_bytes`` for every cell, from a
    subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to
    512 devices, which must not reach this process."""
    code = (
        "import json\n"
        "from repro.configs import ARCHS, SHAPES\n"
        "from repro.launch.dryrun import kernel_credit_bytes\n"
        "passes = {'train': 4.0, 'prefill': 1.0, 'decode': 1.0}\n"
        "print(json.dumps({f'{a}|{s}|{n}': kernel_credit_bytes(\n"
        "    ARCHS[a], SHAPES[s], n, passes[SHAPES[s].kind])\n"
        "    for a in ARCHS for s in SHAPES for n in (256, 512)}))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "512" not in os.environ.get("XLA_FLAGS", "")
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("n_chips", [256, 512])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_credit_bytes_equal_reference(ref_credits, arch, shape,
                                             n_chips):
    cell = PC.SHAPES[shape]
    got = D.kernel_credit_bytes(PC.ARCHS[arch], cell, n_chips,
                                D.PASSES[cell.kind])
    assert got == ref_credits[f"{arch}|{shape}|{n_chips}"]


# the archs whose placement of the attention is the reference's: both head
# counts divide ``model`` (or no attention) and no MLA
AGREE = [a for a in ARCHS
         if PC.ARCHS[a].n_heads % 16 == 0 and PC.ARCHS[a].n_kv_heads % 16 == 0
         and all(s.kind != "mla" for s in PC.ARCHS[a].layer_specs())]


@pytest.mark.parametrize("n_chips", [1, 256, 512])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", AGREE)
def test_port_credit_equals_reference_where_placements_agree(arch, shape,
                                                             n_chips):
    """Where the port places the attention's heads and slots as the
    reference does, its credit is the reference's law, exactly (one rank
    unsharded: ``tp_n`` = ``bsz`` = 1)."""
    cfg, cell = PC.ARCHS[arch], PC.SHAPES[shape]
    shards = {"tp_n": 1, "bsz": 1} if n_chips == 1 else {}
    args = (cfg, cell, n_chips, D.PASSES[cell.kind])
    assert D.port_credit_bytes(*args, **shards) == \
        D.kernel_credit_bytes(*args, **shards)


def _decode_credit_from_state(cfg, cell, state, local):
    """:func:`~repro_torch.launch.dryrun.port_credit_bytes`' law for a
    decode step, read off the rank's own serve state and placement: each
    attention layer's 2K + V over the slots it streams (a window's band)
    plus Q and O of the heads the rank runs; each MLA layer's latent and
    rotary cache twice plus Q and O."""
    H_loc = cfg.n_heads / local.tp_n
    total = 0.0
    for spec, st in zip(cfg.layer_specs(), state["layers"]):
        if spec.kind == "attn":
            k, v = st["k"], st["v"]
            rows, L = k.shape[0], k.shape[1]
            band = min(cell.bounded_budget or cell.seq_len,
                       spec.window or L) / L
            total += (2 * D.tree_bytes(k) + D.tree_bytes(v)) * band
            total += rows * H_loc * 2 * cfg.head_dim * 2
        elif spec.kind == "mla":
            rows = st["latent"].shape[0]
            total += 2 * (D.tree_bytes(st["latent"])
                          + D.tree_bytes(st["krope"]))
            total += rows * H_loc * 2 * cfg.head_dim * 2
    return total


@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "xlstm-125m"])
def test_port_credit_reads_the_ranks_own_cache(arch, shape, mesh_kind):
    """A decode step's credit streams the cache that rank 0 holds under
    the port's placement (``serve_state_specs(sctx=)`` in a fake world)
    and runs the heads ``sharding.Local`` gives it: a KV cache whose heads
    do not divide ``model`` (musicgen's 24, ROADMAP D12) and MLA's latent
    are read whole on every model rank, not a ``model``-th of their
    slots."""
    from repro_torch.models.sharding import Local, param_specs
    cfg, cell = PC.ARCHS[arch], PC.SHAPES[shape]
    mshape, _ = MESHES[mesh_kind]
    with D.fake_world(math.prod(mshape)):
        sctx = _port_ctx(mesh_kind, "serve")
        state = serve_state_specs(cfg, cell.global_batch, cell.seq_len,
                                  cell.bounded_budget, sctx=sctx,
                                  device="cpu")
        specs = param_specs(init_params_shape(cfg, device="cpu"), cfg, sctx)
        local = Local(sctx, cfg, cell.global_batch, specs)
    want = _decode_credit_from_state(cfg, cell, state, local)
    got = D.port_credit_bytes(cfg, cell, math.prod(mshape), 1.0)
    assert got == pytest.approx(want, rel=1e-12)
    if arch == "musicgen-medium":       # the whole cache, 24 heads a rank
        assert got > 1.5 * kv_bytes(state)


# -- each rank's bytes -----------------------------------------------------------

def _ref_rank_bytes(leaf, spec, sizes) -> float:
    div = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            div *= sizes[a]
    return leaf.size * jnp.dtype(leaf.dtype).itemsize / div


def _port_ctx(mesh_kind, mode):
    mesh = M.make_production_mesh(multi_pod=mesh_kind == "multipod",
                                  device_type="cpu")
    return dataclasses.replace(M.shard_ctx(mesh), mode=mode)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_param_bytes_equal_reference(arch, mesh_kind, mode):
    """Rank 0's blocks of the parameters (``init_params_shape(sctx=)`` in a
    fake world) hold what the reference's placements give a rank."""
    shape, axes = MESHES[mesh_kind]
    rcfg = RC.ARCHS[arch]
    rctx = ref_sharding.ShardCtx(mesh=RAbstractMesh(shape, axes),
                                 pod="pod" if "pod" in axes else None,
                                 mode=mode)
    rshapes = ref_model.init_params_shape(rcfg)
    specs = ref_sharding.param_specs(rshapes, rcfg, rctx)
    sizes = dict(zip(axes, shape))
    want = sum(_ref_rank_bytes(leaf, spec, sizes) for leaf, spec in zip(
        jax.tree.leaves(rshapes),
        jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, tuple))))
    with D.fake_world(math.prod(shape)):
        params = init_params_shape(PC.ARCHS[arch],
                                   _port_ctx(mesh_kind, mode), device="cpu")
    assert not torch.distributed.is_initialized()
    assert D.tree_bytes(params) == want


def _state_factor(kind, name, leaf_shape, spec, sizes, B, heads):
    """The port's rank bytes of a serve-state leaf over the reference's
    (ROADMAP C, "Edges"): DAC's control rows, MLA's latent cache, a KV
    cache whose heads do not divide ``model`` and the sLSTM cell's state
    are whole on every model rank, and so is an mLSTM's state where its
    heads do not split over ``model`` (a rank holds whole heads), where
    the reference splits them over ``model``; Mamba's channels split over ``(model, data)``, so with a
    batch that does not split over the batch axes a rank holds a
    ``data``-th of the reference's."""
    tp = sizes["model"]
    bsz = sizes["data"] * sizes.get("pod", 1)
    over_model = any(e == "model" or (isinstance(e, tuple) and "model" in e)
                     for e in spec)
    whole = (name in ("rank2slot", "free", "slot_pos", "latent", "krope")
             or kind == "slstm" or (kind == "mlstm" and heads % tp)
             or (name in ("k", "v") and leaf_shape[2] % tp))
    if whole:
        return tp if over_model else 1
    if kind == "mamba" and B % bsz:
        return 1 / sizes["data"]
    return 1


@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_serve_state_bytes_equal_reference(arch, shape, mesh_kind):
    """Rank 0's block of the serve state (``serve_state_specs(sctx=)``,
    serve mode) holds what the reference's ``serve_state_shardings`` give
    a rank, but for the documented differences (``_state_factor``)."""
    mshape, axes = MESHES[mesh_kind]
    rcfg, cell = RC.ARCHS[arch], PC.SHAPES[shape]
    rctx = ref_sharding.ShardCtx(mesh=RAbstractMesh(mshape, axes),
                                 pod="pod" if "pod" in axes else None,
                                 mode="serve")
    B = cell.global_batch
    rstate = ref_serve.serve_state_specs(rcfg, B, cell.seq_len,
                                         budget=cell.bounded_budget)
    rsh = ref_serve.serve_state_shardings(rcfg, rctx, rstate)
    sizes = dict(zip(axes, mshape))
    want = collections.Counter()
    flat = jax.tree_util.tree_flatten_with_path(rstate)[0]
    for (path, leaf), sh in zip(flat, jax.tree.leaves(rsh)):
        keys = [p.key for p in path]
        kind = (rcfg.period[int(keys[1][1:])].kind if keys[0] == "layers"
                else None)
        n = _ref_rank_bytes(leaf, sh.spec, sizes)
        shp = leaf.shape[1:] if kind else leaf.shape
        want[kind] += n * _state_factor(kind, keys[-1], shp, sh.spec, sizes,
                                        B, rcfg.n_heads)
    with D.fake_world(math.prod(mshape)):
        state = serve_state_specs(PC.ARCHS[arch], B, cell.seq_len,
                                  cell.bounded_budget,
                                  sctx=_port_ctx(mesh_kind, "serve"),
                                  device="cpu")
    got = collections.Counter({None: D.tree_bytes(state["pos"])})
    cfg = PC.ARCHS[arch]
    for layer, st in enumerate(state["layers"]):
        got[cfg.period[layer % len(cfg.period)].kind] += D.tree_bytes(st)
    assert dict(got) == pytest.approx(dict(want), rel=0, abs=0)


# -- roofline laws and the report --------------------------------------------

@pytest.mark.parametrize("terms", [(1.0, 2.0, 0.5), (3.0, 2.0, 0.5),
                                   (1.0, 2.0, 2.5), (1.0, 1.0, 1.0)])
def test_dominant_term_equals_reference(terms):
    t = dict(zip(("compute_s", "memory_s", "collective_s"), terms))
    assert R.dominant_term(t) == ref_roofline.dominant_term(t)


@pytest.mark.parametrize("W", [1, 128, 1024, 4096, 419430])
def test_policy_step_laws_equal_reference(W):
    """The traffic law is the reference's; the target is the same law at
    this card's HBM rate."""
    assert R.policy_step_traffic_bytes(W) == \
        ref_roofline.policy_step_traffic_bytes(W)
    got = R.policy_step_targets([W])[W]
    want = ref_roofline.policy_step_targets([W])[W]
    assert got == pytest.approx(want * R.HBM_BW / ref_roofline.HBM_BW,
                                rel=1e-12)


def _record(arch, shape, mesh, k):
    terms = (1e-3 * (k + 1), 2.5e-2 / (k + 1), 7.0 * k)
    rf = {"compute_s": terms[0], "memory_s": terms[1],
          "collective_s": terms[2],
          "dominant": max(zip(terms, ("compute_s", "memory_s",
                                      "collective_s")))[1],
          "roofline_fraction": 0.1234 / (k + 1),
          "useful_flops_ratio": 0.75 + k / 100,
          "kernel_credited": {"memory_s": 3e-7 * k,
                              "roofline_fraction": 0.5 / (k + 2)}}
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": k % 5 != 3,
            "roofline": rf}


def test_report_table_equals_reference(tmp_path):
    """The same records give the reference's table text, both meshes; a
    tagged file stays out of the table."""
    k = 0
    for arch in ARCHS[:4]:
        for shape in SHAPES:
            for mesh in ("pod", "multipod"):
                rec = _record(arch, shape, mesh, k)
                (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
                    json.dumps(rec))
                k += 1
    (tmp_path / f"{ARCHS[0]}__{SHAPES[0]}__pod__t.json").write_text(
        json.dumps(_record(ARCHS[0], SHAPES[0], "pod", 99)))
    got, want = port_report.load(tmp_path), ref_report.load(str(tmp_path))
    assert got == want and len(got) == 32
    for mesh in ("pod", "multipod"):
        assert port_report.table(got, mesh) == ref_report.table(want, mesh)
    for x in (0.0, 3e-7, 2.5e-3, 0.7, 12.0, 345.0):
        assert port_report.fmt_s(x) == ref_report.fmt_s(x)


# -- the counter -----------------------------------------------------------------

FLOP_B, FLOP_S = 2, 64


def _prefill_products(cfg, B, S):
    """Flops of the matrix products of a dense model's prefill with the
    plain attention, which takes every (q, k) pair, and logits for the
    last position only."""
    d, hd, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = B * S
    per_layer = (2 * tokens * d * hd * (H + 2 * Hkv)     # q, k, v
                 + 2 * 2 * B * H * S * S * hd            # q.k, p.v
                 + 2 * tokens * H * hd * d               # out projection
                 + 3 * 2 * tokens * d * cfg.d_ff)        # gated MLP
    return cfg.n_layers * per_layer + 2 * B * d * cfg.vocab


def _counted_prefill(cfg, B, S, attribute=False):
    from repro_torch.serving import prefill
    with FakeTensorMode() as mode:
        params = init_params_shape(cfg, device="cpu", mode=mode)
        tokens = torch.zeros((B, S), dtype=torch.int64)
        with torch.no_grad(), R.StepCounter(attribute=attribute) as c:
            prefill(params, cfg, tokens=tokens, max_len=S, impl="plain")
    return c


def test_counter_flops_equal_closed_form_and_hlo_analysis():
    """A dense smoke prefill: the counter's flops are exactly the closed
    form of its products, and within ``HLO_FLOPS_RTOL`` of the
    reference's loop-aware HLO analysis of its compiled prefill."""
    cfg = PC.SMOKE_ARCHS["deepseek-7b"]
    c = _counted_prefill(cfg, FLOP_B, FLOP_S)
    got = c.result()
    assert got["flops"] == _prefill_products(cfg, FLOP_B, FLOP_S)
    # the plain attention's products are in f32, the rest in the model's
    # dtype
    attn = cfg.n_layers * 2 * 2 * FLOP_B * cfg.n_heads * FLOP_S ** 2 \
        * cfg.head_dim
    assert got["flops_by_rate"].get("f32", 0) == attn + (
        got["flops"] - attn if cfg.dtype == torch.float32 else 0)

    rcfg = RC.SMOKE_ARCHS["deepseek-7b"]

    def fn(params, tokens):
        return ref_serve.prefill(params, rcfg, tokens=tokens, max_len=FLOP_S)
    lowered = jax.jit(fn).lower(
        ref_model.init_params_shape(rcfg),
        jax.ShapeDtypeStruct((FLOP_B, FLOP_S), jnp.int32))
    hlo = ref_roofline.analyze_hlo(lowered.compile().as_text())["flops"]
    assert got["flops"] == pytest.approx(hlo, rel=HLO_FLOPS_RTOL)


def test_counter_tags_attention_and_attributes_ops():
    """The plain attention's bytes are tagged (its ops, and no other), the
    kernel credit of the cell replaces them, and the profile names the
    functions that issued the ops."""
    cfg = PC.SMOKE_ARCHS["deepseek-7b"]
    c = _counted_prefill(cfg, FLOP_B, FLOP_S, attribute=True)
    ana = c.result()
    ana["rows"] = dict(c.rows)
    attn = sum(b for (kind, _, fn), (b, _) in c.rows.items()
               if kind == "hbm" and fn.startswith(
                   "kernels.flash_attention.attention_dense"))
    assert 0 < ana["hbm_attention_inner"] == attn < ana["hbm_bytes"]
    assert ana["collective_counts"] == {} and ana["wire_bytes"] == 0
    text = P.profile_text(ana, top=5)
    assert "models.layers.mlp_apply" in text or "models.layers" in text
    assert text.startswith("terms: compute=")
    assert ana["peak_live_bytes"] > 0


def test_counter_tags_attention_in_the_backward_pass():
    """A train step's backward ops of the plain attention are tagged
    through their autograd nodes: more attention-inner bytes than the
    forward alone."""
    cfg = PC.SMOKE_ARCHS["deepseek-7b"]
    fwd = _counted_prefill(cfg, FLOP_B, FLOP_S).result()
    from repro_torch.models import lm_loss
    with FakeTensorMode() as mode:
        params = init_params_shape(cfg, device="cpu", mode=mode)
        batch = {"tokens": torch.zeros((FLOP_B, FLOP_S), dtype=torch.int32),
                 "labels": torch.zeros((FLOP_B, FLOP_S), dtype=torch.int32)}
        leaves = [p for layer in params["layers"] for g in layer.values()
                  for p in (g.values() if isinstance(g, dict) else [g])]
        for p in leaves:
            p.requires_grad_(True)
        with R.StepCounter() as c:
            loss = lm_loss(params, cfg, batch, remat="none")
            torch.autograd.grad(loss, leaves, allow_unused=True)
    got = c.result()
    assert got["hbm_attention_inner"] > 1.5 * fwd["hbm_attention_inner"]


def test_counter_in_a_fake_world_equals_a_gloo_world(tmp_path):
    """Smoke decodes on a (data 2, model 2) mesh: the collectives the hook
    records on a fake world of 4 on fake tensors equal those on rank 0 of
    a real gloo world of 4 (``_torch_worlds.collectives_world``)."""
    real = M.launch_world(worlds.collectives_world, 4,
                          init_file=str(tmp_path / "init"), device="cpu",
                          timeout=WORLD_TIMEOUT)[0]
    fake = []
    with D.fake_world(4):
        mesh = M.make_test_mesh(2, 2, device_type="cpu")
        sctx = dataclasses.replace(M.shard_ctx(mesh), mode="serve")
        for name, budget in worlds.DRYRUN_CASES:
            cfg = PC.SMOKE_ARCHS[name]
            with FakeTensorMode() as mode:
                params = init_params_shape(cfg, sctx, "cpu", mode)
                state = serve_state_specs(cfg, worlds.DRYRUN_B,
                                          worlds.DRYRUN_LEN, budget,
                                          sctx=sctx, device="cpu", mode=mode)
                token = torch.zeros(worlds.DRYRUN_B, dtype=torch.int64)
                fake.append(worlds.decode_collectives(cfg, sctx, params,
                                                      state, token))
    assert not torch.distributed.is_initialized()
    assert fake == real
    assert all(r["collective_counts"]["all-gather"] > 0 for r in real)
    assert all(r["wire_by_link"].keys() == {"nvlink"} for r in real)


# -- the mesh on fake tensors ------------------------------------------------

def test_mesh_collectives_run_on_a_fake_world_of_256():
    """``gather``, ``reduce_scatter`` and ``seq_sum`` trace on fake tensors
    in a fake world of 256 ranks (the production mesh), with the ring
    wire bytes the counter charges and the groups' links."""
    with D.fake_world(256):
        mesh = M.make_production_mesh(device_type="cpu")
        with FakeTensorMode(), R.StepCounter() as c:
            x = torch.zeros((32, 8), dtype=torch.float32)
            parts = M.gather(x, mesh, "model")
            rs = M.reduce_scatter(x, mesh, "data", dim=0)
            total = M.seq_sum(x, mesh, ("model",))
        assert M._members(mesh, "model", mesh.get_group("model"))[1] == \
            list(range(16))
    assert not torch.distributed.is_initialized()
    assert len(parts) == 16 and parts[3].shape == (32, 8)
    assert rs.shape == (2, 8) and total.shape == (32, 8)
    res = c.result()
    xb = 32 * 8 * 4
    assert res["collective_counts"] == {"all-gather": 2.0,
                                        "reduce-scatter": 1.0}
    assert res["collective_bytes"] == {"all-gather": 2 * 15 * xb,
                                       "reduce-scatter": 15 / 16 * xb}
    assert res["sum_wire_bytes"] == 15 * xb
    assert res["sum_ring_allreduce_bytes"] == 2 * 15 / 16 * xb
    # the model axis's group spans 16 consecutive ranks: two nodes
    assert set(res["wire_by_link"]) == {"network"}


def test_fake_world_refuses_a_live_group_and_leaves_none(tmp_path):
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
        world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group is up"):
            with D.fake_world(4):
                pass
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(ZeroDivisionError):
        with D.fake_world(4):
            1 / 0
    assert not torch.distributed.is_initialized()


def test_run_cell_records_a_failure_as_data(tmp_path, monkeypatch, capsys):
    """A cell that fails writes ``ok: false`` with its cause; one that
    runs writes the reference's sections and the report reads it."""
    monkeypatch.setitem(PC.ARCHS, "deepseek-7b",
                        PC.SMOKE_ARCHS["deepseek-7b"])
    monkeypatch.setitem(PC.SHAPES, "decode_32k",
                        PC.ShapeCell("decode_32k", 64, 32, "decode"))

    def boom(*a, **k):
        raise ValueError("no such thing")
    ok = D.run_cell("deepseek-7b", "decode_32k", "pod", str(tmp_path),
                    device="cpu")
    assert ok["ok"] and ok["n_chips"] == 256
    assert {"memory", "roofline", "trace_s"} <= ok.keys()
    assert ok["roofline"]["kernel_credited"]["kernel_bytes"] > 0
    assert ok["memory"]["argument_bytes"] > 0
    monkeypatch.setattr(D, "_cell_step", boom)
    bad = D.run_cell("deepseek-7b", "decode_32k", "multipod", str(tmp_path),
                     device="cpu")
    assert not bad["ok"] and bad["error"] == "ValueError: no such thing"
    assert not torch.distributed.is_initialized()
    cells = port_report.load(tmp_path)
    assert len(cells) == 2
    assert "| deepseek-7b | decode_32k |" in port_report.table(cells)
    assert "[dryrun] deepseek-7b__decode_32k__multipod: ok=False" in \
        capsys.readouterr().out
