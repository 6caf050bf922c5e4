"""The port's mesh (``launch/mesh.py``), sharding rules
(``models/sharding.py``) and lane-sharded replay (``Engine(mesh=)``,
``run_sweep(mesh=)``) against the reference and the unsharded port.

The placement tables are held leaf for leaf against the reference's
``PartitionSpec`` s on ``jax.sharding.AbstractMesh`` es (no devices
needed), through ``models/convert.py``'s layout mapping: the port's layer
``l`` is slot ``l % len(period)`` of the reference's period stack, whose
placements carry a leading ``None`` for the stack.  The lane-sharded
replays run in gloo worlds of 2 and 4 CPU ranks (``launch_world``, a
``file://`` rendezvous under ``tmp_path`` and a timeout each) and must
equal the unsharded runs bit for bit.
"""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh as RAbstractMesh  # noqa: E402

import _torch_worlds as worlds  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.models.model import init_params_shape  # noqa: E402
from repro.serving import serve_step as ref_serve  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.data.traces import zipf_trace  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402
from repro_torch.serving import init_serve_state  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
STATE_B, STATE_LEN, STATE_BUDGETS = 32, 64, (0, 32)
WORLD_TIMEOUT = 120


def _ctxs():
    for shape, axes in MESHES:
        pod = "pod" if "pod" in axes else None
        for mode in ("train", "serve"):
            yield (f"{shape}/{mode}",
                   ref_sharding.ShardCtx(mesh=RAbstractMesh(shape, axes),
                                         pod=pod, mode=mode),
                   S.ShardCtx(mesh=S.AbstractMesh(shape, axes), pod=pod,
                              mode=mode))


def _cfgs(name, size):
    table = "ARCHS" if size == "full" else "SMOKE_ARCHS"
    return (getattr(ref_configs, table)[name],
            getattr(port_configs, table)[name])


def _spec(p):
    return tuple(p)


def _walk(port, ref, plen, what, stacked=False):
    """Yield (path, port placement, reference placement) over the port's
    tree, the reference's period stack mapped to the port's layers."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), what
        for k in port:
            yield from _walk(port[k], ref[k], plen, f"{what}/{k}", stacked)
    elif isinstance(port, list):
        for layer, p in enumerate(port):
            yield from _walk(p, ref[f"l{layer % plen}"], plen,
                             f"{what}[{layer}]", True)
    else:
        want = _spec(ref.spec if hasattr(ref, "spec") else ref)
        if stacked:
            assert want[0] is None, (what, want)
            want = want[1:]
        yield what, tuple(port), want


NAMES = sorted(port_configs.ARCHS)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(name, size):
    return init_params_shape(_cfgs(name, size)[0])


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_reference(name, size):
    """``param_specs`` for both modes on (1,1), (2,2), (16,16) and
    (2,16,16) meshes: every leaf's placement is the reference's."""
    rcfg, pcfg = _cfgs(name, size)
    rshapes, pshapes = _ref_param_shapes(name, size), param_shapes(pcfg)
    n = 0
    for what, rctx, pctx in _ctxs():
        want = ref_sharding.param_specs(rshapes, rcfg, rctx)
        got = S.param_specs(pshapes, pcfg, pctx)
        for path, g, w in _walk(got, want, len(pcfg.period), what):
            assert g == w, (path, g, w)
            n += 1
    assert n > 0


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_serve_state_shardings_equal_reference(name, size):
    """``serve_state_shardings`` over the port's (meta-device) serve state
    in both regimes equals the reference's over its ``serve_state_specs``,
    leaf for leaf, on every mesh and mode."""
    rcfg, pcfg = _cfgs(name, size)
    for budget in STATE_BUDGETS:
        rstate = ref_serve.serve_state_specs(rcfg, STATE_B, STATE_LEN,
                                             budget)
        pstate = init_serve_state(pcfg, STATE_B, STATE_LEN, budget,
                                  device="meta")
        for what, rctx, pctx in _ctxs():
            want = ref_serve.serve_state_shardings(rcfg, rctx, rstate)
            got = S.serve_state_shardings(pcfg, pctx, pstate)
            for path, g, w in _walk(got, want, len(pcfg.period),
                                    f"{what}/{budget}"):
                assert g == w, (path, g, w)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_ranks(multi_pod):
    """Without 256 (512) ranks the production mesh raises the reference's
    message (its remedy names the port's launcher, not XLA's flag)."""
    with pytest.raises(RuntimeError) as ref:
        ref_mesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError) as port:
        M.make_production_mesh(multi_pod=multi_pod)
    head = str(ref.value).split(" — ")[0]
    assert head.startswith("need ")
    assert str(port.value).split(" — ")[0] == head


def test_nccl_needs_a_gpu_per_rank(tmp_path):
    """NCCL asked for more ranks than the host has GPUs raises before
    joining any world; it never falls back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    init = f"file://{tmp_path / 'init'}"
    with pytest.raises(RuntimeError, match="one GPU a rank"):
        M.init_distributed("nccl", init, rank=0, world_size=2)
    with pytest.raises(ValueError, match="CUDA devices only"):
        M.init_distributed("nccl", init, rank=0, world_size=1, device="cpu")
    assert not torch.distributed.is_initialized()


def test_ranks_default_to_the_card(tmp_path):
    """A world's ranks and meshes are on the card unless the caller asks
    for the CPU: with no card, ``launch_world``'s default fails its rank
    (NCCL, the CUDA default, finds no GPU), and a mesh whose rank did not
    join through ``init_distributed`` names no device by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        M.launch_world(worlds.engine_world, 1, (1,),
                       init_file=str(tmp_path / "init"), timeout=60)
    with pytest.raises(RuntimeError, match="device_type="):
        M._device_type(None)
    assert M._device_type("cpu") == "cpu"


def test_mesh_arguments_are_checked():
    """A mesh that is not a ``DeviceMesh`` raises ``TypeError``; a mesh
    needs a world."""
    keys = np.zeros((4, 8), np.int32)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(device="cpu", mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(device="cpu").replay("dac", keys, 4, mesh=object())
    with pytest.raises(RuntimeError, match="init_distributed"):
        M.make_test_mesh(2, 2, device_type="cpu")


def test_sharded_serving_is_dense_only():
    """Sharded serving is no longer dense only: MoE, MLA and recurrent
    layers are not refused under a ShardCtx (ROADMAP A13.2 is ported).
    On a mesh with no ranks behind it they ask for a ``DeviceMesh``
    before any collective; so does a rematerialised forward, which
    sharded training runs (A13.3 is ported: it no longer raises)."""
    from repro_torch.models import forward
    from repro_torch.serving import decode_step, prefill
    sctx = S.ShardCtx(mesh=S.AbstractMesh((2, 2), ("data", "model")))
    toks = torch.zeros((4, 8), dtype=torch.long)
    for name in ("deepseek-v2-236b", "mixtral-8x22b", "jamba-1.5-large-398b",
                 "xlstm-125m"):
        cfg = port_configs.SMOKE_ARCHS[name]
        with pytest.raises(TypeError, match="DeviceMesh"):
            prefill({}, cfg, tokens=toks, sctx=sctx)
        with pytest.raises(TypeError, match="DeviceMesh"):
            decode_step({}, cfg, {"pos": None}, token=toks[:, 0], sctx=sctx)
        with pytest.raises(TypeError, match="DeviceMesh"):
            init_serve_state(cfg, 4, 16, sctx=sctx, device="meta")
        with pytest.raises(TypeError, match="DeviceMesh"):
            forward({}, cfg, tokens=toks, sctx=sctx, remat="full")


@pytest.fixture(scope="module", params=[2, 4])
def engine_world(request, tmp_path_factory):
    world = request.param
    init = tmp_path_factory.mktemp(f"engine{world}") / "init"
    return world, M.launch_world(worlds.engine_world, world, (world,),
                                 init_file=str(init), device="cpu",
                                 timeout=WORLD_TIMEOUT)


@pytest.mark.parametrize("policy", worlds.POLICIES)
def test_engine_mesh_equals_unsharded(engine_world, policy):
    """``Engine(mesh=)`` at 2 and 4 gloo ranks: every rank returns the
    unsharded result bit for bit (info, totals, observables), with and
    without ``collect_info``."""
    world, outs = engine_world
    for out in outs:
        for info in (True, False):
            got, want = out["replay"][(policy, info)]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{policy} {info} {k}")


def test_engine_mesh_edges(engine_world):
    """A ``[T]`` request ignores the mesh; lanes that do not divide raise
    ``ValueError``."""
    world, outs = engine_world
    keys = zipf_trace(N=200, T=300, alpha=0.9, seed=0).astype(np.int32)
    want = Engine(device="cpu").replay("dac", keys, 16).info.hit.numpy()
    for out in outs:
        np.testing.assert_array_equal(out["single"], want)
        assert "divide evenly" in out["indivisible"]


def test_run_sweep_mesh_equals_unsharded(engine_world):
    """``run_sweep(mesh=)`` records equal the unsharded grid's on every
    rank; a forced stream runs unsharded, warns, and gives the same
    records."""
    world, outs = engine_world
    for out in outs:
        got, want = out["sweep"]
        assert got == want and len(got) == len(worlds.POLICIES) * 2
        assert out["streamed"] == want
        assert len(out["stream_warned"]) == len(want)
        assert all("does not consult mesh" in w
                   for w in out["stream_warned"])


def test_sharded_cfg_helpers_take_the_reference_layout():
    """``ShardCtx`` keeps the reference's fields and batch axes."""
    pctx = S.ShardCtx(mesh=S.AbstractMesh((2, 4, 8), ("pod", "data",
                                                      "model")), pod="pod")
    rctx = ref_sharding.ShardCtx(
        mesh=RAbstractMesh((2, 4, 8), ("pod", "data", "model")), pod="pod")
    assert pctx.batch_axes == rctx.batch_axes
    assert pctx._bsz() == rctx._bsz() == 8
    assert pctx.axis_size("model") == rctx.axis_size("model") == 8
    assert [f.name for f in dataclasses.fields(pctx)] == \
        [f.name for f in dataclasses.fields(rctx)]
