"""The compressed multi-pod step (``repro_torch.train.compression``,
``make_compressed_train_step``, ``init_ef_state``) against the
reference's.

* ``_quantize`` and ``_dequantize`` bit for bit the reference's on
  numpy inputs, with ties at .5 (both round half to even), all-zero
  blocks and a ragged last block;
* ``ef_allgather_mean`` in a 2-rank pod world of gloo ranks: the mean and
  the new error feedback bit for bit the reference's inside a
  ``shard_map`` over 2 forced XLA host devices (a subprocess);
* the sync on a (pod 2, data 2) world, each rank holding its block
  within its pod, equals the pure-pod sync of the whole leaves bit for
  bit, for leaves quantized on the block and leaves gathered whole;
* the reference test's program (``test_distributed.py::
  test_compressed_grad_sync_tracks_uncompressed``: deepseek-7b smoke,
  bf16, 8 steps, 2 pods): the port's compressed step within 0.01 of its
  uncompressed step at the last step (the reference's own bound), and
  each step's loss within ``REF_TOL`` of the reference's compressed
  step's, from the reference's parameters (bf16 on both sides: the two
  sides' sums differ in their last bits, which bf16 parameters carry);
* ``init_ef_state`` in the reference's layout, path for path and shape
  for shape.

About 20 s on one worker.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_train_worlds as worlds  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.train import compression as ref_comp  # noqa: E402
from repro.train import init_ef_state as ref_init_ef  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import (params_from_reference,  # noqa: E402
                                stacked_view)
from repro_torch.train import compression, init_ef_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
STEPS = 8
TRACK = 0.01        # compressed against uncompressed (the reference's)
REF_TOL = 0.01      # the port's against the reference's (seen: 0.002)
SHAPES = [(1000,), (3, 256), (7, 33), (2, 4, 64)]

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import SMOKE_ARCHS
from repro.data.tokens import TokenPipeline
from repro.models import init_params
from repro.optim import AdamWConfig, adamw
from repro.train import (init_ef_state, make_compressed_train_step,
                         make_train_step)
from repro.train.compression import ef_allgather_mean
from repro.train.train_step import _shard_map
out_file, in_file, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("pod",))
inputs = np.load(in_file)
means, efs = [], []
for i in range(len(inputs.files) // 2):
    g, e = inputs[f"g{i}"], inputs[f"e{i}"]
    def f(g, e):
        m, ne = ef_allgather_mean(g[0], e[0], "pod")
        return m[None], ne[None]
    m, ne = _shard_map(f, mesh, in_specs=(P("pod"), P("pod")),
                       out_specs=(P("pod"), P("pod")),
                       manual_axes={"pod"})(jnp.asarray(g), jnp.asarray(e))
    means.append(np.asarray(m)); efs.append(np.asarray(ne))
# the reference test's program
cfg = SMOKE_ARCHS["deepseek-7b"]
params = init_params(cfg, jax.random.PRNGKey(0))
host = jax.tree.map(np.asarray, params)
ocfg = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=0,
                   weight_decay=0.0)
pipe = TokenPipeline(cfg.vocab, 8, 32)
plain = jax.jit(make_train_step(cfg, ocfg))
comp = jax.jit(make_compressed_train_step(cfg, ocfg, mesh))
p1, o1 = params, adamw.init(params, ocfg)
p2, o2 = params, adamw.init(params, ocfg)
ef = init_ef_state(params, 2)
losses = {"plain": [], "comp": []}
for t in range(steps):
    b = {k: jnp.asarray(v) for k, v in pipe.batch(t).items()}
    p1, o1, m1 = plain(p1, o1, b)
    p2, o2, ef, m2 = comp(p2, o2, ef, b)
    losses["plain"].append(float(m1["loss"]))
    losses["comp"].append(float(m2["loss"]))
np.savez(out_file, params=np.array(host, dtype=object),
         losses=np.array(losses, dtype=object),
         **{f"m{i}": m for i, m in enumerate(means)},
         **{f"ne{i}": e for i, e in enumerate(efs)})
"""


def _pod_inputs():
    """Per pod: heavy-tailed gradients with an all-zero block, a block
    of ties, and error feedback, for each of ``SHAPES``."""
    rng = np.random.default_rng(7)
    out = {}
    for i, shape in enumerate(SHAPES):
        g = (rng.standard_normal((2,) + shape)
             * np.exp(rng.standard_normal((2,) + shape))).astype(np.float32)
        flat = g.reshape(2, -1)
        flat[:, :compression.BLOCK] = 0.0
        if flat.shape[1] >= 2 * compression.BLOCK:
            tie = np.arange(compression.BLOCK) % 40 + 0.5
            tie[0] = 127.0
            flat[:, compression.BLOCK:2 * compression.BLOCK] = tie
        out[f"g{i}"] = g
        out[f"e{i}"] = (rng.standard_normal((2,) + shape)
                        * 1e-2).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    ref, inp = tmp / "ref.npz", tmp / "in.npz"
    inputs = _pod_inputs()
    np.savez(inp, **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(ref),
                             str(inp), str(STEPS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        means = [M.launch_world(worlds.ef_mean_world, 2,
                                (inputs[f"g{i}"], inputs[f"e{i}"]),
                                init_file=str(tmp / f"mean{i}"),
                                device="cpu", timeout=TIMEOUT)
                 for i in range(len(SHAPES))]
        payload = M.launch_world(worlds.payload_world, 4, ("deepseek-7b",),
                                 init_file=str(tmp / "payload"),
                                 device="cpu", timeout=TIMEOUT)
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    steps = M.launch_world(worlds.compressed_world, 2, (str(ref), STEPS),
                           init_file=str(tmp / "steps"), device="cpu",
                           timeout=TIMEOUT)
    return {"ref": np.load(ref, allow_pickle=True), "means": means,
            "payload": payload, "steps": steps}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_dequantize_equal_reference(shape):
    """Bit for bit, with an all-zero block and a block of .5 ties (a
    block's max 127, so its scale is 1 and every other element sits on
    a tie)."""
    g = _pod_inputs()[f"g{SHAPES.index(shape)}"][0]
    rq, rs = ref_comp._quantize(jnp.asarray(g))
    q, s = compression._quantize(torch.from_numpy(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert (s == 0).any()
    np.testing.assert_array_equal(
        compression._dequantize(q, s, shape).numpy(),
        np.asarray(ref_comp._dequantize(rq, rs, shape)))


def test_quantize_rounds_ties_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 250)
    q, s = compression._quantize(x)
    assert float(s[0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_ef_allgather_mean_equals_reference(compressed, i):
    """Each pod's mean and new error feedback, bit for bit the
    reference's ``shard_map`` over two devices; the mean the same on
    both pods."""
    ref = compressed["ref"]
    for pod, (mean, new_ef) in enumerate(compressed["means"][i]):
        np.testing.assert_array_equal(mean, ref[f"m{i}"][pod])
        np.testing.assert_array_equal(new_ef, ref[f"ne{i}"][pod])


def test_sharded_payload_equals_pure_pod(compressed):
    """(pod 2, data 2): every leaf's mean and error feedback are the
    pure-pod sync's of the whole leaves, on every rank; deepseek-7b's
    smoke leaves include leaves quantized on the rank's block (runs of
    whole 256-element blocks: ``lm_head``) and leaves gathered whole."""
    for rank, out in enumerate(compressed["payload"]):
        assert any(r["local"] for r in out.values())
        assert not all(r["local"] for r in out.values())
        assert out["lm_head"]["local"], out["lm_head"]
        for path, row in out.items():
            assert row["mean"] and row["ef"], (rank, path, row)


def test_compressed_step_tracks_uncompressed_and_reference(compressed):
    """The reference test's program on the port: the last compressed loss
    within ``TRACK`` of the uncompressed one, the loss below 7, and each
    compressed step's loss within ``REF_TOL`` of the reference's; both
    pods report the same losses."""
    ref = compressed["ref"]["losses"].item()
    rows = [out["losses"] for out in compressed["steps"]]
    assert rows[0] == rows[1]
    got = rows[0]
    assert len(got["comp"]) == STEPS
    assert abs(got["plain"][-1] - got["comp"][-1]) < TRACK, got
    assert got["comp"][-1] < 7.0
    np.testing.assert_allclose(got["comp"], ref["comp"], rtol=0,
                               atol=REF_TOL)
    np.testing.assert_allclose(got["plain"], ref["plain"], rtol=0,
                               atol=REF_TOL)


def test_init_ef_state_layout_equals_reference(compressed):
    """``init_ef_state(stacked_view(params), 2)``: the reference's tree,
    each leaf ``[2, *leaf]`` f32 zeros; the compressed step hands each
    rank its pod's row back."""
    cfg = SMOKE_ARCHS["deepseek-7b"]
    rparams = ref_init(REF_SMOKE["deepseek-7b"], jax.random.PRNGKey(0))
    want = ref_init_ef(rparams, 2)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                   device="cpu")
    got = init_ef_state(stacked_view(params, cfg), 2)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(list(worlds._leaves(got)))
    for path, leaf in flat:
        g = got
        for k in path:
            g = g[k.key]
        assert g.dtype == torch.float32 and not g.any()
        assert tuple(g.shape) == tuple(leaf.shape), path
    for out in compressed["steps"]:
        for shape in out["ef_shapes"].values():
            assert shape[0] == 1
