"""Sharded serving of the dense-attention configurations (``prefill`` and
``decode_step`` with ``sctx=``) against the unsharded port and against
the reference's own sharded decode.

The port runs in a 4-rank gloo world on the CPU, a (data 2, model 2)
mesh, f32 smoke configs (deepseek-7b, and gemma2-27b with its window,
softcaps and tied embedding), both ShardCtx modes, prefill and 6
teacher-forced decode steps at budgets 0 and 32: the whole batch's
logits on every rank within ``TOL`` of the unsharded port's (the two sum
the heads' outputs, the MLP's width and the attention mass in other
orders), and DAC's control state equal to the unsharded one's after every
step; the other four dense configurations in serve mode; and gemma2-27b
on a (pod 2, data 1, model 2) mesh of the same ranks, with a batch that
splits and one that does not.

The reference's sharded decode (the program of ``test_distributed.py::
test_serve_decode_sharded``) runs in a subprocess with 4 forced XLA host
devices.  On this jax ``jax.make_mesh`` builds Explicit axes, under which
the embedding gather raises ``ShardingTypeError``; the subprocess builds
its mesh as ``jax.sharding.Mesh(devices.reshape(2, 2), ("data",
"model"))``, whose axes are Auto (a test-side shim; the reference is not
edited).  Its logits from a fresh bounded state, with its parameters
carried to the port, hold the port's sharded decode to ``TOL``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

import _torch_worlds as worlds  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
TOL = 1e-4
NAMES = ("deepseek-7b", "gemma2-27b")
BUDGETS = (0, 32)
STEPS = 6

REFERENCE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.launch.mesh import shard_ctx
from repro.models import init_params, shardings
from repro.serving import init_serve_state
from repro.serving.serve_step import decode_step, serve_state_shardings
out_file, steps = sys.argv[1], int(sys.argv[2])
cfg = dataclasses.replace(SMOKE_ARCHS["deepseek-7b"], param_dtype="float32")
# the shim: Auto axes (jax.make_mesh now builds Explicit ones)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
sctx = shard_ctx(mesh)
params = init_params(cfg, jax.random.PRNGKey(0))
host_params = jax.tree.map(np.asarray, params)
params = jax.tree.map(jax.device_put, params, shardings(params, cfg, sctx))
state = init_serve_state(cfg, 4, max_len=64, budget=32)
state = jax.tree.map(jax.device_put, state,
                     serve_state_shardings(cfg, sctx, state))
step = jax.jit(lambda p, s, t: decode_step(p, cfg, s, token=t, sctx=sctx))
tokens = np.random.default_rng(5).integers(0, cfg.vocab, (steps, 4)
                                           ).astype(np.int32)
logits = []
for t in tokens:
    state, lg = step(params, state, jnp.asarray(t))
    logits.append(np.asarray(lg))
np.savez(out_file, params=np.array(host_params, dtype=object),
         tokens=tokens, logits=np.stack(logits))
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    ref = tmp / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(ref),
                          str(STEPS)], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    return M.launch_world(worlds.serve_world, 4,
                          (NAMES, BUDGETS, STEPS, str(ref)),
                          init_file=str(tmp / "init"), device="cpu",
                          timeout=TIMEOUT)


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_serving_equals_unsharded(served, name, budget, mode):
    """Every rank's whole-batch logits within ``TOL`` of the unsharded
    port's at the prefill and each decode step; in the bounded regime the
    control state of every layer, gathered over ``data``, equal to the
    unsharded one's after every step, on every rank."""
    for out in served:
        got, want, ctrl = out[(name, mode, budget)]
        assert got.shape == want.shape == (STEPS + 1,) + want.shape[1:]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        if budget:
            assert ctrl and all(ctrl)
    # every rank returned the same logits bit for bit
    for out in served[1:]:
        np.testing.assert_array_equal(out[(name, mode, budget)][0],
                                      served[0][(name, mode, budget)][0])


@pytest.mark.parametrize("name", worlds.DENSE)
def test_every_dense_configuration_serves_sharded(served, name):
    """The other four dense-attention configurations (qkv biases, GQA
    groups, musicgen's and llava's embeddings in place of tokens) on the
    (2, 2) mesh in serve mode, bounded: logits within ``TOL`` of the
    unsharded port's at the prefill and 3 decode steps."""
    for out in served:
        got, want = out[("dense", name)]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("B,rows", [(4, 2), (3, 3)])
def test_sharded_serving_on_a_pod_mesh(served, B, rows):
    """On a (pod 2, data 1, model 2) mesh the batch splits over (pod,
    data) when it divides (each rank holds ``B / 2`` rows) and is whole
    on every rank when it does not; gemma2-27b's logits within ``TOL``
    of the unsharded port's either way."""
    for out in served:
        got, want, held = out[("pod", B)]
        assert held == rows
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_sharded_decode_equals_reference_sharded_decode(served):
    """The reference's own sharded bounded decode (6 steps from a fresh
    state on a (2, 2) mesh) and the port's, from the same parameters and
    tokens: logits within ``TOL``."""
    for out in served:
        got, want = out["vs_reference"]
        assert got.shape == want.shape == (STEPS, 4, want.shape[-1])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
