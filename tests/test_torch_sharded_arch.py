"""Sharded serving of the configurations with MoE, MLA and recurrent layers
(deepseek-v2-236b, mixtral-8x22b, jamba-1.5-large-398b with all 8 layers,
xlstm-125m) against the unsharded port and against the reference's own
sharded decode.

The port runs in a 4-rank gloo world on the CPU, a (data 2, model 2)
mesh, f32 smoke configs, both ShardCtx modes, prefill and 6
teacher-forced decode steps at budgets 0 and 32, each rank's parameters
from ``init_params(sctx=)`` (equal to ``shard_tree``'s cut of the whole
model).  Checked on every rank: the whole batch's logits within ``TOL``
of the unsharded port's (the two sum the heads' and experts' outputs, the
expert width and the recurrent channels in other orders); DAC's control
state after every step and every MoE routing and drop equal to the
unsharded ones; the recurrent states, gathered, within ``STATE_TOL``.
Besides: mixtral at capacity factor 0.5 and a batch of 16, where decode
drops choices (the whole batch is one dispatch group), and deepseek-v2 on
a (pod 2, data 1, model 2) mesh.

The reference's sharded decode runs in a subprocess with 4 forced XLA
host devices, on a ``jax.sharding.Mesh`` with Auto axes (the shim of
``test_torch_sharded_serve.py``) in serve mode, from a fresh bounded
state; its parameters carried to the port, its logits hold the port's
sharded decode to ``TOL``.
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
TIMEOUT = 180
TOL = 1e-4
STATE_TOL = 1e-4
BUDGETS = (0, 32)
STEPS = 6
MODES = ("serve", "train")
DROPS = ("mixtral-8x22b", 0.5, 16)
POD = "deepseek-v2-236b"

REFERENCE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.launch.mesh import shard_ctx
from repro.models import init_params, shardings
from repro.serving import init_serve_state
from repro.serving.serve_step import decode_step, serve_state_shardings
out_dir, steps = sys.argv[1], int(sys.argv[2])
# the shim: Auto axes (jax.make_mesh now builds Explicit ones)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
sctx = dataclasses.replace(shard_ctx(mesh), mode="serve")
for name in sys.argv[3:]:
    cfg = dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32")
    params = init_params(cfg, jax.random.PRNGKey(0))
    host_params = jax.tree.map(np.asarray, params)
    params = jax.tree.map(jax.device_put, params,
                          shardings(params, cfg, sctx))
    state = init_serve_state(cfg, 4, max_len=64, budget=32)
    state = jax.tree.map(jax.device_put, state,
                         serve_state_shardings(cfg, sctx, state))
    step = jax.jit(lambda p, s, t: decode_step(p, cfg, s, token=t,
                                               sctx=sctx))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (steps, 4)
                                               ).astype(np.int32)
    logits = []
    for t in tokens:
        state, lg = step(params, state, jnp.asarray(t))
        logits.append(np.asarray(lg))
    np.savez(os.path.join(out_dir, name + ".npz"),
             params=np.array(host_params, dtype=object), tokens=tokens,
             logits=np.stack(logits))
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_arch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp),
                          str(STEPS), *worlds.ARCH], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    refs = {name: (str(tmp / f"{name}.npz"), "serve")
            for name in worlds.ARCH}
    return M.launch_world(worlds.serve_world, 4,
                          (worlds.ARCH, BUDGETS, STEPS, refs, MODES, (), POD,
                           DROPS),
                          init_file=str(tmp / "init"), device="cpu",
                          timeout=TIMEOUT)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", worlds.ARCH)
def test_sharded_arch_equals_unsharded(served, name, budget, mode):
    """Every rank's whole-batch logits within ``TOL`` of the unsharded
    port's at the prefill and each decode step, the same bits on every
    rank; the rank's parameters equal to ``shard_tree``'s cut, also when
    the leaves are drawn in slices of rows; in the bounded regime the
    control state of every layer equal to the unsharded one's after every
    step."""
    for out in served:
        row = out[(name, mode, budget)]
        got, want = row["logits"]
        assert got.shape == want.shape == (STEPS + 1,) + want.shape[1:]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert row["init_equal"]
        if budget and name != "xlstm-125m":         # xlstm has no KV cache
            assert row["ctrl_steps"] and row["ctrl_equal"]
    for out in served[1:]:
        np.testing.assert_array_equal(
            out[(name, mode, budget)]["logits"][0],
            served[0][(name, mode, budget)]["logits"][0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ("deepseek-v2-236b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b"))
def test_sharded_moe_routing_equals_unsharded(served, name, mode):
    """Every MoE layer's routing (the experts of each token) and dispatch
    (the choices kept) at the prefill and each decode step equal the
    unsharded port's, on every rank, in both regimes."""
    for out in served:
        for budget in BUDGETS:
            row = out[(name, mode, budget)]
            assert row["routings"] and row["routing_equal"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ("jamba-1.5-large-398b", "xlstm-125m"))
def test_sharded_recurrent_states_equal_unsharded(served, name, mode):
    """The Mamba, mLSTM and sLSTM states after the last decode step,
    gathered over the channel blocks and the batch, within ``STATE_TOL``
    of the unsharded port's."""
    for out in served:
        for budget in BUDGETS:
            row = out[(name, mode, budget)]
            assert row["states"] and row["state_err"] <= STATE_TOL


def test_sharded_moe_drops_equal_unsharded(served):
    """At capacity factor 0.5 and a batch of 16 decode drops choices; the
    sharded step gathers the batch into one dispatch group, so routing,
    drops and logits are the unsharded port's."""
    for out in served:
        row = out["drops"]
        assert row["dropped"] > 0
        assert row["routing_equal"]
        np.testing.assert_allclose(*row["logits"], rtol=0, atol=TOL)


@pytest.mark.parametrize("B,rows", [(4, 2), (3, 3)])
def test_sharded_arch_on_a_pod_mesh(served, B, rows):
    """deepseek-v2 (MLA and MoE with shared experts) on a (pod 2, data 1,
    model 2) mesh: a batch that splits over (pod, data) and one that does
    not; logits within ``TOL`` and routing equal to the unsharded
    port's."""
    for out in served:
        row = out[("pod", B)]
        assert row["rows"] == rows and row["routing_equal"]
        np.testing.assert_allclose(*row["logits"], rtol=0, atol=TOL)


@pytest.mark.parametrize("name", worlds.ARCH)
def test_sharded_arch_equals_reference_sharded_decode(served, name):
    """The reference's own sharded bounded decode in serve mode (6 steps
    from a fresh state on a (2, 2) mesh) and the port's, from the same
    parameters and tokens: logits within ``TOL``."""
    for out in served:
        got, want = out[("reference", name)]
        assert got.shape == want.shape == (STEPS, 4, want.shape[-1])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
