"""Sharded training (``lm_loss(sctx=)``, ``make_train_step(sctx=)``,
``adamw.update`` on a rank's blocks) against the unsharded port and the
reference's own sharded step.

The port runs in a 4-rank gloo world on the CPU, a (data 2, model 2)
mesh, f32 smoke configs, each rank holding its blocks of the parameters
(``shard_tree`` under the train-mode ``param_specs``) and its rows of one
batch (4 x 16):

* all ten configurations, under remat "full", "dots" and "none": the
  loss within ``LOSS_TOL`` of the unsharded port's, and every rank's
  gradient of every leaf within ``TOL`` (of the leaf's largest
  magnitude) of its block of the unsharded gradient (the largest gap
  seen is 1.6e-5, Mamba's ``dt_w``; the rest ~2e-6: the ranks add the
  heads, the width and the batch in other orders);
* mixtral with two microbatches (each rank's rows of each global
  microbatch, the auxiliary loss over the whole batch);
* deepseek-7b and mixtral on a (pod 2, data 1, model 2) mesh;
* ``adamw.update`` given the same whole gradients (global norm 0.5, so
  both sides clip by exactly 1), cut to blocks, 3 steps: the gathered
  parameters and moments (f32 ``m``/``v``, int8 ``q``/``scale``) equal
  the unsharded update's bit for bit, with leaves whose int8 moments the
  rank quantizes on its block (64-aligned runs) and leaves it updates
  whole (runs of 32 elements);
* the reference's sharded mixtral step (the program of
  ``test_distributed.py::test_sharded_train_step_lowers_and_runs`` in a
  subprocess with 4 forced XLA host devices, in f32, its mesh built as
  ``jax.sharding.Mesh(devices.reshape(2, 2), ("data", "model"))``,
  whose axes are Auto: a test-side shim, the reference is not edited;
  Adam's eps 1e-3, as ``test_torch_train.py``'s ``STEP_OPT``, so that a
  near-zero gradient's sign does not decide a whole step of ``lr``):
  with its parameters carried across, the port's loss within
  ``LOSS_TOL`` and its updated parameters within ``TOL``.

About 15 s on one worker.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

import _torch_train_worlds as worlds  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = 1e-4
LOSS_TOL = 1e-5
REMATS = ("full", "dots", "none")
POD = ("deepseek-7b", "mixtral-8x22b")

REFERENCE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from repro.configs import SMOKE_ARCHS
from repro.launch.mesh import shard_ctx
from repro.models import init_params, shardings
from repro.optim import AdamWConfig, adamw
from repro.train import make_train_step
out_file = sys.argv[1]
cfg = dataclasses.replace(SMOKE_ARCHS["mixtral-8x22b"], param_dtype="float32")
# the shim: Auto axes (jax.make_mesh now builds Explicit ones)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
sctx = shard_ctx(mesh)
params = init_params(cfg, jax.random.PRNGKey(0))
host = jax.tree.map(np.asarray, params)
params = jax.tree.map(jax.device_put, params, shardings(params, cfg, sctx))
kw = dict(lr=1e-3, total_steps=10, warmup_steps=0, eps=1e-3)
ocfg = AdamWConfig(**kw)
opt = adamw.init(params, ocfg)
step = jax.jit(make_train_step(cfg, ocfg, sctx=sctx, n_microbatches=2))
toks = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, cfg.vocab)
params, opt, m = step(params, opt, {"tokens": toks, "labels": toks})
assert bool(np.isfinite(float(m["loss"])))
np.savez(out_file, params=np.array(host, dtype=object),
         new_params=np.array(jax.tree.map(np.asarray, params), dtype=object),
         tokens=np.asarray(toks), loss=float(m["loss"]),
         opt=np.array(kw, dtype=object))
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    ref = tmp / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(ref)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        grads = M.launch_world(worlds.grads_world, 4,
                               (worlds.ALL, REMATS, 4, 16, "mixtral-8x22b",
                                POD),
                               init_file=str(tmp / "grads"), device="cpu",
                               timeout=TIMEOUT)
        opt = M.launch_world(worlds.adamw_world, 4, ("deepseek-7b", 3, 0.5),
                             init_file=str(tmp / "adamw"), device="cpu",
                             timeout=TIMEOUT)
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    step = M.launch_world(worlds.reference_step_world, 4, (str(ref), 2),
                          init_file=str(tmp / "step"), device="cpu",
                          timeout=TIMEOUT)
    return {"grads": grads, "adamw": opt, "step": step}


def _check(row, what):
    assert abs(row["loss"] - row["want_loss"]) <= LOSS_TOL, (what, row)
    assert row["err"] <= TOL, (what, row["worst"], row["err"])
    assert row["leaves"] > 0


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("name", worlds.ALL)
def test_sharded_grads_equal_unsharded_blocks(trained, name, remat):
    """Every rank: the global loss, and its gradient of every leaf equal
    to its block of the unsharded port's gradient, within ``TOL``; every
    rank's loss the same bits."""
    rows = [out[name][remat] for out in trained["grads"]]
    for rank, row in enumerate(rows):
        _check(row, f"{name} {remat} rank {rank}")
    assert len({row["bits"] for row in rows}) == 1


def test_reduce_scatter_is_the_block_of_seq_sum(trained):
    """``launch.mesh.reduce_scatter`` (the gather's adjoint, an
    ``all_to_all``): bit for bit this rank's block of ``seq_sum``, over
    each axis and along each dimension, in f32 and bf16."""
    for rank, out in enumerate(trained["grads"]):
        rows = out["reduce_scatter"]
        assert len(rows) == 8 and all(rows.values()), (rank, rows)


def test_sharded_microbatches_are_global_microbatches(trained):
    """mixtral, two microbatches: each rank's rows of global microbatch
    ``i`` (not a split of its own rows), the auxiliary loss's shares and
    mean probabilities over the whole microbatch: loss and gradients as
    the unsharded two-microbatch step's."""
    for rank, out in enumerate(trained["grads"]):
        _check(out["micro"], f"micro rank {rank}")


@pytest.mark.parametrize("name", POD)
def test_sharded_grads_on_a_pod_mesh(trained, name):
    """(pod 2, data 1, model 2): the batch splits over (pod, data), the
    parameters are whole across ``pod``, their gradients' parts added
    over it."""
    for rank, out in enumerate(trained["grads"]):
        _check(out[("pod", name)], f"pod {name} rank {rank}")


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_sharded_adamw_update_is_bit_for_bit(trained, moments):
    """The same whole gradients, cut to blocks: gathered parameters and
    moments bit for bit the unsharded update's at each of 3 steps, and
    the rank's moments cut again from the whole state equal to its own
    (the elastic restore's path); deepseek-7b's smoke leaves include
    both kinds of int8 leaf."""
    for rank, out in enumerate(trained["adamw"]):
        assert out["local"] and out["whole"], out
        assert "layers/l0/mlp/w_gate/0" in out["local"]
        assert "embed" in out["whole"]
        for i, row in enumerate(out[moments]):
            assert row["params"] and row["moments"] and row["cut"], \
                (rank, i, row)
            assert row["norm"][0] == pytest.approx(row["norm"][1],
                                                   rel=1e-6)


def test_sharded_step_equals_reference_sharded_step(trained):
    """The reference's sharded mixtral step (2 microbatches) and the
    port's, from the same parameters and batch: the loss within
    ``LOSS_TOL``, every updated parameter within ``TOL``, on every
    rank."""
    for rank, row in enumerate(trained["step"]):
        _check(row, f"reference step rank {rank}")
