"""Elastic restarts and checkpoints across meshes: ``Trainer(sctx=)`` and
``Trainer.restore_into_mesh``, and ``launch.train --mesh``.

* The reference's program (``test_distributed.py::
  test_elastic_restart_8_to_4_devices``) on the port: deepseek-7b smoke
  (bf16) trains 12 steps on an 8-rank (data 4, model 2) gloo world with
  checkpoints, then a 4-rank (2, 2) world resumes at step 12 and trains
  to 24; the mean of its last 3 losses is below the mean of its first 3
  plus 0.05 (the reference's bound).
* The port's sharded checkpoint (the 8-rank world's step 12) restores
  into the reference's unsharded ``Trainer``: its step-12 loss within
  ``CROSS_TOL`` of the (2, 2) world's (bf16 on both sides, the sums in
  other orders).
* The reference's sharded checkpoint (its trainer on a (2, 2) mesh of 4
  forced XLA host devices in a subprocess, f32, the Auto-axis mesh shim
  of ``test_torch_sharded_serve.py``) restores into the port's (2, 2)
  ``Trainer``: the port's losses at the resumed steps within rtol
  ``RESUME_RTOL`` of the reference's own resumed run.
* Asynchronous saves (``TrainConfig``'s default) under a mesh: every
  rank of a (2, 2) world leaves ``run()`` with the last checkpoint on
  disk, and a (1, 2) world resumes from it.
* ``python -m repro_torch.launch.train --mesh pod`` in a 1-rank world
  fails with the production mesh's "need 256 devices" error.

About 25 s on one worker.
"""
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

import _torch_train_worlds as worlds  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.train import TrainConfig as RefTrainConfig  # noqa: E402
from repro.train import Trainer as RefTrainer  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
ELASTIC_T = dict(steps=24, ckpt_every=8, global_batch=8, seq_len=32,
                 async_ckpt=False)
ELASTIC_O = dict(lr=1e-3, warmup_steps=2, total_steps=24)
CROSS_TOL = 1e-3        # seen: 6.4e-5
RESUME_RTOL = 1e-5      # seen: 2e-7
# the reference's sharded run: 4 steps and a checkpoint, then resumed to 8
REF_T = dict(steps=8, ckpt_every=4, global_batch=8, seq_len=32,
             async_ckpt=False)
REF_O = dict(lr=1e-3, warmup_steps=2, total_steps=8)
# asynchronous saves: 4 steps on (2, 2), resumed on (1, 2) to 6
ASYNC_T = dict(steps=6, ckpt_every=2, global_batch=8, seq_len=32,
               async_ckpt=True)
ASYNC_O = dict(lr=1e-3, warmup_steps=2, total_steps=6)

REFERENCE = r"""
import dataclasses, json, os, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from repro.configs import SMOKE_ARCHS
from repro.launch.mesh import shard_ctx
from repro.optim import AdamWConfig
from repro.train import TrainConfig, Trainer
ckpt, copy, out = sys.argv[1], sys.argv[2], sys.argv[3]
tkw, okw = json.loads(sys.argv[4]), json.loads(sys.argv[5])
cfg = dataclasses.replace(SMOKE_ARCHS["deepseek-7b"], param_dtype="float32")
# the shim: Auto axes (jax.make_mesh now builds Explicit ones)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
sctx = shard_ctx(mesh)
tc = TrainConfig(ckpt_dir=ckpt, **tkw)
Trainer(cfg, AdamWConfig(**okw), tc, sctx=sctx).run(steps=tkw["ckpt_every"])
step = f"step_{tkw['ckpt_every']:010d}"
os.makedirs(copy)
shutil.copytree(os.path.join(ckpt, step), os.path.join(copy, step))
tr = Trainer(cfg, AdamWConfig(**okw), tc, sctx=sctx)
tr.run()
json.dump([{"step": h["step"], "loss": h["loss"]} for h in tr.history],
          open(out, "w"))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    import json
    tmp = tmp_path_factory.mktemp("elastic")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref_out, port_ckpt = tmp / "ref.json", tmp / "from_ref"
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "ref_ckpt"),
         str(port_ckpt), str(ref_out), json.dumps(REF_T),
         json.dumps(REF_O)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ckpt = tmp / "ckpt"
        first = M.launch_world(
            worlds.trainer_world, 8,
            ((4, 2), "deepseek-7b", "bfloat16", str(ckpt), ELASTIC_T,
             ELASTIC_O, 12), init_file=str(tmp / "w8"), device="cpu",
            timeout=TIMEOUT)
        # the 8-rank world's step-12 checkpoint, for the reference
        os.makedirs(tmp / "to_ref")
        shutil.copytree(ckpt / "step_0000000012",
                        tmp / "to_ref" / "step_0000000012")
        second = M.launch_world(
            worlds.trainer_world, 4,
            ((2, 2), "deepseek-7b", "bfloat16", str(ckpt), ELASTIC_T,
             ELASTIC_O), init_file=str(tmp / "w4"), device="cpu",
            timeout=TIMEOUT)
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    from_ref = M.launch_world(
        worlds.trainer_world, 4,
        ((2, 2), "deepseek-7b", "float32", str(port_ckpt), REF_T, REF_O),
        init_file=str(tmp / "wref"), device="cpu", timeout=TIMEOUT)
    return {"first": first, "second": second, "from_ref": from_ref,
            "ref": json.loads(ref_out.read_text()), "tmp": tmp}


def test_elastic_restart_8_to_4_ranks(elastic):
    """12 steps on (4, 2) with checkpoints at 8 and 12; (2, 2) resumes at
    12 and trains to 24 with the loss still falling; every rank reports
    the same history."""
    first, second = elastic["first"], elastic["second"]
    assert [h["step"] for h in first[0]["history"]] == list(range(12))
    assert first[0]["saved"] == [8, 12]
    hist = second[0]["history"]
    assert hist[0]["step"] == 12 and hist[-1]["step"] == 23
    head = np.mean([h["loss"] for h in hist[:3]])
    tail = np.mean([h["loss"] for h in hist[-3:]])
    assert tail < head + 0.05, (head, tail)
    assert all(np.isfinite(h["loss"]) for h in hist)
    for world in (first, second):
        for out in world[1:]:
            assert out["history"] == world[0]["history"]


def test_sharded_checkpoint_restores_into_reference(elastic):
    """The reference's unsharded trainer resumes the 8-rank world's
    step-12 checkpoint: its first loss is the (2, 2) world's within
    ``CROSS_TOL``."""
    rcfg = REF_SMOKE["deepseek-7b"]
    d = elastic["tmp"] / "to_ref"
    tr = RefTrainer(rcfg, RefAdamWConfig(**ELASTIC_O),
                    RefTrainConfig(ckpt_dir=str(d), **ELASTIC_T))
    tr.run(steps=13)
    assert tr.history[0]["step"] == 12
    want = elastic["second"][0]["history"][0]
    assert abs(tr.history[0]["loss"] - want["loss"]) <= CROSS_TOL, \
        (tr.history[0]["loss"], want)


def test_reference_sharded_checkpoint_restores_into_port(elastic):
    """The reference's sharded trainer's step-4 checkpoint, resumed by the
    port's (2, 2) trainer: steps 4-7's losses within ``RESUME_RTOL`` of
    the reference's own resumed run."""
    want = elastic["ref"]
    got = elastic["from_ref"][0]["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == \
        [4, 5, 6, 7]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=RESUME_RTOL)


def test_async_checkpoints_resume_on_a_smaller_mesh(tmp_path):
    """With asynchronous saves, no rank leaves ``run()`` before rank 0's
    writer has put the last checkpoint on disk: every rank of the (2, 2)
    world lists it, and the (1, 2) world resumes from it."""
    ckpt = str(tmp_path / "ckpt")
    first = M.launch_world(
        worlds.trainer_world, 4,
        ((2, 2), "deepseek-7b", "bfloat16", ckpt, ASYNC_T, ASYNC_O, 4),
        init_file=str(tmp_path / "w4"), device="cpu", timeout=TIMEOUT)
    assert [out["saved"] for out in first] == [[2, 4]] * 4
    second = M.launch_world(
        worlds.trainer_world, 2,
        ((1, 2), "deepseek-7b", "bfloat16", ckpt, ASYNC_T, ASYNC_O),
        init_file=str(tmp_path / "w2"), device="cpu", timeout=TIMEOUT)
    assert [h["step"] for h in second[0]["history"]] == [4, 5]
    assert second[1]["history"] == second[0]["history"]
    assert [out["saved"] for out in second] == [[2, 4, 6]] * 2


def test_launch_train_mesh_needs_the_production_mesh(tmp_path):
    """``--mesh pod`` joins the world from the ``torch.distributed.run``
    environment (here a world of one rank on the CPU) and fails on the
    mesh's size."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-7b", "--smoke", "--mesh", "pod", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "need 256 devices" in out.stderr, out.stderr[-2000:]
    assert "A13" not in out.stderr
