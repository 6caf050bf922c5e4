"""Port parity: training (``repro_torch.optim``, ``models.lm_loss``,
``train``, ``checkpoint``, ``launch.train``) against the reference.

Inputs come from seeded numpy; weights cross over through
``params_from_reference``.  Tolerances, in f32 unless said otherwise
("relative" is against the leaf's largest magnitude):

* ``schedule``: equal to the reference's within 2 ulp: the warm-up is
  equal, and XLA's and PyTorch's f32 ``cos`` differ by up to 2 ulp at a
  few steps of the decay (3 of 41 here);
* ``quantize``: ``q`` equal, ``scale`` within 1 ulp, both domains;
* AdamW ``update``, 5 steps on the same parameters and gradients: with f32
  moments, parameters, ``m`` and ``v`` within ``OPT_REL`` = 1e-6 relative;
  with int8 moments ``q`` equal except at rounding ties, counted and
  bounded (a tie is an element whose f32 moment lies within one
  ulp-scaled step of a half-integer of its block's scale, where the two
  sides' global norms, summed in different orders, may round it either
  way);
* ``lm_loss``: the loss within ``LOSS_TOL`` = 1e-5, each gradient leaf
  within ``GRAD_REL`` = 1e-4 relative (the largest seen is ~1e-5, Mamba's
  scan; the rest ~2e-6);
* train steps (at Adam's eps = 1e-3, see ``STEP_OPT``): one step equals
  the reference's step, the loss and the parameters within ``STEP_REL``
  = 1e-5 relative, m and v within ``GRAD_REL``; microbatched and
  rematerialised steps equal the plain one, the loss within
  ``STEP_REL``, parameters, m and v within ``GRAD_REL`` (two
  microbatches sum a router's small gradients in another order);
* trainer loss histories: rtol ``HIST_RTOL`` = 1e-4 against the
  reference's trainer; a killed and resumed run equals an uninterrupted
  one within rtol 1e-5 (the reference's own test).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import lm_loss as ref_lm_loss  # noqa: E402
from repro.models.model import forward as ref_forward  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import TrainConfig as RefTrainConfig  # noqa: E402
from repro.train import Trainer as RefTrainer  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import (forward, lm_loss,  # noqa: E402
                                params_from_reference, params_to_reference,
                                stacked_view)
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.train import (StragglerWatchdog, TrainConfig,  # noqa: E402
                               Trainer, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
ALL = ["deepseek-7b", "codeqwen1.5-7b", "gemma2-27b", "qwen1.5-110b",
       "llava-next-mistral-7b", "musicgen-medium", "deepseek-v2-236b",
       "mixtral-8x22b", "jamba-1.5-large-398b", "xlstm-125m"]
OPT_REL = 1e-6
NORM_REL = 1e-5
CLIP_REL = 1e-5
LOSS_TOL = 1e-5
GRAD_REL = 1e-4
STEP_REL = 1e-5
HIST_RTOL = 1e-4
# int8 moments: the largest share of q elements allowed to sit on a
# rounding tie and differ by one (the ties seen are a few in 10^5)
TIE_SHARE = 1e-3


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32")


def _ref_params(name, seed=3):
    rcfg, pcfg = _f32(REF_SMOKE[name]), _f32(SMOKE_ARCHS[name])
    rparams = ref_init(rcfg, jax.random.PRNGKey(seed))
    pparams = params_from_reference(jax.tree.map(np.asarray, rparams), pcfg,
                                    device="cpu")
    return rcfg, pcfg, rparams, pparams


def _batch(cfg, B, S, seed):
    """The same batch for both sides: (reference's, port's)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.embeds_input:
        x = {"embeds": (rng.standard_normal((B, S, cfg.d_model))
                        * 0.05).astype(np.float32)}
    else:
        x = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    x["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _assert_rel(got, want, rel, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _assert_tree_rel(got, want, rel, what):
    """Every leaf of the reference's tree ``want`` against the same path
    of ``got`` (the port's tree in the reference's layout)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        _assert_rel(_at(got, path), leaf, rel,
                    f"{what} {jax.tree_util.keystr(path)}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --- schedule and quantization -----------------------------------------------

def test_schedule_equals_reference():
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=30, min_lr_frac=0.1)
    steps = np.arange(41, dtype=np.int32)
    want = np.asarray(ref_adamw.schedule(ref_adamw.AdamWConfig(**cfg),
                                         jnp.asarray(steps)))
    got = adamw.schedule(AdamWConfig(**cfg), torch.from_numpy(steps))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    np.testing.assert_array_equal(got.numpy()[:6], want[:6])


def _heavy_tailed(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * np.exp(2 * rng.standard_normal(n))
            ).astype(np.float32)


@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_quantize_equals_reference(sqrt_domain):
    x = _heavy_tailed(64 * 37 + 13, seed=4)     # a partial last block
    if sqrt_domain:
        x = np.abs(x)
    want = ref_adamw.quantize(jnp.asarray(x), sqrt_domain)
    got = adamw.quantize(torch.from_numpy(x), sqrt_domain)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        adamw.dequantize(got, x.shape, sqrt_domain).numpy(),
        np.asarray(ref_adamw.dequantize(want, x.shape, sqrt_domain)))


def test_quantize_roundtrip_accuracy():
    x = torch.from_numpy(_heavy_tailed(1000, seed=1))
    err = (adamw.dequantize(adamw.quantize(x), x.shape) - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0


# --- AdamW update -----------------------------------------------------------

def _int8_ties(got_q, want_q, what):
    """q equal except at rounding ties: each difference is one step, and
    at most ``TIE_SHARE`` of the elements.  Returns the ties' flat
    indices into the leaf."""
    diff = (got_q.numpy().astype(np.int32)
            - np.asarray(want_q).astype(np.int32)).reshape(-1)
    ties = np.flatnonzero(diff)
    assert np.abs(diff).max(initial=0) <= 1, what
    assert ties.size <= TIE_SHARE * diff.size + 1, \
        f"{what}: {ties.size} of {diff.size}"
    return ties


def _adamw_five_steps(name, moments, norm):
    """5 AdamW steps on both sides from the same parameters, each step's
    gradients heavy-tailed f32 from numpy, scaled to global norm ``norm``
    (f64).  Returns the port's final parameters (reference layout), the
    reference's, and each step's grad norms and optimizer states (port's,
    reference's)."""
    rcfg, pcfg, rparams, pparams = _ref_params(name)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moments)
    rocfg, pocfg = ref_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    rstate = ref_adamw.init(rparams, rocfg)
    view = stacked_view(pparams, pcfg)
    pstate = adamw.init(view, pocfg)
    ref_update = jax.jit(lambda g, s, p: ref_adamw.update(g, s, p, rocfg))
    rng = np.random.default_rng(11)
    steps = []
    for _ in range(5):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape) * np.exp(
            rng.standard_normal(p.shape)), rparams)
        total = np.sqrt(sum(np.square(g).sum()
                            for g in jax.tree.leaves(grads)))
        grads = jax.tree.map(lambda g: (g * (norm / total)).astype(
            np.float32), grads)
        rparams, rstate, rstats = ref_update(grads, rstate, rparams)
        pgrads = params_from_reference(grads, pcfg, device="cpu")
        _, pstate, pstats = adamw.update(stacked_view(pgrads, pcfg), pstate,
                                         view, pocfg)
        steps.append((pstats["grad_norm"], rstats["grad_norm"], pstate,
                      rstate))
    assert int(pstate["step"]) == int(rstate["step"]) == 5
    return params_to_reference(pparams, pcfg), rparams, steps


def _int8_moments(pstate, rstate):
    """(leaf path, "m" or "v", port's {"q", "scale"}, reference's) for
    every int8 moment."""
    def is_q(x):
        return isinstance(x, dict) and set(x) == {"q", "scale"}

    for k in ("m", "v"):
        for path, qd in jax.tree_util.tree_flatten_with_path(
                rstate[k], is_leaf=is_q)[0]:
            got = _at(pstate[k], path)
            assert got["q"].shape == qd["q"].shape, (k, path)
            yield jax.tree_util.keystr(path), k, got, qd


def _adamw_case(name, moments, norm, rel):
    got_p, want_p, steps = _adamw_five_steps(name, moments, norm)
    for got, want, _, _ in steps:
        _assert_rel(got, want, NORM_REL, "grad_norm")
    pstate, rstate = steps[-1][2:]
    if moments == "float32":
        _assert_tree_rel(got_p, want_p, rel, "params")
        for k in ("m", "v"):
            _assert_tree_rel(pstate[k], rstate[k], rel, k)
        return
    # a q one step apart at any step moves its parameter's update (by up
    # to lr) for the rest of the run; every other parameter is within rel
    tied = {}
    for _, _, pstate, rstate in steps:
        for leaf, k, got, want in _int8_moments(pstate, rstate):
            tied.setdefault(leaf, set()).update(
                _int8_ties(got["q"], want["q"], f"{k} {leaf}").tolist())
            _assert_rel(got["scale"], want["scale"], rel,
                        f"{k} {leaf} scale")
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        g = _np(_at(got_p, path)).reshape(-1)
        w = np.asarray(leaf).reshape(-1)
        off = np.flatnonzero(np.abs(g - w) > rel * np.abs(w).max())
        key = jax.tree_util.keystr(path)
        assert set(off.tolist()) <= tied.get(key, set()), key
    n = sum(len(t) for t in tied.values())
    print(f"{name}, norm {norm}: {n} elements with an int8 rounding tie")


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("name", ALL)
def test_adamw_update_equals_reference(name, moments):
    """5 steps on the same parameters and gradients, the gradients' norm
    0.5 (below ``clip_norm``, so both sides scale by exactly 1): m, v,
    parameters and int8's scales within ``OPT_REL`` (XLA contracts the
    moments' multiply-adds, PyTorch does not: they differ in the last
    bit), int8's q equal except at rounding ties.  The int8 case
    covers the leaves whose per-layer slices are not whole blocks
    (xlstm's ``b_f``/``b_i``, the smoke deepseek-v2's norms, qwen's
    ``bk``/``bv``): the port quantizes over the reference's stacked
    leaf."""
    _adamw_case(name, moments, 0.5, OPT_REL)


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("name", ["deepseek-7b", "xlstm-125m"])
def test_adamw_clipping_equals_reference(name, moments):
    """Gradients of norm 20, clipped to 1: the two sides sum the global
    norm in different orders (within ``NORM_REL``), so every clipped
    gradient may differ in its last bits: m, v and parameters within
    ``CLIP_REL``, int8's q equal except at rounding ties."""
    _adamw_case(name, moments, 20.0, CLIP_REL)


# --- the loss and its gradients ----------------------------------------------

def _port_grads(pparams, pcfg, pbatch, **kw):
    leaves = list(_leaves(pparams))
    for p in leaves:
        p.requires_grad_(True)
    loss = lm_loss(pparams, pcfg, pbatch, **kw)
    loss.backward()
    grads = _grad_tree(pparams)
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), params_to_reference(grads, pcfg)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return torch.zeros_like(tree) if tree.grad is None else tree.grad.clone()


@pytest.mark.parametrize("name", ALL)
def test_lm_loss_and_grads_equal_reference(name):
    """``jax.value_and_grad(repro.models.lm_loss)`` (the jnp attention,
    remat "full", the MoE models' aux term included) against the port's
    ``lm_loss`` (plain attention) and autograd."""
    rcfg, pcfg, rparams, pparams = _ref_params(name)
    rb, pb = _batch(rcfg, 2, 24, seed=len(name))
    want_loss, want = jax.value_and_grad(ref_lm_loss)(rparams, rcfg, rb)
    got_loss, got = _port_grads(pparams, pcfg, pb)
    assert abs(float(got_loss) - float(want_loss)) <= LOSS_TOL
    _assert_tree_rel(got, want, GRAD_REL, "grad")


@pytest.mark.parametrize("name", ["deepseek-7b", "deepseek-v2-236b"])
def test_plain_attention_gradients_equal_reference(name):
    """Gradients through ``forward(impl="plain")`` (attention; MLA's
    prefill) equal the reference's through its jnp attention."""
    rcfg, pcfg, rparams, pparams = _ref_params(name)
    rb, pb = _batch(rcfg, 2, 16, seed=5)
    w = np.random.default_rng(6).standard_normal(
        (2, 16, rcfg.vocab)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(ref_forward(
        p, rcfg, tokens=rb["tokens"]) * w))(rparams)
    leaves = list(_leaves(pparams))
    for p in leaves:
        p.requires_grad_(True)
    out = forward(pparams, pcfg, tokens=pb["tokens"], impl="plain")
    (out * torch.from_numpy(w)).sum().backward()
    _assert_tree_rel(params_to_reference(_grad_tree(pparams), pcfg), want,
                     GRAD_REL, "grad")


def test_kernel_wrappers_refuse_autograd():
    """B2 and B3 have no backward: under autograd with an input that
    requires grad, ``forward(impl="kernel")`` and both bare wrappers raise
    (here on the CPU as on the card); without grad they run."""
    _, pcfg, _, pparams = _ref_params("deepseek-7b")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    for p in _leaves(pparams):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        forward(pparams, pcfg, tokens=tokens, impl="kernel")
    _, pcfg2, _, mla_params = _ref_params("deepseek-v2-236b")
    for p in _leaves(mla_params):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        forward(mla_params, pcfg2, tokens=tokens, impl="kernel")
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    kv = torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="B2"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="B3"):
        da.decode_attention(q[:, 0], kv, kv, torch.ones(1, 8, dtype=bool))
    with torch.no_grad():
        fa.flash_attention(q, kv, kv)
        da.decode_attention(q[:, 0], kv, kv, torch.ones(1, 8, dtype=bool))
        forward(pparams, pcfg, tokens=tokens, impl="kernel")
    fa.flash_attention(q.detach(), kv, kv)      # nothing requires grad


# --- train steps -------------------------------------------------------------

# One AdamW step moves each parameter by lr * g / (|g| + eps): at eps = 1e-8
# an element whose gradient is ~1e-8, below the gradients' rounding noise
# (~1e-7 of the leaf's largest), moves by anything up to lr.  The train
# steps below compare gradients through m and v (``GRAD_REL``), and
# parameters at eps = 1e-3, where a parameter moves by at most
# lr * |dg| / eps.
STEP_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)


def _one_step(name, n_micro=1, remat="full"):
    _, pcfg, _, pparams = _ref_params(name)
    ocfg = AdamWConfig(**STEP_OPT)
    state = adamw.init(stacked_view(pparams, pcfg), ocfg)
    _, pb = _batch(pcfg, 4, 16, seed=9)
    step = make_train_step(pcfg, ocfg, n_microbatches=n_micro, remat=remat)
    pparams, state, metrics = step(pparams, state, pb)
    return params_to_reference(pparams, pcfg), state, metrics


@pytest.mark.parametrize("n_micro,remat", [(2, "full"), (1, "none"),
                                           (1, "dots"),
                                           (1, "dots_no_batch")])
@pytest.mark.parametrize("name", ["deepseek-7b", "mixtral-8x22b"])
def test_microbatches_and_remat_agree(name, n_micro, remat):
    want_p, want_s, want_m = _one_step(name)
    got_p, got_s, got_m = _one_step(name, n_micro, remat)
    _assert_rel(got_m["loss"], want_m["loss"], STEP_REL, "loss")
    for what, got, want, rel in (("params", got_p, want_p, GRAD_REL),
                                 ("m", got_s["m"], want_s["m"], GRAD_REL),
                                 ("v", got_s["v"], want_s["v"], GRAD_REL)):
        for g, w in zip(_leaves(got), _leaves(want)):
            _assert_rel(g, w, rel, what)


@pytest.mark.parametrize("name", ["deepseek-7b", "mixtral-8x22b",
                                  "xlstm-125m"])
def test_train_step_equals_reference(name):
    rcfg, pcfg, rparams, pparams = _ref_params(name)
    rocfg = ref_adamw.AdamWConfig(**STEP_OPT)
    pocfg = AdamWConfig(**STEP_OPT)
    rb, pb = _batch(rcfg, 4, 16, seed=9)
    rstep = jax.jit(ref_make_train_step(rcfg, rocfg))
    rparams, rstate, rm = rstep(rparams, ref_adamw.init(rparams, rocfg), rb)
    pstep = make_train_step(pcfg, pocfg)
    pparams, pstate, pm = pstep(pparams, adamw.init(
        stacked_view(pparams, pcfg), pocfg), pb)
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= LOSS_TOL
    _assert_rel(pm["grad_norm"], rm["grad_norm"], STEP_REL, "grad_norm")
    _assert_tree_rel(params_to_reference(pparams, pcfg), rparams, STEP_REL,
                     "params")
    for k in ("m", "v"):
        _assert_tree_rel(pstate[k], rstate[k], GRAD_REL, k)


# --- trainer -----------------------------------------------------------------

def _opt(**kw):
    return dict(lr=1e-3, warmup_steps=2, total_steps=16, **kw)


def _tcfg(cls, d, **kw):
    return cls(**{**dict(steps=16, ckpt_dir=str(d), ckpt_every=8,
                         global_batch=4, seq_len=32, async_ckpt=False),
                  **kw})


def test_trainer_kill_and_resume_is_deterministic(tmp_path):
    """The reference's test on the port: a crash mid-run resumes from the
    last snapshot and replays the same data stream, so the final loss
    equals the uninterrupted run's."""
    cfg = SMOKE_ARCHS["deepseek-7b"]
    opt = AdamWConfig(**_opt(weight_decay=0.0))
    d1, d2 = tmp_path / "a", tmp_path / "b"
    t_full = Trainer(cfg, opt, _tcfg(TrainConfig, d1), device="cpu")
    t_full.run()
    t_int = Trainer(cfg, opt, _tcfg(TrainConfig, d2), device="cpu")
    t_int.run(steps=8)
    t_res = Trainer(cfg, opt, _tcfg(TrainConfig, d2), device="cpu")
    t_res.run()
    assert t_res.history[0]["step"] == 8
    np.testing.assert_allclose(t_full.history[-1]["loss"],
                               t_res.history[-1]["loss"], rtol=1e-5)
    assert CheckpointManager(str(d2)).steps() == [8, 16]


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_trainer_history_and_cross_restore_equal_reference(tmp_path,
                                                           moments):
    """deepseek-7b smoke in f32, 16 steps.  Both trainers start from one
    step-0 checkpoint that the reference wrote (so the port restores the
    reference's format); the port's loss history equals the reference
    trainer's; then the reference resumes from the port's step-8
    checkpoint and its steps 8-15 equal the port's."""
    rcfg, pcfg = _f32(REF_SMOKE["deepseek-7b"]), _f32(
        SMOKE_ARCHS["deepseek-7b"])
    ropt = ref_adamw.AdamWConfig(**_opt(moment_dtype=moments))
    popt = AdamWConfig(**_opt(moment_dtype=moments))
    rparams = ref_init(rcfg, jax.random.PRNGKey(0))
    d_ref, d_port, d_back = (tmp_path / n for n in ("ref", "port", "back"))
    RefManager(str(d_ref)).save(0, {"params": rparams,
                                    "opt": ref_adamw.init(rparams, ropt)})
    shutil.copytree(d_ref, d_port)
    t_ref = RefTrainer(rcfg, ropt, _tcfg(RefTrainConfig, d_ref))
    t_ref.run()
    t_port = Trainer(pcfg, popt, _tcfg(TrainConfig, d_port), device="cpu")
    t_port.run()
    want = [h["loss"] for h in t_ref.history]
    got = [h["loss"] for h in t_port.history]
    assert len(got) == 16 and [h["step"] for h in t_port.history] == \
        list(range(16))
    np.testing.assert_allclose(got, want, rtol=HIST_RTOL)
    # the reference resumes the port's step-8 checkpoint
    os.makedirs(d_back)
    shutil.copytree(d_port / "step_0000000008", d_back / "step_0000000008")
    t_back = RefTrainer(rcfg, ropt, _tcfg(RefTrainConfig, d_back))
    t_back.run()
    assert t_back.history[0]["step"] == 8
    np.testing.assert_allclose([h["loss"] for h in t_back.history],
                               got[8:], rtol=HIST_RTOL)


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(factor=3.0)
    flags = [wd.record(dt) for dt in
             [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 1.05, 9.0]]
    assert flags == [False, False, False, False, True, False, False, True]
    assert wd.flagged == 2
    assert wd.ema < 1.5


def test_token_pipeline_stateless_and_host_sharded():
    pipe = TokenPipeline(vocab=100, global_batch=8, seq_len=16, seed=1)
    b1 = pipe.batch(7)
    np.testing.assert_array_equal(b1["tokens"], pipe.batch(7)["tokens"])
    parts = [pipe.batch(7, host_id=h, n_hosts=4)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), b1["tokens"])
    assert not np.array_equal(pipe.batch(8)["tokens"], b1["tokens"])
    full = pipe.batch(3)
    assert full["tokens"].shape == full["labels"].shape == (8, 16)


def test_trainer_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="A13"):
        Trainer(SMOKE_ARCHS["deepseek-7b"], AdamWConfig(), TrainConfig(),
                sctx=object(), device="cpu")


# --- checkpoints -------------------------------------------------------------

def test_checkpoint_atomic_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": {"w": torch.arange(6, dtype=torch.bfloat16)},
             "s": torch.tensor(3, dtype=torch.int32)}
    for step in (5, 10, 15, 20):
        mgr.save(step, state)
    assert mgr.steps() == [15, 20]
    step, restored = mgr.restore()
    assert step == 20
    assert restored["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["a"]["w"].float().numpy(),
                                  np.arange(6, dtype=np.float32))
    assert int(restored["s"]) == 3
    (tmp_path / "step_0000000025.tmp").mkdir()
    assert mgr.latest_step() == 20


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.ones((128, 128))}, blocking=False)
    mgr.wait()
    step, st = mgr.restore()
    assert step == 1 and st["x"].shape == (128, 128)


def test_async_save_then_in_place_update_keeps_the_snapshot(tmp_path):
    """The async save's host copy is a copy: an in-place update right
    after ``save`` returns does not reach the checkpoint."""
    x = torch.arange(1 << 20, dtype=torch.float32)
    want = x.clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"p": {"x": x}}, blocking=False)
    x.add_(1.0)
    _, st = mgr.restore()
    np.testing.assert_array_equal(st["p"]["x"].numpy(), want.numpy())


def _mixed_state(rng):
    """bf16, f32, int8 moments and an int32 scalar, as a trainer saves."""
    w = rng.standard_normal((3, 70)).astype(np.float32)
    q = rng.integers(-127, 128, (4, 64)).astype(np.int8)
    return w, q, rng.standard_normal(4).astype(np.float32)


def test_checkpoints_cross_restore(tmp_path):
    """The port restores what the reference wrote, and the reference
    restores what the port wrote, leaf for leaf and dtype for dtype."""
    w, q, scale = _mixed_state(np.random.default_rng(0))
    ref_state = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                            "f": jnp.asarray(w)},
                 "opt": {"m": {"w": {"q": jnp.asarray(q),
                                     "scale": jnp.asarray(scale)}},
                         "step": jnp.int32(7)}}
    RefManager(str(tmp_path / "r")).save(7, ref_state)
    step, got = CheckpointManager(str(tmp_path / "r")).restore()
    assert step == 7
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["params"]["w"].float().numpy(),
        np.asarray(ref_state["params"]["w"], np.float32))
    np.testing.assert_array_equal(got["params"]["f"].numpy(), w)
    np.testing.assert_array_equal(got["opt"]["m"]["w"]["q"].numpy(), q)
    assert got["opt"]["m"]["w"]["q"].dtype == torch.int8
    assert int(got["opt"]["step"]) == 7

    CheckpointManager(str(tmp_path / "p")).save(7, got)
    step, back = RefManager(str(tmp_path / "p")).restore()
    assert step == 7
    flat_want = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    for path, leaf in flat_want:
        b = _at(back, path)
        assert b.dtype == np.asarray(leaf).dtype, path
        np.testing.assert_array_equal(np.asarray(b), np.asarray(leaf))


# --- entry point -------------------------------------------------------------

def _train_cli(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_launch_train_end_to_end(tmp_path):
    out = _train_cli("--arch", "deepseek-7b", "--smoke", "--device", "cpu",
                     "--steps", "8", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[train] deepseek-7b: step 0...7  loss "), line
    assert CheckpointManager(str(tmp_path)).latest_step() == 8


def test_launch_train_needs_cuda_by_default(tmp_path):
    """``--device`` defaults to cuda and does not fall back to the CPU;
    a mesh names A13."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _train_cli("--arch", "deepseek-7b", "--smoke", "--steps", "1",
                     "--ckpt-dir", str(tmp_path))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = _train_cli("--arch", "deepseek-7b", "--smoke", "--mesh", "pod",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path))
    assert out.returncode != 0 and "A13" in out.stderr
