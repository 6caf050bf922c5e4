"""Port parity: the decoder (``repro_torch.models``) against the
reference's ``models`` for all ten configurations (attention, MLA, MoE,
Mamba, mLSTM and sLSTM layers): forward logits and prefill caches,
parameter layouts and counts, and the exact carry of weights.

Logits and caches are compared in f32 within 1e-4 (the two sides sum
matmuls and softmaxes in different orders; the largest difference seen is
a few 1e-6 on logits of magnitude ~1-5).
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import param_count as ref_param_count  # noqa: E402
from repro_torch.configs import ARCHS, SMOKE_ARCHS  # noqa: E402
from repro_torch.models import (forward, init_params,  # noqa: E402
                                param_count, params_from_reference)

TOL = 1e-4
DENSE = ["deepseek-7b", "codeqwen1.5-7b", "gemma2-27b", "qwen1.5-110b",
         "llava-next-mistral-7b", "musicgen-medium"]
# MLA + MoE, MoE with a window, Mamba + attention + MoE, mLSTM + sLSTM
MIXED = ["deepseek-v2-236b", "mixtral-8x22b", "jamba-1.5-large-398b",
         "xlstm-125m"]
ALL = DENSE + MIXED


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32")


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        x = (rng.standard_normal((B, S, cfg.d_model)) * 0.05).astype(
            np.float32)
        return dict(embeds=jnp.asarray(x)), dict(embeds=torch.from_numpy(x))
    t = rng.integers(0, cfg.vocab, (B, S))
    return dict(tokens=jnp.asarray(t)), dict(tokens=torch.from_numpy(t))


@pytest.mark.parametrize("name", ALL)
def test_forward_equals_reference(name):
    rcfg, pcfg = _f32(REF_SMOKE[name]), _f32(SMOKE_ARCHS[name])
    rparams = ref_init(rcfg, jax.random.PRNGKey(2))
    pparams = params_from_reference(jax.tree.map(np.asarray, rparams), pcfg,
                                    device="cpu")
    rkw, pkw = _inputs(rcfg, 2, 19, seed=len(name))
    want = ref_forward(rparams, rcfg, **rkw)
    got = forward(pparams, pcfg, **pkw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)

    want_last, want_caches = ref_forward(rparams, rcfg, **rkw,
                                         want_cache=True, last_only=True)
    got_last, got_caches = forward(pparams, pcfg, **pkw, want_cache=True,
                                   last_only=True)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=TOL, rtol=0)
    plen = len(rcfg.period)
    for layer, cache in enumerate(got_caches):
        ref_cache = want_caches[f"l{layer % plen}"]
        assert sorted(cache) == sorted(ref_cache)
        for name in ref_cache:
            np.testing.assert_allclose(
                cache[name].numpy(),
                np.asarray(ref_cache[name][layer // plen]),
                atol=TOL, rtol=0, err_msg=f"layer {layer} {name}")


@pytest.mark.parametrize("name", ALL)
def test_param_layout_and_count_equal_reference(name):
    """The port's parameters have the reference's names and shapes, layer
    by layer, and the same count at full size."""
    cfg = SMOKE_ARCHS[name]
    shapes = jax.eval_shape(lambda k: ref_init(REF_SMOKE[name], k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    carried = params_from_reference(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), cfg,
        device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, carried))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(carried)):
        assert a.shape == b.shape
    # the dtypes are the reference's: the model's, or f32 where the
    # reference keeps f32 in any model (router, recurrent gates, A, D)
    for a, s in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        want = torch.float32 if s.dtype == jnp.float32 else cfg.dtype
        assert a.dtype == want
    assert param_count(cfg) == ref_param_count(REF_SMOKE[name])
    assert param_count(ARCHS[name]) == ref_param_count(REF_ARCHS[name])
    assert sum(x.numel() for x in jax.tree.leaves(params)) == param_count(cfg)


def test_params_from_reference_is_exact_in_bf16():
    """bf16 weights are carried by their bits: nothing is rounded."""
    rcfg = REF_SMOKE["gemma2-27b"]
    rparams = jax.tree.map(np.asarray, ref_init(rcfg, jax.random.PRNGKey(7)))
    pparams = params_from_reference(rparams, SMOKE_ARCHS["gemma2-27b"],
                                    device="cpu")
    assert pparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pparams["embed"].view(torch.int16).numpy(),
        rparams["embed"].view(np.int16))
    wq = rparams["layers"]["l1"]["attn"]["wq"]           # period 0, slot 1
    np.testing.assert_array_equal(
        pparams["layers"][1]["attn"]["wq"].view(torch.int16).numpy(),
        wq[0].view(np.int16))


def test_init_params_is_seeded():
    cfg = SMOKE_ARCHS["deepseek-7b"]
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["w_up"],
                       b["layers"][1]["mlp"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("name,leaves", [
    ("deepseek-v2-236b", [("moe", "router"), ("moe", "shared", "w_up"),
                          ("attn", "kv_norm", "scale")]),
    ("jamba-1.5-large-398b", [("moe", "router"), ("mamba", "dt_b"),
                              ("mamba", "A_log"), ("mamba", "D"),
                              ("mamba", "in_proj")]),
    ("xlstm-125m", [("mlstm", "w_i"), ("mlstm", "b_f"), ("slstm", "R"),
                    ("slstm", "b"), ("slstm", "ffn", "w_down")]),
])
def test_params_from_reference_keeps_f32_leaves_in_bf16(name, leaves):
    """In a bf16 model the reference keeps the router, the recurrent
    layers' gates and A/D in f32: each leaf keeps its dtype and its bits
    across the carry, in every layer."""
    rcfg, pcfg = REF_SMOKE[name], SMOKE_ARCHS[name]
    rparams = jax.tree.map(np.asarray, ref_init(rcfg, jax.random.PRNGKey(8)))
    pparams = params_from_reference(rparams, pcfg, device="cpu")
    plen = len(rcfg.period)
    checked = set()
    for layer, lp in enumerate(pparams["layers"]):
        for path in leaves:
            try:
                got = lp
                want = rparams["layers"][f"l{layer % plen}"]
                for k in path:
                    got, want = got[k], want[k]
            except KeyError:
                continue                  # this layer has no such leaf
            want = want[layer // plen]
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            bits = np.int32 if want.dtype == np.float32 else np.int16
            view = torch.int32 if got.dtype == torch.float32 else torch.int16
            np.testing.assert_array_equal(got.view(view).numpy(),
                                          want.view(bits))
            checked.add((path, want.dtype.name))
    assert {p for p, _ in checked} == set(leaves)
    assert "float32" in {d for _, d in checked}
