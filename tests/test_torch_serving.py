"""Port parity: the bounded KV pool (``serving/kv_cache.py``) and the serve
path (``prefill`` + ``decode_step``) against the reference.

The DAC control state and the MoE routing are held equal bit for bit.
Logits, caches (K/V, MLA's latent/krope) and recurrent states are held
within 1e-4 in f32: both sides run the same arithmetic, and the largest
difference seen is a few 1e-6 (matmul and softmax sums in different
orders), on logits of magnitude ~1-5.  Weights and state are carried
across with ``params_from_reference`` / ``serve_state_to_numpy``; tokens
are teacher-forced from seeded numpy, so both sides see the same inputs
at every step.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.serving.serve_step as ref_serve  # noqa: E402
import repro_torch.models.moe as port_moe  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.serving import kv_cache as rk  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS as PORT_SMOKE  # noqa: E402
from repro_torch.models import (params_from_reference,  # noqa: E402
                                serve_state_from_reference,
                                serve_state_to_numpy)
from repro_torch.serving import decode_step, prefill  # noqa: E402
from repro_torch.serving import kv_cache as pk  # noqa: E402

TOL = 1e-4
# the reference's top-2 mass margin must exceed this at every hit event for
# "ctrl equal bit for bit" to be the claim (the two sides' masses differ by
# ~1e-7 in f32; a closer tie could pick another slot on either side); the
# same for the gap between the router's k-th and (k+1)-th probability,
# for "routing equal bit for bit"
MARGIN = 1e-5
MIXED = ["deepseek-v2-236b", "mixtral-8x22b", "jamba-1.5-large-398b",
         "xlstm-125m"]


# the reference's primitives, jitted (eager jnp dispatch would take minutes)
ref_insert = jax.jit(rk.insert)
ref_hit = jax.jit(rk.hit)
ref_resize = jax.jit(rk.resize, static_argnames=("eps", "k_min"))


def _ref_ctrl(ctrl):
    return {k: np.asarray(v) for k, v in ctrl.items()}


def _port_ctrl(ctrl):
    return {k: v.numpy() for k, v in ctrl.items()}


def _assert_ctrl_equal(port, ref, what=""):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=f"{what} {k}")


# --- kv_cache ---------------------------------------------------------------

@pytest.mark.parametrize("budget,k0,use_cap,seed", [
    (8, None, False, 0), (16, 16, False, 1), (32, 4, False, 2),
    (16, 4, True, 3), (32, 8, True, 4)])
def test_kv_cache_sequences_equal_reference(budget, k0, use_cap, seed):
    """Seeded insert / hit / resize sequences, every field after every
    event; hits land on random occupied slots, on the top rank (which
    drives shrinks) and on nothing (-1)."""
    rng = np.random.default_rng(seed)
    B = 3
    rc = rk.control_init(B, budget, k0=k0)
    pc = pk.control_init(B, budget, k0=k0, device="cpu")
    resized = 0
    for t in range(120):
        pos = np.full(B, t, np.int32)
        rc, rslot = ref_insert(rc, jnp.asarray(pos))
        pc, pslot = pk.insert(pc, torch.from_numpy(pos))
        np.testing.assert_array_equal(pslot.numpy(), np.asarray(rslot))
        _assert_ctrl_equal(_port_ctrl(pc), _ref_ctrl(rc), f"insert t={t}")
        for _ in range(int(rng.integers(0, 4))):
            valid = np.asarray(rk.valid_slots(rc))
            top = np.asarray(rc["rank2slot"])[:, 0]
            hits = np.array([
                -1 if r < 0.1 or not valid[b].any() else
                top[b] if r < 0.6 else rng.choice(np.nonzero(valid[b])[0])
                for b, r in enumerate(rng.random(B))], np.int32)
            rc = ref_hit(rc, jnp.asarray(hits))
            pc = pk.hit(pc, torch.from_numpy(hits))
            _assert_ctrl_equal(_port_ctrl(pc), _ref_ctrl(rc), f"hit t={t}")
        cap = (rng.integers(2, 2 * budget, B).astype(np.int32)
               if use_cap else None)
        k_before = np.asarray(rc["k_active"])
        rc = ref_resize(rc, eps=0.5, k_min=2,
                        cap=None if cap is None else jnp.asarray(cap))
        pc = pk.resize(pc, eps=0.5, k_min=2,
                       cap=None if cap is None else torch.from_numpy(cap))
        resized += int((np.asarray(rc["k_active"]) != k_before).sum())
        _assert_ctrl_equal(_port_ctrl(pc), _ref_ctrl(rc), f"resize t={t}")
    assert resized > 0


def test_kv_cache_shrink_frees_slot_zero():
    """A shrink that evicts the rank holding physical slot 0 frees it (the
    reference's masked lanes scatter False to index 0; the port's must not
    lose the real eviction).  The pool (16) is twice the active budget (8),
    so masked lanes sit on both sides of the evicted ranks.  Hits on rank 3
    (rank 4 when rank 3 holds slot 0) push slot 0 down until the halving
    evicts it."""
    budget = 8
    rc = rk.control_init(1, 2 * budget, k0=budget)
    pc = pk.control_init(1, 2 * budget, k0=budget, device="cpu")
    for t in range(budget):
        rc, _ = ref_insert(rc, jnp.full((1,), t, jnp.int32))
        pc, _ = pk.insert(pc, torch.full((1,), t, dtype=torch.int32))
    while int(rc["k_active"][0]) == budget:
        assert not bool(rc["free"][0, 0])
        r2s = np.asarray(rc["rank2slot"])[0]
        slot = np.array([r2s[3] if r2s[3] != 0 else r2s[4]], np.int32)
        rc = ref_resize(ref_hit(rc, jnp.asarray(slot)), eps=0.5, k_min=2)
        pc = pk.resize(pk.hit(pc, torch.from_numpy(slot)), eps=0.5, k_min=2)
        _assert_ctrl_equal(_port_ctrl(pc), _ref_ctrl(rc))
    assert bool(rc["free"][0, 0]) and bool(pc["free"][0, 0])
    assert 0 not in pc["rank2slot"][0].tolist()


def test_kv_cache_grow_and_shrink_laws_equal_reference():
    """``test_serving.py``'s laws: all misses double the budget to the
    pool; hammering the top slot shrinks it; the port follows the same
    trajectory."""
    budget = 64
    rc = rk.control_init(1, budget, k0=8)
    pc = pk.control_init(1, budget, k0=8, device="cpu")
    for t in range(200):
        rc, _ = ref_insert(rc, jnp.full((1,), t, jnp.int32))
        rc = ref_resize(rc)
        pc, _ = pk.insert(pc, torch.full((1,), t, dtype=torch.int32))
        pc = pk.resize(pc)
        _assert_ctrl_equal(_port_ctrl(pc), _ref_ctrl(rc))
    assert int(pc["k_active"][0]) == budget
    for _ in range(300):
        top = rc["rank2slot"][:, 0]
        rc = ref_resize(ref_hit(rc, top), eps=0.5, k_min=2)
        pc = pk.resize(pk.hit(pc, torch.from_numpy(np.array(top))),
                       eps=0.5, k_min=2)
        _assert_ctrl_equal(_port_ctrl(pc), _ref_ctrl(rc))
    assert int(pc["k_active"][0]) < budget


# --- prefill + decode_step --------------------------------------------------

def _models(name):
    rcfg = dataclasses.replace(REF_SMOKE[name], param_dtype="float32")
    pcfg = dataclasses.replace(PORT_SMOKE[name], param_dtype="float32")
    rparams = ref_init(rcfg, jax.random.PRNGKey(5))
    pparams = params_from_reference(jax.tree.map(np.asarray, rparams), pcfg,
                                    device="cpu")
    return rcfg, pcfg, rparams, pparams


def _assert_state_close(pstate, rstate, pcfg, what):
    got = serve_state_to_numpy(pstate, pcfg)
    want = jax.tree.map(np.asarray, rstate)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    for li, layer in want["layers"].items():
        assert sorted(got["layers"][li]) == sorted(layer), f"{what} {li}"
        for name, leaf in layer.items():
            if name == "ctrl":
                _assert_ctrl_equal(got["layers"][li]["ctrl"], leaf,
                                   f"{what} {li}")
            else:
                np.testing.assert_allclose(got["layers"][li][name], leaf,
                                           atol=TOL, rtol=0,
                                           err_msg=f"{what} {li} {name}")


@pytest.fixture
def record_margins(monkeypatch):
    """Wrap the reference serve step's decode attention (and MLA's) to
    record, at every bounded hit event, the top-2 margin of the mass over
    valid slots."""
    margins = []

    def record(mass, valid):
        m = np.where(valid, mass, -np.inf)
        top2 = np.sort(m, axis=-1)[:, -2:]
        margins.extend((top2[:, 1] - top2[:, 0]).tolist())

    def wrap(orig, valid_at):
        def wrapped(*args, **kw):
            o, mass = orig(*args, **kw)
            jax.debug.callback(record, mass, args[valid_at])
            return o, mass
        return wrapped

    monkeypatch.setattr(ref_serve, "decode_attention",
                        wrap(ref_serve.decode_attention, 3))
    monkeypatch.setattr(ref_serve.mla_mod, "mla_attend",
                        wrap(ref_serve.mla_mod.mla_attend, 5))
    return margins


@pytest.fixture
def record_routes(monkeypatch):
    """Record every MoE routing decision on both sides, in call order (the
    reference's through an ordered callback), and the reference's gap
    between the k-th and (k+1)-th router probability."""
    rec = {"ref": [], "port": [], "gap": []}
    ref_route, port_route = ref_serve.moe_mod.route, port_moe.route

    def record(idx, probs):
        rec["ref"].append(np.asarray(idx))
        top = np.sort(np.asarray(probs), axis=-1)
        k = idx.shape[-1]
        rec["gap"].append(float((top[..., -k] - top[..., -k - 1]).min()))

    def ref_wrapped(x, w, cfg):
        idx, gates, probs = ref_route(x, w, cfg)
        jax.debug.callback(record, idx, probs, ordered=True)
        return idx, gates, probs

    def port_wrapped(x, w, cfg):
        idx, gates, probs = port_route(x, w, cfg)
        rec["port"].append(idx.numpy().copy())
        return idx, gates, probs

    monkeypatch.setattr(ref_serve.moe_mod, "route", ref_wrapped)
    monkeypatch.setattr(port_moe, "route", port_wrapped)
    return rec


def _serve_equal_reference(name, budget, margins, routes):
    """Prefill a 20-token prompt, then 28 teacher-forced decode steps, every
    one past the bounded pool's 16 slots: logits, caches and recurrent
    states within 1e-4, positions, DAC control state and MoE routing bit
    for bit after every step.  An embeddings-input model (llava, musicgen)
    takes seeded ``embeds`` ``[B, S, d]`` in the prefill and ``embed``
    ``[B, d]`` at each step; the others take tokens."""
    rcfg, pcfg, rparams, pparams = _models(name)
    B, S, G = 2, 20, 28
    rng = np.random.default_rng(9)
    if pcfg.embeds_input:
        xs = rng.standard_normal((B, S + G, pcfg.d_model)).astype(np.float32)
        key, step_key = "embeds", "embed"
    else:
        xs = rng.integers(0, rcfg.vocab, (B, S + G))
        key, step_key = "tokens", "token"
    rstate, rlast = ref_serve.prefill(rparams, rcfg,
                                      **{key: jnp.asarray(xs[:, :S])},
                                      max_len=S + G, budget=budget)
    pstate, plast = prefill(pparams, pcfg,
                            **{key: torch.from_numpy(xs[:, :S])},
                            max_len=S + G, budget=budget)
    np.testing.assert_allclose(plast.numpy(), np.asarray(rlast), atol=TOL,
                               rtol=0)
    _assert_state_close(pstate, rstate, pcfg, "prefill")
    step = jax.jit(lambda p, s, x: ref_serve.decode_step(
        p, rcfg, s, **{step_key: x}))
    for t in range(S, S + G):
        rstate, rlog = step(rparams, rstate, jnp.asarray(xs[:, t]))
        pstate, plog = decode_step(pparams, pcfg, pstate,
                                   **{step_key: torch.from_numpy(xs[:, t])})
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog),
                                   atol=TOL, rtol=0, err_msg=f"step {t}")
        _assert_state_close(pstate, rstate, pcfg, f"step {t}")
    jax.effects_barrier()
    n_pooled = sum(s.kind in ("attn", "mla") for s in pcfg.layer_specs())
    if budget and n_pooled:
        assert len(margins) >= G * B * n_pooled
        assert min(margins) > MARGIN
    n_moe = sum(bool(s.moe and pcfg.moe) for s in pcfg.layer_specs())
    assert len(routes["port"]) == len(routes["ref"]) == n_moe * (1 + G)
    for t, (a, b) in enumerate(zip(routes["port"], routes["ref"])):
        np.testing.assert_array_equal(a, b, err_msg=f"routing call {t}")
    if n_moe:
        assert min(routes["gap"]) > MARGIN


@pytest.mark.parametrize("name", ["deepseek-7b", "gemma2-27b",
                                  "codeqwen1.5-7b", "qwen1.5-110b"] + MIXED)
@pytest.mark.parametrize("budget", [0, 16])
def test_prefill_and_decode_equal_reference(name, budget, record_margins,
                                            record_routes):
    """Token-input models: :func:`_serve_equal_reference` (windowed and
    softcapped gemma2, MHA with QKV bias (codeqwen), GQA 64/8 with QKV
    bias (qwen), MLA, MoE, Mamba, xLSTM)."""
    _serve_equal_reference(name, budget, record_margins, record_routes)


@pytest.mark.parametrize("name", ["llava-next-mistral-7b",
                                  "musicgen-medium"])
@pytest.mark.parametrize("budget", [0, 16])
def test_prefill_and_decode_from_embeddings_equal_reference(
        name, budget, record_margins, record_routes):
    """Embeddings-input models: ``prefill(embeds=)`` and
    ``decode_step(embed=)`` against the reference's, as
    :func:`_serve_equal_reference` holds them."""
    assert PORT_SMOKE[name].embeds_input
    _serve_equal_reference(name, budget, record_margins, record_routes)


def test_decode_from_reference_state_equals_reference():
    """``serve_state_from_reference`` carries a bounded state (``ctrl``
    included) exactly; decoding from it follows the reference."""
    rcfg, pcfg, rparams, pparams = _models("deepseek-7b")
    B, S = 2, 24
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (B, S + 4))
    rstate, _ = ref_serve.prefill(rparams, rcfg,
                                  tokens=jnp.asarray(toks[:, :S]),
                                  budget=16)
    pstate = serve_state_from_reference(jax.tree.map(np.asarray, rstate),
                                        pcfg, device="cpu")
    _assert_state_close(pstate, rstate, pcfg, "carried")
    for t in range(S, S + 4):
        rstate, rlog = ref_serve.decode_step(rparams, rcfg, rstate,
                                             token=jnp.asarray(toks[:, t]))
        pstate, plog = decode_step(pparams, pcfg, pstate,
                                   token=torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), atol=TOL,
                                   rtol=0)
        _assert_state_close(pstate, rstate, pcfg, f"step {t}")


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "jamba-1.5-large-398b",
                                  "xlstm-125m"])
def test_serve_state_carry_is_exact_in_bf16(name):
    """A bf16 model's prefilled bounded state: the bf16 caches and conv
    tails and the recurrent layers' f32 ``h``/``c``/``C``/``n``/``m`` keep
    their dtypes and bits across ``serve_state_from_reference``, and
    ``serve_state_to_numpy`` gives the same values back."""
    rcfg, pcfg = REF_SMOKE[name], PORT_SMOKE[name]
    rparams = ref_init(rcfg, jax.random.PRNGKey(6))
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 24))
    rstate, _ = ref_serve.prefill(rparams, rcfg, tokens=jnp.asarray(toks),
                                  budget=16)
    rstate = jax.tree.map(np.asarray, rstate)
    pstate = serve_state_from_reference(rstate, pcfg, device="cpu")
    plen = len(rcfg.period)
    dtypes = set()
    for layer, st in enumerate(pstate["layers"]):
        want = rstate["layers"][f"l{layer % plen}"]
        assert sorted(st) == sorted(want)
        for key, leaf in st.items():
            if key == "ctrl":
                continue
            w = want[key][layer // plen]
            assert str(leaf.dtype).removeprefix("torch.") == w.dtype.name
            dtypes.add(w.dtype.name)
            bits = {4: (torch.int32, np.int32), 2: (torch.int16, np.int16)}
            tb, nb = bits[w.dtype.itemsize]
            np.testing.assert_array_equal(leaf.view(tb).numpy(), w.view(nb),
                                          err_msg=f"layer {layer} {key}")
    assert "bfloat16" in dtypes
    assert ("float32" in dtypes) == (name != "deepseek-v2-236b")
    back = serve_state_to_numpy(pstate, pcfg)
    for li, layer in rstate["layers"].items():
        for key, leaf in layer.items():
            if key == "ctrl":
                _assert_ctrl_equal(back["layers"][li]["ctrl"], leaf, li)
            else:
                np.testing.assert_array_equal(
                    back["layers"][li][key], leaf.astype(np.float32))
