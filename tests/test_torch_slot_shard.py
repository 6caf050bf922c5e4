"""The reference's slot-sharded KV cache for sharded serving: a KV cache
whose heads do not divide ``model``, and every MLA latent cache, splits
its slots over ``model`` where they divide it
(``src/repro/serving/serve_step.py::serve_state_shardings``), and B3 (MLA:
its absorbed decode, ``tests/test_torch_mla_slot.py`` holds the law) runs
as a per-rank partial and a rank-ordered merge.

* B3's two parts (``decode_attention_partial_plain``,
  ``decode_attention_merge_plain``, which the wrappers run on the CPU)
  over N in {1, 2, 4, 16} blocks of a slot table give the whole table's
  plain B3 within ``PLAIN_TOL`` (f32): rows with no valid slot at all,
  rows with none in some blocks, a window, a softcap, and heads padded to
  a multiple of N.
* In a 4-rank gloo world on the CPU (``_torch_worlds.slot_world``), a
  (data 1, model 4) mesh, f32, both regimes, prefill and ``STEPS``
  teacher-forced decode steps: qwen1.5-110b's and mixtral-8x22b's smoke
  configs (2 KV heads: slot-split) and deepseek-v2-236b's (MLA, its 4
  heads split 4 ways, its latent cache slot-split) give logits within
  ``TOL`` of the unsharded port, DAC's control state equal after every
  step, MoE routing equal, and a rank's KV (latent + krope) bytes a
  quarter of the unsharded cache's; a slot count that does not divide 4
  keeps the cache whole.  The pool (16 slots) is smaller than the prompt
  (24 tokens), so every decode step evicts.
* Query heads that do not divide 4 (6 over 4 ranks): the same law, the
  heads padded for the exchange (for MLA, ``w_kvb``'s value half and
  ``wo`` cut to each rank's heads).
* Sharded decode from a fresh state held within ``TOL`` of the
  reference's own on the same mesh, ``REF_STEPS`` steps into a pool of
  ``REF_BUDGETS``' 8 slots (the last 4 steps evict), in a subprocess with
  4 forced XLA host devices and the Auto-axes ``jax.sharding.Mesh`` shim
  of ``test_torch_sharded_serve.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_worlds as worlds  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 180
TOL = 1e-4
PLAIN_TOL = 1e-6
BUDGETS = (0, 16)
STEPS = 6
# the reference's decode from a fresh state: 12 steps, a pool of 8 slots
REF_BUDGETS, REF_STEPS = (0, 8), 12
# (name, budget, max_len): a slot count that 4 does not divide
WHOLE = (("qwen1.5-110b", 0, 30), ("mixtral-8x22b", 18, 64),
         ("deepseek-v2-236b", 0, 30))
# (name, query heads, budget): query heads that 4 does not divide
PADDED = (("qwen1.5-110b", 6, 16), ("deepseek-v2-236b", 6, 16))

REFERENCE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
out_dir, steps = sys.argv[1], int(sys.argv[2])
budgets = [int(b) for b in sys.argv[3].split(",")]


def main():
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import SMOKE_ARCHS
    from repro.launch.mesh import shard_ctx
    from repro.models import init_params, shardings
    from repro.serving import init_serve_state
    from repro.serving.serve_step import decode_step, serve_state_shardings
    # the shim: Auto axes (jax.make_mesh now builds Explicit ones)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                             ("data", "model"))
    sctx = dataclasses.replace(shard_ctx(mesh), mode="serve")
    for name in sys.argv[4:]:
        cfg = dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32")
        params = init_params(cfg, jax.random.PRNGKey(0))
        host_params = jax.tree.map(np.asarray, params)
        params = jax.tree.map(jax.device_put, params,
                              shardings(params, cfg, sctx))
        step = jax.jit(lambda p, s, t: decode_step(p, cfg, s, token=t,
                                                   sctx=sctx))
        tokens = np.random.default_rng(5).integers(
            0, cfg.vocab, (steps, 4)).astype(np.int32)
        for budget in budgets:
            state = init_serve_state(cfg, 4, max_len=64, budget=budget)
            state = jax.tree.map(jax.device_put, state,
                                 serve_state_shardings(cfg, sctx, state))
            logits = []
            for t in tokens:
                state, lg = step(params, state, jnp.asarray(t))
                logits.append(np.asarray(lg))
            np.savez(os.path.join(out_dir, f"{name}-{budget}.npz"),
                     params=np.array(host_params, dtype=object),
                     tokens=tokens, logits=np.stack(logits))


try:
    main()
except BaseException:
    open(os.path.join(out_dir, "failed"), "w").close()
    raise
open(os.path.join(out_dir, "done"), "w").close()
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slot_shard")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    # the reference runs beside the world, whose ranks read its files
    # once it has written them all ("done"; "failed" stays if it raised)
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    with open(tmp / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                                str(ref_dir), str(REF_STEPS),
                                ",".join(map(str, REF_BUDGETS)),
                                *worlds.SLOT_ARCHS], env=env, stdout=log,
                               stderr=subprocess.STDOUT)
    refs = {name: {b: str(ref_dir / f"{name}-{b}.npz") for b in REF_BUDGETS}
            for name in worlds.SLOT_ARCHS}
    try:
        out = M.launch_world(worlds.slot_world, 4,
                             (worlds.SLOT_ARCHS, BUDGETS, STEPS, refs, WHOLE,
                              PADDED, str(ref_dir), TIMEOUT),
                             init_file=str(tmp / "init"), device="cpu",
                             timeout=TIMEOUT)
    finally:
        if ref.wait(timeout=TIMEOUT):
            pytest.fail((tmp / "ref.log").read_text()[-3000:])
    return out


# name: B, S, H, Hkv, D, Dv, softcap, valid pattern
PLAIN_CASES = {
    "empty-rows": (3, 256, 8, 2, 16, 16, 0.0, "empty"),
    "window": (2, 512, 8, 2, 32, 16, 0.0, "window"),
    "softcap": (2, 128, 12, 4, 16, 16, 30.0, "sparse"),
    "odd-heads": (2, 64, 6, 6, 8, 8, 0.0, "sparse"),
}


def _valid(pattern, B, S, rng):
    """valid ``[B, S]``: ``empty`` the first row with no valid slot, the
    second with one, the others 70% at random; ``window`` 40 slots before
    a position that moves back 100 slots a row (most blocks empty);
    ``sparse`` 70% at random."""
    if pattern == "window":
        pos = S - 1 - 100 * np.arange(B)[:, None]
        ar = np.arange(S)[None]
        return (ar <= pos) & (ar > pos - 40)
    valid = rng.random((B, S)) < 0.7
    if pattern == "empty":
        valid[0] = False
        valid[1] = False
        valid[1, S // 3] = True
    return valid


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_partial_and_merge_equal_plain_b3(case, n):
    """Each of ``n`` blocks' partial, the heads padded to a multiple of
    ``n`` and dealt ``Hp / n`` to a rank as the exchange deals them, merged
    in block order: ``o`` and the whole rows' mass (each block's, from
    every head's ``(m, l)``) equal the plain B3 of the whole table."""
    B, S, H, Hkv, D, Dv, cap, pattern = PLAIN_CASES[case]
    rng = np.random.default_rng(S + n)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    valid = torch.from_numpy(_valid(pattern, B, S, rng))
    Sb = S // n
    parts, scores = zip(*(da.decode_attention_partial(
        q, k[:, r * Sb:(r + 1) * Sb], v[:, r * Sb:(r + 1) * Sb], valid,
        r * Sb, softcap=cap) for r in range(n)))
    padded = torch.stack([da.pad_heads(p, n) for p in parts])
    assert padded.shape[2] % n == 0 and padded.shape[2] - H < n
    ml = torch.stack(parts)[..., Dv:]
    hn = padded.shape[2] // n
    outs, mass = [], []
    for r in range(n):
        o, m = da.decode_attention_merge(padded[:, :, r * hn:(r + 1) * hn],
                                         ml, scores[r])
        outs.append(o)
        mass.append(m)
    o = torch.cat(outs, dim=1)[:, :H]
    mass = torch.cat(mass, dim=-1)
    want_o, want_m = da.decode_attention_plain(q, k, v, valid, softcap=cap)
    assert torch.isfinite(o).all() and torch.isfinite(mass).all()
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), rtol=PLAIN_TOL,
                               atol=PLAIN_TOL)
    np.testing.assert_allclose(mass.numpy(), want_m.numpy(), rtol=PLAIN_TOL,
                               atol=PLAIN_TOL)
    # the padded heads' outputs are 0; o alone needs no mass inputs
    assert (torch.cat(outs, dim=1)[:, H:] == 0).all()
    alone, none = da.decode_attention_merge(padded[:, :, :hn])
    assert none is None and torch.equal(alone, outs[0])


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", worlds.SLOT_ARCHS)
def test_slot_split_serving_equals_unsharded(served, name, budget):
    """Every rank's whole-batch logits within ``TOL`` of the unsharded
    port's at the prefill and each decode step, the same bits on every
    rank; every attention and MLA layer's cache slot-split; in the bounded
    regime
    DAC's control state equal to the unsharded one's after every step, the
    steps writing over live slots; MoE routing equal."""
    for out in served:
        row = out[(name, budget)]
        got, want = row["logits"]
        assert got.shape == want.shape == (STEPS + 1,) + want.shape[1:]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert row["split"] and all(row["split"]) and row["routing_equal"]
        if budget:
            assert row["ctrl_steps"] and row["ctrl_equal"]
            assert row["evictions"] > 0
        np.testing.assert_array_equal(got, served[0][(name, budget)][
            "logits"][0])


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", worlds.SLOT_ARCHS)
def test_slot_split_rank_holds_a_quarter_of_the_cache(served, name, budget):
    """A rank's KV (or latent + krope) bytes are a quarter of the
    unsharded cache's."""
    for out in served:
        mine, whole = out[(name, budget)]["kv_bytes"]
        assert whole > 0 and 4 * mine == whole


@pytest.mark.parametrize("case", WHOLE)
def test_indivisible_slots_stay_whole(served, case):
    """A slot count that the model axis does not divide keeps every
    rank's cache whole (the reference's ``tp_if``): the unsharded cache's
    bytes on each rank, logits within ``TOL``, control state equal."""
    name, budget, _ = case
    for out in served:
        row = out[("whole", name, budget)]
        assert not any(row["split"])
        mine, whole = row["kv_bytes"]
        assert mine == whole
        np.testing.assert_allclose(*row["logits"], rtol=0, atol=TOL)
        if budget:
            assert row["ctrl_equal"]


@pytest.mark.parametrize("case", PADDED)
def test_indivisible_query_heads_pad_the_exchange(served, case):
    """Query heads that the model axis does not divide (6 over 4 ranks):
    ``wq`` and ``wo`` (MLA: ``w_q``/``w_qb``, ``w_kvb`` and ``wo``) stay
    whole, the exchange pads the heads to 8 and each rank projects its
    real ones; logits within ``TOL`` of the unsharded port, control state
    equal, the steps evicting."""
    name, _, budget = case
    for out in served:
        row = out[("padded", name, budget)]
        assert all(row["split"]) and 4 * row["kv_bytes"][0] == \
            row["kv_bytes"][1]
        np.testing.assert_allclose(*row["logits"], rtol=0, atol=TOL)
        assert row["ctrl_equal"] and row["evictions"] > 0


def test_whole_latent_cache_where_slots_split_raises(served):
    """A decode step over an MLA latent cache held whole on a rank, where
    the model axis divides its slots, raises instead of attending over
    the whole cache: no fallback hides the split."""
    for out in served:
        err = out[("whole-raises", "deepseek-v2-236b")]
        assert err is not None and "whole" in err


@pytest.mark.parametrize("budget", REF_BUDGETS)
@pytest.mark.parametrize("name", worlds.SLOT_ARCHS)
def test_slot_split_decode_equals_reference_sharded_decode(served, name,
                                                            budget):
    """The reference's own sharded decode (``REF_STEPS`` steps from a
    fresh state on the (1, 4) mesh, its cache's slots over ``model``) and
    the port's, from the same parameters and tokens: logits within
    ``TOL``; bounded, the port's steps past the pool's 8 slots evict."""
    for out in served:
        row = out[("reference", name, budget)]
        got, want = row["logits"]
        assert got.shape == want.shape == (REF_STEPS, 4, want.shape[-1])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert (row["evictions"] > 0) == bool(budget)
