"""Port parity: the recurrent layers (``repro_torch.models.ssm``: Mamba,
mLSTM, sLSTM) against the reference's ``models/ssm.py`` on the CPU, and
the reference's own laws (chunked = sequential) on the port.

Weights come from the reference's inits and are carried across exactly;
inputs from a numpy seed.  Outputs and states are held within 1e-5 in f32:
Mamba's chunk scan combines the same products in another order than
``associative_scan`` (log-depth doubling against the reference's
up-and-down sweep), and the mLSTM stabiliser ``m`` and its ``exp(-m)``
floor under the denominator pass any rounding of the gates' sums on; the
largest difference seen is ~1e-6 on values of magnitude ~1.  The
chunked-against-sequential laws keep the reference's tolerances
(``tests/test_models.py``).
"""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS as PORT_SMOKE  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402

TOL = 1e-5
KINDS = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-125m",
         "slstm": "xlstm-125m"}


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _carry(tree):
    return jax.tree.map(_t, tree)


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0, err_msg=what)


def _setup(kind, B, S, seed, scale=0.5):
    rcfg, pcfg = REF_SMOKE[KINDS[kind]], PORT_SMOKE[KINDS[kind]]
    rp = getattr(rssm, f"{kind}_init")(jax.random.PRNGKey(seed), rcfg,
                                       jnp.float32)
    x = (np.random.default_rng(seed).standard_normal((B, S, rcfg.d_model))
         * scale).astype(np.float32)
    return rcfg, pcfg, rp, _carry(rp), jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("S", [1, 3, 5])
def test_causal_conv_and_step_equal_reference(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = rssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm.causal_conv1d(*map(torch.from_numpy, (x, w, b)))
    _close(got, want)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    rs, ro = rssm.conv1d_step(jnp.asarray(st), jnp.asarray(x[:, 0]),
                              jnp.asarray(w), jnp.asarray(b))
    ps, po = ssm.conv1d_step(torch.from_numpy(st), torch.from_numpy(x[:, 0]),
                             torch.from_numpy(w), torch.from_numpy(b))
    _close(ps, rs)
    _close(po, ro)


@pytest.mark.parametrize("kind,B,S", [
    ("mamba", 2, 24), ("mamba", 1, 13), ("mamba", 2, 2),
    ("mlstm", 2, 24), ("mlstm", 1, 13), ("mlstm", 2, 2),
    ("slstm", 2, 16), ("slstm", 1, 2)])
def test_apply_and_state_equal_reference(kind, B, S):
    """Each block's prefill output and its decode state (conv tail padded
    when the prompt is shorter than the conv)."""
    rcfg, pcfg, rp, pp, xj, xt = _setup(kind, B, S, seed=S)
    want, wst = getattr(rssm, f"{kind}_apply")(xj, rp, rcfg,
                                               return_state=True)
    got, gst = getattr(ssm, f"{kind}_apply")(xt, pp, pcfg, return_state=True)
    _close(got, want, f"{kind} out")
    assert sorted(gst) == sorted(wst)
    for k in wst:
        assert gst[k].dtype == torch.float32
        _close(gst[k], wst[k], f"{kind} state {k}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_steps_equal_reference(kind):
    """Eight decode steps from a carried prefill state: outputs and every
    state leaf."""
    rcfg, pcfg, rp, pp, xj, xt = _setup(kind, 2, 12, seed=7)
    _, rst = getattr(rssm, f"{kind}_apply")(xj[:, :4], rp, rcfg,
                                            return_state=True)
    pst = _carry(rst)
    rstep = jax.jit(lambda x, s: getattr(rssm, f"{kind}_decode_step")(
        x, rp, rcfg, s))
    for t in range(4, 12):
        ro, rst = rstep(xj[:, t], rst)
        po, pst = getattr(ssm, f"{kind}_decode_step")(xt[:, t], pp, pcfg,
                                                      pst)
        _close(po, ro, f"{kind} step {t}")
        for k in rst:
            _close(pst[k], rst[k], f"{kind} step {t} {k}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_state_init_equals_reference(kind):
    rcfg, pcfg = REF_SMOKE[KINDS[kind]], PORT_SMOKE[KINDS[kind]]
    want = getattr(rssm, f"{kind}_state_init")(rcfg, 3, jnp.bfloat16)
    got = getattr(ssm, f"{kind}_state_init")(pcfg, 3, torch.bfloat16, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        assert not got[k].any()


def _mlstm_inputs(seed, B=2, S=32, H=4, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    ip = rng.standard_normal((B, S, H)).astype(np.float32)
    fp = (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)
    C0 = np.zeros((B, H, dh, dh), np.float32)
    n0 = np.zeros((B, H, dh), np.float32)
    m0 = np.zeros((B, H), np.float32)
    return q, k, v, ip, fp, C0, n0, m0


@pytest.mark.parametrize("seed,chunk", [(0, 4), (1, 8), (2, 16), (3, 5),
                                        (4, 32)])
def test_mlstm_chunked_equals_sequential(seed, chunk):
    """``tests/test_models.py``'s law on the port (its tolerances)."""
    args = [torch.from_numpy(a) for a in _mlstm_inputs(seed)]
    h1, C1, n1, m1 = ssm.mlstm_seq(*args)
    h2, C2, n2, m2 = ssm.mlstm_cell_chunked(*args, chunk)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(C1.numpy(), C2.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed,chunk", [(0, 8), (5, 5)])
def test_mlstm_cells_equal_reference(seed, chunk):
    a = _mlstm_inputs(seed)
    for fn in ("mlstm_seq", "mlstm_cell_chunked"):
        extra = (chunk,) if fn == "mlstm_cell_chunked" else ()
        want = getattr(rssm, fn)(*map(jnp.asarray, a), *extra)
        got = getattr(ssm, fn)(*map(torch.from_numpy, a), *extra)
        for g, w, what in zip(got, want, "hCnm"):
            _close(g, w, f"{fn} {what}", tol=2e-5)


@pytest.mark.parametrize("S", [24, 13])
def test_mamba_chunked_equals_stepwise(S):
    """``tests/test_models.py``'s law on the port (its tolerances)."""
    rcfg, cfg, _, p, _, _ = _setup("mamba", 2, S, seed=11)
    x = torch.from_numpy((np.random.default_rng(11).standard_normal(
        (2, S, cfg.d_model)) * 0.1).astype(np.float32))
    y_par, st_par = ssm.mamba_apply(x, p, cfg, return_state=True)
    st = ssm.mamba_state_init(cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(S):
        o, st = ssm.mamba_decode_step(x[:, t], p, cfg, st)
        ys.append(o)
    np.testing.assert_allclose(y_par.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_par["h"].numpy(), st["h"].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_par["conv"].numpy(), st["conv"].numpy(),
                               rtol=0, atol=1e-6)
