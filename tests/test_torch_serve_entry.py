"""Port parity of the serving entry point: ``python -m
repro_torch.launch.serve --smoke --device cpu`` against the reference's
``python -m repro.launch.serve --smoke``, both in this process.

The port's ``init_params`` is replaced by the reference's
``init_params(cfg, PRNGKey(seed))`` carried across with
``params_from_reference``, so both entry points serve the same weights;
prompts (tokens, or embeddings for llava and musicgen) come from the
same seeded numpy draws on both sides.  The printed greedy sample tokens
and, with a budget, DAC's active budgets must be equal.

Both sides serve the smoke configurations in f32 (each side's table
entry replaced for the test): their logits then agree within ~1e-6, far
inside the top-2 gaps of greedy decoding.  In bf16 the two frameworks
round matmul outputs differently (~2e-2 on logits of ~3), which flips
argmax ties of one bf16 step (llava at seed 3, step 0).
"""
import dataclasses
import re
import sys

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.launch.serve as ref_serve  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
import repro_torch.models as port_models  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402

ARCHS = ["deepseek-7b", "gemma2-27b", "codeqwen1.5-7b", "qwen1.5-110b",
         "llava-next-mistral-7b", "musicgen-medium"]
SEED = 3


def _reported(text):
    """The printed sample tokens and DAC budget line (None unbounded)."""
    tokens = re.search(r"\[serve\] sample tokens: (\[.*\])", text).group(1)
    budgets = re.search(r"\[serve\] DAC active budgets: (.*)", text)
    return tokens, budgets and budgets.group(1)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("budget", [0, 16])
def test_serve_entry_prints_the_reference_tokens(name, budget, monkeypatch,
                                                 capsys):
    """A 32-token prompt and 12 greedy steps, past the 16-slot pool: the
    port's printed sample tokens and DAC budgets equal the reference's,
    and ``main`` returns what it printed."""
    rcfg = dataclasses.replace(ref_configs.SMOKE_ARCHS[name],
                               param_dtype="float32")
    monkeypatch.setitem(ref_configs.SMOKE_ARCHS, name, rcfg)
    monkeypatch.setitem(port_configs.SMOKE_ARCHS, name, dataclasses.replace(
        port_configs.SMOKE_ARCHS[name], param_dtype="float32"))
    argv = ["--arch", name, "--smoke", "--batch", "2", "--prompt-len", "32",
            "--gen", "12", "--budget", str(budget), "--seed", str(SEED)]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve"] + argv)
    ref_serve.main()
    want = _reported(capsys.readouterr().out)

    ref_params = jax.tree.map(np.asarray,
                              ref_init(rcfg, jax.random.PRNGKey(SEED)))

    def reference_weights(cfg, generator=None, device="cuda", sctx=None):
        return params_from_reference(ref_params, cfg, device=device)
    monkeypatch.setattr(port_models, "init_params", reference_weights)
    rec = port_serve.main(argv + ["--device", "cpu"])
    got = _reported(capsys.readouterr().out)

    assert got == want
    assert rec["device"] == "cpu"
    assert rec["tokens"].shape == (13, 2)
    assert str(rec["tokens"][:8, 0].tolist()) == got[0]
    if budget:
        assert rec["k_active"].shape[1] == 2
        assert 0 < rec["k_active"].min() <= rec["k_active"].max() <= budget
    else:
        assert got[1] is None and rec["k_active"] is None
