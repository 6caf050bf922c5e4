"""Deterministic, stateless-resumable LM token pipeline (the port's copy
of the reference's ``data/tokens.py``, whole; ``tests/test_torch_isolation.py``
holds its batches equal to the reference's bit for bit).

``batch(step)`` derives every byte from (seed, step, host) counters — no
iterator state, so a restarted / rescheduled / elastically-resized job
regenerates exactly the stream it would have seen (the fault-tolerance tests
rely on this).  Token draws follow a Zipf marginal with a light Markov
repetition structure so losses are non-trivial.

For stub-frontend archs (audio/vlm) the pipeline emits precomputed
embeddings [B, S, d] (the assignment's modality frontend stub) plus labels.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, embed_dim: int = 0, repeat_p: float = 0.3):
        self.vocab = vocab
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.embed_dim = embed_dim
        self.repeat_p = repeat_p
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        w = ranks ** -1.1
        self._pmf = w / w.sum()

    def _rng(self, step: int):
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        """Per-host slice of the global batch for `step`."""
        B, S = self.global_batch, self.seq_len
        assert B % n_hosts == 0
        rng = self._rng(step)
        toks = rng.choice(self.vocab, size=(B, S + 1), p=self._pmf)
        rep = rng.random((B, S)) < self.repeat_p
        for t in range(1, S + 1):                    # light Markov structure
            toks[:, t] = np.where(rep[:, t - 1], toks[:, t - 1], toks[:, t])
        toks = toks.astype(np.int32)
        lo = host_id * (B // n_hosts)
        hi = lo + B // n_hosts
        out = {"labels": toks[lo:hi, 1:]}
        if self.embed_dim:
            emb = rng.standard_normal(
                (B, S, self.embed_dim)).astype(np.float32) * 0.05
            out["embeds"] = emb[lo:hi]
        else:
            out["tokens"] = toks[lo:hi, :-1]
        return out
