"""Resumable campaign results store: one file per completed cell (the
port's copy of the reference's ``campaign/store.py``, on the port's
``bench/results.py``).  :func:`cell_key` hashes the same identity JSON as
the reference's, so a port store and a reference store over one corpus
name the same files.

A campaign directory is the single source of truth for a run::

    <root>/
      manifest.json          # the manifest that defines the campaign
      cells/<key>.json       # one repro.bench.result/v2 payload per cell
      quarantine/<key>.json  # failed cells: the cell + its traceback
      journal.jsonl          # append-only wall-time/event log (volatile)

Cell files are keyed by the content hash of ``(trace, policy, K, seed,
T)`` (:func:`cell_key`) and written atomically (temp file +
``os.replace``), so a killed worker never leaves a torn record and a
restarted campaign resumes by simply skipping keys that already exist.
Payloads are validated by :func:`repro_torch.bench.results.validate` on both
write and read, and **normalized** before writing — volatile fields
(``created_unix``, per-record and payload ``wall_s``) are zeroed, real
timings going to ``journal.jsonl`` instead — so an interrupted-and-
resumed campaign produces a ``cells/`` tree *bit-identical* to an
uninterrupted one (``tests/test_torch_campaign.py`` asserts exactly this).

>>> import tempfile
>>> from repro_torch.bench import results
>>> store = CampaignStore(tempfile.mkdtemp())
>>> p = results.build_payload("cell", config={}, records=[
...     {"metrics": {"miss_ratio": [0.5]}, "seeds": [0]}],
...     schema=results.SCHEMA_V2, device="cpu")
>>> _ = store.put("0123abcd", p)
>>> store.has("0123abcd"), store.get("0123abcd")["created_unix"]
(True, 0.0)
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

from ..bench import results

__all__ = ["Cell", "cell_key", "deterministic_payload", "CampaignStore"]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One campaign grid cell: a trace file under a dataset x one policy
    spec x one capacity (int or regime letter) x one seed, with the
    manifest's optional request cap ``T``.

    >>> c = Cell(dataset="kv", trace="corpus/kv.csv.gz", format="auto",
    ...          policy="lru", K="S", seed=0)
    >>> Cell.from_dict(c.to_dict()) == c
    True
    """

    dataset: str
    trace: str                  # trace file path
    format: str                 # ingest format ("auto" resolves by suffix)
    policy: str                 # make_policy spec string
    K: str | int                # int capacity or "S"/"L" regime letter
    seed: int
    T: int | None = None        # request cap from the manifest grid

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, cfg: dict) -> "Cell":
        return cls(**cfg)


def cell_key(cell: Cell) -> str:
    """Content hash identifying one cell's result: the first 16 hex chars
    of the SHA-256 of its canonical identity tuple.  Depends only on what
    determines the numbers — trace path, policy, K, seed and the request
    cap — not on dataset naming, shard assignment or execution order.

    >>> a = Cell(dataset="x", trace="t.csv", format="auto",
    ...          policy="lru", K=8, seed=0)
    >>> cell_key(a) == cell_key(dataclasses.replace(a, dataset="y"))
    True
    >>> cell_key(a) == cell_key(dataclasses.replace(a, seed=1))
    False
    """
    ident = json.dumps(
        {"trace": cell.trace, "policy": cell.policy, "K": cell.K,
         "seed": cell.seed, "T": cell.T},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(ident.encode("utf-8")).hexdigest()[:16]


def deterministic_payload(payload: dict) -> dict:
    """A copy of ``payload`` with the volatile timing fields zeroed —
    ``created_unix`` and every ``wall_s`` (payload- and record-level) —
    so byte-identical inputs produce byte-identical cell files across
    runs.  Wall times belong in the store journal, not the records.

    >>> p = {"created_unix": 9.0, "wall_s": 1.5,
    ...      "records": [{"wall_s": 0.7, "metrics": {"m": [1]}}]}
    >>> q = deterministic_payload(p)
    >>> (q["created_unix"], q["wall_s"], q["records"][0]["wall_s"])
    (0.0, 0.0, 0.0)
    >>> p["wall_s"]                     # the input is left untouched
    1.5
    """
    out = dict(payload)
    if "created_unix" in out:
        out["created_unix"] = 0.0
    if "wall_s" in out:
        out["wall_s"] = 0.0
    if isinstance(out.get("records"), list):
        out["records"] = [
            dict(r, wall_s=0.0) if isinstance(r, dict) and "wall_s" in r
            else r
            for r in out["records"]]
    return out


def _atomic_write(path: str, data: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CampaignStore:
    """Directory-backed, crash-safe result store for one campaign.

    All writes are validate-then-atomic-rename; all reads re-validate, so
    a consumer can trust every file under ``cells/``.  ``has`` /
    ``completed`` / ``quarantined`` are what the executor resumes from.
    """

    CELLS = "cells"
    QUARANTINE = "quarantine"
    MANIFEST = "manifest.json"
    JOURNAL = "journal.jsonl"

    def __init__(self, root: str):
        self.root = str(root)
        self.cells_dir = os.path.join(self.root, self.CELLS)
        self.quarantine_dir = os.path.join(self.root, self.QUARANTINE)
        os.makedirs(self.cells_dir, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)

    # -- cell records -------------------------------------------------------

    def path_for(self, key: str) -> str:
        return os.path.join(self.cells_dir, f"{key}.json")

    def has(self, key: str) -> bool:
        return os.path.exists(self.path_for(key))

    def completed(self) -> list:
        """Sorted keys of every completed cell."""
        return sorted(fn[:-5] for fn in os.listdir(self.cells_dir)
                      if fn.endswith(".json"))

    def put(self, key: str, payload: dict) -> str:
        """Validate, normalize and atomically write one cell payload;
        returns the cell file path."""
        det = deterministic_payload(results.validate(payload))
        path = self.path_for(key)
        _atomic_write(path, json.dumps(det, indent=1, sort_keys=True) + "\n")
        return path

    def get(self, key: str) -> dict:
        """Read + re-validate one completed cell payload."""
        with open(self.path_for(key)) as f:
            return results.validate(json.load(f))

    def payloads(self):
        """Iterate ``(key, payload)`` over every completed cell, sorted by
        key — the report layer's only input."""
        for key in self.completed():
            yield key, self.get(key)

    # -- quarantine ---------------------------------------------------------

    def quarantine(self, key: str, cell, error: str) -> str:
        """Record a failed cell (its identity + the traceback) without
        touching ``cells/`` — the campaign carries on and the failure is
        inspectable.  Delete the file to retry the cell on a later run."""
        path = os.path.join(self.quarantine_dir, f"{key}.json")
        entry = {"key": key, "cell": cell.to_dict(), "error": str(error),
                 # repolint: waive[wallclock] -- quarantine provenance
                 "quarantined_unix": time.time()}
        _atomic_write(path, json.dumps(entry, indent=1) + "\n")
        return path

    def quarantined(self) -> list:
        """Sorted keys of every quarantined cell."""
        return sorted(fn[:-5] for fn in os.listdir(self.quarantine_dir)
                      if fn.endswith(".json"))

    def get_quarantined(self, key: str) -> dict:
        with open(os.path.join(self.quarantine_dir, f"{key}.json")) as f:
            return json.load(f)

    # -- manifest + journal -------------------------------------------------

    def init_manifest(self, manifest) -> None:
        """Pin the campaign's manifest into the store (first run), or
        verify it matches the pinned one (every resume) — mixing two
        different grids into one store is an error, not a surprise."""
        path = os.path.join(self.root, self.MANIFEST)
        mine = json.dumps(manifest.to_dict(), sort_keys=True)
        if os.path.exists(path):
            with open(path) as f:
                pinned = json.dumps(json.load(f), sort_keys=True)
            if pinned != mine:
                raise ValueError(
                    f"store {self.root!r} was created from a different "
                    "manifest; use a fresh store directory (or delete "
                    f"{path} if the change is intentional)")
            return
        _atomic_write(path, json.dumps(manifest.to_dict(), indent=1,
                                       sort_keys=True) + "\n")

    def manifest_dict(self) -> dict:
        """The pinned manifest, as a dict (for ``--report`` with no
        manifest argument: the store is self-describing)."""
        with open(os.path.join(self.root, self.MANIFEST)) as f:
            return json.load(f)

    def journal(self, **event) -> None:
        """Append one JSON event line (timings live here, keeping the
        cell records deterministic)."""
        # repolint: waive[wallclock] -- journal timing is deliberately
        entry = dict(event, unix=time.time())  # outside the cell records
        with open(os.path.join(self.root, self.JOURNAL), "a") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")
