"""Canonical versioned result schema for benchmark/sweep outputs (the
port's copy of the reference's ``bench/results.py``: the same schema
strings, payload shape and validation; the provenance is the port's own).

Two versions coexist: ``repro.bench.result/v1`` for single-cache sweeps,
and ``repro.bench.result/v2``, a strict superset whose records may carry
tier fields (``arbiter``/``budget``/``n_tenants``) and a ``tenants`` list
of per-tenant sub-records.  Every payload has this shape::

    {
      "schema": "repro.bench.result/v1",
      "bench": "<name>",
      "created_unix": <float>,
      "provenance": {"git_sha", "torch", "cuda", "backend", "device_name",
                     "device_count"},
      "config": {...},        # the sweep config (or bench parameters)
      "records": [            # one per grid cell / measurement
        {"metrics": {"miss_ratio": [per-seed floats] | float, ...},
         # standard optional keys, validated when present:
         "policy": str, "scenario": str, "trace": str,
         "T": int, "K": int, "K_label": str, "seeds": [ints],
         "wall_s": float, ...}
      ],
      "extras": {...},        # free-form derived tables (reporting)
      "wall_s": <float>
    }

``validate`` is a hand-rolled structural check; ``save`` validates before
writing so a non-conforming payload never lands on disk, and ``load``
validates after reading.  Provenance stamps every payload with the git
SHA, the torch and CUDA versions and the device the sweep ran on.
"""
from __future__ import annotations

import json
import numbers
import os
import subprocess
import time

import torch

__all__ = ["SCHEMA_V1", "SCHEMA_VERSION", "SCHEMA_V2", "SCHEMA_VERSIONS",
           "RESULTS_DIR", "set_results_dir", "atomic_write_json",
           "provenance", "build_payload", "validate", "save", "load"]

# the port's one home of the schema-version strings (the reference's are
# in its own bench/results.py; the port imports nothing of it): every
# other port module imports these constants
# repolint: waive[schema-literal] -- the port's home of the v1 string
SCHEMA_V1 = "repro.bench.result/v1"
# v2 = v1 plus multi-tenant tier cells: records may carry "arbiter" /
# "budget" / "n_tenants" and a "tenants" list of per-tenant sub-records
# ({"tenant": int, "metrics": {...}}, metrics checked like record metrics,
# per-seed lists aligned with the record's seed axis).  Dynamic-fleet
# cells use the same shape with "n_lanes" and a "lanes" list
# ({"lane": int, "metrics": {...}}).  v1 payloads stay valid and are
# still written by the single-cache sweeps.
# repolint: waive[schema-literal] -- the port's home of the v2 string
SCHEMA_V2 = "repro.bench.result/v2"
SCHEMA_VERSION = SCHEMA_V1   # historical alias (pre-v2 name); prefer V1/V2
SCHEMA_VERSIONS = (SCHEMA_V1, SCHEMA_V2)

RESULTS_DIR = os.environ.get("BENCH_OUT", "experiments/bench")


def set_results_dir(path: str) -> str:
    """Redirect the default results directory for this process (what
    ``benchmarks.run --out-dir`` plumbs through): every later
    :func:`save` without an explicit ``results_dir`` writes there, so
    campaign runs and ad-hoc benchmark runs don't interleave JSONs."""
    global RESULTS_DIR
    RESULTS_DIR = str(path)
    return RESULTS_DIR


def atomic_write_json(path: str, payload: dict, *, sort_keys: bool = False,
                      indent: int = 1) -> str:
    """Durably write JSON via temp-file + ``os.replace``: a reader (or a
    crash) never observes a torn file.  Returns ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=indent, sort_keys=sort_keys)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path

_RECORD_OPTIONAL = {
    "policy": str, "scenario": str, "trace": str, "K_label": str,
    "T": numbers.Integral, "K": numbers.Integral,
    "wall_s": numbers.Real,
}
_RECORD_OPTIONAL_V2 = dict(
    _RECORD_OPTIONAL,
    arbiter=str, budget=numbers.Integral, budget_label=str,
    n_tenants=numbers.Integral, n_lanes=numbers.Integral,
)
_PROVENANCE_KEYS = {"git_sha": str, "torch": str, "cuda": str,
                    "backend": str, "device_name": str,
                    "device_count": numbers.Integral}


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def provenance(device="cuda") -> dict:
    """Attribution stamp: exact code, library versions and the device
    (``"cuda"`` or ``"cpu"``) the run used.

    >>> sorted(provenance("cpu"))
    ['backend', 'cuda', 'device_count', 'device_name', 'git_sha', 'torch']
    """
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    return {
        "git_sha": _git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
        "device_count": torch.cuda.device_count() if on_card else 1,
    }


def build_payload(bench: str, *, config: dict, records: list,
                  extras: dict | None = None,
                  wall_s: float | None = None,
                  schema: str = SCHEMA_V1, device="cuda") -> dict:
    """Assemble (but do not validate) one canonical payload; pass
    ``schema=SCHEMA_V2`` for tier results with per-tenant records, and
    the device the records were computed on.

    >>> p = build_payload("demo", config={}, records=[
    ...     {"metrics": {"miss_ratio": [0.5]}, "seeds": [0]}], device="cpu")
    >>> validate(p)["schema"]
    'repro.bench.result/v1'
    """
    if schema not in SCHEMA_VERSIONS:
        raise ValueError(
            f"unknown schema {schema!r}; known: {list(SCHEMA_VERSIONS)}")
    return {
        "schema": schema,
        "bench": bench,
        # repolint: waive[wallclock] -- provenance stamp, not a timing
        "created_unix": time.time(),
        "provenance": provenance(device),
        "config": config,
        "records": records,
        "extras": extras or {},
        "wall_s": 0.0 if wall_s is None else float(wall_s),
    }


def _fail(path: str, msg: str):
    raise ValueError(f"result schema violation at {path}: {msg}")


def _check_metric_value(path, v):
    if isinstance(v, numbers.Real) and not isinstance(v, bool):
        return
    if isinstance(v, list):
        if not v:
            _fail(path, "metric list must be non-empty")
        for i, x in enumerate(v):
            if not isinstance(x, numbers.Real) or isinstance(x, bool):
                _fail(f"{path}[{i}]", f"expected a number, got {type(x).__name__}")
        return
    _fail(path, f"expected a number or list of numbers, got {type(v).__name__}")


def _check_metrics_dict(path: str, metrics, seeds=None):
    if not isinstance(metrics, dict) or not metrics:
        _fail(path, "must be a non-empty dict")
    for k, v in metrics.items():
        if not isinstance(k, str):
            _fail(path, f"metric names must be str, got {k!r}")
        _check_metric_value(f"{path}[{k!r}]", v)
        # per-seed metric lists must line up with the seed axis
        if seeds is not None and isinstance(v, list) and len(v) != len(seeds):
            _fail(f"{path}[{k!r}]",
                  f"length {len(v)} != len(seeds) {len(seeds)}")


def _check_tenants(path: str, tenants, seeds, key: str = "tenant"):
    """v2: per-tenant (or, with ``key="lane"``, per-lane fleet)
    sub-records inside one cell."""
    if not isinstance(tenants, list) or not tenants:
        _fail(path, f"must be a non-empty list of per-{key} records")
    for j, ten in enumerate(tenants):
        tp = f"{path}[{j}]"
        if not isinstance(ten, dict):
            _fail(tp, f"{key} record must be a dict, got {type(ten).__name__}")
        if not isinstance(ten.get(key), numbers.Integral):
            _fail(f"{tp}.{key}", f"missing or non-int {key} index")
        if "metrics" not in ten:
            _fail(tp, f"{key} record missing 'metrics'")
        _check_metrics_dict(f"{tp}.metrics", ten["metrics"], seeds)


def _check_record(path: str, rec, v2: bool = False):
    if not isinstance(rec, dict):
        _fail(path, f"record must be a dict, got {type(rec).__name__}")
    if "metrics" not in rec:
        _fail(path, "record missing 'metrics'")
    seeds = None
    if "seeds" in rec:
        seeds = rec["seeds"]
        if (not isinstance(seeds, list) or
                not all(isinstance(s, numbers.Integral) for s in seeds)):
            _fail(f"{path}.seeds", "must be a list of ints")
    _check_metrics_dict(f"{path}.metrics", rec["metrics"], seeds)
    if "tenants" in rec:
        if not v2:
            _fail(f"{path}.tenants",
                  f"per-tenant records require schema {SCHEMA_V2!r}")
        _check_tenants(f"{path}.tenants", rec["tenants"], seeds)
    if "lanes" in rec:
        if not v2:
            _fail(f"{path}.lanes",
                  f"per-lane fleet records require schema {SCHEMA_V2!r}")
        _check_tenants(f"{path}.lanes", rec["lanes"], seeds, key="lane")
    optional = _RECORD_OPTIONAL_V2 if v2 else _RECORD_OPTIONAL
    for key, typ in optional.items():
        if key in rec and not isinstance(rec[key], typ):
            _fail(f"{path}.{key}",
                  f"expected {typ.__name__}, got {type(rec[key]).__name__}")


def validate(payload: dict) -> dict:
    """Structurally validate a result payload; returns it unchanged.
    Raises ``ValueError`` naming the offending path otherwise."""
    if not isinstance(payload, dict):
        _fail("$", f"payload must be a dict, got {type(payload).__name__}")
    if payload.get("schema") not in SCHEMA_VERSIONS:
        _fail("$.schema",
              f"expected one of {list(SCHEMA_VERSIONS)}, "
              f"got {payload.get('schema')!r}")
    for key, typ in (("bench", str), ("created_unix", numbers.Real),
                     ("provenance", dict), ("config", dict),
                     ("records", list), ("extras", dict),
                     ("wall_s", numbers.Real)):
        if key not in payload:
            _fail(f"$.{key}", "missing")
        if not isinstance(payload[key], typ):
            _fail(f"$.{key}", f"expected {typ.__name__}, "
                              f"got {type(payload[key]).__name__}")
    prov = payload["provenance"]
    for key, typ in _PROVENANCE_KEYS.items():
        if key not in prov:
            _fail(f"$.provenance.{key}", "missing")
        if not isinstance(prov[key], typ):
            _fail(f"$.provenance.{key}", f"expected {typ.__name__}, "
                                         f"got {type(prov[key]).__name__}")
    v2 = payload["schema"] == SCHEMA_V2
    for i, rec in enumerate(payload["records"]):
        _check_record(f"$.records[{i}]", rec, v2=v2)
    return payload


def save(payload: dict, *, results_dir: str | None = None) -> str:
    """Validate and write ``<results_dir>/<bench>.json`` (atomically, via
    :func:`atomic_write_json`); returns the path."""
    validate(payload)
    out_dir = RESULTS_DIR if results_dir is None else results_dir
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{payload['bench']}.json")
    return atomic_write_json(path, payload)


def load(path: str) -> dict:
    """Read and validate one result payload."""
    with open(path) as f:
        return validate(json.load(f))
