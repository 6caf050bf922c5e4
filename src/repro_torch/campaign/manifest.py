"""Campaign manifests: a versioned, declarative corpus-scale grid (the
port's copy of the reference's ``campaign/manifest.py``, on the port's
``data/ingest.py``; the same schema string and JSON, so a manifest written
by either package loads in the other).

A manifest (``repro.campaign.manifest/v1``) declares *datasets* — named
globs over libCacheSim-format trace files — plus the policy x capacity x
seed grid to run every matched trace through.  It is plain data (JSON on
disk, TOML accepted where the interpreter ships ``tomllib``), so a
thousand-trace campaign is fully described by one small file::

    {
      "schema": "repro.campaign.manifest/v1",
      "name": "corpus",
      "root": "benchmarks/corpus",
      "datasets": [
        {"name": "oracle", "glob": "*.oracleGeneral.bin.gz"},
        {"name": "kv",     "glob": "*.csv.gz"}
      ],
      "grid": {"policies": ["fifo", "lru", "dac"],
               "K": ["S", "L"], "seeds": [0], "T": null}
    }

``glob`` patterns resolve relative to ``root`` (itself relative to the
manifest file's directory when loaded from disk).  A dataset may instead
pin an explicit ``traces`` list — ``python -m
repro_torch.campaign.make_manifest`` emits that form, freezing each
trace's :func:`repro_torch.data.ingest.characterize` stats into the
manifest so the campaign grid is reproducible even if files are later
added next to it.  ``grid.K`` entries are ints or the paper's ``"S"`` /
``"L"`` regime letters (resolved per trace against its id footprint,
exactly like :class:`repro_torch.bench.Scenario`); ``grid.T`` caps the
requests taken from each trace (``null`` = full trace).

>>> m = Manifest.from_dict({
...     "schema": MANIFEST_SCHEMA, "name": "demo",
...     "root": ".", "datasets": [{"name": "d", "glob": "*.csv"}],
...     "grid": {"policies": ["lru"], "K": ["S"], "seeds": [0]}})
>>> m.name, m.grid.policies, m.grid.K
('demo', ('lru',), ('S',))
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os

from ..data import ingest

try:                                        # py3.11+ stdlib; optional here
    import tomllib as _toml
except ImportError:                         # pragma: no cover - py<=3.10
    _toml = None

__all__ = ["MANIFEST_SCHEMA", "Grid", "Dataset", "Manifest",
           "load_manifest", "scan_corpus"]

MANIFEST_SCHEMA = "repro.campaign.manifest/v1"


def _fail(path: str, msg: str):
    raise ValueError(f"campaign manifest violation at {path}: {msg}")


@dataclasses.dataclass(frozen=True)
class Grid:
    """The evaluation grid applied to every matched trace: ``make_policy``
    spec strings x capacities (ints or ``"S"``/``"L"`` regime letters) x
    seeds, plus an optional per-trace request cap ``T``.

    >>> g = Grid(policies=("lru", "dac"), K=("S", 64), seeds=(0,))
    >>> Grid.from_dict(g.to_dict()) == g
    True
    """

    policies: tuple
    K: tuple = ("S", "L")
    seeds: tuple = (0,)
    T: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "policies",
                           tuple(str(p) for p in self.policies))
        ks = []
        for k in self.K:
            if isinstance(k, str) and not k.isdigit():
                if k not in ("S", "L"):
                    _fail("$.grid.K", f"capacity entries are ints or "
                          f"'S'/'L' regime letters, got {k!r}")
                ks.append(k)
            else:
                ks.append(int(k))
        object.__setattr__(self, "K", tuple(ks))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        if not self.policies:
            _fail("$.grid.policies", "needs at least one policy")
        if not self.K:
            _fail("$.grid.K", "needs at least one capacity")
        if not self.seeds:
            _fail("$.grid.seeds", "needs at least one seed")
        if self.T is not None:
            if int(self.T) <= 0:
                _fail("$.grid.T", f"must be a positive cap or null, "
                      f"got {self.T}")
            object.__setattr__(self, "T", int(self.T))

    def to_dict(self) -> dict:
        return {"policies": list(self.policies), "K": list(self.K),
                "seeds": list(self.seeds), "T": self.T}

    @classmethod
    def from_dict(cls, cfg: dict) -> "Grid":
        if not isinstance(cfg, dict):
            _fail("$.grid", f"must be a dict, got {type(cfg).__name__}")
        if "policies" not in cfg:
            _fail("$.grid.policies", "missing")
        return cls(policies=tuple(cfg["policies"]),
                   K=tuple(cfg.get("K", ("S", "L"))),
                   seeds=tuple(cfg.get("seeds", (0,))),
                   T=cfg.get("T"))


@dataclasses.dataclass(frozen=True)
class Dataset:
    """One named trace group: a glob over ``root``, or a pinned explicit
    ``traces`` list (``(path, format)`` pairs plus optional frozen stats).

    >>> d = Dataset(name="kv", glob="*.csv.gz")
    >>> Dataset.from_dict(d.to_dict()) == d
    True
    """

    name: str
    glob: str | None = None
    format: str = "auto"
    traces: tuple = ()          # of (relpath, format) pairs, when pinned
    stats: dict | None = None   # relpath -> frozen characterization dict

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            _fail("$.datasets[].name", f"must be a non-empty string, "
                  f"got {self.name!r}")
        if self.glob is None and not self.traces:
            _fail(f"$.datasets[{self.name}]",
                  "needs a 'glob' pattern or a pinned 'traces' list")
        object.__setattr__(self, "traces",
                           tuple((str(p), str(f)) for p, f in self.traces))

    def resolve(self, root: str) -> list:
        """The dataset's ``(path, format)`` pairs: the pinned list when
        present (paths joined onto ``root``), else a sorted glob."""
        if self.traces:
            return [(os.path.join(root, p), f) for p, f in self.traces]
        return [(p, self.format)
                for p in sorted(_glob.glob(os.path.join(root, self.glob)))]

    def to_dict(self) -> dict:
        out = {"name": self.name, "format": self.format}
        if self.glob is not None:
            out["glob"] = self.glob
        if self.traces:
            out["traces"] = [list(t) for t in self.traces]
        if self.stats is not None:
            out["stats"] = self.stats
        return out

    @classmethod
    def from_dict(cls, cfg: dict) -> "Dataset":
        if not isinstance(cfg, dict) or "name" not in cfg:
            _fail("$.datasets[]", f"each dataset is a dict with a 'name', "
                  f"got {cfg!r}")
        return cls(name=cfg["name"], glob=cfg.get("glob"),
                   format=cfg.get("format", "auto"),
                   traces=tuple(tuple(t) for t in cfg.get("traces", ())),
                   stats=cfg.get("stats"))


@dataclasses.dataclass(frozen=True)
class Manifest:
    """A full campaign declaration: datasets x grid, versioned and
    JSON-round-trippable (the store keeps a copy so a campaign directory
    is self-describing).

    >>> m = Manifest(name="demo", root=".", grid=Grid(policies=("lru",)),
    ...              datasets=(Dataset(name="d", glob="*.csv"),))
    >>> Manifest.from_dict(m.to_dict()) == m
    True
    """

    name: str
    root: str
    datasets: tuple
    grid: Grid

    def __post_init__(self):
        object.__setattr__(self, "datasets", tuple(self.datasets))
        if not self.name or not isinstance(self.name, str):
            _fail("$.name", f"must be a non-empty string, got {self.name!r}")
        if not self.datasets:
            _fail("$.datasets", "needs at least one dataset")
        names = [d.name for d in self.datasets]
        if len(set(names)) != len(names):
            _fail("$.datasets", f"dataset names must be unique, got {names}")

    def traces(self) -> list:
        """Every ``(dataset_name, path, format)`` triple the manifest
        matches, in deterministic (dataset-declaration, sorted-path)
        order.  A dataset whose glob matches nothing is an error — a
        typo'd pattern must not silently shrink the campaign."""
        out = []
        for ds in self.datasets:
            matched = ds.resolve(self.root)
            if not matched:
                _fail(f"$.datasets[{ds.name}]",
                      f"matched no trace files under {self.root!r} "
                      f"(glob {ds.glob!r})")
            out.extend((ds.name, path, fmt) for path, fmt in matched)
        return out

    def to_dict(self) -> dict:
        return {"schema": MANIFEST_SCHEMA, "name": self.name,
                "root": self.root,
                "datasets": [d.to_dict() for d in self.datasets],
                "grid": self.grid.to_dict()}

    @classmethod
    def from_dict(cls, cfg: dict) -> "Manifest":
        if not isinstance(cfg, dict):
            _fail("$", f"manifest must be a dict, got {type(cfg).__name__}")
        if cfg.get("schema") != MANIFEST_SCHEMA:
            _fail("$.schema", f"expected {MANIFEST_SCHEMA!r}, "
                  f"got {cfg.get('schema')!r}")
        for key in ("name", "datasets", "grid"):
            if key not in cfg:
                _fail(f"$.{key}", "missing")
        if not isinstance(cfg["datasets"], list):
            _fail("$.datasets", "must be a list")
        return cls(name=cfg["name"], root=cfg.get("root", "."),
                   datasets=tuple(Dataset.from_dict(d)
                                  for d in cfg["datasets"]),
                   grid=Grid.from_dict(cfg["grid"]))

    def save(self, path: str) -> str:
        """Write the manifest as JSON (atomically — a crashed scan must
        not leave a torn manifest behind); returns ``path``."""
        from ..bench.results import atomic_write_json
        atomic_write_json(path, self.to_dict(), sort_keys=True)
        return path


def load_manifest(path: str) -> Manifest:
    """Load + validate a manifest file (``.json``, or ``.toml`` on
    interpreters that ship ``tomllib``).  A relative ``root`` is
    re-anchored at the manifest file's directory, so a campaign directory
    can be launched from anywhere."""
    if str(path).endswith(".toml"):
        if _toml is None:
            raise RuntimeError(
                f"{path}: TOML manifests need the stdlib 'tomllib' "
                "(python >= 3.11); re-emit the manifest as JSON")
        with open(path, "rb") as f:
            cfg = _toml.load(f)
    else:
        with open(path) as f:
            cfg = json.load(f)
    m = Manifest.from_dict(cfg)
    if not os.path.isabs(m.root):
        root = os.path.join(os.path.dirname(os.path.abspath(path)), m.root)
        m = dataclasses.replace(m, root=os.path.normpath(root))
    return m


def _dataset_name_for(root: str, path: str) -> str:
    """Grouping rule for scanned corpora: traces under a subdirectory form
    that subdirectory's dataset; files directly in ``root`` group by
    trace format (oracle / csv / txt)."""
    rel = os.path.relpath(path, root)
    head = rel.split(os.sep, 1)[0]
    if head != os.path.basename(rel):
        return head
    return ingest.detect_format(path)


def scan_corpus(root: str, *, name: str | None = None, grid: Grid,
                dataset: str | None = None,
                characterize: bool = True) -> Manifest:
    """Build a pinned manifest by scanning ``root`` for trace files (any
    suffix :func:`repro_torch.data.ingest.detect_format` understands, one
    directory level deep).  Traces group into datasets by subdirectory —
    format name for flat files — unless ``dataset`` forces a single
    group; ``characterize=True`` freezes each trace's stats into the
    manifest (what ``python -m repro_torch.campaign.make_manifest``
    emits).  A plain ``.oracleGeneral.bin`` with a byte-identical ``.gz``
    twin is skipped, as the reference's ``benchmarks/real_traces.py``
    does."""
    paths = []
    for dirpath, _, files in sorted(os.walk(root)):
        if os.path.relpath(dirpath, root).count(os.sep) > 0:
            continue
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            try:
                ingest.detect_format(p)
            except ValueError:
                continue
            if fn.endswith(".oracleGeneral.bin") and \
                    os.path.exists(p + ".gz"):
                continue
            paths.append(p)
    if not paths:
        raise FileNotFoundError(f"no trace files under {root!r}")
    groups: dict = {}
    for p in paths:
        ds = dataset or _dataset_name_for(root, p)
        groups.setdefault(ds, []).append(p)
    datasets = []
    for ds in sorted(groups):
        rels = [os.path.relpath(p, root) for p in groups[ds]]
        stats = None
        if characterize:
            stats = {rel: dataclasses.asdict(ingest.characterize(p))
                     for rel, p in zip(rels, groups[ds])}
        datasets.append(Dataset(
            name=ds, traces=tuple((rel, "auto") for rel in rels),
            stats=stats))
    return Manifest(name=name or os.path.basename(os.path.normpath(root)),
                    root=root, datasets=tuple(datasets), grid=grid)
