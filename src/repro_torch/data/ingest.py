"""Real-trace ingestion: file readers, dense key remapping, streaming (the
port's copy of the reference's ``data/ingest.py``; numpy, gzip and csv
only, held equal to the original by ``tests/test_torch_isolation.py``).

The paper's headline evaluation runs over 1067 *real* traces; this module
is the bridge between trace files on disk and the replay engine.  Three
formats are supported, all gzip-transparent (``.gz`` suffix or magic
bytes):

* ``oracle`` — libCacheSim's ``oracleGeneral`` binary: packed
  little-endian 24-byte records
  ``(u32 clock_time, u64 obj_id, u32 obj_size, i64 next_access_vtime)``.
* ``csv`` — textual ``key[,size[,cost]]`` rows.  A first row naming a
  ``key`` column is treated as a header (columns may be reordered;
  ``size``/``cost`` optional; extras ignored); any other first row is
  data, except an all-textual multi-column row — a foreign header —
  which is refused rather than ingested as a request.
* ``txt`` — one key per line.

Raw keys — 64-bit ids for ``oracle``, textual tokens for ``csv``/``txt``
(compared as strings: ``"007"`` and ``"7"`` are distinct objects) — are
densely remapped to ``int32`` ids in **first-appearance order**:
deterministic, order-stable, and identical whether a trace is loaded at
once (:func:`load_trace`) or iterated in chunks of any size
(:func:`iter_chunks`), so streamed and materialized replays see
bit-identical request streams.  Uncompressed ``oracle`` files
are memory-mapped and sliced per chunk — a multi-gigabyte trace never
loads into host memory on the streaming path.

:func:`characterize` computes per-trace stats (request/object counts,
byte footprint, a Zipf skew estimate) in one streaming pass; the trace
registry's ``file(path=...)`` family (:mod:`repro_torch.data.traces`) resolves
its id footprint through it.  Writers for every format round-trip what
the format carries and power ``tools/make_corpus.py`` plus the ingest
test suite.

>>> import os, tempfile
>>> p = os.path.join(tempfile.mkdtemp(), "t.keys.txt")
>>> write_keys(p, [7, 7, 3, 7])
>>> load_trace(p).keys.tolist()          # dense first-appearance ids
[0, 0, 1, 0]
"""
from __future__ import annotations

import csv
import dataclasses
import functools
import gzip
import io
import os
from typing import Iterator, NamedTuple

import numpy as np

__all__ = [
    "FORMATS", "ORACLE_DTYPE", "DEFAULT_CHUNK",
    "DenseRemap", "TraceChunk", "Trace", "TraceStats",
    "detect_format", "iter_chunks", "load_trace", "characterize",
    "count_requests", "write_oracle_general", "write_csv", "write_keys",
]

FORMATS = ("oracle", "csv", "txt")

# libCacheSim oracleGeneral record: packed little-endian, 24 bytes
ORACLE_DTYPE = np.dtype([("time", "<u4"), ("obj", "<u8"),
                         ("size", "<u4"), ("next", "<i8")])
assert ORACLE_DTYPE.itemsize == 24

DEFAULT_CHUNK = 1 << 18

_SUFFIX_TO_FORMAT = {
    ".bin": "oracle", ".oracle": "oracle", ".oraclegeneral": "oracle",
    ".csv": "csv", ".txt": "txt", ".keys": "txt",
}


def detect_format(path) -> str:
    """Infer the trace format from the file suffix (a trailing ``.gz`` is
    stripped first): ``.bin``/``.oracleGeneral`` -> ``oracle``, ``.csv``
    -> ``csv``, ``.txt``/``.keys`` -> ``txt``.

    >>> detect_format("a/mix.oracleGeneral.bin.gz")
    'oracle'
    >>> detect_format("kv.csv")
    'csv'
    """
    name = os.path.basename(str(path)).lower()
    if name.endswith(".gz"):
        name = name[:-3]
    _, suffix = os.path.splitext(name)
    fmt = _SUFFIX_TO_FORMAT.get(suffix)
    if fmt is None:
        raise ValueError(
            f"cannot infer trace format from {path!r} (suffix {suffix!r}); "
            f"pass format= explicitly, one of {list(FORMATS)}")
    return fmt


def _resolve_format(path, format: str) -> str:
    if format == "auto":
        return detect_format(path)
    if format not in FORMATS:
        raise ValueError(
            f"unknown trace format {format!r}; known: {list(FORMATS)} "
            "(or 'auto')")
    return format


def _is_gzip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _open_binary(path):
    """Binary stream over ``path``, transparently gunzipping."""
    if _is_gzip(path):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _open_text(path):
    return io.TextIOWrapper(_open_binary(path), encoding="utf-8",
                            newline="")


# ---------------------------------------------------------------------------
# dense key remapping
# ---------------------------------------------------------------------------

class DenseRemap:
    """Raw keys -> dense ``int32`` ids in first-appearance order.

    Deterministic and order-stable: the i-th *distinct* raw key ever seen
    gets id ``i``, so the mapping depends only on the key sequence — the
    same trace remaps identically whether it is consumed whole or in
    chunks of any size.

    >>> remap = DenseRemap()
    >>> remap(np.array([9, 4, 9, 7])).tolist()
    [0, 1, 0, 2]
    >>> remap(np.array([7, 1])).tolist()      # state persists across calls
    [2, 3]
    >>> remap.n_objects
    4
    """

    def __init__(self):
        self._ids: dict = {}

    @property
    def n_objects(self) -> int:
        """Number of distinct raw keys assigned so far."""
        return len(self._ids)

    def __call__(self, raw) -> np.ndarray:
        raw = np.asarray(raw)
        ids = self._ids
        if raw.dtype.kind in "iuU":
            # vectorized: one dict op per *distinct* key in the chunk,
            # visited in first-appearance order (argsort of first index)
            uniq, first, inv = np.unique(raw, return_index=True,
                                         return_inverse=True)
            lut = np.empty(len(uniq), dtype=np.int64)
            for j in np.argsort(first, kind="stable"):
                lut[j] = ids.setdefault(uniq[j].item(), len(ids))
            out = lut[inv]
        else:
            out = np.empty(raw.shape, dtype=np.int64)
            for i, k in enumerate(raw.tolist()):
                out[i] = ids.setdefault(k, len(ids))
        if ids and len(ids) > np.iinfo(np.int32).max:
            raise ValueError("trace exceeds int32 distinct-key budget")
        return out.astype(np.int32)


# ---------------------------------------------------------------------------
# raw per-format readers (chunked; keys NOT yet remapped)
# ---------------------------------------------------------------------------

def _iter_oracle_raw(path, chunk):
    if _is_gzip(path):
        want = chunk * ORACLE_DTYPE.itemsize
        with _open_binary(path) as f:
            while True:
                buf = f.read(want)
                if not buf:
                    return
                # gzip streams may return short reads mid-file
                while len(buf) % ORACLE_DTYPE.itemsize or len(buf) < want:
                    more = f.read(want - len(buf))
                    if not more:
                        break
                    buf += more
                if len(buf) % ORACLE_DTYPE.itemsize:
                    raise ValueError(
                        f"{path}: truncated oracleGeneral stream "
                        f"({len(buf) % ORACLE_DTYPE.itemsize} trailing bytes)")
                rec = np.frombuffer(buf, dtype=ORACLE_DTYPE)
                yield rec["obj"], rec["size"].astype(np.int64), None
        return
    n_bytes = os.path.getsize(path)
    n_rec, trailing = divmod(n_bytes, ORACLE_DTYPE.itemsize)
    if trailing:
        raise ValueError(
            f"{path}: size {n_bytes} is not a multiple of the 24-byte "
            "oracleGeneral record (truncated or wrong format?)")
    if n_rec == 0:
        return
    # memory-mapped: a chunk slice is the only thing that touches RAM
    mm = np.memmap(path, dtype=ORACLE_DTYPE, mode="r", shape=(n_rec,))
    for lo in range(0, n_rec, chunk):
        rec = mm[lo:lo + chunk]
        yield np.asarray(rec["obj"]), rec["size"].astype(np.int64), None


def _iter_csv_raw(path, chunk):
    with _open_text(path) as f:
        reader = csv.reader(f)
        first = next(reader, None)
        if first is None:
            return
        cols = {"key": 0, "size": 1, "cost": 2}
        rows = []

        def numeric(tok):
            try:
                float(tok)
                return True
            except ValueError:
                return False

        names = [tok.strip().lower() for tok in first]
        if "key" in names:
            # header row: named columns, any order, extras ignored
            cols = {name: i for i, name in enumerate(names)
                    if name in ("key", "size", "cost")}
        elif all(not numeric(tok) for tok in first):
            # every column textual but none named 'key': a header from
            # another tool, or an undecidably ambiguous first row —
            # refuse rather than ingest column names as requests (multi-
            # column string *keys* are fine: their size column is
            # numeric, so such data rows don't trip this; single-column
            # string keys belong in the txt format or under a 'key'
            # header)
            raise ValueError(
                f"{path}: first CSV row {names} looks like a header but "
                "has no 'key' column; name one (size/cost optional), use "
                "headerless key[,size[,cost]] rows, or the txt format "
                "for bare string keys")
        else:
            cols = {name: i for name, i in cols.items() if i < len(first)}
            rows.append(first)

        def flush(rows):
            keys = np.asarray([r[cols["key"]].strip() for r in rows])
            sizes = costs = None
            if "size" in cols:
                # int(float(...)): tolerate float-formatted byte counts
                # ("1024.0") from pandas-style exporters
                sizes = np.asarray(
                    [int(float(r[cols["size"]])) for r in rows],
                    dtype=np.int64)
            if "cost" in cols:
                costs = np.asarray([float(r[cols["cost"]]) for r in rows],
                                   dtype=np.float32)
            return keys, sizes, costs

        for row in reader:
            if not row:
                continue
            rows.append(row)
            if len(rows) >= chunk:
                yield flush(rows)
                rows = []
        if rows:
            yield flush(rows)


def _iter_txt_raw(path, chunk):
    with _open_text(path) as f:
        toks = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            toks.append(line)
            if len(toks) >= chunk:
                yield np.asarray(toks), None, None
                toks = []
        if toks:
            yield np.asarray(toks), None, None


_RAW_READERS = {"oracle": _iter_oracle_raw, "csv": _iter_csv_raw,
                "txt": _iter_txt_raw}


# ---------------------------------------------------------------------------
# public loading surface
# ---------------------------------------------------------------------------

class TraceChunk(NamedTuple):
    """One streamed slice of a trace: dense int32 ``keys`` plus the
    per-request ``sizes`` (int64 bytes) / ``costs`` (float32) the file
    carries — ``None`` where the format has no such column (the engine's
    unit default applies)."""

    keys: np.ndarray
    sizes: np.ndarray | None
    costs: np.ndarray | None


class Trace(NamedTuple):
    """A fully-loaded trace (see :func:`load_trace`): the same fields as
    :class:`TraceChunk` for the whole request sequence, plus the dense id
    footprint ``n_objects`` (keys lie in ``[0, n_objects)``)."""

    keys: np.ndarray
    sizes: np.ndarray | None
    costs: np.ndarray | None
    n_objects: int


def iter_chunks(path, format: str = "auto", *, chunk: int = DEFAULT_CHUNK,
                limit: int = 0) -> Iterator[TraceChunk]:
    """Stream a trace file as :class:`TraceChunk` slices of ``chunk``
    requests (the last one shorter), keys densely remapped on the fly —
    bit-identical to :func:`load_trace` of the same file.  ``limit > 0``
    stops after that many requests.  Uncompressed ``oracle`` files are
    memory-mapped; nothing larger than one chunk is ever resident.

    >>> import os, tempfile
    >>> p = os.path.join(tempfile.mkdtemp(), "t.keys.txt")
    >>> write_keys(p, [5, 2, 5, 9])
    >>> [c.keys.tolist() for c in iter_chunks(p, chunk=3)]
    [[0, 1, 0], [2]]
    """
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    fmt = _resolve_format(path, format)
    remap = DenseRemap()
    seen = 0
    for raw, sizes, costs in _RAW_READERS[fmt](path, chunk):
        if limit > 0 and seen + len(raw) > limit:
            take = limit - seen
            raw = raw[:take]
            sizes = None if sizes is None else sizes[:take]
            costs = None if costs is None else costs[:take]
        if len(raw) == 0:
            break
        yield TraceChunk(keys=remap(raw), sizes=sizes, costs=costs)
        seen += len(raw)
        if limit > 0 and seen >= limit:
            return


def _cache_key(path):
    """Cache identity of a trace file: realpath + mtime_ns + size.  Size
    is part of the key so a same-second rewrite (mtime unchanged at
    coarse resolution) still invalidates — ``tools/make_manifest.py``
    freezes these stats into manifests and must never see stale ones.
    The resolved format is a separate ``lru_cache`` argument."""
    st = os.stat(path)
    return os.path.realpath(path), st.st_mtime_ns, st.st_size


@functools.lru_cache(maxsize=64)
def _count_requests(cache_key, format: str) -> int:
    path = cache_key[0]
    if format == "oracle" and not _is_gzip(path):
        n_rec, trailing = divmod(os.path.getsize(path),
                                 ORACLE_DTYPE.itemsize)
        if trailing:
            raise ValueError(
                f"{path}: size is not a multiple of the 24-byte "
                "oracleGeneral record (truncated or wrong format?)")
        return int(n_rec)
    return sum(len(raw)
               for raw, _, _ in _RAW_READERS[format](path, DEFAULT_CHUNK))


def count_requests(path, format: str = "auto") -> int:
    """Number of requests in a trace file — O(1) for uncompressed
    ``oracle`` files (size / 24, no decode), a parse-only pass (no remap,
    no popularity stats) otherwise; cached by path + mtime + size +
    format (see :func:`_cache_key`).  This is the
    cheap length check ``repro_torch.bench.Scenario`` validates ``T`` against.

    >>> import os, tempfile
    >>> p = os.path.join(tempfile.mkdtemp(), "t.oracleGeneral.bin")
    >>> write_oracle_general(p, [1, 2, 1])
    >>> count_requests(p)
    3
    """
    return _count_requests(_cache_key(path), _resolve_format(path, format))


@functools.lru_cache(maxsize=4)
def _load_full(cache_key, format: str, limit: int = 0) -> Trace:
    path = cache_key[0]
    keys, sizes, costs = [], [], []
    for ch in iter_chunks(path, format, limit=limit):
        keys.append(ch.keys)
        sizes.append(ch.sizes)
        costs.append(ch.costs)

    def seal(arr):
        # cached arrays are shared across callers: hand out read-only
        # views so an in-place edit fails loudly instead of corrupting
        # every later replay of the same file
        if arr is not None:
            arr.setflags(write=False)
        return arr

    if not keys:
        return Trace(seal(np.empty(0, np.int32)), None, None, 0)
    cat = lambda parts: (None if parts[0] is None
                         else np.concatenate(parts))
    all_keys = np.concatenate(keys)
    n_objects = int(all_keys.max()) + 1 if len(all_keys) else 0
    return Trace(keys=seal(all_keys), sizes=seal(cat(sizes)),
                 costs=seal(cat(costs)), n_objects=n_objects)


def load_trace(path, format: str = "auto", *, limit: int = 0) -> Trace:
    """Load a trace into memory as a :class:`Trace` (the materialized
    counterpart of :func:`iter_chunks`; loads are cached by
    path + mtime + size + format + limit, see :func:`_cache_key`).
    ``limit > 0`` reads only the first ``limit``
    requests — a bounded prefix scan, never a full-file pass, and the
    dense remap of a truncated load matches the full load's prefix.

    >>> import os, tempfile
    >>> p = os.path.join(tempfile.mkdtemp(), "t.csv")
    >>> write_csv(p, [8, 8, 2], sizes=[10, 10, 30])
    >>> tr = load_trace(p)
    >>> tr.keys.tolist(), tr.sizes.tolist(), tr.n_objects
    ([0, 0, 1], [10, 10, 30], 2)
    """
    fmt = _resolve_format(path, format)
    return _load_full(_cache_key(path), fmt, max(0, limit))


# ---------------------------------------------------------------------------
# characterization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceStats:
    """One streaming pass worth of per-trace characterization.

    ``footprint_bytes`` sums each object's first-seen size (the working
    set's storage demand); ``total_bytes`` sums request sizes (traffic
    volume); formats without sizes count unit objects for both, matching
    the engine's unit-size default.  ``skew`` is a least-squares Zipf
    exponent estimate over the log rank-frequency curve (0 means
    uniform)."""

    path: str
    format: str
    n_requests: int
    n_objects: int
    total_bytes: int
    footprint_bytes: int
    skew: float

    @property
    def unique_frac(self) -> float:
        """Distinct keys per request — 1.0 is a pure scan."""
        return self.n_objects / self.n_requests if self.n_requests else 0.0


def _fit_skew(counts: np.ndarray) -> float:
    counts = np.sort(counts[counts > 0])[::-1].astype(np.float64)
    if len(counts) < 2 or counts[0] == counts[-1]:
        return 0.0
    ranks = np.arange(1, len(counts) + 1, dtype=np.float64)
    slope = np.polyfit(np.log(ranks), np.log(counts), 1)[0]
    return float(max(0.0, -slope))


@functools.lru_cache(maxsize=16)
def _characterize(cache_key, format: str) -> TraceStats:
    path = cache_key[0]
    counts = np.zeros(0, dtype=np.int64)
    first_size = np.zeros(0, dtype=np.int64)
    seen = np.zeros(0, dtype=bool)
    n_requests = 0
    total_bytes = 0
    for ch in iter_chunks(path, format):
        hi = int(ch.keys.max()) + 1
        if hi > len(counts):
            grow = max(hi, 2 * len(counts))
            pad = lambda a, fill: np.concatenate(
                [a, np.full(grow - len(a), fill, a.dtype)])
            counts = pad(counts, 0)
            first_size = pad(first_size, 0)
            seen = pad(seen, False)
        np.add.at(counts, ch.keys, 1)
        sizes = (np.ones(len(ch.keys), np.int64) if ch.sizes is None
                 else ch.sizes)
        total_bytes += int(sizes.sum())
        # first-seen size per object: np.unique's return_index is the
        # first in-chunk occurrence of each distinct id
        uniq, first = np.unique(ch.keys, return_index=True)
        new = ~seen[uniq]
        first_size[uniq[new]] = sizes[first[new]]
        seen[uniq[new]] = True
        n_requests += len(ch.keys)
    n_objects = int(seen.sum())
    return TraceStats(
        path=str(path), format=format, n_requests=n_requests,
        n_objects=n_objects, total_bytes=total_bytes,
        footprint_bytes=int(first_size.sum()), skew=_fit_skew(counts))


def characterize(path, format: str = "auto") -> TraceStats:
    """Compute (and cache, by path + mtime + size + format — see
    :func:`_cache_key`) a trace's :class:`TraceStats` in one streaming
    pass.

    >>> import os, tempfile
    >>> p = os.path.join(tempfile.mkdtemp(), "t.csv")
    >>> write_csv(p, [1, 1, 1, 2], sizes=[100, 100, 100, 50])
    >>> st = characterize(p)
    >>> st.n_requests, st.n_objects, st.total_bytes, st.footprint_bytes
    (4, 2, 350, 150)
    """
    return _characterize(_cache_key(path), _resolve_format(path, format))


# ---------------------------------------------------------------------------
# writers (corpus generation + round-trip tests)
# ---------------------------------------------------------------------------

def _open_write(path):
    """Binary sink; ``.gz`` paths gzip with ``mtime=0`` so regenerated
    corpora are byte-identical (CI diffs them against the committed
    files)."""
    if str(path).endswith(".gz"):
        return gzip.GzipFile(path, "wb", mtime=0)
    return open(path, "wb")


def _next_access(keys: np.ndarray) -> np.ndarray:
    """oracleGeneral's ``next_access_vtime``: for each position, the index
    of the key's next occurrence, or -1 (libCacheSim's 'never again')."""
    nxt = np.full(len(keys), -1, dtype=np.int64)
    last: dict = {}
    for i in range(len(keys) - 1, -1, -1):
        k = keys[i].item()
        nxt[i] = last.get(k, -1)
        last[k] = i
    return nxt


def write_oracle_general(path, keys, sizes=None, *, times=None) -> None:
    """Write an ``oracleGeneral`` binary trace (gzip if ``path`` ends in
    ``.gz``); ``next_access_vtime`` is computed from the key sequence.

    >>> import os, tempfile
    >>> p = os.path.join(tempfile.mkdtemp(), "t.oracleGeneral.bin")
    >>> write_oracle_general(p, [11, 5, 11], sizes=[64, 32, 64])
    >>> tr = load_trace(p)
    >>> tr.keys.tolist(), tr.sizes.tolist()
    ([0, 1, 0], [64, 32, 64])
    """
    keys = np.asarray(keys)
    rec = np.empty(len(keys), dtype=ORACLE_DTYPE)
    rec["time"] = (np.arange(len(keys), dtype=np.uint32) if times is None
                   else np.asarray(times, dtype=np.uint32))
    rec["obj"] = keys.astype(np.uint64)
    rec["size"] = (np.ones(len(keys), np.uint32) if sizes is None
                   else np.asarray(sizes, dtype=np.uint32))
    rec["next"] = _next_access(keys)
    with _open_write(path) as f:
        f.write(rec.tobytes())


def write_csv(path, keys, sizes=None, costs=None, *, header=True) -> None:
    """Write a ``key[,size[,cost]]`` CSV trace (gzip-aware); ``header``
    emits the column-name row the reader understands.

    >>> import os, tempfile
    >>> p = os.path.join(tempfile.mkdtemp(), "t.csv.gz")
    >>> write_csv(p, [3, 9], sizes=[2, 4], costs=[0.5, 1.25])
    >>> load_trace(p).costs.tolist()
    [0.5, 1.25]
    """
    if costs is not None and sizes is None:
        raise ValueError("csv column order is key,size,cost — costs "
                         "require sizes")
    cols = ["key"] + (["size"] if sizes is not None else []) \
        + (["cost"] if costs is not None else [])
    keys = np.asarray(keys)
    lines = []
    if header:
        lines.append(",".join(cols))
    for i in range(len(keys)):
        row = [str(keys[i].item() if keys.dtype.kind in "iu" else keys[i])]
        if sizes is not None:
            row.append(str(int(sizes[i])))
        if costs is not None:
            row.append(repr(float(costs[i])))
        lines.append(",".join(row))
    with _open_write(path) as f:
        f.write(("\n".join(lines) + "\n").encode("utf-8"))


def write_keys(path, keys) -> None:
    """Write a key-per-line text trace (gzip-aware).

    >>> import os, tempfile
    >>> p = os.path.join(tempfile.mkdtemp(), "t.keys.txt.gz")
    >>> write_keys(p, [4, 4, 1])
    >>> load_trace(p).keys.tolist()
    [0, 0, 1]
    """
    keys = np.asarray(keys)
    text = "\n".join(str(k.item() if keys.dtype.kind in "iu" else k)
                     for k in keys) + "\n"
    with _open_write(path) as f:
        f.write(text.encode("utf-8"))
