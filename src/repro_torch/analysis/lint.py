"""Repo-specific AST lint (port of ``repro/analysis/lint.py``).

The reference's six rules, copied rule for rule, over ``src/``,
``benchmarks/`` and ``tools/``; on a module that imports no ``torch`` this
linter gives the reference's findings, finding for finding:

``wallclock``
    ``time.time()`` / ``datetime.now()``-style absolute clocks make runs
    irreproducible and results nondeterministic.  Durations must use
    ``time.perf_counter()``; genuine provenance timestamps carry a waiver.
``unseeded-rng``
    Global/legacy RNG draws (``np.random.rand``, stdlib ``random.random``,
    ``default_rng()`` with no seed) break bit-identical replays.  All
    randomness must flow from an explicitly seeded ``Generator``.
``schema-literal``
    Result-schema version strings must come from the
    ``repro.bench.results.SCHEMA_V1/V2`` constants, not duplicated string
    literals (docstrings are exempt; so is the defining module, the
    reference's ``repro/bench/results.py``: the port's copy of it carries
    waivers that both linters read).
``empty-sentinel``
    Inline ``jnp.int32(-1)`` where ``EMPTY`` exists invites the two
    drifting apart.
``atomic-json``
    Bare ``json.dump(...)`` tears result files on crash; writes go through
    ``atomic_write_json`` (whose own body is exempt).
``traced-branch``
    A Python ``if``/``while`` whose test calls ``jnp.*``/``lax.*`` is the
    classic trace-time concretization error (heuristic).

Where a module imports ``torch``, two rules also take their torch forms,
under the same ids:

``empty-sentinel``
    An inline ``-1`` made as an int32 tensor: ``torch.tensor(-1,
    dtype=torch.int32)``, ``torch.full(shape, -1, dtype=torch.int32)`` (and
    ``full_like``, ``new_full``, ``as_tensor``, ``scalar_tensor``).
``traced-branch``
    A Python ``if``/``while`` whose test reads a tensor's value: a
    ``torch.*`` call (``torch.any``, ``torch.all``, ``torch.equal``, ...) or
    an ``.item()`` / ``.any()`` / ``.all()`` method call.  That is a host
    sync, and it breaks a CUDA graph capture.  Calls that return host
    metadata are exempt (``torch.is_tensor``, ``torch.device(...)``,
    ``torch.is_grad_enabled``, ``torch.cuda.is_available``, dtype
    queries), as ``jnp.dtype`` is in the reference.

A finding is waived by a comment on the same line or the line above::

    t = time.time()  # repolint: waive[wallclock] -- journal provenance

Waivers are themselves audited: one that matches nothing is reported as
``unused-waiver``, so the waiver list can only shrink with the code.  The
reference's linter reads the same waivers and knows no torch form, so a
torch-only finding is repaired, never waived: its waiver would be an
``unused-waiver`` to the reference.

>>> from repro_torch.analysis.lint import lint_source
>>> bad = "import time\\ndef f():\\n    return time.time()\\n"
>>> [(f.rule, f.where) for f in lint_source(bad, path="x.py")]
[('wallclock', 'x.py:3')]
>>> ok = ("import time\\ndef f():\\n"
...       "    # repolint: waive[wallclock] -- demo\\n    return time.time()\\n")
>>> lint_source(ok, path="x.py")
[]
>>> stale = "x = 1  # repolint: waive[wallclock] -- nothing here\\n"
>>> [f.rule for f in lint_source(stale, path="x.py")]
['unused-waiver']
>>> sync = "import torch\\nif torch.any(x > 0):\\n    y = 1\\n"
>>> [(f.rule, f.where) for f in lint_source(sync, path="t.py")]
[('traced-branch', 't.py:2')]
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path

from .findings import Finding

__all__ = ["RULES", "lint_source", "lint_file", "lint_tree"]

RULES = {
    "wallclock": "absolute clock call (time.time/datetime.now); use "
                 "perf_counter for durations or waive provenance stamps",
    "unseeded-rng": "legacy/global or unseeded RNG draw; use a seeded "
                    "np.random.Generator or jax.random key",
    "schema-literal": "inline result-schema version string; use "
                      "repro.bench.results.SCHEMA_V1/V2",
    "empty-sentinel": "inline int32(-1); use repro.core.EMPTY",
    "atomic-json": "bare json.dump; use "
                   "repro.bench.results.atomic_write_json",
    "traced-branch": "Python if/while branching on a traced jnp/lax value",
    "unused-waiver": "repolint waiver comment that matches no finding",
}

_WAIVER_RE = re.compile(r"#\s*repolint:\s*waive\[([A-Za-z0-9_,\- ]+)\]")

# absolute-wallclock attribute tails (matched against the end of the chain)
_WALLCLOCK_TAILS = {
    ("time", "time"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}

# draw functions that, reached through a `random` module attribute, imply
# the legacy/global (or stdlib) RNG rather than a seeded Generator
_RNG_DRAWS = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "choices", "shuffle", "permutation", "uniform",
    "normal", "standard_normal", "poisson", "exponential", "gauss",
    "randrange", "betavariate", "vonmisesvariate",
}

# string fragment identifying a result-schema version literal; assembled at
# runtime so this module's own AST never contains the banned needle
_SCHEMA_NEEDLE = "repro.bench.result/" + "v"

# modules where specific rules are definitionally allowed: the reference's
# schema home for both linters, so that a waiver means the same to each
_SCHEMA_HOME = "repro/bench/results.py"
_ATOMIC_WRITERS = {"atomic_write_json"}

# traced-namespace heads for the traced-branch heuristic, minus the
# metadata accessors that return host values (branching on those is fine)
_TRACED_HEADS = {("jnp",), ("lax",), ("jax", "numpy"), ("jax", "lax")}
_HOST_METADATA = {"dtype", "shape", "ndim", "size", "iinfo", "finfo",
                  "result_type", "issubdtype", "promote_types"}

# torch forms: tensor constructors whose fill value is an int32 -1, the
# argument position of that value, and the dtype tails that are int32
_TORCH_FILLS = {"tensor": 0, "as_tensor": 0, "scalar_tensor": 0,
                "full": 1, "full_like": 1, "new_full": 1}
_FILL_KEYWORDS = ("data", "fill_value", "s")
_INT32_TAILS = {("torch", "int32"), ("torch", "int")}
# tensor methods that read a value to the host
_VALUE_METHODS = {"item", "any", "all"}
# torch calls that return host metadata, not a tensor's value
_TORCH_HOST = {"is_tensor", "device", "is_grad_enabled", "is_available",
               "device_count", "is_initialized", "get_rank",
               "get_world_size", "is_floating_point", "is_complex",
               "get_default_dtype", "is_current_stream_capturing",
               "is_inference_mode_enabled"} | _HOST_METADATA


def _attr_chain(node):
    """``np.random.rand`` -> ``("np", "random", "rand")``; None if the
    chain doesn't bottom out in a plain name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _docstring_ids(tree):
    """ids of Constant nodes that are docstrings (exempt from literal
    rules)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                out.add(id(body[0].value))
    return out


def _imports(tree):
    """``(modules, aliases)``: the absolute modules the source imports and
    the names it binds to modules (``import numpy as np`` -> ``np``)."""
    modules, aliases = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(a.name for a in node.names)
            aliases.update(a.asname or a.name.split(".")[0]
                           for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules.add(node.module or "")
    return modules, aliases


def _is_minus_one(node):
    return (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and node.operand.value == 1)


class _Visitor(ast.NodeVisitor):
    def __init__(self, path, tree):
        self.path = path
        self.doc_ids = _docstring_ids(tree)
        modules, self.modules = _imports(tree)
        self.torch = any(m.split(".")[0] == "torch" for m in modules)
        self.func_stack = []
        self.raw = []   # (rule, line, message)

    def _hit(self, rule, node, message):
        self.raw.append((rule, node.lineno, message))

    # -- scope tracking -------------------------------------------------
    def visit_FunctionDef(self, node):
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- call rules -----------------------------------------------------
    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        if chain:
            self._check_wallclock(node, chain)
            self._check_rng(node, chain)
            self._check_sentinel(node, chain)
            self._check_json(node, chain)
        if self.torch:
            self._check_torch_sentinel(node)
        self.generic_visit(node)

    def _check_wallclock(self, node, chain):
        if chain[-2:] in _WALLCLOCK_TAILS:
            self._hit("wallclock", node,
                      f"{'.'.join(chain)}() is an absolute clock; use "
                      "time.perf_counter() or waive with a reason")

    def _check_rng(self, node, chain):
        name = ".".join(chain)
        if chain[0] == "jax":
            return   # jax.random draws require an explicit key: seeded
        if chain[-1] in _RNG_DRAWS and "random" in chain[:-1]:
            self._hit("unseeded-rng", node,
                      f"{name}() draws from a global/legacy RNG; use a "
                      "seeded np.random.Generator")
        elif chain[-1] == "default_rng":
            args = list(node.args) + [kw.value for kw in node.keywords]
            seeded = any(not (isinstance(a, ast.Constant)
                              and a.value is None) for a in args)
            if not seeded:
                self._hit("unseeded-rng", node,
                          f"{name}() without a seed is nondeterministic")

    def _check_sentinel(self, node, chain):
        if (chain[-1] == "int32" and chain[0] in ("jnp", "np", "numpy",
                                                  "jax")
                and len(node.args) == 1 and not node.keywords):
            if _is_minus_one(node.args[0]):
                self._hit("empty-sentinel", node,
                          f"{'.'.join(chain)}(-1): use repro.core.EMPTY")

    def _check_torch_sentinel(self, node):
        """``torch.full(shape, -1, dtype=torch.int32)`` and kin; the
        method forms (``x.new_full``) have any head."""
        if not isinstance(node.func, ast.Attribute):
            return
        name = node.func.attr
        at = _TORCH_FILLS.get(name)
        if at is None:
            return
        if name != "new_full" and _attr_chain(node.func.value) != ("torch",):
            return
        dtype = {kw.arg: kw.value for kw in node.keywords}.get("dtype")
        if dtype is None or _attr_chain(dtype) not in _INT32_TAILS:
            return
        fill = node.args[at] if len(node.args) > at else next(
            (kw.value for kw in node.keywords if kw.arg in _FILL_KEYWORDS),
            None)
        if fill is not None and _is_minus_one(fill):
            self._hit("empty-sentinel", node,
                      f"{name}(..., -1, dtype=torch.int32): use the port's "
                      "EMPTY (repro_torch.core.EMPTY)")

    def _check_json(self, node, chain):
        if chain == ("json", "dump"):
            if not (set(self.func_stack) & _ATOMIC_WRITERS):
                self._hit("atomic-json", node,
                          "json.dump tears files on crash; use "
                          "atomic_write_json")

    # -- literal rule ---------------------------------------------------
    def visit_Constant(self, node):
        if (isinstance(node.value, str) and _SCHEMA_NEEDLE in node.value
                and id(node) not in self.doc_ids
                and not self.path.replace("\\", "/").endswith(
                    _SCHEMA_HOME)):
            self._hit("schema-literal", node,
                      f"schema literal {node.value!r}; import SCHEMA_V1/V2 "
                      "from repro.bench.results")
        self.generic_visit(node)

    # -- traced-branch heuristic ---------------------------------------
    def _torch_read(self, call):
        """The name of a tensor-value read in ``call``, else None."""
        chain = _attr_chain(call.func)
        if chain and chain[0] == "torch" and len(chain) > 1:
            return None if chain[-1] in _TORCH_HOST else ".".join(chain)
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _VALUE_METHODS
                and not (chain and chain[0] in self.modules)):
            return f".{call.func.attr}"     # a method, not np.all(...)
        return None

    def _check_branch(self, node):
        kind = type(node).__name__.lower()
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func)
                if chain and (chain[:1] in _TRACED_HEADS
                              or chain[:2] in _TRACED_HEADS) \
                        and chain[-1] not in _HOST_METADATA:
                    self._hit("traced-branch", node,
                              f"Python {kind} branches on "
                              f"{'.'.join(chain)}(...) — traced values "
                              "need lax.cond/jnp.where")
                    return
                read = self._torch_read(sub) if self.torch else None
                if read:
                    self._hit("traced-branch", node,
                              f"Python {kind} branches on {read}(...) — a "
                              "host sync that breaks a CUDA graph capture; "
                              "use torch.where")
                    return
        # only visit the test's children once via generic_visit below

    def visit_If(self, node):
        self._check_branch(node)
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_branch(node)
        self.generic_visit(node)


def _waiver_map(src):
    """Waiver entries ``[line, rules, used]``; a waiver at line L covers
    findings on L and L+1 (comment-above style).  Only real COMMENT
    tokens count — waiver syntax quoted inside a docstring is inert."""
    waivers = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except tokenize.TokenError:   # pragma: no cover - ast.parse ran first
        comments = []
    for lineno, text in comments:
        m = _WAIVER_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            waivers.append([lineno, rules, False])
    return waivers


def lint_source(src, path="<memory>"):
    """Lint one module's source text; returns surviving ``Finding``s.

    >>> lint_source("x = jnp.int32(-1)\\n", path="m.py")[0].rule
    'empty-sentinel'
    >>> lint_source("import torch\\n"
    ...             "x = torch.full((4,), -1, dtype=torch.int32)\\n",
    ...             path="m.py")[0].rule
    'empty-sentinel'
    """
    tree = ast.parse(src, filename=path)
    visitor = _Visitor(path, tree)
    visitor.visit(tree)
    waivers = _waiver_map(src)

    findings = []
    for rule, line, message in sorted(visitor.raw, key=lambda r: r[1]):
        waived = False
        for w in waivers:
            if w[0] in (line, line - 1) and rule in w[1]:
                w[2] = True
                waived = True
        if not waived:
            findings.append(Finding(rule, f"{path}:{line}", message))
    for wline, rules, used in waivers:
        if not used:
            findings.append(Finding(
                "unused-waiver", f"{path}:{wline}",
                f"waiver for {sorted(rules)} matches no finding; remove "
                "it"))
    return findings


def lint_file(path, root=None):
    """Lint a file on disk; ``where`` paths are relative to ``root``."""
    path = Path(path)
    rel = str(path.relative_to(root)) if root else str(path)
    return lint_source(path.read_text(), path=rel)


def lint_tree(root, subdirs=("src", "benchmarks", "tools")):
    """Lint every ``*.py`` under ``root``'s analysis scope.

    >>> from repro_torch.analysis import lint
    >>> root = Path(lint.__file__).resolve().parents[3]
    >>> isinstance(lint_tree(root), list)
    True
    """
    root = Path(root)
    findings = []
    for sub in subdirs:
        base = root / sub
        if not base.is_dir():
            continue
        for path in sorted(base.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            findings.extend(lint_file(path, root=root))
    return findings
