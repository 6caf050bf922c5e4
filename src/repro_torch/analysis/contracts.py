"""Step-contract analyzer (port of ``repro/analysis/contracts.py``).

Every registry policy, and the tier and fleet steps built on DAC's
budgeted plan, must satisfy structural contracts that no amount of
replaying example traces can prove.  The reference traces each ``step``
to its jaxpr; torch has no jaxpr, so this module runs **one real step on a
fresh state** and records every aten op the step dispatches
(``TorchDispatchMode``), then verifies:

``carry-structure`` / ``carry-aval``
    The carry law of the graph loop (``core/simulator.py``, whose captured
    steps write back into static buffers): the state tree that goes into
    ``step`` comes out with the same paths, and every leaf with the same
    shape, dtype and device.  Torch has no weak types.
``row-dtype`` / ``row-width`` / ``row-init``
    Rank rows (every ``"cache"`` leaf) are ``int32`` with a lane-padded
    trailing width (``W % LANE == 0``) and start all-``EMPTY``.
``f64-leak``
    No ``float64``/``complex128`` tensor in the state or among the step's
    op outputs (a 0-dim ``scalar_tensor``, the wrapped Python number a
    ``torch.where`` lifts, is a weak type and exempt).  Torch's index ops
    give ``int64``, so the reference's "no 8-byte aval in 32-bit mode"
    becomes: ``int64`` appears only
      * in the state leaves :data:`INT64_LEAVES` documents (LRU's and
        BLRU's ``last`` and ``t``), and
      * in index computations: the outputs of :data:`INDEX_OPS`, values
        derived from those (or from the documented leaves) alone, every
        ``int64`` value that feeds an ``index``/``indices`` operand
        (``gather``, ``scatter``, ...: the sketch hash, ``.long()`` casts),
        and an uninitialised ``int64`` buffer that no recorded op reads,
        which a kernel launched outside the dispatcher fills and the step
        drops (B1's ``counts`` and ``work``; the engine's counts are
        ``int64`` too, outside any step).
    Any other ``int64`` state leaf or op output is a finding.
``adapt-keys``
    Names a policy declares in ``ADAPT_KEYS`` exist in its (base) state
    as ``int32`` leaves (the admission/tier revert-exemption contract).
``forbidden-primitive``
    No op in the step reads device memory on the host or has a
    data-dependent output shape (:data:`FORBIDDEN_PRIMITIVES`), and no op
    copies across devices.  On a CUDA state the step is also captured into
    a CUDA graph under ``torch.cuda.set_sync_debug_mode("error")`` (the
    recorded eager step before it is the warm-up that loads every kernel,
    B1's library included, as ``simulator.py``'s graph loop warms up) and
    the graph's replay is held equal to the eager step bit for bit.  A
    capture that fails is a finding.  The dispatcher does not see B1's
    ``ctypes`` launch: on CUDA the graph-vs-eager comparison holds B1's
    own work.
``trace-error``
    The step raises.

The reference's two Pallas modes become two devices: a CPU state runs each
kernel's plain version, a CUDA state launches B1 for the rank policies,
DAC's budgeted step and the rank bases under admission, the tier and the
fleet.  ``verify_contracts`` runs the whole registry (15 policies + their
``admit(...)`` wrappers) on each device, the budgeted DAC paths, the tier
and the fleet, and a sub-pass of every spec with
``torch.set_default_dtype(torch.float64)`` (the counterpart of the
reference's x64 sub-pass).

>>> from repro_torch.analysis import contracts
>>> contracts.check_policy("fifo", device="cpu")
[]
>>> len(contracts.registry_specs())
30
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import POLICIES, make_policy
from ..core.policy import EMPTY, LANE, Request, lane_scalar
from .findings import Finding

__all__ = ["FORBIDDEN_PRIMITIVES", "INDEX_OPS", "INT64_LEAVES",
           "registry_specs", "check_policy", "check_tier", "check_fleet",
           "verify_contracts"]

# ops that read device memory on the host (``.item()``, ``bool(t)``) or
# whose output shape depends on the data: a host sync inside the step,
# which stalls the device and breaks a CUDA graph capture
FORBIDDEN_PRIMITIVES = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
    "bincount",
})

# ops whose int64 outputs are indices (torch gives them no other type)
INDEX_OPS = frozenset({
    "argmax", "argmin", "max", "min", "sort", "argsort", "topk", "kthvalue",
    "median", "mode", "cummax", "cummin", "bucketize", "searchsorted",
    "arange",
})

# state leaves the port keeps in int64, by policy name: LRU's and BLRU's
# timestamps (ROADMAP C, "Int64 counts")
INT64_LEAVES = {"lru": ("last", "t"), "blru": ("last", "t")}

_WIDE = (torch.float64, torch.complex128)
_COPIES = frozenset({"_to_copy", "copy_", "_copy_from",
                     "_copy_from_and_resize"})
_INDEX_ARGS = frozenset({"index", "indices"})
_BUFFERS = frozenset({"empty", "empty_strided", "empty_like"})
# ops that make another view of their first input and compute nothing
_ALIASES = frozenset({"detach", "alias", "view", "_unsafe_view", "as_strided",
                      "slice", "select", "unsqueeze", "squeeze", "expand",
                      "permute", "transpose", "t"})


def registry_specs():
    """All registry policies plus their ``admit(...)`` wrappers.

    >>> specs = registry_specs()
    >>> "dynamicadaptiveclimb" in specs and "admit(fifo)" in specs
    True
    """
    names = sorted(POLICIES)
    return tuple(names) + tuple(f"admit({n})" for n in names)


# -- the op record ------------------------------------------------------

def _tensors(v):
    if torch.is_tensor(v):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _tensors(x)]
    return []


class Record(TorchDispatchMode):
    """Record every aten op dispatched inside the ``with`` block as
    ``(op, ins, outs)``: ``op`` the overload (``aten.gather.default``),
    ``ins`` ``(argument name, tensor)`` pairs, ``outs`` the output
    tensors.  The record holds every tensor, so ids stay unique."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        named = list(zip(_arg_names(func), args)) + list(kwargs.items())
        ins = tuple((n, t) for n, v in named for t in _tensors(v))
        self.ops.append((func, ins, tuple(_tensors(out))))
        return out


@functools.lru_cache(maxsize=None)
def _arg_names(func):
    return tuple(a.name for a in func._schema.arguments)


def _name(func):
    return func.overloadpacket.__name__


def _aval(t):
    return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}" \
           f"@{t.device.type}"


# -- state trees ----------------------------------------------------------

def _leaves(tree, path=()):
    """``(path, tensor)`` pairs of nested dicts, keys sorted (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                           path + (k,))]
    return [(path, tree)]


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -- program checks -----------------------------------------------------

def _scan_program(ops, state, int64_ok, target, findings):
    """Walk every op of a recorded step for forbidden primitives,
    cross-device copies and 64-bit values outside the allowed places."""
    bad_prims, wide, int64_makers = set(), set(), set()
    for func, ins, outs in ops:
        name = _name(func)
        if name in FORBIDDEN_PRIMITIVES:
            bad_prims.add(name)
        if name in _COPIES:
            devs = {t.device.type for _, t in ins} | {t.device.type
                                                      for t in outs}
            if len(devs) > 1:
                bad_prims.add(f"{name} across {'/'.join(sorted(devs))}")
        for t in outs:
            if t.dtype in _WIDE and not (name == "scalar_tensor"
                                         and t.dim() == 0):
                wide.add((str(t.dtype).removeprefix("torch."), name))
    for path, leaf in _leaves(state):
        if leaf.dtype in _WIDE:
            wide.add((str(leaf.dtype).removeprefix("torch."),
                      f"state leaf {_keystr(path)}"))

    ok = _index_values(ops, {id(leaf) for path, leaf in _leaves(state)
                             if path in int64_ok})
    for func, _, outs in ops:
        if any(t.dtype == torch.int64 and id(t) not in ok for t in outs):
            int64_makers.add(str(func))

    for name in sorted(bad_prims):
        findings.append(Finding(
            "forbidden-primitive", target,
            f"op {name!r} inside the step (a host sync)"))
    for dt, where in sorted(wide):
        findings.append(Finding(
            "f64-leak", target, f"{dt} tensor from {where} in the step"))
    for op in sorted(int64_makers):
        findings.append(Finding(
            "f64-leak", target,
            f"int64 tensor made by {op} outside an index computation"))


def _index_values(ops, leaf_ids):
    """ids of the int64 tensors the step may hold (see the module
    docstring): the documented leaves, index ops' outputs, what derives
    from those alone, the ancestors of every index operand, wrapped
    scalars and unread kernel buffers."""
    producer, read, root = {}, set(), {}
    for j, (func, ins, outs) in enumerate(ops):
        if _name(func) in _ALIASES and ins:
            base = root.get(id(ins[0][1]), id(ins[0][1]))
            root.update((id(t), base) for t in outs)
        else:   # what an op computes from, through any views of it
            read.update(root.get(id(t), id(t)) for _, t in ins)
        for t in outs:
            producer.setdefault(id(t), j)
    ok = set(leaf_ids)
    # backward: every int64 value that feeds an index operand
    stack = [t for _, ins, _ in ops for n, t in ins
             if n in _INDEX_ARGS and t.dtype == torch.int64]
    while stack:
        t = stack.pop()
        if id(t) in ok:
            continue
        ok.add(id(t))
        j = producer.get(id(t))
        if j is not None:
            stack += [u for _, u in ops[j][1] if u.dtype == torch.int64]
    # forward: index ops, wrapped scalars, kernel buffers, derivations
    wrapped = set()
    for func, ins, outs in ops:
        name = _name(func)
        longs = [u for _, u in ins if u.dtype == torch.int64]
        derived = (any(id(u) not in wrapped for u in longs)
                   and all(id(u) in ok for u in longs))
        for t in outs:
            if t.dtype != torch.int64:
                continue
            if name == "scalar_tensor" and t.dim() == 0:
                wrapped.add(id(t))
                ok.add(id(t))
            elif (name in INDEX_OPS or derived
                  or (name in _BUFFERS and id(t) not in read)):
                ok.add(id(t))
    return ok


def _capture_check(step_fn, state, req, eager, target, findings):
    """Capture ``step_fn(state, req)`` into a CUDA graph with syncs made
    errors, replay it, and hold its output state equal to ``eager`` (the
    eager step's, which ran first and loaded every kernel).  Returns
    whether the captured step matched."""
    static = _tree_map(torch.clone, state)
    graph = torch.cuda.CUDAGraph()
    mode = torch.cuda.get_sync_debug_mode()
    try:
        with torch.cuda.graph(graph):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = step_fn(static, req)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
    except Exception as exc:   # a step that will not capture is a finding
        findings.append(Finding(
            "forbidden-primitive", target,
            f"step does not capture into a CUDA graph: "
            f"{type(exc).__name__}: {exc}"))
        return False
    graph.replay()
    torch.cuda.synchronize()
    diff = [_keystr(p) for (p, a), (_, b) in zip(_leaves(out),
                                                  _leaves(eager))
            if not torch.equal(a, b)]
    if diff:
        findings.append(Finding(
            "forbidden-primitive", target,
            f"the captured step's replay differs from the eager step in "
            f"{diff}: the step bakes a host value into the graph"))
    return not diff


def _check_carry(step_fn, state, req, target, findings, int64_ok=()):
    """Run ``step_fn(state, req)`` — which must return *only* the new
    state — under the op record, and verify the carry law plus the
    program-level invariants; on CUDA also the capture."""
    try:
        with Record() as rec:
            new_state = step_fn(state, req)
    except Exception as exc:   # a step that will not run is a finding
        findings.append(Finding(
            "trace-error", target,
            f"step failed to run: {type(exc).__name__}: {exc}"))
        return
    ins, outs = _leaves(state), _leaves(new_state)
    in_paths, out_paths = [p for p, _ in ins], [p for p, _ in outs]
    if in_paths != out_paths or not all(torch.is_tensor(t) for _, t in outs):
        gone = sorted(map(_keystr, set(in_paths) - set(out_paths)))
        new = sorted(map(_keystr, set(out_paths) - set(in_paths)))
        findings.append(Finding(
            "carry-structure", target,
            f"state tree structure drifts across step: lost {gone}, "
            f"gained {new}"))
        return
    for (path, a), (_, b) in zip(ins, outs):
        if (a.shape, a.dtype, a.device) != (b.shape, b.dtype, b.device):
            findings.append(Finding(
                "carry-aval", target,
                f"state leaf {_keystr(path)} drifts across step: "
                f"{_aval(a)} -> {_aval(b)} (breaks the graph loop's "
                "static carry)"))
    for path, leaf in ins:
        if leaf.dtype == torch.int64 and path not in int64_ok:
            findings.append(Finding(
                "f64-leak", target,
                f"state leaf {_keystr(path)} is int64 and not documented "
                "as such (INT64_LEAVES)"))
    _scan_program(rec.ops, state, set(int64_ok), target, findings)
    if state and _leaves(state)[0][1].device.type == "cuda":
        _capture_check(step_fn, state, req, new_state, target, findings)


def _check_rows(state, target, findings):
    """Every ``"cache"`` leaf is an int32, lane-padded, all-EMPTY row."""
    for path, leaf in _leaves(state):
        if not (path and path[-1] == "cache"):
            continue
        where = f"{target}{_keystr(path)}"
        if leaf.dtype != torch.int32:
            findings.append(Finding(
                "row-dtype", where, f"rank row dtype {leaf.dtype}, "
                "expected int32"))
        if leaf.shape[-1] % LANE != 0:
            findings.append(Finding(
                "row-width", where, f"rank row width {leaf.shape[-1]} is "
                f"not a multiple of LANE={LANE}"))
        if not np.all(leaf.cpu().numpy() == EMPTY):
            findings.append(Finding(
                "row-init", where, "fresh rank row is not all-EMPTY"))


def _check_adapt_keys(pol, state, target, findings):
    """Declared ``ADAPT_KEYS`` exist in the (base) state as int32
    leaves."""
    base, sub = pol, state
    inner = getattr(pol, "base", None)
    if inner is not None and isinstance(state, dict) and "base" in state:
        base, sub = inner, state["base"]
    for key in getattr(base, "ADAPT_KEYS", ()):
        if not (isinstance(sub, dict) and key in sub):
            findings.append(Finding(
                "adapt-keys", target,
                f"declared ADAPT_KEYS entry {key!r} missing from the "
                "state tree"))
            continue
        leaf = sub[key]
        if leaf.dtype != torch.int32:
            findings.append(Finding(
                "adapt-keys", target,
                f"ADAPT_KEYS leaf {key!r} has dtype {leaf.dtype}, "
                "expected int32"))


def _int64_leaves(pol):
    """Paths of the state leaves ``pol`` documents as int64."""
    inner = getattr(pol, "base", None)
    if inner is not None:
        return {("base",) + p for p in _int64_leaves(inner)}
    return {(k,) for k in INT64_LEAVES.get(getattr(pol, "name", ""), ())}


def _with_cap(state, K):
    """Insert the tier's capacity cap the way ``repro_torch.tier`` does:
    one int32 scalar a lane."""
    if isinstance(state, dict) and "base" in state:
        base = state["base"]
        cap = lane_scalar(K, base["k"].shape[0], base["k"].device)
        return dict(state, base=dict(base, cap=cap))
    return dict(state, cap=lane_scalar(K, state["k"].shape[0],
                                       state["k"].device))


def _label(device):
    dt = torch.get_default_dtype()
    return f"@{torch.device(device).type}" + (
        "" if dt == torch.float32
        else f"/default={str(dt).removeprefix('torch.')}")


def check_policy(spec, K=8, device="cuda", budgeted=False):
    """Verify one policy spec's step contracts on ``device``; returns
    findings.

    >>> check_policy("dac", device="cpu")
    []
    >>> check_policy("admit(dac)", device="cpu", budgeted=True)
    []
    """
    pol = make_policy(spec)
    target = f"{spec}{':budgeted' if budgeted else ''}{_label(device)}"
    findings = []
    state = pol.init(K, device=device)
    _check_rows(state, target, findings)
    _check_adapt_keys(pol, state, target, findings)
    if budgeted:
        state = _with_cap(state, K)
        step_fn = lambda st, r: pol.step_budgeted(st, r)[0]  # noqa: E731
    else:
        step_fn = lambda st, r: pol.step(st, r)[0]  # noqa: E731
    req = Request.of([3], device=device)
    _check_carry(step_fn, state, req, target, findings, _int64_leaves(pol))
    return findings


def check_tier(device="cuda", n_tenants=3, budget=6 * LANE):
    """Contract pass over the multi-tenant tier step.

    >>> check_tier(device="cpu")
    []
    """
    from ..tier.tier import CacheTier
    tier = CacheTier("dac", n_tenants=n_tenants, budget=budget)
    target = f"tier(dac,n={n_tenants}){_label(device)}"
    findings = []
    state = tier.init(device=device)
    _check_rows(state, target, findings)
    _check_adapt_keys(tier.policy, state, target, findings)
    req = Request.of(torch.zeros((1, n_tenants), dtype=torch.int32),
                     device=device)
    step_fn = lambda st, r: tier.step(st, r)[0]  # noqa: E731
    _check_carry(step_fn, state, req, target, findings)
    return findings


def check_fleet(device="cuda", n_lanes=4, budget=8 * LANE):
    """Contract pass over the fleet lane-block step.

    >>> check_fleet(device="cpu")
    []
    """
    from ..fleet.fleet import FleetTier, _fleet_step
    tier = FleetTier("dac", n_lanes=n_lanes, budget=budget)
    target = f"fleet(dac,n={n_lanes}){_label(device)}"
    findings = []
    state = tier.init(device=device)
    _check_rows(state, target, findings)
    req = Request.of(torch.zeros((1, n_lanes), dtype=torch.int32),
                     device=device)
    step_fn = lambda st, r: _fleet_step(tier, st, r)[0]  # noqa: E731
    _check_carry(step_fn, state, req, target, findings)
    return findings


def verify_contracts(specs=None, devices=("cpu", "cuda"), K=8,
                     include_budgeted=True, include_tier=True,
                     include_dtype=True):
    """The full contract pass: registry x devices, budgeted paths,
    tier/fleet, and a float64-default-dtype sub-pass of every spec on each
    device.  Returns all findings (empty = contract-clean)."""
    if specs is None:
        specs = registry_specs()
    findings = []
    for device in devices:
        for spec in specs:
            findings += check_policy(spec, K=K, device=device)
        if include_budgeted:
            for spec in ("dynamicadaptiveclimb",
                         "admit(dynamicadaptiveclimb)"):
                findings += check_policy(spec, K=K, device=device,
                                         budgeted=True)
        if include_tier:
            findings += check_tier(device=device)
            findings += check_fleet(device=device)
    if include_dtype and torch.get_default_dtype() != torch.float64:
        previous = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            for device in devices:
                for spec in specs:
                    findings += check_policy(spec, K=K, device=device)
        finally:
            torch.set_default_dtype(previous)
    return findings
