"""Spec-string machinery for the port's policy registry.

A copy of the reference package's ``specs`` module (the port imports
nothing of that package; ``tests/test_torch_isolation.py`` holds the two
copies equal).  The policy registry (``repro_torch.core.make_policy``)
speaks the same tiny language as the reference::

    name
    name(k1=v1, k2=v2, ...)

This module owns the parser and the type-coercion rules so the two stay in
lockstep: values are coerced to the *declared* type of the target callable's
parameter (inferred from its default, falling back to its annotation), an
integer knob rejects non-integral floats, and an unknown parameter raises
``ValueError`` naming the accepted ones.
"""
from __future__ import annotations

import inspect
import re

__all__ = ["parse_spec", "coerce_value", "build_kwargs", "format_spec",
           "split_top"]

_SPEC_RE = re.compile(r"([a-z0-9_]+)\s*(?:\((.*)\))?\s*", re.I | re.S)

# annotations arrive as strings under `from __future__ import annotations`
_ANNOT_TYPES = {"int": int, "float": float, "bool": bool, "str": str}


def parse_spec(spec: str) -> tuple[str, str | None]:
    """Split ``"name(args)"`` into ``(name, argstr)``; ``argstr`` is ``None``
    when no parenthesis group is present."""
    m = _SPEC_RE.fullmatch(spec.strip())
    if not m:
        raise ValueError(f"unparseable spec {spec!r}")
    return m.group(1).lower(), m.group(2)


def split_top(argstr: str | None) -> list:
    """Split a spec argument string on *top-level* commas only — commas
    inside nested parentheses stay put, so composite specs such as
    ``admit(dac(eps=0.5,growth=4),filter=tinylfu)`` keep their base-policy
    spec intact.  Empty segments are dropped; ``None`` splits to ``[]``.

    >>> split_top("dac(eps=0.5,growth=4),filter=tinylfu")
    ['dac(eps=0.5,growth=4)', 'filter=tinylfu']
    >>> split_top("a=1,b=2"), split_top(None), split_top("  ")
    (['a=1', 'b=2'], [], [])
    """
    if argstr is None:
        return []
    parts, depth, cur = [], 0, []
    for ch in argstr:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced parentheses in {argstr!r}")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ValueError(f"unbalanced parentheses in {argstr!r}")
    parts.append("".join(cur))
    return [p for p in (q.strip() for q in parts) if p]


def _coerce_literal(text: str):
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text.strip("'\"")


def _declared_type(param: inspect.Parameter):
    """The type a spec value must land as: the default's type when one is
    declared, else the (string or real) annotation."""
    if param.default is not inspect.Parameter.empty:
        return type(param.default)
    ann = param.annotation
    if isinstance(ann, str):
        return _ANNOT_TYPES.get(ann)
    return ann if isinstance(ann, type) else None


def coerce_value(kind: str, name: str, params: dict, key: str, value):
    """Coerce a parsed spec value to the declared type of parameter ``key``
    of registry entry ``name`` (``params`` = its ``inspect`` parameters),
    so ``growth=4.0`` and ``growth=4`` build identical objects instead of
    one smuggling a float through an integer knob."""
    param = params.get(key)
    if param is None:
        raise ValueError(
            f"unknown parameter {key!r} for {kind} {name!r}; accepts: "
            f"{sorted(params)}")
    target = _declared_type(param)
    if target is None or isinstance(value, str):
        return value
    if target is bool:
        if not isinstance(value, bool):
            raise ValueError(
                f"{name}({key}=...) expects a bool, got {value!r}")
        return value
    if target is int:
        if isinstance(value, float):
            if not value.is_integer():
                raise ValueError(
                    f"{name}({key}=...) expects an integer, got {value!r}")
            return int(value)
        return int(value)
    if target is float:
        return float(value)
    return value


def build_kwargs(kind: str, name: str, fn, argstr: str | None, *,
                 skip: tuple[str, ...] = ("self",)) -> dict:
    """Parse ``argstr`` ("k1=v1,k2=v2") into kwargs coerced against ``fn``'s
    signature; parameters in ``skip`` are not spec-settable."""
    params = {k: p for k, p in inspect.signature(fn).parameters.items()
              if k not in skip}
    kwargs = {}
    if argstr and argstr.strip():
        for part in split_top(argstr):
            k, sep, v = part.partition("=")
            if not sep:
                raise ValueError(
                    f"{kind} spec args must be k=v, got {part!r}")
            k = k.strip()
            kwargs[k] = coerce_value(kind, name, params, k,
                                     _coerce_literal(v.strip()))
    return kwargs


def format_spec(name: str, kwargs: dict) -> str:
    """Canonical string form: ``name`` or ``name(k=v,...)`` (insertion
    order preserved)."""
    if not kwargs:
        return name
    args = ",".join(f"{k}={v}" for k, v in kwargs.items())
    return f"{name}({args})"
