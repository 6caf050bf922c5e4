"""Fault-tolerant checkpointing (port of ``checkpoint/manager.py``):
atomic writes, keep-k pruning, auto-resume, optional async (a host copy,
then a writer thread).

Layout, the reference's own:  ``<dir>/step_<N>/state.npz + meta.json``,
written to a ``.tmp`` directory first and atomically renamed, so a crash
mid-save never corrupts the latest checkpoint, and :meth:`restore` picks
the highest complete step.  Leaves of the nested-dict state are addressed
by their ``'/'``-joined path; a bf16 leaf is stored as its ``uint16`` bits
and named ``"bfloat16"`` in ``meta["dtypes"]``, as the reference stores
it, so each side restores the other's checkpoints.  numpy has no bf16, so
:meth:`restore` returns CPU tensors, bf16 rebuilt from its bits.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_SEP = "/"

# dtypes numpy cannot hold, stored as a bit view (the reference's names)
_VIEW_AS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16)}
_VIEW_FROM = {name: dt for dt, (name, _, _) in _VIEW_AS.items()}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = tree
    return out


def _unflatten(flat):
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _host_copy(x):
    """A numpy array that owns its memory: a tensor on any device is
    copied (on the CPU, ``.numpy()`` alone would share the parameter's
    memory, which the optimizer updates in place while a writer thread may
    still be writing it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class CheckpointManager:
    """Atomic, keep-k, optionally-async checkpoint manager."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    # -- save -----------------------------------------------------------
    def save(self, step: int, state: dict, blocking: bool = True,
             extra_meta: dict | None = None):
        """Snapshot ``state`` (a nested dict of tensors or arrays) at
        ``step``.  ``blocking=False`` returns after the host copy; the
        serialization runs on a writer thread (:meth:`wait` joins it and
        re-raises what it raised)."""
        self.wait()
        host = {k: _host_copy(v) for k, v in _flatten(state).items()}
        dtypes = {}
        for k, v in host.items():
            if isinstance(v, torch.Tensor):
                if v.dtype in _VIEW_AS:
                    name, bits, np_bits = _VIEW_AS[v.dtype]
                    dtypes[k] = name
                    host[k] = v.view(bits).numpy().view(np_bits)
                else:
                    host[k] = v.numpy()
        # repolint: waive[wallclock] -- checkpoint provenance stamp
        meta = {"step": step, "time": time.time(), "dtypes": dtypes,
                **(extra_meta or {})}

        def _write():
            final = self._step_dir(step)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "state.npz"), **host)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                # repolint: waive[atomic-json] -- tmp dir + atomic rename
                json.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._prune()

        if blocking:
            _write()
        else:
            def _run():
                try:
                    _write()
                except BaseException as e:  # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, step: int | None = None):
        """Returns ``(step, state)`` or ``(None, None)`` when there is
        nothing to resume.  Leaves come back as CPU tensors; the caller
        moves them to its device."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        flat = {}
        with np.load(os.path.join(d, "state.npz")) as z:
            for k in z.files:
                a, name = z[k], dtypes.get(k)
                if name is None:
                    flat[k] = torch.from_numpy(a)
                elif name in _VIEW_FROM:
                    flat[k] = torch.from_numpy(a.view(np.int16)).view(
                        _VIEW_FROM[name])
                else:
                    raise ValueError(f"{d}: leaf {k!r} has dtype {name!r}, "
                                     f"which this port does not read")
        return step, _unflatten(flat)
