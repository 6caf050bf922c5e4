"""Build and load the port's CUDA kernels (plain C interface + ``ctypes``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/kernels/`` at the repository root, at first use.  The
library's file name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once.  A failed build
raises: there is no fallback.

Every pointer and the stream pass as ``ctypes.c_void_p`` (a bare Python
int would be cut to 32 bits); each C entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
Every failure here (no ``nvcc``, a failed build, a library that does not
load, a launch that returns an error) raises :class:`KernelError`, which
callers can tell apart from a fault of their inputs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelError(RuntimeError):
    """A kernel that could not be built, loaded or launched."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise KernelError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels are "
            "built from source at first use")
    return str(path)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: ptxas report}``
    (registers, shared memory, spills) for the sources it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        reports[name] = log
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build([name])
    try:
        return ctypes.CDLL(str(library_path(name)))
    except OSError as exc:
        raise KernelError(f"loading {library_path(name)}: {exc}") from exc


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise KernelError(f"{what}: CUDA error {status}")
