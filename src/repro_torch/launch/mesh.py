"""Device meshes on ``torch.distributed`` (port of ``launch/mesh.py``).

Axes, as the reference names them:
  * ``pod``: 2 pods of 256 ranks; pure data parallelism (parameters
    replicated per pod);
  * ``data``: batch (and, for training, FSDP) parallelism within a pod;
  * ``model``: tensor parallelism (attention heads, the MLP's width, the
    vocabulary).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
a process group, one rank a process.  JAX drives every device from one
process; here each rank runs the same program on its own device and the
ranks meet in collectives, so a world is started first
(:func:`init_distributed`, or :func:`launch_world` for a world of
spawned processes on one host).

Backends are explicit.  NCCL, the default on CUDA, needs one GPU a rank:
asked for more ranks on a host than it has GPUs, :func:`init_distributed`
raises, and never switches to gloo.  gloo runs on the CPU and for several
ranks that share one card (its ``all_gather`` and ``all_to_all``, the
collectives the port uses, take CUDA tensors).  Sums over ranks are
all-gathers added in a fixed order (:func:`seq_sum`), never a backend's
``all_reduce``, so that every rank gets the same bits whatever the
backend; a reduce-scatter is an ``all_to_all`` of the pieces, added in
the same order.

Autograd runs through :func:`cat` and :func:`seq_sum`: each rank's
backward pass computes the transpose of the whole program's forward pass,
so a value held on several ranks carries, on each, only the part of its
gradient that flows through that rank's own use of it, and the parts
meet where a collective's transpose adds them.  The transposes:

* :func:`cat` (a gather of blocks) -> a reduce-scatter: every rank's
  gradient of this rank's block, added in coordinate order (the block of
  a :func:`seq_sum` of the wholes, bit for bit; each rank sends each
  other rank only its block, by ``all_to_all``);
* :func:`seq_sum` (a sum of partials) -> a :func:`seq_sum` of the
  gradients: every rank used the sum, so each partial's gradient is the
  sum of their gradients;
* a cut of a block (``narrow``, ``sharding._block``) -> zero-padding, the
  autograd default: the other ranks' blocks of the value's gradient
  reach it through the collective that made the value.

A leaf held whole on several ranks (a norm's scale, every parameter
across ``pod``) so ends its backward pass with one part on each; the
train step adds them over those axes (``train.train_step``).  A
replicated loss is one function of every rank's values, so each rank
seeds its backward pass with ``1 / ranks``: the parts then add up to the
loss's gradient.  Megatron's f/g pairs give every replica the whole
gradient instead; both conventions give each parameter block the same
gradient, and this one needs no rule for where a replicated activation
enters split compute.

Importing this module starts nothing; :func:`init_distributed` records
the rank's device, which the meshes built after it default to.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["init_distributed", "make_production_mesh", "make_test_mesh",
           "shard_ctx", "check_mesh", "axis_size", "axis_index", "gather",
           "cat", "seq_sum", "reduce_scatter", "launch_world"]


# the device init_distributed() placed this process's rank on
_RANK_DEVICE: torch.device | None = None


def _env_int(name, default=None):
    v = os.environ.get(name)
    return default if v is None else int(v)


def init_distributed(backend: str | None = None,
                     init_method: str | None = None, *,
                     rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None,
                     device: str = "cuda") -> torch.device:
    """Join this process to the world and return its device.

    ``rank``, ``world_size`` and ``local_rank`` default to the ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` environment (as ``python -m
    torch.distributed.run`` sets them); ``init_method`` defaults to the
    environment's ``MASTER_ADDR``/``MASTER_PORT`` (``"env://"``), or takes a
    ``file://`` path.  A CUDA rank's device is ``cuda:{local_rank %
    device_count}``; ``device="cpu"`` puts the rank on the CPU.  The
    backend defaults to NCCL on CUDA and gloo on the CPU; NCCL asked for
    more ranks on this host than it has GPUs raises ``RuntimeError``."""
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    world_size = (_env_int("WORLD_SIZE", 1) if world_size is None
                  else int(world_size))
    local_rank = (_env_int("LOCAL_RANK", rank) if local_rank is None
                  else int(local_rank))
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend runs on CUDA devices only; "
                             "use gloo on the CPU")
        per_host = _env_int("LOCAL_WORLD_SIZE", world_size)
        n_gpus = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if per_host > n_gpus:
            raise RuntimeError(
                f"NCCL needs one GPU a rank: {per_host} ranks on this host, "
                f"{n_gpus} GPUs; run fewer ranks, or gloo to share a card")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' for a "
                               "gloo world on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    global _RANK_DEVICE
    _RANK_DEVICE = dev
    return dev


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device_type):
    """The mesh's device type: ``device_type``, else the one this rank's
    :func:`init_distributed` placed it on."""
    if device_type is not None:
        return device_type
    if _RANK_DEVICE is None:
        raise RuntimeError("the rank's device is not known: join the world "
                           "through init_distributed(), or pass "
                           "device_type=")
    return _RANK_DEVICE.type


def _mesh(shape, axes, device_type):
    need = math.prod(shape)
    world = _world()
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() (or "
                           "run under launch_world) before building a mesh")
    if need > world:
        raise RuntimeError(f"a mesh of {shape} needs {need} ranks, the world "
                           f"has {world}")
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh(_device_type(device_type), ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The (data 16, model 16) mesh, or (pod 2, data 16, model 16) with
    ``multi_pod``, over the first 256 (512) ranks of the world, on the
    ranks' devices (``device_type`` as :func:`make_test_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = _world()
    if have < need:
        raise RuntimeError(
            f"need {need} devices for mesh {shape}, have {have} — launch "
            f"{need} ranks (python -m torch.distributed.run)")
    return _mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device_type=None):
    """A small mesh over the first ``pod * data * model`` ranks of the
    world (``pod=0``: no pod axis).  ``device_type`` defaults to the type
    of the rank's device from :func:`init_distributed`."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def shard_ctx(mesh, mode: str = "train"):
    """The :class:`~repro_torch.models.sharding.ShardCtx` of ``mesh``:
    FSDP and batch over ``data``, tensor parallelism over ``model``."""
    from ..models.sharding import ShardCtx
    pod = "pod" if "pod" in mesh.mesh_dim_names else None
    return ShardCtx(mesh=mesh, fsdp="data", tp="model", pod=pod, mode=mode)


def check_mesh(mesh):
    """``mesh`` itself, or ``TypeError`` unless it is a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def axis_size(mesh, axis: str) -> int:
    return check_mesh(mesh).size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return check_mesh(mesh).get_local_rank(axis)


# dtypes a collective carries by their bytes (gloo takes neither)
_CARRY = (torch.bool, torch.bfloat16)


# Set by a counter (``launch.roofline``) to see every collective: called as
# ``COLLECTIVE_HOOK(kind, x, ranks)`` with ``kind`` "all-gather", "sum" (a
# :func:`seq_sum`'s all-gather) or "reduce-scatter", ``x`` the rank's
# operand and ``ranks`` the group's global ranks.  ``None`` otherwise.
COLLECTIVE_HOOK = None


def gather(x: torch.Tensor, mesh, axis: str) -> list:
    """``x`` of every rank along ``axis`` (same shape and dtype on each),
    in coordinate order."""
    return _gather(x, mesh, axis, "all-gather")


def _gather(x, mesh, axis, kind):
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    if n == 1:
        return [x]
    ranks, coords = _members(mesh, axis, group)
    if COLLECTIVE_HOOK is not None:
        COLLECTIVE_HOOK(kind, x, ranks)
    dt = x.dtype
    send = x.contiguous()
    if dt in _CARRY:
        send = send.view(torch.uint8)
    out = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(out, send, group=group)
    # the group's ranks come in global-rank order; put them in coordinate
    # order along the axis
    ordered = [None] * n
    for g, c in enumerate(coords):
        ordered[c] = out[g]
    return [t.view(dt) if dt in _CARRY else t for t in ordered]


def _members(mesh, axis, group):
    """The global ranks of ``axis``'s group (in the group's rank order) and
    each one's coordinate along ``axis``, as Python ints; reckoned once a
    mesh and axis from the mesh's rank layout (no tensor op, so that a
    collective on fake tensors traces)."""
    cache = mesh.__dict__.setdefault("_repro_members", {})
    if axis not in cache:
        # the layout is a real tensor, read outside any fake or counting
        # mode the caller runs under
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            dims = tuple(int(n) for n in mesh.mesh.shape)
            flat_ranks = mesh.mesh.reshape(-1).tolist()
        where = {}
        for flat, r in enumerate(flat_ranks):
            coord = []
            for n in reversed(dims):
                flat, c = divmod(flat, n)
                coord.append(c)
            where[int(r)] = coord[::-1]
        dim = mesh.mesh_dim_names.index(axis)
        ranks = [int(r) for r in dist.get_process_group_ranks(group)]
        cache[axis] = (ranks, [where[r][dim] for r in ranks])
    return cache[axis]


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0):
    """This rank's block (along ``dim``, split over ``axis`` in coordinate
    order) of the sum over ``axis`` of every rank's ``x``, added in
    coordinate order: bit for bit the block of :func:`seq_sum`, but each
    rank sends each other rank only that rank's block (one
    ``all_to_all``)."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    ranks, coords = _members(mesh, axis, group)
    if COLLECTIVE_HOOK is not None:
        COLLECTIVE_HOOK("reduce-scatter", x, ranks)
    dt = x.dtype
    pieces = x.chunk(n, dim)
    # the group's j-th member gets the piece at its coordinate
    send = torch.cat([pieces[c].movedim(dim, 0).contiguous().reshape(-1)
                      for c in coords])
    if dt in _CARRY:
        send = send.view(torch.uint8)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if dt in _CARRY:
        recv = recv.view(dt)
    shape = pieces[0].movedim(dim, 0).shape
    got = recv.chunk(n)
    ordered = [None] * n
    for j, c in enumerate(coords):
        ordered[c] = got[j].view(shape)
    return _ordered_sum(ordered).movedim(0, dim)


class _Cat(torch.autograd.Function):
    """The blocks of every rank along ``axis`` concatenated along ``dim``.

    Adjoint: a reduce-scatter (:func:`reduce_scatter`).  Each rank's
    gradient of the whole holds the part that flows through its own use
    of it; this rank's block's gradient is the sum of every rank's
    gradient at the block's place, added in coordinate order (a
    :func:`seq_sum` over ``axis``, then this rank's cut, bit for
    bit)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return torch.cat(gather(x, mesh, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _SeqSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks along ``axis``, added in
    coordinate order.

    Adjoint: the same sum of the gradients.  Every rank of the axis used
    the sum, each holding the gradient of its own use; a partial's
    gradient is the sum of them all."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _ordered_sum(_gather(x, mesh, axis, "sum"))

    @staticmethod
    def backward(ctx, g):
        return _ordered_sum(_gather(g, ctx.mesh, ctx.axis, "sum")), None, \
            None


def _ordered_sum(parts):
    x = parts[0]
    for p in parts[1:]:
        x = x + p
    return x


def cat(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank over ``axes`` concatenated along ``dim``,
    the first axis major (the order a dimension split over ``axes`` is
    laid out in).  Differentiable: its adjoint is a reduce-scatter
    (:class:`_Cat`)."""
    dim %= x.dim()
    for axis in reversed(tuple(axes)):
        if axis_size(mesh, axis) > 1:
            x = _Cat.apply(x, mesh, axis, dim)
    return x


def seq_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes``, added in coordinate
    order (the last axis first), so that every rank gets the same value
    bit for bit whatever the backend's reduction order.
    Differentiable: its adjoint is the same sum of the gradients."""
    for axis in reversed(tuple(axes)):
        if axis_size(mesh, axis) > 1:
            x = _SeqSum.apply(x, mesh, axis)
    return x


# -- worlds of spawned processes -------------------------------------------

def _rank_main(fn, rank, world, init_file, backend, device, args, results):
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_distributed(backend, f"file://{init_file}", rank=rank,
                         world_size=world, local_rank=rank, device=device)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                       # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def launch_world(fn, world: int, args=(), *, init_file: str,
                 backend: str | None = None, device: str = "cuda",
                 timeout: float = 120.0) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one host and return
    their results in rank order.

    Each rank joins a world through ``init_file`` (a ``file://`` rendezvous
    path that must not exist yet) on ``backend`` (default: NCCL on CUDA,
    gloo on the CPU) with its device from :func:`init_distributed`: a
    card unless ``device="cpu"``; with no card, every rank raises.  ``fn``
    and its result are pickled (a top-level function; return numpy arrays
    or Python values).  A rank that raises fails the world: the others are
    terminated and ``RuntimeError`` carries its traceback; so does a world
    that has not finished after ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init_file, backend, device,
                               args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"world of {world} ranks not done after "
                                   f"{timeout} s (ranks done: "
                                   f"{sorted(got)})")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    return [got[r] for r in range(world)]
