"""Process meshes and collectives, the counterpart of
``raytracing_tpu/parallel/mesh.py:25-78``.

A JAX mesh is an array of devices inside one process, and ``shard_map``
runs the body once per device. Here each mesh position is a process (a
rank of ``torch.distributed``), laid out row-major over the axis sizes as
``np.reshape`` lays out the JAX package's device list. The axes keep
their JAX meaning:

* ``dp``: pixel blocks, one a rank;
* ``tp``: the scene's primitives split by range, closest hits reduced
  across ranks (``scene_shard.py``, ``ring.py``);
* ``sp``: samples per pixel split across ranks;
* ``pp``: bounce windows staged across ranks (``pp.py``).

``axis_index(ax)`` is :meth:`Mesh.index`; ``psum``, ``pmean`` and ``pmin``
are all-reduces (SUM, SUM over the axis size, MIN) on the process group
of the ranks that differ only on those axes; ``ppermute`` is a
``batch_isend_irecv`` to the ring neighbour (``ring.py``, ``pp.py``).

Backends: NCCL refuses two ranks on one card, so ranks that share a card
use gloo, which takes CUDA tensors for ``all_reduce`` and ``broadcast``
only (no send/recv): the dp/sp/tp paths use ``all_reduce`` alone; the
ring and the pipeline need gloo on CPU tensors or NCCL with a card a
rank. The backend is always named by the caller or by
:func:`default_backend` (NCCL for the card, gloo for the CPU); asking NCCL
for more ranks than cards raises. Nothing here catches a failed
collective.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import DEFAULT_DEVICE, resolve

TIMEOUT = datetime.timedelta(seconds=600)  # a collective that waits longer raises


def default_backend(device=DEFAULT_DEVICE, world_size: int = 1) -> str:
    """``"nccl"`` for a CUDA device when each of ``world_size`` ranks has
    a card of its own, else ``"gloo"`` (the CPU, or ranks that share a
    card). ``spawn`` and ``initialize_distributed`` default to this rule
    for one rank, so NCCL asked of ranks sharing a card raises there."""
    dev = torch.device(device)
    return ("nccl" if dev.type == "cuda" and world_size <= torch.cuda.device_count()
            else "gloo")


def check_backend(backend: str, world_size: int, device=DEFAULT_DEVICE) -> None:
    """Raise where ``backend`` cannot run ``world_size`` ranks on this
    host's ``device``: NCCL needs CUDA tensors and a card a rank."""
    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA tensors; use 'gloo' for the CPU")
        n = torch.cuda.device_count()
        if world_size > n:
            raise ValueError(
                f"backend 'nccl' needs one card a rank: {world_size} ranks, {n} card(s) "
                f"(NCCL refuses two ranks on one card); use backend='gloo', which takes "
                f"CUDA tensors for all_reduce and broadcast")


def rank_device(device=DEFAULT_DEVICE, local_rank: int = 0) -> torch.device:
    """A rank's device: ``cuda:(local_rank % device_count)`` for a CUDA
    device (set as the current one), else ``device`` as it is."""
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None,
                           strict: Optional[bool] = None, device=DEFAULT_DEVICE) -> bool:
    """Join the process group (``torch.distributed.init_process_group``).

    Returns True when the group is (now) initialized. With no explicit
    argument and neither ``RANK`` nor ``WORLD_SIZE`` in the environment it
    returns False: a single-process run. With none but those variables
    set, it joins through ``env://``. When ``init_method``, ``world_size``
    or ``rank`` is given, a failure raises (``strict``; a silently
    single-process run of a multi-process job is worse than a crash);
    ``strict=False`` returns False instead. ``backend`` defaults to
    :func:`default_backend` of ``device``."""
    explicit = any(x is not None for x in (init_method, world_size, rank))
    if strict is None:
        strict = explicit
    if dist.is_initialized():
        return True
    if not explicit and "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return False
    backend = backend or default_backend(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    try:
        check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world_size)), device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank, timeout=TIMEOUT)
    except (RuntimeError, ValueError):
        if strict:
            raise
        return False
    return True


@dataclass
class Mesh:
    """This rank's view of a mesh of ``prod(axis_sizes)`` ranks: its
    coordinates, its device and the process group of every set of axes
    (the ranks that differ from it only on those axes). Ranks past the
    mesh's size belong to none of it (``member`` False)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    groups: dict = field(default_factory=dict, repr=False)  # frozenset(axes) -> group

    @property
    def n(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def member(self) -> bool:
        return self.rank < self.n

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r} (axes {self.axis_names})")
        return axes

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def coords(self) -> Tuple[int, ...]:
        if not self.member:
            raise ValueError(f"rank {self.rank} is outside this mesh of {self.n} ranks")
        return tuple(int(c) for c in np.unravel_index(self.rank, self.axis_sizes))

    def index(self, axis: str) -> int:
        """``axis_index``: this rank's coordinate on ``axis``."""
        return self.coords()[self.axis_names.index(self._axes(axis)[0])]

    def group(self, axes):
        """The process group of ``axes`` (None when it is this rank alone)."""
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return None
        return self.groups[frozenset(axes)]

    def peer(self, axis: str, offset: int) -> int:
        """The global rank ``offset`` steps along the ring of ``axis``."""
        c = list(self.coords())
        k = self.axis_names.index(axis)
        c[k] = (c[k] + offset) % self.axis_sizes[k]
        return int(np.ravel_multi_index(c, self.axis_sizes))


def make_mesh(axis_sizes: Optional[Sequence[int]] = None, axis_names=("dp",),
              device=DEFAULT_DEVICE) -> Mesh:
    """A mesh over the first ``prod(axis_sizes)`` ranks of the initialized
    process group (``make_mesh()``: every rank on one ``dp`` axis;
    ``make_mesh((4, 2), ("dp", "tp"))``: 4-way data × 2-way scene
    parallel). Every rank of the group must call it, in the same order:
    it creates one process group for every set of axes. ``device`` is
    this rank's device (``rank_device``; the CPU when asked for)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(initialize_distributed, or spawn)")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names[:len(axis_sizes)])
    n = math.prod(axis_sizes)
    if n > world:
        raise ValueError(f"mesh wants {n} ranks, the process group has {world}")
    rank = dist.get_rank()
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    mesh = Mesh(names, axis_sizes, rank, dev)
    made = {}  # ranks tuple -> group, so equal rank sets share one group
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(range(len(names)), k):
            if math.prod(axis_sizes[i] for i in subset) == 1:
                continue
            others = [i for i in range(len(names)) if i not in subset]
            for fixed in itertools.product(*(range(axis_sizes[i]) for i in others)):
                ranks = []
                for free in itertools.product(*(range(axis_sizes[i]) for i in subset)):
                    c = [0] * len(names)
                    for i, v in zip(others, fixed):
                        c[i] = v
                    for i, v in zip(subset, free):
                        c[i] = v
                    ranks.append(int(np.ravel_multi_index(c, axis_sizes)))
                key = tuple(sorted(ranks))
                if key not in made:
                    made[key] = dist.new_group(list(key), timeout=TIMEOUT)
                if rank in key:
                    mesh.groups[frozenset(names[i] for i in subset)] = made[key]
    return mesh


class _Psum(torch.autograd.Function):
    """All-reduce SUM whose backward is the all-reduce SUM of the
    cotangent (the transpose of ``psum``: every rank's cotangent of the
    replicated sum is its share of the total)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``jax.lax.psum`` over ``axes``, differentiable."""
    group = mesh.group(axes)
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Psum.apply(x, group)
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def pmean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``jax.lax.pmean``: the sum over ``axes`` divided by their size."""
    n = mesh.size(axes)
    return x if n == 1 else psum(x, mesh, axes) / n


def pmin(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``jax.lax.pmin`` over ``axes`` of a detached tensor (winner
    selection is discrete: it has no gradient)."""
    group = mesh.group(axes)
    y = x.detach().clone()
    if group is not None:
        dist.all_reduce(y, op=dist.ReduceOp.MIN, group=group)
    return y


class _ReplicatedOut(torch.autograd.Function):
    """The identity on an output every rank of a mesh of ``n`` holds,
    whose backward takes each rank's share (1/n) of the cotangent: every
    rank computes the same loss from it, and the shares of all ranks sum
    to one loss's cotangent."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def replicated_output(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReplicatedOut.apply(x, mesh.n)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (an all-reduce, which both backends
    run on the mesh's device)."""
    group = mesh.group(mesh.axis_names)
    if group is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)


def _spawned(rank: int, fn, world_size: int, backend: str, device, store: str, out: str,
             args) -> None:
    if torch.device(device).type == "cpu":
        # ranks on the CPU share its cores: one rank's threads per share
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, store=dist.FileStore(store, world_size), rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    try:
        result = fn(rank_device(device, rank), *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *, backend: Optional[str] = None, device=DEFAULT_DEVICE,
          args=()) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` local ranks, started
    with the spawn method (``torch.multiprocessing``), joined through a
    ``FileStore`` in a temporary directory (no port to race for), and
    return each rank's result in rank order. ``fn`` must be importable
    (a function at the top of a module of the package: each rank imports
    it afresh) and returns picklable CPU values. A rank that raises makes
    this raise with its traceback."""
    backend = backend or default_backend(device)
    check_backend(backend, world_size, device)
    resolve(device)
    tmp = tempfile.mkdtemp(prefix="rt_spawn_")
    try:
        torch.multiprocessing.spawn(
            _spawned, args=(fn, world_size, backend, device, os.path.join(tmp, "store"), tmp,
                            args), nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
