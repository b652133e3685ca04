"""The device mesh on ``torch.distributed``: layout, process groups, launcher.

Counterpart of ``repro/launch/mesh.py``.  The reference's mesh is one
controller's view of many devices, which GSPMD partitions a program over.
The port's is SPMD over processes: one rank a mesh position, each running
the same program on the shards it holds, with explicit collectives.

* ``Mesh`` is the layout: ``axis_names``, ``shape`` (``mesh.shape[axis]``
  as in JAX) and, for a live mesh, the rank, its row-major ``coords``, its
  ``device`` and one process group for each set of axes a rank reduces
  over (``mesh.group(axes)``).  A mesh without a rank is the layout alone,
  which layout functions take without starting any process.
* ``make_mesh`` builds a live mesh over an initialised default group.
* ``spawn`` starts one process a rank (the ``spawn`` start method: CUDA
  cannot fork), rendezvous through a ``FileStore`` in a temporary
  directory, runs ``fn(mesh, *args)`` on every rank and returns rank 0's
  result.

Backend: NCCL when every rank has a card of its own, gloo when ranks share
a card (NCCL refuses two ranks on one device) or run on the CPU.  The
port's collectives are ``all_reduce``, ``all_gather`` and ``broadcast``,
which gloo implements for CUDA tensors too.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh layout; with ``rank`` set, one rank's view of it."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.sizes} does not name its axes "
                             f"{self.axis_names}")
        if self.rank is not None and not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.size}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords_of(self, rank: int) -> dict[str, int]:
        """A rank's position, row-major over the axes (the last fastest)."""
        out = {}
        for name, n in reversed(tuple(zip(self.axis_names, self.sizes))):
            out[name] = rank % n
            rank //= n
        return {a: out[a] for a in self.axis_names}

    @property
    def coords(self) -> dict[str, int]:
        if self.rank is None:
            raise ValueError("a layout-only mesh has no rank")
        return self.coords_of(self.rank)

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a, n in zip(self.axis_names, self.sizes):
            r = r * n + coords[a]
        return r

    def index_over(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """Row-major index of a rank's coordinates over ``axes`` (in the
        order given): the block a dimension sharded over ``axes`` gives it."""
        c = self.coords if rank is None else self.coords_of(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def ranks_over(self, axes: Sequence[str], rank: Optional[int] = None) -> list[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, in
        ascending order: the members of its group over ``axes``."""
        c = self.coords if rank is None else self.coords_of(rank)
        free = [a for a in self.axis_names if a in axes]
        out = []
        for vals in itertools.product(*(range(self.shape[a]) for a in free)):
            out.append(self.rank_of({**c, **dict(zip(free, vals))}))
        return sorted(out)

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes``; None when the axes hold
        one rank (nothing to reduce)."""
        key = _axes_key(self, axes)
        if not key:
            return None
        if self.rank is None or key not in self.groups:
            raise ValueError(f"no process group over {key} on this mesh")
        return self.groups[key]


def _axes_key(mesh: Mesh, axes: Sequence[str]) -> tuple[str, ...]:
    """``axes`` in mesh order, without the axes of size 1."""
    unknown = set(axes) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} not in mesh {mesh.axis_names}")
    return tuple(a for a in mesh.axis_names if a in axes and mesh.shape[a] > 1)


def choose_backend(world: int, device) -> str:
    """NCCL when every one of ``world`` ranks has a card of its own, else
    gloo (ranks sharing a card, or on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """A live mesh over the initialised default group, which must hold
    ``prod(shape)`` ranks.  Every rank creates every group, in the same
    order (``new_group`` is collective): for each set of axes larger than
    one rank, one group per position off those axes."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (spawn starts one)")
    layout = Mesh(tuple(int(s) for s in shape), tuple(axes))
    world = dist.get_world_size()
    if world != layout.size:
        raise ValueError(f"mesh {layout.shape} needs {layout.size} ranks, the "
                         f"default group has {world}")
    rank = dist.get_rank()
    backend = backend or dist.get_backend()
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    live = [a for a in layout.axis_names if layout.shape[a] > 1]
    groups = {}
    for k in range(1, len(live) + 1):
        for sub in itertools.combinations(live, k):
            seen = set()
            for r in range(world):
                members = tuple(layout.ranks_over(sub, r))
                if members in seen:
                    continue
                seen.add(members)
                g = dist.new_group(list(members), backend=backend)
                if rank in members:
                    groups[sub] = g
    return Mesh(layout.sizes, layout.axis_names, rank, device, backend, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout: 16 x 16 = 256 chips a pod; ``multi_pod`` adds
    a leading 2-pod axis.  Layout only (``make_mesh`` makes it live on that
    many ranks)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh(device="cuda") -> Mesh:
    """The one-rank 1 x 1 mesh of a single process: every axis holds one
    rank, so it has no group and no collective runs."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh((1, 1), ("data", "model"), rank=0, device=device)


def data_axis_size(mesh: Mesh) -> int:
    size = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        size *= mesh.shape["pod"]
    return size


def _rank_main(rank: int, world: int, backend: str, store: str, shape, axes,
               device: str, fn: Callable, args: tuple, results) -> None:
    """One rank: join the group, build the mesh, run ``fn``, report."""
    torch.set_num_threads(1)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=600))
        mesh = make_mesh(shape, axes, device=device, backend=backend)
        out = fn(mesh, *args)
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, shape: Sequence[int], axes: Sequence[str], *args,
          device="cuda", timeout: float = 900.0) -> Any:
    """Run ``fn(mesh, *args)`` on ``prod(shape)`` new processes, one rank
    each, and return rank 0's result (pickled back: CPU tensors, numpy,
    plain data).  ``fn`` must be importable by name.  Raises if any rank
    fails or the ranks take longer than ``timeout`` seconds; every process
    started is stopped before it returns."""
    world = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn: no CUDA device (pass device='cpu' to run "
                           "the ranks on the CPU)")
    backend = choose_backend(world, dev)
    why = ("a card each" if backend == "nccl" else
           "sharing one card" if dev.type == "cuda" else "on the CPU")
    print(f"mesh: {world} ranks {dict(zip(axes, shape))} on {dev.type}, "
          f"backend {backend} ({why})")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, backend, os.path.join(tmp, "store"), tuple(shape),
            tuple(axes), str(dev), fn, args, results)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect_results(procs, results, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect_results(procs, results, timeout: float):
    """Rank 0's result once every rank has reported; the first failure's
    traceback, or a rank that died without a word, raises."""
    pending, out = set(range(len(procs))), None
    deadline = time.monotonic() + timeout
    while pending:
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r in pending if procs[r].exitcode is not None]
            if dead:
                try:   # a report sent just before the exit may still be in flight
                    rank, ok, payload = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"mesh rank(s) {dead} exited (codes "
                        f"{[procs[r].exitcode for r in dead]}) without a result")
            elif time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks {sorted(pending)} still running "
                                   f"after {timeout} s")
            else:
                continue
        if not ok:
            raise RuntimeError(f"mesh rank {rank} failed:\n{payload}")
        pending.discard(rank)
        if rank == 0:
            out = pickle.loads(payload)
    return out
