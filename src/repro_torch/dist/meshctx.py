"""The process-global mesh over ``torch.distributed`` (the port of
``repro.dist.meshctx``), and the helpers that start its ranks.

The reference builds one ``jax.sharding.Mesh`` of local devices and lets
GSPMD partition each jitted step.  The port runs one process a rank, the
Megatron way: every rank holds its local shards and the model code calls
explicit collectives over one process group a mesh axis.  A :class:`Mesh`
holds this rank's coordinate and group on each axis; ranks are laid out
row-major over ``shape``, so on a ``(data, model)`` mesh the ``model``
groups are runs of consecutive ranks.

Axis convention (DESIGN.md §5.1): the mesh has a ``"model"`` axis (tensor
and expert parallelism); every other axis shards the batch.  With no mesh
set, :func:`get_mesh` returns the trivial ``(1, 1)`` ``("data", "model")``
mesh, which needs no process group: every single-device call site works
unchanged.

:func:`make_meta_mesh` builds one rank's mesh with no process group, on
the meta device: each axis holds a :class:`MetaGroup`, on which the
collectives count and return shapes (the dry run of the production
meshes, ``launch/dryrun.py``).

Devices and transport: rank ``r`` runs on ``cuda:(r % device_count)``.
When every rank has its own card the groups use NCCL.  Ranks that share a
card (two ranks on the one H100) cannot use NCCL, which refuses two ranks
on one GPU: the caller must ask for gloo explicitly (``backend="gloo"``,
``launch.serve --dist-backend gloo``), and the all-gather and the ring's
send/recv then stage CUDA tensors through host buffers
(``dist/collectives.py``).  Nothing
switches transport quietly.  On the CPU the groups use gloo.

:func:`spawn_ranks` starts ``world`` rank processes (the ``spawn`` start
method) that meet through a ``FileStore`` in a fresh directory, so tests
running in parallel never race for a TCP port; it joins with a timeout,
and a rank that raises, dies or hangs fails the call.  Under ``torchrun``
(``RANK`` / ``WORLD_SIZE`` set) :func:`init_from_env` joins the group the
launcher made instead.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class Mesh:
    """One rank's view of a device mesh: the axis sizes, this rank's
    coordinate on each axis, and its process group on each axis wider
    than 1 (None on a 1-wide axis, where no collective is needed).

    ``ranks`` are the world ranks the mesh lays out row-major (the first
    ``prod(shape)`` by default); ``rank`` is this rank's position among
    them.  A rank outside ``ranks`` holds a mesh with ``member`` False: it
    has no coordinate and no group, and its ``device`` is its own (a fleet
    builds every replica's mesh on every rank)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *, rank: int = 0,
                 groups: Optional[dict] = None, device="cpu",
                 backend: Optional[str] = None, ranks: Optional[Sequence[int]] = None,
                 member: bool = True):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axes)
        self.ranks = tuple(range(math.prod(self.shape)) if ranks is None else ranks)
        self.member = bool(member)
        self.rank = int(rank)
        coords, r = [], self.rank
        for s in reversed(self.shape):
            coords.append(r % s)
            r //= s
        self._coords = dict(zip(self.axis_names, reversed(coords))) if member else {}
        self._groups = dict(groups or {})
        self.device = torch.device(device)
        self.backend = backend

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if not self.member:
            raise ValueError(f"this rank lies outside the mesh of ranks {self.ranks}")
        return self._coords[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None if 1-wide)."""
        return self._groups.get(axis)

    @property
    def transport(self) -> str:
        """The backend, and on gloo with a card which collectives stage
        CUDA tensors through the host (``dist/collectives.py``)."""
        if self.backend is None:
            return "none"
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo (all_reduce on CUDA tensors; all_gather and send/recv host-staged)"
        return self.backend

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        where = f"rank {self.rank}" if self.member else "not a member"
        return f"Mesh({dims}; ranks {self.ranks}, {where}, {self.device}, {self.transport})"


class MetaGroup:
    """A mesh axis of a meta mesh (:func:`make_meta_mesh`): its ``size``
    and this rank's ``rank`` on it, and no process group.  A collective
    handed one counts what it would move and returns a meta result of the
    right shape (``dist/collectives.py``); it never passes its input
    through."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = int(size), int(rank)

    def __repr__(self) -> str:
        return f"MetaGroup(size={self.size}, rank={self.rank})"


def make_meta_mesh(shape: Sequence[int], axes: Sequence[str], rank: int = 0) -> Mesh:
    """World rank ``rank``'s :class:`Mesh` of ``shape`` on the meta device,
    built with no process group: each axis wider than 1 holds a
    :class:`MetaGroup` (the shape-only dry run of one rank's step,
    ``launch/dryrun.py``)."""
    if "model" not in axes:
        raise ValueError(f"mesh axes {tuple(axes)} must include 'model'")
    n = math.prod(shape)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} lies outside a mesh of {n} ranks")
    mesh = Mesh(shape, axes, rank=rank, device="meta")
    mesh._groups = {a: MetaGroup(s, mesh.coord(a))
                    for a, s in zip(mesh.axis_names, mesh.shape) if s > 1}
    return mesh


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)`` for a CUDA
    mesh, the CPU for a CPU one."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the ranks on the host")
    return torch.device("cuda", rank % n)


def resolve_backend(device, world: int, backend: Optional[str] = None) -> str:
    """The process-group backend for ``world`` ranks on ``device``: NCCL
    when every rank has its own card, gloo on the CPU.  Ranks that share a
    card need ``backend="gloo"`` asked for explicitly; anything else
    raises (NCCL refuses two ranks on one GPU)."""
    dev = torch.device(device)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; the CPU runs gloo")
        return "gloo"
    cards = torch.cuda.device_count()
    if world > cards and backend != "gloo":
        raise ValueError(
            f"{world} ranks share {cards} card(s): NCCL cannot hold two ranks on one "
            "GPU; ask for gloo explicitly (backend='gloo', launch.serve "
            "--dist-backend gloo), whose collectives stage CUDA tensors through the host")
    return backend or "nccl"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cpu",
              backend: Optional[str] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """This rank's :class:`Mesh` of ``ranks`` (default: the first
    ``prod(shape)`` ranks) of the initialised process group, row-major.
    ``axes`` must contain ``"model"``; a mesh of one rank needs no process
    group.  Every rank of the world must call it, with the same
    arguments, in the same order (creating groups is collective); a rank
    outside ``ranks`` gets a mesh with ``member`` False.  ``backend``
    defaults to the default group's."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} / axes {tuple(axes)} rank mismatch")
    if "model" not in axes:
        raise ValueError(f"mesh axes {tuple(axes)} must include 'model'")
    n = math.prod(shape)
    if n == 1 and ranks is None:
        # the trivial mesh: this rank alone, on every rank that asks
        return Mesh(shape, axes, device=device)
    ranks = tuple(range(n) if ranks is None else ranks)
    if len(ranks) != n or len(set(ranks)) != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} distinct ranks, got {ranks}")
    if not dist.is_initialized():
        if ranks == (0,):
            return Mesh(shape, axes, device=device)
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks and no process group is "
                         "initialised (spawn_ranks, init_from_env or torchrun)")
    world = dist.get_world_size()
    if max(ranks) >= world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the process group has "
                         f"{world} (ranks {ranks})")
    me = dist.get_rank()
    if n == 1:
        # one rank of several: no group; the others hold it as outsiders
        if world == 1:
            return Mesh(shape, axes, device=device)
        return Mesh(shape, axes, ranks=ranks, member=me == ranks[0],
                    device=rank_device(me, device))
    backend = backend or dist.get_backend()
    groups = {}
    for ai, axis in enumerate(axes):
        if shape[ai] == 1:
            continue
        # one group per line of the mesh along ``axis``: every rank takes
        # part in creating each one, in the same order
        others = [range(s) for j, s in enumerate(shape) if j != ai]
        for rest in _product(others):
            line = []
            for c in range(shape[ai]):
                idx = list(rest)
                idx.insert(ai, c)
                line.append(ranks[_ravel(idx, shape)])
            g = dist.new_group(line, backend=backend)
            if me in line:
                groups[axis] = g
    if me not in ranks:
        return Mesh(shape, axes, ranks=ranks, member=False, device=rank_device(me, device),
                    backend=backend)
    return Mesh(shape, axes, rank=ranks.index(me), groups=groups, ranks=ranks,
                device=rank_device(me, device), backend=backend)


def world_size() -> int:
    """The process group's size (1 with none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_group():
    """The group of every rank of the world (None with one rank or none):
    the group of the decisions every rank must share — a fleet's or a data
    axis's clock, the emission of a replica to the ranks outside it, the
    check of the ranks' streams."""
    return dist.group.WORLD if world_size() > 1 else None


def _product(ranges):
    out = [()]
    for r in ranges:
        out = [p + (i,) for p in out for i in r]
    return out


def _ravel(idx, shape) -> int:
    r = 0
    for i, s in zip(idx, shape):
        r = r * s + i
    return r


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Mesh) -> Mesh:
    """Install ``mesh`` as the process-global mesh; returns it."""
    global _MESH
    _MESH = mesh
    return mesh


def get_mesh() -> Mesh:
    """The active mesh; the trivial single-device mesh if none was set."""
    global _MESH
    if _MESH is None:
        _MESH = make_mesh((1, 1), ("data", "model"))
    return _MESH


@contextmanager
def use_mesh(mesh: Mesh):
    """Scoped :func:`set_mesh`."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def batch_axes(mesh: Optional[Mesh] = None) -> tuple:
    """Every mesh axis that shards the batch dim (all but ``"model"``)."""
    mesh = mesh or get_mesh()
    return tuple(a for a in mesh.axis_names if a != "model")


def data_group(mesh: Optional[Mesh] = None):
    """The process group over the batch-sharding axes (None when they are
    all 1-wide); more than one wide batch axis raises."""
    mesh = mesh or get_mesh()
    wide = [a for a in batch_axes(mesh) if mesh.size(a) > 1]
    if len(wide) > 1:
        raise NotImplementedError(f"batch sharded over {wide}: one data axis is supported")
    return mesh.group(wide[0]) if wide else None


def model_size() -> int:
    """The active mesh's ``model`` axis size (1: the one-device path)."""
    return get_mesh().size("model")


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def init_from_env(*, device="cuda", backend: Optional[str] = None,
                  timeout_s: float = 600.0) -> tuple:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``).  Returns (rank,
    world)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = resolve_backend(device, world, backend)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
    return rank, world


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_entry(fn, rank, world, store_path, backend, timeout_s, threads, args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: tensors travel by value (the queue's own pickler
        # would pass shared-memory handles that die with this process)
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        sys.stdout.flush()
        sys.exit(1)


@contextmanager
def _forwarding_signals(procs):
    """SIGTERM / SIGINT to this process passed on to every live process of
    ``procs`` while the context is open (a launcher's ranks see the
    scheduler's preemption); a no-op off the main thread."""
    import signal

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, forward)
        except ValueError:
            pass
    try:
        yield
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)


def spawn_ranks(fn: Callable, world: int, *, store_dir: Optional[str] = None,
                timeout_s: float = 60.0, backend: str = "gloo", device="cpu",
                args: tuple = (), threads: int = 1) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined
    by one process group; returns the ranks' results in rank order.

    ``fn`` must be importable (module level: it is pickled by name).  The
    ranks meet through a ``FileStore`` in a new directory under
    ``store_dir`` (the system's temporary directory by default), with
    ``timeout_s`` on every collective; the whole call is bounded by
    ``timeout_s`` too.  A rank that raises, exits or outlives the bound
    fails the call with its traceback, and every rank still running is
    killed.  ``threads`` sets each rank's ``torch.set_num_threads`` (0:
    leave it).  A SIGTERM or SIGINT to this process while the ranks run
    is passed on to them (a launcher's preemption reaches its ranks)."""
    backend = resolve_backend(device, world, backend)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_ranks_", dir=store_dir)
    store_path = os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world, store_path, backend, timeout_s, threads,
                               args, out))
             for r in range(world)]
    results: dict = {}
    failure = None
    try:
        with _forwarding_signals(procs):
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            while len(results) < world and failure is None:
                try:
                    rank, ok, payload = out.get(timeout=0.2)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in results and p.exitcode not in (None, 0):
                            failure = f"rank {r} exited with code {p.exitcode}"
                            break
                    if failure is None and time.monotonic() > deadline:
                        missing = sorted(set(range(world)) - set(results))
                        failure = f"ranks {missing} did not finish within {timeout_s:g} s"
                    continue
                if ok:
                    results[rank] = pickle.loads(payload)
                else:
                    failure = f"rank {rank} failed:\n{payload}"
            for p in procs:
                p.join(timeout=5.0 if failure is None else 0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world)]
