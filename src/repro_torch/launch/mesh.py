"""Meshes of ``torch.distributed`` ranks, and the ranks themselves.

The port of ``repro.launch.mesh``.  A JAX mesh is a grid of devices with
named axes, and a collective over a tuple of axes runs over the devices
that share the other coordinates.  Here each rank is a process with one
device, and :func:`make_mesh` builds, after
``torch.distributed.init_process_group``, a process group for every tuple
of axes a collective can name (every non-empty subset of the axes, in mesh
order), then binds the mesh to :mod:`repro_torch.sharding.comm`.

Ranks are numbered row-major over the mesh, and inside a group they are
ordered by global rank, which is JAX's order: the linear index over the
named axes in mesh order.  Every rank creates every group, in the same
order (a ``new_group`` that not every rank enters hangs).

The backend and each rank's device are explicit arguments: ``"nccl"``
needs one card a rank; ``"gloo"`` is what ranks on the CPU and ranks that
share one card use (on a card it carries CUDA tensors through the host).
:func:`spawn` and :class:`RankPool` start ranks as processes of the
``spawn`` start method (CUDA survives it); under ``torchrun`` a program
calls :func:`init_rank` with ``init_method="env://"`` itself.
:func:`add_mesh_flags` and :func:`mesh_cli` are the launchers' mesh
flags, shared by ``launch/serve.py`` and ``launch/train.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.common.device import resolve_device, use_device
from repro_torch.sharding import comm

BACKENDS = ("gloo", "nccl")
# the axes of a mesh given by its sizes alone (the launchers' --mesh)
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's process group over a tuple of axes: ``pg`` (None for a
    group of one rank), its ``size`` and this rank's ``index`` in it."""
    pg: Any
    size: int
    index: int


@dataclasses.dataclass
class Mesh:
    """A grid of ranks with named axes, seen from one rank."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[Tuple[str, ...], AxisGroup]
    wire: comm.WireLog

    @property
    def coords(self) -> Tuple[int, ...]:
        return coords_of(self.rank, self.shape)

    @property
    def axis_sizes(self) -> Tuple[Tuple[str, int], ...]:
        return tuple(zip(self.axes, self.shape))

    def size(self, axes) -> int:
        return math.prod(dict(self.axis_sizes)[a] for a in comm._norm(axes))

    def index(self, axes) -> int:
        """This rank's linear index over ``axes`` (row-major, in the order
        given)."""
        c = dict(zip(self.axes, self.coords))
        i = 0
        for a in comm._norm(axes):
            i = i * dict(self.axis_sizes)[a] + c[a]
        return i

    def group(self, axes) -> AxisGroup:
        axes = comm._norm(axes)
        g = self.groups.get(axes)
        if g is None:
            raise ValueError(f"no process group over {axes} on the mesh "
                             f"{self.axis_sizes}: name axes of the mesh, in "
                             f"mesh order")
        return g


def coords_of(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` on a mesh of ``shape``."""
    out = []
    for n in reversed(tuple(shape)):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def group_members(shape: Sequence[int], axes_idx: Sequence[int]
                  ) -> List[List[int]]:
    """The ranks of each group over the mesh axes at ``axes_idx``: one
    list a block of ranks that share the other coordinates, each ordered
    by global rank (JAX's order over the named axes in mesh order)."""
    world = math.prod(shape)
    blocks: Dict[Tuple[int, ...], List[int]] = {}
    for r in range(world):
        c = coords_of(r, shape)
        key = tuple(v for i, v in enumerate(c) if i not in axes_idx)
        blocks.setdefault(key, []).append(r)
    return [blocks[k] for k in sorted(blocks)]


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device) -> Mesh:
    """Build this rank's :class:`Mesh` (``device`` is the rank's own) and
    bind it to :mod:`repro_torch.sharding.comm`.  Needs
    ``torch.distributed`` initialized with ``prod(shape)`` ranks."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up, "
                         f"with distinct names")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed."
                           "init_process_group first (or init_rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    groups: Dict[Tuple[str, ...], AxisGroup] = {}
    for n in range(1, len(axes) + 1):
        for idx in itertools.combinations(range(len(axes)), n):
            names = tuple(axes[i] for i in idx)
            size = math.prod(shape[i] for i in idx)
            blocks = group_members(shape, idx)
            mine = next(b for b in blocks if rank in b)
            pg = None
            if size > 1:
                for b in blocks:           # every rank enters every group
                    g = dist.new_group(b)
                    if b is mine:
                        pg = g
            groups[names] = AxisGroup(pg, size, mine.index(rank))
    mesh = Mesh(shape, axes, rank, resolve_device(device),
                dist.get_backend(), groups, comm.WireLog())
    comm.bind(mesh)
    return mesh


# =============================================================================
# Ranks as processes
# =============================================================================

def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_devices(backend: str, devices: Sequence) -> List[torch.device]:
    """Validate a backend and the ranks' devices (one entry a rank; a card
    may appear several times under gloo, never under nccl)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    devs = [torch.device(d) for d in devices]
    if backend == "nccl":
        if any(d.type != "cuda" or d.index is None for d in devs):
            raise ValueError(f"nccl needs a card a rank, given as cuda:N: "
                             f"{[str(d) for d in devs]}")
        if len(set(devs)) != len(devs):
            raise ValueError(f"nccl needs one card a rank, and ranks share "
                             f"one: {[str(d) for d in devs]} (use gloo)")
    return devs


def init_rank(rank: int, world: int, *, backend: str, device,
              init_method: str, timeout_s: float = 600.0) -> torch.device:
    """Initialize ``torch.distributed`` for one rank on its ``device``
    (made current first, where it is a card) and return the device.
    ``init_method`` is ``tcp://127.0.0.1:<port>``, ``file://<path>`` or,
    under torchrun, ``env://``."""
    check_devices(backend, [device])
    dev = use_device(device)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return dev


@dataclasses.dataclass
class Rank:
    """What a task run on a rank gets first: who it is, its device, and a
    ``state`` dict that lives as long as the rank's process."""
    rank: int
    world: int
    device: torch.device
    state: Dict[str, Any]


def _rank_main(rank, world, backend, device, init_method, timeout_s,
               threads, tasks, results):
    """A rank's process: initialize, then run tasks until told to stop."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = init_rank(rank, world, backend=backend, device=device,
                        init_method=init_method, timeout_s=timeout_s)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    ctx = Rank(rank, world, dev, {})
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(ctx, *args)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``world`` ranks as processes (``spawn`` start method), each on
    ``devices[rank]`` under ``backend``, that run tasks until closed.
    Each rank runs ``threads`` intra-op threads (default: the host's cores
    shared out, at least one: ranks that each take every core spend their
    time contending for them).

    :meth:`run` calls ``fn(rank: Rank, *args)`` on every rank and returns
    the results in rank order; ``fn`` must be importable by name (a
    module-level function) and its arguments and result picklable.  A task
    that raises on any rank, a rank that dies, or a task that outlasts
    ``timeout_s`` stops every rank and raises here with each rank's
    traceback.  ``timeout_s`` also bounds each collective
    (``init_process_group``'s timeout), so a rank left waiting in one
    fails instead of hanging.  Use it as a context manager.
    """

    def __init__(self, world: int, *, backend: str, devices: Sequence,
                 timeout_s: float = 600.0, threads: Optional[int] = None,
                 init_method: Optional[str] = None):
        if len(devices) != world:
            raise ValueError(f"{world} ranks need {world} devices, got "
                             f"{list(devices)}")
        check_devices(backend, devices)
        self.world, self.timeout_s = world, timeout_s
        if threads is None:
            threads = max(1, (os.cpu_count() or 1) // world)
        ctx = mp.get_context("spawn")
        init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
        self._results = ctx.Queue()
        self._tasks = [ctx.SimpleQueue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world, backend, str(devices[r]), init_method, timeout_s,
                threads, self._tasks[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args,
            timeout_s: Optional[float] = None) -> List[Any]:
        """``fn(rank, *args)`` on every rank, within ``timeout_s`` (default
        the pool's); the results in rank order."""
        for q in self._tasks:
            q.put((fn, args))
        got: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        limit = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + limit
        while len(got) + len(errors) < self.world:
            try:
                rank, ok, out = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if p.exitcode is not None and r not in got]
                if dead or time.monotonic() > deadline:
                    errors.update({r: f"rank {r} exited with code "
                                      f"{self._procs[r].exitcode}"
                                   for r in dead})
                    if not dead:
                        errors[-1] = f"{fn.__name__} outlasted {limit} s"
                    break
                continue
            (got if ok else errors)[rank] = out
            if errors:
                break
        if errors:
            self.close(kill=True)
            raise RuntimeError(f"{fn.__name__} failed on rank(s) "
                               f"{sorted(errors)}:\n" + "\n".join(
                                   f"--- rank {r}:\n{e}" for r, e in
                                   sorted(errors.items())))
        return [got[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        if not kill:
            for q, p in zip(self._tasks, self._procs):
                if p.is_alive():
                    q.put(None)
            for p in self._procs:
                p.join(timeout=60)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def spawn(fn: Callable, world: int, *, backend: str, devices: Sequence,
          args: tuple = (), timeout_s: float = 600.0,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` once on ``world`` new ranks (see
    :class:`RankPool`) and return the results in rank order."""
    with RankPool(world, backend=backend, devices=devices,
                  timeout_s=timeout_s, threads=threads) as pool:
        return pool.run(fn, *args)


# =============================================================================
# The launchers' mesh flags
# =============================================================================

def add_mesh_flags(ap, verb: str) -> None:
    """``--mesh``, ``--backend``, ``--devices`` and ``--launcher`` on the
    launcher's parser (``verb`` says what runs over the mesh)."""
    ap.add_argument("--mesh", default=None,
                    help=f"{verb} over a mesh of ranks: 'data,model' sizes "
                         f"(e.g. 2,2), or 'pod,data,model'")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="with --mesh: the torch.distributed backend")
    ap.add_argument("--devices", default=None,
                    help="with --mesh: the ranks' devices, one a rank or "
                         "one for all (e.g. cuda:0 or cuda:0,cuda:1,...)")
    ap.add_argument("--launcher", choices=("spawn", "env"),
                    default="spawn",
                    help="with --mesh: spawn the ranks here, or run as one "
                         "rank under torchrun (env://)")


def mesh_cli(args) -> Tuple[Tuple[int, ...], List[str], Optional[Mesh]]:
    """The mesh flags of ``args`` (``--mesh`` given): ``(shape, devices,
    mesh)``, ``devices`` one a rank.  Under ``--launcher spawn`` ``mesh``
    is None and the launcher spawns the ranks; under ``--launcher env``
    this process is torchrun's rank ``RANK``, initialized and bound to the
    mesh returned."""
    shape = tuple(int(v) for v in args.mesh.split(","))
    if len(shape) not in MESH_AXES:
        raise SystemExit(f"--mesh takes 2 or 3 sizes, got {args.mesh}")
    if args.backend is None or args.devices is None:
        raise SystemExit("--mesh needs --backend and --devices")
    world = math.prod(shape)
    devices = args.devices.split(",")
    if len(devices) == 1:
        devices = devices * world
    if args.launcher == "spawn":
        return shape, devices, None
    rank = int(os.environ["RANK"])
    if int(os.environ["WORLD_SIZE"]) != world:
        raise SystemExit(f"torchrun started {os.environ['WORLD_SIZE']} "
                         f"ranks; --mesh {args.mesh} needs {world}")
    dev = init_rank(rank, world, backend=args.backend, device=devices[rank],
                    init_method="env://")
    return shape, devices, make_mesh(shape, MESH_AXES[len(shape)],
                                     device=dev)
