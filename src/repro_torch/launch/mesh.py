"""Meshes of named axes over a ``torch.distributed`` process group, and an
SPMD runner.

The counterpart of ``repro.launch.mesh``: ``make_mesh``,
``make_production_mesh`` and ``dp_axes``.  A ``Mesh`` lays the default
group's ranks out row-major over its shape (rank r sits at
``numpy.unravel_index(r, shape)``, the last axis fastest, as
``jax.make_mesh`` orders its devices), and builds one process group for
every set of its axes, so that a collective over one axis, or over a tuple
such as ``("pod", "data")``, runs among the ranks that differ only there.
Every rank builds the same groups in the same order (``new_group`` is
collective over the world).  A shape whose product is not the world size
raises; nothing is reshaped.

``spmd(fn, shape, axes, device=, args=)`` runs ``fn(mesh, *args)`` on one
spawned process per rank and returns each rank's result as numpy;
``SpmdPool`` keeps the processes between calls, so that a test file pays
the spawn once.  Each call initialises a fresh process group through a
``file://`` store in a new temporary directory (no TCP port: many runners
may share a machine), on ``nccl`` for a CUDA device (one card per rank,
or it raises) and on ``gloo`` for ``"cpu"``; it never falls back from one
to the other.  Each rank runs one intra-op thread.  A rank's exception is
raised in the caller with that rank's traceback; a rank that does not
answer within the call's deadline (the process group's timeout bounds each
collective) has its pool killed, and the call raises.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device, tree


class Mesh:
    """Named axes over the default process group (see the module doc)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device=None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                             f"length or repeat an axis")
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised process group")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                             f"ranks, the process group {world}")
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.rank = dist.get_rank()
        self.coords = dict(zip(axes, (int(c) for c in
                                      np.unravel_index(self.rank, shape))))
        if device is None:
            device = (f"cuda:{torch.cuda.current_device()}"
                      if dist.get_backend() == "nccl" else "cpu")
        self.device = torch.device(device)
        self._groups = {}
        grid = np.arange(world).reshape(shape)
        for n in range(1, len(axes) + 1):
            for sub in itertools.combinations(range(len(axes)), n):
                rest = [i for i in range(len(axes)) if i not in sub]
                # the sub-axes last, in mesh order: one row per group
                rows = grid.transpose(rest + list(sub)).reshape(
                    -1, math.prod(shape[i] for i in sub))
                for row in rows:
                    g = dist.new_group([int(r) for r in row])
                    if self.rank in row:
                        self._groups[tuple(axes[i] for i in sub)] = g

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {axes} are not distinct axes of "
                             f"{self.axis_names} in mesh order")
        return axes

    def group(self, axes):
        """The process group of this rank along ``axes``."""
        return self._groups[self._key(axes)]

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def index(self, axes) -> int:
        """This rank's position along ``axes`` (the first axis major)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(shape: Sequence[int], axes: Optional[Sequence[str]] = None,
              device=None) -> Mesh:
    """A mesh of any shape (tests, reduced runs); ``axes`` default to the
    last ``len(shape)`` of ("pod", "data", "model")."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """("data", "model") = (16, 16), or ("pod", "data", "model") = (2, 16,
    16) with ``multi_pod``: the reference's production layouts, which need
    a process group of 256 or 512 ranks."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"), device)
    return Mesh((16, 16), ("data", "model"), device)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# Process groups and the SPMD runner
# ---------------------------------------------------------------------------

PG_TIMEOUT_S = 60           # each collective's bound inside a rank
RUN_TIMEOUT_S = 120         # a call's bound in the caller


@contextlib.contextmanager
def process_group(device, rank: int = 0, world: int = 1,
                  store: Optional[str] = None,
                  timeout_s: float = PG_TIMEOUT_S):
    """The default process group for the duration of the block: ``nccl``
    on a CUDA device (rank r on card r), ``gloo`` on the CPU, initialised
    through the ``file://`` store ``store`` (a fresh temporary file when
    None)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} NCCL ranks need {world} cards, "
                               f"found {torch.cuda.device_count()}")
        torch.cuda.set_device(rank)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    tmp = None
    if store is None:
        tmp = tempfile.mkdtemp(prefix="pg-")
        store = os.path.join(tmp, "store")
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _to_numpy(out):
    def one(leaf):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return leaf
    return tree.map(one, out)


def _rank_loop(rank: int, tasks, results) -> None:
    torch.set_num_threads(1)
    while True:
        item = tasks.get()
        if item is None:
            return
        fn, shape, axes, device, store, args, timeout_s = item
        try:
            with process_group(device, rank, math.prod(shape), store,
                               timeout_s):
                mesh = Mesh(shape, axes,
                            None if device == "cpu" else f"cuda:{rank}")
                out = _to_numpy(fn(mesh, *args))
            results.put((rank, True, out))
        except BaseException:                       # noqa: BLE001
            results.put((rank, False, traceback.format_exc()))


class SpmdPool:
    """``n`` spawned rank processes that run ``spmd`` calls of up to ``n``
    ranks, on the cards unless ``device`` is "cpu"; ``close`` (or the
    ``with`` block's end) stops them."""

    def __init__(self, n: int, device="cuda",
                 pg_timeout_s: float = PG_TIMEOUT_S):
        dev = resolve_device(device)
        if dev.type == "cuda" and torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} NCCL ranks need {n} cards, found "
                               f"{torch.cuda.device_count()}")
        self.n, self.device = n, dev.type
        self.pg_timeout_s = pg_timeout_s
        self._dir = tempfile.mkdtemp(prefix="spmd-")
        self._calls = 0
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_loop,
                                   args=(r, self._tasks[r], self._results),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, shape: Sequence[int], axes: Sequence[str],
            args: Sequence[Any] = (), timeout_s: float = RUN_TIMEOUT_S
            ) -> list:
        """``fn(mesh, *args)`` on ranks 0 .. prod(shape) − 1: their results
        (numpy where they were tensors), by rank."""
        if self._procs is None:
            raise RuntimeError("the pool is closed")
        world = math.prod(shape)
        if world > self.n:
            raise ValueError(f"mesh {tuple(shape)} needs {world} ranks, the "
                             f"pool holds {self.n}")
        store = os.path.join(self._dir, f"store{self._calls}")
        self._calls += 1
        for r in range(world):
            self._tasks[r].put((fn, tuple(shape), tuple(axes), self.device,
                                store, tuple(args), self.pg_timeout_s))
        out: Dict[int, Any] = {}
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout_s)
        while len(out) < world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, res = self._results.get(timeout=max(left, 0.01))
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(
                    f"spmd {getattr(fn, '__name__', fn)} on {tuple(shape)}: "
                    f"ranks {sorted(set(range(world)) - set(out))} gave no "
                    f"result in {timeout_s} s; the pool was killed") from None
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"spmd {getattr(fn, '__name__', fn)} on "
                                   f"{tuple(shape)}: rank {rank} "
                                   f"failed:\n{res}")
            out[rank] = res
        return [out[r] for r in range(world)]

    @property
    def closed(self) -> bool:
        return self._procs is None

    def close(self, kill: bool = False, join_s: float = 10.0) -> None:
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        if not kill:
            for q in self._tasks:
                q.put(None)
            for p in procs:
                p.join(join_s)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(join_s)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def spmd(fn: Callable, shape: Sequence[int], axes: Sequence[str], *,
         device="cuda", args: Sequence[Any] = (),
         timeout_s: float = RUN_TIMEOUT_S) -> list:
    """``fn(mesh, *args)`` on one spawned process per rank of ``shape``;
    each rank's result as numpy, by rank (see the module doc)."""
    with SpmdPool(math.prod(shape), device) as pool:
        return pool.run(fn, shape, axes, args, timeout_s)
