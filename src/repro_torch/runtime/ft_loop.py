"""Fault-tolerant training driver: the inject → detect → recover loop.

The counterpart of ``repro.runtime.ft_loop`` on one card:

    data pipeline (deterministic batch_at)        — data/pipeline.py
    train step                                    — train/steps.py
    checkpoint every K steps (incremental, async, — train/checkpoint.py
      crc32-chained; dirty chunks only)             (IncrementalCheckpointer)
    SEU injection (optional, for drills)          — core/fault_injection.py
    detection: loss NaN/spike                     — here
    recovery: restore last checkpoint + replay    — here

The reference's ``jax.jit(step_fn)`` is a plain call: PyTorch runs
eagerly.  Saves copy the state to host at once and persist on a background
writer; recovery calls ``wait()`` first so the restore reads a durable
manifest.

With ``mesh`` (a ``launch.mesh.Mesh``; every rank runs the loop) the step
runs under ``ShardCtx(mesh, dp, "model")``, dp being every other axis; the
state is this rank's shards under ``train_state_specs`` (cut from the
same initial draw as the unsharded loop's), each step's batch this rank's
slice (``shard_batch``), and saves and restores go through the sharded
checkpointer (rank 0 writes) onto the same mesh.  Every rank must take
the same branch: a fault that ``fault_hook`` raises on one rank is made
known to all by one MAX all-reduce of a flag before each step, so that no
rank is left in a collective its peers skipped; the loss is global, so
the corruption check agrees by itself.  Like the reference's loop, it
restores onto the same mesh (no elastic restart).

Determinism contract: batch ``i`` is a pure function of (seed, i), and
every operation of the step is deterministic on the card (the hand
kernels reduce in a fixed order with no atomics; ``models/transformer``
says what else), so a restore at step s replays steps [s, crash) on
identical data and the loss curve after recovery is bit-identical to a run
that never crashed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.pipeline import TokenStream, shard_batch
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.shard import ShardCtx
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import shard_tree
from repro_torch.runtime.orchestrator import Orchestrator
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim as optim_mod
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    keep_n: int = 2
    loss_spike_factor: float = 10.0   # recovery trigger: loss > factor×median
    max_recoveries: int = 8
    seed: int = 0
    # incremental-checkpointer knobs: rebase cadence bounds manifest-chain
    # length; max_pending bounds how far durable state may trail the loop
    ckpt_full_every: int = 8
    ckpt_max_pending: int = 2


@dataclasses.dataclass
class RunReport:
    losses: List[float]
    recoveries: int
    steps_replayed: int
    wall_s: float
    events: List[str]
    ckpt_stats: Dict[str, int] = dataclasses.field(default_factory=dict)


def _is_bad(loss: float, history: List[float], factor: float) -> bool:
    if not np.isfinite(loss):
        return True
    if len(history) >= 8:
        med = float(np.median(history[-8:]))
        if loss > factor * max(med, 1e-6):
            return True
    return False


def run(cfg: ArchConfig, shape: ShapeConfig, ft: FTConfig,
        n_steps: int = 100,
        fault_hook: Optional[Callable[[int, Any], Any]] = None,
        lr: float = 3e-4, device="cuda", mesh=None) -> RunReport:
    """Train ``n_steps`` on ``device``; survive faults injected by
    ``fault_hook``.

    fault_hook(step, state) -> state | None: may corrupt the state (SEU
    drill) or raise ``RuntimeError("node lost")`` to simulate a device
    failure.  The driver recovers either way.  With ``mesh`` the state is
    on the mesh's device and ``device`` is not used.
    """
    t0 = time.time()
    dev = resolve_device(device) if mesh is None else mesh.device
    opt = optim_mod.make_optimizer(cfg.optimizer, lr=lr)
    stream = TokenStream(cfg, shape, seed=ft.seed, n_hosts=1, host_id=0)
    orch = Orchestrator(n_workers=1, heartbeat_timeout=1e9)
    ctx, shard = None, {}          # shard: the checkpoints' mesh= specs=
    if mesh is not None:
        dp = tuple(a for a in mesh.axis_names if a != "model")
        ctx = ShardCtx(mesh, dp, "model")
        shard = {"mesh": mesh, "specs": steps_mod.train_state_specs(
            cfg, steps_mod.abstract_train_state(cfg, opt).params, dp,
            "model", cfg.optimizer, mesh)}
    step_fn = steps_mod.make_train_step(cfg, ctx, optimizer=opt)

    def batch_at(step):
        host = stream.batch_at(step)
        if mesh is None:
            return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        return shard_batch(host, mesh, ctx.dp)

    def restore(step):
        return ckpt.restore(ft.ckpt_dir, step, device=dev, **shard)

    def agreed(err) -> bool:
        """Whether any rank failed before this step (the flag's MAX)."""
        if mesh is None:
            return err is not None
        flag = torch.tensor([float(err is not None)], device=dev)
        return bool(C.all_reduce(flag, mesh, mesh.axis_names, op="max"))

    def agreed_step(found: Optional[int]) -> Optional[int]:
        """The checkpoint step every rank takes: the newest that any rank
        found in the directory (None where none did).  Rank 0 alone
        writes checkpoints, from a background thread, so ranks that read
        the directory at different moments can find different steps (a
        rank that starts late finds the step-0 save its peers are still
        gathering for, and would skip the gathers they wait in); each rank
        reads before this all-reduce, and rank 0 writes again only after
        it."""
        if mesh is None:
            return found
        newest = torch.tensor([-1 if found is None else found],
                              dtype=torch.int64, device=dev)
        newest = int(C.all_reduce(newest, mesh, mesh.axis_names, op="max"))
        return None if newest < 0 else newest

    # incremental + async checkpointing: dirty-chunk writes on a background
    # thread; every restore below waits for in-flight saves to be durable
    # before reading, so recovery never races the writer
    ick = ckpt.IncrementalCheckpointer(
        ft.ckpt_dir, keep_n=ft.keep_n, full_every=ft.ckpt_full_every,
        max_pending=ft.ckpt_max_pending)
    try:
        # ---- init or resume
        start = agreed_step(ckpt.latest_step(ft.ckpt_dir))
        if start is None:
            # the unsharded loop's draw (a CPU generator), cut into shards
            state = steps_mod.init_train_state(
                cfg, torch.Generator().manual_seed(ft.seed), opt,
                device=dev if mesh is None else "cpu")
            if mesh is not None:
                state = shard_tree(state, shard["specs"], mesh)
            ick.save(0, state, **shard)
            start = 0
        else:
            start, state = restore(start)

        losses: List[float] = []
        events: List[str] = []
        recoveries = 0
        replayed = 0
        step = start

        while step < n_steps:
            batch = batch_at(step)
            try:
                err = None
                if fault_hook is not None:
                    try:
                        maybe = fault_hook(step, state)
                        if maybe is not None:
                            state = maybe
                    except (RuntimeError, FloatingPointError) as e:
                        err = e
                if agreed(err):
                    raise err or RuntimeError("a peer rank failed")
                t_step = time.time()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                orch.heartbeat(0, step, time.time() - t_step)

                if _is_bad(loss, losses, ft.loss_spike_factor):
                    raise RuntimeError(f"corruption detected: loss={loss}")

                losses.append(loss)
                step += 1
                if step % ft.ckpt_every == 0:
                    ick.save(step, state, **shard)
            except (RuntimeError, FloatingPointError) as e:
                recoveries += 1
                events.append(f"step {step}: {e} → restore+replay")
                if recoveries > ft.max_recoveries:
                    raise RuntimeError(
                        f"exceeded max_recoveries={ft.max_recoveries}") from e
                ick.wait()                  # durability barrier before read
                restored, state = restore(
                    agreed_step(ckpt.latest_step(ft.ckpt_dir)))
                # drop optimistic losses past the restore point, replay
                replayed += step - restored
                losses = losses[: restored - start]
                step = restored
    finally:
        ick.close()                         # flush pending writes, join

    return RunReport(losses=losses, recoveries=recoveries,
                     steps_replayed=replayed, wall_s=time.time() - t0,
                     events=events, ckpt_stats=dict(ick.stats))
