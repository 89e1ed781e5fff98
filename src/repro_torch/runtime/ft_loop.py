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
manifest.  The loop runs on one device: ``mesh`` (the sharded loop and
the orchestrator's elastic restart onto a smaller mesh) raises, and waits
for ROADMAP.md queue 1, item 17; the sharded train step and the elastic
restore themselves are in ``train.steps`` and ``train.checkpoint``.

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
from repro_torch.data.pipeline import TokenStream
from repro_torch.models.config import ArchConfig, ShapeConfig
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
    failure.  The driver recovers either way.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded FT loop and its elastic restart come with "
            "ROADMAP.md queue 1, item 17")
    t0 = time.time()
    dev = resolve_device(device)
    opt = optim_mod.make_optimizer(cfg.optimizer, lr=lr)
    stream = TokenStream(cfg, shape, seed=ft.seed, n_hosts=1, host_id=0)
    orch = Orchestrator(n_workers=1, heartbeat_timeout=1e9)
    step_fn = steps_mod.make_train_step(cfg, optimizer=opt)

    # incremental + async checkpointing: dirty-chunk writes on a background
    # thread; every restore below waits for in-flight saves to be durable
    # before reading, so recovery never races the writer
    ick = ckpt.IncrementalCheckpointer(
        ft.ckpt_dir, keep_n=ft.keep_n, full_every=ft.ckpt_full_every,
        max_pending=ft.ckpt_max_pending)
    try:
        # ---- init or resume
        start = ckpt.latest_step(ft.ckpt_dir)
        if start is None:
            state = steps_mod.init_train_state(
                cfg, torch.Generator().manual_seed(ft.seed), opt, device=dev)
            ick.save(0, state)
            start = 0
        else:
            start, state = ckpt.restore(ft.ckpt_dir, start, device=dev)

        losses: List[float] = []
        events: List[str] = []
        recoveries = 0
        replayed = 0
        step = start

        while step < n_steps:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.batch_at(step).items()}
            try:
                if fault_hook is not None:
                    maybe = fault_hook(step, state)
                    if maybe is not None:
                        state = maybe
                t_step = time.time()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                orch.heartbeat(0, step, time.time() - t_step)

                if _is_bad(loss, losses, ft.loss_spike_factor):
                    raise RuntimeError(f"corruption detected: loss={loss}")

                losses.append(loss)
                step += 1
                if step % ft.ckpt_every == 0:
                    ick.save(step, state)
            except (RuntimeError, FloatingPointError) as e:
                recoveries += 1
                events.append(f"step {step}: {e} → restore+replay")
                if recoveries > ft.max_recoveries:
                    raise RuntimeError(
                        f"exceeded max_recoveries={ft.max_recoveries}") from e
                ick.wait()                  # durability barrier before read
                last = ckpt.latest_step(ft.ckpt_dir)
                restored, state = ckpt.restore(ft.ckpt_dir, last, device=dev)
                # drop optimistic losses past the restore point, replay
                replayed += step - restored
                losses = losses[: restored - start]
                step = restored
    finally:
        ick.close()                         # flush pending writes, join

    return RunReport(losses=losses, recoveries=recoveries,
                     steps_replayed=replayed, wall_s=time.time() - t0,
                     events=events, ckpt_stats=dict(ick.stats))
