"""Cluster orchestration — the RTG4 analogue at fleet scale.

A copy of ``repro.runtime.orchestrator`` (pure Python, no framework).

In the paper, the RTG4 "acts as the main orchestrator for HPDP operations":
it dispatches work to the co-processor, watches execution, and decides where
outputs flow next.  At 1000-node scale the same role is a control plane that

  * tracks worker health via **heartbeats** (here: wall-clock step reports),
  * flags **stragglers** (step time > k × running median) and dispatches
    backup work (speculative re-execution — the classic MapReduce remedy),
  * drives **elastic restart**: when a worker is lost, choose the largest
    healthy mesh that the workload still fits, and hand the training driver
    a (new_mesh, restore_step) plan; checkpoint/restore does the rest.

The implementation is deliberately runnable single-process (simulated
workers driven by tests/examples) while keeping the exact decision logic a
real fleet controller needs — the policy is the contribution, the transport
(gRPC vs in-process calls) is not.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class WorkerState:
    uid: int
    last_heartbeat: float = 0.0
    last_step: int = -1
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True
    straggler: bool = False


@dataclasses.dataclass
class ElasticPlan:
    """What the training driver should do after a failure."""
    new_world_size: int
    new_mesh_shape: Tuple[int, ...]
    restore_step: int
    reason: str


class Orchestrator:
    def __init__(self, n_workers: int, heartbeat_timeout: float = 10.0,
                 straggler_factor: float = 3.0, min_history: int = 4):
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(uid=i) for i in range(n_workers)}
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.min_history = min_history
        self.events: List[str] = []

    # ------------------------------------------------------------ reporting
    def heartbeat(self, uid: int, step: int, step_time: float,
                  now: Optional[float] = None):
        w = self.workers[uid]
        w.last_heartbeat = now if now is not None else time.time()
        w.last_step = step
        w.step_times.append(step_time)
        if len(w.step_times) > 64:
            w.step_times = w.step_times[-64:]

    # ------------------------------------------------------------- policies
    def check_health(self, now: Optional[float] = None) -> List[int]:
        """Mark workers dead on heartbeat timeout; returns newly-dead uids."""
        now = now if now is not None else time.time()
        dead = []
        for w in self.workers.values():
            if w.alive and now - w.last_heartbeat > self.heartbeat_timeout:
                w.alive = False
                dead.append(w.uid)
                self.events.append(f"worker {w.uid} declared dead at {now:.1f}")
        return dead

    def detect_stragglers(self) -> List[int]:
        """Step time > factor × cluster median ⇒ straggler.

        The remedy at fleet scale is backup-task dispatch: the returned uids'
        current shards are re-queued on healthy spares; first finisher wins
        (determinism is preserved because both compute the same reduction).
        """
        times = [w.step_times[-1] for w in self.workers.values()
                 if w.alive and len(w.step_times) >= self.min_history]
        if len(times) < 2:
            return []
        med = statistics.median(times)
        out = []
        for w in self.workers.values():
            if not w.alive or len(w.step_times) < self.min_history:
                continue
            w.straggler = w.step_times[-1] > self.straggler_factor * med
            if w.straggler:
                out.append(w.uid)
                self.events.append(
                    f"worker {w.uid} straggling "
                    f"({w.step_times[-1]:.3f}s vs median {med:.3f}s)")
        return out

    def alive_count(self) -> int:
        return sum(w.alive for w in self.workers.values())

    # ---------------------------------------------------------- elasticity
    def elastic_plan(self, checkpointed_step: int,
                     model_axis: int = 16) -> ElasticPlan:
        """Largest (data × model_axis) mesh that fits the survivors.

        Keeps the model axis intact (TP degree is a property of the
        checkpointed layout; changing it is a reshard, which restore()
        supports but costs more) and shrinks the data axis to the largest
        power-of-two that fits.
        """
        alive = self.alive_count()
        data_axis = max(1, 2 ** int(math.log2(max(alive // model_axis, 1))))
        world = data_axis * model_axis
        return ElasticPlan(
            new_world_size=world,
            new_mesh_shape=(data_axis, model_axis),
            restore_step=checkpointed_step,
            reason=f"{alive}/{len(self.workers)} workers alive → "
                   f"mesh ({data_axis}, {model_axis})",
        )

    def progress(self) -> Dict[str, float]:
        steps = [w.last_step for w in self.workers.values() if w.alive]
        return {
            "min_step": min(steps) if steps else -1,
            "max_step": max(steps) if steps else -1,
            "alive": self.alive_count(),
        }
