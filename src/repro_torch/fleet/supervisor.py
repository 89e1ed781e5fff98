"""Fleet supervision: heartbeats, stragglers, scrubbing, and recovery.

The counterpart of ``repro.fleet.supervisor``; every restore names the
replica's device (``train/checkpoint`` defaults to the card), so a
recovered replica serves from where it served before.

The supervisor is the fleet's RTG4: it never touches a token itself, it
watches the replicas that do.  Health tracking reuses the training
``Orchestrator`` policies verbatim (heartbeat timeout ⇒ dead, step time
vs cluster median ⇒ straggler) with the fleet's deterministic tick counter
as the clock, so verdicts replay bit-exactly under campaign seeds.

On top of health it owns the two dependability duties the serving layer
needs:

  * **scrub** — verify a replica's live weights against the deploy-time
    ABFT storage checksums (``core.abft.storage_checksums``); any mismatch
    is a detected weight-SEU.
  * **recover** — drive the quarantine → restore → re-verify → readmit
    state machine for a replica whose scrub failed.  Recovery is
    *incremental first*: the scrub verdict names exactly which tensors are
    corrupted, so the supervisor re-reads only those leaves from the golden
    checkpoint (``train/checkpoint.restore_leaves``, crc32-verified) and
    patches them in — a full reload is the fallback, not the default.
    Every recovery is wall-clock timed into ``FleetMetrics`` (the paper's
    recovery-time argument needs a measured number, not a story).
    Re-verification scrubs the restored weights before the replica serves
    again; a replica that cannot be re-verified is DEAD.
"""
from __future__ import annotations

import time
from typing import List, Optional

from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.replica import Replica, ReplicaState
from repro_torch.runtime.orchestrator import Orchestrator
from repro_torch.train import checkpoint as ckpt_mod


class Supervisor:
    def __init__(self, n_replicas: int, *, scrub_every: int = 8,
                 heartbeat_timeout: float = 25.0,
                 straggler_factor: float = 3.0):
        self.n_replicas = n_replicas
        self.scrub_every = scrub_every
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.orch = Orchestrator(n_replicas,
                                 heartbeat_timeout=heartbeat_timeout,
                                 straggler_factor=straggler_factor)
        self.events: List[str] = self.orch.events   # one shared event log
        # structured dependability event log (obs.EventLog) — the
        # fleet installs its own so supervisor verdicts carry provenance;
        # None keeps the supervisor usable standalone
        self.event_log = None

    def _emit(self, kind: str, tick: int, **fields):
        if self.event_log is not None:
            self.event_log.emit(kind, tick=tick, **fields)

    def reset(self):
        self.orch = Orchestrator(self.n_replicas,
                                 heartbeat_timeout=self.heartbeat_timeout,
                                 straggler_factor=self.straggler_factor)
        self.events = self.orch.events

    # ------------------------------------------------------------ heartbeats
    def heartbeat(self, rid: int, step: int, step_time: float, tick: int):
        self.orch.heartbeat(rid, step, step_time, now=float(tick))

    def newly_dead(self, tick: int) -> List[int]:
        """Replica uids whose heartbeats stopped (timeout in ticks)."""
        return self.orch.check_health(now=float(tick))

    def stragglers(self) -> List[int]:
        return self.orch.detect_stragglers()

    # ---------------------------------------------------------------- scrub
    def due_for_scrub(self, tick: int) -> bool:
        return self.scrub_every > 0 and tick % self.scrub_every == 0

    def scrub(self, replica: Replica, metrics: FleetMetrics,
              tick: int) -> bool:
        """Weight-integrity check; returns True when clean."""
        metrics.scrubs += 1
        bad = replica.scrub()
        if bad:
            metrics.detections += 1
            self.events.append(
                f"tick {tick}: replica {replica.rid} scrub FAILED "
                f"({len(bad)} corrupted leaves, e.g. {bad[0]})")
            self._emit("detection", tick, site="weights",
                       replica=replica.rid,
                       detail={"check": "storage_scrub",
                               "leaves": len(bad)})
            return False
        replica.last_clean_scrub_tick = tick
        return True

    # ------------------------------------------------------------- recovery
    def _full_reload(self, replica: Replica, ckpt_dir,
                     step: Optional[int] = None) -> None:
        _, params = ckpt_mod.restore(ckpt_dir, step,  # crc32-verified read
                                     device=replica.device)
        replica.reload(params)

    def recover(self, replica: Replica, ckpt_dir, metrics: FleetMetrics,
                tick: int, step: Optional[int] = None) -> bool:
        """quarantine → restore → re-verify → readmit.  Returns True when
        the replica is HEALTHY again; on any failure it is left DEAD.

        The restore is incremental when the scrub verdict
        (``replica.last_scrub_bad``) names the corrupted leaves: only those
        are re-read from the golden checkpoint and patched in.  If the
        partial restore cannot cover the verdict, or re-verification still
        fails afterwards (e.g. the corruption moved while we restored), the
        supervisor escalates to a full reload before giving up.

        ``step`` pins which checkpoint step is golden — after a rolling
        deploy the fleet's current step moves, and recovering a replica
        from an older step would re-verify against the wrong checksums."""
        t0 = time.perf_counter()
        replica.state = ReplicaState.QUARANTINED
        self.events.append(f"tick {tick}: replica {replica.rid} quarantined")
        self._emit("quarantine", tick, replica=replica.rid)
        replica.state = ReplicaState.RECOVERING
        bad = list(replica.last_scrub_bad)
        incremental = False
        try:
            if bad:
                leaves = ckpt_mod.restore_leaves(ckpt_dir, bad, step=step,
                                                 device=replica.device)
                if set(leaves) == set(bad):
                    replica.reload_leaves(leaves)
                    incremental = True
            if not incremental:
                self._full_reload(replica, ckpt_dir, step)
        except Exception as e:                        # noqa: BLE001
            replica.state = ReplicaState.DEAD
            metrics.replicas_lost += 1
            self.events.append(
                f"tick {tick}: replica {replica.rid} DEAD "
                f"(checkpoint restore failed: {e})")
            self._emit("replica_dead", tick, replica=replica.rid,
                       detail={"reason": "restore_failed"})
            return False
        still_bad = replica.scrub()
        if still_bad and incremental:
            # partial restore did not satisfy the re-verify — escalate
            self.events.append(
                f"tick {tick}: replica {replica.rid} incremental restore "
                f"insufficient ({len(still_bad)} leaves still dirty); "
                f"falling back to full reload")
            incremental = False
            try:
                self._full_reload(replica, ckpt_dir, step)
            except Exception as e:                    # noqa: BLE001
                replica.state = ReplicaState.DEAD
                metrics.replicas_lost += 1
                self.events.append(
                    f"tick {tick}: replica {replica.rid} DEAD "
                    f"(fallback reload failed: {e})")
                self._emit("replica_dead", tick, replica=replica.rid,
                           detail={"reason": "fallback_reload_failed"})
                return False
            still_bad = replica.scrub()
        if still_bad:
            replica.state = ReplicaState.DEAD
            metrics.replicas_lost += 1
            self.events.append(
                f"tick {tick}: replica {replica.rid} DEAD "
                f"(re-verify failed after restore)")
            self._emit("replica_dead", tick, replica=replica.rid,
                       detail={"reason": "reverify_failed"})
            return False
        seconds = time.perf_counter() - t0
        replica.state = ReplicaState.HEALTHY
        replica.routable = True
        replica.last_clean_scrub_tick = tick
        replica.recoveries += 1
        metrics.recoveries += 1
        metrics.observe_recovery(seconds, leaves=len(bad),
                                 incremental=incremental)
        self._emit("recovery", tick, site="weights", replica=replica.rid,
                   seconds=seconds,
                   detail={"incremental": incremental, "leaves": len(bad)})
        how = (f"incremental restore of {len(bad)} leaves" if incremental
               else "full reload")
        self.events.append(
            f"tick {tick}: replica {replica.rid} readmitted "
            f"({how} + re-verify ok, {seconds * 1e3:.1f} ms)")
        return True
