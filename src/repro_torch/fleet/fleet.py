"""Multi-replica dependable serving — the repo's "dependable service" layer.

The counterpart of ``repro.fleet.fleet``: the same state machine, event
log and metrics, over the port's ``Engine``.  A fleet lives on the device of
its params (``params["embed"]``); every restore, reload and patch lands on
its replica's device, and proc-transport workers build on the device the
fleet names in their init frame, after the parent has built the CUDA
kernels their engines launch.

The paper's system property — orchestrator watches, co-processor computes,
faults never corrupt the output stream — promoted from a single ``Engine``
to a supervised fleet of N of them:

    client ──▶ Router (hash / least-loaded, admission, deadlines)
                  │ assigns
                  ▼
        ┌──── Replica 0 ── Engine ────┐
        │     Replica 1 ── Engine     │──▶ certified output stream
        │         …                   │
        └── Replica N-1 ── Engine ────┘
                  ▲ scrubs / heartbeats / recovery
              Supervisor (Orchestrator policies + ABFT storage checksums
                          + checkpoint reload)

The dependability contract is **certify-before-release**, and since the
engine became a staged dataflow pipeline (runtime/dataflow.py) it is
enforced *inside each engine's certify stage*: the fleet installs a
release-gate hook (``_certify_finished``) into every replica's pipeline, so
a finished request is withheld at the certify stage — not by fleet code
wrapped around a monolithic step loop —

  * ``Policy.NONE``  release immediately (the undefended baseline campaigns
    measure SDC against);
  * ``Policy.ABFT``  release only after the serving replica passes a weight
    scrub dated *after* the request finished.  A failed scrub recalls every
    uncertified request and replays it on a verified replica, so a weight
    SEU can delay tokens but never ship them wrong.  Lost work is bounded
    by scrub_every × capacity tokens per replica.
  * ``Policy.DMR``   every request is decoded twice on distinct replicas
    (primary + shadow); bit-identical streams release immediately, any
    disagreement is detected, attributed by scrubbing both replicas
    (corrupted one recovers via checkpoint reload), and the request replays
    on a clean replica.  Catches *transient* compute/state faults the
    weight scrub cannot see, at 2× decode cost.
  * ``Policy.CKPT``  checkpoint/restart as the primary strategy: ABFT's
    certify-before-release weight scrubs, plus decode-state scrubbing with
    engine snapshot *rollback* — a transient SEU in the KV cache or token
    buffer is detected by checksum and healed by replaying at most
    ``snapshot_every`` steps in place, no failover needed.  ABFT fleets
    run the same decode-state scrub in detect-only mode (transient-site
    coverage the ROADMAP called for) and recover by drain + failover.

Quarantine-recovery (any policy) is *incremental first*: the scrub verdict
names the corrupted tensors and the supervisor restores exactly those
leaves from the golden checkpoint, timing every recovery into the metrics
(``recovery_mean_seconds``, ``incremental_restores`` vs ``full_reloads``).

Failover is deterministic: greedy decode is a pure function of (params,
prompt) and the engine's continuous batching is composition-independent, so
a replayed request reproduces its tokens bit-exactly on any clean replica —
the property the campaign workload certifies statistically.

Everything advances on an integer ``tick`` (one engine step per healthy
replica) and every decision is a pure function of fleet state, so a trial
replays bit-for-bit from its seed.

Two orthogonal capabilities ride on that contract (docs/multihost.md):

  * ``transport="proc"`` runs every replica's engine in a spawned worker
    process behind ``fleet/transport.py`` — same Fleet/Supervisor/Router
    code, real process isolation, token streams bit-identical to inproc.
    A dead worker (SIGKILL, crash, missed RPC deadline) takes the same
    quarantine → restore → re-verify → replay path a failed scrub does.
  * The supervisor's straggler verdicts drive **speculative backup
    dispatch**: a straggler's in-flight requests are re-issued to a warm
    spare, the first finisher wins, and the loser's copy is cancelled at
    release — certify-before-release applies to whichever copy wins.
  * ``Fleet.deploy`` performs **zero-drain rolling weight deploys**: one
    replica at a time leaves the router (still decoding what it owns),
    has the changed leaves patched into its live engine, re-verifies
    against the *new* storage checksums, and rejoins — the fleet serves
    throughout, and a strike landing mid-swap is caught by the re-verify.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch import tree
from repro_torch.core import abft
from repro_torch.core.dependability import Policy
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.replica import Replica, ReplicaState
from repro_torch.fleet.router import Router
from repro_torch.fleet.supervisor import Supervisor
from repro_torch.fleet.transport import TransportDead
from repro_torch.models.config import ArchConfig
from repro_torch.obs import EventLog
from repro_torch.runtime.serving import Request
from repro_torch.train import checkpoint as ckpt_mod

TRANSPORTS = ("inproc", "proc")

FLEET_POLICIES = (Policy.NONE, Policy.ABFT, Policy.DMR, Policy.CKPT)

# policies whose release gate is the weight-scrub certification loop
_SCRUB_GATED = (Policy.ABFT, Policy.CKPT)


def _state_scrub_mode(policy: Policy) -> str:
    """Engine decode-state scrub mode per fleet policy: CKPT rolls back in
    place (engine-local checkpoint/restart), ABFT detects and lets the
    fleet drain + fail over, NONE/DMR leave the scrub off (DMR's pair
    comparison is its transient detector)."""
    if policy == Policy.CKPT:
        return "rollback"
    if policy == Policy.ABFT:
        return "detect"
    return "off"


def _sums_by_path(checks) -> Dict[str, int]:
    """Storage checksums by manifest path, in one host readback."""
    flat = tree.leaves_with_paths(checks)
    if not flat:
        return {}
    vals = torch.stack([v for _, v in flat]).cpu().tolist()
    return {ckpt_mod.path_str(p): v for (p, _), v in zip(flat, vals)}


def _build_kernels(cfg: ArchConfig) -> None:
    """Build the CUDA kernels a replica's engine launches, before any worker
    is spawned: the workers then load the built libraries instead of each
    running ``nvcc`` inside its ready deadline."""
    if cfg.quant == "w8a8_ffn":
        from repro_torch.kernels.qmatmul import kernel as MK
        MK.build()
    if cfg.attn_impl == "flash":
        from repro_torch.kernels.flashattn import kernel as FK
        FK.build()


@dataclasses.dataclass
class _Tracked:
    """Fleet-side lifecycle record for one submitted request."""
    req: Request                      # the caller's object (primary copy)
    shadow: Optional[Request]         # DMR twin, served on a different replica
    primary_rid: int
    shadow_rid: int = -1
    backup: Optional[Request] = None  # speculative copy on a warm spare
    backup_rid: int = -1
    submitted_tick: int = 0
    deadline_ticks: Optional[int] = None
    primary_done: bool = False
    shadow_done: bool = False
    replays: int = 0
    released: bool = False
    expired: bool = False
    failed: bool = False

    @property
    def terminal(self) -> bool:
        return self.released or self.expired or self.failed


class Fleet:
    MAX_REPLAYS = 3

    def __init__(self, cfg: ArchConfig, params, n_replicas: int = 2, *,
                 policy: Policy = Policy.ABFT, router: str = "least_loaded",
                 admit_limit: Optional[int] = None, scrub_every: int = 4,
                 capacity: int = 4, max_len: int = 128, prefill_pad: int = 8,
                 snapshot_every: int = 16, eos_id: int = -1,
                 heartbeat_timeout: float = 25.0, ckpt_dir: Optional[str] = None,
                 backend: Optional[str] = None, policy_map=None,
                 transport: str = "inproc"):
        # per-site selective hardening for every replica's in-graph hot
        # paths (core/policy_map.py; PolicyMap | JSON doc/text/path).  Baked
        # into cfg so all replicas — including proc-transport workers, which
        # receive the config as a JSON doc — run the same mapped program.
        # The fleet keeps its own scrub orchestration (certify-before-release
        # weight scrubs, decode-state scrub modes) driven by ``policy``;
        # the map governs the op-level policies inside each engine.
        from repro_torch.models import api as _model_api
        cfg = _model_api.with_policy_map(cfg, policy_map)
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; "
                             f"known: {TRANSPORTS}")
        if policy not in FLEET_POLICIES:
            raise ValueError(
                f"fleet policy must be one of {[p.value for p in FLEET_POLICIES]}"
                f" (TMR at fleet scale is three engines + vote; use DMR + "
                f"failover, the 2× alternative this fleet implements)")
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.cfg = cfg
        self.policy = policy
        self.scrub_every = scrub_every
        self.transport = transport
        self.device = params["embed"].device

        # golden state: checkpoint for reload-recovery, checksums for scrub
        self._params0 = params
        self._owns_ckpt_dir = ckpt_dir is None
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="fleet-golden-")
        ckpt_mod.save(self.ckpt_dir, 0, params)
        self._current_step = 0      # the checkpoint step replicas serve from

        # every replica serves on the same execution backend: bit-identical
        # failover (the fleet's core guarantee) holds *across* backends too,
        # but certify-before-release compares like for like within a fleet
        scrub_mode = _state_scrub_mode(policy)
        if transport == "proc":
            # each replica's engine lives in a spawned worker process; the
            # workers restore the golden checkpoint themselves (crc32-
            # verified, so byte-identical to ``params``) onto the fleet's
            # device and start in parallel — spawn all first, then wait on
            # each
            from repro_torch.fleet.transport import ProcReplica
            if self.device.type == "cuda":
                _build_kernels(cfg)
            self.replicas: List[Replica] = [
                ProcReplica(i, cfg, ckpt_dir=self.ckpt_dir, step=0,
                            device=str(self.device),
                            capacity=capacity, max_len=max_len,
                            prefill_pad=prefill_pad,
                            snapshot_every=snapshot_every, eos_id=eos_id,
                            backend=backend, state_scrub=scrub_mode)
                for i in range(n_replicas)]
            for r in self.replicas:
                r.wait_ready()
            self._golden0 = abft.storage_checksums(params)
        else:
            first = Replica(0, cfg, params, capacity=capacity,
                            max_len=max_len, prefill_pad=prefill_pad,
                            snapshot_every=snapshot_every,
                            eos_id=eos_id, backend=backend,
                            state_scrub=scrub_mode)
            self.replicas = [first] + [
                Replica(i, cfg, params, capacity=capacity, max_len=max_len,
                        prefill_pad=prefill_pad,
                        snapshot_every=snapshot_every,
                        eos_id=eos_id, golden=first.golden,
                        compiled=first.engine.compiled, backend=backend,
                        state_scrub=scrub_mode)
                for i in range(1, n_replicas)]
            self._golden0 = first.golden
        # the fleet's release gate runs inside each engine's certify stage;
        # ckpt_step pins which checkpoint step each replica's golden
        # checksums correspond to (it moves per-replica during a rolling
        # deploy, so recovery always restores what the replica certifies)
        for r in self.replicas:
            r.install_certifier(self._certify_finished)
            r.ckpt_step = 0
        self.router = Router(router, admit_limit)
        self.supervisor = Supervisor(n_replicas, scrub_every=scrub_every,
                                     heartbeat_timeout=heartbeat_timeout)
        self.metrics = FleetMetrics(
            lost_work_bound_tokens=scrub_every * capacity)
        # structured dependability event log on the fleet tick clock; the
        # supervisor shares it so scrub/recovery verdicts carry provenance.
        # Replica engines do NOT share it — their pump-cycle clock differs
        # from the fleet tick, and mixing clocks would corrupt timeline
        # latencies; engine-level verdicts reach this log via
        # _settle_state_events (stamped with the fleet tick).
        self.event_log = EventLog(policy=policy.value)
        self.supervisor.event_log = self.event_log
        self.tick_no = 0
        self.records: Dict[int, _Tracked] = {}
        self.released: Dict[int, Request] = {}

    # ------------------------------------------------------------ admission
    def submit(self, req: Request,
               deadline_ticks: Optional[int] = None) -> bool:
        """Route a request into the fleet; False == rejected (admission
        control or no healthy replica)."""
        if req.uid in self.records:
            raise ValueError(f"duplicate request uid {req.uid}")
        self.metrics.submitted += 1
        primary = self.router.pick(req.uid, self.replicas)
        if primary is None:
            self.metrics.rejected += 1
            return False
        rec = _Tracked(req=req, shadow=None, primary_rid=primary.rid,
                       submitted_tick=self.tick_no,
                       deadline_ticks=deadline_ticks)
        if self.policy == Policy.DMR:
            self._place_shadow(rec)
        primary.engine.submit(req)
        self.records[req.uid] = rec
        return True

    def _place_shadow(self, rec: _Tracked):
        """DMR twin placement: a copy of the request on a healthy replica
        other than the primary.  With no second healthy replica the request
        serves undoubled (degraded DMR: release on finish, logged)."""
        shadow_replica = self.router.pick(rec.req.uid, self.replicas,
                                          exclude=(rec.primary_rid,))
        if shadow_replica is None:
            rec.shadow = None
            rec.shadow_rid = -1
            self.supervisor.events.append(
                f"tick {self.tick_no}: uid {rec.req.uid} served without "
                f"shadow (no second healthy replica)")
            return
        rec.shadow = Request(uid=rec.req.uid, prompt=list(rec.req.prompt),
                             max_new_tokens=rec.req.max_new_tokens)
        rec.shadow_rid = shadow_replica.rid
        shadow_replica.engine.submit(rec.shadow)

    # ----------------------------------------------------------- tick loop
    def tick(self):
        """One fleet scheduling round: step every healthy engine (each step
        pumps the replica's admit→…→release pipeline once, with the fleet's
        release gate live in the certify stage), heartbeat, scrub on
        cadence, expire deadlines."""
        self.tick_no += 1
        self.metrics.ticks += 1
        for r in self.replicas:
            if r.state is not ReplicaState.HEALTHY or r.paused:
                continue
            t0 = time.perf_counter()
            try:
                r.engine.step()
            except TransportDead:
                self._recover_transport(r)
                continue
            self.metrics.engine_steps += 1
            # for the proc transport the step time is the RPC round trip —
            # a worker fighting its host shows up as a straggler naturally
            self.supervisor.heartbeat(r.rid, r.engine.stats.steps,
                                      time.perf_counter() - t0, self.tick_no)
            self._settle_state_events(r)
        stragglers = self.supervisor.stragglers()
        if stragglers:
            self._dispatch_backups(stragglers)

        for rid in self.supervisor.newly_dead(self.tick_no):
            r = self.replicas[rid]
            if r.state is ReplicaState.HEALTHY:
                self._fail_replica(r, reason="heartbeat timeout",
                                   recover=False)

        if self.policy in _SCRUB_GATED and self.supervisor.due_for_scrub(
                self.tick_no):
            for r in self.replicas:
                if r.state is ReplicaState.HEALTHY:
                    self._scrub_and_settle(r)

        self._expire_deadlines()

    # ------------------------------------------------- decode-state scrubs
    def _settle_state_events(self, replica: Replica):
        """Fold the engine's decode-state scrub verdicts into fleet metrics
        and finish the recovery the engine could not do alone: a CKPT
        engine already rolled back (we only account it); a detect-only
        (ABFT) engine — or a rollback that found its snapshot corrupted —
        needs the fleet to drain the replica's work, clear its decode
        state, and replay on verified replicas."""
        for ev in replica.engine.drain_state_events():
            self.metrics.detections += 1
            self.metrics.state_scrub_detections += 1
            action = (f"rolled back {ev['steps_replayed']} steps"
                      if ev["recovered"] else "drain + replay")
            self.supervisor.events.append(
                f"tick {self.tick_no}: replica {replica.rid} decode-state "
                f"scrub detected corruption ({action})")
            self.event_log.emit(
                "detection", tick=self.tick_no, site="decode_state",
                replica=replica.rid, detail={"check": "state_scrub"})
            if ev["recovered"]:
                self.metrics.observe_recovery(ev["seconds"], rollback=True)
                self.event_log.emit(
                    "rollback", tick=self.tick_no, site="decode_state",
                    replica=replica.rid, seconds=ev["seconds"],
                    detail={"steps_replayed": ev["steps_replayed"]})
                continue
            t0 = time.perf_counter()
            drained = replica.in_flight() + replica.uncertified
            replica.uncertified = []
            # weights are untouched by a state SEU: a run-state reset (not a
            # quarantine) makes the replica clean again
            replica.engine.reset()
            seconds = time.perf_counter() - t0
            self.metrics.recovery_seconds.observe(seconds)
            self.metrics.state_drains += 1
            self.event_log.emit(
                "recovery", tick=self.tick_no, site="decode_state",
                replica=replica.rid, seconds=seconds,
                detail={"action": "drain_replay", "drained": len(drained)})
            for req in drained:
                rec = self.records.get(req.uid)
                if rec is not None and not rec.terminal:
                    self._replay(rec)

    def run(self, max_ticks: int = 100_000) -> FleetMetrics:
        """Serve until every submitted request reaches a terminal state
        (released / expired / failed) or the tick budget runs out."""
        while self.tick_no < max_ticks:
            if not self._work_pending():
                self._final_certification()
                if not self._work_pending():
                    break
            self.tick()
        return self.metrics

    # ------------------------------------------------------ finish handling
    def _certify_finished(self, replica: Replica, req: Request) -> bool:
        """The fleet's release gate, run *inside* each replica engine's
        certify stage (installed via ``Replica.install_certifier``).  True
        lets the request flow on to the engine's release stage; False
        withholds it — the fleet has taken custody (uncertified list, DMR
        pair bookkeeping, or a stale copy that is simply dropped)."""
        rec = self.records.get(req.uid)
        if rec is None or rec.terminal:
            return False
        is_primary = req is rec.req
        is_shadow = rec.shadow is not None and req is rec.shadow
        is_backup = rec.backup is not None and req is rec.backup
        if not (is_primary or is_shadow or is_backup):
            return False                             # stale pre-replay copy
        if self.policy in _SCRUB_GATED:
            if is_primary or is_backup:
                replica.uncertified.append(req)
            return False       # withheld until a clean post-finish scrub
        if self.policy == Policy.DMR and rec.shadow is not None:
            if is_primary:
                rec.primary_done = True
            else:
                rec.shadow_done = True
            if rec.primary_done and rec.shadow_done:
                if rec.req.output == rec.shadow.output:
                    self._release(rec)
                    return True
                self._dmr_mismatch(rec)
            return False
        # Policy.NONE (or degraded DMR): release on finish — primary or
        # speculative backup, whichever finished first
        if is_primary or is_backup:
            self._release(rec, req)
            return True
        return False

    def _release(self, rec: _Tracked, req: Optional[Request] = None):
        """Certified release.  ``req`` is the winning copy (primary by
        default; the speculative backup when it finished/certified first) —
        the loser of a backup race is cancelled wherever it still runs, so
        its eventual release is suppressed."""
        req = rec.req if req is None else req
        rec.released = True
        self.released[rec.req.uid] = req
        self.metrics.observe_release(self.tick_no - rec.submitted_tick,
                                     len(req.output or []))
        if rec.backup is not None:
            won = req is rec.backup
            if won:
                self.metrics.backups_won += 1
            loser_rid = rec.primary_rid if won else rec.backup_rid
            if 0 <= loser_rid < len(self.replicas):
                loser = self.replicas[loser_rid]
                loser.engine.cancel(rec.req.uid)
                loser.uncertified = [q for q in loser.uncertified
                                     if q.uid != rec.req.uid]

    # ------------------------------------------------------------ ABFT path
    def _scrub_and_settle(self, replica: Replica):
        """Scrub a replica; clean ⇒ certify+release its finished requests,
        dirty ⇒ full recovery loop + recall/replay of everything uncertified
        or in flight."""
        if self.supervisor.scrub(replica, self.metrics, self.tick_no):
            for req in replica.uncertified:
                rec = self.records.get(req.uid)
                if rec is not None and not rec.terminal:
                    self._release(rec, req)
            replica.uncertified = []
        else:
            self._fail_replica(replica, reason="weight scrub failed",
                               recover=True)

    # ----------------------------------------------------------- DMR path
    def _dmr_mismatch(self, rec: _Tracked):
        """Primary and shadow streams disagree: detect, attribute by
        scrubbing both replicas (weight-SEU ⇒ recovery loop), then replay
        the request on a clean replica (transient faults leave both scrubs
        clean; the fresh third execution is the tie-breaker)."""
        self.metrics.detections += 1
        self.supervisor.events.append(
            f"tick {self.tick_no}: uid {rec.req.uid} DMR mismatch "
            f"(replicas {rec.primary_rid}/{rec.shadow_rid})")
        self.event_log.emit(
            "detection", tick=self.tick_no, uid=rec.req.uid,
            replica=rec.primary_rid,
            detail={"check": "dmr_compare", "shadow_rid": rec.shadow_rid})
        for rid in (rec.primary_rid, rec.shadow_rid):
            r = self.replicas[rid]
            if r.state is ReplicaState.HEALTHY and not self.supervisor.scrub(
                    r, self.metrics, self.tick_no):
                self._fail_replica(r, reason="weight scrub failed "
                                   "(DMR attribution)", recover=True)
        self._replay(rec)

    # ------------------------------------------------- speculative backups
    def _dispatch_backups(self, stragglers: List[int]):
        """Re-issue a straggler's in-flight requests to a warm spare; first
        finisher wins at the certify gate, the loser's release is
        suppressed.  Decode determinism makes the copies interchangeable —
        a backup that wins releases the exact bytes the primary would have.
        DMR requests already run doubled, so they are left alone."""
        for rid in stragglers:
            straggler = self.replicas[rid]
            if not straggler.healthy:
                continue
            for req in straggler.in_flight():
                rec = self.records.get(req.uid)
                if (rec is None or rec.terminal or rec.backup is not None
                        or rec.shadow is not None
                        or rec.primary_rid != rid):
                    continue
                spare = self.router.pick(req.uid, self.replicas,
                                         exclude=(rid,))
                if spare is None:
                    continue
                rec.backup = Request(uid=rec.req.uid,
                                     prompt=list(rec.req.prompt),
                                     max_new_tokens=rec.req.max_new_tokens)
                rec.backup_rid = spare.rid
                spare.engine.submit(rec.backup)
                self.metrics.backup_dispatches += 1
                self.supervisor.events.append(
                    f"tick {self.tick_no}: uid {rec.req.uid} speculative "
                    f"backup on replica {spare.rid} (straggler {rid})")
                self.event_log.emit(
                    "backup_dispatch", tick=self.tick_no, uid=rec.req.uid,
                    replica=spare.rid, detail={"straggler": rid})

    # ------------------------------------------------------------ injection
    def strike(self, rid: int, site: str, fault, key) -> None:
        """Campaign/drill injection surface: route an SEU to a replica's
        engine and record it — with fault provenance and the fleet tick —
        in the event log, so reports can reconstruct the
        injection→detection→recovery timeline."""
        self.event_log.emit(
            "strike", tick=self.tick_no, site=site, replica=rid,
            fault=getattr(fault, "name", getattr(fault, "__name__", "")))
        self.replicas[rid].engine.strike(site, fault, key)

    # ------------------------------------------------------------- failover
    def kill_replica(self, rid: int, reason: str = "killed"):
        """Simulated hard loss (test/campaign hook): the replica is DEAD and
        its in-flight work fails over to the healthy survivors."""
        r = self.replicas[rid]
        if r.state is ReplicaState.DEAD:
            return
        self._fail_replica(r, reason=reason, recover=False)

    def pause_replica(self, rid: int):
        """Stop stepping/heartbeating a replica without killing it — the
        supervisor's heartbeat timeout must notice on its own."""
        self.replicas[rid].paused = True

    def _fail_replica(self, replica: Replica, *, reason: str, recover: bool):
        """Common exit from HEALTHY: drain every request the replica owns
        (queued, decoding, finished-but-uncertified), run the recovery loop
        if asked, then replay the drained work on verified replicas."""
        drained = replica.in_flight() + replica.uncertified
        replica.uncertified = []
        self.supervisor.events.append(
            f"tick {self.tick_no}: replica {replica.rid} failed ({reason}); "
            f"{len(drained)} requests drained")
        if recover:
            self.supervisor.recover(replica, self.ckpt_dir, self.metrics,
                                    self.tick_no,
                                    step=getattr(replica, "ckpt_step",
                                                 self._current_step))
        else:
            replica.state = ReplicaState.DEAD
            self.metrics.replicas_lost += 1
            self.supervisor.events.append(
                f"tick {self.tick_no}: replica {replica.rid} DEAD ({reason})")
            self.event_log.emit("replica_dead", tick=self.tick_no,
                                replica=replica.rid,
                                detail={"reason": reason})
        for req in drained:
            rec = self.records.get(req.uid)
            if rec is not None and not rec.terminal:
                self._replay(rec)

    def _recover_transport(self, replica):
        """A worker process died mid-RPC (SIGKILL, crash, missed deadline).
        The parent-side request registry survives the worker, so custody is
        intact: drain it, respawn the worker from the current golden
        checkpoint step, re-verify the restored weights, readmit, and
        replay the drained work — the same chain a failed scrub takes, with
        process loss as the detection."""
        drained = replica.in_flight() + replica.uncertified
        replica.uncertified = []
        self.metrics.detections += 1
        self.supervisor.events.append(
            f"tick {self.tick_no}: replica {replica.rid} transport lost; "
            f"{len(drained)} requests drained")
        self.event_log.emit(
            "detection", tick=self.tick_no, replica=replica.rid,
            detail={"check": "transport", "reason": "peer_dead"})
        replica.state = ReplicaState.QUARANTINED
        self.event_log.emit("quarantine", tick=self.tick_no,
                            replica=replica.rid)
        step = getattr(replica, "ckpt_step", self._current_step)
        t0 = time.perf_counter()
        replica.state = ReplicaState.RECOVERING
        try:
            replica.reset_from_ckpt(self.ckpt_dir, step)
            still_bad = replica.scrub()
        except Exception as e:                        # noqa: BLE001
            replica.state = ReplicaState.DEAD
            self.metrics.replicas_lost += 1
            self.supervisor.events.append(
                f"tick {self.tick_no}: replica {replica.rid} DEAD "
                f"(worker respawn failed: {e})")
            self.event_log.emit("replica_dead", tick=self.tick_no,
                                replica=replica.rid,
                                detail={"reason": "respawn_failed"})
            still_bad = None                      # exception path: DEAD above
        if still_bad:
            replica.state = ReplicaState.DEAD
            self.metrics.replicas_lost += 1
            self.event_log.emit("replica_dead", tick=self.tick_no,
                                replica=replica.rid,
                                detail={"reason": "reverify_failed"})
        elif still_bad is not None:
            seconds = time.perf_counter() - t0
            replica.state = ReplicaState.HEALTHY
            replica.last_clean_scrub_tick = self.tick_no
            replica.recoveries += 1
            self.metrics.recoveries += 1
            self.metrics.observe_recovery(seconds)   # full restore by respawn
            self.event_log.emit(
                "recovery", tick=self.tick_no, replica=replica.rid,
                seconds=seconds,
                detail={"incremental": False, "action": "worker_respawn"})
            self.supervisor.events.append(
                f"tick {self.tick_no}: replica {replica.rid} worker "
                f"respawned + re-verified ({seconds * 1e3:.1f} ms)")
        for req in drained:
            rec = self.records.get(req.uid)
            if rec is not None and not rec.terminal:
                self._replay(rec)

    def _replay(self, rec: _Tracked):
        """Deterministic failover: requeue the request (and its DMR shadow)
        from the prompt on healthy replicas; decode determinism makes the
        replayed stream bit-identical to what a fault-free replica would
        have produced."""
        rec.replays += 1
        self.metrics.failovers += 1
        self.event_log.emit("failover", tick=self.tick_no, uid=rec.req.uid,
                            detail={"replay": rec.replays})
        self.metrics.lost_tokens += len(rec.req.output or [])
        if rec.shadow is not None:
            self.metrics.lost_tokens += len(rec.shadow.output or [])
        if rec.backup is not None:
            self.metrics.lost_tokens += len(rec.backup.output or [])
        rec.backup = None
        rec.backup_rid = -1
        # evict any copy still resident somewhere (queued on a replica that
        # did not fail, half of a DMR pair, …)
        for r in self.replicas:
            r.engine.cancel(rec.req.uid)
            r.uncertified = [q for q in r.uncertified if q.uid != rec.req.uid]
        if rec.replays > self.MAX_REPLAYS:
            rec.failed = True
            self.metrics.failed += 1
            self.supervisor.events.append(
                f"tick {self.tick_no}: uid {rec.req.uid} FAILED "
                f"(replay budget exhausted)")
            return
        rec.req.output = None
        rec.req.finished_at = 0.0
        rec.primary_done = rec.shadow_done = False
        primary = self.router.pick(rec.req.uid, self.replicas)
        if primary is None:
            rec.failed = True
            self.metrics.failed += 1
            self.supervisor.events.append(
                f"tick {self.tick_no}: uid {rec.req.uid} FAILED "
                f"(no healthy replica for failover)")
            return
        rec.primary_rid = primary.rid
        if self.policy == Policy.DMR:
            self._place_shadow(rec)
        primary.engine.submit(rec.req)

    # ------------------------------------------------------------ deadlines
    def _expire_deadlines(self):
        for rec in self.records.values():
            if rec.terminal or rec.deadline_ticks is None:
                continue
            if self.tick_no - rec.submitted_tick > rec.deadline_ticks:
                rec.expired = True
                self.metrics.deadline_misses += 1
                for r in self.replicas:
                    r.engine.cancel(rec.req.uid)
                    r.uncertified = [q for q in r.uncertified
                                     if q.uid != rec.req.uid]
                self.supervisor.events.append(
                    f"tick {self.tick_no}: uid {rec.req.uid} missed its "
                    f"deadline ({rec.deadline_ticks} ticks)")

    # ------------------------------------------------------------- draining
    def _engines_busy(self) -> bool:
        return any(r.state is ReplicaState.HEALTHY and not r.paused
                   and (r.engine.queue or r.engine.active)
                   for r in self.replicas)

    def _work_pending(self) -> bool:
        if self._engines_busy():
            return True
        return any(not rec.terminal for rec in self.records.values())

    def _final_certification(self):
        """End-of-stream settlement: scrub every replica still holding
        uncertified output so the tail of the stream is certified (or
        recalled) even when the tick count never hits the scrub cadence."""
        if self.policy in _SCRUB_GATED:
            for r in self.replicas:
                if r.state is ReplicaState.HEALTHY and r.uncertified:
                    self._scrub_and_settle(r)
        # non-ABFT terminal stragglers: requests stranded on dead replicas
        for rec in list(self.records.values()):
            if not rec.terminal and not self._request_resident(rec):
                self._replay(rec)

    def _request_resident(self, rec: _Tracked) -> bool:
        """Is any live copy of the request still queued/decoding/uncertified
        on a healthy replica?"""
        for r in self.replicas:
            if r.state is not ReplicaState.HEALTHY:
                continue
            for req in r.in_flight() + r.uncertified:
                if req.uid == rec.req.uid:
                    return True
        return False

    # ------------------------------------------------------ rolling deploy
    def deploy(self, params=None, *, ckpt_dir: Optional[str] = None,
               step: Optional[int] = None, mid_swap=None,
               ticks_between: int = 2) -> dict:
        """Zero-drain rolling weight deploy.

        The new weights (``params``, or a checkpoint read from an external
        ``ckpt_dir``/``step``) are first written to the fleet's own golden
        store — deploy truth is always the crc32-verified *storage* copy,
        and the new scrub checksums are computed from that round trip,
        never from live memory.  Then the fleet walks its healthy replicas
        one at a time:

          1. settle output certified under the *old* checksums,
          2. leave the router (``routable=False``; in-flight decodes keep
             running — nothing drains),
          3. patch exactly the changed leaves (manifest-path diff of old vs
             new storage checksums → ``restore_leaves``) into the live
             engine,
          4. re-verify against the **new** storage checksums before the
             replica takes new work again.  A strike landing mid-swap fails
             this re-verify and takes the standard quarantine → incremental
             restore (from the new step) → re-verify → replay path.

        ``mid_swap(rid)`` is a test/campaign hook invoked between patch and
        re-verify — the window the rolling-deploy campaign strikes SEUs
        into.  ``ticks_between`` fleet ticks run between replica swaps so
        the fleet demonstrably serves throughout.  Returns a summary dict.
        """
        if (params is None) == (ckpt_dir is None):
            raise ValueError("deploy needs exactly one of params= or "
                             "ckpt_dir=")
        new_step = (ckpt_mod.latest_step(self.ckpt_dir) or 0) + 1
        if params is None:
            _, params = ckpt_mod.restore(ckpt_dir, step, device=self.device)
        ckpt_mod.save(self.ckpt_dir, new_step, params)
        _, new_params = ckpt_mod.restore(self.ckpt_dir, new_step,
                                         device=self.device)
        new_golden = abft.storage_checksums(new_params)

        old_sums = _sums_by_path(self._golden0)
        new_sums = _sums_by_path(new_golden)
        changed = [p for p in ckpt_mod.manifest_paths(self.ckpt_dir,
                                                      new_step)
                   if old_sums.get(p) != new_sums[p]]
        leaves = ckpt_mod.restore_leaves(self.ckpt_dir, changed,
                                         step=new_step, device=self.device)
        self.metrics.deploys += 1
        self.event_log.emit(
            "deploy_start", tick=self.tick_no,
            detail={"step": new_step, "changed": len(changed)})
        self.supervisor.events.append(
            f"tick {self.tick_no}: deploy of step {new_step} started "
            f"({len(changed)} changed leaves)")

        swapped: List[int] = []
        failed: List[int] = []
        for r in self.replicas:
            if r.state is not ReplicaState.HEALTHY:
                continue
            # settle output that certifies against the old checksums while
            # they are still the truth
            if self.policy in _SCRUB_GATED and r.uncertified:
                self._scrub_and_settle(r)
                if r.state is not ReplicaState.HEALTHY:
                    failed.append(r.rid)
                    continue
            r.routable = False
            # ckpt_step moves first: a worker that dies mid-patch respawns
            # with a *full* restore of the new step (golden recomputed from
            # the restored weights), which completes the swap the hard way
            r.ckpt_step = new_step
            try:
                r.patch_leaves(leaves, golden=new_golden)
                if mid_swap is not None:
                    mid_swap(r.rid)
                clean = self.supervisor.scrub(r, self.metrics, self.tick_no)
            except TransportDead:
                self._recover_transport(r)
                clean = r.state is ReplicaState.HEALTHY
            if not clean and r.state is ReplicaState.HEALTHY:
                # a strike landed during the swap (or the patch tore):
                # caught before the replica rejoined the router
                self._fail_replica(r, reason="deploy re-verify failed",
                                   recover=True)
            if r.state is ReplicaState.HEALTHY:
                r.routable = True
                self.metrics.replicas_swapped += 1
                self.event_log.emit(
                    "replica_swapped", tick=self.tick_no, replica=r.rid,
                    detail={"step": new_step, "reverified": True,
                            "recovered": not clean})
                self.supervisor.events.append(
                    f"tick {self.tick_no}: replica {r.rid} swapped to step "
                    f"{new_step} (re-verified)")
                swapped.append(r.rid)
            else:
                failed.append(r.rid)
            for _ in range(ticks_between):
                self.tick()

        self._params0 = new_params
        self._golden0 = new_golden
        self._current_step = new_step
        return {"step": new_step, "changed": len(changed),
                "swapped": swapped, "failed": failed}

    # --------------------------------------------------------------- reset
    def reset(self, policy: Optional[Policy] = None):
        """Return the fleet to a fresh, fully-healthy state with the golden
        params (campaign trials reuse one fleet so engines stay compiled).
        Dependability counters restart; the golden checkpoint is reused."""
        if policy is not None:
            if policy not in FLEET_POLICIES:
                raise ValueError(f"fleet policy must be one of "
                                 f"{[p.value for p in FLEET_POLICIES]}")
            self.policy = policy
        scrub_mode = _state_scrub_mode(self.policy)
        for r in self.replicas:
            if hasattr(r, "reset_from_ckpt"):
                # proc replica: the worker restores the current golden step
                # itself (cached per step, crc32-verified — byte-identical
                # to ``self._params0``); a dead worker is respawned
                r.reset_from_ckpt(self.ckpt_dir, self._current_step)
                r.engine.state_scrub = scrub_mode
            else:
                r.engine.state_scrub = scrub_mode
                r.reset(params=self._params0)
                r.golden = self._golden0
                r.routable = True
            r.ckpt_step = self._current_step
        self.supervisor.reset()
        self.metrics = FleetMetrics(
            lost_work_bound_tokens=self.metrics.lost_work_bound_tokens)
        self.event_log = EventLog(policy=self.policy.value)
        self.supervisor.event_log = self.event_log
        self.tick_no = 0
        self.records = {}
        self.released = {}

    def close(self):
        """Shut down worker processes (proc transport) and delete the golden
        checkpoint directory if this fleet created it (a caller-supplied
        ckpt_dir is the caller's to manage)."""
        for r in self.replicas:
            if hasattr(r, "handle"):
                try:
                    r.close()
                except Exception:       # noqa: BLE001 — teardown best effort
                    pass
        if self._owns_ckpt_dir:
            shutil.rmtree(self.ckpt_dir, ignore_errors=True)
            self._owns_ckpt_dir = False

    def __del__(self):
        try:
            self.close()
        except Exception:       # noqa: BLE001 — interpreter teardown
            pass

    # -------------------------------------------------------------- report
    def report(self, wall: bool = False) -> dict:
        """Fleet metrics + per-replica state, JSON-ready.  ``wall=True``
        adds the wall-clock-derived rates (non-deterministic; see
        ``FleetMetrics.to_json``)."""
        out = self.metrics.to_json(wall=wall)
        out["policy"] = self.policy.value
        out["transport"] = self.transport
        out["ckpt_step"] = self._current_step
        out["replicas"] = [
            {"rid": r.rid, "state": r.state.value,
             "recoveries": r.recoveries,
             "engine_steps": r.engine.stats.steps,
             "engine_tokens_out": r.engine.stats.tokens_out}
            for r in self.replicas]
        out["events"] = list(self.supervisor.events)
        return out
