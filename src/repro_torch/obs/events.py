"""Structured dependability event log — injection → detection → recovery.

The neutron-irradiation and DAVOS lines of work turn raw SDC counts into
hardening decisions by *attributing* every error: which site was struck,
when the policy noticed, what the recovery did, and how long each edge
took.  This module is that record for the reproduction: an append-only log
of typed events, each carrying fault provenance, that campaign reports
replay into per-policy detection- and recovery-latency distributions.

Event kinds (``EventLog.KINDS``):

  ``strike``      an SEU was injected (campaign hook or drill CLI):
                  site + fault model + the tick it landed on
  ``detection``   a policy's check flagged corruption (ABFT checksum,
                  storage scrub, decode-state scrub, DMR divergence)
  ``rollback``    in-place recovery: engine snapshot restore (steps
                  replayed, wall seconds)
  ``recovery``    out-of-place recovery: quarantine restore (incremental /
                  full), drain + replay, golden re-execution
  ``quarantine``  a replica was pulled from service pending recovery
  ``failover``    a request was replayed on another replica
  ``replica_dead``a replica left service permanently
  ``deploy_start``a rolling weight deploy began (fleet scope): target
                  checkpoint step + changed-leaf count
  ``replica_swapped`` one replica finished its swap and re-verified clean
                  against the *new* storage checksums (rejoins the router)
  ``backup_dispatch`` a straggler's in-flight request was speculatively
                  re-issued to a warm spare (first finisher wins)

Every event carries a ``tick`` on the emitting layer's deterministic clock
(engine steps for the executor, fleet ticks for the fleet) plus provenance
fields — ``site``, ``policy``, ``replica``, ``uid``, ``fault`` — that are
empty-defaulted so the log serializes uniformly.  Wall-clock durations of
measured recoveries ride in ``seconds``; they are *data about the recovery*
(not event timestamps), so they do not break tick determinism.

``timelines()`` reconstructs injection→detection→recovery chains: each
``strike`` claims every subsequent event until the next ``strike``, which
is exact for the one-strike-per-trial campaigns that drive this log and a
good approximation everywhere else.  ``latency_summary()`` reduces the
chains to per-policy distributions — the numbers the campaign report's
timeline columns print.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional


KINDS = ("strike", "detection", "rollback", "recovery", "quarantine",
         "failover", "replica_dead", "deploy_start", "replica_swapped",
         "backup_dispatch")


@dataclasses.dataclass
class Event:
    """One dependability occurrence with full fault provenance."""
    tick: int                 # deterministic clock of the emitting layer
    kind: str                 # one of KINDS
    site: str = ""            # fault site (kv_cache / weights / …)
    policy: str = ""          # dependability policy active at emission
    fault: str = ""           # fault-model name (single_bitflip, …)
    replica: int = -1         # replica id (-1: single-engine scope)
    uid: int = -1             # request uid (-1: not request-scoped)
    seconds: float = 0.0      # measured wall duration (recoveries)
    detail: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self, wall: bool = True) -> dict:
        d = {"tick": self.tick, "kind": self.kind, "site": self.site,
             "policy": self.policy, "fault": self.fault,
             "replica": self.replica, "uid": self.uid,
             "detail": dict(self.detail)}
        if wall:
            d["seconds"] = self.seconds
        return d


class EventLog:
    """Append-only dependability event log with a shared default context.

    ``ctx`` fields (e.g. ``replica=2``, ``policy="ckpt"``) are merged into
    every emitted event unless the emit call overrides them — so an engine
    embedded in a fleet replica stamps its replica id without every call
    site threading it through.
    """

    KINDS = KINDS

    def __init__(self, **ctx):
        self.events: List[Event] = []
        self.ctx = ctx

    def emit(self, kind: str, tick: int, **fields) -> Event:
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r}; known: {KINDS}")
        merged = dict(self.ctx)
        merged.update(fields)
        ev = Event(tick=int(tick), kind=kind, **merged)
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def clear(self) -> None:
        self.events = []

    def drain(self) -> List[Event]:
        ev, self.events = self.events, []
        return ev

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self.events if e.kind == kind]

    # ----------------------------------------------------------- analysis
    def timelines(self) -> List[dict]:
        """Injection→detection→recovery chains: every ``strike`` claims the
        events that follow it (up to the next strike).  Latencies are tick
        deltas on the emitting layer's clock; ``recovery_seconds`` is the
        summed measured wall time of the chain's recovery actions."""
        chains: List[dict] = []
        current: Optional[dict] = None
        for ev in self.events:
            if ev.kind == "strike":
                if current is not None:
                    chains.append(current)
                current = {"strike": ev, "detection": None,
                           "recoveries": [], "events": []}
                continue
            if current is None:
                continue                       # pre-strike noise (scrub ok …)
            current["events"].append(ev)
            if ev.kind == "detection" and current["detection"] is None:
                current["detection"] = ev
            elif ev.kind in ("rollback", "recovery"):
                current["recoveries"].append(ev)
        if current is not None:
            chains.append(current)
        out = []
        for ch in chains:
            strike, det = ch["strike"], ch["detection"]
            rec = ch["recoveries"]
            out.append({
                "site": strike.site,
                "policy": strike.policy,
                "fault": strike.fault,
                "strike_tick": strike.tick,
                "detected": det is not None,
                "detection_tick": det.tick if det else None,
                "detection_latency_ticks":
                    (det.tick - strike.tick) if det else None,
                "recovered": bool(rec),
                "recovery_latency_ticks":
                    (rec[-1].tick - strike.tick) if rec else None,
                "recovery_seconds": sum(e.seconds for e in rec),
                "n_events": len(ch["events"]),
            })
        return out

    def latency_summary(self) -> Dict[str, dict]:
        """Per-policy detection/recovery latency distributions from the
        reconstructed timelines — mean/max over tick deltas plus summed
        measured recovery seconds."""
        per: Dict[str, dict] = {}
        for tl in self.timelines():
            s = per.setdefault(tl["policy"] or "?", {
                "strikes": 0, "detected": 0, "recovered": 0,
                "detection_ticks": [], "recovery_ticks": [],
                "recovery_seconds": 0.0})
            s["strikes"] += 1
            if tl["detected"]:
                s["detected"] += 1
                s["detection_ticks"].append(tl["detection_latency_ticks"])
            if tl["recovered"]:
                s["recovered"] += 1
                s["recovery_ticks"].append(tl["recovery_latency_ticks"])
                s["recovery_seconds"] += tl["recovery_seconds"]
        out = {}
        for policy, s in per.items():
            dt, rt = s["detection_ticks"], s["recovery_ticks"]
            out[policy] = {
                "strikes": s["strikes"],
                "detected": s["detected"],
                "recovered": s["recovered"],
                "detection_ticks_mean":
                    (sum(dt) / len(dt)) if dt else 0.0,
                "detection_ticks_max": max(dt) if dt else 0,
                "recovery_ticks_mean":
                    (sum(rt) / len(rt)) if rt else 0.0,
                "recovery_ticks_max": max(rt) if rt else 0,
                "recovery_seconds": s["recovery_seconds"],
            }
        return out

    # ------------------------------------------------------------- export
    def to_json(self, wall: bool = True) -> dict:
        """The event-log document: raw events + reconstructed timelines.
        ``wall=False`` strips measured wall-clock seconds so deterministic
        runs export byte-identically (report-diffing mode)."""
        doc = {"events": [e.to_dict(wall=wall) for e in self.events],
               "timelines": self.timelines(),
               "latency_summary": self.latency_summary()}
        if not wall:
            for tl in doc["timelines"]:
                tl.pop("recovery_seconds", None)
            for s in doc["latency_summary"].values():
                s.pop("recovery_seconds", None)
        return doc

    def dump(self, path, wall: bool = True) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(wall=wall), indent=2,
                                   sort_keys=True) + "\n")
        return path
