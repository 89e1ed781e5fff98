"""Fleet-level service metrics — built on the ``repro_torch.obs`` registry.

A copy of ``repro.fleet.metrics``: for the same fleet history,
``to_json(wall=False)`` gives the reference's bytes.

One ``FleetMetrics`` instance accumulates everything a dependable-serving
SLO needs: delivery counters (released / rejected / deadline misses),
dependability counters (scrubs, detections, recoveries, failovers), the
lost-work accounting the paper's bounded-recovery story requires, and
per-request latency in *ticks* (the fleet's deterministic clock) so the
numbers replay bit-exactly under campaign seeds.

Counters live in an ``obs.Registry`` (attribute access is preserved:
``metrics.released += 1`` still works, routed to the registry counter), and
the two distributions — release latency and recovery wall time — are
streaming ``Histogram``s of fixed size, whatever the number of requests.
The registry doubles as the Prometheus / JSON-snapshot export surface
(``metrics.registry``).

``to_json`` is the export surface the fleet CLI and campaign reports
serialize verbatim.  Wall-clock-derived fields (``wall_seconds``,
``tokens_per_second``) are opt-in via ``to_json(wall=True)``: they change
run to run even under fixed seeds, so the deterministic default keeps
report diffs clean.
"""
from __future__ import annotations

import json
import pathlib
import time

from repro_torch.obs import Histogram, Registry

# every integer counter the fleet maintains, in export order
_COUNTERS = (
    # configuration-derived bound: max tokens a replica can produce between
    # two clean scrubs (certification window × batch width)
    "lost_work_bound_tokens",
    # service counters
    "ticks", "engine_steps", "submitted", "released", "rejected",
    "deadline_misses", "failed",
    "tokens_out",                # tokens of *released* (certified) requests
    # dependability counters
    "scrubs",
    "detections",         # scrub mismatches + DMR disagreements + state hits
    "recoveries",         # quarantine→restore→re-verify→readmit cycles
    "failovers",          # requests replayed on another replica
    "replicas_lost",      # replicas that ended DEAD
    "lost_tokens",        # tokens discarded and re-decoded (actual lost work)
    # recovery accounting (checkpoint/restart as a measured subsystem)
    "incremental_restores",   # quarantine recoveries served by partial restore
    "full_reloads",           # recoveries that needed the whole checkpoint
    "leaves_restored",        # tensors re-read across incremental restores
    "state_scrub_detections",  # decode-state checksum mismatches (transients)
    "state_rollbacks",        # engine snapshot rollbacks (CKPT recovery)
    "state_drains",           # drain+replay transient recoveries (ABFT detect)
    # multi-host: speculative backups + rolling weight deploys
    "backup_dispatches",      # straggler requests re-issued to a warm spare
    "backups_won",            # releases where the backup copy finished first
    "deploys",                # rolling weight deploys started
    "replicas_swapped",       # replicas that swapped + re-verified clean
)

# latency in fleet ticks: power-of-two edges 1..8192
_TICK_BUCKETS = tuple(float(2 ** i) for i in range(14))
# recovery wall seconds: 100 µs .. ~26 s exponential
_SECONDS_BUCKETS = tuple(0.0001 * 4.0 ** i for i in range(10))


class FleetMetrics:
    """Registry-backed fleet metrics with the legacy attribute surface."""

    def __init__(self, lost_work_bound_tokens: int = 0,
                 registry: Registry = None):
        self.registry = registry if registry is not None else Registry()
        self._c = {name: self.registry.counter("fleet_" + name)
                   for name in _COUNTERS}
        # latency, in fleet ticks (submit → release)
        self.latencies: Histogram = self.registry.histogram(
            "fleet_release_latency_ticks",
            "submit-to-release latency in fleet ticks",
            buckets=_TICK_BUCKETS)
        # recovery latency, wall seconds (quarantine restores + rollbacks)
        self.recovery_seconds: Histogram = self.registry.histogram(
            "fleet_recovery_seconds",
            "wall time of measured recovery actions",
            buckets=_SECONDS_BUCKETS)
        self.started_at = time.time()
        self.lost_work_bound_tokens = lost_work_bound_tokens

    # counter attribute routing: ``metrics.released += 1`` reads and writes
    # the registry counter, so the monolith-era call sites stay unchanged
    def __getattr__(self, name):
        c = self.__dict__.get("_c")
        if c is not None and name in c:
            return c[name].value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        c = self.__dict__.get("_c")
        if c is not None and name in c:
            c[name].value = int(value)
        else:
            object.__setattr__(self, name, value)

    # ------------------------------------------------------------- derived
    def observe_release(self, latency_ticks: int, n_tokens: int):
        self.released += 1
        self.tokens_out += n_tokens
        self.latencies.observe(int(latency_ticks))

    def observe_recovery(self, seconds: float, *, leaves: int = 0,
                         incremental: bool = False, rollback: bool = False):
        """One measured recovery action: a quarantine restore (incremental
        or full-reload) or an engine decode-state snapshot rollback."""
        self.recovery_seconds.observe(float(seconds))
        if rollback:
            self.state_rollbacks += 1
        elif incremental:
            self.incremental_restores += 1
            self.leaves_restored += leaves
        else:
            self.full_reloads += 1

    def recovery_mean_seconds(self) -> float:
        return self.recovery_seconds.mean()

    def recovery_max_seconds(self) -> float:
        h = self.recovery_seconds
        return float(h.max) if h.count else 0.0

    def latency_percentile(self, q: float) -> float:
        return self.latencies.percentile(q)

    @property
    def p50_ticks(self) -> float:
        return self.latency_percentile(50)

    @property
    def p99_ticks(self) -> float:
        return self.latency_percentile(99)

    def throughput_tokens_per_tick(self) -> float:
        return self.tokens_out / max(self.ticks, 1)

    # -------------------------------------------------------------- export
    def to_json(self, wall: bool = False) -> dict:
        """JSON-ready metrics.  Deterministic by default; ``wall=True`` adds
        the wall-clock-derived rates (they vary run to run, so reports that
        want diffable output leave them off)."""
        d = {name: self._c[name].value for name in _COUNTERS}
        d.update(
            recovery_count=self.recovery_seconds.count,
            recovery_mean_seconds=round(self.recovery_mean_seconds(), 6),
            recovery_max_seconds=round(self.recovery_max_seconds(), 6),
            p50_latency_ticks=self.p50_ticks,
            p99_latency_ticks=self.p99_ticks,
            tokens_per_tick=self.throughput_tokens_per_tick(),
        )
        if wall:
            elapsed = time.time() - self.started_at
            d.update(
                wall_seconds=round(elapsed, 3),
                tokens_per_second=round(
                    self.tokens_out / max(elapsed, 1e-9), 1),
            )
        return d

    def dump(self, path, wall: bool = False) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(wall=wall), indent=2))
        return path
