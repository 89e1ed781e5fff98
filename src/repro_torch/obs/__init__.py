"""Observability layer: metrics registry, deterministic span tracing, and
the structured dependability event log.

The counterpart of ``repro.obs``: standard library only, ported verbatim,
so that the same calls give the same bytes in both packages.

Three measured-event substrates, one design rule — *observation must not
perturb the system it observes*:

  * :mod:`repro_torch.obs.metrics` — ``Counter``/``Gauge``/``Histogram`` in a
    ``Registry`` with JSON snapshot + Prometheus text exposition; fixed
    memory (streaming histograms), wall-clock-free export.
  * :mod:`repro_torch.obs.trace` — per-request per-stage span tracing on the
    executor's deterministic tick clock, exported as Chrome
    ``trace_event`` JSON (Perfetto-viewable); byte-identical across
    same-seed runs, zero-cost when disabled.
  * :mod:`repro_torch.obs.events` — typed dependability events (strike /
    detection / rollback / recovery / quarantine / failover) with fault
    provenance, plus injection→detection→recovery timeline reconstruction
    and per-policy latency distributions.

The reference's docs/observability.md describes the span model, the event
schema and the Perfetto workflow; they are the same here.
"""
from repro_torch.obs.events import Event, EventLog
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     exp_buckets)
from repro_torch.obs.trace import SpanTracer, dump_merged, merge_traces

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "exp_buckets",
    "SpanTracer", "merge_traces", "dump_merged", "Event", "EventLog",
]
