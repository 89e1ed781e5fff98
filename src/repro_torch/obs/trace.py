"""Deterministic per-request span tracing — Chrome ``trace_event`` export.

Answers *where a request spent its time*: every request flowing through the
streaming executor gets one span per pipeline stage (admit → prefill →
decode → certify), plus counter tracks for queue depth and decode-slot
occupancy sampled once per pump cycle.  The file a trace dumps to is the
Chrome/Perfetto ``trace_event`` JSON format, so ``ui.perfetto.dev`` (or
``chrome://tracing``) renders the pipeline directly — one track per stage,
one slice per request-stage residency.

Determinism is the design constraint: spans are keyed on the executor's
**tick clock** (cooperative pump cycles), not the wall clock, so two runs
with the same seed produce *byte-identical* trace files — the property the
dependability campaigns rely on for replay debugging, asserted in
``tests/test_obs.py``.  ``wall_clock=True`` opt-in adds wall-time
annotations to span args (useful for real profiling, destroys
byte-identity; default off).

Cost model: tracing must be a pure observer —

  * disabled (``tracer=None`` on the executor) it is a handful of ``if x is
    None`` branches: zero allocations, nothing measurable;
  * enabled it is dict appends on host-side stage transitions only (never
    inside jitted code), budgeted at < 3 % tokens/s on the serving bench
    (asserted in CI).

Span model (Chrome ``ph`` phases):

  ``X`` complete events — one per (request uid, stage) residency, ``ts`` =
        entry tick, ``dur`` = ticks resident, ``args`` carry uid and
        stage-specific detail (prompt length, tokens decoded, …);
  ``C`` counter events — per-tick queue depths and slot occupancy;
  ``i`` instant events — point occurrences (release, rollback, strike);
  ``M`` metadata — process/thread naming so stage tracks sort correctly.

Ticks are exported as microseconds 1:1 (Perfetto needs a time unit; one
tick = 1 µs nominal).  In wall-clock mode spans additionally carry
``wall_ts``/``wall_dur`` (seconds) in their args.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional, Tuple

# canonical stage → trace-track (tid) assignment; release is an instant on
# the certify track's successor so it sorts last
STAGE_TIDS = {"admit": 1, "prefill": 2, "decode": 3, "certify": 4,
              "release": 5}


class SpanTracer:
    """Collects spans against a caller-advanced tick clock.

    The owner (``StreamingExecutor``) calls ``tick_to(t)`` as its clock
    advances, ``open_span``/``close_span`` at stage transitions, ``instant``
    for point events, and ``counter`` for per-tick level samples.  Nothing
    here reads a clock of its own in deterministic mode.
    """

    def __init__(self, wall_clock: bool = False, name: str = "engine",
                 pid: int = 0):
        self.wall_clock = wall_clock
        self.name = name
        self.pid = pid
        self.tick = 0
        self.events: List[dict] = []
        self._open: Dict[Tuple[int, str], dict] = {}   # (uid, stage) -> span
        self._t0 = time.perf_counter() if wall_clock else 0.0
        self._emit_metadata()

    # ------------------------------------------------------------ plumbing
    def _emit_metadata(self):
        self.events.append({"ph": "M", "pid": self.pid, "tid": 0,
                            "name": "process_name",
                            "args": {"name": self.name}})
        for stage, tid in STAGE_TIDS.items():
            self.events.append({"ph": "M", "pid": self.pid, "tid": tid,
                                "name": "thread_name",
                                "args": {"name": stage}})
            self.events.append({"ph": "M", "pid": self.pid, "tid": tid,
                                "name": "thread_sort_index",
                                "args": {"sort_index": tid}})

    def _wall(self) -> float:
        return time.perf_counter() - self._t0

    def tick_to(self, tick: int) -> None:
        self.tick = tick

    # -------------------------------------------------------------- spans
    def open_span(self, uid: int, stage: str, **args) -> None:
        """Begin a (uid, stage) residency at the current tick.  Re-opening
        an open span restarts it (rollback replays re-enter a stage)."""
        span = {"uid": uid, "stage": stage, "ts": self.tick, "args": args}
        if self.wall_clock:
            span["wall_ts"] = self._wall()
        self._open[(uid, stage)] = span

    def close_span(self, uid: int, stage: str, **args) -> None:
        """End a residency; silently ignores a span that is not open (e.g.
        a request cancelled out of a stage it never entered)."""
        span = self._open.pop((uid, stage), None)
        if span is None:
            return
        merged = dict(span["args"])
        merged.update(args)
        merged["uid"] = uid
        ev = {"ph": "X", "pid": self.pid, "tid": STAGE_TIDS.get(stage, 9),
              "name": stage, "cat": "request",
              "ts": span["ts"], "dur": self.tick - span["ts"],
              "args": merged}
        if self.wall_clock:
            ev["args"]["wall_ts"] = span["wall_ts"]
            ev["args"]["wall_dur"] = self._wall() - span["wall_ts"]
        self.events.append(ev)

    def cancel_span(self, uid: int, stage: str) -> None:
        """Drop an open span without emitting (request evicted/reset)."""
        self._open.pop((uid, stage), None)

    def instant(self, name: str, stage: str = "decode", **args) -> None:
        ev = {"ph": "i", "pid": self.pid,
              "tid": STAGE_TIDS.get(stage, 9), "name": name,
              "cat": "event", "ts": self.tick, "s": "t", "args": args}
        if self.wall_clock:
            ev["args"]["wall_ts"] = self._wall()
        self.events.append(ev)

    def counter(self, name: str, **series) -> None:
        """One ``C`` sample of a counter track at the current tick."""
        self.events.append({"ph": "C", "pid": self.pid, "tid": 0,
                            "name": name, "ts": self.tick, "args": series})

    # ------------------------------------------------------------- export
    def to_chrome_trace(self) -> dict:
        """The ``trace_event`` JSON object.  Open spans are flushed as
        zero-progress slices ending at the current tick (work still in
        flight when the trace was cut)."""
        events = list(self.events)
        for (uid, stage), span in sorted(self._open.items(),
                                         key=lambda kv: (kv[0][0],
                                                         kv[0][1])):
            args = dict(span["args"])
            args.update(uid=uid, unfinished=True)
            events.append({"ph": "X", "pid": self.pid,
                           "tid": STAGE_TIDS.get(stage, 9), "name": stage,
                           "cat": "request", "ts": span["ts"],
                           "dur": self.tick - span["ts"], "args": args})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "clock": "ticks" if not self.wall_clock else "ticks+wall",
                "tracer": self.name,
            },
        }

    def to_bytes(self) -> bytes:
        """Canonical serialization: sorted keys, fixed separators — the
        byte-identity surface the determinism tests assert on."""
        return json.dumps(self.to_chrome_trace(), sort_keys=True,
                          separators=(",", ":")).encode() + b"\n"

    def dump(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(self.to_bytes())
        return path


def merge_traces(tracers) -> dict:
    """Combine several tracers (e.g. one per fleet replica, distinguished
    by ``pid``) into one ``trace_event`` object, in the order given —
    deterministic when each tracer is."""
    tracers = list(tracers)
    events: List[dict] = []
    for tr in tracers:
        events.extend(tr.to_chrome_trace()["traceEvents"])
    wall = any(tr.wall_clock for tr in tracers)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "clock": "ticks" if not wall else "ticks+wall",
            "tracer": "+".join(tr.name for tr in tracers),
        },
    }


def dump_merged(tracers, path) -> pathlib.Path:
    """Canonically serialize a merged trace (same byte-identity contract
    as ``SpanTracer.to_bytes``)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = json.dumps(merge_traces(tracers), sort_keys=True,
                      separators=(",", ":")).encode() + b"\n"
    path.write_bytes(data)
    return path
