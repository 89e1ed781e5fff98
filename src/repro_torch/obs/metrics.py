"""Metrics registry — bounded-memory counters, gauges, and histograms.

The paper's dependability claims are *measured* claims (tokens/s, detection
latency, recovery time), so the reproduction needs a measurement substrate
that is itself dependable:

  * **bounded memory** — a `Histogram` is a fixed set of bucket counters
    plus (count, sum, min, max); observing ten million request latencies
    costs the same bytes as observing ten.  This is what replaces the
    unbounded ``FleetMetrics.latencies`` / ``recovery_seconds`` lists that
    used to grow per request for the lifetime of a fleet.
  * **deterministic export** — ``Registry.snapshot()`` is a plain dict of
    plain numbers in registration order, and ``render_prometheus()`` is the
    standard text exposition; neither touches the wall clock, so two
    same-seed runs export byte-identical metrics.
  * **cheap** — instruments are attribute-access + integer adds; nothing
    allocates on the hot path.

Instruments live in a ``Registry`` so one process-wide (or one
fleet/engine-scoped) namespace can be snapshotted atomically.  Names follow
Prometheus conventions (``snake_case``, unit suffix: ``_ticks``,
``_seconds``, ``_tokens``).
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotonic event count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-observed level (queue depth, slot occupancy, replica count)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n

    def to_dict(self) -> dict:
        return {"type": self.kind, "value": self.value}


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """Exponential bucket upper bounds: start, start·f, …  (count edges)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# default edges: wide dynamic range for both tick-valued (1..~4k) and
# seconds-valued (1e-4..~26) observations, 16 buckets + overflow
DEFAULT_BUCKETS = exp_buckets(0.0001, 4.0, 16)


class Histogram:
    """Fixed-bucket streaming histogram: O(len(buckets)) memory forever.

    ``buckets`` are inclusive upper bounds; one overflow bucket catches
    everything above the last edge.  Exact ``count``/``sum``/``min``/``max``
    ride along, so means and extrema stay exact while percentiles are
    bucket-resolution estimates (`percentile` interpolates within the
    winning bucket).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.name = name
        self.help = help
        self.buckets = edges
        self.bucket_counts: List[int] = [0] * (len(edges) + 1)  # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def __len__(self) -> int:
        return self.count

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (q in [0, 100]): linear
        interpolation inside the bucket where the rank lands, clamped to
        the exact observed [min, max]."""
        if not self.count:
            return 0.0
        rank = q / 100.0 * self.count
        cum = 0
        lo = 0.0
        for i, edge in enumerate(self.buckets):
            n = self.bucket_counts[i]
            if n and cum + n >= rank:
                frac = (rank - cum) / n
                est = lo + frac * (edge - lo)
                return min(max(est, self.min), self.max)
            cum += n
            lo = edge
        return self.max

    def to_dict(self) -> dict:
        return {
            "type": self.kind,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": self.mean(),
            "buckets": [
                {"le": edge, "count": c}
                for edge, c in zip(self.buckets, self.bucket_counts)
            ] + [{"le": "+Inf", "count": self.bucket_counts[-1]}],
        }


class Registry:
    """One namespace of instruments; get-or-create semantics so layers can
    share a registry without coordinating construction order."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, not {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def __iter__(self):
        return iter(self._instruments.values())

    # -------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-ready dict in registration order — wall-clock-free, so two
        deterministic runs snapshot byte-identically."""
        return {name: inst.to_dict()
                for name, inst in self._instruments.items()}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape page)."""
        lines: List[str] = []
        for name, inst in self._instruments.items():
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, Histogram):
                cum = 0
                for edge, c in zip(inst.buckets, inst.bucket_counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{edge:g}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {inst.count}')
                lines.append(f"{name}_sum {inst.sum:g}")
                lines.append(f"{name}_count {inst.count}")
            else:
                lines.append(f"{name} {inst.value:g}")
        return "\n".join(lines) + "\n"

    def dump(self, path, fmt: Optional[str] = None) -> pathlib.Path:
        """Write the snapshot: JSON by default, Prometheus text when the
        path ends in ``.prom`` (or fmt='prom')."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if fmt == "prom" or (fmt is None and path.suffix == ".prom"):
            path.write_text(self.render_prometheus())
        else:
            path.write_text(json.dumps(self.snapshot(), indent=2,
                                       sort_keys=False) + "\n")
        return path
