"""The port's observability layer (``repro_torch.obs``) held against
``repro.obs``: the non-``Engine`` cases of ``tests/test_obs.py`` on the
port, byte-identical exports for the same call sequence in both packages,
the committed schemas (``tools/check_obs.py``) on the port's traces and
event logs, and the campaign's synthesized timeline columns."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.campaign import faultload as fl
from repro_torch.campaign.report import ConfigResult, to_markdown
from repro_torch.campaign.runner import run_campaign
from repro_torch.core.dependability import Policy
from repro_torch.obs import (EventLog, Histogram, Registry, SpanTracer,
                             exp_buckets, merge_traces)

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_semantics():
    reg = Registry()
    c = reg.counter("reqs_total", "requests")
    c.inc()
    c.inc(4)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    assert c.value == 5 and g.value == 5
    assert reg.counter("reqs_total") is c
    with pytest.raises(TypeError):
        reg.gauge("reqs_total")


def test_histogram_exact_stats_and_bounded_memory():
    h = Histogram("lat", buckets=exp_buckets(1.0, 2.0, 8))
    n_buckets = len(h.to_dict()["buckets"])
    for i in range(10_000):
        h.observe(float(i % 250))
    assert h.count == 10_000
    assert h.min == 0.0 and h.max == 249.0
    assert h.mean() == pytest.approx(124.5)
    assert h.min <= h.percentile(0.5) <= h.max
    assert len(h.to_dict()["buckets"]) == n_buckets


def test_histogram_percentile_clamped_to_observed_range():
    h = Histogram("x", buckets=(1.0, 10.0, 100.0))
    for v in (3.0, 4.0, 5.0):
        h.observe(v)
    assert h.percentile(0.0) >= h.min
    assert h.percentile(1.0) <= h.max


def test_registry_snapshot_and_prometheus_render():
    reg = Registry()
    reg.counter("a_total", "a").inc(3)
    reg.histogram("h", "h", buckets=(1.0, 2.0)).observe(1.5)
    snap = reg.snapshot()
    assert list(snap) == ["a_total", "h"]
    text = reg.render_prometheus()
    assert "a_total 3" in text
    assert 'h_bucket{le="2"' in text or 'h_bucket{le="2.0"}' in text
    assert "h_sum" in text and "h_count 1" in text


def test_registry_dump_json_and_prom(tmp_path):
    reg = Registry()
    reg.counter("c_total").inc()
    jpath = reg.dump(tmp_path / "m.json")
    assert json.loads(jpath.read_text())["c_total"]["value"] == 1
    ppath = reg.dump(tmp_path / "m.prom")
    assert "c_total 1" in ppath.read_text()


# ---------------------------------------------------------------------------
# Span tracer primitives
# ---------------------------------------------------------------------------


def _build_tracer(obs, name="engine", pid=0):
    tr = obs.SpanTracer(name=name, pid=pid)
    tr.tick_to(1)
    tr.open_span(0, "admit", prompt_len=3)
    tr.tick_to(2)
    tr.close_span(0, "admit")
    tr.open_span(0, "prefill")
    tr.tick_to(4)
    tr.close_span(0, "prefill", tokens=3)
    tr.instant("strike", site="kv_cache")
    tr.counter("queue_depth", submit=2, decode=1)
    tr.open_span(1, "decode")          # left open: flushed as unfinished
    tr.open_span(2, "prefill")
    tr.cancel_span(2, "prefill")
    return tr


def test_tracer_span_lifecycle_and_canonical_bytes():
    a, b = _build_tracer(tobs), _build_tracer(tobs)
    assert a.to_bytes() == b.to_bytes()
    doc = a.to_chrome_trace()
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {"admit", "prefill", "decode"} == {e["name"] for e in spans}
    admit = next(e for e in spans if e["name"] == "admit")
    assert admit["ts"] == 1 and admit["dur"] == 1
    assert admit["args"]["uid"] == 0 and admit["args"]["prompt_len"] == 3
    open_flush = next(e for e in spans if e["name"] == "decode")
    assert open_flush["args"]["unfinished"] is True
    assert doc["metadata"]["clock"] == "ticks"


def test_tracer_cancel_drops_span_silently():
    tr = SpanTracer()
    tr.open_span(7, "prefill")
    tr.cancel_span(7, "prefill")
    tr.close_span(7, "prefill")            # not open: silent no-op
    assert not [e for e in tr.events if e["ph"] == "X"]


def test_merge_traces_keeps_pids_distinct():
    a, b = SpanTracer(name="replica0", pid=0), SpanTracer(name="replica1",
                                                          pid=1)
    for tr in (a, b):
        tr.open_span(0, "decode")
        tr.tick_to(3)
        tr.close_span(0, "decode")
    doc = merge_traces([a, b])
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
    assert doc["metadata"]["tracer"] == "replica0+replica1"


# ---------------------------------------------------------------------------
# Event log
# ---------------------------------------------------------------------------


def test_event_log_validates_kind_and_merges_ctx():
    log = EventLog(policy="ckpt", replica=2)
    ev = log.emit("strike", tick=4, site="kv_cache", fault="single_bitflip")
    assert ev.policy == "ckpt" and ev.replica == 2 and ev.site == "kv_cache"
    with pytest.raises(ValueError):
        log.emit("meteor", tick=5)


def test_event_log_timeline_reconstruction():
    log = EventLog(policy="ckpt")
    log.emit("strike", tick=10, site="kv_cache")
    log.emit("detection", tick=12, site="decode_state")
    log.emit("rollback", tick=13, seconds=0.5)
    log.emit("strike", tick=20, site="weights")      # undetected chain
    tls = log.timelines()
    assert len(tls) == 2
    first, second = tls
    assert first["detected"] and first["detection_latency_ticks"] == 2
    assert first["recovered"] and first["recovery_latency_ticks"] == 3
    assert first["recovery_seconds"] == 0.5
    assert not second["detected"] and not second["recovered"]
    summary = log.latency_summary()["ckpt"]
    assert summary["strikes"] == 2 and summary["detected"] == 1
    assert summary["detection_ticks_mean"] == 2.0


def test_event_log_wall_flag_strips_seconds():
    log = EventLog()
    log.emit("strike", tick=1)
    log.emit("recovery", tick=2, seconds=1.25)
    with_wall = log.to_json(wall=True)
    without = log.to_json(wall=False)
    assert with_wall["events"][1]["seconds"] == 1.25
    assert all("seconds" not in e for e in without["events"])
    assert all("recovery_seconds" not in t for t in without["timelines"])


# ---------------------------------------------------------------------------
# The same calls give the same bytes in both packages
# ---------------------------------------------------------------------------


def _build_registry(obs):
    reg = obs.Registry()
    reg.counter("tokens_total", "tokens out").inc(17)
    g = reg.gauge("queue_depth", "queued requests")
    g.set(4)
    g.inc(2.5)
    g.dec()
    h = reg.histogram("latency_ticks", "request latency",
                      buckets=obs.exp_buckets(1.0, 2.0, 6))
    for v in (0.5, 1.0, 3.0, 7.5, 40.0, 1e3):
        h.observe(v)
    reg.histogram("empty", "never observed", buckets=(1.0,))
    return reg


def _build_events(obs):
    log = obs.EventLog(policy="ckpt", replica=1)
    log.emit("strike", tick=3, site="kv_cache", fault="mbu_burst",
             detail={"leaf": "k", "index": 12})
    log.emit("detection", tick=5, site="kv_cache",
             detail={"check": "state_scrub"})
    log.emit("rollback", tick=6, seconds=0.125, detail={"steps": 2})
    log.emit("strike", tick=9, site="weights", fault="single_bitflip")
    log.emit("quarantine", tick=10, replica=0)
    log.emit("recovery", tick=12, seconds=2.5,
             detail={"action": "incremental_restore"})
    log.emit("failover", tick=12, replica=1)
    log.emit("strike", tick=20, site="decode_state")
    log.emit("detection", tick=20, site="decode_state",
             detail={"check": "in_op"})
    return log


@pytest.mark.parametrize("fmt", ["json", "prom"])
def test_registry_bytes_equal_reference(tmp_path, fmt):
    paths = [_build_registry(obs).dump(tmp_path / f"{name}.{fmt}")
             for name, obs in (("ref", jobs), ("port", tobs))]
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert _build_registry(jobs).snapshot() == _build_registry(tobs).snapshot()
    assert _build_registry(jobs).render_prometheus() \
        == _build_registry(tobs).render_prometheus()


def test_tracer_bytes_equal_reference(tmp_path):
    assert _build_tracer(jobs).to_bytes() == _build_tracer(tobs).to_bytes()
    merged = []
    for name, obs in (("ref", jobs), ("port", tobs)):
        tracers = [_build_tracer(obs, f"replica{i}", i) for i in range(2)]
        merged.append(obs.dump_merged(tracers, tmp_path / f"{name}.json"))
    assert merged[0].read_bytes() == merged[1].read_bytes()


@pytest.mark.parametrize("wall", [True, False])
def test_event_log_equal_reference(tmp_path, wall):
    ref, port = _build_events(jobs), _build_events(tobs)
    assert ref.timelines() == port.timelines()
    assert ref.latency_summary() == port.latency_summary()
    assert ref.to_json(wall=wall) == port.to_json(wall=wall)
    a = ref.dump(tmp_path / "ref.json", wall=wall)
    b = port.dump(tmp_path / "port.json", wall=wall)
    assert a.read_bytes() == b.read_bytes()
    assert [e.to_dict() for e in ref.drain()] \
        == [e.to_dict() for e in port.drain()]


def _check_obs(*args):
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs.py"), *args],
        capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("kind", ["trace", "events"])
def test_port_artifacts_pass_check_obs(tmp_path, kind):
    if kind == "trace":
        path = tobs.dump_merged([_build_tracer(tobs, f"replica{i}", i)
                                 for i in range(2)], tmp_path / "t.json")
    else:
        path = _build_events(tobs).dump(tmp_path / "e.json")
    done = _check_obs(f"--{kind}", str(path))
    assert done.returncode == 0, done.stdout + done.stderr
    assert "ok" in done.stdout


def test_check_obs_rejects_a_broken_port_trace(tmp_path):
    """The gate is live: a span without its uid fails the schema run."""
    doc = _build_tracer(tobs).to_chrome_trace()
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            ev["args"].pop("uid")
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(doc))
    assert _check_obs("--trace", str(path)).returncode == 1


# ---------------------------------------------------------------------------
# Campaign timeline columns
# ---------------------------------------------------------------------------


def test_campaign_accumulator_site_synthesized_timelines():
    """The kernel cases emit no host events; the runner synthesizes the
    chains from trial verdicts — ABFT detects every accumulator strike,
    NONE never does, CKPT detects and recovers on the same tick."""
    specs = fl.expand_grid(["qmatmul"], [Policy.NONE, Policy.ABFT,
                                         Policy.CKPT],
                           ["accumulator"], ["single_bitflip"], 8, 0)
    sink = []
    results = {r.policy: r for r in run_campaign(specs, event_sink=sink,
                                                 device="cpu")}
    assert results["abft"].strikes_logged == 8
    assert results["abft"].detections_logged == 8
    assert results["none"].detections_logged == 0
    ck = results["ckpt"]
    assert ck.detections_logged == 8 and ck.faults_recovered == 8
    assert ck.detection_ticks_max == 0 and ck.recovery_ticks_max == 0
    assert [e["config"] for e in sink] == [s.label() for s in specs]
    assert all(len(e["timelines"]) == 8 for e in sink)


def test_config_result_timeline_columns_round_trip():
    r = ConfigResult(workload="serving", policy="ckpt", site="kv_cache",
                     fault_model="single_bitflip", trials=4, masked=0,
                     detected_corrected=4, detected_uncorrected=0, sdc=0,
                     faults_recovered=4, strikes_logged=4,
                     detections_logged=4, detection_ticks_mean=1.5,
                     detection_ticks_max=3, recovery_ticks_mean=2.0,
                     recovery_ticks_max=4)
    assert ConfigResult.from_dict(r.to_dict()) == r
    legacy = {k: v for k, v in r.to_dict().items()
              if not k.startswith(("strikes_", "detections_",
                                   "detection_", "recovery_ticks"))}
    old = ConfigResult.from_dict(legacy)
    assert old.strikes_logged == 0 and old.detection_ticks_mean == 0.0
    md = to_markdown([r])
    assert "det. lat ticks (mean/max)" in md
    assert "| 1.5/3 |" in md and "| 2.0/4 |" in md
