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


# ---------------------------------------------------------------------------
# Engine traces of tests/test_obs.py's TRACE_ARCHS, the recurrent one
# (smollm-135m's cases are in test_torch_serving_scrub.py)
# ---------------------------------------------------------------------------

TRACE_ARCHS = ["smollm-135m", "rwkv6-1.6b"]


@pytest.fixture(scope="module", params=TRACE_ARCHS[1:])
def traced_pair(request):
    """reduced(rwkv6-1.6b) in f32, the reference's parameters in both
    packages."""
    import dataclasses

    import jax
    from repro.configs import registry as jregistry
    from repro.models import api as japi
    from repro.models.config import reduced as jreduced
    from repro_torch.configs import registry as tregistry
    from repro_torch.convert import rwkv6_params_from_numpy
    from repro_torch.models.config import reduced
    jax.config.update("jax_platform_name", "cpu")
    f32 = dict(compute_dtype="float32")
    jcfg = dataclasses.replace(jreduced(jregistry.get(request.param)), **f32)
    cfg = dataclasses.replace(reduced(tregistry.get(request.param)), **f32)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    return cfg, rwkv6_params_from_numpy(jax.device_get(jparams),
                                        device="cpu"), jcfg, jparams


def _flip_token_buffer(eng, jax_side):
    """An addressed flip of bit 3 of slot 0's token, in either package."""
    if jax_side:
        toks = eng.tokens
        eng.strike("decode_state", lambda x, k: x.at[0].set(x[0] ^ 8), None)
        assert eng.tokens is not toks
    else:
        from repro_torch.core import fault_injection as fi
        eng.strike("decode_state",
                   lambda x, g: fi.flip_bit_at_index(x, 0, 3), None)


def _traced_serve(side, pair, *, multi_step=1, rollback=False, **obs):
    from repro.runtime.serving import Engine as JEngine
    from repro.runtime.serving import Request as JRequest
    from repro_torch.runtime.serving import Engine, Request
    cfg, params, jcfg, jparams = pair
    jax_side = side == "jax"
    E, R = (JEngine, JRequest) if jax_side else (Engine, Request)
    tracer = (jobs.SpanTracer if jax_side else SpanTracer)()
    eng = E(*((jcfg, jparams) if jax_side else (cfg, params)),
            capacity=2, max_len=96, prefill_pad=8, multi_step=multi_step,
            snapshot_every=2 if rollback else 32,
            state_scrub="rollback" if rollback else "off", tracer=tracer,
            **obs)
    reqs = [R(uid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate([[5, 9, 2], [3, 1, 4, 1], [2, 7]])]
    for r in reqs:
        eng.submit(r)
    if rollback:
        eng.step()              # both first requests still decoding
        _flip_token_buffer(eng, jax_side)
    eng.run()
    return tracer, [list(r.output) for r in reqs], eng


@pytest.mark.parametrize("multi_step,rollback", [(1, False), (4, False),
                                                 (2, True)],
                         ids=["per_step", "multi_step", "rollback"])
def test_recurrent_traces_are_byte_identical(traced_pair, multi_step,
                                             rollback):
    tr_a, out_a, _ = _traced_serve("torch", traced_pair,
                                   multi_step=multi_step, rollback=rollback)
    tr_b, out_b, _ = _traced_serve("torch", traced_pair,
                                   multi_step=multi_step, rollback=rollback)
    assert out_a == out_b and tr_a.to_bytes() == tr_b.to_bytes()
    tr_j, out_j, _ = _traced_serve("jax", traced_pair,
                                   multi_step=multi_step, rollback=rollback)
    assert out_a == out_j and tr_a.to_bytes() == tr_j.to_bytes()
    spans = [e for e in tr_a.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"admit", "prefill", "decode",
                                          "certify"}
    certified = [e for e in spans if e["name"] == "certify"]
    assert len(certified) == 3
    assert all(e["args"]["certified"] for e in certified)
    names = [e["name"] for e in tr_a.events if e["ph"] == "i"]
    assert ("strike" in names and "rollback" in names) == rollback


def test_recurrent_tracing_is_a_pure_observer(traced_pair):
    from repro_torch.runtime.serving import Engine, Request
    cfg, params = traced_pair[:2]
    _, traced, _ = _traced_serve("torch", traced_pair, multi_step=2,
                                 rollback=True)
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 multi_step=2, snapshot_every=2, state_scrub="rollback")
    assert eng.tracer is None
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate([[5, 9, 2], [3, 1, 4, 1], [2, 7]])]
    for r in reqs:
        eng.submit(r)
    eng.step()
    _flip_token_buffer(eng, False)
    eng.run()
    assert [list(r.output) for r in reqs] == traced


def test_recurrent_engine_metrics_and_events_equal_reference(traced_pair):
    reg, jreg = Registry(), jobs.Registry()
    log, jlog = EventLog(policy="ckpt"), jobs.EventLog(policy="ckpt")
    _, _, eng = _traced_serve("torch", traced_pair, rollback=True,
                              metrics=reg, event_log=log)
    _traced_serve("jax", traced_pair, rollback=True, metrics=jreg,
                  event_log=jlog)
    snap = reg.snapshot()
    assert snap["engine_requests_released_total"]["value"] == 3
    assert snap["engine_tokens_out_total"]["value"] == eng.stats.tokens_out
    assert json.dumps(snap, sort_keys=True) \
        == json.dumps(jreg.snapshot(), sort_keys=True)
    kinds = [e.kind for e in log]
    assert kinds.count("strike") == 1
    assert "detection" in kinds and "rollback" in kinds
    assert json.dumps(log.to_json(wall=False), sort_keys=True) \
        == json.dumps(jlog.to_json(wall=False), sort_keys=True)
