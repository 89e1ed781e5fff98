"""The engine's scrubs, strikes and observers held against the reference's.

The decode-state scrub cases of tests/test_serving.py (rollback restores
the golden stream after a token-buffer or KV-cache strike, detect raises
one alarm, no false positives on a clean run, a struck snapshot is
refused, bad modes are rejected, the recurrent family's in-place state
covered as well), the storage-scrub cases of
tests/test_policy_map.py (the golden restore, the detect latch, the derived
schedule) and the ``Engine`` cases of tests/test_obs.py (traces of two
same-seed runs byte-identical, per step, windowed and across a rollback;
tracing a pure observer; metrics equal to the stats; provenance-stamped
events), each with the int8 KV cache off and on where it applies.  Both
packages serve ``reduced(smollm-135m)`` (W8A8 FFN, f32 compute) from the
reference's parameters and take the same addressed strikes, so the
streams, the scrub events, the trace bytes, the metrics bytes and the
event logs are the reference's, byte for byte."""
from __future__ import annotations

import dataclasses
import json

import jax
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import fault_injection as jfi
from repro.models import api as japi
from repro.models.config import reduced as jreduced
from repro.obs import EventLog as JEventLog
from repro.obs import Registry as JRegistry
from repro.obs import SpanTracer as JSpanTracer
from repro.runtime.serving import Engine as JEngine
from repro.runtime.serving import Request as JRequest
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.convert import (rwkv6_params_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.core import fault_injection as fi
from repro_torch.core.dependability import Policy
from repro_torch.core.policy_map import PolicyMap, PolicyRule
from repro_torch.models.config import reduced
from repro_torch.obs import EventLog, Registry, SpanTracer
from repro_torch.runtime.serving import Engine, Request

jax.config.update("jax_platform_name", "cpu")

_W8A8 = dict(quant="w8a8_ffn", compute_dtype="float32")


@pytest.fixture(scope="module", params=[False, True], ids=["f32kv",
                                                           "int8kv"])
def served(request):
    kw = dict(_W8A8, quant_kv=request.param)
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")), **kw)
    cfg = dataclasses.replace(reduced(tregistry.get("smollm-135m")), **kw)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    params = transformer_params_from_numpy(jax.device_get(jparams),
                                           device="cpu")
    return cfg, params, jcfg, jparams


# the same addressed strikes in both packages: flip ``bit`` of flat element
# ``index`` of the struck tensor (the cache's k page, or the token buffer)

def _t_flip(index, bit):
    def addressed_flip(x, gen):
        return fi.flip_bit_at_index(x, index % x.numel(), bit)
    return addressed_flip


def _j_flip(index, bit):
    def addressed_flip(x, key):
        bits, u = jfi._as_bits(x)
        flat = bits.reshape(-1)
        i = index % flat.shape[0]
        flat = flat.at[i].set(flat[i] ^ u(1 << bit))
        return jax.lax.bitcast_convert_type(flat.reshape(x.shape), x.dtype)
    return addressed_flip


def _hit_tokens(eng, jax_side):
    f = (_j_flip if jax_side else _t_flip)(0, 3)
    key = jax.random.key(3) if jax_side else None
    eng.strike("decode_state", f, key)


def _hit_cache(eng, jax_side):
    f = (_j_flip if jax_side else _t_flip)(1000, 29 if eng.cache.k_s is None
                                           else 5)
    if jax_side:
        eng.cache = eng.cache._replace(k=f(eng.cache.k, None))
    else:
        eng.strike("kv_cache", f, None, leaf=("k",))


def _serve_with_scrub(side, served, mode, strike=None, strike_at=2, **kw):
    cfg, params, jcfg, jparams = served
    E, R = (JEngine, JRequest) if side == "jax" else (Engine, Request)
    eng = E(*((jcfg, jparams) if side == "jax" else (cfg, params)),
            capacity=2, max_len=96, prefill_pad=8, snapshot_every=2,
            state_scrub=mode, **kw)
    reqs = [R(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate([[5, 9, 2], [3, 1, 4, 1]])]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while (eng.queue or eng.active) and steps < 200:
        eng.step()
        steps += 1
        if steps == strike_at and strike is not None:
            strike(eng, side == "jax")
    return [tuple(r.output) for r in reqs], eng


def _events(eng):
    return [{k: v for k, v in e.items() if k != "seconds"}
            for e in eng.drain_state_events()]


@pytest.mark.parametrize("strike", [_hit_tokens, _hit_cache],
                         ids=["decode_state", "kv_cache"])
def test_state_scrub_rollback_restores_golden_stream(served, strike):
    golden, _ = _serve_with_scrub("torch", served, "off")
    out, eng = _serve_with_scrub("torch", served, "rollback", strike)
    assert out == golden
    events = eng.drain_state_events()
    assert len(events) == 1 and events[0]["recovered"]
    assert events[0]["seconds"] > 0
    assert int(eng.dependability["faults_detected"]) == 1
    assert int(eng.dependability["faults_recovered"]) == 1
    assert eng.stats.replays == 1
    jout, jeng = _serve_with_scrub("jax", served, "rollback", strike)
    assert jout == out
    assert jeng.stats.replays == 1


def test_state_scrub_recurrent_family():
    """Recurrent caches are rewritten in place every step (not append-only):
    the post-mutation re-checksum covers them.  rwkv6 (reduced, f32) with
    an addressed flip in the WKV state: one detection, rolled back, the
    golden stream, as in the reference."""
    f32 = dict(compute_dtype="float32")
    jcfg = dataclasses.replace(jreduced(jregistry.get("rwkv6-1.6b")), **f32)
    cfg = dataclasses.replace(reduced(tregistry.get("rwkv6-1.6b")), **f32)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    pair = (cfg, rwkv6_params_from_numpy(jax.device_get(jparams),
                                         device="cpu"), jcfg, jparams)

    def hit_state(eng, jax_side):
        f = (_j_flip if jax_side else _t_flip)(1000, 29)
        if jax_side:
            eng.cache = eng.cache._replace(tm_s=f(eng.cache.tm_s, None))
        else:
            eng.strike("kv_cache", f, None, leaf=("tm_s",))

    golden, _ = _serve_with_scrub("torch", pair, "off")
    out, eng = _serve_with_scrub("torch", pair, "rollback", hit_state)
    assert out == golden
    ev = eng.drain_state_events()
    assert len(ev) == 1 and ev[0]["recovered"]
    jout, jeng = _serve_with_scrub("jax", pair, "rollback", hit_state)
    assert jout == out
    assert jeng.stats.replays == eng.stats.replays == 1


def test_state_scrub_detect_mode_raises_alarm_only(served):
    out, eng = _serve_with_scrub("torch", served, "detect", _hit_tokens)
    events = _events(eng)
    assert len(events) == 1 and not events[0]["recovered"]
    assert eng.stats.replays == 0
    assert int(eng.dependability["faults_detected"]) == 1
    assert int(eng.dependability["faults_recovered"]) == 0
    jout, jeng = _serve_with_scrub("jax", served, "detect", _hit_tokens)
    assert (jout, _events(jeng)) == (out, events)


def test_state_scrub_clean_run_no_false_positives(served):
    golden, _ = _serve_with_scrub("torch", served, "off")
    out, eng = _serve_with_scrub("torch", served, "rollback")
    assert out == golden
    assert eng.drain_state_events() == []
    assert int(eng.dependability["faults_detected"]) == 0
    assert int(eng.dependability["checks_run"]) > 0
    _, jeng = _serve_with_scrub("jax", served, "rollback")
    assert int(eng.dependability["checks_run"]) \
        == int(jeng.dependability["checks_run"])


def test_corrupted_snapshot_is_refused(served):
    cfg, params, _, _ = served
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 snapshot_every=2, state_scrub="rollback")
    eng.submit(Request(uid=0, prompt=[5, 9, 2], max_new_tokens=6))
    eng.step()
    eng.step()
    assert eng._snapshot is not None
    eng._snapshot["tokens"] = fi.flip_one_bit(eng._snapshot["tokens"],
                                              torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="snapshot failed checksum"):
        eng.restore_snapshot()


def test_snapshot_is_a_clone_the_live_state_cannot_reach(served):
    """A strike on the live cache after a snapshot leaves the snapshot and
    its checksums intact, so a rollback restores clean state."""
    cfg, params, _, _ = served
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 snapshot_every=100, state_scrub="rollback")
    eng.submit(Request(uid=0, prompt=[5, 9, 2], max_new_tokens=6))
    eng.step()
    snap = [t.clone() for t in tree.leaves(eng._snapshot["cache"])]
    eng.cache.k.view(-1)[7] = eng.cache.k.view(-1)[7] + 1   # in place
    assert all(torch.equal(a, b) for a, b in
               zip(snap, tree.leaves(eng._snapshot["cache"])))
    eng.restore_snapshot()
    assert all(torch.equal(a, b) for a, b in
               zip(snap, tree.leaves(eng.cache)))


def test_state_scrub_invalid_mode_rejected(served):
    cfg, params, _, _ = served
    with pytest.raises(ValueError, match="state_scrub"):
        Engine(cfg, params, state_scrub="sometimes")
    eng = Engine(cfg, params)
    with pytest.raises(ValueError, match="state_scrub"):
        eng.state_scrub = "sometimes"
    eng.state_scrub = "detect"
    assert eng.state_scrub == "detect"


# ---------------------------------------------------------------------------
# Storage scrubbing (tests/test_policy_map.py's engine cases)
# ---------------------------------------------------------------------------


def _serve_once(eng, strike_at=None, strike=None):
    eng.reset()
    reqs = [Request(uid=i, prompt=[5, 9, 2 + i], max_new_tokens=4)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    step = 0
    while (eng.queue or eng.active) and step < 100:
        eng.step()
        step += 1
        if step == strike_at:
            strike(eng)
    return [tuple(r.output) for r in reqs]


def _hit_weight(eng):
    eng.strike("weights", _t_flip(17, 30), None,
               leaf=("dense_blocks", "wq"))


def test_engine_policy_map_derives_scrubs_and_stays_bit_identical(served):
    cfg, params, _, _ = served
    base = Engine(cfg, params, capacity=2, max_len=48, prefill_pad=8)
    pm = PolicyMap(rules=(PolicyRule("ffn.*", Policy.ABFT),
                          PolicyRule("weights", Policy.CKPT),
                          PolicyRule("kv_cache", Policy.ABFT),
                          PolicyRule("decode_state", Policy.ABFT)))
    mapped = Engine(cfg, params, capacity=2, max_len=48, prefill_pad=8,
                    policy_map=pm)
    assert mapped.state_scrub == "detect"
    assert mapped.storage_scrub == "rollback"
    assert mapped.storage_scrub_every == mapped.snapshot_every
    assert _serve_once(mapped) == _serve_once(base)
    rep = mapped.dependability_report()
    assert rep["storage_scrub"] == "rollback"
    assert rep["faults_detected"] == 0 and rep["checks_run"] > 0


def test_engine_storage_scrub_rollback_recovers_weight_strike(served):
    cfg, params, _, _ = served
    golden_params = [t.clone() for t in tree.leaves(params)]
    eng = Engine(cfg, params, capacity=2, max_len=48, prefill_pad=8,
                 policy_map=PolicyMap(rules=(PolicyRule("weights",
                                                        Policy.CKPT),)),
                 storage_scrub_every=1)
    golden = _serve_once(eng)
    assert _serve_once(eng, 1, _hit_weight) == golden
    events = [e for e in eng.drain_state_events()
              if e.get("site") == "weights"]
    assert len(events) == 1 and events[0]["recovered"]
    assert eng.scrub_storage()
    # the restored parameters are a clone: writing into them in place
    # reaches neither the golden copy nor the caller's parameters
    eng.params["dense_blocks"]["wq"].view(-1)[0] += 1.0
    assert not eng.scrub_storage()
    assert all(torch.equal(a, b) for a, b in zip(
        golden_params, tree.leaves(eng.executor._golden_params)))
    assert all(torch.equal(a, b) for a, b in zip(golden_params,
                                                 tree.leaves(params)))


def test_engine_storage_scrub_detect_latches_one_alarm(served):
    cfg, params, _, _ = served
    eng = Engine(cfg, params, capacity=2, max_len=48, prefill_pad=8,
                 policy_map=PolicyMap(rules=(PolicyRule("weights",
                                                        Policy.ABFT),)))
    assert eng.storage_scrub == "detect" and eng.storage_scrub_every == 1
    _serve_once(eng, 1, _hit_weight)
    weight_events = [e for e in eng.drain_state_events()
                     if e.get("site") == "weights"]
    assert len(weight_events) == 1
    assert not weight_events[0]["recovered"]
    # reset() clears the latch; refresh_storage_baseline() re-blesses
    eng.reset()
    assert not eng.scrub_storage()
    eng.refresh_storage_baseline()
    assert eng.scrub_storage()


# ---------------------------------------------------------------------------
# Observers (tests/test_obs.py's engine cases), byte for byte
# ---------------------------------------------------------------------------


def _traced_serve(side, served, *, multi_step=1, rollback=False,
                  metrics=None, event_log=None):
    cfg, params, jcfg, jparams = served
    jax_side = side == "jax"
    E, R, T = ((JEngine, JRequest, JSpanTracer) if jax_side
               else (Engine, Request, SpanTracer))
    tracer = T()
    eng = E(*((jcfg, jparams) if jax_side else (cfg, params)),
            capacity=2, max_len=96, prefill_pad=8, multi_step=multi_step,
            snapshot_every=2 if rollback else 32,
            state_scrub="rollback" if rollback else "off", tracer=tracer,
            metrics=metrics, event_log=event_log)
    reqs = [R(uid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate([[5, 9, 2], [3, 1, 4, 1], [2, 7]])]
    for r in reqs:
        eng.submit(r)
    if rollback:
        eng.step()              # both first requests still decoding
        _hit_tokens(eng, jax_side)
    eng.run()
    return tracer, [list(r.output) for r in reqs], eng


@pytest.mark.parametrize("multi_step,rollback", [(1, False), (4, False),
                                                 (2, True)],
                         ids=["per_step", "multi_step", "rollback"])
def test_traces_are_byte_identical(served, multi_step, rollback):
    tr_a, out_a, _ = _traced_serve("torch", served, multi_step=multi_step,
                                   rollback=rollback)
    tr_b, out_b, _ = _traced_serve("torch", served, multi_step=multi_step,
                                   rollback=rollback)
    assert out_a == out_b
    assert tr_a.to_bytes() == tr_b.to_bytes()
    tr_j, out_j, _ = _traced_serve("jax", served, multi_step=multi_step,
                                   rollback=rollback)
    assert out_a == out_j
    assert tr_a.to_bytes() == tr_j.to_bytes()
    spans = [e for e in tr_a.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"admit", "prefill", "decode",
                                          "certify"}
    certified = [e for e in spans if e["name"] == "certify"]
    assert all(e["args"]["certified"] for e in certified)
    assert len({e["args"]["uid"] for e in certified}) == 3
    names = [e["name"] for e in tr_a.events if e["ph"] == "i"]
    assert ("strike" in names and "rollback" in names) == rollback


def test_tracing_is_a_pure_observer(served):
    _, traced, _ = _traced_serve("torch", served, multi_step=2,
                                 rollback=True)
    cfg, params, _, _ = served
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 multi_step=2, snapshot_every=2, state_scrub="rollback")
    assert eng.tracer is None and eng.event_log is None \
        and eng.metrics is None
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate([[5, 9, 2], [3, 1, 4, 1], [2, 7]])]
    for r in reqs:
        eng.submit(r)
    eng.step()
    _hit_tokens(eng, False)
    eng.run()
    assert [list(r.output) for r in reqs] == traced
    assert eng.stats.replays == 1


def test_engine_metrics_counters_match_stats(served):
    reg, jreg = Registry(), JRegistry()
    _, _, eng = _traced_serve("torch", served, metrics=reg)
    _traced_serve("jax", served, metrics=jreg)
    snap = reg.snapshot()
    assert snap["engine_requests_submitted_total"]["value"] == 3
    assert snap["engine_requests_released_total"]["value"] == 3
    assert snap["engine_tokens_out_total"]["value"] == eng.stats.tokens_out
    assert snap["engine_release_latency_ticks"]["count"] == 3
    assert json.dumps(snap, sort_keys=True) \
        == json.dumps(jreg.snapshot(), sort_keys=True)
    assert reg.render_prometheus() == jreg.render_prometheus()


def test_engine_emits_provenance_stamped_events(served):
    log, jlog = EventLog(policy="ckpt"), JEventLog(policy="ckpt")
    _traced_serve("torch", served, multi_step=1, rollback=True,
                  event_log=log)
    _traced_serve("jax", served, multi_step=1, rollback=True,
                  event_log=jlog)
    kinds = [e.kind for e in log]
    assert kinds.count("strike") == 1
    assert "detection" in kinds and "rollback" in kinds
    strike = log.of_kind("strike")[0]
    assert strike.site == "decode_state" and strike.fault == "addressed_flip"
    assert strike.policy == "ckpt"
    (tl,) = log.timelines()
    assert tl["detected"] and tl["recovered"]
    assert tl["detection_latency_ticks"] >= 0
    assert json.dumps(log.to_json(wall=False), sort_keys=True) \
        == json.dumps(jlog.to_json(wall=False), sort_keys=True)


def test_record_dependability_surfaces_detections_as_events(served):
    cfg, params, _, _ = served
    log = EventLog()
    eng = Engine(cfg, params, event_log=log)
    eng.record_dependability({"faults_detected": torch.tensor(2),
                              "checks_run": 1})
    eng.record_dependability({"faults_detected": 0, "checks_run": 1})
    (ev,) = list(log)
    assert ev.kind == "detection" and ev.detail == {"check": "dependability",
                                                    "count": 2}
    assert int(eng.dependability["checks_run"]) == 2
    assert int(eng.dependability["faults_detected"]) == 2
