"""The port's serving engine: continuous batching, streams equal to plain
greedy decode and to the reference engine's, every policy map and backend
bit-identical, snapshot/rollback recovery.  Mirrors tests/test_serving.py
(its engine and snapshot cases) on reduced(smollm-135m) with the W8A8 FFN
and f32 compute, from the reference's parameters."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models.config import reduced as jreduced
from repro.runtime.serving import Engine as JEngine
from repro.runtime.serving import Request as JRequest
from repro_torch.configs import registry as tregistry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.dependability import Policy
from repro_torch.core.policy_map import PolicyMap
from repro_torch.models import api as model_api
from repro_torch.models.config import reduced
from repro_torch.runtime.serving import Engine, Request

jax.config.update("jax_platform_name", "cpu")

_W8A8 = dict(quant="w8a8_ffn", compute_dtype="float32")


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")),
                               **_W8A8)
    cfg = dataclasses.replace(reduced(tregistry.get("smollm-135m")), **_W8A8)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    params = transformer_params_from_numpy(jax.device_get(jparams),
                                           device="cpu")
    return cfg, params, jcfg, jparams


def greedy_reference(cfg, params, prompt, n_new, max_len=96):
    """Plain prefill + decode loop (no engine)."""
    logits, cache = model_api.prefill(cfg, params, torch.tensor([prompt]),
                                      max_len)
    out = [int(torch.argmax(logits[0, len(prompt) - 1]))]
    tok = torch.tensor([out[-1]], dtype=torch.int32)
    for _ in range(n_new - 1):
        logits, cache = model_api.decode_step(cfg, params, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(int(tok[0]))
    return out


def _serve(eng, prompts, n_new):
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.output) for r in reqs]


def test_single_request_matches_reference(served):
    cfg, params, _, _ = served
    prompt = [5, 9, 2, 7]
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8)
    req = Request(uid=0, prompt=prompt, max_new_tokens=6)
    eng.submit(req)
    eng.run()
    assert req.output == greedy_reference(cfg, params, prompt, 6)


def test_batched_requests_match_individual(served):
    """Continuous batching must not change any request's tokens."""
    cfg, params, _, _ = served
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4, 4]]
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8)
    outs = _serve(eng, prompts, [5] * 3)
    for out, p in zip(outs, prompts):
        assert out == greedy_reference(cfg, params, p, 5)


def test_more_requests_than_capacity(served):
    cfg, params, _, _ = served
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8)
    outs = _serve(eng, [[i + 1, i + 2] for i in range(5)], [3] * 5)
    assert all(len(o) == 3 for o in outs)
    assert eng.stats.tokens_out >= 5 * 2


def test_streams_match_the_reference_engine(served):
    """The slice end to end: the port's Engine and the reference's Engine
    on the same parameters and requests give the same token streams."""
    cfg, params, jcfg, jparams = served
    prompts = [[5, 9, 2, 7], [3, 1], [8, 6, 4, 2, 1], [7]]
    n_new = [6, 4, 5, 3]
    jeng = JEngine(jcfg, jparams, capacity=2, max_len=64, prefill_pad=8)
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = Engine(cfg, params, capacity=2, max_len=64, prefill_pad=8)
    assert _serve(eng, prompts, n_new) == [list(r.output) for r in jreqs]
    assert eng.stats.steps == jeng.stats.steps
    assert eng.stats.tokens_out == jeng.stats.tokens_out


@pytest.mark.parametrize("kw", [
    {"policy_map": {"rules": [{"pattern": "ffn.*", "policy": "abft"}]}},
    {"policy_map": {"rules": [{"pattern": "ffn.*", "policy": "tmr"}]}},
    {"policy_map": PolicyMap.from_doc({"rules": [
        {"pattern": "ffn.wd", "policy": "ckpt", "backend": "ref"}]})},
    {"backend": "ref"},
], ids=["ffn_abft", "ffn_tmr", "wd_ckpt_ref", "ref_backend"])
def test_policy_maps_and_backends_serve_identically(served, kw):
    cfg, params, _, _ = served
    prompts, n_new = [[5, 9, 2, 7], [3, 1, 4]], [5, 4]
    base = _serve(Engine(cfg, params, capacity=2, max_len=64,
                         prefill_pad=8), prompts, n_new)
    eng = Engine(cfg, params, capacity=2, max_len=64, prefill_pad=8, **kw)
    assert _serve(eng, prompts, n_new) == base
    assert eng.state_scrub == "off" and eng.storage_scrub == "off"


def test_snapshot_restore_round_trips_stats_and_finished_requests(served):
    """restore_snapshot rolls back tokens_out (not just steps) and
    resurrects requests that finished after the snapshot."""
    cfg, params, _, _ = served
    prompts = [[5, 9, 2, 7], [3, 1]]

    def fresh():
        eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                     snapshot_every=2)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (8, 3)))]
        for r in reqs:
            eng.submit(r)
        return eng, reqs

    eng, reqs = fresh()
    clean_stats = eng.run()
    golden = [list(r.output) for r in reqs]

    eng, reqs = fresh()
    eng.step()
    eng.step()          # req 1 (max_new=3) finishes here, after the snapshot
    assert reqs[1].finished_at > 0
    eng.tokens[0] = 123                           # SEU in decode state
    eng.restore_snapshot()
    assert reqs[1].finished_at == 0.0
    eng.run()
    assert [list(r.output) for r in reqs] == golden
    assert eng.stats.steps == clean_stats.steps
    assert eng.stats.tokens_out == clean_stats.tokens_out
    assert eng.stats.replays == 1


def test_restore_requeues_requests_admitted_after_snapshot(served):
    cfg, params, _, _ = served
    prompts = [[5, 9, 2], [4, 4, 8, 1]]
    golden = [greedy_reference(cfg, params, p, 3) for p in prompts]
    eng = Engine(cfg, params, capacity=1, max_len=96, prefill_pad=8,
                 snapshot_every=4)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()      # snapshot@0; req0 finishes; req1 admitted at step 2
    assert reqs[0].finished_at > 0 and reqs[1].output is not None
    eng.tokens[0] = 77
    eng.restore_snapshot()
    assert reqs[1] in eng.queue                   # requeued, prefill redone
    eng.run()
    assert [list(r.output) for r in reqs] == golden
    assert eng.stats.replays == 1


def test_cancelled_request_stays_cancelled_after_restore(served):
    cfg, params, _, _ = served
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 snapshot_every=2)
    a = Request(uid=0, prompt=[5, 9, 2], max_new_tokens=6)
    b = Request(uid=1, prompt=[3, 1, 4], max_new_tokens=6)
    eng.submit(a)
    eng.submit(b)
    eng.step()                      # snapshot@0 captures both as active
    assert eng.cancel(b.uid)
    out_b = list(b.output)
    eng.restore_snapshot()
    eng.run()
    assert b.output == out_b
    assert all(r.uid != b.uid for r in eng.active.values())
    assert a.output == greedy_reference(cfg, params, a.prompt, 6)


def test_snapshot_rollback_replays_identically(served):
    cfg, params, _, _ = served
    prompt = [3, 1, 4, 1, 5]
    want = greedy_reference(cfg, params, prompt, 8)
    eng = Engine(cfg, params, capacity=1, max_len=96, prefill_pad=8,
                 snapshot_every=2)
    req = Request(uid=0, prompt=prompt, max_new_tokens=8)
    eng.submit(req)
    for _ in range(4):
        eng.step()
    eng.tokens[0] = 123
    assert eng.restore_snapshot() >= 0
    eng.run()
    assert req.output == want


def test_snapshot_survives_in_place_cache_writes(served):
    """The cache is written in place (decode_step, the slot splice), so a
    snapshot must own its copy: corrupt the live cache after the snapshot,
    keep decoding, restore twice — the streams are the fault-free ones."""
    cfg, params, _, _ = served
    prompts, n_new = [[5, 9, 2, 7], [3, 1, 4]], [7, 7]
    golden = _serve(Engine(cfg, params, capacity=2, max_len=64,
                           prefill_pad=8), prompts, n_new)
    eng = Engine(cfg, params, capacity=2, max_len=64, prefill_pad=8,
                 snapshot_every=100)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs:
        eng.submit(r)
    eng.step()                                  # snapshot, then one step
    snap_k = eng._snapshot["cache"].k.clone()
    for _ in range(2):
        eng.cache.k.mul_(-3.0)                  # SEU-scale damage, in place
        eng.cache.v.add_(5.0)
        eng.step()
        assert torch.equal(eng._snapshot["cache"].k, snap_k)
        eng.restore_snapshot()
    eng.run()
    assert [list(r.output) for r in reqs] == golden


def test_unported_engine_options_raise(served):
    """Bad modes raise; the options once refused (the scrubs, maps that
    imply them, decode windows, observers) now construct, with the
    reference's derived scrub schedule."""
    cfg, params, _, _ = served
    with pytest.raises(ValueError, match="state_scrub"):
        Engine(cfg, params, state_scrub="sometimes")
    with pytest.raises(ValueError, match="storage_scrub"):
        Engine(cfg, params, storage_scrub="sometimes")
    with pytest.raises(ValueError, match="multi_step"):
        Engine(cfg, params, multi_step=0)
    for kw, want in (({"state_scrub": "rollback"}, ("rollback", "off", 32)),
                     ({"storage_scrub": "detect"}, ("off", "detect", 1)),
                     ({"policy_map": PolicyMap.uniform(Policy.ABFT)},
                      ("detect", "detect", 1)),
                     ({"policy_map": PolicyMap.uniform(Policy.CKPT)},
                      ("rollback", "rollback", 32)),
                     ({"multi_step": 4}, ("off", "off", 32)),
                     ({"tracer": object()}, ("off", "off", 32))):
        eng = Engine(cfg, params, **kw)
        assert (eng.state_scrub, eng.storage_scrub,
                eng.storage_scrub_every) == want
