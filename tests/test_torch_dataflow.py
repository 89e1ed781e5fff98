"""The port's streaming dataflow executor: the transformer-family cases of
tests/test_dataflow.py — the Channel primitives (blocking put/get, close,
the two property tests), the source stage under the threaded driver and
``data.pipeline.prefetch``, mid-decode joins, the drain barrier, strike
routing and the scrub that catches it, the certify gate, max-len
truncation at ``multi_step`` 1 and 4, bit-identical decode windows and a
windowed snapshot rollback — on ``reduced(smollm-135m)`` with the W8A8 FFN
and f32 compute, from the reference's parameters, with the token streams
also held against the reference's engine."""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models.config import reduced as jreduced
from repro.runtime.serving import Engine as JEngine
from repro.runtime.serving import Request as JRequest
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core import fault_injection as fi
from repro_torch.data import pipeline as dp
from repro_torch.models import api as model_api
from repro_torch.models.config import ShapeConfig, reduced
from repro_torch.runtime import dataflow as df
from repro_torch.runtime.serving import Engine, Request

jax.config.update("jax_platform_name", "cpu")

_W8A8 = dict(quant="w8a8_ffn", compute_dtype="float32")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# Channel / stage primitives
# ---------------------------------------------------------------------------


def test_channel_fifo_and_capacity():
    ch = df.Channel(2, "t")
    assert ch.try_put(1) and ch.try_put(2)
    assert ch.full() and not ch.try_put(3)
    assert ch.try_get() == 1
    assert ch.try_put(3)
    assert [ch.try_get(), ch.try_get()] == [2, 3]
    assert df.Channel.is_empty_token(ch.try_get())


def test_channel_blocking_put_unblocks_on_get():
    ch = df.Channel(1)
    ch.put("a")
    got = []

    def producer():
        ch.put("b")               # blocks until the consumer makes room
        got.append("sent")

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not got                # still blocked at capacity
    assert ch.get() == "a"
    t.join(timeout=2.0)
    assert got == ["sent"] and ch.get() == "b"


def test_channel_close_raises_closed():
    ch = df.Channel(1)
    ch.close()
    with pytest.raises(df.Closed):
        ch.put(1)
    with pytest.raises(df.Closed):
        ch.get()


def test_source_stage_cooperative_pump_is_ordered():
    out = df.Channel(3)
    stage = df.SourceStage(lambda i: i * 10, out, start=4)
    assert stage.pump()
    assert list(out) == [40, 50, 60]
    assert out.try_get() == 40
    stage.pump()
    assert list(out) == [50, 60, 70]


def test_threaded_source_streams_deterministically():
    out = df.Channel(2)
    driver = df.ThreadedSource(df.SourceStage(lambda i: i, out)).start()
    assert [out.get() for _ in range(20)] == list(range(20))
    driver.close()
    assert not driver._thread.is_alive()


def test_prefetch_matches_sync():
    cfg = reduced(tregistry.get("smollm-135m"))
    s = dp.TokenStream(cfg, ShapeConfig("t", seq_len=32, global_batch=8,
                                        kind="train"), seed=2)
    it = dp.prefetch(s, start_step=5, depth=2)
    for expect in (5, 6, 7):
        step, batch = next(it)
        assert step == expect
        np.testing.assert_array_equal(batch["tokens"],
                                      s.batch_at(expect)["tokens"])
    it.close()


@pytest.mark.parametrize("seed", range(8))
def test_channel_random_interleaving_fifo_no_loss_no_dup(seed):
    """Under any seeded schedule of try_put/try_get a channel never loses,
    duplicates or reorders an item, and refuses iff full (or empty)."""
    rng = random.Random(seed)
    ch = df.Channel(rng.choice([0, 1, 2, 5]), f"prop{seed}")
    sent, got, nxt = [], [], 0
    for _ in range(500):
        if rng.random() < 0.5:
            was_full = ch.full()
            accepted = ch.try_put(nxt)
            assert accepted == (not was_full)
            if accepted:
                sent.append(nxt)
                nxt += 1
        else:
            was_empty = len(ch) == 0
            item = ch.try_get()
            assert df.Channel.is_empty_token(item) == was_empty
            if not was_empty:
                got.append(item)
    assert got + ch.drain() == sent


@pytest.mark.parametrize("seed", range(4))
def test_channel_streaming_close_propagates_exactly_once(seed):
    """Closing under concurrent blocking put/get wakes both sides, each
    sees ``Closed`` exactly once, and every item put is delivered."""
    rng = random.Random(seed)
    ch = df.Channel(rng.choice([1, 2, 4]), f"close{seed}")
    produced, consumed = [], []
    closed_seen = {"producer": 0, "consumer": 0}

    def producer():
        i = 0
        while True:
            try:
                ch.put(i)
            except df.Closed:
                closed_seen["producer"] += 1
                return
            produced.append(i)
            i += 1

    def consumer():
        while True:
            try:
                consumed.append(ch.get())
            except df.Closed:
                closed_seen["consumer"] += 1
                return

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start()
    tc.start()
    time.sleep(0.01 + rng.random() * 0.03)
    ch.close()
    tp.join(timeout=5)
    tc.join(timeout=5)
    assert not tp.is_alive() and not tc.is_alive()
    assert closed_seen == {"producer": 1, "consumer": 1}
    assert consumed == produced


# ---------------------------------------------------------------------------
# The engine on the executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smollm():
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")),
                               **_W8A8)
    cfg = dataclasses.replace(reduced(tregistry.get("smollm-135m")), **_W8A8)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    params = transformer_params_from_numpy(jax.device_get(jparams),
                                           device="cpu")
    return cfg, params, jcfg, jparams


def greedy_reference(cfg, params, prompt, n_new, max_len=96):
    logits, cache = model_api.prefill(cfg, params, torch.tensor([prompt]),
                                      max_len)
    out = [int(torch.argmax(logits[0, len(prompt) - 1]))]
    tok = torch.tensor([out[-1]], dtype=torch.int32)
    for _ in range(n_new - 1):
        logits, cache = model_api.decode_step(cfg, params, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(int(tok[0]))
    return out


def _serve(E, R, cfg, params, prompts, budgets, **kw):
    eng = E(cfg, params, capacity=2, max_len=96, prefill_pad=8, **kw)
    reqs = [R(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.output) for r in reqs], eng.stats.steps


def test_mid_decode_joins_are_bit_identical(smollm):
    cfg, params, jcfg, jparams = smollm
    early, late = [[5, 9, 2], [3, 1, 4, 1]], [[2, 7, 1], [8, 8]]
    outs = []
    for E, R, c, p in ((Engine, Request, cfg, params),
                       (JEngine, JRequest, jcfg, jparams)):
        eng = E(c, p, capacity=2, max_len=96, prefill_pad=8)
        reqs = [R(uid=i, prompt=list(q), max_new_tokens=8)
                for i, q in enumerate(early)]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()                   # both early requests mid-decode
        late_reqs = [R(uid=10 + i, prompt=list(q), max_new_tokens=8)
                     for i, q in enumerate(late)]
        for r in late_reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.output for r in reqs + late_reqs])
    for out, p in zip(outs[0], early + late):
        assert out == greedy_reference(cfg, params, p, 8)
    assert outs[0] == outs[1]


def test_drain_barrier_changes_schedule_not_tokens(smollm):
    cfg, params, _, _ = smollm
    prompts = [[5, 9, 2], [3, 1, 4, 1], [2, 7], [8, 8, 6]]
    budgets = [2, 8, 2, 8]
    streamed, s_steps = _serve(Engine, Request, cfg, params, prompts,
                               budgets)
    padded, p_steps = _serve(Engine, Request, cfg, params, prompts, budgets,
                             drain_barrier=True)
    assert streamed == padded
    assert p_steps > s_steps


def test_stage_topology_and_in_flight_order(smollm):
    cfg, params, _, _ = smollm
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8)
    ex = eng.executor
    assert [s.name for s in ex.stages] == [
        "admit", "prefill", "decode", "certify", "release"]
    reqs = [Request(uid=i, prompt=[1 + i, 2], max_new_tokens=4)
            for i in range(4)]
    for r in reqs:
        eng.submit(r)
    assert [r.uid for r in ex.in_flight()] == [0, 1, 2, 3]
    eng.step()
    assert [r.uid for r in ex.in_flight()] == [2, 3, 0, 1]
    eng.run()


def test_strike_decode_state_is_caught_by_scrub(smollm):
    cfg, params, _, _ = smollm
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 snapshot_every=2, state_scrub="rollback")
    req = Request(uid=0, prompt=[5, 9, 2], max_new_tokens=6)
    eng.submit(req)
    eng.step()
    eng.step()
    eng.strike("decode_state", fi.flip_one_bit, _gen(3))
    eng.run()
    events = eng.drain_state_events()
    assert len(events) == 1 and events[0]["recovered"]
    assert req.output == greedy_reference(cfg, params, [5, 9, 2], 6)


def test_strike_kv_cache_and_weights_route_to_owners(smollm):
    cfg, params, _, _ = smollm
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8)
    eng.submit(Request(uid=0, prompt=[5, 9, 2], max_new_tokens=4))
    eng.step()
    before_cache = [t.clone() for t in tree.leaves(eng.cache)]
    before_params = tree.leaves(eng.params)
    eng.strike("kv_cache", fi.flip_one_bit, _gen(1))
    eng.strike("weights", fi.flip_one_bit, _gen(2))
    after_cache = tree.leaves(eng.cache)
    after_params = tree.leaves(eng.params)
    assert sum(not torch.equal(a, b)
               for a, b in zip(before_cache, after_cache)) == 1
    assert sum(not torch.equal(a, b)
               for a, b in zip(before_params, after_params)) == 1
    # the strike copied the struck weight: the caller's params are intact
    assert all(torch.equal(a, b) for a, b in
               zip(before_params, tree.leaves(params)))
    with pytest.raises(ValueError, match="no stage owns"):
        eng.strike("flux_capacitor", fi.flip_one_bit, _gen(0))


def test_certify_hook_withholds_and_releases(smollm):
    cfg, params, _, _ = smollm
    held = []
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 certify=lambda req: (held.append(req), False)[1])
    reqs = [Request(uid=i, prompt=[1 + i, 5], max_new_tokens=3)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    released = []
    while eng.executor.busy():
        released += eng.step()
    assert released == []
    assert sorted(r.uid for r in held) == [0, 1]
    assert all(r.finished_at > 0 for r in held)
    eng.certify = lambda req: True
    eng.reset()
    for r in reqs:
        r.output = None
        r.finished_at = 0.0
        eng.submit(r)
    released = []
    while eng.executor.busy():
        released += eng.step()
    assert sorted(r.uid for r in released) == [0, 1]


def test_finished_requests_survive_full_outbox(smollm):
    cfg, params, _, _ = smollm
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8)
    ex = eng.executor
    certify_ch = df.Channel(1, "finished")
    release_ch = df.Channel(1, "certified")
    ex._certify_ch, ex._release_ch = certify_ch, release_ch
    ex.decode.outbox = certify_ch
    ex.certifier.inbox, ex.certifier.outbox = certify_ch, release_ch
    ex.release.inbox = release_ch
    prompts = [[5, 9, 2], [3, 1, 4]]
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    released = []
    while eng.executor.busy():
        released += eng.step()
    assert sorted(r.uid for r in released) == [0, 1]
    for r, p in zip(reqs, prompts):
        assert r.output == greedy_reference(cfg, params, p, 4)


def test_prefill_eos_finishes_at_admission(smollm):
    cfg, params, _, _ = smollm
    prompt = [5, 9, 2]
    t0 = greedy_reference(cfg, params, prompt, 1)[0]
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 eos_id=t0)
    req = Request(uid=0, prompt=list(prompt), max_new_tokens=8)
    other = Request(uid=1, prompt=[8, 8, 6], max_new_tokens=3)
    eng.submit(req)
    eng.submit(other)
    released = []
    while eng.executor.busy():
        released += eng.step()
    assert req.output == [t0]
    assert sorted(r.uid for r in released) == [0, 1]
    assert len(other.output) >= 1


@pytest.mark.parametrize("multi_step", [1, 4])
def test_decode_truncates_at_max_len(smollm, multi_step):
    cfg, params, jcfg, jparams = smollm
    max_len, prompt = 12, [5, 9, 2]
    outs = []
    for E, R, c, p in ((Engine, Request, cfg, params),
                       (JEngine, JRequest, jcfg, jparams)):
        eng = E(c, p, capacity=2, max_len=max_len, prefill_pad=8,
                multi_step=multi_step)
        req = R(uid=0, prompt=list(prompt), max_new_tokens=64)
        eng.submit(req)
        eng.run()
        assert req.finished_at > 0
        outs.append(req.output)
    eff = prompt[:1]
    want_len = max_len - len(eff)
    assert len(outs[0]) == want_len
    assert outs[0] == greedy_reference(cfg, params, eff, want_len,
                                       max_len=max_len)
    assert outs[0] == outs[1]


def test_multi_step_windows_are_bit_identical(smollm):
    cfg, params, jcfg, jparams = smollm
    prompts = [[5, 9, 2], [3, 1, 4, 1], [2, 7], [8, 8, 6]]
    budgets = [2, 8, 2, 8]
    per_step, s1 = _serve(Engine, Request, cfg, params, prompts, budgets)
    windowed, s4 = _serve(Engine, Request, cfg, params, prompts, budgets,
                          multi_step=4)
    assert windowed == per_step
    assert s4 >= s1
    # the reference's jitted window: the same streams and step count
    assert _serve(JEngine, JRequest, jcfg, jparams, prompts, budgets,
                  multi_step=4) == (windowed, s4)


def test_multi_step_window_reads_the_host_back_once():
    """One host readback per window: the tokens and finish masks of all
    ``multi_step`` inner steps come back in a single copy."""
    calls = []

    class Ex:
        capacity, multi_step, eos_id, max_len = 2, 3, -1, 96
        stats = df.EngineStats()
        tick = 0
        tracer = None

        def _decode(self, p, t, c):
            return (t + 1).to(torch.int32), c

    ex = Ex()
    ex.params = None
    stage = df.DecodeStage.__new__(df.DecodeStage)
    stage.ex, stage.outbox = ex, df.Channel(0)
    stage.cache = None
    stage.tokens = torch.tensor([5, 7], dtype=torch.int32)
    stage.slot_pos = np.zeros(2, np.int32)
    stage.slot_remaining = np.array([2, 9], np.int32)
    stage._pending = deque()
    stage.active = {0: Request(0, [1], 3, output=[5]),
                    1: Request(1, [1], 10, output=[7])}
    orig = torch.Tensor.cpu

    def cpu(self, *a, **k):
        calls.append(tuple(self.shape))
        return orig(self, *a, **k)

    torch.Tensor.cpu = cpu
    try:
        stage.decode_window()
    finally:
        torch.Tensor.cpu = orig
    assert calls == [(6, 2)]
    assert stage.active[1].output == [7, 8, 9, 10]
    assert ex.stats.steps == 3
    assert stage.outbox.drain()[0].output == [5, 6, 7]


def test_multi_step_snapshot_rollback_still_bit_exact(smollm):
    cfg, params, _, _ = smollm
    prompt, n_new = [5, 9, 2], 16
    golden = greedy_reference(cfg, params, prompt, n_new)
    eng = Engine(cfg, params, capacity=2, max_len=96, prefill_pad=8,
                 multi_step=4, snapshot_every=2, state_scrub="rollback")
    req = Request(uid=0, prompt=list(prompt), max_new_tokens=n_new)
    eng.submit(req)
    eng.step()
    eng.step()
    eng.strike("decode_state", fi.flip_one_bit, _gen(3))
    eng.run()
    events = eng.drain_state_events()
    assert len(events) == 1 and events[0]["recovered"]
    assert req.output == golden
