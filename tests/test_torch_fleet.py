"""The port's dependable serving fleet against the reference's.

Mirrors every ``smollm-135m`` case of tests/test_fleet.py and
``test_fleet_release_gate_lives_in_certify_stage`` of tests/test_dataflow.py
(the campaign cases are in test_torch_fleet_campaign.py), and the
``rwkv6-1.6b`` cases of its ``family_fleet`` and of
``test_proc_fleet_bit_identical_with_failover`` (slow there, and here).  Both packages' fleets serve
the reference's parameters of reduced(smollm-135m) with the W8A8 FFN and
f32 compute, and every fault is addressed — a (leaf, index, bit) the test
names, the same cells in both — so each scenario is held three ways:

  * the released token streams equal the reference fleet's (and greedy
    decode's);
  * ``FleetMetrics.to_json(wall=False)`` gives the reference's bytes, all
    but ``recovery_mean_seconds``/``recovery_max_seconds`` (rounded wall
    times of the recoveries, which ``recovery_count`` pins instead);
  * the fleet event log's ``to_json(wall=False)`` gives the reference's
    bytes.

Straggler verdicts compare wall-clock step times, so these fleets run with
the straggler test off (``straggler_factor`` infinite); the backup-dispatch
case turns it on and drives it with synthetic heartbeats, as the
reference's does.

Then the transport: frames byte-identical across packages (int8, int32,
f32, a 0-d scalar and a bf16 leaf), and a process fleet on the CPU, with a
worker SIGKILLed mid-decode, equal to the in-process one.  Proc fleets get
120 s ready and call deadlines, so a hung worker fails its test.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import fault_injection as jfi
from repro.core.dependability import Policy as JPolicy
from repro.fleet import Fleet as JFleet
from repro.fleet import ReplicaState as JReplicaState
from repro.fleet import Router as JRouter
from repro.fleet import transport as jtp
from repro.models import api as japi
from repro.models.config import reduced as jreduced
from repro.runtime.serving import Request as JRequest
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.convert import (rwkv6_params_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.core import fault_injection as tfi
from repro_torch.core.dependability import Policy
from repro_torch.fleet import Fleet, ReplicaState, Router
from repro_torch.fleet import transport as tp
from repro_torch.models import api as model_api
from repro_torch.models.config import reduced
from repro_torch.runtime.serving import Request
from repro_torch.train import checkpoint as ckpt_mod

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
PROMPTS = [[5, 9, 2], [3, 1, 4, 1], [2, 7], [8, 8, 6], [1, 6, 1, 8]]
N_NEW = 5
_W8A8 = dict(quant="w8a8_ffn", compute_dtype="float32")
WEIGHT_HIT = ("dense_blocks/wq", 37, 30)     # (leaf, flat index, bit)
TOKEN_HIT = (0, 3)                           # (slot, bit) of the tokens


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params_pair():
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")),
                               **_W8A8)
    cfg = dataclasses.replace(reduced(tregistry.get("smollm-135m")), **_W8A8)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    params = transformer_params_from_numpy(jax.device_get(jparams),
                                           device=CPU)
    return cfg, params, jcfg, jparams


# ---------------------------------------------------------------------------
# Addressed faults, the same cells in both packages
# ---------------------------------------------------------------------------


def j_flip(x, idx, bit):
    bits, u = jfi._as_bits(x)
    flat = bits.reshape(-1)
    flat = flat.at[idx].set(flat[idx] ^ u(1 << bit))
    return jax.lax.bitcast_convert_type(flat.reshape(x.shape), x.dtype)


def j_flip_leaf(params, pstr, idx, bit):
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = [j_flip(leaf, idx, bit)
           if ckpt_mod.path_str(tuple(getattr(k, "key", getattr(k, "name",
                                                               None))
                                      for k in p)) == pstr else leaf
           for p, leaf in flat]
    return jax.tree_util.tree_unflatten(treedef, out)


def t_flip_leaf(params, pstr, idx, bit):
    for path, leaf in tree.leaves_with_paths(params):
        if ckpt_mod.path_str(path) == pstr:
            return tree.replace(params, path,
                                tfi.flip_bit_at_index(leaf, idx, bit))
    raise KeyError(pstr)


_SEED_BITS, _IDX_BITS = 6, 34         # a port key's seed = leaf|index|bit


def _addr(gen):
    seed = gen.initial_seed()
    return (seed >> (_IDX_BITS + _SEED_BITS),
            (seed >> _SEED_BITS) & ((1 << _IDX_BITS) - 1),
            seed & ((1 << _SEED_BITS) - 1))


def addressed(x, key):
    """The strike fault of ``Fleet.strike``: flip the addressed bit (both
    packages name it ``addressed`` in their event logs)."""
    if isinstance(x, torch.Tensor):
        _, idx, bit = _addr(key)
        return tfi.flip_bit_at_index(x, idx % x.numel(),
                                     bit % (x.element_size() * 8))
    return j_flip(x, int(key[1]) % x.size, int(key[2]) % (x.dtype.itemsize
                                                          * 8))


def _leaf_index(params, pstr):
    return [ckpt_mod.path_str(p) for p, _ in tree.leaves_with_paths(params)
            ].index(pstr)


@pytest.fixture
def addressed_inject(monkeypatch):
    """Both packages' leaf draws replaced by the key's addressed leaf."""
    def j_inject(params, key, fault):
        leaves, treedef = jax.tree_util.tree_flatten(params)
        i = int(key[0])
        leaves[i] = fault(leaves[i], key)
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def t_inject(params, gen, fault):
        path, leaf = tree.leaves_with_paths(params)[_addr(gen)[0]]
        return tree.replace(params, path, fault(leaf, gen))

    monkeypatch.setattr(jfi, "inject_pytree_with", j_inject)
    monkeypatch.setattr(tfi, "inject_pytree_with", t_inject)


def _keys(params, pstr, idx, bit):
    i = _leaf_index(params, pstr)
    seed = (i << (_IDX_BITS + _SEED_BITS)) | (idx << _SEED_BITS) | bit
    return (jnp.asarray([i, idx, bit], jnp.int32),
            torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# Both fleets through one scenario
# ---------------------------------------------------------------------------

J = SimpleNamespace(Request=JRequest, Policy=JPolicy, RS=JReplicaState,
                    flip_leaf=j_flip_leaf, jax=True)
T = SimpleNamespace(Request=Request, Policy=Policy, RS=ReplicaState,
                    flip_leaf=t_flip_leaf, jax=False)


def _stragglers(fleet, factor):
    fleet.supervisor.straggler_factor = factor
    fleet.supervisor.reset()


def _fleet_pair(params_pair, n_replicas=3, policy="none", **kw):
    cfg, params, jcfg, jparams = params_pair
    kw = dict(capacity=2, max_len=96, prefill_pad=8, scrub_every=3, **kw)
    pair = (JFleet(jcfg, jparams, n_replicas=n_replicas,
                   policy=JPolicy(policy), **kw),
            Fleet(cfg, params, n_replicas=n_replicas, policy=Policy(policy),
                  **kw))
    for fleet in pair:
        _stragglers(fleet, float("inf"))
    return pair


@pytest.fixture(scope="module")
def fleets(params_pair):
    """One 3-replica fleet per package (reset per scenario)."""
    jf, tf = _fleet_pair(params_pair)
    yield jf, tf
    jf.close()
    tf.close()


def _serve(ns, fleet, policy, prompts=PROMPTS, n_new=N_NEW, mid_run=None):
    """Reset + submit + (optional mid-run drill) + drain; returns requests."""
    fleet.reset(policy=ns.Policy(policy))
    reqs = [ns.Request(uid=i, prompt=list(p), max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert fleet.submit(r)
    if mid_run is not None:
        fleet.tick()
        fleet.tick()
        mid_run(ns, fleet)
    fleet.run()
    return reqs


def _metrics_bytes(fleet) -> str:
    d = fleet.metrics.to_json()
    for k in ("recovery_mean_seconds", "recovery_max_seconds"):
        d.pop(k)
    return json.dumps(d)


def _events_bytes(fleet) -> str:
    return json.dumps(fleet.event_log.to_json(wall=False), sort_keys=True)


def _streams(fleet, reqs):
    return [tuple(fleet.released[r.uid].output) if r.uid in fleet.released
            else None for r in reqs]


def _both(fleets, policy, mid_run=None, **kw):
    """Serve one scenario on both fleets; assert streams, metrics and event
    bytes equal; return (port fleet, port requests)."""
    jf, tf = fleets
    jreqs = _serve(J, jf, policy, mid_run=mid_run, **kw)
    treqs = _serve(T, tf, policy, mid_run=mid_run, **kw)
    assert _streams(tf, treqs) == _streams(jf, jreqs)
    assert _metrics_bytes(tf) == _metrics_bytes(jf)
    assert _events_bytes(tf) == _events_bytes(jf)
    return tf, treqs


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


def _corrupt_weights(ns, fleet):
    victim = fleet.replicas[0]
    victim.engine.params = ns.flip_leaf(victim.engine.params, *WEIGHT_HIT)


def _flip_token(ns, fleet):
    v = fleet.replicas[0]
    slot, bit = TOKEN_HIT
    if ns.jax:
        toks = v.engine.tokens
        v.engine.tokens = toks.at[slot].set(toks[slot] ^ (1 << bit))
    else:
        v.engine.tokens = tfi.flip_bit_at_index(v.engine.tokens, slot, bit)


# ---------------------------------------------------------------------------
# A fleet serves exactly what one engine would
# ---------------------------------------------------------------------------


def test_fleet_matches_single_engine_reference(fleets, params_pair):
    cfg, params, _, _ = params_pair
    tf, reqs = _both(fleets, "none")
    for r, p in zip(reqs, PROMPTS):
        assert r.output == greedy_reference(cfg, params, p, N_NEW), r.uid
    assert tf.metrics.released == len(PROMPTS)


# ---------------------------------------------------------------------------
# Router: determinism + admission control
# ---------------------------------------------------------------------------


def test_hash_router_is_deterministic_and_stable(fleets):
    jf, tf = fleets
    jf.reset()
    tf.reset()
    picks = [Router("hash").pick(uid, tf.replicas).rid for uid in range(20)]
    assert picks == [Router("hash").pick(uid, tf.replicas).rid
                     for uid in range(20)]
    assert picks == [JRouter("hash").pick(uid, jf.replicas).rid
                     for uid in range(20)]
    assert len(set(picks)) > 1


def test_least_loaded_router_prefers_idle_lowest_rid(fleets):
    _, tf = fleets
    tf.reset()
    router = Router("least_loaded")
    assert router.pick(0, tf.replicas).rid == 0
    tf.replicas[0].engine.submit(Request(uid=90, prompt=[1],
                                         max_new_tokens=2))
    assert router.pick(1, tf.replicas).rid == 1
    with pytest.raises(ValueError, match="unknown router policy"):
        Router("random")


def test_admission_control_rejects_when_full(fleets):
    out = []
    for ns, fleet, R in ((J, fleets[0], JRouter), (T, fleets[1], Router)):
        fleet.reset()
        old = fleet.router
        try:
            fleet.router = R("least_loaded", admit_limit=1)
            got = [fleet.submit(ns.Request(uid=i, prompt=[1, 2],
                                           max_new_tokens=2))
                   for i in range(4)]
            assert got == [True, True, True, False]
            assert fleet.metrics.rejected == 1
            fleet.run()
            assert fleet.metrics.released == 3
            out.append((_metrics_bytes(fleet), _events_bytes(fleet)))
        finally:
            fleet.router = old
    assert out[0] == out[1]


def test_deadline_miss_expires_request(fleets):
    out = []
    for ns, fleet in ((J, fleets[0]), (T, fleets[1])):
        fleet.reset()
        req = ns.Request(uid=0, prompt=[5, 9, 2], max_new_tokens=30)
        assert fleet.submit(req, deadline_ticks=2)
        fleet.run()
        assert fleet.metrics.deadline_misses == 1
        assert req.uid not in fleet.released
        out.append((_metrics_bytes(fleet), fleet.supervisor.events))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Deterministic failover
# ---------------------------------------------------------------------------


def test_failover_after_kill_is_bit_exact(fleets):
    jf, tf = fleets
    golden = _streams(tf, _serve(T, tf, "none"))
    tf, reqs = _both(fleets, "none",
                     mid_run=lambda ns, f: f.kill_replica(0))
    assert tf.replicas[0].state is ReplicaState.DEAD
    assert tf.metrics.failovers > 0
    assert _streams(tf, reqs) == golden
    assert tf.metrics.released == len(PROMPTS)


def test_heartbeat_timeout_declares_paused_replica_dead(fleets):
    jf, tf = fleets
    golden = _streams(tf, _serve(T, tf, "none"))
    tf, reqs = _both(fleets, "none",
                     mid_run=lambda ns, f: f.pause_replica(0))
    assert any("heartbeat timeout" in e for e in tf.supervisor.events)
    assert _streams(tf, reqs) == golden
    assert tf.supervisor.events == fleets[0].supervisor.events


# ---------------------------------------------------------------------------
# Weight-SEU recovery: quarantine → checkpoint reload → re-verify → readmit
# ---------------------------------------------------------------------------


def test_abft_scrub_recovers_weight_seu(fleets):
    tf, clean = _both(fleets, "abft")
    golden = _streams(tf, clean)
    assert tf.metrics.detections == 0
    tf, reqs = _both(fleets, "abft", mid_run=_corrupt_weights)
    assert tf.metrics.detections >= 1
    assert tf.metrics.recoveries == 1
    assert tf.replicas[0].state is ReplicaState.HEALTHY
    assert tf.replicas[0].scrub() == []
    assert _streams(tf, reqs) == golden
    assert tf.metrics.released == len(PROMPTS)


def test_dmr_detects_transient_decode_fault(fleets):
    tf, clean = _both(fleets, "dmr")
    golden = _streams(tf, clean)
    assert tf.metrics.detections == 0

    def strike(ns, f):
        v = f.replicas[0]
        v.engine.tokens = v.engine.tokens ^ 1     # flip every active token

    tf, reqs = _both(fleets, "dmr", mid_run=strike)
    assert tf.metrics.detections >= 1
    assert tf.metrics.recoveries == 0
    assert _streams(tf, reqs) == golden
    assert tf.metrics.released == len(PROMPTS)


def test_ckpt_weight_seu_incremental_restore(fleets):
    tf, clean = _both(fleets, "ckpt")
    golden = _streams(tf, clean)
    assert tf.metrics.detections == 0
    tf, reqs = _both(fleets, "ckpt", mid_run=_corrupt_weights)
    m = tf.metrics
    assert m.detections >= 1
    assert m.recoveries == 1
    assert m.incremental_restores == 1
    assert m.full_reloads == 0
    assert m.leaves_restored >= 1
    assert m.recovery_seconds.count == 1 and m.recovery_seconds.sum > 0
    assert m.to_json()["recovery_mean_seconds"] > 0
    assert tf.replicas[0].state is ReplicaState.HEALTHY
    assert _streams(tf, reqs) == golden
    assert m.released == len(PROMPTS)


def test_ckpt_decode_state_seu_rolls_back_in_place(fleets):
    tf, clean = _both(fleets, "ckpt")
    golden = _streams(tf, clean)
    tf, reqs = _both(fleets, "ckpt", mid_run=_flip_token)
    m = tf.metrics
    assert m.state_scrub_detections >= 1
    assert m.state_rollbacks >= 1
    assert m.recoveries == 0
    assert _streams(tf, reqs) == golden
    assert m.released == len(PROMPTS)


def test_recovery_survives_crashed_checkpoint_writer(fleets):
    golden = None
    for ns, fleet in ((J, fleets[0]), (T, fleets[1])):
        clean = _streams(fleet, _serve(ns, fleet, "ckpt"))
        golden = golden or clean
        assert clean == golden
        orphan = Path(fleet.ckpt_dir) / "step_0000000099.tmp"
        orphan.mkdir()
        (orphan / "chunks.npz").write_bytes(b"torn write")
        try:
            reqs = _serve(ns, fleet, "ckpt", mid_run=_corrupt_weights)
            assert fleet.metrics.recoveries == 1
            assert fleet.replicas[0].scrub() == []
            assert _streams(fleet, reqs) == golden
        finally:
            if orphan.exists():
                import shutil
                shutil.rmtree(orphan)
    assert _events_bytes(fleets[1]) == _events_bytes(fleets[0])


def test_abft_decode_state_seu_drains_and_replays(fleets):
    tf, clean = _both(fleets, "abft")
    golden = _streams(tf, clean)
    tf, reqs = _both(fleets, "abft", mid_run=_flip_token)
    m = tf.metrics
    assert m.state_scrub_detections >= 1
    assert m.state_drains >= 1
    assert m.state_rollbacks == 0
    assert _streams(tf, reqs) == golden
    assert m.released == len(PROMPTS)


def test_weight_strike_leaves_shared_params_of_other_replicas_clean(
        params_pair):
    """In-process replicas share parameter tensors: a strike on replica 0
    writes out of place, so replica 1's storage scrub stays clean and the
    fleet's golden params keep their checksums."""
    cfg, params, _, _ = params_pair
    tf = Fleet(cfg, params, n_replicas=2, policy=Policy.ABFT, capacity=2,
               max_len=96, prefill_pad=8)
    r0, r1 = tf.replicas[0], tf.replicas[1]
    leaf = r1.engine.params["dense_blocks"]["wq"]
    assert r0.engine.params["dense_blocks"]["wq"] is leaf   # shared
    before = leaf.clone()
    _corrupt_weights(T, tf)
    assert r0.scrub() == [WEIGHT_HIT[0]]
    assert r1.scrub() == []
    assert torch.equal(leaf, before)
    assert torch.equal(params["dense_blocks"]["wq"], before)
    # the incremental reload builds a new leaf, never writes the shared one
    tf.supervisor.recover(r0, tf.ckpt_dir, tf.metrics, tf.tick_no, step=0)
    assert r0.scrub() == [] and r1.scrub() == []
    assert r0.engine.params["dense_blocks"]["wq"] is not leaf
    assert torch.equal(r0.engine.params["dense_blocks"]["wq"], before)
    tf.reset()
    assert r0.engine.params["dense_blocks"]["wq"] is leaf   # shared again
    tf.close()


def test_reload_refuses_a_misshaped_leaf(params_pair):
    """A reloaded or patched leaf keeps the live leaf's shape: one with the
    same element count but another shape is refused, never reshaped, and
    the replica keeps serving its own leaf."""
    cfg, params, _, _ = params_pair
    tf = Fleet(cfg, params, n_replicas=1, policy=Policy.ABFT, capacity=2,
               max_len=96, prefill_pad=8)
    try:
        r0 = tf.replicas[0]
        wq = params["dense_blocks"]["wq"]
        flat = wq.reshape(-1)
        with pytest.raises(ValueError, match="shape"):
            r0.reload_leaves({WEIGHT_HIT[0]: flat})
        with pytest.raises(ValueError, match="shape"):
            r0.patch_leaves({WEIGHT_HIT[0]: flat})
        with pytest.raises(ValueError, match="shape"):
            r0.reload({**params, "dense_blocks": {**params["dense_blocks"],
                                                  "wq": flat}})
        assert r0.engine.params["dense_blocks"]["wq"] is wq
        assert r0.scrub() == []
    finally:
        tf.close()


# ---------------------------------------------------------------------------
# Metrics export, release gate
# ---------------------------------------------------------------------------


def test_metrics_json_round_trip(fleets, tmp_path):
    tf, _ = _both(fleets, "abft")
    m = tf.metrics.to_json()
    for k in ("released", "p50_latency_ticks", "p99_latency_ticks",
              "tokens_per_tick", "recoveries", "failovers",
              "lost_work_bound_tokens", "scrubs"):
        assert k in m, k
    assert m["released"] == len(PROMPTS)
    assert m["p50_latency_ticks"] <= m["p99_latency_ticks"]
    p = tf.metrics.dump(tmp_path / "fleet.json")
    assert json.loads(p.read_text())["released"] == len(PROMPTS)
    report = tf.report()
    assert len(report["replicas"]) == 3
    json.dumps(report)
    jreport = fleets[0].report()
    for r in (report, jreport):
        for k in ("recovery_mean_seconds", "recovery_max_seconds"):
            r.pop(k)
    assert json.dumps(report) == json.dumps(jreport)
    assert tf.metrics.registry.render_prometheus() \
        == fleets[0].metrics.registry.render_prometheus()


def test_fleet_release_gate_lives_in_certify_stage(params_pair):
    cfg, params, _, _ = params_pair
    fleet = Fleet(cfg, params, n_replicas=2, policy=Policy.ABFT,
                  capacity=2, max_len=96, prefill_pad=8, scrub_every=1000)
    try:
        assert all(r.engine.certify is not None for r in fleet.replicas)
        req = Request(uid=0, prompt=[5, 9, 2], max_new_tokens=3)
        assert fleet.submit(req)
        for _ in range(10):
            fleet.tick()
        assert req.finished_at > 0
        assert req.uid not in fleet.released
        assert any(any(q.uid == req.uid for q in r.uncertified)
                   for r in fleet.replicas)
        fleet.run()
        assert req.uid in fleet.released
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# Process transport: framing, wire round trips, cross-process bit identity
# ---------------------------------------------------------------------------


def _frame_arrays():
    bf = np.asarray([1.5, -2.25, 3.0e-5, 65504.0], np.float32)
    return {
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "f32": np.asarray([[1.5, -2.25]], np.float32),
        "i8": np.asarray([-128, 127], np.int8),
        "scalar": np.asarray(3.0, np.float64),
        "bf16": bf,
    }


def test_transport_frames_equal_reference_bytes():
    """The same frame, encoded by each package, byte for byte: int8, int32,
    f32, a 0-d scalar leaf and a bf16 leaf (the port's from a torch
    tensor, the reference's through ml_dtypes)."""
    a = _frame_arrays()
    j_arrays = {k: (jnp.asarray(v, jnp.bfloat16) if k == "bf16" else v)
                for k, v in a.items()}
    j_arrays = {k: np.asarray(v) for k, v in j_arrays.items()}
    t_arrays = {k: (torch.from_numpy(v).to(torch.bfloat16) if k == "bf16"
                    else v) for k, v in a.items()}
    payload = {"x": 1, "s": "y", "nested": {"a": [1, 2]}}
    jbuf = jtp.encode_frame(7, "step", payload, j_arrays)
    tbuf = tp.encode_frame(7, "step", payload, t_arrays)
    assert tbuf == jbuf
    # a torch tensor of every dtype gives the numpy array's bytes
    assert tp.encode_frame(1, "x", {}, {k: torch.from_numpy(v) for k, v in
                                        a.items() if k != "bf16"}) \
        == jtp.encode_frame(1, "x", {}, {k: v for k, v in a.items()
                                         if k != "bf16"})
    seq, op, got_payload, got = tp.decode_frame(jbuf)
    assert (seq, op, got_payload) == (7, "step", payload)
    assert set(got) == set(a)
    for name, want in t_arrays.items():
        want = torch.as_tensor(want)
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        assert torch.equal(got[name], want), name
    assert got["scalar"].dim() == 0


def test_transport_frame_rejects_garbage():
    good = tp.encode_frame(0, "ping", {}, {})
    with pytest.raises(tp.ProtocolError):
        tp.decode_frame(b"XXXX" + good[4:])
    with pytest.raises(tp.ProtocolError):
        tp.decode_frame(good[:-1])
    with pytest.raises(tp.ProtocolError):
        tp.decode_frame(good + b"\x00")


def test_pipe_channel_enforces_consecutive_seq():
    a, b = multiprocessing.Pipe()
    ch = tp.PipeChannel(a, "seqtest")
    b.send_bytes(tp.encode_frame(1, "first", {}, {}))
    op, _, _ = ch.get(5)
    assert op == "first"
    b.send_bytes(tp.encode_frame(3, "gap", {}, {}))
    with pytest.raises(tp.ProtocolError):
        ch.get(5)
    a.close()
    b.close()


def test_request_wire_doc_round_trip():
    req = Request(uid=3, prompt=[1, 2, 3], max_new_tokens=5)
    assert req.to_doc() == JRequest(uid=3, prompt=[1, 2, 3],
                                    max_new_tokens=5).to_doc()
    clone = Request.from_doc(req.to_doc())
    assert (clone.uid, clone.prompt, clone.max_new_tokens) == (3, [1, 2, 3],
                                                               5)
    finished = Request.from_doc(req.to_doc())
    finished.output = [9, 8]
    finished.finished_tick = 4
    req.sync_from_doc(finished.to_doc())
    assert req.output == [9, 8] and req.finished_tick == 4


def test_config_and_fault_docs_cross_the_wire(params_pair):
    from repro_torch.campaign import faultload as fl
    from repro_torch.core.policy_map import PolicyMap
    cfg = dataclasses.replace(params_pair[0],
                              policy_map=PolicyMap.uniform("abft"))
    doc = tp.cfg_to_doc(cfg)
    assert json.loads(json.dumps(doc)) == doc
    assert tp.cfg_from_doc(doc) == cfg
    for name, fm in fl.FAULT_MODELS.items():
        assert tp.fault_from_name(tp.fault_to_name(fm.apply)) is fm.apply
    assert tp.fault_from_name(tp.fault_to_name(tfi.flip_one_bit)) \
        is tfi.flip_one_bit
    with pytest.raises(ValueError, match="cannot serialize fault"):
        tp.fault_to_name(lambda x, g: x)


def test_proc_worker_refuses_a_missing_device(params_pair, tmp_path):
    """A worker asked for a device that is not there raises in init; the
    parent sees WorkerError, never a worker that fell back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params = params_pair[:2]
    ckpt_mod.save(tmp_path, 0, params)
    r = tp.ProcReplica(0, cfg, ckpt_dir=str(tmp_path), device="cuda")
    try:
        with pytest.raises(tp.WorkerError, match="no CUDA device"):
            r.wait_ready()
    finally:
        r.close()


def _proc_serve(fleet, prompts, n_new, kill=False):
    fleet.reset()
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert fleet.submit(r)
    if kill:
        fleet.tick()
        fleet.tick()
        fleet.replicas[0].handle.proc.kill()         # SIGKILL, no goodbye
    fleet.run()
    return [tuple(fleet.released[r.uid].output) for r in reqs]


def test_proc_fleet_bit_identical_with_failover(params_pair):
    """A 3-replica process fleet on the CPU releases byte-identical token
    streams to the in-process fleet, also with one worker SIGKILLed
    mid-run; the workers are gone after close."""
    cfg, params = params_pair[:2]
    prompts = PROMPTS[:3]
    ref = Fleet(cfg, params, n_replicas=3, policy=Policy.NONE,
                capacity=2, max_len=96, prefill_pad=8)
    try:
        golden = _proc_serve(ref, prompts, 4)
    finally:
        ref.close()
    fleet = Fleet(cfg, params, n_replicas=3, policy=Policy.NONE,
                  capacity=2, max_len=96, prefill_pad=8, transport="proc")
    try:
        assert all(r.device == torch.device(CPU) for r in fleet.replicas)
        assert _proc_serve(fleet, prompts, 4) == golden
        assert _proc_serve(fleet, prompts, 4, kill=True) == golden
        assert fleet.metrics.recoveries + fleet.metrics.failovers > 0
        assert all(r.state is ReplicaState.HEALTHY for r in fleet.replicas)
    finally:
        fleet.close()
    assert not any(r.handle.proc.is_alive() for r in fleet.replicas)


# ---------------------------------------------------------------------------
# The recurrent family (tests/test_fleet.py's family_fleet, rwkv6-1.6b)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv_pair():
    f32 = dict(compute_dtype="float32")
    jcfg = dataclasses.replace(jreduced(jregistry.get("rwkv6-1.6b")), **f32)
    cfg = dataclasses.replace(reduced(tregistry.get("rwkv6-1.6b")), **f32)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    params = rwkv6_params_from_numpy(jax.device_get(jparams), device=CPU)
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module")
def rwkv_fleets(rwkv_pair):
    """One 2-replica rwkv fleet per package (the reference's family_fleet
    geometry)."""
    jf, tf = _fleet_pair(rwkv_pair, n_replicas=2)
    yield jf, tf
    jf.close()
    tf.close()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b"])
def test_family_fleet_matches_single_engine_reference(rwkv_fleets, rwkv_pair,
                                                      arch):
    cfg, params, _, _ = rwkv_pair
    assert cfg.name == arch + "-reduced"
    tf, reqs = _both(rwkv_fleets, "none")
    for r, p in zip(reqs, PROMPTS):
        assert r.output == greedy_reference(cfg, params, p, N_NEW), r.uid
    assert tf.metrics.released == len(PROMPTS)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b"])
def test_family_failover_after_kill_is_bit_exact(rwkv_fleets, arch):
    jf, tf = rwkv_fleets
    golden = _streams(tf, _serve(T, tf, "none"))
    tf, reqs = _both(rwkv_fleets, "none",
                     mid_run=lambda ns, f: f.kill_replica(0))
    assert tf.replicas[0].state is ReplicaState.DEAD
    assert tf.metrics.failovers > 0
    assert _streams(tf, reqs) == golden
    assert tf.metrics.released == len(PROMPTS)


@pytest.mark.parametrize("arch", [
    pytest.param("rwkv6-1.6b", marks=pytest.mark.slow)])
def test_proc_fleet_bit_identical_with_failover_family(rwkv_pair, arch):
    """The recurrent family's process fleet (slow, as in the reference):
    3 CPU workers release the in-process fleet's streams, also with one
    SIGKILLed mid-run."""
    cfg, params = rwkv_pair[:2]
    prompts = PROMPTS[:3]
    ref = Fleet(cfg, params, n_replicas=3, policy=Policy.NONE,
                capacity=2, max_len=96, prefill_pad=8)
    try:
        golden = _proc_serve(ref, prompts, 4)
    finally:
        ref.close()
    fleet = Fleet(cfg, params, n_replicas=3, policy=Policy.NONE,
                  capacity=2, max_len=96, prefill_pad=8, transport="proc")
    try:
        assert _proc_serve(fleet, prompts, 4) == golden
        assert _proc_serve(fleet, prompts, 4, kill=True) == golden
        assert fleet.metrics.recoveries + fleet.metrics.failovers > 0
        assert all(r.state is ReplicaState.HEALTHY for r in fleet.replicas)
    finally:
        fleet.close()
    assert not any(r.handle.proc.is_alive() for r in fleet.replicas)


# ---------------------------------------------------------------------------
# Zero-drain rolling weight deploys
# ---------------------------------------------------------------------------


def _serve_with_deploy(ns, fleet, prompts, n_new, deploy_to=None,
                       mid_swap=None):
    fleet.reset()
    reqs = [ns.Request(uid=i, prompt=list(p), max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert fleet.submit(r)
    summary = None
    if deploy_to is not None:
        fleet.tick()
        fleet.tick()
        summary = fleet.deploy(params=deploy_to, mid_swap=mid_swap)
    fleet.run()
    return _streams(fleet, reqs), summary


def test_rolling_deploy_swaps_weights_without_draining(params_pair):
    cfg, params, jcfg, jparams = params_pair
    jpb = japi.init_params(jcfg, jax.random.key(1))
    pb = transformer_params_from_numpy(jax.device_get(jpb), device=CPU)
    jf, tf = _fleet_pair(params_pair, n_replicas=2, policy="abft")
    try:
        out = []
        for ns, fleet, new in ((J, jf, jpb), (T, tf, pb)):
            golden_a, _ = _serve_with_deploy(ns, fleet, PROMPTS[:3], 5)
            mixed, summary = _serve_with_deploy(ns, fleet, PROMPTS[:3], 5,
                                                deploy_to=new)
            assert summary["swapped"] == [0, 1] and not summary["failed"]
            assert summary["changed"] > 0
            assert None not in mixed
            assert mixed != golden_a
            assert fleet.metrics.deploys == 1
            assert fleet.metrics.replicas_swapped == 2
            assert fleet.metrics.detections == 0
            kinds = [e.kind for e in fleet.event_log]
            assert kinds.count("deploy_start") == 1
            assert kinds.count("replica_swapped") == 2
            deployed = (mixed, summary, _metrics_bytes(fleet),
                        _events_bytes(fleet))
            post, _ = _serve_with_deploy(ns, fleet, PROMPTS[:3], 5)
            assert post != golden_a
            assert all(r.routable and r.state is ns.RS.HEALTHY
                       for r in fleet.replicas)
            out.append((golden_a, deployed, post))
        assert out[0] == out[1]
        # every deployed leaf is on the replica's device, with its dtype
        for r in tf.replicas:
            for (_, a), (_, b) in zip(tree.leaves_with_paths(r.engine.params),
                                      tree.leaves_with_paths(pb)):
                assert a.device == r.device and a.dtype == b.dtype
    finally:
        jf.close()
        tf.close()


def test_rolling_deploy_mid_swap_strike_detected_and_healed(
        params_pair, addressed_inject):
    jf, tf = _fleet_pair(params_pair, n_replicas=2, policy="abft")
    jkey, tkey = _keys(params_pair[1], *WEIGHT_HIT)
    try:
        out = []
        for ns, fleet, deploy_to, key in (
                (J, jf, params_pair[3], jkey), (T, tf, params_pair[1], tkey)):
            golden, _ = _serve_with_deploy(ns, fleet, PROMPTS[:3], 6,
                                           deploy_to=deploy_to)

            def mid_swap(rid, fleet=fleet, key=key):
                if rid == 1:
                    fleet.strike(0, "weights", addressed, key)

            struck, summary = _serve_with_deploy(
                ns, fleet, PROMPTS[:3], 6, deploy_to=deploy_to,
                mid_swap=mid_swap)
            assert struck == golden
            assert fleet.metrics.detections >= 1
            assert fleet.metrics.recoveries >= 1
            assert all(r.state is ns.RS.HEALTHY and r.routable
                       for r in fleet.replicas)
            kinds = [e.kind for e in fleet.event_log]
            assert "strike" in kinds and "recovery" in kinds
            assert kinds.index("deploy_start") < kinds.index("strike")
            out.append((struck, summary, _metrics_bytes(fleet),
                        _events_bytes(fleet)))
        assert out[0] == out[1]
    finally:
        jf.close()
        tf.close()


# ---------------------------------------------------------------------------
# Speculative backup dispatch
# ---------------------------------------------------------------------------


def test_speculative_backup_wins_when_primary_stalls(fleets, params_pair):
    cfg, params = params_pair[:2]
    out = []
    for ns, fleet in ((J, fleets[0]), (T, fleets[1])):
        _stragglers(fleet, 3.0)
        fleet.reset()
        req = ns.Request(uid=0, prompt=[5, 9, 2], max_new_tokens=5)
        assert fleet.submit(req)
        fleet.tick()
        for i in range(5):
            for rid, dt in ((0, 9.0), (1, 0.01), (2, 0.01)):
                fleet.supervisor.heartbeat(rid, i + 1, dt, fleet.tick_no)
        assert fleet.supervisor.stragglers() == [0]
        fleet._dispatch_backups([0])
        rec = fleet.records[0]
        assert rec.backup is not None and rec.backup_rid != 0
        assert fleet.metrics.backup_dispatches == 1
        fleet.replicas[0].paused = True
        fleet.run()
        fleet.replicas[0].paused = False
        assert fleet.metrics.backups_won == 1
        assert fleet.released[0] is rec.backup
        out.append((list(fleet.released[0].output), _metrics_bytes(fleet),
                    _events_bytes(fleet)))
        _stragglers(fleet, float("inf"))
    assert out[0] == out[1]
    assert out[1][0] == greedy_reference(cfg, params, [5, 9, 2], 5)


# ---------------------------------------------------------------------------
# Chaos: SIGKILL under load and mid-deploy (slow in the reference too)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_proc_fleet_chaos_sigkill_mid_decode_and_mid_deploy(params_pair):
    cfg, params = params_pair[:2]
    fleet = Fleet(cfg, params, n_replicas=2, policy=Policy.ABFT,
                  capacity=2, max_len=96, prefill_pad=8, scrub_every=3,
                  transport="proc")
    try:
        golden, _ = _serve_with_deploy(T, fleet, PROMPTS[:3], 6,
                                       deploy_to=params)
        fleet.reset()
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(PROMPTS[:3])]
        for r in reqs:
            assert fleet.submit(r)
        fleet.tick()
        fleet.tick()
        fleet.replicas[0].handle.proc.kill()
        fleet.tick()

        def mid_swap(rid):
            if rid == 1:
                fleet.replicas[1].handle.proc.kill()
        summary = fleet.deploy(params=params, mid_swap=mid_swap)
        fleet.run()
        assert _streams(fleet, reqs) == golden
        assert summary["step"] == 2
        assert fleet.metrics.recoveries >= 2
        assert all(r.state is ReplicaState.HEALTHY and r.routable and r.alive
                   for r in fleet.replicas)
        kinds = [e.kind for e in fleet.event_log]
        assert kinds.count("detection") >= 2
        assert kinds.count("quarantine") >= 2
        assert kinds.count("recovery") >= 2
        dep = kinds.index("deploy_start")
        assert "detection" in kinds[dep:] and "recovery" in kinds[dep:]
        assert kinds[dep:].count("replica_swapped") == 2
    finally:
        fleet.close()


def test_cli_drill_on_the_cpu(tmp_path, capsys):
    """``repro_torch.fleet.cli``: a weight SEU under ABFT is healed (exit
    0, the released streams equal the golden pass's); the default device
    is the card, which raises where there is none."""
    from repro_torch.fleet import cli
    assert cli.main(["--device", CPU, "--replicas", "2", "--requests", "4",
                     "--policy", "abft", "--inject", "weights",
                     "--out", str(tmp_path), "--quiet"]) == 0
    report = json.loads((tmp_path / "fleet.json").read_text())
    assert report["outputs_match_golden"] and report["device"] == CPU
    assert report["recoveries"] == 1 and report["released"] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--out", str(tmp_path), "--quiet"])
