"""The port's mixture-of-experts transformer held against the reference's
single-device MoE path (``_local_route``, ``_moe_ffn_single``, ``forward``,
``loss_fn``, ``prefill``, ``decode_step``), on the reference's parameters
(converted with ``transformer_params_from_numpy``) and the same tokens.
Mirrors the MoE cases of tests/test_transformer.py (the meshless ones:
the shard_map case waits for the port's parallel slice), over its
``small_moe`` config and reduced ``mixtral-8x7b`` and ``kimi-k2-1t-a32b``.

Exact: the routing maps (``gather_idx``, ``filled``), the int8
activations and the int32 expert accumulators, on router inputs whose
f32 products are exact in any summation order (dyadic values), so that
both packages see the same logits and the same ties; a case with exact
ties and one with capacity drops.  Within tolerances: the gates, aux and
z losses to 1e-6 (softmax and means sum in other orders); f32 logits of
``forward``, ``prefill`` and ``decode_step`` to 1e-4 (the float path
around the integer products sums in other orders on the two frameworks'
CPU kernels); the loss and its gradients to 2e-4.  Where a case routes
the model's own activations, it asserts the margin between each token's
k-th and (k+1)-th router probability that keeps a last-bit difference
from changing a choice: the premise of an exact stream."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import fault_injection as jfi
from repro.models import transformer as jtfm
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import reduced as jreduced
from repro.runtime.serving import Engine as JEngine
from repro.runtime.serving import Request as JRequest
from repro_torch.configs import registry as tregistry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core import fault_injection as fi
from repro_torch.kernels import dispatch
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.config import reduced as treduced
from repro_torch.runtime.serving import Engine, Request

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)


def small_moe(**kw):
    """tests/test_transformer.py's ``small_moe`` on both sides (f32
    compute, capacity_factor 8: dropless)."""
    moe = kw.pop("moe", {})
    base = dict(name="t", family="transformer", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128, head_dim=8,
                compute_dtype="float32")
    base.update(kw)
    m = dict(n_experts=4, top_k=2, d_expert=16, n_shared_experts=1,
             n_dense_layers=1, capacity_factor=8.0)
    m.update(moe)
    return (JArchConfig(moe=JMoEConfig(**m), **base),
            TArchConfig(moe=TMoEConfig(**m), **base))


def arch(name, **kw):
    """reduced(name) on both sides, f32 compute and W8A8 unless
    overridden."""
    kw = {"quant": "w8a8_ffn", "compute_dtype": "float32", **kw}
    return (dataclasses.replace(jreduced(jregistry.get(name)), **kw),
            dataclasses.replace(treduced(tregistry.get(name)), **kw))


CONFIGS = {
    "small_moe": lambda: small_moe(),
    "small_moe_w8a8": lambda: small_moe(quant="w8a8_ffn"),
    "mixtral": lambda: arch("mixtral-8x7b"),
    "kimi": lambda: arch("kimi-k2-1t-a32b"),
    "drops": lambda: small_moe(quant="w8a8_ffn",
                               moe={"capacity_factor": 1.0}),
}

_PARAMS = {}


def both(name):
    """(jcfg, tcfg, jparams, tparams) of a CONFIGS entry, drawn once."""
    if name not in _PARAMS:
        jcfg, tcfg = CONFIGS[name]()
        jp = jax.jit(lambda k: jtfm.init_params(jcfg, k))(jax.random.key(0))
        _PARAMS[name] = (jcfg, tcfg, jp, transformer_params_from_numpy(
            jax.device_get(jp), device="cpu"))
    return _PARAMS[name]


def tokens(cfg, shape, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks).to(
        torch.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _margin(tcfg, tp, ttoks):
    """The least gap, over every MoE layer and token of the port's forward
    pass, between a token's k-th and (k+1)-th router probability (inf with
    every expert chosen).  The two packages' router probabilities differ
    in the last bits, far below the gaps the tests assert."""
    m = tcfg.moe
    if m.top_k >= m.n_experts:
        return np.inf
    gaps = []
    real = ttfm._local_route

    def route(h, router_w, *a):
        p = torch.softmax(h.float() @ router_w.float(), dim=-1)
        p = torch.sort(p, dim=-1).values
        gaps.append(float((p[:, -m.top_k] - p[:, -m.top_k - 1]).min()))
        return real(h, router_w, *a)
    ttfm._local_route = route
    try:
        with torch.no_grad():
            ttfm.forward(tcfg, tp, ttoks)
    finally:
        ttfm._local_route = real
    return min(gaps)


# ---------------------------------------------------------------------------
# Routing and the expert products: exact
# ---------------------------------------------------------------------------


def _route_inputs(jcfg, n, seed, ties=False):
    """(h (n, d), router (d, E)) of dyadic values: every f32 product and
    sum of the router logits is exact, so both packages route the same
    logits.  ``ties`` gives experts 0 and 1 the same router column (exact
    ties, which go to the lower index) and expert 3 a copy of expert 2's."""
    rng = np.random.default_rng(seed)
    d, E = jcfg.d_model, jcfg.moe.n_experts
    h = (rng.integers(-8, 9, (n, d)) / 4).astype(np.float32)
    router = (rng.integers(-16, 17, (d, E)) / 64).astype(np.float32)
    if ties:
        router[:, 1] = router[:, 0]
        router[:, 3] = router[:, 2]
    return h, router


ROUTE_CASES = {"small_moe": ("small_moe", False), "mixtral": ("mixtral", False),
               "kimi": ("kimi", False), "drops": ("drops", False),
               "ties": ("small_moe", True)}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_local_route_matches_reference(case):
    name, ties = ROUTE_CASES[case]
    jcfg, tcfg, _, _ = both(name)
    n = 24
    h, router = _route_inputs(jcfg, n, seed=5, ties=ties)
    m = jcfg.moe
    cap = max(int(m.top_k * n * m.capacity_factor / m.n_experts), 4)
    assert ttfm.capacity(tcfg.moe, n) == cap
    jg, jgates, jfilled, jaux, jz = jtfm._local_route(
        jnp.asarray(h), jnp.asarray(router), m, 0, m.n_experts, cap)
    r = ttfm._local_route(torch.from_numpy(h), torch.from_numpy(router),
                          tcfg.moe, cap)
    np.testing.assert_array_equal(r.gather_idx.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(r.filled.numpy(), np.asarray(jfilled))
    _close(r.gates, jgates, ROUTE_TOL)
    _close(r.aux, jaux, ROUTE_TOL)
    _close(r.z_loss, jz, ROUTE_TOL)
    kept = int(np.asarray(jfilled).sum())
    if case == "drops":               # capacity 12 < some expert's load
        assert kept < n * m.top_k
    else:
        assert kept == n * m.top_k
    if ties:                          # the tie went to the lower index
        logits = h @ router
        assert (logits[:, 0] == logits[:, 1]).all()
        chosen = {tuple(sorted(int(e) for e in np.flatnonzero(
            (np.asarray(jg) == t) & np.asarray(jfilled)) // cap))
            for t in range(n)}
        assert all(1 not in c or 0 in c for c in chosen)
    # each token's kept rows, in ascending order, are the rows the
    # reference's scatter-add sums onto it
    for t in range(n):
        rows = np.flatnonzero((np.asarray(jg) == t) & np.asarray(jfilled))
        got = r.tslot[t].numpy()
        np.testing.assert_array_equal(got[got < m.n_experts * cap], rows)


@pytest.mark.parametrize("name", ["small_moe_w8a8", "mixtral", "kimi",
                                  "drops"])
def test_expert_products_exact(name):
    """The expert buffer, the int8 activations and the int32 accumulators
    of ``_qeinsum``'s three products equal the reference's bit for bit,
    and its rescaled outputs equal the reference's on equal inputs."""
    jcfg, tcfg, jp, tp = both(name)
    n = 24
    h, router = _route_inputs(jcfg, n, seed=7)
    m = jcfg.moe
    cap = ttfm.capacity(tcfg.moe, n)
    jg, _, jfilled, _, _ = jtfm._local_route(
        jnp.asarray(h), jnp.asarray(router), m, 0, m.n_experts, cap)
    r = ttfm._local_route(torch.from_numpy(h), torch.from_numpy(router),
                          tcfg.moe, cap)
    jbuf = jnp.where(jfilled[:, None], jnp.asarray(h)[jg], 0).reshape(
        m.n_experts, cap, -1)
    tbuf = torch.where(r.filled[:, None], torch.from_numpy(h)[r.gather_idx],
                       0).reshape(m.n_experts, cap, -1)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    jbp = {k: v[0] for k, v in jp["moe_blocks"].items()}
    tbp = {k: v[0] for k, v in tp["moe_blocks"].items()}
    x = np.array(jbuf)
    for wname, spec in (("we_g", "ecd,edf->ecf"), ("we_i", "ecd,edf->ecf"),
                        ("we_o", "ecf,efd->ecd")):
        if wname == "we_o":          # the down product takes a d_expert row
            x = np.random.default_rng(9).standard_normal(
                (m.n_experts, cap, m.d_expert)).astype(np.float32)
            x[~np.asarray(jfilled).reshape(m.n_experts, cap)] = 0
        jx_q, jx_s = jtfm._quantize_act(jnp.asarray(x))
        tx_q, tx_s = ttfm._quantize_act(torch.from_numpy(x))
        np.testing.assert_array_equal(tx_q.numpy(), np.asarray(jx_q))
        np.testing.assert_array_equal(tx_s.numpy(), np.asarray(jx_s))
        jacc = jnp.einsum(spec, jx_q, jbp[wname + "_q"],
                          preferred_element_type=jnp.int32)
        tacc = torch.stack([dispatch.matmul_acc(tx_q[e], tbp[wname + "_q"][e])
                            for e in range(m.n_experts)])
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        want = jtfm._qeinsum(jcfg, spec, jnp.asarray(x), jbp, wname)
        got = ttfm._qeinsum(tcfg, torch.from_numpy(x), tbp, wname)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_combine_sums_each_token_in_buffer_order():
    """The combine equals a scatter-add in buffer order, bit for bit, on
    every row, with dropped choices adding nothing."""
    _, tcfg, _, _ = both("drops")
    n = 24
    h, router = _route_inputs(both("drops")[0], n, seed=11)
    cap = ttfm.capacity(tcfg.moe, n)
    r = ttfm._local_route(torch.from_numpy(h), torch.from_numpy(router),
                          tcfg.moe, cap)
    out = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (tcfg.moe.n_experts * cap, 8)).astype(np.float32))
    want = torch.zeros((n, 8))
    for row in range(out.shape[0]):            # the reference's order
        if r.filled[row]:
            want[r.gather_idx[row]] += out[row]
    assert torch.equal(ttfm._combine(out, r), want)


# ---------------------------------------------------------------------------
# The model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_forward_matches_reference(name):
    jcfg, tcfg, jp, tp = both(name)
    jt, tt = tokens(jcfg, (2, 16))
    assert _margin(tcfg, tp, tt) > 1e-5
    want = jax.jit(lambda p, t: jtfm.forward(jcfg, p, t))(jp, jt)
    got = ttfm.forward(tcfg, tp, tt)
    assert got.logits.shape == (2, 16, jcfg.vocab_size)
    _close(got.logits, want.logits, TOL)
    _close(got.aux_loss, want.aux_loss, ROUTE_TOL)
    _close(got.z_loss, want.z_loss, ROUTE_TOL)
    assert float(got.aux_loss) > 0.0


@pytest.mark.parametrize("name", ["small_moe", "mixtral", "kimi"])
def test_prefill_then_decode_matches_reference(name):
    """Prefill logits, then decode steps (the batch's rows routed as one
    batch of B tokens), against the reference's."""
    jcfg, tcfg, jp, tp = both(name)
    B, S, steps = 2, 10, 4
    jt, tt = tokens(jcfg, (B, S + steps), seed=3)
    assert _margin(tcfg, tp, tt) > 1e-5
    jl, jc = jtfm.prefill(jcfg, jp, jt[:, :S], max_len=S + steps)
    tl, tc = ttfm.prefill(tcfg, tp, tt[:, :S], S + steps)
    _close(tl, jl, TOL)
    _close(tc.k, jc.k, TOL)
    dec = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    for t in range(S, S + steps):
        jl, jc = dec(jp, jt[:, t], jc)
        tl, tc = ttfm.decode_step(tcfg, tp, tt[:, t], tc)
        _close(tl, jl, TOL)
    assert tc.length.tolist() == [S + steps] * B


def test_decode_matches_forward():
    """tests/test_transformer.py's ``test_decode_matches_forward`` for
    ``small_moe``: teacher-forced decode reproduces forward's logits (a
    dropless capacity, so batch and token-at-a-time routing agree)."""
    _, tcfg, _, tp = both("small_moe")
    _, tt = tokens(tcfg, (2, 12))
    full = ttfm.forward(tcfg, tp, tt).logits
    cache = ttfm.init_cache(tcfg, 2, max_len=12, device="cpu")
    for t in range(12):
        logits, cache = ttfm.decode_step(tcfg, tp, tt[:, t], cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), **TOL)


def test_swa_moe_decodes_past_its_ring():
    """reduced mixtral (window 16) decoding 24 steps past a 12-token
    prefill: the ring wraps, and the logits follow the reference's."""
    jcfg, tcfg, jp, tp = both("mixtral")
    S, steps = 12, 24
    assert jcfg.swa_window == 16 and S + steps > 2 * jcfg.swa_window
    jt, tt = tokens(jcfg, (1, S + steps), seed=4)
    jl, jc = jtfm.prefill(jcfg, jp, jt[:, :S], max_len=S + steps)
    tl, tc = ttfm.prefill(tcfg, tp, tt[:, :S], S + steps)
    assert tc.k.shape[2] == 16
    dec = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    for t in range(S, S + steps):
        jl, jc = dec(jp, jt[:, t], jc)
        tl, tc = ttfm.decode_step(tcfg, tp, tt[:, t], tc)
        _close(tl, jl, TOL)


def test_loss_and_grads_match_reference():
    """``loss_fn`` (CE + aux_loss·aux + router_z_loss·z) and its gradients
    through the routing (gates), the expert products, the router and the
    shared experts, against ``jax.grad``."""
    jcfg, tcfg, jp, _ = both("small_moe")
    jt, tt = tokens(jcfg, (2, 16))
    batch_j = {"tokens": jt, "labels": jt}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, batch_j), has_aux=True))(jp)
    tp = transformer_params_from_numpy(jax.device_get(jp), device="cpu")
    for blk in tp.values():
        for t in (blk.values() if isinstance(blk, dict) else [blk]):
            t.requires_grad_(True)
    tloss, taux = ttfm.loss_fn(tcfg, tp, {"tokens": tt, "labels": tt})
    tloss.backward()
    _close(tloss, jloss, LOSS_TOL)
    for k in ("ce", "aux", "z"):
        _close(taux[k], jaux[k], LOSS_TOL)
    for blk, jb in jgrads.items():
        tb = tp[blk]
        if not isinstance(jb, dict):
            _close(tb.grad, jb, LOSS_TOL)
            continue
        for k, g in jb.items():
            _close(tb[k].grad, g, LOSS_TOL)
    assert float(tp["moe_blocks"]["we_i"].grad.abs().max()) > 0


def test_remat_moe_matches_plain_gradients():
    """``remat`` wraps the MoE blocks as it wraps the dense ones: the same
    loss and gradients."""
    _, tcfg, _, _ = both("small_moe")
    _, tt = tokens(tcfg, (2, 16))
    grads = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        tp = tapi.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        for t in tp["moe_blocks"].values():
            t.requires_grad_(True)
        assert ttfm._remat(cfg, tp) == (remat != "none")
        loss, _ = ttfm.loss_fn(cfg, tp, {"tokens": tt, "labels": tt})
        loss.backward()
        grads[remat] = {k: t.grad for k, t in tp["moe_blocks"].items()}
    for k, g in grads["none"].items():
        torch.testing.assert_close(grads["full"][k], g, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Parameters: layout, quantization, conversion, the card's generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,quant", [("mixtral-8x7b", "none"),
                                        ("mixtral-8x7b", "w8a8_ffn"),
                                        ("kimi-k2-1t-a32b", "w8a8_ffn")])
def test_init_params_and_convert_match_reference(name, quant):
    """The port's parameter tree has the reference's keys, shapes and
    dtypes (no ``dense_blocks`` for mixtral; kimi's leading dense layer;
    (E, K, N) experts with (E, N) scales), and ``convert.py`` carries the
    reference's tree across leaf for leaf, W8A8 included."""
    jcfg, tcfg = arch(name, quant=quant, param_dtype="bfloat16")
    jp = jax.device_get(jax.jit(lambda k: jtfm.init_params(jcfg, k))(
        jax.random.key(0)))
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")

    def layout(tree, dt):
        return {k: layout(v, dt) if isinstance(v, dict)
                else (tuple(v.shape), dt(v)) for k, v in tree.items()}
    assert layout(tp, lambda t: str(t.dtype).replace("torch.", "")) == \
        layout(jp, lambda a: str(a.dtype))
    assert ("dense_blocks" in tp) == (name == "kimi-k2-1t-a32b")
    conv = transformer_params_from_numpy(jp, device="cpu")
    for blk, jb in jp.items():
        for k, a in (jb.items() if isinstance(jb, dict) else [(None, jb)]):
            t = conv[blk] if k is None else conv[blk][k]
            np.testing.assert_array_equal(
                t.float().numpy() if t.dtype == torch.bfloat16
                else t.numpy(), np.asarray(a, np.float32)
                if a.dtype.name == "bfloat16" else np.asarray(a))


def test_quantize_ffn_weight_in_chunks_equals_whole(monkeypatch):
    """A leaf quantized a few (K, N) matrices at a time gives the values
    of the whole-leaf quantization: the scales are per matrix."""
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, 12, 7)).astype(np.float32)).to(torch.bfloat16)
    whole = ttfm.quantize_ffn_weight(w)
    monkeypatch.setattr(ttfm, "_QUANT_CHUNK", 2 * 12 * 7)
    for a, b in zip(ttfm.quantize_ffn_weight(w), whole):
        assert torch.equal(a, b)
    jq, js = jtfm.quantize_ffn_weight(jnp.asarray(w.float().numpy(),
                                                  jnp.bfloat16))
    np.testing.assert_array_equal(whole[0].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(whole[1].numpy(), np.asarray(js))


def test_dense_init_draws_on_the_generators_device():
    """A CPU generator gives the numbers it always gave (pinned), on the
    CPU; the draw happens on ``gen.device``."""
    gen = torch.Generator().manual_seed(0)
    w = tcommon.dense_init(gen, (3, 37, 41), in_axis=1)
    assert w.device.type == "cpu" and w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.flatten()[:4].numpy(),
        np.array([-0.1850869208574295, -0.1894468516111374,
                  -0.0411948636174202, -0.07132923603057861], np.float32))
    e = tcommon.embed_init(torch.Generator().manual_seed(0), (2, 3),
                           dtype=torch.bfloat16)
    want = (torch.randn((2, 3), generator=torch.Generator().manual_seed(0))
            * 0.02).to(torch.bfloat16)
    assert torch.equal(e, want)


# ---------------------------------------------------------------------------
# Serving: the Engine, a weight strike, the launcher
# ---------------------------------------------------------------------------


def _j_flip(index, bit):
    def flip(x):
        bits, u = jfi._as_bits(x)
        flat = bits.reshape(-1)
        i = index % flat.shape[0]
        flat = flat.at[i].set(flat[i] ^ u(1 << bit))
        return jax.lax.bitcast_convert_type(flat.reshape(x.shape), x.dtype)
    return flip


def _engine_streams(side, cfg, params, strike=False):
    E, R = (JEngine, JRequest) if side == "jax" else (Engine, Request)
    eng = E(cfg, params, capacity=2, max_len=48, prefill_pad=8,
            snapshot_every=2, storage_scrub="rollback",
            storage_scrub_every=1)
    reqs = [R(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate([[5, 9, 2], [3, 1, 4, 1, 5, 9, 2, 6, 5],
                                   [7, 7]])]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while (eng.queue or eng.active) and steps < 100:
        eng.step()
        steps += 1
        if steps == 2 and strike:
            if side == "jax":
                p = dict(eng.params)
                p["moe_blocks"] = dict(p["moe_blocks"])
                p["moe_blocks"]["we_g_q"] = _j_flip(123, 6)(
                    p["moe_blocks"]["we_g_q"])
                eng.params = p
            else:
                eng.strike("weights", lambda x, g: fi.flip_bit_at_index(
                    x, 123, 6), None, leaf=("moe_blocks", "we_g_q"))
    return [tuple(r.output) for r in reqs], eng


def test_engine_streams_match_reference_and_heal_an_expert_strike():
    """reduced mixtral (W8A8 experts, f32 compute) served by both packages'
    Engines: equal streams, and a bit flip in ``moe_blocks/we_g_q`` healed
    by the storage scrub's rollback in both."""
    jcfg, tcfg, jp, tp = both("mixtral")
    golden, _ = _engine_streams("torch", tcfg, tp)
    jgolden, _ = _engine_streams("jax", jcfg, jp)
    assert golden == jgolden
    assert all(len(s) == 6 for s in golden)
    healed, eng = _engine_streams("torch", tcfg, tp, strike=True)
    jhealed, jeng = _engine_streams("jax", jcfg, jp, strike=True)
    assert healed == jhealed == golden
    ev = [e for e in eng.drain_state_events() if e.get("site") == "weights"]
    jev = [e for e in jeng.drain_state_events()
           if e.get("site") == "weights"]
    assert len(ev) == len(jev) == 1 and ev[0]["recovered"]


def test_serve_launcher_serves_mixtral(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--max-len", "64"])
    assert "[serve] all requests completed" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Flash attention at head dim 112
# ---------------------------------------------------------------------------


def test_flash_head_dim_112_matches_pallas():
    """A small config with head_dim 112 (kimi-k2's) under
    ``attn_impl="flash"``: forward logits against the reference's, whose
    attention runs the Pallas kernels in interpret mode; and the port's
    forward-with-lse kernel against the reference's at (1, 4, 24, 112)."""
    jcfg, tcfg = small_moe(head_dim=112, attn_impl="flash", n_layers=1,
                           moe={"n_dense_layers": 0})
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    tp = transformer_params_from_numpy(jax.device_get(jp), device="cpu")
    jt, tt = tokens(jcfg, (1, 24))
    assert _margin(tcfg, tp, tt) > 1e-5
    _close(ttfm.forward(tcfg, tp, tt).logits,
           jtfm.forward(jcfg, jp, jt).logits, TOL)
    from repro.kernels.flashattn import kernel as jfk
    from repro_torch.kernels.flashattn import kernel as tfk
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 24, 112), (1, 2, 24, 112), (1, 2, 24, 112)))
    jo, jl = jfk.flash_attention_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), block_q=8,
                                         block_k=8, interpret=True)
    to, tl = tfk.flash_attention_fwd_lse(*(torch.from_numpy(a)
                                           for a in (q, k, v)))
    _close(to, jo, dict(rtol=1e-5, atol=1e-5))
    _close(tl, jl, dict(rtol=1e-5, atol=1e-5))
    assert 112 in tfk.HEAD_DIMS
