"""The int8 KV cache (``cfg.quant_kv``) held against the reference's.

On shared inputs: ``_quantize_kv_rows`` gives the reference's int8 rows
and f32 scales bit for bit, and so does quantizing the reference's own
float K/V (the pages and scales of its ``quant_kv`` prefill); the int8
q.k scores (``common.int8_scores``) are the reference's int32 product
exactly.  End to end at ``reduced(smollm-135m)`` (W8A8 FFN, f32 compute,
the reference's parameters): after prefill and four decode steps the int8
pages equal the reference's and the scales agree to 1e-6 relative (the
K/V they scale come out of f32 matmuls and RoPE whose rounding differs
by a few ulps); decode logits agree within 2e-6; greedy streams through
both engines are equal token for token.  Beside them, the two index rules
a struck token buffer or weight leans on: an out-of-range token id reads
the row JAX's gather reads, and ``torch.argmax`` picks ``jnp.argmax``'s
index over NaN, inf and ties."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro.models.config import reduced as jreduced
from repro.runtime.serving import Engine as JEngine
from repro.runtime.serving import Request as JRequest
from repro_torch.configs import registry as tregistry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import common
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import reduced
from repro_torch.runtime.serving import Engine, Request

jax.config.update("jax_platform_name", "cpu")

_KW = dict(quant="w8a8_ffn", compute_dtype="float32")
SCALE_TOL = dict(rtol=1e-6, atol=0)          # a few f32 ulps
LOGIT_TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")), **_KW)
    cfg = dataclasses.replace(reduced(tregistry.get("smollm-135m")), **_KW)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = transformer_params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, cfg, jp, tp


def _q(cfg):
    return dataclasses.replace(cfg, quant_kv=True)


def _np(a):
    return np.asarray(jax.device_get(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bitwise(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 4, 16)).astype(np.float32) * 5
    x[0, 0, 0] = 0.0                                   # an all-zero row
    x[0, 1, 1, :] = np.arange(16) - 7.5                # .5 ties at scale 1
    x[0, 1, 1, 0] = 127.0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jtfm._quantize_kv_rows(jx)
    tq, ts = ttfm._quantize_kv_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


@pytest.mark.parametrize("hd", [16, 128])
def test_int8_scores_are_the_reference_int32_product(hd):
    rng = np.random.default_rng(hd)
    B, T, KV, G = 2, 9, 3, 3
    q = rng.integers(-127, 128, (B, KV, G, hd)).astype(np.int8)
    k = rng.integers(-127, 128, (B, T, KV, hd)).astype(np.int8)
    q[0], k[0] = 127, 127                      # the largest |sum|, hd*127^2
    k[1, 0] = -128
    got = common.int8_scores(torch.from_numpy(q), torch.from_numpy(k))
    want = jnp.einsum("bkgh,btkh->bkgt", jnp.asarray(q), jnp.asarray(k),
                      preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert int(got.max()) == hd * 127 * 127


def test_prefill_quantizes_the_reference_kv_bitwise(model):
    """The reference's float prefill cache, quantized by the port, is its
    ``quant_kv`` prefill cache, pages and scales bit for bit."""
    jcfg, _, jp, _ = model
    toks = jnp.asarray([[5, 9, 2, 7, 1, 3, 0, 0]], jnp.int32)
    S = toks.shape[1]
    _, jflt = japi.prefill(jcfg, jp, toks, 32)
    _, jq = japi.prefill(_q(jcfg), jp, toks, 32)
    for page, scales in (("k", "k_s"), ("v", "v_s")):
        q, s = ttfm._quantize_kv_rows(torch.from_numpy(
            np.array(_np(getattr(jflt, page))[:, :, :S])))
        np.testing.assert_array_equal(q.numpy(),
                                      _np(getattr(jq, page))[:, :, :S])
        np.testing.assert_array_equal(s.numpy(),
                                      _np(getattr(jq, scales))[:, :, :S])
        # the rows past the prompt stay zero, scales included
        assert not _np(getattr(jq, scales))[:, :, S:].any()


def test_cache_pages_and_scales_match_reference(model):
    jcfg, cfg, jp, tp = model
    qj, qt = _q(jcfg), _q(cfg)
    toks = np.array([[5, 9, 2, 7, 1, 3, 0, 0], [4, 4, 8, 1, 0, 0, 0, 0]],
                    np.int32)
    jl, jc = japi.prefill(qj, jp, jnp.asarray(toks), 32)
    tl, tc = tapi.prefill(qt, tp, torch.from_numpy(toks), 32)

    def same(step):
        for f in ("k", "v", "length"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          _np(getattr(jc, f)),
                                          err_msg=f"{f} at {step}")
        for f in ("k_s", "v_s"):
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       _np(getattr(jc, f)), **SCALE_TOL,
                                       err_msg=f"{f} at {step}")

    same("prefill")
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    j_step = jax.jit(lambda p, t, c: japi.decode_step(qj, p, t, c))
    tok = np.array([3, 11], np.int32)
    for i in range(4):
        jl, jc = j_step(jp, jnp.asarray(tok), jc)
        tl, tc = tapi.decode_step(qt, tp, torch.from_numpy(tok), tc)
        same(f"decode {i}")
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
        tok = np.argmax(_np(jl), axis=-1).astype(np.int32)


def test_decode_attention_int8_matches_reference():
    """``decode_attention`` with scales, on the same int8 pages: within
    f32 rounding of the reference's (the softmax and PV product are
    plain f32 tensor code in both)."""
    rng = np.random.default_rng(5)
    B, T, KV, G, hd = 2, 11, 2, 2, 16
    q = rng.normal(size=(B, 1, KV * G, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (B, T, KV, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (B, T, KV, hd)).astype(np.int8)
    ks, vs = (rng.uniform(0.001, 0.05, (B, T, KV)).astype(np.float32)
              for _ in range(2))
    cur = np.array([11, 4], np.int32)
    want = jcommon.decode_attention(*map(jnp.asarray, (q, k, v, cur)),
                                    k_scale=jnp.asarray(ks),
                                    v_scale=jnp.asarray(vs))
    got = common.decode_attention(*map(torch.from_numpy, (q, k, v, cur)),
                                  k_scale=torch.from_numpy(ks),
                                  v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT_TOL)


def _streams(E, R, cfg, params, prompts, n_new, **kw):
    eng = E(cfg, params, capacity=2, max_len=64, prefill_pad=8, **kw)
    reqs = [R(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.output) for r in reqs], eng.stats.steps


def test_greedy_streams_equal_reference_engine(model):
    jcfg, cfg, jp, tp = model
    prompts = [[5, 9, 2, 7], [3, 1], [8, 6, 4, 2, 1], [7]]
    n_new = [8, 6, 7, 5]
    want = _streams(JEngine, JRequest, _q(jcfg), jp, prompts, n_new)
    got = _streams(Engine, Request, _q(cfg), tp, prompts, n_new)
    assert got == want
    # the int8 cache is a different numerics from the float one, and the
    # engine's windows serve it identically
    assert _streams(Engine, Request, _q(cfg), tp, prompts, n_new,
                    multi_step=4)[0] == got[0]


def test_out_of_range_tokens_read_the_rows_jax_gathers(model):
    jcfg, cfg, jp, tp = model
    V = cfg.vocab_size
    ids = np.array([-2**31, -V - 1, -V, -1, 0, V - 1, V, 2**31 - 1],
                   np.int32)
    want = _np(jp["embed"][jnp.asarray(ids)])
    got = ttfm._embed(cfg, tp, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_argmax_picks_the_reference_index_over_nan_and_inf():
    nan, inf = float("nan"), float("inf")
    rows = np.array([[1, nan, 3, nan], [1, inf, inf, 2], [nan, inf, 0, 0],
                     [-inf, -inf, -inf, -inf], [2, 2, 1, 2],
                     [nan, nan, nan, nan], [-inf, nan, inf, nan]],
                    np.float32)
    np.testing.assert_array_equal(
        torch.argmax(torch.from_numpy(rows), dim=-1).numpy(),
        _np(jnp.argmax(jnp.asarray(rows), axis=-1)))


def test_weight_struck_to_inf_serves_the_reference_stream(model):
    """A weight whose exponent bits are struck to inf drives the logits to
    inf/NaN: both engines then pick the same tokens."""
    jcfg, cfg, jp, tp = model
    jp2 = dict(jp, embed=jp["embed"].at[3, 5].set(jnp.inf))
    tp2 = dict(tp, embed=tp["embed"].clone())
    tp2["embed"][3, 5] = float("inf")
    prompts, n_new = [[5, 3, 2], [3, 1]], [5, 5]
    want = _streams(JEngine, JRequest, _q(jcfg), jp2, prompts, n_new)
    got = _streams(Engine, Request, _q(cfg), tp2, prompts, n_new)
    assert got == want
