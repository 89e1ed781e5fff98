"""The port's recurrent families against their own oracles and against the
reference: tests/test_rwkv_griffin.py's eleven cases (chunked/parallel
forms against the recurrent ones, decode against forward, prefill then
decode, finite gradients through autograd), and the reference's
``wkv_chunked``, ``rglru_parallel`` and the logits of ``forward``,
``prefill`` and ``decode_step`` on converted weights.

Tolerances: the f32 kernels of the recurrences within 1e-4 (rtol and atol,
the reference test's), ``rglru_parallel`` against the unrolled step within
1e-5 (the reference test's) and against ``jax.lax.associative_scan`` within
1e-5 (the log-depth scan multiplies in another order); model logits in
f32 within 2e-3 of their own forward (the reference test's) and within
1e-4 of the reference's on the same weights.  Every zero-initialised
parameter (norm scales, ``mu``, ``u``, the ddlerp and decay ``B`` factors)
is drawn at random for the parity cases, so every path carries signal.

Griffin's rows keep one position each here and one per batch in the
reference (ROADMAP queue 3): the reference is compared only where every
row sits at the same position (``test_logits_match_reference``: one
prompt length per batch)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import griffin as jgriffin
from repro.models import rwkv6 as jrwkv6
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import RecurrentConfig as JRecurrentConfig
from repro_torch.convert import (griffin_params_from_numpy,
                                 rwkv6_params_from_numpy)
from repro_torch.models import griffin, rwkv6
from repro_torch.models.config import ArchConfig, RecurrentConfig

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)


def _rwkv_kw(**kw):
    base = dict(name="rwkv-t", family="rwkv", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=1, d_ff=64, vocab_size=128,
                compute_dtype="float32", sub_quadratic=True)
    base.update(kw)
    return base


def _griffin_kw(**kw):
    base = dict(name="grif-t", family="hybrid", n_layers=5, d_model=32,
                n_heads=4, n_kv_heads=1, d_ff=64, vocab_size=128, head_dim=8,
                compute_dtype="float32", sub_quadratic=True)
    base.update(kw)
    return base


def rwkv_cfg(**kw):
    return ArchConfig(recurrent=RecurrentConfig(kind="rwkv6", head_dim=8),
                      **_rwkv_kw(**kw))


def griffin_cfg(**kw):
    return ArchConfig(recurrent=RecurrentConfig(kind="rglru", attn_window=8,
                                                lru_width=32, d_conv=4),
                      **_griffin_kw(**kw))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _tokens(cfg, shape, seed=1):
    return torch.randint(0, cfg.vocab_size, shape, generator=_gen(seed))


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------


def _wkv_inputs(rng, B, T, H, hd):
    r, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    # decays in a realistic range (0.4 .. 0.999)
    w = rng.uniform(0.4, 0.999, size=(B, T, H, hd)).astype(np.float32)
    u = (rng.normal(size=(H, hd)) * 0.3).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("T,chunk", [(16, 4), (17, 8), (32, 32), (9, 16)])
def test_wkv_chunked_matches_scan(T, chunk):
    rng = np.random.default_rng(T * 31 + chunk)
    args = _wkv_inputs(rng, 2, T, 3, 8)
    t_args = [torch.from_numpy(a) for a in args]
    o_ref, s_ref = rwkv6.wkv_scan(*t_args)
    o_chk, s_chk = rwkv6.wkv_chunked(*t_args, chunk=chunk)
    np.testing.assert_allclose(o_chk.numpy(), o_ref.numpy(), **TOL)
    np.testing.assert_allclose(s_chk.numpy(), s_ref.numpy(), **TOL)
    # and the reference's chunked form on the same inputs
    o_j, s_j = jrwkv6.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(o_chk.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(s_chk.numpy(), np.asarray(s_j), **TOL)


def test_wkv_chunked_with_initial_state():
    rng = np.random.default_rng(0)
    B, T, H, hd = 1, 12, 2, 4
    mk = lambda: rng.normal(size=(B, T, H, hd)).astype(np.float32)  # noqa
    r, k, v = mk(), mk(), mk()
    w = rng.uniform(0.5, 0.99, size=(B, T, H, hd)).astype(np.float32)
    u = np.zeros((H, hd), np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    o_ref, s_ref = rwkv6.wkv_scan(*t)
    o_chk, s_chk = rwkv6.wkv_chunked(*t, chunk=5)
    np.testing.assert_allclose(o_chk.numpy(), o_ref.numpy(), **TOL)
    np.testing.assert_allclose(s_chk.numpy(), s_ref.numpy(), **TOL)
    o_j, s_j = jrwkv6.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u, s0)),
                                  chunk=5)
    np.testing.assert_allclose(o_chk.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(s_chk.numpy(), np.asarray(s_j), **TOL)


# ---------------------------------------------------------------------------
# RWKV6 model
# ---------------------------------------------------------------------------


def test_rwkv_forward_finite():
    cfg = rwkv_cfg()
    params = rwkv6.init_params(cfg, _gen(0), device="cpu")
    out = rwkv6.forward(cfg, params, _tokens(cfg, (2, 16)))
    assert out.logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(out.logits).all())


def test_rwkv_decode_matches_forward():
    cfg = rwkv_cfg()
    params = rwkv6.init_params(cfg, _gen(0), device="cpu")
    B, S = 2, 10
    tokens = _tokens(cfg, (B, S))
    full = rwkv6.forward(cfg, params, tokens)
    cache = rwkv6.init_cache(cfg, B, max_len=S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = rwkv6.decode_step(cfg, params, tokens[:, t], cache)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               full.logits.numpy(), **MODEL_TOL)


def test_rwkv_prefill_then_decode():
    cfg = rwkv_cfg()
    params = rwkv6.init_params(cfg, _gen(0), device="cpu")
    B, S = 1, 9
    tokens = _tokens(cfg, (B, S + 1))
    full = rwkv6.forward(cfg, params, tokens)
    logits_p, cache = rwkv6.prefill(cfg, params, tokens[:, :S],
                                    max_len=S + 2)
    np.testing.assert_allclose(logits_p[:, -1].numpy(),
                               full.logits[:, S - 1].numpy(), **MODEL_TOL)
    logits_d, _ = rwkv6.decode_step(cfg, params, tokens[:, S], cache)
    np.testing.assert_allclose(logits_d.numpy(), full.logits[:, S].numpy(),
                               **MODEL_TOL)


def _grads_finite(mod, cfg):
    params = mod.init_params(cfg, _gen(0), device="cpu")
    leaves = [t for v in params.values()
              for t in (v.values() if isinstance(v, dict) else [v])]
    for t in leaves:
        t.requires_grad_(True)
    tokens = _tokens(cfg, (2, 8))
    loss, _ = mod.loss_fn(cfg, params, {"tokens": tokens, "labels": tokens})
    loss.backward()
    assert bool(torch.isfinite(loss))
    for t in leaves:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


def test_rwkv_grads_finite():
    _grads_finite(rwkv6, rwkv_cfg())


# ---------------------------------------------------------------------------
# Griffin / RG-LRU
# ---------------------------------------------------------------------------


def _rglru_inputs(seed=1, B=2, T=11, W=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    g = rng.uniform(0.1, 0.9, size=(B, T, W)).astype(np.float32)
    lam = rng.uniform(0.5, 3.0, size=(W,)).astype(np.float32)
    return x, g, lam


def test_rglru_parallel_matches_step():
    x, g, lam = map(torch.from_numpy, _rglru_inputs())
    h_par = griffin.rglru_parallel(x, g, lam)
    h = torch.zeros((x.shape[0], x.shape[2]))
    seq = []
    for t in range(x.shape[1]):
        h = griffin.rglru_step(x[:, t], g[:, t], lam, h)
        seq.append(h)
    np.testing.assert_allclose(h_par.numpy(), torch.stack(seq, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [1, 2, 11, 64, 257])
def test_rglru_parallel_matches_reference(T):
    x, g, lam = _rglru_inputs(seed=T, T=T)
    got = griffin.rglru_parallel(*map(torch.from_numpy, (x, g, lam)))
    want = jgriffin.rglru_parallel(*map(jnp.asarray, (x, g, lam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32)
    for state in (None, st):
        got, gs = griffin._causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w),
            None if state is None else torch.from_numpy(state))
        want, ws = jgriffin._causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_griffin_forward_finite():
    cfg = griffin_cfg()
    params = griffin.init_params(cfg, _gen(0), device="cpu")
    out = griffin.forward(cfg, params, _tokens(cfg, (2, 12)))
    assert out.logits.shape == (2, 12, cfg.vocab_size)
    assert bool(torch.isfinite(out.logits).all())


def test_griffin_decode_matches_forward():
    cfg = griffin_cfg()
    params = griffin.init_params(cfg, _gen(0), device="cpu")
    B, S = 1, 12                       # past the window (8)
    tokens = _tokens(cfg, (B, S))
    full = griffin.forward(cfg, params, tokens)
    cache = griffin.init_cache(cfg, B, max_len=S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = griffin.decode_step(cfg, params, tokens[:, t], cache)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               full.logits.numpy(), **MODEL_TOL)


def test_griffin_prefill_then_decode():
    cfg = griffin_cfg()
    params = griffin.init_params(cfg, _gen(0), device="cpu")
    B, S = 1, 10
    tokens = _tokens(cfg, (B, S + 1))
    full = griffin.forward(cfg, params, tokens)
    logits_p, cache = griffin.prefill(cfg, params, tokens[:, :S],
                                      max_len=S + 2)
    np.testing.assert_allclose(logits_p[:, -1].numpy(),
                               full.logits[:, S - 1].numpy(), **MODEL_TOL)
    logits_d, _ = griffin.decode_step(cfg, params, tokens[:, S], cache)
    np.testing.assert_allclose(logits_d.numpy(), full.logits[:, S].numpy(),
                               **MODEL_TOL)


def test_griffin_grads_finite():
    _grads_finite(griffin, griffin_cfg())


# ---------------------------------------------------------------------------
# Logits against the reference on converted weights
# ---------------------------------------------------------------------------


def _randomise_zeros(tree, seed):
    """Every all-zero leaf drawn at random (scale 0.3), so that norm
    scales, mixes, bonuses and low-rank factors carry signal."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and not a.any():
            return (rng.normal(size=a.shape) * 0.3).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(f, tree)


FAMILIES = {
    "rwkv": (jrwkv6, rwkv6, rwkv6_params_from_numpy,
             lambda: JArchConfig(recurrent=JRecurrentConfig(
                 kind="rwkv6", head_dim=8), **_rwkv_kw()), rwkv_cfg),
    "griffin": (jgriffin, griffin, griffin_params_from_numpy,
                lambda: JArchConfig(recurrent=JRecurrentConfig(
                    kind="rglru", attn_window=8, lru_width=32, d_conv=4),
                    **_griffin_kw()), griffin_cfg),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_reference(family):
    jmod, tmod, convert, jcfg_fn, tcfg_fn = FAMILIES[family]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    tree = _randomise_zeros(jax.device_get(
        jmod.init_params(jcfg, jax.random.key(0))), seed=7)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert(tree, device="cpu")
    B, S, P = 2, 13, 9                 # past griffin's window of 8
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, S))
    tt = torch.from_numpy(toks).to(torch.int32)
    jt = jnp.asarray(toks, jnp.int32)
    # the reference jitted once per function (its scans compile per call)
    j_fwd = jax.jit(jmod.forward, static_argnums=0)
    j_pre = jax.jit(jmod.prefill, static_argnums=(0, 3))
    j_dec = jax.jit(jmod.decode_step, static_argnums=0)
    np.testing.assert_allclose(tmod.forward(tcfg, tparams, tt).logits.numpy(),
                               np.asarray(j_fwd(jcfg, jparams, jt).logits),
                               **TOL)
    lt, ct = tmod.prefill(tcfg, tparams, tt[:, :P], max_len=S + 2)
    lj, cj = j_pre(jcfg, jparams, jt[:, :P], S + 2)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for t in range(P, S):
        lt, ct = tmod.decode_step(tcfg, tparams, tt[:, t], ct)
        lj, cj = j_dec(jcfg, jparams, jt[:, t], cj)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_rwkv_float64_witness():
    """The precision witness (``repro_torch.models.witness``) at a small
    width: a float64 forward gives the same logits at two lengths (1e-12,
    normwise), float32 stands within 1e-5 of it, and a bf16 prefill +
    decode misses 1e-4, the card's limit for f32."""
    from repro_torch.models.witness import witness
    doc = witness(rwkv_cfg(compute_dtype="bfloat16"), prompt=9, steps=4,
                  cpu=True, device="cpu")
    p = {k: v["max"] for k, v in doc["pairs"].items()}
    assert p["f64 forward S vs S+steps"] < 1e-12
    assert p["f32 forward S+steps vs f64"] < 1e-5
    assert p["f32 prefill+decode vs f64"] < 1e-5
    assert p["bf16 prefill+decode vs f32 forward"] > 1e-4
    with pytest.raises(ValueError, match="no float64 path"):
        witness(griffin_cfg(), device="cpu")


def test_reduced_griffin_has_no_attention_layer():
    """The premise of every Engine and fleet parity case on ``reduced()``
    recurrentgemma: the reference keeps one position per batch, the port
    one per row (``GriffinCache.length``), and the two agree on a model
    without attention layers, or where every row sits at one position."""
    from repro_torch.configs import registry
    from repro_torch.models.config import reduced
    cfg = reduced(registry.get("recurrentgemma-2b"))
    n_super, tail, n_attn = griffin._counts(cfg)
    assert (n_super, n_attn) == (0, 0) and tail == cfg.n_layers


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spliced_rows_decode_as_alone(family):
    """Two prompts of different lengths prefilled alone, spliced into rows
    of one batch cache (``api.cache_write_slot``) and decoded together: each
    row's logits equal its own single-request decode.  Griffin's rows keep
    their own positions (``GriffinCache.length`` is per row), so its
    attention layers see each row's ring as a lone request does."""
    from repro_torch.models import api
    tmod, cfg = FAMILIES[family][1], FAMILIES[family][4]()
    params = tmod.init_params(cfg, _gen(0), device="cpu")
    prompts = [_tokens(cfg, (1, 11), seed=2), _tokens(cfg, (1, 4), seed=3)]
    steps = _tokens(cfg, (2, 6), seed=4)
    batch = tmod.init_cache(cfg, 2, max_len=24, device="cpu")
    alone = []
    for row, p in enumerate(prompts):
        _, one = tmod.prefill(cfg, params, p, max_len=24)
        batch = api.cache_write_slot(batch, tuple(t.clone() for t in one),
                                     row, p.shape[1])
        logits = []
        for t in range(steps.shape[1]):
            lg, one = tmod.decode_step(cfg, params, steps[row:row + 1, t],
                                       one)
            logits.append(lg[0])
        alone.append(torch.stack(logits))
    for t in range(steps.shape[1]):
        lg, batch = tmod.decode_step(cfg, params, steps[:, t], batch)
        for row in range(2):
            np.testing.assert_allclose(lg[row].numpy(),
                                       alone[row][t].numpy(), **TOL)
