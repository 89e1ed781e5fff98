"""The port's mirror of tests/test_arch_smoke.py over every name of the
reference's registry: each arch, reduced to at most 2 layers, runs one
forward, one train step (its own optimizer) and one decode step on the CPU
with the reference's shape, finiteness, ``step == 1`` and "params moved"
checks; its config equals the reference's field by field; its forward
logits hold the reference's on the same parameters (the reference's,
converted); the two dense giants, ``command-r-plus-104b`` and
``llama3-405b``, and the embedding-input models, ``musicgen-large`` and
``llava-next-34b`` (on shared ``embeds``, at widths that keep MHA and a
group of 7), take two train steps from the reference's converted state
with losses that hold the reference's; and the embedding-input models'
loss and every gradient hold ``jax.value_and_grad``'s (2e-4), the unused
token table's gradient zero in both.

Tolerances are those of each family's own parity file, on the f32 path:
2e-4 for the dense transformers, token- and embedding-input
(test_torch_transformer.py, test_torch_embed_archs.py), 1e-4 for the MoE
transformers (test_torch_moe.py, whose router-margin guard is kept: a
routing flip is not a rounding difference) and for the recurrent families
(test_torch_rwkv_griffin.py); a train step's loss within 1e-4 relative
(test_torch_train.py).  Each arch's parameters are drawn once per module.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models.config import reduced as jreduced
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro_torch import tree
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import reduced as treduced
from repro_torch.train import optim as toptim
from repro_torch.train import steps as tsteps

jax.config.update("jax_platform_name", "cpu")

ARCHS = jregistry.names()
B, S = 2, 16
TRANSFORMER_TOL = dict(rtol=2e-4, atol=2e-4)
MOE_TOL = dict(rtol=1e-4, atol=1e-4)
RECURRENT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
CONVERT = {"transformer": convert.transformer_params_from_numpy,
           "rwkv": convert.rwkv6_params_from_numpy,
           "hybrid": convert.griffin_params_from_numpy}


def _cfg(name, registry, reduce, **kw):
    c = reduce(registry.get(name))
    return dataclasses.replace(c, n_layers=min(c.n_layers, 2), **kw)


def _tol(cfg):
    if cfg.family != "transformer":
        return RECURRENT_TOL
    return MOE_TOL if cfg.moe is not None else TRANSFORMER_TOL


@pytest.fixture(scope="module")
def smoke_params():
    """name -> (reduced port config, its seed-0 parameters), drawn once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = _cfg(name, tregistry, treduced)
            cache[name] = (cfg, tapi.init_params(
                cfg, torch.Generator().manual_seed(0), device="cpu"))
        return cache[name]
    return get


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bf16 as the ``ml_dtypes`` bfloat16 that JAX
    takes."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def parity_params():
    """name -> (reference config, port config, reference params, the port's
    copy of them), f32 compute, drawn once: the port's seed-0 draw as numpy
    arrays, given to the reference as they are and carried into the port
    by ``convert.py`` (the reference's own draw takes seconds per arch on
    the CPU; both layouts are one dict, so the reference's forward takes
    the port's draw)."""
    cache = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            kw = {"compute_dtype": "float32", **kw}
            jcfg = _cfg(name, jregistry, jreduced, **kw)
            tcfg = _cfg(name, tregistry, treduced, **kw)
            host = tree.map(_numpy, tapi.init_params(
                tcfg, torch.Generator().manual_seed(0), device="cpu"))
            cache[key] = (jcfg, tcfg,
                          jax.tree_util.tree_map(jnp.asarray, host),
                          CONVERT[tcfg.family](host, device="cpu"))
        return cache[key]
    return get


def _inputs(cfg, seed=1):
    """(reference kwargs, port kwargs) of one (B, S) batch: tokens, or
    embeddings for an embedding-input arch."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        e = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return ({"tokens": None, "embeds": jnp.asarray(e)},
                {"tokens": None, "embeds": torch.from_numpy(e)})
    t = rng.integers(0, cfg.vocab_size, (B, S))
    return ({"tokens": jnp.asarray(t, jnp.int32)},
            {"tokens": torch.from_numpy(t).to(torch.int32)})


def _finite(t):
    return bool(torch.isfinite(t.float()).all())


# ------------------------------------------------------- the smoke checks


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_smoke(arch, smoke_params):
    cfg, params = smoke_params(arch)
    _, kw = _inputs(cfg)
    logits = tapi.forward(cfg, params, kw["tokens"],
                          embeds=kw.get("embeds")).logits
    assert logits.shape == (B, S, cfg.vocab_size)
    assert _finite(logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch, smoke_params):
    cfg, params = smoke_params(arch)
    opt = toptim.make_optimizer(cfg.optimizer)
    params = tree.map(torch.clone, params)   # the step writes in place
    before = tree.map(torch.clone, params)
    state = tsteps.TrainState(params, opt.init(params),
                              torch.zeros((), dtype=torch.int32))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S))).to(torch.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = torch.from_numpy(np.random.default_rng(2)
                                           .standard_normal((B, S, cfg.d_model))
                                           .astype(np.float32))
    state2, metrics = tsteps.make_train_step(cfg, optimizer=opt)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2.step) == 1
    # params actually moved
    assert any(not torch.equal(a.float(), b.float())
               for a, b in zip(tree.leaves(before),
                               tree.leaves(state2.params))
               if a.is_floating_point())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_smoke(arch, smoke_params):
    cfg, params = smoke_params(arch)
    cache = tapi.init_cache(cfg, B, 32, device="cpu")
    if cfg.input_mode == "embeddings":
        emb = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (B, cfg.d_model)).astype(np.float32))
        logits, cache = tapi.decode_step(cfg, params, None, cache, embed=emb)
    else:
        logits, cache = tapi.decode_step(
            cfg, params, torch.tensor([1, 2], dtype=torch.int32), cache)
    assert logits.shape == (B, cfg.vocab_size)
    assert _finite(logits)


def test_all_archs_have_configs():
    """The 10 assigned architectures are all registered with exact dims,
    and each equals the reference's config field by field."""
    expect = {
        "kimi-k2-1t-a32b": (61, 7168, 64, 8, 2048, 163840),
        "mixtral-8x7b": (32, 4096, 32, 8, 14336, 32000),
        "smollm-135m": (30, 576, 9, 3, 1536, 49152),
        "qwen3-0.6b": (28, 1024, 16, 8, 3072, 151936),
        "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
        "llama3-405b": (126, 16384, 128, 8, 53248, 128256),
        "rwkv6-1.6b": (24, 2048, None, None, 7168, 65536),
        "musicgen-large": (48, 2048, 32, 32, 8192, 2048),
        "llava-next-34b": (60, 7168, 56, 8, 20480, 64000),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
    }
    assert sorted(expect) == tregistry.names() == ARCHS
    for name, (L, d, H, KV, ff, V) in expect.items():
        c = tregistry.get(name)
        assert c.n_layers == L and c.d_model == d and c.d_ff == ff \
            and c.vocab_size == V, name
        if H is not None:
            assert c.n_heads == H and c.n_kv_heads == KV, name
        assert dataclasses.asdict(c) == dataclasses.asdict(
            jregistry.get(name)), name


# ------------------------------------------------ parity with the reference


def _router_margin(cfg, params, kw, monkeypatch):
    """The least gap, over every MoE layer and token of the port's forward,
    between a token's k-th and (k+1)-th router probability."""
    m = cfg.moe
    gaps = []
    real = ttfm._local_route

    def route(h, router_w, *a):
        p = torch.sort(torch.softmax(h.float() @ router_w.float(), dim=-1),
                       dim=-1).values
        gaps.append(float((p[:, -m.top_k] - p[:, -m.top_k - 1]).min()))
        return real(h, router_w, *a)
    with monkeypatch.context() as mp:
        mp.setattr(ttfm, "_local_route", route)
        ttfm.forward(cfg, params, kw["tokens"])
    return min(gaps)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, parity_params, monkeypatch):
    jcfg, tcfg, jp, tp = parity_params(arch)
    jkw, tkw = _inputs(tcfg, seed=5)
    if tcfg.moe is not None:
        assert _router_margin(tcfg, tp, tkw, monkeypatch) > 1e-5
    want = jax.jit(lambda p, t, e: japi.forward(
        jcfg, p, t, embeds=e).logits)(jp, jkw["tokens"], jkw.get("embeds"))
    with torch.no_grad():
        got = tapi.forward(tcfg, tp, tkw["tokens"],
                           embeds=tkw.get("embeds")).logits
    assert got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(tcfg))


# Reduced widths that keep the embedding-input models' structure: musicgen's
# MHA (a KV head per query head) and llava's group of 7 query heads per KV
# head; both keep their untied head, remat and parameter dtype (llava bf16).
EMBED_STRUCTURE = {"musicgen-large": dict(n_kv_heads=4),
                   "llava-next-34b": dict(n_heads=14, n_kv_heads=2)}


def _train_batch(cfg, rng):
    """(reference batch, port batch) of one train step: seeded tokens as
    labels, and seeded f32 ``embeds`` in the tokens' place for an
    embedding-input arch."""
    t = rng.integers(0, cfg.vocab_size, (B, S))
    jb = {"tokens": jnp.asarray(t, jnp.int32),
          "labels": jnp.asarray(t, jnp.int32)}
    tt = torch.from_numpy(t).to(torch.int32)
    tb = {"tokens": tt, "labels": tt}
    if cfg.input_mode == "embeddings":
        e = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        jb["embeds"], tb["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def _train_state(jcfg, jp):
    js = jsteps.TrainState(jp, joptim.make_optimizer(jcfg.optimizer).init(jp),
                           jnp.zeros((), jnp.int32))
    host = jax.device_get(js)
    return js, convert.train_state_from_numpy(
        (host.params, host.opt_state, host.step), device="cpu")


@pytest.mark.parametrize("arch", ["command-r-plus-104b", "llama3-405b",
                                  "musicgen-large", "llava-next-34b"])
def test_train_steps_match_reference(arch, parity_params):
    """Two train steps (the arch's own optimizer: AdamW for command-r,
    musicgen and llava, Adafactor for llama3) from the reference's train
    state over the shared parameters: both losses, the second after one
    update of the parameters (bf16 for command-r, llama3 and llava).  The
    embedding-input archs train on shared seeded ``embeds`` at their own
    remat, at widths that keep their head structure (``EMBED_STRUCTURE``)."""
    jcfg, tcfg, jp, _ = parity_params(arch, **EMBED_STRUCTURE.get(arch, {}))
    js, ts = _train_state(jcfg, jp)
    jstep = jax.jit(jsteps.make_train_step(jcfg))
    tstep = tsteps.make_train_step(tcfg)
    rng = np.random.default_rng(6)
    for _ in range(2):
        jb, tb = _train_batch(tcfg, rng)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    assert int(ts.step) == int(js.step) == 2


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_embeds_loss_and_grads_match_jax_grad(arch, parity_params):
    """The embedding-input path's loss and every parameter's gradient
    against ``jax.value_and_grad`` of the reference's, at the model's own
    remat (musicgen save_dots, llava full) and widths that keep its head
    structure.  The token table ``embed`` is unused (``embeds`` take its
    place and the head is ``lm_head``): its gradient is zero in both
    packages, one AdamW step from the same state gives it the same value
    (weight decay alone) in both, and its moments stay zero."""
    jcfg, tcfg, jp, _ = parity_params(arch, **EMBED_STRUCTURE[arch])
    assert tcfg.remat == jcfg.remat != "none"
    assert not tcfg.tie_embeddings and "lm_head" in jp
    jb, tb = _train_batch(tcfg, np.random.default_rng(8))
    (jl, _), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    js, ts = _train_state(jcfg, jp)
    # the train step's own gradient function (unused leaves get zeros)
    tl, _, tg = tsteps._grad_fn(tcfg, None)(ts.params, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    ref = jax.tree_util.tree_leaves_with_path(jg)
    got = tree.leaves_with_paths(tg)
    assert len(ref) == len(got)
    for (jpath, want), (path, g) in zip(ref, got):
        name = tree.path_str(path)
        assert name == "/".join(str(getattr(k, "key", k)) for k in jpath)
        np.testing.assert_allclose(_np32(g), _np32(want), err_msg=name,
                                   **GRAD_TOL)
    assert tg["embed"].shape == ts.params["embed"].shape
    assert not np.any(_np32(tg["embed"]))
    assert not np.any(_np32(jg["embed"]))
    # one AdamW step (the train step's clip and in-place update) on it
    js, _ = jax.jit(jsteps.make_train_step(jcfg))(js, jb)
    ts, _ = tsteps.make_train_step(tcfg)(ts, tb)
    before = _np32(jp["embed"])
    moved = _np32(ts.params["embed"])
    np.testing.assert_array_equal(moved, _np32(js.params["embed"]))
    # f32: the decay moves it; bf16: lr·wd·|p| is under half a bf16 step
    # of |p|, so it rounds back to its value in both packages
    assert np.any(moved != before) == (tcfg.param_dtype == "float32")
    for k in ("m", "v"):
        assert not np.any(_np32(ts.opt_state[k]["embed"]))
        assert not np.any(_np32(js.opt_state[k]["embed"]))
