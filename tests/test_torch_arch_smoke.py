"""The port's mirror of tests/test_arch_smoke.py over every name of the
reference's registry: each arch, reduced to at most 2 layers, runs one
forward, one train step (its own optimizer) and one decode step on the CPU
with the reference's shape, finiteness, ``step == 1`` and "params moved"
checks; its config equals the reference's field by field; its forward
logits hold the reference's on the same parameters (the reference's,
converted); and the two dense giants, ``command-r-plus-104b`` and
``llama3-405b``, take two train steps from the reference's converted state
with losses that hold the reference's.

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

    def get(name):
        if name not in cache:
            jcfg = _cfg(name, jregistry, jreduced, compute_dtype="float32")
            tcfg = _cfg(name, tregistry, treduced, compute_dtype="float32")
            host = tree.map(_numpy, tapi.init_params(
                tcfg, torch.Generator().manual_seed(0), device="cpu"))
            cache[name] = (jcfg, tcfg,
                           jax.tree_util.tree_map(jnp.asarray, host),
                           CONVERT[tcfg.family](host, device="cpu"))
        return cache[name]
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


@pytest.mark.parametrize("arch", ["command-r-plus-104b", "llama3-405b"])
def test_train_steps_match_reference(arch, parity_params):
    """Two train steps (the arch's own optimizer: AdamW for command-r,
    Adafactor for llama3) from the reference's train state over the shared
    parameters: both losses, the second after one update of the bf16
    parameters."""
    jcfg, tcfg, jp, _ = parity_params(arch)
    js = jsteps.TrainState(jp, joptim.make_optimizer(jcfg.optimizer).init(jp),
                           jnp.zeros((), jnp.int32))
    host = jax.device_get(js)
    ts = convert.train_state_from_numpy((host.params, host.opt_state,
                                         host.step), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg))
    tstep = tsteps.make_train_step(tcfg)
    rng = np.random.default_rng(6)
    for _ in range(2):
        t = rng.integers(0, tcfg.vocab_size, (B, S))
        js, jm = jstep(js, {"tokens": jnp.asarray(t, jnp.int32),
                            "labels": jnp.asarray(t, jnp.int32)})
        tt = torch.from_numpy(t).to(torch.int32)
        ts, tm = tstep(ts, {"tokens": tt, "labels": tt})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    assert int(ts.step) == int(js.step) == 2
