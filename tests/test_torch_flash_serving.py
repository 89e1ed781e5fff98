"""``attn_impl="flash"`` held against the reference: the transformer's
full-sequence passes (``forward``, ``prefill``) on the
``flash_attention_fwd_lse`` kernel's plain version, greedy decoding after
them, and the serving ``Engine``.

reduced(smollm-135m) with the W8A8 FFN and f32 compute, from the
reference's parameters; the reference runs its Pallas flash forward in
interpret mode.  Logits are held to 2e-4 (rtol and atol): the attention is
f32 on both sides with other tile orders, and the rest of the float path
sums in other orders on the two frameworks' CPU kernels (see
tests/test_torch_transformer.py).  Greedy tokens and token streams are
held exactly.
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
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import reduced as jreduced
from repro.runtime.serving import Engine as JEngine
from repro.runtime.serving import Request as JRequest
from repro_torch.configs import registry as tregistry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.config import reduced as treduced
from repro_torch.runtime.serving import Engine, Request

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-4, atol=2e-4)
FLASH = dict(quant="w8a8_ffn", compute_dtype="float32", attn_impl="flash")


@pytest.fixture(scope="module")
def flash_lm():
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")),
                               **FLASH)
    tcfg = dataclasses.replace(treduced(tregistry.get("smollm-135m")),
                               **FLASH)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = transformer_params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(cfg, shape, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks).to(
        torch.int32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_flash_forward_matches_reference(flash_lm):
    jcfg, jp, tcfg, tp = flash_lm
    jt, tt = _tokens(jcfg, (2, 40))
    want = japi.forward(jcfg, jp, jt).logits
    got = tapi.forward(tcfg, tp, tt).logits
    assert got.shape == (2, 40, jcfg.vocab_size)
    _close(got, want)


def test_flash_prefill_matches_reference(flash_lm):
    jcfg, jp, tcfg, tp = flash_lm
    S = 37
    jt, tt = _tokens(jcfg, (1, S), seed=2)
    j_lp, j_cache = japi.prefill(jcfg, jp, jt, max_len=48)
    t_lp, t_cache = tapi.prefill(tcfg, tp, tt, max_len=48)
    _close(t_lp, j_lp)
    _close(t_cache.k, j_cache.k)
    _close(t_cache.v, j_cache.v)
    assert t_cache.length.tolist() == [S]


def test_flash_and_chunked_agree_inside_the_port(flash_lm):
    """The two attention paths of the port, f32: within the tolerance."""
    _, _, tcfg, tp = flash_lm
    _, tt = _tokens(tcfg, (2, 70), seed=3)
    flash = tapi.forward(tcfg, tp, tt).logits
    chunked = tapi.forward(dataclasses.replace(tcfg, attn_impl="chunked"),
                           tp, tt).logits
    np.testing.assert_allclose(flash.numpy(), chunked.numpy(), **TOL)


def _greedy_j(cfg, params, prompt, n_new, max_len=64):
    prefill = jax.jit(lambda p, t: japi.prefill(cfg, p, t, max_len))
    step = jax.jit(lambda p, t, c: japi.decode_step(cfg, p, t, c))
    logits, cache = prefill(params, jnp.asarray([prompt], jnp.int32))
    out = [int(jnp.argmax(logits[0, len(prompt) - 1]))]
    for _ in range(n_new - 1):
        logits, cache = step(params, jnp.asarray([out[-1]], jnp.int32),
                             cache)
        out.append(int(jnp.argmax(logits[0])))
    return out


def _greedy_t(cfg, params, prompt, n_new, max_len=64):
    logits, cache = tapi.prefill(cfg, params, torch.tensor([prompt]),
                                 max_len)
    out = [int(torch.argmax(logits[0, len(prompt) - 1]))]
    for _ in range(n_new - 1):
        logits, cache = tapi.decode_step(cfg, params, torch.tensor([out[-1]]),
                                         cache)
        out.append(int(torch.argmax(logits[0])))
    return out


def test_flash_greedy_tokens_match_reference(flash_lm):
    jcfg, jp, tcfg, tp = flash_lm
    for prompt in ([5, 9, 2, 7], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]):
        assert _greedy_t(tcfg, tp, prompt, 10) == \
            _greedy_j(jcfg, jp, prompt, 10)


def test_flash_engine_streams_match_the_reference_engine(flash_lm):
    """The slice end to end: the port's Engine and the reference's Engine,
    both with ``attn_impl="flash"``, on the same parameters and requests,
    give the same token streams."""
    jcfg, jp, tcfg, tp = flash_lm
    prompts = [[5, 9, 2, 7], [3, 1], list(range(20, 39)), [7]]
    n_new = [6, 4, 5, 3]
    jeng = JEngine(jcfg, jp, capacity=2, max_len=64, prefill_pad=16)
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = Engine(tcfg, tp, capacity=2, max_len=64, prefill_pad=16)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert [list(r.output) for r in reqs] == [list(r.output) for r in jreqs]
    assert eng.stats.steps == jeng.stats.steps


@pytest.mark.parametrize("kw", [
    {"policy_map": {"rules": [{"pattern": "ffn.*", "policy": "abft"}]}},
    {"policy_map": {"rules": [{"pattern": "ffn.*", "policy": "tmr"}]}},
    {"backend": "ref"},
], ids=["ffn_abft", "ffn_tmr", "ref_backend"])
def test_flash_engine_maps_serve_identically(flash_lm, kw):
    _, _, tcfg, tp = flash_lm
    prompts, n_new = [[5, 9, 2, 7], list(range(40, 60))], [5, 4]

    def serve(**extra):
        eng = Engine(tcfg, tp, capacity=2, max_len=64, prefill_pad=16,
                     **extra)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, n_new))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [list(r.output) for r in reqs]
    assert serve(**kw) == serve()


def test_flash_sliding_window_forward_matches_reference():
    """A windowed config: the flash kernel's window (keys at most
    ``window`` positions back) on both sides."""
    base = dict(name="t", family="transformer", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                head_dim=16, compute_dtype="float32", swa_window=8,
                attn_impl="flash")
    jcfg, tcfg = JArchConfig(**base), TArchConfig(**base)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = transformer_params_from_numpy(jax.device_get(jp), device="cpu")
    jt, tt = _tokens(jcfg, (2, 30), seed=4)
    _close(tapi.forward(tcfg, tp, tt).logits,
           japi.forward(jcfg, jp, jt).logits)
