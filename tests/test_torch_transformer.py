"""The port's dense transformer held against the reference on the same
parameters (the reference's, converted with ``transformer_params_from_numpy``)
and the same tokens.  Mirrors the dense cases of tests/test_transformer.py
and tests/test_w8a8.py (without the sharding case).

Tolerances.  The integer W8A8 path is exact, and the activation quantizer
and the FFN rescale are bit-exact on equal inputs (checked below).  The
float path around them (RMS norm, RoPE, softmax, silu, the f32 matmuls)
sums in other orders on the two frameworks' CPU kernels, so f32 logits
differ in the last bits; an activation that lands within an ulp of a
rounding boundary of ``_quantize_act`` can then move one int8 step.  The
logits are therefore held to 2e-4 absolute and relative (f32 path; 2e-3
with W8A8, one int8 step of one activation), and the greedy tokens and
token streams exactly.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.policy_map import PolicyMap as JPolicyMap
from repro.models import api as japi
from repro.models import transformer as jtfm
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import reduced as jreduced
from repro_torch.configs import registry as tregistry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.policy_map import PolicyMap as TPolicyMap
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.config import reduced as treduced

jax.config.update("jax_platform_name", "cpu")

F32_TOL = dict(rtol=2e-4, atol=2e-4)
W8A8_TOL = dict(rtol=2e-3, atol=2e-3)


def small(**kw):
    """The same small dense config on both sides (f32 compute, as the
    reference's consistency tests)."""
    base = dict(name="t", family="transformer", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128, head_dim=8,
                compute_dtype="float32")
    base.update(kw)
    return JArchConfig(**base), TArchConfig(**base)


def smollm(**kw):
    """reduced(smollm-135m) on both sides, W8A8 FFN and f32 compute
    unless overridden."""
    kw = {"quant": "w8a8_ffn", "compute_dtype": "float32", **kw}
    return (dataclasses.replace(jreduced(jregistry.get("smollm-135m")), **kw),
            dataclasses.replace(treduced(tregistry.get("smollm-135m")), **kw))


def params_both(jcfg, seed=0):
    p = japi.init_params(jcfg, jax.random.key(seed))
    return p, transformer_params_from_numpy(jax.device_get(p), device="cpu")


def tokens(cfg, shape, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks).to(
        torch.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


CASES = {"plain": {}, "qknorm": {"qk_norm": True}, "bias": {"use_bias": True},
         "swa": {"swa_window": 8}, "tied": {"tie_embeddings": True},
         "w8a8": {"quant": "w8a8_ffn"}}


@pytest.mark.parametrize("case", list(CASES))
def test_dense_forward_matches_reference(case):
    jcfg, tcfg = small(**CASES[case])
    jp, tp = params_both(jcfg)
    jt, tt = tokens(jcfg, (2, 16))
    want = jtfm.forward(jcfg, jp, jt).logits
    got = ttfm.forward(tcfg, tp, tt).logits
    assert got.shape == (2, 16, jcfg.vocab_size)
    _close(got, want, W8A8_TOL if case == "w8a8" else F32_TOL)


def test_init_params_layout_matches_reference():
    jcfg, tcfg = smollm()
    jp = jax.device_get(japi.init_params(jcfg, jax.random.key(0)))
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")

    def layout(tree, to_np):
        return {k: layout(v, to_np) if isinstance(v, dict)
                else (tuple(v.shape), to_np(v)) for k, v in tree.items()}
    assert layout(tp, lambda t: str(t.dtype).replace("torch.", "")) == \
        layout(jp, lambda a: str(a.dtype))


def test_qdot_matches_reference_under_policy_maps():
    """``_qdot`` on equal inputs: the activation quantizer, the integer
    accumulator and the rescale are bit-exact, under no map and under an
    ``ffn.*`` rule for every policy."""
    jcfg, tcfg = smollm()
    jp, tp = params_both(jcfg)
    jbp = {k: v[0] for k, v in jp["dense_blocks"].items()}
    tbp = {k: v[0] for k, v in tp["dense_blocks"].items()}
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(
        np.float32)
    for pol in (None, "none", "abft", "dmr", "tmr", "ckpt"):
        jc, tc = jcfg, tcfg
        if pol is not None:
            doc = {"rules": [{"pattern": "ffn.*", "policy": pol}]}
            jc = dataclasses.replace(jcfg, policy_map=JPolicyMap.from_doc(doc))
            tc = dataclasses.replace(tcfg, policy_map=TPolicyMap.from_doc(doc))
        for name in ("wg", "wi"):
            want = jtfm._qdot(jc, jnp.asarray(x), jbp, name)
            got = ttfm._qdot(tc, torch.from_numpy(x), tbp, name)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["plain", "swa", "w8a8"])
def test_decode_matches_forward_and_reference(case):
    """Teacher-forced decode step by step reproduces forward() inside the
    port (the reference's 3e-2), and the reference's decode logits."""
    jcfg, tcfg = small(**CASES[case])
    jp, tp = params_both(jcfg)
    B, S = 2, 12
    jt, tt = tokens(jcfg, (B, S))
    full = ttfm.forward(tcfg, tp, tt).logits
    jcache = jtfm.init_cache(jcfg, B, max_len=S)
    tcache = ttfm.init_cache(tcfg, B, max_len=S, device="cpu")
    tol = W8A8_TOL if case == "w8a8" else F32_TOL
    j_step = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    for t in range(S):
        want, jcache = j_step(jp, jt[:, t], jcache)
        got, tcache = ttfm.decode_step(tcfg, tp, tt[:, t], tcache)
        _close(got, want, tol)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=3e-2, atol=3e-2)
    np.testing.assert_array_equal(tcache.length.numpy(),
                                  np.asarray(jcache.length))
    _close(tcache.k, jcache.k, tol)


def test_prefill_then_decode_matches_reference():
    jcfg, tcfg = smollm()
    jp, tp = params_both(jcfg)
    S = 10
    jt, tt = tokens(jcfg, (2, S + 1))
    j_lp, j_cache = jtfm.prefill(jcfg, jp, jt[:, :S], max_len=S + 4)
    t_lp, t_cache = ttfm.prefill(tcfg, tp, tt[:, :S], max_len=S + 4)
    _close(t_lp, j_lp, W8A8_TOL)
    _close(t_cache.k, j_cache.k, W8A8_TOL)
    _close(t_cache.v, j_cache.v, W8A8_TOL)
    j_ld, _ = jtfm.decode_step(jcfg, jp, jt[:, S], j_cache)
    t_ld, _ = ttfm.decode_step(tcfg, tp, tt[:, S], t_cache)
    _close(t_ld, j_ld, W8A8_TOL)


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


def test_greedy_tokens_match_reference():
    """The slice on reduced(smollm-135m), W8A8, f32: equal greedy streams
    from the reference's params."""
    jcfg, tcfg = smollm()
    jp, tp = params_both(jcfg)
    for prompt in ([5, 9, 2, 7], [3, 1, 4, 1, 5, 9, 2, 6]):
        assert _greedy_t(tcfg, tp, prompt, 12) == \
            _greedy_j(jcfg, jp, prompt, 12)


def test_bf16_prefill_and_decode_match_forward():
    """In bf16 compute, inside the port: prefill's logits are forward's
    (one code path), and the decode step after it agrees with forward at
    that position to the reference's bf16 tolerance."""
    _, tcfg = smollm(compute_dtype="bfloat16")
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    _, tt = tokens(tcfg, (2, 11))
    full = tapi.forward(tcfg, tp, tt).logits
    lp, cache = tapi.prefill(tcfg, tp, tt[:, :10], max_len=16)
    assert lp.dtype == torch.bfloat16 and cache.k.dtype == torch.bfloat16
    assert torch.equal(lp, full[:, :10])
    ld, cache = tapi.decode_step(tcfg, tp, tt[:, 10], cache)
    np.testing.assert_allclose(ld.float().numpy(), full[:, 10].float().numpy(),
                               rtol=3e-2, atol=3e-2)
    assert cache.length.tolist() == [11, 11]


def test_swa_ring_buffer_decode_long():
    """Decoding past the window: the ring buffer matches forward() with
    SWA inside the port."""
    _, tcfg = small(swa_window=8)
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    _, tt = tokens(tcfg, (1, 20))
    full = tapi.forward(tcfg, tp, tt).logits
    cache = tapi.init_cache(tcfg, 1, max_len=20, device="cpu")
    assert cache.k.shape[2] == 8
    for t in range(20):
        logits, cache = tapi.decode_step(tcfg, tp, tt[:, t], cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **F32_TOL)


def test_unported_paths_name_their_roadmap_item():
    # every reference arch resolves, the two dense giants included; item
    # 17's last parts came (the pipeline, the dry-run, the FT loop's mesh:
    # test_torch_pipeline.py, test_torch_dryrun.py,
    # test_torch_ft_loop_mesh.py)
    for name in ("command-r-plus-104b", "llama3-405b"):
        assert tregistry.get(name).fsdp_params
    with pytest.raises(KeyError):
        tregistry.get("no-such-arch")
    assert tregistry.names() == jregistry.names() == [
        "command-r-plus-104b", "kimi-k2-1t-a32b", "llama3-405b",
        "llava-next-34b", "mixtral-8x7b", "musicgen-large", "qwen3-0.6b",
        "recurrentgemma-2b", "rwkv6-1.6b", "smollm-135m"]
    assert tregistry.get("mixtral-8x7b").moe.n_experts == 8
    assert tregistry.get("kimi-k2-1t-a32b").moe.n_shared_experts == 1
    _, tcfg = small()
    moe = dataclasses.replace(tcfg, moe=TMoEConfig(4, 2, 16))
    mp = tapi.init_params(moe, torch.Generator().manual_seed(0),
                          device="cpu")
    assert "moe_blocks" in mp and "dense_blocks" not in mp
    _, mt = tokens(moe, (1, 4))
    import inspect
    from repro_torch.launch import dryrun, op_analysis  # noqa: F401
    from repro_torch.parallel import pipeline  # noqa: F401
    from repro_torch.runtime import ft_loop
    from repro_torch.train import steps as tsteps
    assert "mesh" in inspect.signature(ft_loop.run).parameters
    assert callable(tsteps.input_specs) and \
        callable(tsteps.abstract_train_state)
    with pytest.raises(ValueError, match="unknown family"):
        tapi.init_params(dataclasses.replace(tcfg, family="cnn"),
                         torch.Generator(), device="cpu")
    # the int8 KV cache came in: its cache holds int8 pages and f32 scales
    qkv = dataclasses.replace(tcfg, quant_kv=True)
    cache = tapi.init_cache(qkv, 2, max_len=8, device="cpu")
    assert cache.k.dtype == torch.int8 and cache.k_s.dtype == torch.float32
    assert cache.k_s.shape == cache.k.shape[:-1]
    # training came in: loss_fn, once refused, now gives a finite loss
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    _, tt = tokens(tcfg, (2, 8))
    loss, aux = tapi.loss_fn(tcfg, tp, {"tokens": tt, "labels": tt})
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert set(aux) == {"ce", "aux", "z"}
