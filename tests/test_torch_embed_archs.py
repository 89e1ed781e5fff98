"""The embedding-input models, musicgen-large and llava-next-34b.

Their configs equal the reference's field for field (the dims of
tests/test_arch_smoke.py:87-106 among them); at ``reduced`` width, on the
reference's parameters, ``forward(embeds=)``, ``prefill(embeds=)`` and
``decode_step(embed=)`` hold the reference's logits within the tolerances
of test_torch_transformer.py (2e-4 on the f32 path, 2e-3 with the W8A8
FFN) and its greedy tokens exactly; the caller's embeddings come from
``data/pipeline.TokenStream``, bit-equal to the reference's stream.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as jdp
from repro.models import api as japi
from repro.models.config import SHAPES
from repro.models.config import reduced as jreduced
from repro_torch.configs import registry as tregistry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.data import pipeline as tdp
from repro_torch.models import api as tapi
from repro_torch.models.config import ShapeConfig
from repro_torch.models.config import reduced as treduced

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("musicgen-large", "llava-next-34b")
DIMS = {                       # tests/test_arch_smoke.py:97-98
    "musicgen-large": (48, 2048, 32, 32, 8192, 2048),
    "llava-next-34b": (60, 7168, 56, 8, 20480, 64000),
}
F32_TOL = dict(rtol=2e-4, atol=2e-4)
W8A8_TOL = dict(rtol=2e-3, atol=2e-3)
S, NEW, MAX_LEN = 12, 4, 24


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    cfg, jcfg = tregistry.get(arch), jregistry.get(arch)
    L, d, H, KV, ff, V = DIMS[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (L, d, H, KV, ff, V)
    assert cfg.input_mode == "embeddings"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert arch in tregistry.names()
    assert cfg.param_count() == jcfg.param_count()


def _pair(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jreduced(jregistry.get(arch)), **kw),
            dataclasses.replace(treduced(tregistry.get(arch)), **kw))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("quant", ["none", "w8a8_ffn"])
@pytest.mark.parametrize("arch", ARCHS)
def test_embeds_paths_match_the_reference(arch, quant):
    jcfg, cfg = _pair(arch, quant=quant)
    tol = W8A8_TOL if quant == "w8a8_ffn" else F32_TOL
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = transformer_params_from_numpy(jax.device_get(jp), device="cpu")
    if cfg.param_dtype == "bfloat16":
        assert tp["embed"].dtype == torch.bfloat16
    batch = tdp.TokenStream(cfg, ShapeConfig("e", S, 2, "prefill"),
                            seed=3).batch_at(0)
    emb = batch["embeds"]
    je, te = jnp.asarray(emb), torch.from_numpy(emb)

    _close(tapi.forward(cfg, tp, None, embeds=te).logits,
           japi.forward(jcfg, jp, None, embeds=je).logits, tol)

    jl, jc = japi.prefill(jcfg, jp, None, MAX_LEN, embeds=je)
    tl, tc = tapi.prefill(cfg, tp, None, MAX_LEN, embeds=te)
    _close(tl, jl, tol)
    assert torch.equal(torch.argmax(tl[:, -1], -1),
                       torch.from_numpy(np.array(jnp.argmax(jl[:, -1], -1))))
    step_embeds = np.random.default_rng(4).standard_normal(
        (NEW, 2, cfg.d_model)).astype(np.float32)
    for e in step_embeds:
        jl, jc = japi.decode_step(jcfg, jp, None, jc, embed=jnp.asarray(e))
        tl, tc = tapi.decode_step(cfg, tp, None, tc,
                                  embed=torch.from_numpy(e))
        _close(tl, jl, tol)
        assert np.isfinite(tl.float().numpy()).all()
        assert torch.equal(torch.argmax(tl, -1), torch.from_numpy(
            np.array(jnp.argmax(jl, -1))))


@pytest.mark.parametrize("arch", ARCHS)
def test_token_stream_embeds_bit_equal(arch):
    jcfg, cfg = jreduced(jregistry.get(arch)), treduced(tregistry.get(arch))
    shape = SHAPES["train_4k"]
    small = ShapeConfig("small", 32, 8, "train")
    for step in (0, 5):
        jb = jdp.TokenStream(jcfg, dataclasses.replace(shape, seq_len=32,
                                                       global_batch=8),
                             seed=0, n_hosts=1, host_id=0).batch_at(step)
        tb = tdp.TokenStream(cfg, small, seed=0).batch_at(step)
        assert tb["embeds"].shape == (8, 32, cfg.d_model)
        for k in ("tokens", "labels", "embeds"):
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))


def test_fwd_lse_at_llava_attention_shape():
    """Row 9 at llava-next-34b's attention shape, cut in heads: hd 128, a
    GQA group of 7 (14 query heads over 2 KV heads), S = 100 (not a
    multiple of 64); the port's plain version against the reference's
    Pallas kernel in interpret mode, within test_torch_flashattn.py's
    1e-5."""
    from repro.kernels.flashattn.kernel import (
        flash_attention_fwd_lse as j_fwd_lse)
    from repro_torch.kernels.flashattn import kernel as K
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 14, 100, 128), (1, 2, 100, 128), (1, 2, 100, 128))]
    out, lse = K.flash_attention_fwd_lse(*(torch.from_numpy(a)
                                           for a in arrs))
    j_out, j_lse = j_fwd_lse(*(jnp.asarray(a) for a in arrs),
                             interpret=True, block_q=64, block_k=64)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **tol)
