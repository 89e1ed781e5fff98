"""The port's attention backward held against the reference.

Mirrors the gradient cases of tests/test_flashattn.py: the same numpy
inputs go through the reference's Pallas backward (``flash_attention_bwd``
and ``jax.grad`` of ``flash_attn_diff``, in interpret mode) and through the
port's ``flash_attention_bwd`` wrapper and ``flash_attn_diff``, which run
the plain version ``ref.flash_bwd_plain`` on CPU tensors.

Tolerances.  Both sides rebuild the probabilities from the same lse and
sum the same f32 products in other orders, so gradients are held to the
reference's own gradient tolerance, 2e-4 (rtol and atol).  bf16 gradients
are held to one bf16 step of the reference's value plus that f32
allowance: both round f32 results that differ in their last bits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn.kernel import flash_attention_bwd as j_bwd
from repro.kernels.flashattn.kernel import flash_attention_fwd_lse as j_lse
from repro.kernels.flashattn.ops import flash_attn_diff as j_diff
from repro.kernels.flashattn.ops import flash_attn_model as j_model
from repro.kernels.flashattn.ref import attention_ref as j_attention_ref
from repro_torch.kernels import flash_attn_diff, flash_attn_model
from repro_torch.kernels.flashattn import kernel as K
from repro_torch.kernels.flashattn import ops as O
from repro_torch.kernels.flashattn import ref as R

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-4, atol=2e-4)

BWD_CASES = [
    # B, H, KV, S, hd, window (the reference's BWD_CASES)
    (1, 2, 2, 128, 32, None),
    (1, 4, 2, 128, 16, None),          # GQA 2:1 — head-group accumulation
    (1, 4, 1, 96, 16, None),           # MQA, ragged S
    (1, 2, 2, 192, 32, 64),            # sliding window
]


def inputs(seed, B, H, KV, S, hd, layout="bhsd"):
    """Seeded normal q, k, v and the output gradient, numpy f32."""
    rng = np.random.default_rng(seed)
    shapes = [(B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)]
    if layout == "bshd":
        shapes = [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                  (B, S, H, hd)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(np.array(a, copy=True)).to(dtype) for a in arrs]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bf16_close(got, want):
    w = _np(want)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                   - 7)
    err = np.abs(_np(got) - w)
    assert (err <= step + TOL["atol"] + TOL["rtol"] * np.abs(w)).all(), \
        float(err.max())


def reference_bwd(arrs, causal, window, dtype=jnp.float32):
    """The reference's out, lse and (dq, dk, dv), Pallas in interpret
    mode with its 64 × 64 tiles."""
    q, k, v, do = [jnp.asarray(a, dtype) for a in arrs]
    out, lse = j_lse(q, k, v, causal=causal, window=window, block_q=64,
                     block_k=64, interpret=True)
    grads = j_bwd(q, k, v, out, lse, do, causal=causal, window=window,
                  block_q=64, block_k=64, interpret=True)
    return out, lse, grads


@pytest.mark.parametrize("B,H,KV,S,hd,window", BWD_CASES)
def test_bwd_plain_matches_pallas_bwd(B, H, KV, S, hd, window):
    """Row 10's plain version against the reference's Pallas backward on the
    same q, k, v, out, lse and dO."""
    arrs = inputs(7, B, H, KV, S, hd)
    out, lse, want = reference_bwd(arrs, True, window)
    q, k, v, do = _t(arrs)
    got = K.flash_attention_bwd(q, k, v, *_t([out, lse]), do, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"d{name}", **TOL)
    assert [g.dtype for g in got] == [torch.float32] * 3


@pytest.mark.parametrize("window", [None, 24])
def test_bwd_plain_noncausal(window):
    arrs = inputs(8, 1, 4, 2, 80, 32)
    out, lse, want = reference_bwd(arrs, False, window)
    q, k, v, do = _t(arrs)
    got = K.flash_attention_bwd(q, k, v, *_t([out, lse]), do, causal=False,
                                window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_bwd_plain_bf16():
    """bf16 inputs: gradients come back in bf16, within one bf16 step."""
    arrs = inputs(9, 1, 4, 2, 100, 16)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
          for a in arrs]
    out, lse, want = reference_bwd(bf, True, None, jnp.bfloat16)
    q, k, v, do = _t(bf, torch.bfloat16)
    out_t = _t([np.asarray(out.astype(jnp.float32))], torch.bfloat16)[0]
    got = K.flash_attention_bwd(q, k, v, out_t, _t([lse])[0], do)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _bf16_close(g, w)


def test_bwd_block_k_independence():
    """The plain version's K tiling changes no gradient beyond rounding."""
    arrs = inputs(10, 1, 2, 1, 70, 16)
    q, k, v, do = _t(arrs)
    out, lse = K.flash_attention_fwd_lse(q, k, v)
    a = R.flash_bwd_plain(q, k, v, out, lse, do, block_k=16)
    b = R.flash_bwd_plain(q, k, v, out, lse, do, block_k=70)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("B,H,KV,S,hd,window", BWD_CASES)
def test_flash_attn_diff_grads_match_jax(B, H, KV, S, hd, window):
    """``flash_attn_diff`` (autograd Function) against ``jax.grad`` of the
    reference's ``flash_attn_diff`` and of its oracle."""
    arrs = inputs(11, B, H, KV, S, hd)
    dout = arrs[3]

    def f_flash(q, k, v):
        return jnp.sum(j_diff(q, k, v, True, window, 64, 64, True) * dout)

    def f_ref(q, k, v):
        return jnp.sum(j_attention_ref(q, k, v, causal=True, window=window)
                       * dout)

    jq = [jnp.asarray(a) for a in arrs[:3]]
    want = jax.grad(f_flash, argnums=(0, 1, 2))(*jq)
    oracle = jax.grad(f_ref, argnums=(0, 1, 2))(*jq)
    q, k, v = [t.requires_grad_() for t in _t(arrs[:3])]
    out = flash_attn_diff(q, k, v, True, window)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dout))
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
        np.testing.assert_allclose(_np(g), _np(o), **TOL)


@pytest.mark.parametrize("S,KV", [(5, 2), (37, 1), (64, 2)])
def test_flash_attn_model_grads_match_jax(S, KV):
    """The model layout, ragged S and GQA/MQA included."""
    arrs = inputs(12, 2, 4, KV, S, 16, layout="bshd")
    dout = arrs[3]
    want = jax.grad(lambda q, k, v: jnp.sum(
        j_model(q, k, v, interpret=True) * dout), argnums=(0, 1, 2))(
            *[jnp.asarray(a) for a in arrs[:3]])
    q, k, v = [t.requires_grad_() for t in _t(arrs[:3])]
    got = torch.autograd.grad(flash_attn_model(q, k, v), (q, k, v),
                              torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_no_grad_runs_the_forward_alone(monkeypatch):
    """Serving launches what it launched before training came in: under
    ``torch.no_grad`` one ``fwd_lse`` per call and no backward; with a
    gradient, one of each."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = K.flash_attention_fwd_lse, K.flash_attention_bwd

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(O.kernel, "flash_attention_fwd_lse", spy_fwd)
    monkeypatch.setattr(O.kernel, "flash_attention_bwd", spy_bwd)
    q, k, v, _ = _t(inputs(13, 1, 4, 2, 24, 16, layout="bshd"))
    with torch.no_grad():
        flash_attn_model(q.requires_grad_(), k, v)
    assert calls == {"fwd": 1, "bwd": 0}
    flash_attn_model(q.detach(), k, v)
    assert calls == {"fwd": 2, "bwd": 0}
    flash_attn_model(q, k, v).sum().backward()
    assert calls == {"fwd": 3, "bwd": 1}
    assert q.grad is not None


def test_bwd_wrapper_checks():
    q, k, v, do = _t(inputs(14, 1, 4, 2, 16, 16))
    out, lse = K.flash_attention_fwd_lse(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        K.flash_attention_bwd(q, k, v, out, lse[..., :8], do)
    with pytest.raises(ValueError, match="do"):
        K.flash_attention_bwd(q, k, v, out, lse, do.double())
    with pytest.raises(ValueError, match="head dim 48"):
        K.flash_attention_bwd(*_t(inputs(14, 1, 2, 2, 8, 48)[:3]), out, lse,
                              do)
    with pytest.raises(ValueError, match="several devices"):
        K.flash_attention_bwd(q, k, v, out, lse, do.to("meta"))
    K.reset_launches()
    K.flash_attention_bwd(q, k, v, out, lse, do)
    assert K.flash_attention_bwd.launches == 0       # CPU: the plain version
    assert K.flash_attention_bwd in K.KERNELS

