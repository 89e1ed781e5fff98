"""The port's flash-attention forward kernels held against the reference.

Mirrors the forward cases of tests/test_flashattn.py: the same numpy
inputs go through the reference's Pallas kernels in interpret mode (or its
jnp oracle ``attention_ref`` where the head dim is 64) and through the
port's wrappers, which run their plain versions on CPU tensors.

Tolerances.  Both sides compute in f32 with an online softmax, in other
tile orders and on other CPU kernels: outputs, check columns and lse are
held to 1e-5 (rtol and atol).  bf16 outputs are held to one bf16 step of
the reference's value: both round the same f32 result, which differs in
its last bits.  ``csum`` is held exactly: against the reference's
``output_row_checksums`` of the very array the port emitted, and against
the port's own recomputation.  Within the port, the three kernels' ``out``
is compared bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.kernels.flashattn.kernel import flash_attention as j_flash
from repro.kernels.flashattn.kernel import (
    flash_attention_checked as j_checked)
from repro.kernels.flashattn.kernel import (
    flash_attention_fwd_lse as j_fwd_lse)
from repro.kernels.flashattn.ops import flash_attn as j_flash_attn
from repro.kernels.flashattn.ops import flash_attn_model as j_model
from repro.kernels.flashattn.ref import attention_ref as j_attention_ref
from repro_torch.core import abft as tabft
from repro_torch.core.fault_injection import flip_bit_at_index
from repro_torch.kernels import flash_attn, flash_attn_model
from repro_torch.kernels.flashattn import kernel as K
from repro_torch.kernels.flashattn import ref as R

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)


def qkv(seed, B, H, KV, S, hd, dtype=np.float32, layout="bhsd"):
    """Seeded normal q, k, v as numpy arrays ((B,H,S,hd) or, for the model
    layout, (B,S,H,hd))."""
    rng = np.random.default_rng(seed)
    shapes = [(B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)]
    if layout == "bshd":
        shapes = [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _j(arrs, dtype=None):
    return [jnp.asarray(a, dtype) for a in arrs]


def _t(arrs, dtype=None):
    return [torch.from_numpy(np.array(a, copy=True)).to(dtype or
            torch.float32) for a in arrs]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


CASES = [
    # B, H, KV, S, hd, window
    (1, 2, 2, 128, 32, None),          # one block exactly
    (2, 4, 2, 256, 64, None),          # GQA 2:1, multi-block
    (1, 4, 1, 96, 16, None),           # MQA, ragged S < block
    (1, 2, 2, 200, 32, None),          # ragged S, multi-block
    (1, 4, 2, 256, 32, 64),            # sliding window
    (1, 2, 1, 160, 32, 32),            # window smaller than block
]


@pytest.mark.parametrize("B,H,KV,S,hd,window", CASES)
def test_flash_matches_reference(B, H, KV, S, hd, window):
    """The plain version against the Pallas kernel (interpret) for hd <= 32
    and against the reference's oracle at hd = 64."""
    arrs = qkv(0, B, H, KV, S, hd)
    got = K.flash_attention(*_t(arrs), causal=True, window=window)
    if hd <= 32:
        want = j_flash(*_j(arrs), causal=True, window=window, block_q=64,
                       block_k=64, interpret=True)
    else:
        want = j_attention_ref(*_j(arrs), causal=True, window=window)
    assert got.shape == (B, H, S, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("B,H,KV,S,hd,window", CASES)
def test_attention_ref_matches_reference(B, H, KV, S, hd, window):
    arrs = qkv(1, B, H, KV, S, hd)
    got = R.attention_ref(*_t(arrs), causal=True, window=window)
    want = j_attention_ref(*_j(arrs), causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _bf16_step(x):
    """One bf16 step (ulp) at the magnitude of each element of ``x``."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_flash_bf16_io():
    arrs = qkv(1, 1, 2, 2, 128, 32)
    got = K.flash_attention(*_t(arrs, torch.bfloat16))
    want = j_flash(*_j(arrs, jnp.bfloat16), interpret=True, block_q=64,
                   block_k=64)
    assert got.dtype == torch.bfloat16
    g, w = _np(got), _np(want)
    assert np.all(np.abs(g - w) <= _bf16_step(w)), np.abs(g - w).max()
    oracle = j_attention_ref(*_j(arrs, jnp.bfloat16))
    np.testing.assert_allclose(g, _np(oracle), rtol=2e-2, atol=2e-2)


def test_flash_noncausal():
    arrs = qkv(2, 1, 2, 2, 128, 32)
    got = K.flash_attention(*_t(arrs), causal=False)
    want = j_flash(*_j(arrs), causal=False, interpret=True, block_q=64,
                   block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_flash_noncausal_window():
    """A window without causality: keys from q - window to the end."""
    arrs = qkv(3, 1, 4, 2, 160, 16)
    got = K.flash_attention(*_t(arrs), causal=False, window=40)
    want = j_flash(*_j(arrs), causal=False, window=40, interpret=True,
                   block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_ops_layout_adapter():
    """(B,S,H,hd) wrapper agrees with the reference's adapter."""
    B, S, H, KV, hd = 2, 96, 4, 2, 16
    arrs = qkv(3, B, H, KV, S, hd, layout="bshd")
    got = flash_attn(*_t(arrs))
    want = j_flash_attn(*_j(arrs), interpret=True)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_block_shape_independence():
    """Different K tilings of the plain version agree (the kernel's tile is
    fixed at compile time; its order is ``block_k`` = 32's)."""
    arrs = _t(qkv(4, 1, 2, 2, 256, 32))
    a = K.flash_attention(*arrs)
    for bq, bk in ((64, 64), (128, 64), (64, 128), (16, 16)):
        b = K.flash_attention(*arrs, block_q=bq, block_k=bk)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def test_flash_fwd_lse_matches_plain_fwd():
    arrs = qkv(9, 1, 2, 2, 128, 32)
    o1 = K.flash_attention(*_t(arrs))
    o2, lse = K.flash_attention_fwd_lse(*_t(arrs))
    assert torch.equal(o1, o2)
    _, j_lse = j_fwd_lse(*_j(arrs), interpret=True, block_q=64, block_k=64)
    np.testing.assert_allclose(lse.numpy(), _np(j_lse), **TOL)
    # lse is the true logsumexp of the masked scores
    q, k, _ = _t(arrs)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(32)
    s = torch.where(torch.tril(torch.ones(128, 128, dtype=torch.bool)), s,
                    R.NEG_INF)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, dim=-1).numpy(), **TOL)


CHECKED_CASES = [
    # B, H, KV, S, hd, window
    (1, 2, 2, 128, 32, None),
    (1, 4, 2, 200, 16, None),          # GQA, ragged S
    (1, 2, 1, 160, 32, 32),            # MQA + sliding window
]


@pytest.mark.parametrize("B,H,KV,S,hd,window", CHECKED_CASES)
def test_checked_kernel_two_tier_outputs(B, H, KV, S, hd, window):
    """The checked kernel (a) emits the plain kernel's output bit for bit,
    (b) carries a float check column equal to rowsum_hd(out) up to
    roundoff and to the reference's within 1e-5, and (c) emits the exact
    mod-2^32 bit checksum, equal to the reference's recomputation on the
    same array."""
    arrs = qkv(11, B, H, KV, S, hd)
    plain = K.flash_attention(*_t(arrs), causal=True, window=window)
    out, check, csum = K.flash_attention_checked(*_t(arrs), causal=True,
                                                 window=window)
    assert out.shape == (B, H, S, hd)
    assert check.shape == csum.shape == (B, H, S)
    assert check.dtype == torch.float32 and csum.dtype == torch.int64
    assert torch.equal(out, plain)                               # (a)
    np.testing.assert_allclose(out.sum(dim=-1).numpy(), check.numpy(),
                               rtol=1e-4, atol=1e-4)             # (b)
    j_out, j_check, _ = j_checked(*_j(arrs), causal=True, window=window,
                                  block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(j_out), **TOL)
    np.testing.assert_allclose(check.numpy(), _np(j_check), **TOL)
    assert torch.equal(csum, tabft.output_row_checksums(out))    # (c)
    np.testing.assert_array_equal(
        csum.numpy(), np.asarray(jabft.output_row_checksums(
            jnp.asarray(out.numpy()))))


def test_checked_kernel_bf16_checksum_is_exact():
    arrs = qkv(12, 1, 2, 2, 128, 32)
    out, _, csum = K.flash_attention_checked(*_t(arrs, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    j_out = jnp.asarray(out.float().numpy(), jnp.bfloat16)   # exact
    np.testing.assert_array_equal(
        csum.numpy(), np.asarray(jabft.output_row_checksums(j_out)))
    assert torch.equal(csum, tabft.output_row_checksums(out))


def test_output_bit_checksum_detects_every_flip():
    """A lowest-mantissa flip is far below any float tolerance, yet the bit
    checksum flags the row — and only that row."""
    out, _, csum = K.flash_attention_checked(*_t(qkv(13, 1, 2, 2, 128, 32)))
    idx = np.ravel_multi_index((0, 1, 77, 5), out.shape)
    for bit in (0, 12, 23, 31):                  # mantissa → sign sweep
        bad = flip_bit_at_index(out, int(idx), bit)
        row_ok = tabft.output_row_checksums(bad) == csum
        assert not bool(row_ok[0, 1, 77]), f"bit {bit} escaped"
        assert int((~row_ok).sum()) == 1, f"bit {bit} flagged extra rows"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_output_row_checksums_match_reference(dtype):
    """Exact, including sums that wrap past 2^32 (f32 bit patterns near
    2^31, 64 per row)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    x[0] = -3.0e38                               # sign bit set: wraps
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(t.float().numpy(), getattr(jnp, dtype))
    np.testing.assert_array_equal(
        tabft.output_row_checksums(t).numpy(),
        np.asarray(jabft.output_row_checksums(j)))


@pytest.mark.parametrize("S", [5, 37, 100])
def test_flash_attn_model_ragged_small_S(S):
    """Model layouts shorter than one tile (short prefills) match the
    reference's ``flash_attn_model`` (its Pallas forward in interpret
    mode) and its oracle."""
    arrs = qkv(14, 1, 2, 2, S, 16, layout="bshd")
    got = flash_attn_model(*_t(arrs))
    want = j_model(*_j(arrs), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    oracle = jnp.swapaxes(j_attention_ref(
        *[jnp.swapaxes(a, 1, 2) for a in _j(arrs)]), 1, 2)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=2e-5, atol=2e-5)


def test_flash_attn_model_refuses_a_gradient():
    """Since training came in, an input that requires a gradient is no
    longer refused: the gradient flows through ``flash_attn_diff``'s
    backward and matches ``jax.grad`` of the reference's
    ``flash_attn_model`` (Pallas backward in interpret mode) within 2e-4,
    the reference's own gradient tolerance."""
    arrs = qkv(15, 1, 2, 2, 16, 16, layout="bshd")
    q, k, v = [t.requires_grad_() for t in _t(arrs)]
    out = flash_attn_model(q, k, v)
    dout = np.random.default_rng(16).standard_normal(out.shape).astype(
        np.float32)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dout))
    want = jax.grad(lambda q, k, v: jnp.sum(
        j_model(q, k, v, interpret=True) * dout), argnums=(0, 1, 2))(
            *_j(arrs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-4)
    assert flash_attn_model(q.detach(), k, v).shape == q.shape


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v = _t(qkv(16, 1, 4, 2, 8, 16))
    with pytest.raises(ValueError, match="head dim 48"):
        K.flash_attention(*_t(qkv(16, 1, 2, 2, 8, 48)))
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        K.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of KV"):
        K.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        K.flash_attention(q, k, v, window=-1)
    assert [kern.launches for kern in K.KERNELS] == [0, 0, 0, 0]  # CPU
