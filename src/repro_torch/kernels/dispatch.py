"""Built-in execution backends for the quantized matmul and conv, and
for attention.

Registers ``torch``, ``ref`` and ``cuda`` into ``core.backend``'s registry
(see that module for the contract and selection precedence), the
counterparts of the reference's ``jnp``, ``ref`` and ``pallas``; the
registry imports this module lazily.  Their integer entries are
bit-identical: the hot path is integer and every sum wraps mod 2^32.
Attention is float, so the three agree to a tolerance; within one backend
the checked entry's output is the plain entry's bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import abft as abft_mod
from repro_torch.core import backend as backend_mod
from repro_torch.kernels.qconv2d import kernel as qconv_kernel
from repro_torch.kernels.qconv2d import ref as qconv_ref
from repro_torch.kernels.qconv2d.ops import pad_zp, resolve_pads, weight_colsum
from repro_torch.kernels.flashattn import kernel as flash_kernel
from repro_torch.kernels.flashattn import ref as flash_ref
from repro_torch.kernels.qmatmul import kernel as qmatmul_kernel


def _pads(x_q, w_q, stride, padding):
    return resolve_pads(x_q.shape[1], x_q.shape[2], w_q.shape[0],
                        w_q.shape[1], stride, padding)


# ---------------------------------------------------------------------------
# torch — whole-tensor float64 ops, the counterpart of the reference's jnp
# (XLA dot_general / conv).  Every product and sum is an integer below 2^53,
# so float64 is exact; torch has no exact int8 dot (on the CPU int8 @ int8
# wraps in int8, on CUDA there is no int32 matmul), so no int8 or TF32 op.
# ---------------------------------------------------------------------------


def _exact_i32(v: torch.Tensor) -> torch.Tensor:
    return abft_mod.wrap_int32(torch.round(v).to(torch.int64))


def _matmul_acc_torch(x_q, w_q):
    return _exact_i32(x_q.double() @ w_q.double())


def _matmul_acc_checksum_torch(x_q, w_q, w_check):
    want = _exact_i32(x_q.double() @ w_check.double())
    return _matmul_acc_torch(x_q, w_q), want


def _conv_acc_torch(x_q, x_zp, w, stride, padding):
    """conv(x - zp, w) in float64 on the zero-point-padded NHWC input
    (padded taps hold zp, so they contribute 0), HWIO weights."""
    xp = pad_zp(x_q, x_zp, _pads(x_q, w, stride, padding))
    x = xp.double() - x_zp.double()
    y = F.conv2d(x.permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                 stride=tuple(stride))
    return _exact_i32(y.permute(0, 2, 3, 1))


def _conv_acc_checksum_torch(x_q, x_zp, w_q, w_check, stride, padding):
    return (_conv_acc_torch(x_q, x_zp, w_q, stride, padding),
            _conv_acc_torch(x_q, x_zp, w_check, stride, padding)[..., 0])


def _attn_torch(q, k, v, *, causal=True, window=None):
    return flash_ref.attention_ref(q, k, v, causal=causal, window=window)


def _attn_checksum_torch(q, k, v, *, causal=True, window=None):
    out = _attn_torch(q, k, v, causal=causal, window=window)
    check = _attn_check_column(q, k, v, causal=causal, window=window)
    return out, check, abft_mod.output_row_checksums(out)


# ---------------------------------------------------------------------------
# ref — independent oracle: exact float64 products summed in int64; explicit
# tap loop on x - zp for the conv, no colsum algebra
# ---------------------------------------------------------------------------


def _matmul_acc_ref(x_q, w_q):
    return abft_mod.wrap_int32(abft_mod.exact_dot(x_q, w_q))


def _matmul_acc_checksum_ref(x_q, w_q, w_check):
    want = abft_mod.exact_dot(x_q, w_check[:, None])[:, 0]
    return _matmul_acc_ref(x_q, w_q), abft_mod.wrap_int32(want)


def _conv_acc_ref(x_q, x_zp, w_q, stride, padding):
    return qconv_ref.conv_acc_ref(x_q, x_zp, w_q, stride,
                                  _pads(x_q, w_q, stride, padding))


def _conv_acc_checksum_ref(x_q, x_zp, w_q, w_check, stride, padding):
    pads = _pads(x_q, w_q, stride, padding)
    acc = qconv_ref.conv_acc_ref(x_q, x_zp, w_q, stride, pads)
    want = qconv_ref.conv_acc_ref(x_q, x_zp, w_check, stride, pads)[..., 0]
    return acc, want


# ---------------------------------------------------------------------------
# cuda — the hand-written kernels (their plain versions on CPU tensors)
# ---------------------------------------------------------------------------


def _matmul_acc_cuda(x_q, w_q):
    return qmatmul_kernel.qmatmul_acc(x_q.contiguous(), w_q.contiguous())


def _matmul_acc_checksum_cuda(x_q, w_q, w_check):
    return qmatmul_kernel.qmatmul_acc_checksum(
        x_q.contiguous(), w_q.contiguous(), w_check.contiguous())


def _conv_acc_cuda(x_q, x_zp, w_q, stride, padding):
    xp = pad_zp(x_q, x_zp, _pads(x_q, w_q, stride, padding))
    zp = x_zp.to(torch.int32).reshape(1)
    return qconv_kernel.qconv2d_acc(xp, w_q, weight_colsum(w_q), zp,
                                    stride=tuple(stride))


def _conv_acc_checksum_cuda(x_q, x_zp, w_q, w_check, stride, padding):
    xp = pad_zp(x_q, x_zp, _pads(x_q, w_q, stride, padding))
    zp = x_zp.to(torch.int32).reshape(1)
    return qconv_kernel.qconv2d_acc_checksum(
        xp, w_q, weight_colsum(w_q), w_check, zp,
        stride=tuple(stride))


# ---------------------------------------------------------------------------
# attention — the float hot kernel, per backend
#
# Attention has no integer operand identity, so the checksummed entry is
# two-tier (core/dependability.dependable_attention): a float check column
# verified with a tolerance plus an exact bit checksum of the emitted
# output rows.  The cuda kernels fuse both into the epilogue; ref computes
# them as separate passes in the execution path.
# ---------------------------------------------------------------------------


def _scores(q, k, *, causal, window):
    """Masked f32 scores (B, H, S, S), the GQA heads expanded."""
    G = q.shape[1] // k.shape[1]
    s = torch.matmul(q.to(torch.float32),
                     flash_ref.gqa_expand(k, G).transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    pos = torch.arange(q.shape[2], device=q.device)
    return torch.where(flash_ref.band_mask(pos, pos, causal, window), s,
                       flash_ref.NEG_INF)


def _attn_check_column(q, k, v, *, causal, window):
    """Independent rowsum_hd(out) accumulation: softmax probabilities
    contracted with rowsum_hd(v) — never touches the (hd-wide) output
    accumulation it checks."""
    v1 = flash_ref.gqa_expand(v, q.shape[1] // k.shape[1]).sum(dim=-1)
    p = torch.softmax(_scores(q, k, causal=causal, window=window), dim=-1)
    return torch.einsum("bhqk,bhk->bhq", p, v1)


def _attn_ref(q, k, v, *, causal=True, window=None):
    """Independent oracle: explicit two-pass softmax (max/exp/normalize),
    no ``torch.softmax``."""
    s = _scores(q, k, causal=causal, window=window)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    vv = flash_ref.gqa_expand(v, q.shape[1] // k.shape[1])
    return torch.matmul(p, vv).to(q.dtype)


def _attn_checksum_ref(q, k, v, *, causal=True, window=None):
    out = _attn_ref(q, k, v, causal=causal, window=window)
    check = _attn_check_column(q, k, v, causal=causal, window=window)
    return out, check, abft_mod.output_row_checksums(out)


def _attn_cuda(q, k, v, *, causal=True, window=None):
    return flash_kernel.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window)


def _attn_checksum_cuda(q, k, v, *, causal=True, window=None):
    return flash_kernel.flash_attention_checked(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window)


# ---------------------------------------------------------------------------
# registration + convenience dispatchers
# ---------------------------------------------------------------------------

for _be in (
    backend_mod.Backend(
        name="torch",
        matmul_acc=_matmul_acc_torch,
        matmul_acc_checksum=_matmul_acc_checksum_torch,
        conv_acc=_conv_acc_torch,
        conv_acc_checksum=_conv_acc_checksum_torch,
        attn=_attn_torch,
        attn_checksum=_attn_checksum_torch,
        description="whole-tensor float64 matmul / F.conv2d, exact below "
                    "2^53 (the reference's jnp)"),
    backend_mod.Backend(
        name="ref",
        matmul_acc=_matmul_acc_ref,
        matmul_acc_checksum=_matmul_acc_checksum_ref,
        conv_acc=_conv_acc_ref,
        conv_acc_checksum=_conv_acc_checksum_ref,
        attn=_attn_ref,
        attn_checksum=_attn_checksum_ref,
        description="independent plain-PyTorch oracle (exact float64 "
                    "products, tap loop, two-pass softmax)"),
    backend_mod.Backend(
        name="cuda",
        matmul_acc=_matmul_acc_cuda,
        matmul_acc_checksum=_matmul_acc_checksum_cuda,
        conv_acc=_conv_acc_cuda,
        conv_acc_checksum=_conv_acc_checksum_cuda,
        attn=_attn_cuda,
        attn_checksum=_attn_checksum_cuda,
        description="hand-written sm_90a kernels with the fused ABFT check "
                    "channel (their plain versions on CPU tensors)"),
):
    backend_mod.register_backend(_be, overwrite=True)
del _be


def conv_acc(x_q, x_zp, w_q, stride=(1, 1), padding="SAME", *,
             backend: backend_mod.BackendLike = None):
    """Raw int32 conv accumulator conv(x - zp, w) on the selected backend."""
    return backend_mod.resolve(backend).conv_acc(x_q, x_zp, w_q, stride,
                                                 padding)


def conv_acc_checksum(x_q, x_zp, w_q, w_check, stride=(1, 1), padding="SAME",
                      *, backend: backend_mod.BackendLike = None):
    """(acc, want) conv accumulator plus the fused per-pixel ABFT channel."""
    return backend_mod.resolve(backend).conv_acc_checksum(
        x_q, x_zp, w_q, w_check, stride, padding)


def matmul_acc(x_q, w_q, *, backend: backend_mod.BackendLike = None):
    """Raw int32 accumulator X·W on the selected backend."""
    return backend_mod.resolve(backend).matmul_acc(x_q, w_q)


def matmul_acc_checksum(x_q, w_q, w_check, *,
                        backend: backend_mod.BackendLike = None):
    """(acc, want) with the ABFT check vector computed in the execution path."""
    return backend_mod.resolve(backend).matmul_acc_checksum(x_q, w_q, w_check)


def attn(q, k, v, *, causal=True, window=None,
         backend: backend_mod.BackendLike = None):
    """Fused attention (B,H,S,hd layout) on the selected backend."""
    return backend_mod.resolve(backend).attn(q, k, v, causal=causal,
                                             window=window)


def attn_checksum(q, k, v, *, causal=True, window=None,
                  backend: backend_mod.BackendLike = None):
    """(out, check, csum): attention plus the two-tier ABFT check outputs."""
    return backend_mod.resolve(backend).attn_checksum(q, k, v, causal=causal,
                                                      window=window)
