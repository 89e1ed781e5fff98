"""Built-in execution backends for the quantized matmul and conv.

Registers ``ref`` and ``cuda`` into ``core.backend``'s registry (see that
module for the contract and selection precedence); the registry imports
this module lazily.  Both are bit-identical: the hot path is integer and
every sum wraps mod 2^32.

The attention entries of both backends are empty: calling them raises
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import torch

from repro_torch.core import abft as abft_mod
from repro_torch.core import backend as backend_mod
from repro_torch.kernels.qconv2d import kernel as qconv_kernel
from repro_torch.kernels.qconv2d import ref as qconv_ref
from repro_torch.kernels.qconv2d.ops import pad_zp, resolve_pads, weight_colsum
from repro_torch.kernels.qmatmul import kernel as qmatmul_kernel

_ATTN_ITEM = ("the flash-attention kernels come with ROADMAP.md queue 1, "
              "item 10 (port slice 3)")


def _pads(x_q, w_q, stride, padding):
    return resolve_pads(x_q.shape[1], x_q.shape[2], w_q.shape[0],
                        w_q.shape[1], stride, padding)


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
# registration + convenience dispatchers
# ---------------------------------------------------------------------------

for _be in (
    backend_mod.Backend(
        name="ref",
        matmul_acc=_matmul_acc_ref,
        matmul_acc_checksum=_matmul_acc_checksum_ref,
        conv_acc=_conv_acc_ref,
        conv_acc_checksum=_conv_acc_checksum_ref,
        description="independent plain-PyTorch oracle (exact float64 "
                    "products, tap loop)"),
    backend_mod.Backend(
        name="cuda",
        matmul_acc=_matmul_acc_cuda,
        matmul_acc_checksum=_matmul_acc_checksum_cuda,
        conv_acc=_conv_acc_cuda,
        conv_acc_checksum=_conv_acc_checksum_cuda,
        description="hand-written sm_90a kernels with the fused ABFT check "
                    "channel (their plain versions on CPU tensors)"),
):
    backend_mod.register_backend(_be, overwrite=True)
del _be


def _entry(be: backend_mod.Backend, name: str, item: str):
    fn = getattr(be, name)
    if fn is None:
        raise NotImplementedError(f"backend {be.name!r} has no {name} yet: "
                                  f"{item}")
    return fn


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
    be = backend_mod.resolve(backend)
    return _entry(be, "attn", _ATTN_ITEM)(q, k, v, causal=causal,
                                          window=window)


def attn_checksum(q, k, v, *, causal=True, window=None,
                  backend: backend_mod.BackendLike = None):
    """(out, check, csum): attention plus the two-tier ABFT check outputs."""
    be = backend_mod.resolve(backend)
    return _entry(be, "attn_checksum", _ATTN_ITEM)(q, k, v, causal=causal,
                                                   window=window)
