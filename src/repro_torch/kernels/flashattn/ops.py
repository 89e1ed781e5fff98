"""Model-layout wrappers around the flash-attention kernels, and the
differentiable form.

The counterpart of ``repro.kernels.flashattn.ops``.  Models carry
(B, S, H, hd); the kernels want (B, H, S, hd).  The reference's
``interpret`` switch has no counterpart: a CUDA tensor always reaches the
kernel, a CPU tensor its plain version.

``flash_attn_diff`` is the reference's ``jax.custom_vjp`` as a
``torch.autograd.Function``: its forward is ``flash_attention_fwd_lse``,
which saves q, k, v, out and lse; its backward is ``flash_attention_bwd``.
Under ``torch.no_grad``, or with no input requiring a gradient, it runs the
forward kernel alone and saves nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flashattn import kernel


def _heads_major(*ts):
    return [t.transpose(1, 2).contiguous() for t in ts]


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True,
               window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KV, hd) → (B, S, H, hd) on
    ``flash_attention``."""
    out = kernel.flash_attention(*_heads_major(q, k, v), causal=causal,
                                 window=window)
    return out.transpose(1, 2)


class _FlashAttnDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        out, lse = kernel.flash_attention_fwd_lse(
            q, k, v, causal=causal, window=window, block_q=block_q,
            block_k=block_k)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, block_q=block_q,
                        block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd(q, k, v, out, lse,
                                                do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attn_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = kernel.BLOCK_Q,
                    block_k: int = kernel.BLOCK_K) -> torch.Tensor:
    """Differentiable flash attention: forward AND backward are the hand
    kernels.  q (B, H, S, hd), k/v (B, KV, S, hd) → (B, H, S, hd).  The
    backward rebuilds the probabilities from the saved logsumexp: the
    (S, S) score matrix is never stored in either pass."""
    return _FlashAttnDiff.apply(q, k, v, causal, window, block_q, block_k)


def flash_attn_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: Optional[int] = None,
                     block_q: int = kernel.BLOCK_Q,
                     block_k: int = kernel.BLOCK_K) -> torch.Tensor:
    """The model layout's differentiable attention, (B, S, H, hd) in and
    out, on ``flash_attn_diff``."""
    out = flash_attn_diff(*_heads_major(q, k, v), causal, window, block_q,
                          block_k)
    return out.transpose(1, 2)
