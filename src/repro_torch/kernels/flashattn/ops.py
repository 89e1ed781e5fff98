"""Model-layout wrappers around the flash-attention kernels.

The counterpart of ``repro.kernels.flashattn.ops``.  Models carry
(B, S, H, hd); the kernels want (B, H, S, hd).  The reference's
``interpret`` switch has no counterpart: a CUDA tensor always reaches the
kernel, a CPU tensor its plain version.

``flash_attn_diff`` (the differentiable form, whose backward is the
``flash_attention_bwd`` kernel) comes with training, ROADMAP.md queue 1,
item 13; until then ``flash_attn_model`` serves the forward only and
refuses inputs that require a gradient.
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


def flash_attn_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: Optional[int] = None,
                     block_q: int = kernel.BLOCK_Q,
                     block_k: int = kernel.BLOCK_K) -> torch.Tensor:
    """The model layout's attention, (B, S, H, hd) in and out, on
    ``flash_attention_fwd_lse`` — the reference's ``flash_attn_diff``
    forward, whose lse the backward will read."""
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attn_model has no backward yet: flash_attn_diff and the "
            "flash_attention_bwd kernels come with training, ROADMAP.md "
            "queue 1, item 13")
    out, _ = kernel.flash_attention_fwd_lse(*_heads_major(q, k, v),
                                            causal=causal, window=window,
                                            block_q=block_q, block_k=block_k)
    return out.transpose(1, 2)
