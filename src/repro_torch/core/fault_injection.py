"""SEU (single-event upset) injection: bit flips in live tensors.

The counterpart of ``repro.core.fault_injection``.  Flips go through the
same-width *signed* integer view of a tensor (``int8`` / ``int16`` /
``int32``): XOR and AND give the same bits on a signed or an unsigned view,
and bitwise ops on ``torch.uint32`` are thin on CUDA.

The reference draws its targets from ``jax.random`` key streams, which the
port cannot reproduce; ``flip_bit_at_index`` takes the target explicitly,
so that a test strikes the same cell in both packages.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INT_FOR_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _as_bits(x: torch.Tensor) -> Tuple[torch.Tensor, torch.dtype]:
    """``x`` viewed as its same-width signed integer type (no copy)."""
    t = _INT_FOR_WIDTH[x.element_size()]
    return x.view(t), t


def flip_bit_at_index(x: torch.Tensor, index: int, bit: int) -> torch.Tensor:
    """A copy of ``x`` with ``bit`` of flat element ``index`` flipped."""
    bits, _ = _as_bits(x)
    width = x.element_size() * 8
    if not 0 <= bit < width:
        raise ValueError(f"bit {bit} outside a {width}-bit element")
    mask = 1 << bit
    if mask >= 1 << (width - 1):        # the sign bit, as a signed constant
        mask -= 1 << width
    flat = bits.reshape(-1).clone()
    flat[index] ^= mask
    return flat.reshape(x.shape).view(x.dtype)
