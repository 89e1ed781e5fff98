"""SEU (single-event upset) injection: bit flips in live tensors.

The counterpart of ``repro.core.fault_injection``.  Flips go through the
same-width *signed* integer view of a tensor (``int8`` / ``int16`` /
``int32``): XOR and AND give the same bits on a signed or an unsigned view,
and bitwise ops on ``torch.uint32`` are thin on CUDA.

The reference draws its targets from ``jax.random`` key streams, which the
port cannot reproduce.  So every fault model whose target is a draw has an
explicitly addressed twin (``flip_bit_at_index`` for ``flip_one_bit`` and
``flip_bit_at``, ``flip_burst_at`` for ``flip_burst``, ``stuck_at_index``
for ``stuck_at``, ``inject_leaf_with`` for ``inject_pytree_with``'s leaf
draw), with which a test strikes the same cells in both
packages, and the random models (the campaign's faultload, the pytree
injectors of the training drills) draw from a CPU ``torch.Generator``
instead of a key.  The draws happen on the host and the fault is applied on
the tensor's own device, so one seed strikes the same cells on the CPU and
on the card.  Each draw advances the generator, so every flip of
``inject_into_pytree`` is an independent draw, as the reference's one key
per flip.  Faults return a copy and leave their input untouched, as the
reference's.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch import tree

_INT_FOR_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _as_bits(x: torch.Tensor) -> Tuple[torch.Tensor, torch.dtype]:
    """``x`` viewed as its same-width signed integer type (no copy)."""
    t = _INT_FOR_WIDTH[x.element_size()]
    return x.view(t), t


def _width(x: torch.Tensor) -> int:
    return x.element_size() * 8


def _signed(mask: int, width: int) -> int:
    """An unsigned ``width``-bit mask as the signed constant of that width."""
    return mask - (1 << width) if mask >= 1 << (width - 1) else mask


def _bit_mask(x: torch.Tensor, bit: int, bits: int = 1) -> int:
    """Bits ``bit .. bit + bits - 1`` of one element of ``x``, signed."""
    width = _width(x)
    if not (bits >= 1 and 0 <= bit and bit + bits <= width):
        raise ValueError(f"bits {bit}..{bit + bits - 1} outside a "
                         f"{width}-bit element")
    return _signed(((1 << bits) - 1) << bit, width)


def _draw(high: int, gen: torch.Generator) -> int:
    return int(torch.randint(high, (), generator=gen))


def flip_bit_at_index(x: torch.Tensor, index: int, bit: int) -> torch.Tensor:
    """A copy of ``x`` with ``bit`` of flat element ``index`` flipped."""
    return flip_burst_at(x, index, bit, 1, 1)


def flip_one_bit(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A copy of ``x`` with one uniformly random bit of one uniformly random
    element flipped."""
    idx = _draw(x.numel(), gen)
    return flip_bit_at_index(x, idx, _draw(_width(x), gen))


def flip_bit_at(x: torch.Tensor, gen: torch.Generator,
                bit: int) -> torch.Tensor:
    """Flip the given bit position of one uniformly random element: the
    targeted cousin of ``flip_one_bit``, with which the bit sweep maps
    per-bit-position coverage."""
    return flip_bit_at_index(x, _draw(x.numel(), gen), bit)


def flip_burst_at(x: torch.Tensor, e0: int, b0: int, elems: int,
                  bits: int) -> torch.Tensor:
    """A copy of ``x`` with bits ``b0 .. b0 + bits - 1`` flipped in flat
    elements ``e0 .. e0 + elems - 1``: the addressed twin of
    ``flip_burst``.  The cluster must lie inside the tensor and the word."""
    mask = _bit_mask(x, b0, bits)
    if not (elems >= 1 and 0 <= e0 and e0 + elems <= x.numel()):
        raise ValueError(f"elements {e0}..{e0 + elems - 1} outside a tensor "
                         f"of {x.numel()}")
    bits_t, _ = _as_bits(x)
    flat = bits_t.reshape(-1).clone()
    flat[e0:e0 + elems] ^= mask
    return flat.reshape(x.shape).view(x.dtype)


def flip_burst(x: torch.Tensor, gen: torch.Generator, elems: int = 2,
               bits: int = 2) -> torch.Tensor:
    """MBU burst: flip a seeded ``elems`` x ``bits`` cluster of adjacent
    cells (the same adjacent bit positions in adjacent elements of the
    flattened tensor), anchored at a uniformly random (element, bit) and
    clamped inside the tensor and the word, as the reference's: every burst
    has the same size."""
    n, width = x.numel(), _width(x)
    span_e, span_b = min(elems, n), min(bits, width)
    e0 = min(_draw(n, gen), n - span_e)
    b0 = _draw(width - span_b + 1, gen)
    return flip_burst_at(x, e0, b0, span_e, span_b)


def stuck_at_index(x: torch.Tensor, index: int, bit: int,
                   value: int) -> torch.Tensor:
    """A copy of ``x`` with ``bit`` of flat element ``index`` forced to
    ``value`` (0 or 1): the addressed twin of ``stuck_at``."""
    mask = _bit_mask(x, bit)
    bits_t, _ = _as_bits(x)
    flat = bits_t.reshape(-1).clone()
    if value:
        flat[index] |= mask
    else:
        flat[index] &= ~mask
    return flat.reshape(x.shape).view(x.dtype)


def stuck_at(x: torch.Tensor, gen: torch.Generator,
             stuck_value: int = 1) -> torch.Tensor:
    """Force one uniformly random bit of one uniformly random element to
    ``stuck_value``: idempotent, and masked at the site where the bit
    already holds the value (the ~50 % intrinsic masking floor)."""
    idx = _draw(x.numel(), gen)
    return stuck_at_index(x, idx, _draw(_width(x), gen), stuck_value)


def flip_bits_at_rate(x: torch.Tensor, gen: torch.Generator,
                      rate: float) -> torch.Tensor:
    """Flip each bit independently with probability ``rate`` (fleet-scale
    SEU model).  The hits are drawn on the host, one uniform per bit, bit
    position by bit position, and applied as one XOR on ``x``'s device."""
    width = _width(x)
    mask = torch.zeros(x.shape, dtype=torch.int64)
    for b in range(width):
        hit = torch.rand(x.shape, generator=gen, dtype=torch.float64) < rate
        mask |= hit.to(torch.int64) << b
    mask = torch.where(mask >= 1 << (width - 1), mask - (1 << width), mask)
    bits_t, t = _as_bits(x)
    return (bits_t ^ mask.to(t).to(x.device)).view(x.dtype)


def inject_pytree_with(params, gen: torch.Generator,
                       fault: Callable[[torch.Tensor, torch.Generator],
                                       torch.Tensor]):
    """Apply ``fault(x, gen) -> x'`` to one random tensor leaf of a pytree,
    chosen weighted by element count (uniform over elements)."""
    leaves = tree.leaves_with_paths(params)
    sizes = torch.tensor([float(leaf.numel()) for _, leaf in leaves],
                         dtype=torch.float64)
    i = int(torch.multinomial(sizes / sizes.sum(), 1, generator=gen))
    path, leaf = leaves[i]
    return tree.replace(params, path, fault(leaf, gen))


def inject_leaf_with(params, path: tuple, gen: torch.Generator,
                     fault: Callable[[torch.Tensor, torch.Generator],
                                     torch.Tensor]):
    """Apply ``fault(x, gen) -> x'`` to the leaf at ``path``
    (``tree.leaves_with_paths``' paths): the addressed twin of
    ``inject_pytree_with``'s leaf draw."""
    leaf = dict(tree.leaves_with_paths(params))[tuple(path)]
    return tree.replace(params, tuple(path), fault(leaf, gen))


def inject_into_pytree(params, gen: torch.Generator, n_flips: int = 1):
    """Flip ``n_flips`` single bits, each in a random leaf of a pytree
    (weight-memory SEU model for checkpoint/restart drills); every flip
    takes fresh draws from ``gen``."""
    for _ in range(n_flips):
        params = inject_pytree_with(params, gen, flip_one_bit)
    return params
