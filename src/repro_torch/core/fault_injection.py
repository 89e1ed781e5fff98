"""SEU (single-event upset) injection: bit flips in live tensors.

The counterpart of ``repro.core.fault_injection``.  Flips go through the
same-width *signed* integer view of a tensor (``int8`` / ``int16`` /
``int32``): XOR and AND give the same bits on a signed or an unsigned view,
and bitwise ops on ``torch.uint32`` are thin on CUDA.

The reference draws its targets from ``jax.random`` key streams, which the
port cannot reproduce: ``flip_bit_at_index`` takes the target explicitly,
so that a test strikes the same cell in both packages, and the random
faults (``flip_one_bit`` and the pytree injectors, which the training
drills use) draw from a CPU ``torch.Generator`` instead of a key.  Each
draw advances the generator, so every flip of ``inject_into_pytree`` is
an independent draw, as the reference's one key per flip.  Faults return
a copy and leave their input untouched, as the reference's.
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


def flip_one_bit(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A copy of ``x`` with one uniformly random bit of one uniformly random
    element flipped."""
    idx = int(torch.randint(x.numel(), (), generator=gen))
    bit = int(torch.randint(x.element_size() * 8, (), generator=gen))
    return flip_bit_at_index(x, idx, bit)


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


def inject_into_pytree(params, gen: torch.Generator, n_flips: int = 1):
    """Flip ``n_flips`` single bits, each in a random leaf of a pytree
    (weight-memory SEU model for checkpoint/restart drills); every flip
    takes fresh draws from ``gen``."""
    for _ in range(n_flips):
        params = inject_pytree_with(params, gen, flip_one_bit)
    return params
