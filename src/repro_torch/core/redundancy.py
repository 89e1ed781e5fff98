"""N-modular redundancy with bitwise majority voting (temporal form).

The counterpart of ``vote``, ``agree`` and ``_bitwise_majority3`` in
``repro.core.redundancy``.  Bitwise majority of three,
maj(a,b,c) = (a&b) | (b&c) | (a&c), applied to the bit patterns, is exact
and branch-free for every dtype.  The spatial form (``replicated_vote``,
one replica per device) comes with the parallelism slice.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.fault_injection import _as_bits


def _bitwise_majority3(a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    ab, _ = _as_bits(a)
    bb, _ = _as_bits(b)
    cb, _ = _as_bits(c)
    maj = (ab & bb) | (bb & cb) | (ab & cb)
    return maj.view(a.dtype)


def vote(replicas: Sequence[torch.Tensor]) -> torch.Tensor:
    """Majority vote across replica outputs.

    3 replicas → bitwise majority (corrects any single corrupted replica).
    2 replicas → detection only: returns replica 0; use ``agree`` to check.
    """
    if len(replicas) == 3:
        return _bitwise_majority3(*replicas)
    if len(replicas) == 2:
        return replicas[0]
    raise ValueError(f"vote() supports 2 or 3 replicas, got {len(replicas)}")


def agree(replicas: Sequence[torch.Tensor]) -> torch.Tensor:
    """() bool tensor — all replicas bit-identical (DMR detection predicate).
    Stays on the device: no host synchronisation."""
    b0, _ = _as_bits(replicas[0])
    ok = torch.ones((), dtype=torch.bool, device=b0.device)
    for other in replicas[1:]:
        ob, _ = _as_bits(other)
        ok = ok & torch.all(b0 == ob)
    return ok
