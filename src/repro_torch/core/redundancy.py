"""N-modular redundancy with bitwise majority voting (temporal form).

The counterpart of ``vote``, ``agree``, ``dmr_apply``, ``tmr_apply`` and
``_bitwise_majority3`` in ``repro.core.redundancy``; replicas are tensors
or pytrees of them (``repro_torch.tree``).  Bitwise majority of three,
maj(a,b,c) = (a&b) | (b&c) | (a&c), applied to the bit patterns, is exact
and branch-free for every dtype.  ``replicated_vote`` is the spatial form:
one replica per rank of a mesh axis of size 3.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch import tree
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
        return tree.map(_bitwise_majority3, *replicas)
    if len(replicas) == 2:
        return replicas[0]
    raise ValueError(f"vote() supports 2 or 3 replicas, got {len(replicas)}")


def agree(replicas: Sequence[torch.Tensor]) -> torch.Tensor:
    """() bool tensor — all replicas bit-identical (DMR detection predicate).
    Stays on the device: no host synchronisation."""
    flat0 = tree.leaves(replicas[0])
    ok = torch.ones((), dtype=torch.bool, device=flat0[0].device)
    for other in replicas[1:]:
        for a, b in zip(flat0, tree.leaves(other)):
            ok = ok & torch.all(_as_bits(a)[0] == _as_bits(b)[0])
    return ok


def _replicas(f: Callable, args, injectors) -> list:
    outs = []
    for inj in injectors:
        y = f(*args)
        if inj is not None:
            y = tree.map(inj, y)
        outs.append(y)
    return outs


def dmr_apply(f: Callable, *args,
              injectors: Sequence[Optional[Callable]] = (None, None)):
    """Dual modular redundancy, detect-only: run ``f`` twice (each pass
    optionally perturbed by an injector) and compare bit for bit.
    Returns ``(y0, detected)``: replica 0's output and a () bool tensor,
    True when the replicas disagree."""
    outs = _replicas(f, args, injectors)
    return outs[0], ~agree(outs)


def tmr_apply(f: Callable, *args,
              injectors: Sequence[Optional[Callable]] = (None, None, None)):
    """Run ``f`` three times, each optionally perturbed by an injector,
    and vote."""
    return vote(_replicas(f, args, injectors))


def replicated_vote(f: Callable, mesh, axis: str = "replica") -> Callable:
    """Spatial TMR: each rank along ``axis`` (size 3) computes ``f`` in
    full; every leaf of the result is all-gathered over the axis and
    majority-voted bit for bit on every rank.  Returns a function with
    ``f``'s signature; its inputs must be the same on the three ranks."""
    if mesh.shape[axis] != 3:
        raise ValueError(f"replicated_vote needs a {axis!r} axis of size 3, "
                         f"the mesh has {mesh.shape}")
    from repro_torch.parallel import collectives as C

    def gather_vote(leaf: torch.Tensor) -> torch.Tensor:
        allr = C.all_gather(leaf.detach()[None], mesh, axis, dim=0)
        return _bitwise_majority3(allr[0], allr[1], allr[2])

    def voted(*args):
        return tree.map(gather_vote, f(*args))
    return voted
