"""Optimizers: AdamW, Adafactor (factored second moment) and SGD with
momentum.

The counterpart of ``repro.train.optim``.  Each is an (init, update) pair
of pure functions over a parameter pytree (``repro_torch.tree``): ``update``
returns new update and state trees and mutates nothing, as the reference's
(so a snapshot taken by the checkpointer, or a state kept for a replay,
never changes under the caller).  Arithmetic in f32 in the reference's
order; updates cast back to each parameter's dtype.  ``apply_`` writes the
same values into the state and its parameters in place, as the reference's
donated buffers take them: the train step (``train.steps``) runs it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]
    name: str
    apply_: Callable[..., None]


def _no_pmean(t, dims):
    return t


def _pmeans(params, shard):
    """One ``pmean(t, dims)`` per parameter leaf: the mean over the ranks
    that hold the other shards of the parameter's dims ``dims`` (all its
    sharded dims for None), for a mean taken over those dims of a local
    shard.  ``shard`` is (specs, mesh) or None (nothing sharded)."""
    n = len(tree.leaves(params))
    if shard is None:
        return [_no_pmean] * n
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import entry_axes
    specs, mesh = shard

    def make(spec, ndim):
        parts = tuple(spec) + (None,) * (ndim - len(spec))

        def pmean(t, dims):
            dims = range(ndim) if dims is None else dims
            axes = {a for d in dims for a in entry_axes(parts[d])}
            return C.all_mean(t, mesh, tuple(a for a in mesh.axis_names
                                             if a in axes))
        return pmean
    return [make(s, p.dim()) for s, p in zip(tree.leaves(specs),
                                             tree.leaves(params))]


def _optimizer(name, init, leaf, split, join,
               elementwise=False) -> Optimizer:
    """An ``Optimizer`` from its rule for one parameter.

    ``leaf(g, s, p, step, pmean)`` returns the parameter's update, in its
    dtype, and its new state, a dict of f32 tensors that ``leaf``
    allocated; ``pmean`` (``_pmeans``) makes a mean over a shard's dims
    the whole parameter's (identity when nothing is sharded; ``update`` and
    ``apply_`` take ``shard=(specs, mesh)`` for a sharded state);
    ``split(state, path)`` is the parameter's state dict, holding the
    state's own tensors; ``join(structure, states)`` is the state tree of
    the per-parameter dicts.  ``update`` is functional.  ``apply_`` is its
    in-place twin, the train step's: parameter by parameter it adds the
    update into the parameter and copies the new state over the old, so
    that no second copy of the parameters or of the state is ever held (a
    model whose parameters, gradients and state fill most of the card
    trains on it); the values are ``update``'s bit for bit.  An
    ``elementwise`` rule runs there a stacked leaf in blocks of whole
    slices of its leading axis, as many as fit in ``_BLOCK`` elements (one
    at least): the same values, a block's temporaries, and one block for a
    leaf that fits (each block costs the rule's launches again)."""
    def update(grads, state, params, step, shard=None):
        ups, states = [], []
        for (path, p), pm in zip(tree.leaves_with_paths(params),
                                 _pmeans(params, shard)):
            u, s = leaf(_at(grads, path), split(state, path), p, step, pm)
            ups.append(u)
            states.append(s)
        structure = tree.structure(params)
        return tree.unflatten(structure, ups), join(structure, states)

    def apply_(grads, state, params, step, shard=None):
        for (path, p), pm in zip(tree.leaves_with_paths(params),
                                 _pmeans(params, shard)):
            g, old = _at(grads, path), split(state, path)
            for i in _blocks(p) if elementwise and p.dim() > 2 else (...,):
                u, new = leaf(g[i], {k: t[i] for k, t in old.items()}, p[i],
                              step, pm)
                p[i].add_(u)
                for k, t in new.items():
                    old[k][i].copy_(t)

    return Optimizer(init, update, name, apply_)


# elements per block of an elementwise rule in place (512 MB of f32): a
# leaf that fits runs whole, a larger one as many slices as fit
_BLOCK = 1 << 27


def _blocks(p: torch.Tensor):
    n = max(1, _BLOCK * p.shape[0] // max(p.numel(), 1))
    return [slice(i, i + n) for i in range(0, p.shape[0], n)]


def _keyed(*keys):
    """(split, join) of a state that holds one params-shaped tree per key."""
    def split(state, path):
        return {k: _at(state[k], path) for k in keys}

    def join(structure, states):
        return {k: tree.unflatten(structure, [s[k] for s in states])
                for k in keys}
    return split, join


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def global_norm(t, shard=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf²), in f32.  With ``shard``
    = (specs, mesh), ``t`` holds this rank's shards: each leaf's sum is
    summed over the axes that shard it, so each element counts once (a
    replicated copy not again), in one all-reduce per set of axes."""
    leaves = tree.leaves(t)
    sq = [torch.sum(torch.square(leaf.to(torch.float32))) for leaf in leaves]
    if shard is not None:
        from repro_torch.parallel import collectives as C
        from repro_torch.parallel.sharding import entry_axes
        specs, mesh = shard
        by_axes = {}
        for i, spec in enumerate(tree.leaves(specs)):
            named = {a for e in spec for a in entry_axes(e)}
            axes = tuple(a for a in mesh.axis_names if a in named)
            by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            summed = C.all_reduce(torch.stack([sq[i] for i in idx]), mesh,
                                  axes)
            for i, v in zip(idx, summed.unbind()):
                sq[i] = v
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm_(t, max_norm: float, shard=None) -> torch.Tensor:
    """Scale every leaf of ``t`` in place so that the global norm is at
    most ``max_norm``; returns the norm before."""
    norm = global_norm(t, shard)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree.leaves(t):
        g.mul_(scale.to(g.dtype))
    return norm


def clip_by_global_norm(t, max_norm: float):
    """(t scaled to global norm at most ``max_norm``, the norm before)."""
    t = tree.map(torch.clone, t)
    return t, clip_by_global_norm_(t, max_norm)


def _step_t(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32) + 1.0


# Each rule below computes the reference's expression in the reference's
# order; it writes in place only into tensors it allocated itself, so that a
# full-width FFN or embedding leaf holds at most three f32 temporaries
# beside its new state, where the expressions written out hold five or six.

# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": tree.map(_f32_zeros, params),
                "v": tree.map(_f32_zeros, params)}

    def leaf(g, s, p, step, pmean):
        t = _step_t(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        g = g.to(torch.float32)
        m = b1 * s["m"]
        m.add_((1 - b1) * g)                     # b1·m + (1 − b1)·g
        v = b2 * s["v"]
        v.add_((1 - b2) * g * g)                 # b2·v + (1 − b2)·g·g
        del g
        den = v / bc2
        den.sqrt_()
        den.add_(eps)                            # sqrt(v / bc2) + eps
        u = m / bc1
        u.div_(den)
        del den
        u.add_(weight_decay * p.to(torch.float32))
        u.mul_(-lr)
        return u.to(p.dtype), {"m": m, "v": v}

    return _optimizer("adamw", init, leaf, *_keyed("m", "v"),
                      elementwise=True)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018) — factored second moment
# ---------------------------------------------------------------------------


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        def st(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _f32_zeros(p)}
        return tree.unflatten(tree.structure(params),
                              [st(p) for p in tree.leaves(params)])

    def leaf(g, s, p, step, pmean):
        t = _step_t(step)
        beta = 1.0 - t ** (-decay)
        g = g.to(torch.float32)
        g2 = g * g
        g2.add_(eps)
        if _factored(p):
            # each mean over a sharded dim is the whole parameter's
            vr = beta * s["vr"] + (1 - beta) * pmean(
                torch.mean(g2, dim=-1), (p.dim() - 1,))
            vc = beta * s["vc"] + (1 - beta) * pmean(
                torch.mean(g2, dim=-2), (p.dim() - 2,))
            del g2
            # rms = sqrt(vr ⊗ vc / mean(vr)), then u = g / max(rms, eps)
            u = vr[..., :, None] * vc[..., None, :]
            u.div_(torch.clamp(pmean(torch.mean(vr, dim=-1, keepdim=True),
                                     (p.dim() - 2,))[..., None], min=eps))
            u.sqrt_()
            u.clamp_(min=eps)
            torch.div(g, u, out=u)
            new = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g / torch.sqrt(v + eps)
            new = {"v": v}
        del g
        # update clipping (RMS of update ≤ clip_threshold)
        urms = torch.sqrt(pmean(torch.mean(u * u), None))
        u.div_(torch.clamp(urms / clip_threshold, min=1.0))
        if weight_decay:
            u.add_(weight_decay * p.to(torch.float32))
        u.mul_(-lr)
        return u.to(p.dtype), new

    def join(structure, states):
        return tree.unflatten(structure, states)

    return _optimizer("adafactor", init, leaf, _at, join)


def _at(t, path):
    for p in path:
        t = t[p]
    return t


def sgdm(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": tree.map(_f32_zeros, params)}

    def leaf(g, s, p, step, pmean):
        m = momentum * s["m"] + g.to(torch.float32)
        return (-lr * m).to(p.dtype), {"m": m}

    return _optimizer("sgdm", init, leaf, *_keyed("m"), elementwise=True)


def make_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    if name == "sgdm":
        return sgdm(lr=lr)
    raise ValueError(name)
