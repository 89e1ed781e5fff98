"""Optimizers: AdamW, Adafactor (factored second moment) and SGD with
momentum.

The counterpart of ``repro.train.optim``.  Each is an (init, update) pair
of pure functions over a parameter pytree (``repro_torch.tree``): ``update``
returns new update and state trees and mutates nothing, as the reference's
(so a snapshot taken by the checkpointer, or a state kept for a replay,
never changes under the caller).  Arithmetic in f32 in the reference's
order; updates cast back to each parameter's dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]
    name: str


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def global_norm(t) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf²), in f32."""
    sq = [torch.sum(torch.square(leaf.to(torch.float32)))
          for leaf in tree.leaves(t)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm(t, max_norm: float):
    """(t scaled to global norm at most ``max_norm``, the norm before)."""
    norm = global_norm(t)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map(lambda g: g * scale.to(g.dtype), t), norm


def _step_t(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32) + 1.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": tree.map(_f32_zeros, params),
                "v": tree.map(_f32_zeros, params)}

    def update(grads, state, params, step):
        t = _step_t(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        ups, ms, vs = [], [], []
        for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state["m"]),
                              tree.leaves(state["v"]), tree.leaves(params)):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p.to(torch.float32)
            ups.append((-lr * u).to(p.dtype))
            ms.append(m)
            vs.append(v)
        s = tree.structure(params)
        return tree.unflatten(s, ups), {"m": tree.unflatten(s, ms),
                                        "v": tree.unflatten(s, vs)}

    return Optimizer(init, update, "adamw")


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

    def update(grads, state, params, step):
        t = _step_t(step)
        beta = 1.0 - t ** (-decay)
        structure = tree.structure(params)
        ups, ns = [], []
        for path, p in tree.leaves_with_paths(params):
            g = _at(grads, path).to(torch.float32)
            s = _at(state, path)
            g2 = g * g + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rms = torch.sqrt(
                    vr[..., :, None] * vc[..., None, :]
                    / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)
                                  [..., None], min=eps))
                u = g / torch.clamp(rms, min=eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / torch.sqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS of update ≤ clip_threshold)
            urms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(urms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            ups.append((-lr * u).to(p.dtype))
            ns.append(new_s)
        return tree.unflatten(structure, ups), tree.unflatten(structure, ns)

    return Optimizer(init, update, "adafactor")


def _at(t, path):
    for p in path:
        t = t[p]
    return t


def sgdm(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": tree.map(_f32_zeros, params)}

    def update(grads, state, params, step):
        m = tree.map(lambda g, mm: momentum * mm + g.to(torch.float32),
                     grads, state["m"])
        updates = tree.map(lambda mm, p: (-lr * mm).to(p.dtype), m, params)
        return updates, {"m": m}

    return Optimizer(init, update, "sgdm")


def make_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    if name == "sgdm":
        return sgdm(lr=lr)
    raise ValueError(name)
