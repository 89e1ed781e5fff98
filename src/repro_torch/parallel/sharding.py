"""Logical sharding rules: parameter-tree paths → partition specs, and the
placement of a tree's shards on the ranks of a mesh.

The counterpart of ``repro.parallel.sharding``, with the same table and
the same stacked-block rule, so that ``param_specs``, ``batch_specs`` and
``cache_specs`` give the reference's specs as data.  Axis scheme:

  batch                              → dp axes ("data",) or ("pod", "data")
  heads / d_ff / vocab / experts' E  → "model"   (tensor / expert parallel)
  weight non-TP dim                  → dp when cfg.fsdp_params (ZeRO-3)

``P`` is the port's partition spec: one entry per tensor dimension, each
None (not split), an axis name, or a tuple of axis names (split over their
product, the first axis major).  It normalises its entries as JAX's
``PartitionSpec`` does (a one-name tuple is the name, an empty one None)
and is a leaf of ``repro_torch.tree``, not a container.

``local_slices`` is the counterpart of ``NamedSharding``'s
``devices_indices_map``: the slice of each dimension a rank holds.
``shard_tree`` cuts each rank's leaves out of full ones (the
counterpart of ``jax.device_put`` with ``shardings_for``), and
``gather_tree`` puts full leaves back together on every rank.  A
dimension that its axes do not divide raises a ``ValueError`` naming the
leaf and the axis: it is never replicated quietly.

One difference by design: the port's ``GriffinCache.length`` is a (B,)
vector, one position per row, so its spec is the batch's (dp), where the
reference's scalar counter is replicated.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models.config import ArchConfig


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P:
    """A partition spec (see the module doc)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(_entry(e) for e in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"


def entry_axes(e) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _rules(cfg: ArchConfig, dp: Tuple[str, ...], mdl: Optional[str],
           moe_mode: str = "ep"):
    """name → spec.  fsdp shards one non-TP dim over the dp axes."""
    fsdp = dp if cfg.fsdp_params else None

    # the expert layout follows models.transformer.moe_mode: EP when E
    # divides the model axis, else expert-TP (de → model, d → dp)
    if moe_mode == "ep":
        we_g = we_i = P(mdl, None, dp)
        we_o = P(mdl, dp, None)
    else:
        we_g = we_i = P(None, dp, mdl)
        we_o = P(None, mdl, dp)

    # (a leading L axis is added for stacked block params)
    return {
        # transformer attention
        "wq": P(fsdp, mdl), "wk": P(fsdp, mdl), "wv": P(fsdp, mdl),
        "wo": P(mdl, fsdp),
        "bq": P(mdl), "bk": P(mdl), "bv": P(mdl),
        # dense mlp
        "wi": P(fsdp, mdl), "wg": P(fsdp, mdl), "wd": P(mdl, fsdp),
        "mlp_g": P(fsdp, mdl), "mlp_i": P(fsdp, mdl), "mlp_o": P(mdl, fsdp),
        "router": P(None, None),
        "we_g": we_g, "we_i": we_i, "we_o": we_o,
        # W8A8: int8 weights shard like their float originals, the
        # per-out-channel scales follow the output dim
        "wi_q": P(fsdp, mdl), "wg_q": P(fsdp, mdl), "wd_q": P(mdl, fsdp),
        "wi_s": P(mdl), "wg_s": P(mdl), "wd_s": P(fsdp),
        "we_g_q": we_g, "we_i_q": we_i, "we_o_q": we_o,
        "we_g_s": P(*(we_g[:1] + we_g[2:])),
        "we_i_s": P(*(we_i[:1] + we_i[2:])),
        "we_o_s": P(*(we_o[:1] + we_o[2:])),
        "ws_g": P(None, mdl), "ws_i": P(None, mdl), "ws_o": P(mdl, None),
        "ws_g_q": P(None, mdl), "ws_i_q": P(None, mdl),
        "ws_o_q": P(mdl, None),
        "ws_g_s": P(mdl), "ws_i_s": P(mdl), "ws_o_s": P(None),
        # rwkv time/channel mix
        "wr": P(fsdp, mdl),
        "cm_wk": P(fsdp, mdl), "cm_wv": P(mdl, fsdp), "cm_wr": P(fsdp, None),
        "ddl_A": P(fsdp, None), "ddl_B": P(None, None, fsdp),
        "dec_A": P(fsdp, None), "dec_B": P(None, fsdp),
        # griffin
        "w_x": P(fsdp, mdl), "w_gate": P(fsdp, mdl),
        "conv_w": P(None, mdl),
        "w_a": P(None, mdl), "w_i": P(None, mdl),
        "w_out": P(mdl, fsdp),
        "lam": P(mdl),
        # embeddings
        "embed": P(mdl, fsdp),
        "lm_head": P(fsdp, mdl),
    }


_STACKS = ("blocks", "dense_blocks", "moe_blocks", "rec_blocks",
           "attn_blocks", "tail_rec")


def _spec_for(name: str, ndim: int, stacked: bool, table) -> P:
    spec = table.get(name)
    if spec is None:
        return P()               # norms, scalars, small adapters: replicated
    parts = tuple(spec)
    if stacked:
        parts = (None,) + parts
    # pad/truncate to the tensor's rank (e.g. biases)
    if len(parts) < ndim:
        parts = parts + (None,) * (ndim - len(parts))
    return P(*parts[:ndim])


def rules_for(cfg: ArchConfig, dp, mdl, model_size: Optional[int]):
    """The table ``param_specs`` uses on a mesh whose model axis has
    ``model_size`` ranks (None: no mesh, the EP layout)."""
    if cfg.layout == "dp":
        # pure DP: the model axis is folded into dp by the caller, and no
        # tensor dimension shards over it
        mdl = None
    mode = "ep"
    if cfg.moe is not None and model_size is not None and mdl is not None:
        from repro_torch.models.transformer import moe_mode
        mode = moe_mode(cfg, model_size)
    return _rules(cfg, tuple(dp), mdl, moe_mode=mode)


def param_specs(cfg: ArchConfig, params: Any,
                dp: Tuple[str, ...] = ("data",), mdl: str = "model",
                mesh=None) -> Any:
    """A tree of ``P`` matching ``params`` (nested dicts of tensors or
    arrays).  ``mesh`` (when given) selects the MoE expert layout: EP if
    n_experts divides the model-axis size, expert-TP otherwise; without a
    mesh the EP layout is assumed."""
    size = None if mesh is None or mdl is None else mesh.shape[mdl]
    table = rules_for(cfg, dp, mdl, size)

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,)) for k, v in node.items()}
        if node is None:
            return None
        stacked = any(n in _STACKS for n in names[:-1])
        return _spec_for(names[-1] if names else "", node.ndim, stacked,
                         table)

    return walk(params, ())


def batch_specs(dp: Tuple[str, ...] = ("data",)) -> P:
    """tokens/labels (B, S) sharded over the batch."""
    return P(dp, None)


def cache_specs(cfg: ArchConfig, dp: Tuple[str, ...], mdl: Optional[str]):
    """KV / recurrent cache specs by family (batch over dp, the KV cache's
    time dim or the recurrent width over model)."""
    dp = dp or None           # () → replicated batch (e.g. B = 1 decode)
    if cfg.family == "transformer":
        from repro_torch.models.transformer import KVCache
        # the cache's TIME dim over the model axis (flash-decoding): GQA KV
        # heads rarely divide the axis, T does
        tshard = mdl if (mdl is not None and mdl not in (dp or ())) else None
        kv = P(None, dp, tshard, None, None)    # (L, B, T, KV, hd)
        if cfg.quant_kv:
            sc = P(None, dp, tshard, None)      # (L, B, T, KV) scales
            return KVCache(kv, kv, P(dp), sc, sc)
        return KVCache(kv, kv, P(dp))           # per-row lengths (B,)
    if cfg.family == "rwkv":
        from repro_torch.models.rwkv6 import RwkvCache
        return RwkvCache(P(None, dp, mdl), P(None, dp, None, None, None),
                         P(None, dp, mdl), P())
    if cfg.family == "hybrid":
        from repro_torch.models.griffin import GriffinCache
        return GriffinCache(P(None, dp, None, mdl), P(None, dp, mdl),
                            P(None, dp, None, None, None),
                            P(None, dp, None, None, None), P(dp))
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def local_slices(spec: P, shape, mesh, rank: Optional[int] = None,
                 name: str = "leaf") -> Tuple[slice, ...]:
    """The slice of each dimension of a ``shape`` tensor that ``rank`` (by
    default this one) holds under ``spec``."""
    parts = tuple(spec)
    if len(parts) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than its "
                         f"shape {tuple(shape)}")
    rank = mesh.rank if rank is None else rank
    coords = dict(zip(mesh.axis_names, (int(c) for c in np.unravel_index(
        rank, tuple(mesh.shape.values())))))
    seen = set()
    out = []
    for dim, n in enumerate(shape):
        axes = entry_axes(parts[dim]) if dim < len(parts) else ()
        for a in axes:
            if a not in mesh.shape or a in seen:
                raise ValueError(f"{name}: spec {spec} names axis {a!r} "
                                 f"that the mesh {mesh.shape} lacks, or "
                                 f"twice")
            seen.add(a)
        k = math.prod(mesh.shape[a] for a in axes)
        if n % k:
            raise ValueError(f"{name}: dim {dim} of size {n} does not split "
                             f"over axis {axes} ({k} ways)")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
        out.append(slice(idx * (n // k), (idx + 1) * (n // k)))
    return tuple(out)


def _pairs(full, specs):
    leaves = tree.leaves_with_paths(full)
    spec_leaves = tree.leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"tree of {len(leaves)} leaves against "
                         f"{len(spec_leaves)} specs")
    return leaves, spec_leaves


def shard_tree(full, specs, mesh, device=None):
    """This rank's shard of every leaf of ``full`` (numpy or torch leaves)
    under ``specs`` (a tree of ``P`` of the same structure), as contiguous
    torch tensors on ``device`` (by default the mesh's)."""
    device = mesh.device if device is None else torch.device(device)
    leaves, spec_leaves = _pairs(full, specs)
    out = []
    for (path, leaf), spec in zip(leaves, spec_leaves):
        t = torch.from_numpy(np.asarray(leaf)) \
            if not isinstance(leaf, torch.Tensor) else leaf.detach()
        piece = t[local_slices(spec, t.shape, mesh, name=tree.path_str(path))]
        local = torch.empty(piece.shape, dtype=piece.dtype, device=device)
        out.append(local.copy_(piece))
    return tree.unflatten(tree.structure(full), out)


def gather_leaf(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor of the shard ``t`` (differentiable: each gather's
    backward is a reduce-scatter)."""
    from repro_torch.parallel import collectives as C
    for dim, e in enumerate(spec):
        if e is not None:
            t = C.all_gather(t, mesh, e, dim=dim)
    return t


def gather_tree(local, specs, mesh):
    """Every leaf of ``local`` (this rank's shards) gathered to its full
    shape on every rank."""
    leaves, spec_leaves = _pairs(local, specs)
    return tree.unflatten(tree.structure(local),
                          [gather_leaf(leaf, spec, mesh)
                           for (_, leaf), spec in zip(leaves, spec_leaves)])
