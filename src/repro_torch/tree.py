"""Pytrees of tensors: nested dicts, NamedTuples, lists and tuples.

The port's stand-in for the parts of ``jax.tree_util`` that the training
stack uses.  Leaves are ordered as JAX orders them (dict keys sorted,
NamedTuple fields and sequence items in order), so a path names the same
leaf in both packages, and ``path_str`` spells it as the reference's
checkpoint manifests do ("params/dense_blocks/wq").  ``structure`` is a
JSON description of the containers (a NamedTuple by its import path), from
which ``unflatten`` rebuilds the tree without pickling anything.

``None`` is an empty subtree, as in JAX: it holds no leaf, ``map`` and
``replace`` pass it through, and ``structure``/``unflatten`` keep it in its
place (the int8 KV cache's ``KVCache.k_s``/``v_s`` are ``None`` without
``quant_kv``).
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves_with_paths(tree) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in JAX's order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [((k,) + p, leaf) for k in sorted(tree)
                for p, leaf in leaves_with_paths(tree[k])]
    if _is_namedtuple(tree):
        return [((f,) + p, leaf) for f in tree._fields
                for p, leaf in leaves_with_paths(getattr(tree, f))]
    if isinstance(tree, (list, tuple)):
        return [((i,) + p, leaf) for i, t in enumerate(tree)
                for p, leaf in leaves_with_paths(t)]
    return [((), tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path) or "root"


_NONE = {"none": None}          # an empty subtree; a leaf is plain None


def structure(tree):
    """A JSON-able description of the containers of ``tree``."""
    if tree is None:
        return dict(_NONE)
    if isinstance(tree, dict):
        return {"dict": {k: structure(tree[k]) for k in sorted(tree)}}
    if _is_namedtuple(tree):
        cls = type(tree)
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "items": [structure(getattr(tree, f)) for f in tree._fields]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [structure(t) for t in tree]}
    return None


def unflatten(struct, leaves_in: List[Any]):
    """The tree of ``struct`` with ``leaves_in`` in leaf order."""
    it = iter(leaves_in)

    def build(s):
        if s is None:
            return next(it)
        if s == _NONE:
            return None
        if "dict" in s:
            return {k: build(v) for k, v in s["dict"].items()}
        if "namedtuple" in s:
            mod, name = s["namedtuple"].split(":")
            cls = importlib.import_module(mod)
            for part in name.split("."):
                cls = getattr(cls, part)
            return cls(*(build(v) for v in s["items"]))
        kind, items = next(iter(s.items()))
        return (list if kind == "list" else tuple)(build(v) for v in items)

    out = build(struct)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    others = [leaves(r) for r in rest]
    flat = leaves(tree)
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(structure(tree),
                     [fn(*args) for args in zip(flat, *others)])


def replace(tree, path: tuple, leaf):
    """A copy of the containers along ``path`` with the leaf there
    replaced (the other leaves are shared)."""
    if not path:
        return leaf
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, head: replace(tree[head], rest, leaf)}
    if _is_namedtuple(tree):
        return tree._replace(**{head: replace(getattr(tree, head), rest,
                                              leaf)})
    out = list(tree)
    out[head] = replace(tree[head], rest, leaf)
    return type(tree)(out)
