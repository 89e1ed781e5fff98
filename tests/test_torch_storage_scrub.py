"""The storage scrub's per-leaf checksums and the pytree rules under them.

``repro_torch.tree`` treats ``None`` as JAX treats it, an empty subtree:
the leaf lists and paths equal ``jax.tree_util.tree_leaves_with_path``'s
on the reference's ``KVCache`` with and without int8 scales, and a tree
with ``None`` survives ``structure``/``unflatten``.  ``storage_checksums``
equals the reference's uint32 per leaf on f32, bf16, int8 and int32 leaves
and on both caches; ``verify_storage`` flags exactly the struck leaf, at
every bit of every width."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.models import transformer as jtransformer
from repro_torch import tree
from repro_torch.core import abft
from repro_torch.core import fault_injection as fi
from repro_torch.models import transformer

jax.config.update("jax_platform_name", "cpu")


def _key_str(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_paths(t):
    return [tuple(_key_str(k) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(t)]


def _t(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _caches(quant_kv: bool):
    """The same cache in both packages: (reference KVCache, port's)."""
    rng = np.random.default_rng(int(quant_kv))
    shape = (2, 3, 5, 2, 4)
    if quant_kv:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0, 1, shape[:-1]).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=shape).astype(jnp.bfloat16)
                for _ in range(2))
        ks = vs = None
    length = np.array([3, 0, 5], np.int32)
    jc = jtransformer.KVCache(*(None if a is None else jnp.asarray(a)
                                for a in (k, v, length, ks, vs)))
    tc = transformer.KVCache(*(None if a is None else _t(a)
                               for a in (k, v, length, ks, vs)))
    return jc, tc


@pytest.mark.parametrize("quant_kv", [False, True])
def test_tree_treats_none_as_jax_does(quant_kv):
    jc, tc = _caches(quant_kv)
    paths = [p for p, _ in tree.leaves_with_paths(tc)]
    assert [tuple(map(str, p)) for p in paths] == _jax_paths(jc)
    assert len(tree.leaves(tc)) == len(jax.tree_util.tree_leaves(jc)) \
        == (5 if quant_kv else 3)
    nested = {"b": [None, tc], "a": None, "c": (tc.length, None)}
    jnested = {"b": [None, jc], "a": None, "c": (jc.length, None)}
    assert [tuple(map(str, p)) for p, _ in tree.leaves_with_paths(nested)] \
        == _jax_paths(jnested)
    # None survives the structure round trip and map
    back = tree.unflatten(tree.structure(nested), tree.leaves(nested))
    assert back["a"] is None and back["b"][0] is None
    assert back["c"][1] is None
    assert (back["b"][1].k_s is None) == (not quant_kv)
    cloned = tree.map(torch.clone, nested)
    assert cloned["a"] is None and cloned["b"][0] is None
    assert (cloned["b"][1].k_s is None) == (not quant_kv)
    assert torch.equal(cloned["b"][1].k, tc.k) and cloned["b"][1].k is not tc.k
    # a tree without None keeps the structure it always had
    assert tree.structure({"w": tc.k}) == {"dict": {"w": None}}


def _mixed_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w32": rng.normal(size=(32, 16)).astype(np.float32),
        "wbf": rng.normal(size=(7, 9)).astype(jnp.bfloat16),
        "q8": rng.integers(-128, 128, (64,)).astype(np.int8),
        "i32": rng.integers(-2**31, 2**31, (5, 3), dtype=np.int64)
        .astype(np.int32),
        "blocks": {"neg": np.full((4,), -1, np.int8),
                   "s": np.array(-0.0, np.float32)},
    }


def _check_equal(got, want):
    gl = tree.leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == () and g.dtype == torch.int64
        assert int(g) == int(np.asarray(w))          # the uint32 value


def test_storage_checksums_equal_reference_per_leaf():
    p = _mixed_params()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = tree.map(_t, p)
    _check_equal(abft.storage_checksums(tp), jabft.storage_checksums(jp))
    for quant_kv in (False, True):
        jc, tc = _caches(quant_kv)
        _check_equal(abft.storage_checksums(tc),
                     jabft.storage_checksums(jc))
    # sums that wrap past 2^32: all-ones words
    big = {"u": np.full((1000,), -1, np.int32),
           "h": np.full((70000,), -1, np.int16)}
    _check_equal(abft.storage_checksums(tree.map(_t, big)),
                 jabft.storage_checksums(
                     jax.tree_util.tree_map(jnp.asarray, big)))


@pytest.mark.parametrize("leaf", ["w32", "wbf", "q8", "i32", "blocks/neg",
                                  "blocks/s"])
def test_verify_storage_flags_exactly_the_struck_leaf(leaf):
    tp = tree.map(_t, _mixed_params())
    checks = abft.storage_checksums(tp)
    ok = abft.verify_storage(tp, checks)
    assert all(bool(v) for v in tree.leaves(ok))
    path = tuple(leaf.split("/"))
    x = dict(tree.leaves_with_paths(tp))[path]
    width = x.element_size() * 8
    for bit in range(width):
        idx = (bit * 7) % x.numel()
        struck = fi.inject_leaf_with(
            tp, path, None, lambda v, _: fi.flip_bit_at_index(v, idx, bit))
        flags = dict(tree.leaves_with_paths(
            abft.verify_storage(struck, checks)))
        assert [p for p, f in flags.items() if not bool(f)] == [path], bit
    # the strike copied the leaf: the original tree still verifies
    assert all(bool(v) for v in tree.leaves(abft.verify_storage(tp, checks)))


def test_storage_checksum_refuses_leaves_past_its_exact_range():
    class Huge:
        def numel(self):
            return 2**31

    with pytest.raises(ValueError, match="2\\^31"):
        abft._leaf_checksum(Huge())


def test_inject_leaf_with_strikes_the_named_cache_leaf():
    _, tc = _caches(True)
    struck = fi.inject_leaf_with(
        tc, ("k_s",), None, lambda v, _: fi.flip_bit_at_index(v, 3, 30))
    assert struck.k is tc.k and struck.v_s is tc.v_s
    assert not torch.equal(struck.k_s, tc.k_s)
    assert type(struck) is type(tc)
