"""Recompute in the backward, held against the reference and against the
port without it.

* rwkv6 and griffin: with ``remat="save_dots"`` the loss and every
  gradient are ``torch.equal`` to ``remat="none"``, and both are held
  against ``jax.value_and_grad`` of the reference's ``loss_fn`` under
  ``save_dots`` on the same numpy weights and tokens (2e-4 relative and
  absolute, ``tests/test_torch_train.py``'s gradient tolerance); the
  forward's logits are ``torch.equal`` with and without remat and without
  a gradient; griffin's super-blocks are recomputed in the backward and its
  tail is not, as in the reference.
* Saved for the backward (the bytes of the distinct storages that
  ``torch.autograd.graph.saved_tensors_hooks`` sees, parameters left out):
  under remat at most each recomputed block's input, plus what the
  layers outside a checkpoint (the embedding, griffin's tail, the head
  and the loss) save, and at most ``REMAT_SAVED_RATIO`` of the count
  without remat.
* ``common.chunked_causal_attention``: output and q/k/v gradients against
  ``jax.value_and_grad`` through ``repro.models.common``'s function (f32
  within ``ATTN_TOL``; bf16 within ``ATTN_BF16_TOL``, two bf16 steps), and
  ``torch.equal`` to the values of the implementation that kept every
  score chunk (``tests/data/chunked_attention_saved.npz``, written by
  ``python tests/test_torch_remat.py`` on commit 16ea621's port, before
  the per-chunk recompute).  The bytes saved for the backward grow about
  linearly in S at a fixed chunk (at most ``LINEAR_GROWTH`` per doubling,
  where keeping every chunk grows them about 4×), with a window too; inside
  a transformer block's checkpoint the tracked peak of a whole forward and
  backward (``launch.op_analysis``) grows the same way.

Every case runs torch on one intra-op thread: the saved values were taken
so, and one thread fixes each CPU kernel's order of sums.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch import tree
from repro_torch.models import common, griffin
from test_torch_rwkv_griffin import FAMILIES, _randomise_zeros

jax.config.update("jax_platform_name", "cpu")

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
LINEAR_GROWTH = 2.2
REMAT_SAVED_RATIO = 0.05
SAVED = os.path.join(os.path.dirname(__file__), "data",
                     "chunked_attention_saved.npz")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the two families

# test_torch_rwkv_griffin's configs (remat "save_dots", the default):
# rwkv6 at 2 layers, griffin at 5 (one (rec, rec, attn) super-block and a
# tail of two rec layers), d_model 32, f32
B, S = 2, 40       # two WKV chunks of 32; past griffin's window of 8


@functools.lru_cache(maxsize=None)
def _setup(family):
    jmod, _, _, jcfg_fn, tcfg_fn = FAMILIES[family]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    assert jcfg.remat == tcfg.remat == "save_dots"
    host = _randomise_zeros(jax.device_get(
        jmod.init_params(jcfg, jax.random.key(0))), seed=7)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size,
                                             (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, tcfg, host, batch


def _live(tcfg, host, family):
    """The port's parameters from the numpy tree, every leaf a fresh leaf
    that takes a gradient."""
    params = FAMILIES[family][2](host, device="cpu")
    return tree.map(lambda t: t.detach().requires_grad_(), params)


def _loss_and_grads(family, remat):
    _, tcfg, host, batch = _setup(family)
    cfg = dataclasses.replace(tcfg, remat=remat)
    params = _live(cfg, host, family)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = FAMILIES[family][1].loss_fn(cfg, params, tb)
    leaves = tree.leaves(params)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_equals_none_and_the_reference(family):
    jcfg, _, host, batch = _setup(family)
    loss, grads = _loss_and_grads(family, "save_dots")
    loss0, grads0 = _loss_and_grads(family, "none")
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    jmod = FAMILIES[family][0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_fn(jcfg, p, jb)[0]))(
            jax.tree_util.tree_map(jnp.asarray, host))
    np.testing.assert_allclose(float(loss), float(jl), **GRAD_TOL)
    # the reference's gradients in the port's tree, leaf for leaf
    want = FAMILIES[family][2](jax.device_get(jg), device="cpu")
    paths = tree.leaves_with_paths(want)
    assert len(paths) == len(grads)
    for (path, j), g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), j.numpy(),
                                   err_msg=tree.path_str(path), **GRAD_TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_unchanged_by_remat(family):
    _, tcfg, host, batch = _setup(family)
    tmod = FAMILIES[family][1]
    toks = torch.from_numpy(batch["tokens"])
    out = {}
    for remat in ("none", "save_dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = tmod.forward(cfg, _live(cfg, host, family),
                                  toks).logits.detach()
    with torch.no_grad():
        plain = tmod.forward(tcfg, FAMILIES[family][2](host, device="cpu"),
                             toks).logits
    assert torch.equal(out["save_dots"], out["none"])
    assert torch.equal(out["save_dots"], plain)


def test_griffin_recomputes_super_blocks_not_its_tail(monkeypatch):
    """Forward runs 4 rec blocks and 1 attention block; the backward
    recomputes the super-block's 2 rec blocks and its attention block and
    none of the tail's (the reference's ``tail_body`` is not wrapped)."""
    calls = {"rec": 0, "attn": 0}
    rec, attn = griffin._rec_block, griffin._attn_full

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(griffin, "_rec_block", count("rec", rec))
    monkeypatch.setattr(griffin, "_attn_full", count("attn", attn))
    _, tcfg, host, batch = _setup("griffin")
    params = _live(tcfg, host, "griffin")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = griffin.loss_fn(tcfg, params, tb)
    assert calls == {"rec": 4, "attn": 1}
    torch.autograd.grad(loss, tree.leaves(params))
    assert calls == {"rec": 6, "attn": 2}


def _saved_bytes(fn, exclude=()):
    """``fn()`` under ``saved_tensors_hooks``: its result and the bytes of
    the distinct storages its graph saved, those of ``exclude`` left
    out."""
    skip = {t.untyped_storage().data_ptr() for t in exclude}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def _ends_saved(family, cfg, params, tb):
    """What the layers outside a checkpoint save: the embedding, griffin's
    tail, the head and the loss, each run on its own."""
    from repro_torch.models.shard import cross_entropy
    from repro_torch.models.transformer import _inputs, _logits
    leaves = tree.leaves(params)
    x = _inputs(cfg, params, tb["tokens"])
    _, emb = _saved_bytes(lambda: _inputs(cfg, params, tb["tokens"]), leaves)
    xs = x.detach().requires_grad_()
    tail = 0
    if family == "griffin":
        _, tail_layers = griffin._super_blocks(cfg, params)
        pos = torch.arange(S)[None, :]
        _, tail = _saved_bytes(
            lambda: griffin._run(cfg, tail_layers, xs, pos), leaves)
    _, head = _saved_bytes(lambda: cross_entropy(
        None, _logits(cfg, params, xs), tb["labels"]), leaves)
    return emb + tail + head, x.numel() * x.element_size()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_saves_block_inputs_only(family):
    """Beyond what the embedding, griffin's tail, the head and the loss
    save, remat keeps each recomputed block's inputs (x, and griffin's
    positions) and nothing else: at most REMAT_SAVED_RATIO of what the
    same blocks keep without remat (here ~0.01)."""
    _, tcfg, host, batch = _setup(family)
    tmod = FAMILIES[family][1]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    saved = {}
    for remat in ("none", "save_dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _live(cfg, host, family)
        _, saved[remat] = _saved_bytes(
            lambda: tmod.loss_fn(cfg, params, tb), tree.leaves(params))
    ends, x_bytes = _ends_saved(family, tcfg, params, tb)
    if family == "rwkv":
        blocks, inputs = tcfg.n_layers, x_bytes
    else:
        blocks, inputs = tcfg.n_layers // 3, x_bytes + S * 8
    kept = {k: v - ends for k, v in saved.items()}
    assert 0 < kept["save_dots"] <= blocks * inputs
    assert kept["save_dots"] <= REMAT_SAVED_RATIO * kept["none"]


# ------------------------------------------------- chunked attention

ATTN_CASES = {     # B, S (not a multiple of the chunk), H, KV, hd, chunk
    "causal": dict(shape=(1, 72, 4, 2, 8), chunk=16, window=None,
                   dtype="float32"),
    "window": dict(shape=(1, 72, 4, 2, 8), chunk=16, window=24,
                   dtype="float32"),
    "bf16_window": dict(shape=(1, 72, 4, 2, 8), chunk=16, window=24,
                        dtype="bfloat16"),
}


def _attn_inputs(case, S=None):
    """q, k, v and the output's cotangent, numpy f32 from a seed (rounded
    to bf16 for a bf16 case)."""
    b, s, h, kv, hd = ATTN_CASES[case]["shape"]
    s = S or s
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    if ATTN_CASES[case]["dtype"] == "bfloat16":
        q, k, v, dy = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                       for a in (q, k, v, dy))
    return q, k, v, dy


def attention_values(case, S=None):
    """The port's output and q/k/v gradients of ``sum(out * dy)`` (numpy
    f32)."""
    c = ATTN_CASES[case]
    dt = getattr(torch, c["dtype"])
    q, k, v, dy = (torch.from_numpy(a).to(dt) for a in _attn_inputs(case, S))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = common.chunked_causal_attention(q, k, v, window=c["window"],
                                          chunk=c["chunk"])
    grads = torch.autograd.grad(out, (q, k, v), dy)
    return {n: t.detach().float().numpy()
            for n, t in zip(("out", "dq", "dk", "dv"), (out,) + grads)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_the_reference(case):
    c = ATTN_CASES[case]
    got = attention_values(case)
    jdt = jnp.dtype(c["dtype"])
    q, k, v, dy = (jnp.asarray(a, jdt) for a in _attn_inputs(case))

    def f(q, k, v):
        out = jcommon.chunked_causal_attention(q, k, v, window=c["window"],
                                               chunk=c["chunk"])
        return jnp.sum(out.astype(jnp.float32) * dy.astype(jnp.float32)), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    bf16 = c["dtype"] == "bfloat16"
    for name, want in zip(("out", "dq", "dk", "dv"), (out,) + grads):
        tol = ATTN_BF16_TOL if bf16 else \
            ATTN_TOL if name == "out" else ATTN_GRAD_TOL
        np.testing.assert_allclose(got[name],
                                   np.asarray(want.astype(jnp.float32)),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_equals_saved_values(case):
    saved = np.load(SAVED)
    for name, got in attention_values(case).items():
        np.testing.assert_array_equal(got, saved[f"{case}/{name}"],
                                      err_msg=name)


def _attn_saved_bytes(case, S):
    c = ATTN_CASES[case]
    dt = getattr(torch, c["dtype"])
    q, k, v, _ = (torch.from_numpy(a).to(dt).requires_grad_()
                  for a in _attn_inputs(case, S))
    _, n = _saved_bytes(lambda: common.chunked_causal_attention(
        q, k, v, window=c["window"], chunk=c["chunk"]))
    return n


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_saves_linear_in_s(case):
    """S 128 → 256 → 512 at chunk 16: every doubling at most
    LINEAR_GROWTH× the bytes (keeping every score chunk: about 4×)."""
    n = [_attn_saved_bytes(case, s) for s in (128, 256, 512)]
    assert all(0 < a and b <= LINEAR_GROWTH * a for a, b in zip(n, n[1:])), n


def test_chunked_attention_inside_a_block_checkpoint(monkeypatch):
    """A 2-layer f32 transformer (window 24) under ``remat="save_dots"``
    (each block checkpointed, the attention's per-chunk checkpoints nested
    in it), attention chunk 16: loss and gradients ``torch.equal`` to
    ``remat="none"``, and the tracked peak of one forward and backward
    (``launch.op_analysis``, parameters left out) at most LINEAR_GROWTH×
    per doubling of S from 64 to 256 (keeping every score chunk: 2.5× from
    128 to 256)."""
    from repro_torch.configs import registry
    from repro_torch.launch import op_analysis
    from repro_torch.models import api
    from repro_torch.models.config import reduced
    attn = common.chunked_causal_attention
    monkeypatch.setattr(common, "chunked_causal_attention",
                        functools.partial(attn, chunk=16))
    cfg = dataclasses.replace(reduced(registry.get("smollm-135m")),
                              compute_dtype="float32", swa_window=24)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    peaks = []
    for s in (64, 128, 256):
        toks = torch.randint(0, cfg.vocab_size, (1, s + 1),
                             generator=torch.Generator().manual_seed(s))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        res = {}
        for remat in ("save_dots", "none") if s == 64 else ("save_dots",):
            c = dataclasses.replace(cfg, remat=remat)
            live = tree.map(lambda t: t.detach().requires_grad_(), params)

            def step():
                loss, _ = api.loss_fn(c, live, batch)
                return loss.detach(), torch.autograd.grad(
                    loss, tree.leaves(live))
            (loss, grads), an = op_analysis.analyze(step)
            res[remat] = (loss, grads)
            if remat == "save_dots":
                peaks.append(an.peak_live_bytes)
        if "none" in res:
            assert torch.equal(res["none"][0], res["save_dots"][0])
            assert all(torch.equal(a, b)
                       for a, b in zip(res["none"][1], res["save_dots"][1]))
    assert all(b <= LINEAR_GROWTH * a for a, b in zip(peaks, peaks[1:])), \
        peaks


if __name__ == "__main__":
    # Writes SAVED from whichever ``repro_torch`` is on the path (run on
    # the implementation that kept every score chunk).
    torch.set_num_threads(1)
    os.makedirs(os.path.dirname(SAVED), exist_ok=True)
    np.savez_compressed(SAVED, **{f"{case}/{n}": a
                                  for case in ATTN_CASES
                                  for n, a in attention_values(case).items()})
