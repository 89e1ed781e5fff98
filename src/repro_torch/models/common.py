"""Shared model building blocks: norms, RoPE, attention (chunked-causal,
GQA, sliding-window), slot-wise cache plumbing, initializers, the loss.

The counterpart of ``repro.models.common``.  Compute dtype is bf16 by
default with f32 for norms and softmax.  Where the reference multiplies
bf16 operands with ``preferred_element_type=float32`` (attention scores and
the PV product), the port upcasts the operands to f32 and multiplies in
f32: a bf16 ``torch.matmul`` would round its output to bf16.  The
probabilities are rounded to the compute dtype first, as the reference
casts them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """N(0, std^2) drawn from ``gen`` on ``gen.device``, scaled in place:
    a CPU generator gives the numbers it always gave, whatever device the
    caller moves them to; a CUDA generator draws on the card, where the f32
    draw of a large leaf is its only transient copy.  ``gen`` None draws
    nothing: a shape-only tensor on the meta device (the dry-run's
    ``train.steps.abstract_train_state``)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.randn(shape, generator=gen, device=gen.device)
    return t.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) from ``gen``, on ``gen.device``."""
    return _normal(gen, shape, 1.0 / math.sqrt(shape[in_axis]), dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    return _normal(gen, shape, 0.02, dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)     # f32, or f64 for f64
    x = x.to(acc)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.to(acc))).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.promote_types(x.dtype, torch.float32)).chunk(
        2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


NEG_INF = -1e30


def remat_wanted(cfg, leaves) -> bool:
    """Recompute blocks in the backward: ``cfg.remat`` asks for it and a
    gradient will flow into one of ``leaves`` (the blocks' weights)."""
    return (cfg.remat != "none" and torch.is_grad_enabled()
            and any(t.requires_grad for t in leaves))


def recompute(fn, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``: the
    backward recomputes what ``fn`` saved, and only its inputs are kept
    (checkpoints nest).  The bodies it wraps draw no random numbers, so no
    RNG state is stashed."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _q_chunk_sweep(q_i, kc, vc, qi: int, chunk: int, scale: float,
                   window: Optional[int], cdt: torch.dtype):
    """One query chunk's online softmax over its key chunks 0..qi: (B,
    chunk, KV, G, hd) in q_i's dtype (f32, or f64 for the witness), the
    probabilities rounded to the compute dtype ``cdt`` before P·V."""
    B, _, KV, G, hd = q_i.shape
    dt = q_i.dtype
    idx = torch.arange(chunk, device=q_i.device)
    m = torch.full((B, chunk, KV, G), NEG_INF, dtype=dt, device=q_i.device)
    l_sum = torch.zeros((B, chunk, KV, G), dtype=dt, device=q_i.device)
    acc = torch.zeros((B, chunk, KV, G, hd), dtype=dt, device=q_i.device)
    for kj in range(qi + 1):
        s = torch.einsum("bqkgh,bckh->bqkgc", q_i, kc[:, kj]) * scale
        q_pos = qi * chunk + idx
        k_pos = kj * chunk + idx
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1)
        # p rounded to the compute dtype, as the reference casts it
        p = p.to(cdt).to(dt)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p, vc[:, kj])
        m = m_new
    return acc / torch.clamp(l_sum[..., None], min=1e-30)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: Optional[int] = None,
                             chunk: int = 512) -> torch.Tensor:
    """Causal GQA attention with an online softmax over KV chunks.

    q (B, S, H, hd), k/v (B, S, KV, hd).  The reference's algorithm chunk
    by chunk, so the (S, S) score matrix is never materialized; KV chunks
    wholly above the diagonal are skipped (in the reference they add an
    exact zero).  When a gradient flows, each query chunk's sweep runs
    under a checkpoint (``recompute``), as the reference wraps it in
    ``jax.checkpoint(policy=nothing_saveable)``: the backward recomputes
    the chunk's scores and probabilities, so training keeps O(S · chunk)
    per head instead of every score chunk.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    chunk = min(chunk, S)
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    scale = 1.0 / math.sqrt(hd)
    dt = torch.promote_types(q.dtype, torch.float32)   # f64: the witness
    qc = q.reshape(B, n, chunk, KV, G, hd).to(dt)
    kc = k.reshape(B, n, chunk, KV, hd).to(dt)
    vc = v.reshape(B, n, chunk, KV, hd).to(dt)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(n):
        args = (qc[:, qi], kc, vc, qi, chunk, scale, window, q.dtype)
        out = recompute(_q_chunk_sweep, *args) if grad \
            else _q_chunk_sweep(*args)
        outs.append(out.to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(B, n * chunk, H, hd)
    return out[:, :S]


def int8_scores(q_q: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, hd) int8 . (B, T, KV, hd) int8 -> (B, KV, G, T) int32,
    the reference's int8 x int8 -> int32 product.  Taken in float64 on
    every device: |sum| <= hd * 127^2, far below 2^53, so every product
    and partial sum is exact and no TF32 setting reaches it."""
    return torch.einsum("bkgh,btkh->bkgt", q_q.to(torch.float64),
                        k_cache.to(torch.float64)).to(torch.int32)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     t0: int = 0, reduce=None) -> torch.Tensor:
    """Single-token attention over a (ring-buffered) KV cache.

    q (B, 1, H, hd), caches (B, T, KV, hd), cur_len (B,) valid slots.
    With ``k_scale``/``v_scale`` (B, T, KV) the caches are int8: q is
    quantized per (b, kv, g) row, the scores are the exact int32 product
    (``int8_scores``) rescaled by q's and each row's k scale, and V is
    dequantized page-wide to q's dtype, as in the reference.

    Flash-decoding: a cache whose time dim is sharded over more than one
    rank passes this rank's slots (the first at global slot ``t0``) and
    ``reduce(t, op)``, the "max" or "sum" over the shards; the softmax is
    then written out, exp(s − max) over its sum, with the row max and the
    sum made global before P is formed, and the partial P·V are summed.
    """
    B, T, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    acc = torch.promote_types(q.dtype, torch.float32)   # f64: the witness
    qg = q.reshape(B, KV, G, hd).to(acc)
    if k_scale is not None:
        q_s = torch.clamp(qg.abs().amax(dim=-1), min=1e-8) / 127.0
        q_q = torch.clamp(torch.round(qg / q_s[..., None]), -127,
                          127).to(torch.int8)
        ks_t = k_scale.movedim(1, 2)[:, :, None, :]          # (B, KV, 1, T)
        s = (int8_scores(q_q, k_cache).to(torch.float32) * q_s[..., None]
             * ks_t * scale)
        v_cache = (v_cache.to(torch.float32)
                   * v_scale[..., None]).to(q.dtype)
    else:
        s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.to(acc)) * scale
    valid = (torch.arange(T, device=q.device) + t0)[None, :] \
        < cur_len.reshape(-1).expand(B)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if reduce is None:
        p = torch.softmax(s, dim=-1)
    else:
        m = reduce(s.amax(dim=-1, keepdim=True), "max")
        p = torch.exp(s - m)
        p = p / reduce(p.sum(dim=-1, keepdim=True), "sum")
    p = p.to(v_cache.dtype).to(acc)
    out = torch.einsum("bkgt,btkh->bkgh", p, v_cache.to(acc))
    if reduce is not None:
        out = reduce(out, "sum")
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cache_write_slot(batch_cache, one_cache, slot: int, n: int):
    """Copy a single-request prefill cache into row ``slot`` of a batch
    cache, in place, and return the batch cache — the splice that lets a
    request join a live decode batch (runtime/dataflow's DecodeStage).

    Leaves are (L, B, T, ...) (batch at dim 1; a shorter one-request time
    axis is copied as a prefix, the rest of the row zeroed), a (B,) int
    per-row length vector (set to ``n``), or a scalar counter (maxed);
    a ``None`` field (no int8 scales) is skipped.
    """
    for bc, oc in zip(batch_cache, one_cache):
        if bc is None:
            continue
        if bc.dim() == 0:
            bc.copy_(torch.maximum(bc, oc))
        elif bc.dim() == 1 and not bc.is_floating_point():
            bc[slot] = n
        else:
            t = oc.shape[2]
            bc[:, slot, :t].copy_(oc[:, 0])
            bc[:, slot, t:].zero_()
    return batch_cache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       psum=None, n_shards: int = 1) -> torch.Tensor:
    """Mean next-token CE.  logits (B, S, V) any float dtype, upcast to
    f32; labels (B, S) int; ``mask`` (B, S) weights the tokens.  The gold
    logit is a gather whose backward adds one term into each zeroed row,
    so it is exact in any order.  A batch sharded over ``n_shards`` equal
    slices passes ``psum``, the sum over them: the mean is then the mean
    of the slices' means (the masked one the global sums' quotient)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _mean_nll(logz - gold, mask, psum, n_shards)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 v_lo: int, vmax, vsum,
                                 mask: Optional[torch.Tensor] = None,
                                 psum=None, n_shards: int = 1
                                 ) -> torch.Tensor:
    """``cross_entropy_loss`` of the whole-vocabulary logits, from this
    rank's columns ``[v_lo, v_lo + V_loc)`` (``logits`` (B, S, V_loc)).
    ``vmax`` is the MAX over the vocabulary's shards, ``vsum`` the SUM,
    differentiable with its exact adjoint (``collectives.all_reduce``).
    The row max is the global MAX of the local maxima, outside the
    gradient as ``jax.nn.logsumexp`` keeps it; Σ exp(x − max) is the SUM
    of the local sums; the gold logit is the local gather where the label
    falls in this rank's columns, else 0, SUMmed (one nonzero term).  So
    the logits' gradient is each column's softmax minus its one-hot, and
    no rank holds a row whole.  ``mask``, ``psum`` and ``n_shards`` as in
    ``cross_entropy_loss``."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    m = vmax(logits.detach().amax(dim=-1))
    m = torch.where(torch.isinf(m), 0.0, m)      # as torch.logsumexp
    logz = torch.log(vsum(torch.exp(logits - m[..., None]).sum(dim=-1))) + m
    local = labels.long() - v_lo
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1,
                        torch.where(mine, local, 0)[..., None])[..., 0]
    gold = vsum(torch.where(mine, gold, 0.0))
    return _mean_nll(logz - gold, mask, psum, n_shards)


def _mean_nll(nll: torch.Tensor, mask, psum, n_shards: int) -> torch.Tensor:
    """The mean of the per-token ``nll`` (``cross_entropy_loss``'s)."""
    if mask is not None:
        mask = mask.to(nll.dtype)
        num, den = torch.sum(nll * mask), torch.sum(mask)
        if psum is not None:
            num, den = psum(num), psum(den)
        return num / torch.clamp(den, min=1.0)
    loss = torch.mean(nll)
    return loss if psum is None else psum(loss) / n_shards
