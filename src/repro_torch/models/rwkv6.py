"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
per-channel decay.

The counterpart of ``repro.models.rwkv6``: the same parameter dict (layers
stacked on axis 0 of ``params["blocks"]``), the same ``RwkvCache`` and the
same arithmetic.  Layer = time-mix (WKV6 recurrence) + channel-mix, both
with token-shift and Finch's low-rank data-dependent interpolation
(ddlerp).

WKV6 per head (state S ∈ R^{hd×hd}):
    o_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ ,   w_t = exp(-exp(ŵ(x_t)))  ∈ (0,1)

Two implementations, as in the reference:
  * ``wkv_scan``    — token-recurrent loop (oracle; the decode path);
  * ``wkv_chunked`` — chunk-parallel form (training/prefill): within a chunk
                      the decay products become a C×C score matrix (exp of
                      cumsum differences around a mid-chunk offset, in f32),
                      so each chunk is dense matmul work; chunks are chained
                      by carrying S.

Remat: with ``cfg.remat`` other than "none" and a gradient to take,
``forward`` runs each layer (its cast to the compute dtype and, under a
``ShardCtx``, its weight gather included) under a non-reentrant
checkpoint, where the reference wraps the layer body in ``jax.checkpoint``.
The backward then recomputes the layer, the chunked WKV's C×C score
tensors included, and the forward keeps each layer's input only; the
gather runs again in the backward, as the reference's remat under FSDP
gathers again.  ``save_dots`` recomputes the whole body, as ``full`` does
(the reference's policy keeps the matmul outputs).  Training runs on the
card (``train.steps.make_train_step``, ``chip_smoke.py``).

Tensor parallelism: under a ``ShardCtx`` whose model axis has m > 1
ranks and divides the H heads (``_tp``), each rank runs its H/m heads
from the weights as the reference's specs lay them out: ``wr``, ``wk``,
``wv``, ``wg`` and ``cm_wk`` by columns, ``wo`` and ``cm_wv`` by rows and
summed over the axis, ``cm_wr`` and the ddlerp whole (its inputs are the
replicated residual stream).  ``u``, ``ln_x``, ``w0`` and ``dec_B``'s
output columns, which the specs replicate, are sliced to the local heads
after their gather.  The heads are independent, so the WKV and the group
norm are exact on them.  The decode cache keeps the reference's layout,
the WKV state replicated over the axis: a tensor-parallel layer steps its
own heads' state and all-gathers the new one over the axis once per layer
and step (B·H·hd² floats), the price of that layout.  Otherwise (one
model rank, ``layout="dp"``, or an axis that does not divide H) each
layer's weights are gathered whole.

Differences from the reference: the ``lax.scan`` over layers (and over
chunks and tokens) is a Python loop, and ``decode_step`` writes the new
state into ``cache`` in place, as the port's transformer writes its KV
cache.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import common
from repro_torch.models.config import ArchConfig
from repro_torch.models.shard import cross_entropy, sharded
from repro_torch.models.transformer import (ForwardOut, _cast_layers,
                                            _cdt, _inputs, _layers, _logits,
                                            _pdt)

LORA_R = 16          # ddlerp low-rank dim
DECAY_LORA_R = 32


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The WKV arithmetic's dtype: f32, or f64 under a float64 compute dtype
    (the precision witness)."""
    return torch.promote_types(dt, torch.float32)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """The reference's parameter dict, drawn from ``gen`` on its device
    (a CPU generator draws what it always drew) and moved to ``device``."""
    dev = resolve_device(device)
    d, L, V, ff = cfg.d_model, cfg.n_layers, cfg.vocab_size, cfg.d_ff
    hd = cfg.recurrent.head_dim
    H = d // hd
    pdt = _pdt(cfg)

    def stack(shape):
        return common.dense_init(gen, (L,) + shape, in_axis=1, dtype=pdt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt)

    # decay init: moderate decay so both scan and chunked paths are in a
    # healthy numeric range
    w0 = torch.linspace(-6.0, -0.5, d)[None, :].repeat(L, 1).to(pdt)
    params = {
        "embed": common.embed_init(gen, (V, d), dtype=pdt),
        "final_norm": zeros(d),
        "lm_head": common.dense_init(gen, (d, V), dtype=pdt),
        "blocks": {
            "ln1": zeros(L, d), "ln2": zeros(L, d),
            "mu_x": zeros(L, d), "mu": zeros(L, 5, d),   # per {w,k,v,r,g}
            "ddl_A": stack((d, 5 * LORA_R)),
            "ddl_B": stack((5, LORA_R, d)) * 0.0,
            "wr": stack((d, d)), "wk": stack((d, d)), "wv": stack((d, d)),
            "wg": stack((d, d)), "wo": stack((d, d)),
            "w0": w0,
            "dec_A": stack((d, DECAY_LORA_R)),
            "dec_B": stack((DECAY_LORA_R, d)) * 0.0,
            "u": zeros(L, H, hd),
            "ln_x": zeros(L, d),                          # per-head norm
            "cm_mu_k": zeros(L, d), "cm_mu_r": zeros(L, d),
            "cm_wk": stack((d, ff)), "cm_wv": stack((ff, d)),
            "cm_wr": stack((d, d)),
        },
    }
    return {k: ({n: t.to(dev) for n, t in v.items()}
                if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------


def wkv_scan(r, k, v, w, u, s0=None):
    """Token-recurrent oracle. r,k,v,w: (B, T, H, hd) f32; u: (H, hd).

    Returns (o (B,T,H,hd), s_final (B,H,hd,hd))."""
    B, T, H, hd = r.shape
    s = s0 if s0 is not None else torch.zeros(
        (B, H, hd, hd), dtype=r.dtype, device=r.device)
    outs = []
    for t in range(T):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]      # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                 s + u[None, :, :, None] * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 32):
    """Chunk-parallel WKV6. Same contract as wkv_scan (f32 inputs)."""
    B, T, H, hd = r.shape
    C = min(chunk, T)
    n = -(-T // C)
    Tp = n * C
    if Tp != T:
        pad = (0, 0, 0, 0, 0, Tp - T)
        r, k, v = (F.pad(t, pad) for t in (r, k, v))
        w = F.pad(w, pad, value=1.0)                    # pad decay = identity
    s = s0 if s0 is not None else torch.zeros(
        (B, H, hd, hd), dtype=r.dtype, device=r.device)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    outs = []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rr, kk, vv, ww = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
        lw = torch.log(torch.clamp(ww, min=1e-24))      # ≤ 0
        L = torch.cumsum(lw, dim=1)                     # inclusive
        E = L - lw                                      # exclusive
        mid = L[:, -1:] * 0.5                           # per-channel offset
        r_s = rr * torch.exp(E - mid)                   # bounded by exp(|Lc|/2)
        k_s = kk * torch.exp(mid - L)
        # intra-chunk scores s[t, i] = Σ_c r_s[t, c] k_s[i, c] (strict lower)
        scores = torch.einsum("bthc,bihc->bhti", r_s, k_s)
        scores = torch.where(mask[None, None], scores, 0.0)
        o = torch.einsum("bhti,bihv->bthv", scores, vv)
        # current-token bonus
        o = o + torch.einsum("bthc,bthc,bthv->bthv", rr * u[None, None], kk,
                             vv)
        # inter-chunk: o_t += (r ⊙ Π_{j<t} w) · S0
        o = o + torch.einsum("bthk,bhkv->bthv", rr * torch.exp(E), s)
        # state to next chunk: S = diag(ΠW) S0 + Σ_i (Π_{j>i} w ⊙ k_i) v_iᵀ
        decay_all = torch.exp(L[:, -1])                 # (B, H, hd)
        k_tail = kk * torch.exp(L[:, -1:] - L)          # Π_{j>i} w  ≤ 1
        s = decay_all[..., :, None] * s + torch.einsum("bihk,bihv->bhkv",
                                                       k_tail, vv)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :T], s


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ddlerp(bp, x, xx):
    """Finch data-dependent interpolation → 5 mixed inputs (w,k,v,r,g)."""
    diff = xx - x
    x_mix = x + diff * bp["mu_x"]
    lo = torch.tanh(x_mix @ bp["ddl_A"])                # (B,T,5R)
    B_, T_, _ = lo.shape
    lo = lo.reshape(B_, T_, 5, LORA_R)
    delta = torch.einsum("btfr,frd->btfd", lo, bp["ddl_B"])
    mixed = x[:, :, None] + diff[:, :, None] * (bp["mu"][None, None] + delta)
    return [mixed[:, :, i] for i in range(5)]           # w,k,v,r,g


def _time_mix(cfg, bp, x, use_chunked: bool, state=None, sh=None):
    """x: (B, T, d). state: (x_prev (B,d), S (B,H,hd,hd)) for decode.
    Under ``sh`` (the layer tensor-parallel, ``_tp``) ``bp``'s ``wr``,
    ``wk``, ``wv``, ``wg`` are this rank's columns and ``wo`` its rows:
    the WKV and the group norm run on its H/m heads (``u``, ``ln_x``,
    ``w0`` and ``dec_B``'s columns sliced to them, and S to them on the
    way in), ``wo``'s product is summed over the axis, and the returned S
    is this rank's heads'."""
    B, T, d = x.shape
    hd = cfg.recurrent.head_dim
    h = common.rms_norm(x, bp["ln1"], cfg.norm_eps)
    x_prev = state[0] if state is not None else torch.zeros(
        (B, d), dtype=h.dtype, device=h.device)
    xx = torch.cat([x_prev[:, None].to(h.dtype), h[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(bp, h, xx)
    w0, dec_b, u, ln_x = bp["w0"], bp["dec_B"], bp["u"], bp["ln_x"]
    s0 = state[1] if state is not None else None
    if sh is not None:                 # this rank's heads
        w0, dec_b, ln_x = (sh.model_slice(t) for t in (w0, dec_b, ln_x))
        u = sh.model_slice(u, 0)
        s0 = None if s0 is None else sh.model_slice(s0, 1)

    acc = _acc_dtype(h.dtype)
    r = (xr @ bp["wr"]).reshape(B, T, -1, hd).to(acc)
    k = (xk @ bp["wk"]).reshape(B, T, -1, hd).to(acc)
    v = (xv @ bp["wv"]).reshape(B, T, -1, hd).to(acc)
    g = F.silu(xg @ bp["wg"])
    H = r.shape[2]

    logw = w0[None, None] + torch.tanh(xw @ bp["dec_A"]) @ dec_b
    w = torch.exp(-torch.exp(logw.to(acc))).reshape(B, T, H, hd)
    u = u.to(acc)

    if use_chunked and T > 1:
        o, s = wkv_chunked(r, k, v, w, u, s0)
    else:
        o, s = wkv_scan(r, k, v, w, u, s0)

    # per-head group norm
    o = common.rms_norm(o, ln_x.reshape(H, hd), cfg.norm_eps)
    o = o.reshape(B, T, H * hd).to(x.dtype) * g
    y = o @ bp["wo"]
    return x + (y if sh is None else sh.row.sum(y)), (h[:, -1], s)


def _channel_mix(cfg, bp, x, state=None, sh=None):
    """Under ``sh`` ``cm_wk`` is this rank's d_ff/m columns and ``cm_wv``
    its rows, summed over the axis; ``cm_wr`` is whole."""
    B, T, d = x.shape
    h = common.rms_norm(x, bp["ln2"], cfg.norm_eps)
    x_prev = state if state is not None else torch.zeros(
        (B, d), dtype=h.dtype, device=h.device)
    xx = torch.cat([x_prev[:, None].to(h.dtype), h[:, :-1]], dim=1)
    xk = h + (xx - h) * bp["cm_mu_k"]
    xr = h + (xx - h) * bp["cm_mu_r"]
    kk = torch.square(torch.relu(xk @ bp["cm_wk"]))
    r = torch.sigmoid(xr @ bp["cm_wr"])
    y = kk @ bp["cm_wv"]
    return x + r * (y if sh is None else sh.row.sum(y)), h[:, -1]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _tp(cfg, sh):
    """``sh`` where the layers run tensor-parallel: the model axis has more
    than one rank and divides the heads (else None: gathered whole)."""
    H = cfg.d_model // cfg.recurrent.head_dim
    return sh if sh is not None and sh.splits(H) else None


def _weights(sh, tp, bp):
    """One layer's leaves for use: gathered whole, or with their model dims
    kept where the layer runs tensor-parallel."""
    return bp if sh is None else sh.layer(bp, keep_model=tp is not None)


def _layer(cfg, bp, x, sh=None):
    """One layer over the whole sequence, from its stored weights: cast to
    the compute dtype and (under ``sh``) gathered, then time-mix and
    channel-mix, tensor-parallel where ``_tp``."""
    tp = _tp(cfg, sh)
    bp = _weights(sh, tp, {k: t.to(_cdt(cfg)) for k, t in bp.items()})
    x, _ = _time_mix(cfg, bp, x, use_chunked=True, sh=tp)
    x, _ = _channel_mix(cfg, bp, x, sh=tp)
    return x


def forward(cfg: ArchConfig, params, tokens, ctx=None,
            embeds=None, vocab_local=False) -> ForwardOut:
    """Under ``ctx`` the tokens, the logits and ``params`` are this rank's
    (the logits whole, or this rank's columns of the vocabulary with
    ``vocab_local``, as ``transformer.forward``); each layer's weights are
    gathered just before it runs, its model dims kept where the layer runs
    tensor-parallel (``_tp``: each rank its own heads and d_ff columns).
    With ``cfg.remat`` and a gradient to take, each layer (its cast and
    gather included) runs under ``common.recompute``."""
    sh = sharded(cfg, ctx)
    x = _inputs(cfg, params, tokens, embeds, sh)
    remat = common.remat_wanted(cfg, params["blocks"].values())
    for bp in _layers(params["blocks"]):
        x = common.recompute(_layer, cfg, bp, x, sh) if remat \
            else _layer(cfg, bp, x, sh)
    logits = _logits(cfg, params, x, sh, vocab_local)
    z = torch.zeros((), dtype=torch.float32, device=logits.device)
    return ForwardOut(logits, z, z)


def loss_fn(cfg, params, batch, ctx=None):
    out = forward(cfg, params, batch["tokens"], ctx,
                  embeds=batch.get("embeds"), vocab_local=True)
    loss = cross_entropy(sharded(cfg, ctx), out.logits, batch["labels"],
                         batch.get("mask"))
    return loss, {"ce": loss}


class RwkvCache(NamedTuple):
    tm_x: torch.Tensor       # (L, B, d)   time-mix shift state
    tm_s: torch.Tensor       # (L, B, H, hd, hd) wkv state, f32
    cm_x: torch.Tensor       # (L, B, d)   channel-mix shift state
    length: torch.Tensor     # () int32


def init_cache(cfg: ArchConfig, B: int, max_len: int, dtype=None, *,
               device="cuda") -> RwkvCache:
    dev = resolve_device(device)
    dtype = dtype or _cdt(cfg)
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.recurrent.head_dim
    H = d // hd
    return RwkvCache(torch.zeros((L, B, d), dtype=dtype, device=dev),
                     torch.zeros((L, B, H, hd, hd), dtype=_acc_dtype(dtype),
                                 device=dev),
                     torch.zeros((L, B, d), dtype=dtype, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev))


def decode_step(cfg, params, token, cache: RwkvCache, ctx=None, embed=None):
    """token: (B,) int (or embed (B, d)).  Writes each layer's new state
    into ``cache`` in place, advances ``length`` and returns (logits (B, V),
    cache).  Under ``ctx`` the tokens and ``cache`` are this rank's
    (``cache_specs``): the shift states' width slices are gathered for the
    step and written back after it; the WKV state is replicated over the
    model axis, so a tensor-parallel layer steps its own heads' and
    all-gathers the new state over the axis."""
    sh = sharded(cfg, ctx)
    if sh is None:
        return _decode(cfg, params, token, cache, embed, None)
    return sh.on_full_cache(
        cache, lambda full: _decode(cfg, params, token, full, embed, sh))


def _decode(cfg, params, token, cache: RwkvCache, embed, sh):
    x = _inputs(cfg, params, token, embed, sh)[:, None, :]
    tp = _tp(cfg, sh)
    for li, bp in enumerate(_cast_layers(cfg, params["blocks"])):
        bp = _weights(sh, tp, bp)
        x, (tmx, tms) = _time_mix(cfg, bp, x, use_chunked=False,
                                  state=(cache.tm_x[li], cache.tm_s[li]),
                                  sh=tp)
        x, cmx = _channel_mix(cfg, bp, x, state=cache.cm_x[li], sh=tp)
        cache.tm_x[li].copy_(tmx)
        cache.tm_s[li].copy_(_whole_state(tp, tms))
        cache.cm_x[li].copy_(cmx)
    cache.length.add_(1)
    return _logits(cfg, params, x, sh)[:, 0], cache


def _whole_state(tp, s):
    """A layer's new WKV state for the cache, which holds every head on
    every rank: this rank's heads' gathered over the model axis where the
    layer runs tensor-parallel (once per layer and step)."""
    return s if tp is None else tp.model_gather(s, 1)


def prefill(cfg, params, tokens, max_len: int, ctx=None, embeds=None):
    """Chunked forward that also returns the recurrent state as the cache
    (under ``ctx``, this rank's slices of it, ``cache_specs``)."""
    sh = sharded(cfg, ctx)
    x = _inputs(cfg, params, tokens, embeds, sh)
    B, S = x.shape[:2]
    cache = init_cache(cfg, B, max_len, device=x.device)
    tp = _tp(cfg, sh)
    for li, bp in enumerate(_cast_layers(cfg, params["blocks"])):
        bp = _weights(sh, tp, bp)
        x, (tmx, tms) = _time_mix(cfg, bp, x, use_chunked=True, sh=tp)
        x, cmx = _channel_mix(cfg, bp, x, sh=tp)
        cache.tm_x[li].copy_(tmx)
        cache.tm_s[li].copy_(_whole_state(tp, tms))
        cache.cm_x[li].copy_(cmx)
    cache.length.fill_(S)
    logits = _logits(cfg, params, x, sh)
    return logits, (cache if sh is None else sh.local_cache(cache))
