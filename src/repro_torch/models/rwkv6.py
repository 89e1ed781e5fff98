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

Differences from the reference: the ``lax.scan`` over layers (and over
chunks and tokens) is a Python loop, and ``decode_step`` writes the new
state into ``cache`` in place, as the port's transformer writes its KV
cache.  Training on the card is not ported; ``loss_fn`` is autograd-ready
for the CPU tests.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import common
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (ForwardOut, _cast_layers,
                                            _cdt, _check, _inputs, _logits,
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
    """The reference's parameter dict, drawn from ``gen`` on the CPU and
    moved to ``device``."""
    _check(cfg)
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


def _time_mix(cfg, bp, x, use_chunked: bool, state=None):
    """x: (B, T, d). state: (x_prev (B,d), S (B,H,hd,hd)) for decode."""
    B, T, d = x.shape
    hd = cfg.recurrent.head_dim
    H = d // hd
    h = common.rms_norm(x, bp["ln1"], cfg.norm_eps)
    x_prev = state[0] if state is not None else torch.zeros(
        (B, d), dtype=h.dtype, device=h.device)
    xx = torch.cat([x_prev[:, None].to(h.dtype), h[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(bp, h, xx)

    acc = _acc_dtype(h.dtype)
    r = (xr @ bp["wr"]).reshape(B, T, H, hd).to(acc)
    k = (xk @ bp["wk"]).reshape(B, T, H, hd).to(acc)
    v = (xv @ bp["wv"]).reshape(B, T, H, hd).to(acc)
    g = F.silu(xg @ bp["wg"])

    logw = bp["w0"][None, None] + torch.tanh(xw @ bp["dec_A"]) @ bp["dec_B"]
    w = torch.exp(-torch.exp(logw.to(acc))).reshape(B, T, H, hd)
    u = bp["u"].to(acc)

    s0 = state[1] if state is not None else None
    if use_chunked and T > 1:
        o, s = wkv_chunked(r, k, v, w, u, s0)
    else:
        o, s = wkv_scan(r, k, v, w, u, s0)

    # per-head group norm
    o = common.rms_norm(o, bp["ln_x"].reshape(H, hd), cfg.norm_eps)
    o = o.reshape(B, T, d).to(x.dtype) * g
    return x + o @ bp["wo"], (h[:, -1], s)


def _channel_mix(cfg, bp, x, state=None):
    B, T, d = x.shape
    h = common.rms_norm(x, bp["ln2"], cfg.norm_eps)
    x_prev = state if state is not None else torch.zeros(
        (B, d), dtype=h.dtype, device=h.device)
    xx = torch.cat([x_prev[:, None].to(h.dtype), h[:, :-1]], dim=1)
    xk = h + (xx - h) * bp["cm_mu_k"]
    xr = h + (xx - h) * bp["cm_mu_r"]
    kk = torch.square(torch.relu(xk @ bp["cm_wk"]))
    out = torch.sigmoid(xr @ bp["cm_wr"]) * (kk @ bp["cm_wv"])
    return x + out, h[:, -1]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params, tokens, ctx=None,
            embeds=None) -> ForwardOut:
    _check(cfg, ctx)
    x = _inputs(cfg, params, tokens, embeds)
    for bp in _cast_layers(cfg, params["blocks"]):
        x, _ = _time_mix(cfg, bp, x, use_chunked=True)
        x, _ = _channel_mix(cfg, bp, x)
    logits = _logits(cfg, params, x)
    z = torch.zeros((), dtype=torch.float32, device=logits.device)
    return ForwardOut(logits, z, z)


def loss_fn(cfg, params, batch, ctx=None):
    out = forward(cfg, params, batch["tokens"], ctx,
                  embeds=batch.get("embeds"))
    loss = common.cross_entropy_loss(out.logits, batch["labels"],
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
    cache)."""
    _check(cfg, ctx)
    x = _inputs(cfg, params, token, embed)[:, None, :]
    for li, bp in enumerate(_cast_layers(cfg, params["blocks"])):
        x, (tmx, tms) = _time_mix(cfg, bp, x, use_chunked=False,
                                  state=(cache.tm_x[li], cache.tm_s[li]))
        x, cmx = _channel_mix(cfg, bp, x, state=cache.cm_x[li])
        cache.tm_x[li].copy_(tmx)
        cache.tm_s[li].copy_(tms)
        cache.cm_x[li].copy_(cmx)
    cache.length.add_(1)
    return _logits(cfg, params, x)[:, 0], cache


def prefill(cfg, params, tokens, max_len: int, ctx=None, embeds=None):
    """Chunked forward that also returns the recurrent state as the
    cache."""
    _check(cfg, ctx)
    x = _inputs(cfg, params, tokens, embeds)
    B, S = x.shape[:2]
    cache = init_cache(cfg, B, max_len, device=x.device)
    for li, bp in enumerate(_cast_layers(cfg, params["blocks"])):
        x, (tmx, tms) = _time_mix(cfg, bp, x, use_chunked=True)
        x, cmx = _channel_mix(cfg, bp, x)
        cache.tm_x[li].copy_(tmx)
        cache.tm_s[li].copy_(tms)
        cache.cm_x[li].copy_(cmx)
    cache.length.fill_(S)
    return _logits(cfg, params, x), cache
