"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrence + local
attention, interleaved 2:1 (two recurrent blocks, then one local-MQA block).

The counterpart of ``repro.models.griffin``: the same parameter dict
(``rec_blocks`` stacked (2·n_super, ...), ``attn_blocks`` (n_attn, ...),
``tail_rec`` for the leftover recurrent layers), the same ``GriffinCache``
fields (recurrent state per recurrent layer, a window-sized KV ring per
attention layer) and the same arithmetic.

RG-LRU:  a_t = exp(-c · softplus(Λ) · σ(W_a x_t)),  c = 8
         h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Differences from the reference:

* ``rglru_parallel`` is a log-depth (Hillis–Steele) scan: ⌈log₂ T⌉
  doubling steps of tensor ops with the reference's ``combine``, where the
  reference calls ``jax.lax.associative_scan``; the two orders of the
  same products agree to f32 rounding (``tests/test_torch_rwkv_griffin.py``
  states the tolerance);
* ``_causal_conv1d`` is the reference's K shifted multiply-adds, not
  ``F.conv1d`` (which on the card would run a float32 conv in TF32);
* the ``lax.scan`` over super-blocks is a Python loop, and ``decode_step``
  writes the recurrent state and the KV ring into ``cache`` in place;
* products the reference takes between an f32 and a bf16 operand (the
  decode attention output times ``wo``) promote both to f32, as JAX does;
* ``GriffinCache.length`` is a (B,) vector, one position per row, as the
  port's ``KVCache`` holds it; the reference keeps one scalar for the whole
  batch, which the slot splice maxes, so in its continuous batching a row
  that joins with a shorter prompt decodes its attention layers at another
  row's position.  The two agree wherever every row sits at the same
  position (one request, or the same prompt length) and in any model
  without attention layers (``reduced()`` keeps two recurrent layers).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import common
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (ForwardOut, _cast_layers,
                                            _cdt, _check, _inputs, _logits,
                                            _pdt)

RGLRU_C = 8.0


def _counts(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_super, n_tail_rec, n_attn) for the (rec, rec, attn) pattern."""
    n_super = cfg.n_layers // 3
    return n_super, cfg.n_layers - 3 * n_super, n_super


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _rec_block_params(gen, n, d, W, ff, d_conv, pdt):
    def stack(shape):
        return common.dense_init(gen, (n,) + shape, in_axis=1, dtype=pdt)
    return {
        "ln": torch.zeros((n, d), dtype=pdt),
        "w_x": stack((d, W)),
        "w_gate": stack((d, W)),
        "conv_w": stack((d_conv, W)),
        "lam": torch.linspace(0.9, 5.0, W)[None].repeat(n, 1).to(pdt),
        "w_a": stack((W, W)),
        "w_i": stack((W, W)),
        "w_out": stack((W, d)),
        "ln_mlp": torch.zeros((n, d), dtype=pdt),
        "mlp_g": stack((d, ff)),
        "mlp_i": stack((d, ff)),
        "mlp_o": stack((ff, d)),
    }


def _attn_block_params(gen, n, cfg, pdt):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def stack(shape):
        return common.dense_init(gen, (n,) + shape, in_axis=1, dtype=pdt)
    return {
        "ln": torch.zeros((n, d), dtype=pdt),
        "wq": stack((d, H * hd)), "wk": stack((d, KV * hd)),
        "wv": stack((d, KV * hd)), "wo": stack((H * hd, d)),
        "ln_mlp": torch.zeros((n, d), dtype=pdt),
        "mlp_g": stack((d, ff)), "mlp_i": stack((d, ff)),
        "mlp_o": stack((ff, d)),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """The reference's parameter dict, drawn from ``gen`` on the CPU and
    moved to ``device``."""
    _check(cfg)
    dev = resolve_device(device)
    d, V, ff = cfg.d_model, cfg.vocab_size, cfg.d_ff
    W = cfg.recurrent.lru_width or d
    pdt = _pdt(cfg)
    n_super, tail, n_attn = _counts(cfg)
    params = {
        "embed": common.embed_init(gen, (V, d), dtype=pdt),
        "final_norm": torch.zeros((d,), dtype=pdt),
        "rec_blocks": _rec_block_params(gen, 2 * n_super, d, W, ff,
                                        cfg.recurrent.d_conv, pdt),
        "attn_blocks": _attn_block_params(gen, n_attn, cfg, pdt),
    }
    if tail:
        params["tail_rec"] = _rec_block_params(gen, tail, d, W, ff,
                                               cfg.recurrent.d_conv, pdt)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(gen, (d, V), dtype=pdt)
    return {k: ({n: t.to(dev) for n, t in v.items()}
                if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))     # jax.nn.softplus


def _gates(x_in, gate_a, lam):
    log_a = -RGLRU_C * _softplus(lam) * gate_a                  # ≤ 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                               min=1e-12)) * x_in
    return a, b


def rglru_parallel(x_in, gate_a, lam):
    """x_in, gate_a: (B, T, W) f32; lam: (W,).  The linear recurrence
    h_t = a_t h_{t-1} + b_t as a log-depth scan: step ``d`` combines each
    position with the one ``d`` before it, ``combine((a1, b1), (a2, b2))
    = (a1 a2, a2 b1 + b2)`` as in the reference."""
    a, b = _gates(x_in, gate_a, lam[None, None])
    T = a.shape[1]
    d = 1
    while d < T:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_step(x_in, gate_a, lam, h_prev):
    a, b = _gates(x_in, gate_a, lam[None])                      # (B, W)
    return a * h_prev + b


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _causal_conv1d(x, w, state=None):
    """Depthwise causal conv as K shifted multiply-adds.  x: (B, T, W),
    w: (K, W), state: (B, K-1, W)."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, 0:T] * w[0][None, None]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i][None, None]
    return out, xp[:, -(K - 1):]


def _mlp(cfg, bp, x):
    hm = common.rms_norm(x, bp["ln_mlp"], cfg.norm_eps)
    return x + (_gelu(hm @ bp["mlp_g"]) * (hm @ bp["mlp_i"])) @ bp["mlp_o"]


def _rec_block(cfg, bp, x, state=None):
    """state: (conv_state (B,K-1,W), h (B,W)) or None. x: (B,T,d)."""
    T = x.shape[1]
    h = common.rms_norm(x, bp["ln"], cfg.norm_eps)
    xb = h @ bp["w_x"]                                   # (B, T, W)
    gate = _gelu(h @ bp["w_gate"])
    xb, new_conv = _causal_conv1d(xb, bp["conv_w"],
                                  state[0] if state is not None else None)
    g_a = torch.sigmoid((xb @ bp["w_a"]).to(torch.float32))
    g_i = torch.sigmoid((xb @ bp["w_i"]).to(torch.float32))
    xin = g_i * xb.to(torch.float32)
    lam = bp["lam"].to(torch.float32)
    if state is not None and T == 1:
        new_h = rglru_step(xin[:, 0], g_a[:, 0], lam, state[1])
        rec = new_h[:, None]
    else:
        rec = rglru_parallel(xin, g_a, lam)
        new_h = rec[:, -1]
    x = x + (rec.to(x.dtype) * gate) @ bp["w_out"]
    return _mlp(cfg, bp, x), (new_conv, new_h)


def _attn_full(cfg, bp, x, positions):
    """Local MQA over the whole sequence: (x', k, v), k after RoPE."""
    B, T, _ = x.shape
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h = common.rms_norm(x, bp["ln"], cfg.norm_eps)
    q = common.apply_rope((h @ bp["wq"]).reshape(B, T, H, hd), positions,
                          cfg.rope_theta)
    k = common.apply_rope((h @ bp["wk"]).reshape(B, T, KV, hd), positions,
                          cfg.rope_theta)
    v = (h @ bp["wv"]).reshape(B, T, KV, hd)
    o = common.chunked_causal_attention(q, k, v,
                                        window=cfg.recurrent.attn_window)
    x = x + (o.reshape(B, T, H * hd) @ bp["wo"]).to(x.dtype)
    return _mlp(cfg, bp, x), k, v


def _attn_decode(cfg, bp, x, kc, vc, pos):
    """One token of local MQA against the ring ``kc``/``vc`` (B, Win, KV,
    hd), row b written in place at slot ``pos[b] % Win``."""
    B = x.shape[0]
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    Tc = kc.shape[1]
    h = common.rms_norm(x, bp["ln"], cfg.norm_eps)
    q = common.apply_rope((h @ bp["wq"]).reshape(B, 1, H, hd), pos[:, None],
                          cfg.rope_theta)
    k = common.apply_rope((h @ bp["wk"]).reshape(B, 1, KV, hd),
                          pos[:, None], cfg.rope_theta)
    v = (h @ bp["wv"]).reshape(B, 1, KV, hd)
    rows = torch.arange(B, device=x.device)
    slot = (pos % Tc).long()
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    o = common.decode_attention(q.to(torch.float32), kc.to(torch.float32),
                                vc.to(torch.float32),
                                torch.clamp(pos + 1, max=Tc))
    o = o.reshape(B, 1, H * hd) @ bp["wo"].to(torch.float32)
    return _mlp(cfg, bp, x + o.to(x.dtype))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _schedule(cfg, params):
    """The layers in execution order: ("rec", i, block) for the i-th
    recurrent layer (cache row i), ("attn", j, block) for the j-th
    attention layer, as the reference's super-blocks and tail run them."""
    n_super, tail, _ = _counts(cfg)
    rec = _cast_layers(cfg, params["rec_blocks"]) if n_super else []
    attn = _cast_layers(cfg, params["attn_blocks"]) if n_super else []
    out = []
    for s in range(n_super):
        out += [("rec", 2 * s, rec[2 * s]), ("rec", 2 * s + 1, rec[2 * s + 1]),
                ("attn", s, attn[s])]
    if tail:
        out += [("rec", 2 * n_super + i, bp)
                for i, bp in enumerate(_cast_layers(cfg, params["tail_rec"]))]
    return out


def forward(cfg: ArchConfig, params, tokens, ctx=None,
            embeds=None) -> ForwardOut:
    _check(cfg, ctx)
    x = _inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for kind, _, bp in _schedule(cfg, params):
        if kind == "rec":
            x, _ = _rec_block(cfg, bp, x)
        else:
            x, _, _ = _attn_full(cfg, bp, x, positions)
    logits = _logits(cfg, params, x)
    z = torch.zeros((), dtype=torch.float32, device=logits.device)
    return ForwardOut(logits, z, z)


def loss_fn(cfg, params, batch, ctx=None):
    out = forward(cfg, params, batch["tokens"], ctx,
                  embeds=batch.get("embeds"))
    loss = common.cross_entropy_loss(out.logits, batch["labels"],
                                     batch.get("mask"))
    return loss, {"ce": loss}


class GriffinCache(NamedTuple):
    conv: torch.Tensor       # (n_rec, B, K-1, W)
    h: torch.Tensor          # (n_rec, B, W) f32
    k: torch.Tensor          # (n_attn, B, Win, KV, hd)
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32 — per-row tokens seen


def init_cache(cfg: ArchConfig, B: int, max_len: int, dtype=None, *,
               device="cuda") -> GriffinCache:
    dev = resolve_device(device)
    dtype = dtype or _cdt(cfg)
    n_super, tail, n_attn = _counts(cfg)
    n_rec = 2 * n_super + tail
    W = cfg.recurrent.lru_width or cfg.d_model
    K = cfg.recurrent.d_conv
    win = min(cfg.recurrent.attn_window, max_len)
    kv = (n_attn, B, win, cfg.n_kv_heads, cfg.resolved_head_dim)
    return GriffinCache(
        torch.zeros((n_rec, B, K - 1, W), dtype=dtype, device=dev),
        torch.zeros((n_rec, B, W), dtype=torch.float32, device=dev),
        torch.zeros(kv, dtype=dtype, device=dev),
        torch.zeros(kv, dtype=dtype, device=dev),
        torch.zeros((B,), dtype=torch.int32, device=dev))


def decode_step(cfg, params, token, cache: GriffinCache, ctx=None,
                embed=None):
    """token: (B,) int (or embed (B, d)).  Row b decodes at position
    ``cache.length[b]``; the recurrent state and the KV rings are written
    in place."""
    _check(cfg, ctx)
    x = _inputs(cfg, params, token, embed)[:, None, :]
    pos = cache.length
    for kind, i, bp in _schedule(cfg, params):
        if kind == "rec":
            x, (cv, hh) = _rec_block(cfg, bp, x,
                                     state=(cache.conv[i], cache.h[i]))
            cache.conv[i].copy_(cv)
            cache.h[i].copy_(hh)
        else:
            x = _attn_decode(cfg, bp, x, cache.k[i], cache.v[i], pos)
    cache.length.add_(1)
    return _logits(cfg, params, x)[:, 0], cache


def prefill(cfg, params, tokens, max_len: int, ctx=None, embeds=None):
    """Forward pass that also fills a fresh decode cache: each recurrent
    layer's final state, and each attention layer's last ``Win`` positions
    ring-aligned (position p at slot p % Win)."""
    _check(cfg, ctx)
    x = _inputs(cfg, params, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, B, max_len, device=x.device)
    win = cache.k.shape[2]
    Tc = min(win, S)
    idx = (torch.arange(Tc, device=x.device) + (S - Tc)) % win
    for kind, i, bp in _schedule(cfg, params):
        if kind == "rec":
            x, (cv, hh) = _rec_block(cfg, bp, x)
            cache.conv[i].copy_(cv)
            cache.h[i].copy_(hh)
        else:
            x, k, v = _attn_full(cfg, bp, x, positions)
            cache.k[i][:, idx] = k[:, S - Tc:].to(cache.k.dtype)
            cache.v[i][:, idx] = v[:, S - Tc:].to(cache.v.dtype)
    cache.length.fill_(S)
    return _logits(cfg, params, x), cache
