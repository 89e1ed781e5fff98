"""Decoder-only transformer LM, dense path, with the W8A8 FFN on the
hand-written int8 matmul kernels.

The counterpart of the dense path of ``repro.models.transformer``: the
same parameter dict (layers stacked on a leading axis; ``quant="w8a8_ffn"``
replaces each FFN weight ``name`` by ``name_q`` int8 and ``name_s`` f32
per-channel scales), the same KV-cache layout (L, B, T, KV, hd) and the
same arithmetic.  Differences:

* the reference's ``lax.scan`` over layers is a Python loop;
* the KV cache is written in place (``decode_step``, ``prefill``): torch
  tensors are mutable, and a copy of the cache per step would cost what
  the reference's donation saves;
* ``prefill`` fills the cache in the same pass that computes the logits.
  The reference runs ``forward`` and then a second pass that recomputes
  K/V; the values are the same, the port runs each FFN matmul once per
  layer instead of twice.

* ``cfg.remat`` ("save_dots" or "full") wraps each block of a training
  ``forward`` in ``torch.utils.checkpoint`` (non-reentrant), which keeps
  the block's input and recomputes the whole block in the backward.  The
  reference's "save_dots" keeps the matmul outputs; the port recomputes
  them too: a memory choice that changes no value, and no selective
  policy sees the ctypes kernel launches, which the dispatcher cannot.
  The recompute runs the flash forward kernel a second time per block;
* the embedding lookup is ``F.embedding``, whose backward is not among
  PyTorch's nondeterministic operations (the indexed accumulate of
  ``params["embed"][tokens]`` is, on the CPU), so a training step replays
  bit for bit.

``attn_impl="flash"`` runs full-sequence attention (``forward``,
``prefill``) through ``kernels.flashattn.ops.flash_attn_model``, as the
reference's ``_attention_core``: ``flash_attention_fwd_lse`` forward and,
when a gradient is asked for, the ``flash_attention_bwd`` kernels; decode
attention stays ``common.decode_attention`` under either setting, plain
tensor code in both packages.

``embeds`` (``forward``, ``prefill``) and ``embed`` (``decode_step``) take
the place of the token embedding, as in the reference: the campaign's
``activations`` site strikes the embeddings through them.  A token id out
of range reads the row JAX's gather reads (a negative id counts from the
end once, then the id is clamped), so a struck token buffer decodes the
same stream in both packages and never faults the card.

``cfg.quant_kv`` keeps the KV cache in int8 with one f32 scale per
(layer, row, position, KV head) in ``KVCache.k_s``/``v_s`` (``None``
otherwise), quantized as the reference's ``_quantize_kv_rows``; decode
attention takes the int8 q.k product exactly (``common.decode_attention``).

Not in the port yet (each raises ``NotImplementedError`` naming its
ROADMAP item): MoE blocks and ``ShardCtx`` (item 17).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.flashattn.ops import flash_attn_model
from repro_torch.models import common
from repro_torch.models.config import ArchConfig

_NOT_YET = {
    "moe": "MoE blocks come with ROADMAP.md queue 1, item 17",
    "ctx": "sharded execution (ShardCtx) comes with ROADMAP.md queue 1, "
           "item 17",
}


def _not_yet(what: str):
    raise NotImplementedError(_NOT_YET[what])


def _check(cfg: ArchConfig, ctx=None) -> None:
    if cfg.moe is not None:
        _not_yet("moe")
    if ctx is not None:
        _not_yet("ctx")


def _pdt(cfg: ArchConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _cdt(cfg: ArchConfig):
    """The compute dtype; ``float64`` serves as a precision witness."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.compute_dtype, torch.float32)


def _w(cfg: ArchConfig, w):
    """Cast a weight to the compute dtype at point of use."""
    return w.to(_cdt(cfg))


# ------------------------- W8A8 (the paper's technique) --------------------


def quantize_ffn_weight(w: torch.Tensor):
    """Per-channel symmetric int8 over the contraction dim (axis -2).

    (..., K, N) → int8 (..., K, N), f32 scale (..., N); stacked (L, K, N)
    weights keep per-(layer, channel) scales.
    """
    w = w.to(torch.float32)
    scale = torch.clamp(w.abs().amax(dim=-2), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127)
    return w_q.to(torch.int8), scale


_FFN_WEIGHTS = ("wi", "wg", "wd")


def quantize_ffn_params(cfg: ArchConfig, params):
    """Replace FFN weight leaves with {name}_q int8 + {name}_s f32 scales."""
    _check(cfg)
    p = dict(params)
    blocks = dict(p["dense_blocks"])
    for name in _FFN_WEIGHTS:
        if name in blocks:
            blocks[name + "_q"], blocks[name + "_s"] = \
                quantize_ffn_weight(blocks.pop(name))
    p["dense_blocks"] = blocks
    return p


def _quantize_act(x: torch.Tensor):
    """Dynamic symmetric per-row int8 activation quant (serving-style):
    round half to even of an IEEE divide, as the reference."""
    x = x.to(torch.float32)
    x_s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    x_q = torch.clamp(torch.round(x / x_s), -127, 127).to(torch.int8)
    return x_q, x_s


def _qdot(cfg: ArchConfig, x, bp, name):
    """x @ W[name], W8A8 when quantized params are present.

    The int32 accumulator comes from the execution-backend registry
    (``cfg.backend``: the ``cuda`` kernels by default, the ``ref`` plain
    oracle on request); with ``cfg.policy_map`` set, the site
    ``ffn.<name>`` resolves to a policy (and optionally a backend) and the
    accumulator runs through ``dependable_matmul_acc``.  The rescale is
    ``acc.f32 * x_s * w_s``, then a cast, in the reference's order."""
    if name + "_q" not in bp:
        return x @ _w(cfg, bp[name])
    from repro_torch.kernels import dispatch
    x_q, x_s = _quantize_act(x)
    w_q = bp[name + "_q"]
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    if cfg.policy_map is not None:
        from repro_torch.core import dependability as dep
        pol, pm_backend = cfg.policy_map.resolve("ffn." + name)
        be = pm_backend or cfg.backend
        if pol is dep.Policy.NONE:
            acc = dispatch.matmul_acc(x2, w_q, backend=be)
        else:
            acc, _ = dep.dependable_matmul_acc(pol, x2, w_q, backend=be)
    else:
        acc = dispatch.matmul_acc(x2, w_q, backend=cfg.backend)
    acc = acc.reshape(*lead, w_q.shape[-1])
    y = acc.to(torch.float32) * x_s * bp[name + "_s"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """The reference's parameter dict, drawn from ``gen`` on the CPU and
    moved to ``device``.  Layers stacked on axis 0."""
    _check(cfg)
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    L = cfg.n_layers
    pdt = _pdt(cfg)

    def stack(shape):
        return common.dense_init(gen, (L,) + shape, in_axis=1, dtype=pdt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt)

    blocks = {"ln1": zeros(L, d), "ln2": zeros(L, d),
              "wq": stack((d, H * hd)), "wk": stack((d, KV * hd)),
              "wv": stack((d, KV * hd)), "wo": stack((H * hd, d))}
    if cfg.qk_norm:
        blocks["q_norm"], blocks["k_norm"] = zeros(L, hd), zeros(L, hd)
    if cfg.use_bias:
        blocks.update(bq=zeros(L, H * hd), bk=zeros(L, KV * hd),
                      bv=zeros(L, KV * hd))
    blocks.update(wi=stack((d, ff)), wg=stack((d, ff)), wd=stack((ff, d)))
    params = {"embed": common.embed_init(gen, (V, d), dtype=pdt),
              "final_norm": torch.zeros((d,), dtype=pdt),
              "dense_blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(gen, (d, V), dtype=pdt)
    params = {k: ({n: t.to(dev) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in params.items()}
    if cfg.quant == "w8a8_ffn":
        params = quantize_ffn_params(cfg, params)
    return params


def _layers(blocks: Dict[str, torch.Tensor]) -> List[Dict[str, Any]]:
    """The stacked (L, ...) block dict as one dict of views per layer."""
    cols = {k: v.unbind(0) for k, v in blocks.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _cast_layers(cfg: ArchConfig, blocks) -> List[Dict[str, Any]]:
    """``_layers`` with every weight cast to the compute dtype (the
    recurrent families cast whole blocks, as the reference does)."""
    dt = _cdt(cfg)
    return [{k: t.to(dt) for k, t in bp.items()} for bp in _layers(blocks)]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(cfg: ArchConfig, bp, x, positions):
    """Pre-norm projections, qk-norm and RoPE: q (B,S,H,hd), k/v
    (B,S,KV,hd)."""
    B, S, _ = x.shape
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h = common.rms_norm(x, bp["ln1"], cfg.norm_eps)
    q = h @ _w(cfg, bp["wq"])
    k = h @ _w(cfg, bp["wk"])
    v = h @ _w(cfg, bp["wv"])
    if cfg.use_bias:
        q = q + _w(cfg, bp["bq"])
        k = k + _w(cfg, bp["bk"])
        v = v + _w(cfg, bp["bv"])
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, bp["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, bp["k_norm"], cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention(cfg: ArchConfig, bp, x, positions):
    """Full-sequence attention block: (x + attn, k, v) — k and v as the
    KV cache holds them."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, bp, x, positions)
    if cfg.attn_impl == "flash":
        o = flash_attn_model(q, k, v, window=cfg.swa_window)
    else:
        o = common.chunked_causal_attention(q, k, v, window=cfg.swa_window)
    x = x + o.reshape(B, S, -1) @ _w(cfg, bp["wo"])
    return x, k, v


def _dense_ffn(cfg: ArchConfig, bp, x):
    h = common.rms_norm(x, bp["ln2"], cfg.norm_eps)
    act = F.silu(_qdot(cfg, h, bp, "wg")) * _qdot(cfg, h, bp, "wi")
    return x + _qdot(cfg, act, bp, "wd")


def _logits(cfg: ArchConfig, params, x):
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def _embed(cfg: ArchConfig, params, tokens):
    """The embedding rows of ``tokens``, an out-of-range id read as JAX's
    gather reads it: negative ids count from the end once, then clamp."""
    V = params["embed"].shape[0]
    ids = tokens.long()
    ids = torch.clamp(torch.where(ids < 0, ids + V, ids), 0, V - 1)
    return F.embedding(ids, params["embed"]).to(_cdt(cfg))


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def _block(cfg: ArchConfig, bp, x, positions):
    x, _, _ = _attention(cfg, bp, x, positions)
    return _dense_ffn(cfg, bp, x)


def _inputs(cfg: ArchConfig, params, tokens, embeds=None):
    """The token embeddings, or ``embeds`` in their place, in the compute
    dtype."""
    return _embed(cfg, params, tokens) if embeds is None \
        else embeds.to(_cdt(cfg))


def _trunk(cfg: ArchConfig, params, tokens, keep_kv=None, remat=False,
           embeds=None):
    """Embed (or take ``embeds`` (B, S, d) in its place), every block, final
    norm and head; ``keep_kv(layer, k, v)`` receives each layer's K/V;
    ``remat`` recomputes each block in the backward."""
    x = _inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for li, bp in enumerate(_layers(params["dense_blocks"])):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _block, cfg, bp, x, positions, use_reentrant=False)
            continue
        x, k, v = _attention(cfg, bp, x, positions)
        if keep_kv is not None:
            keep_kv(li, k, v)
        x = _dense_ffn(cfg, bp, x)
    return _logits(cfg, params, x)


def _remat(cfg: ArchConfig, params) -> bool:
    """Recompute blocks when ``cfg.remat`` asks and a gradient will flow."""
    return (cfg.remat != "none" and torch.is_grad_enabled()
            and any(t.requires_grad for t in params["dense_blocks"].values()))


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, ctx=None,
            embeds=None) -> ForwardOut:
    """tokens: (B, S) int (or embeds (B, S, d)) → logits (B, S, V)."""
    _check(cfg, ctx)
    logits = _trunk(cfg, params, tokens, remat=_remat(cfg, params),
                    embeds=embeds)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return ForwardOut(logits, zero, zero)


def loss_fn(cfg: ArchConfig, params, batch, ctx=None):
    """(mean next-token CE, {"ce", "aux", "z"}) of ``batch`` ("tokens",
    "labels", optional "mask"); dense, so aux and z are zero."""
    out = forward(cfg, params, batch["tokens"], ctx,
                  embeds=batch.get("embeds"))
    loss = common.cross_entropy_loss(out.logits, batch["labels"],
                                     batch.get("mask"))
    return loss, {"ce": loss, "aux": out.aux_loss, "z": out.z_loss}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with a (ring-buffer) KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor          # (L, B, T, KV, hd) — compute dtype, or int8
    v: torch.Tensor          #   when cfg.quant_kv (k_s/v_s hold the scales)
    length: torch.Tensor     # (B,) int32 — per-row tokens currently in cache
    k_s: Optional[torch.Tensor] = None   # (L, B, T, KV) f32 int8-KV scales
    v_s: Optional[torch.Tensor] = None


def _quantize_kv_rows(x: torch.Tensor):
    """Per-(..., KV)-row symmetric int8 over hd: (..., KV, hd) -> q, scale
    (round half to even of an IEEE divide, as the reference)."""
    x = x.to(torch.float32)
    s = torch.clamp(x.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def cache_len(cfg: ArchConfig, max_len: int) -> int:
    """SWA archs only need a window-sized ring buffer."""
    if cfg.swa_window is not None:
        return min(cfg.swa_window, max_len)
    return max_len


def init_cache(cfg: ArchConfig, B: int, max_len: int, dtype=None, *,
               device="cuda") -> KVCache:
    _check(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, cache_len(cfg, max_len), cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if cfg.quant_kv:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros((B,), dtype=torch.int32, device=dev),
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev),
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev))
    dtype = dtype or _cdt(cfg)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros((B,), dtype=torch.int32, device=dev))


def decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                cache: KVCache, ctx=None, embed=None):
    """token: (B,) int (or embed (B, d)).  Writes each layer's new K/V row
    into ``cache`` in place (slot ``length % T`` of each row), advances
    ``length`` and returns (logits (B, V), cache)."""
    _check(cfg, ctx)
    x = _inputs(cfg, params, token, embed)[:, None, :]
    B = x.shape[0]
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    pos = cache.length
    T = cache.k.shape[2]
    rows = torch.arange(B, device=x.device)
    slot = (pos % T).long()
    valid = torch.clamp(pos + 1, max=T)
    for li, bp in enumerate(_layers(params["dense_blocks"])):
        q, k, v = _qkv(cfg, bp, x, pos[:, None])
        if cache.k_s is not None:                    # int8 KV cache
            k_q, k_sc = _quantize_kv_rows(k[:, 0])   # (B, KV, hd), (B, KV)
            v_q, v_sc = _quantize_kv_rows(v[:, 0])
            cache.k[li, rows, slot] = k_q
            cache.v[li, rows, slot] = v_q
            cache.k_s[li, rows, slot] = k_sc
            cache.v_s[li, rows, slot] = v_sc
            o = common.decode_attention(q, cache.k[li], cache.v[li], valid,
                                        k_scale=cache.k_s[li],
                                        v_scale=cache.v_s[li])
        else:
            cache.k[li, rows, slot] = k[:, 0].to(cache.k.dtype)
            cache.v[li, rows, slot] = v[:, 0].to(cache.v.dtype)
            o = common.decode_attention(q, cache.k[li], cache.v[li], valid)
        x = x + (o.reshape(B, 1, H * hd) @ _w(cfg, bp["wo"])).to(x.dtype)
        x = _dense_ffn(cfg, bp, x)
    cache.length.add_(1)
    return _logits(cfg, params, x).reshape(B, -1), cache


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, max_len: int,
            ctx=None, embeds=None):
    """Full-sequence forward that also fills a fresh KV cache in the same
    pass; ``embeds`` (B, S, d) takes the place of the token embedding.
    Returns (logits (B, S, V), cache)."""
    _check(cfg, ctx)
    src = tokens if embeds is None else embeds
    B, S = src.shape[:2]
    cache = init_cache(cfg, B, max_len, device=src.device)
    T = cache.k.shape[2]
    tc = min(T, S)
    # keep the last T positions; SWA rings put position p at slot p % T
    ring = cfg.swa_window is not None and S >= T
    idx = (torch.arange(tc, device=src.device) + (S - tc)) % T

    def write(page, new):
        if ring:
            page[:, idx] = new
        else:
            page[:, :tc] = new

    def keep(li, k, v):
        k, v = k[:, S - tc:], v[:, S - tc:]
        if cache.k_s is None:
            write(cache.k[li], k.to(cache.k.dtype))
            write(cache.v[li], v.to(cache.v.dtype))
            return
        for page, scales, new in ((cache.k[li], cache.k_s[li], k),
                                  (cache.v[li], cache.v_s[li], v)):
            q, sc = _quantize_kv_rows(new)
            write(page, q)
            write(scales, sc)

    logits = _trunk(cfg, params, tokens, keep_kv=keep, embeds=embeds)
    cache.length.fill_(S)
    return logits, cache
