"""Decoder-only transformer LM, dense and mixture-of-experts, with the
W8A8 FFN on the hand-written int8 matmul kernels.

The counterpart of the single-device paths of ``repro.models.transformer``:
the same parameter dict (layers stacked on a leading axis in
``dense_blocks`` and, for a config with ``moe``, ``moe_blocks`` after its
``n_dense_layers`` leading dense layers; ``quant="w8a8_ffn"`` replaces
each FFN and expert weight ``name`` by ``name_q`` int8 and ``name_s`` f32
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
  ``forward`` in ``common.recompute`` (a non-reentrant
  ``torch.utils.checkpoint``), which keeps the block's input and
  recomputes the whole block in the backward; chunked attention's own
  per-query-chunk checkpoints nest inside it.  The
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

The MoE FFN is the reference's ``_moe_ffn_single``: sort-based capacity
routing (``_local_route``: f32 router product, softmax, top-k,
renormalised gates, a stable sort by expert, ``capacity`` slots per
expert, later assignments dropped first), a gather into an (E, C, d)
buffer, the expert products, and a combine onto the token rows, plus the
shared experts through ``_qdot`` (sites ``ffn.ws_g``/``ws_i``/``ws_o``,
which a policy map reaches; the routed experts it does not reach, as in
the reference).  Differences by design:

* top-k is a stable descending sort, so a tie goes to the lower expert
  index as in ``jax.lax.top_k`` (``torch.topk`` promises no order);
* under W8A8 each expert's int8 product is its own ``dispatch.matmul_acc``
  (the ``qmatmul_acc`` kernel on the card, 3·E launches per MoE layer per
  call, empty experts included): the reference's int8 einsum with int32
  accumulation has no counterpart on the card;
* the combine sums each token's kept slots in ascending slot order (the
  order of the reference's sorted buffer), one gather per choice, with no
  scatter-add: float atomics would sum in an order that changes between
  runs.

Under a ``ShardCtx`` (``models.shard``) every entry runs on this rank's
shards, explicit SPMD where the reference leaves the partitioning to
GSPMD and ``shard_map``:

* attention is tensor-parallel over the model axis where it divides the
  heads (the reference's ``qspec``/``kvspec`` and ``tp_ok`` rules): q's
  heads shard when H divides it, k's and v's when KV does too, and a rank
  whose q heads are local but whose KV heads are not takes each local q
  head's KV head (group 1); ``wq``/``wk``/``wv`` are column-parallel,
  ``wo`` row-parallel and summed over the axis; rows 9 and 10 run on the
  local heads.  Otherwise the heads are replicated (their weights
  gathered);
* the dense FFN is column-parallel (``wg``, ``wi``) and row-parallel
  (``wd``);
* the meshed MoE (the reference's ``_moe_ffn_local``) routes this rank's
  tokens with ``capacity`` from the local token count, over the experts
  ``[e_lo, e_lo + E_loc)`` in ``ep`` (E divides the model axis) or over all
  experts with a slice of ``d_expert`` in ``etp``; in ``ep`` the partial
  combines are summed over the model axis; in ``etp`` each expert's
  ``we_o`` product is summed before the gates (under W8A8 its int32
  accumulators, exactly), so the fixed-order combine runs on whole rows;
  the shared experts are tensor-parallel; aux and z are ``pmean``ed over
  dp + (model,);
* the vocabulary stays split over the model axis as the reference's
  specs lay it out, where the axis has more than one rank and is free for
  tensor parallelism (``Sharded.vocab_split``): the embedding looks up
  this rank's rows and sums over the axis (exact: one nonzero term per
  position), and the loss takes this rank's columns of the logits
  through a vocab-parallel cross-entropy (``shard.cross_entropy``).
  ``forward``, ``prefill`` and ``decode_step`` return whole logits: their
  head is gathered over the model axis, as at one rank; d is gathered
  over dp (FSDP) in every entry;
* ``decode_step`` reads a cache laid out by ``cache_specs``: batch over
  dp, the time dim over the model axis.  Each rank writes the new row
  where it owns its slot and attends to its slots; the softmax's max and
  sum are made global before P, and the partial P·V summed
  (flash-decoding);
* the loss is the global batch's mean (the slices' means averaged);
* under ``cfg.seq_shard`` (``Sharded.seq_split``: the model axis
  tensor-parallel over m > 1 ranks that divide S) ``forward``, and so
  ``loss_fn`` and the train step, keep the stream between blocks on this
  rank's S/m rows, the layout the reference's ``seq_sp`` pins with
  ``with_sharding_constraint``.  The embedding's sum over the vocabulary
  shards is a reduce-scatter onto the rows (a slice where the vocabulary
  is whole, of ``embeds`` too); each attention and dense FFN half runs
  its norm on the rows, all-gathers the normed rows before its column
  products and reduce-scatters ``wo``'s and ``wd``'s sums back onto them
  (``wo``'s output sliced where the q heads are not local), the residual
  add on the rows; the MoE half gathers its normed rows whole, so that it
  routes the same B·S tokens, and reduce-scatters the expert combine's
  and the shared experts' sums onto the rows (etp's combine, whole on
  every rank, sliced).  The final norm runs on the rows, which are then
  gathered for the head.  Every gather sits inside the block that
  ``cfg.remat`` recomputes, so only the S/m rows are kept between blocks.
  ``prefill`` and ``decode_step`` keep the whole sequence, as the
  reference's ``prefill`` does.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.flashattn.ops import flash_attn_model
from repro_torch.models import common
from repro_torch.models.config import ArchConfig
from repro_torch.models.shard import (RowSum, ShardCtx,  # noqa: F401
                                      cross_entropy, sharded)
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import entry_axes


def _pdt(cfg: ArchConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _cdt(cfg: ArchConfig):
    """The compute dtype; ``float64`` serves as a precision witness."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.compute_dtype, torch.float32)


def _w(cfg: ArchConfig, w):
    """Cast a weight to the compute dtype at point of use."""
    return w.to(_cdt(cfg))


def _n_moe(cfg: ArchConfig) -> int:
    """The number of MoE layers (after the ``n_dense_layers`` dense ones)."""
    return 0 if cfg.moe is None else cfg.n_layers - cfg.moe.n_dense_layers


# ------------------------- W8A8 (the paper's technique) --------------------


def _quantize_weight(w: torch.Tensor):
    w = w.to(torch.float32)
    scale = torch.clamp(w.abs().amax(dim=-2), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127)
    return w_q.to(torch.int8), scale


_QUANT_CHUNK = 1 << 28            # f32 elements quantized at a time


def quantize_ffn_weight(w: torch.Tensor):
    """Per-channel symmetric int8 over the contraction dim (axis -2).

    (..., K, N) → int8 (..., K, N), f32 scale (..., N); stacked (L, K, N)
    and (L, E, K, N) weights keep per-(layer, expert, channel) scales.  A
    large leaf is quantized a few (K, N) matrices at a time: the scales
    are per matrix, so the values are the same, and the f32 copy stays
    small (kimi-k2's routed experts are 17 GB in int8)."""
    K, N = w.shape[-2:]
    flat = w.reshape(-1, K, N)
    w_q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((flat.shape[0], N), dtype=torch.float32,
                        device=w.device)
    step = max(1, _QUANT_CHUNK // (K * N))
    for i in range(0, flat.shape[0], step):
        w_q[i:i + step], scale[i:i + step] = _quantize_weight(
            flat[i:i + step])
    return w_q.reshape(w.shape), scale.reshape(*w.shape[:-2], N)


_FFN_WEIGHTS = ("wi", "wg", "wd", "we_g", "we_i", "we_o", "ws_g", "ws_i",
                "ws_o")


def _quantize_block(bp):
    out = dict(bp)
    for name in _FFN_WEIGHTS:
        if name in out:
            out[name + "_q"], out[name + "_s"] = \
                quantize_ffn_weight(out.pop(name))
    return out


def quantize_ffn_params(cfg: ArchConfig, params):
    """Replace FFN and expert weight leaves with {name}_q int8 + {name}_s
    f32 scales, in both block dicts."""
    p = dict(params)
    for blk in ("dense_blocks", "moe_blocks"):
        if p.get(blk) is not None:
            p[blk] = _quantize_block(p[blk])
    return p


def _quantize_act(x: torch.Tensor, amax=None):
    """Dynamic symmetric per-row int8 activation quant (serving-style):
    round half to even of an IEEE divide, as the reference.  A row whose
    elements are spread over ranks passes ``amax``, the MAX over them, so
    that each rank quantizes with the whole row's scale."""
    x = x.to(torch.float32)
    a = x.abs().amax(dim=-1, keepdim=True)
    if amax is not None:
        a = amax(a)
    x_s = torch.clamp(a, min=1e-8) / 127.0
    x_q = torch.clamp(torch.round(x / x_s), -127, 127).to(torch.int8)
    return x_q, x_s


def _qdot(cfg: ArchConfig, x, bp, name, red: Optional[RowSum] = None):
    """x @ W[name], W8A8 when quantized params are present.

    The int32 accumulator comes from the execution-backend registry
    (``cfg.backend``: the ``cuda`` kernels by default, the ``ref`` plain
    oracle on request); with ``cfg.policy_map`` set, the site
    ``ffn.<name>`` resolves to a policy (and optionally a backend) and the
    accumulator runs through ``dependable_matmul_acc``.  The rescale is
    ``acc.f32 * x_s * w_s``, then a cast, in the reference's order.

    ``red``: a row-parallel product (x holds this rank's slice of the
    contraction dim, W its rows); the row absmax is made global before the
    quantization and the int32 accumulators (or the float products) are
    summed by ``red``."""
    if name + "_q" not in bp:
        y = x @ _w(cfg, bp[name])
        return y if red is None else red.sum(y)
    from repro_torch.kernels import dispatch
    x_q, x_s = _quantize_act(x, None if red is None else red.amax)
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
    if red is not None:
        acc, x_s = red.sum(acc), red.rows(x_s)
    y = acc.to(torch.float32) * x_s * bp[name + "_s"]
    return y.to(x.dtype)


def _qeinsum(cfg: ArchConfig, x, bp, name, red: Optional[RowSum] = None):
    """The expert products (E, C, K) × (E, K, N) → (E, C, N), W8A8 when
    quantized: the activations quantized per row once, then one int32
    accumulator per expert from ``dispatch.matmul_acc`` on ``cfg.backend``
    (every expert, empty ones too, as the reference's einsum computes
    every expert), then ``acc.f32 * x_s * w_s``, then a cast.  ``red``
    as in ``_qdot`` (``etp``'s ``we_o``, K split over the model axis)."""
    if name + "_q" not in bp:
        y = torch.bmm(x, _w(cfg, bp[name]))
        return y if red is None else red.sum(y)
    from repro_torch.kernels import dispatch
    x_q, x_s = _quantize_act(x, None if red is None else red.amax)
    w_q = bp[name + "_q"]
    acc = torch.stack([dispatch.matmul_acc(x_q[e], w_q[e],
                                           backend=cfg.backend)
                       for e in range(w_q.shape[0])])
    if red is not None:
        acc = red.sum(acc)
    y = acc.to(torch.float32) * x_s * bp[name + "_s"][:, None, :]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """The reference's parameter dict, drawn from ``gen`` on its device
    and moved to ``device``: ``dense_blocks`` for the dense layers,
    ``moe_blocks`` for the MoE layers (either absent when it has none),
    each stacked on axis 0.  Blocks are drawn before the embedding, each
    block's leaves in the reference's order; under W8A8 each FFN and
    expert weight is quantized as soon as it is drawn, so its bf16 or f32
    copy never meets the next one."""
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    pdt = _pdt(cfg)
    quant = cfg.quant == "w8a8_ffn"
    n_moe = _n_moe(cfg)

    def block_params(n, moe):
        if n == 0:
            return None
        p = {}

        def put(name, t):
            t = t.to(dev)
            if quant and name in _FFN_WEIGHTS:
                p[name + "_q"], p[name + "_s"] = quantize_ffn_weight(t)
            else:
                p[name] = t

        def stack(name, shape):
            put(name, common.dense_init(gen, (n,) + shape, in_axis=1,
                                        dtype=pdt))

        for name, width in (("ln1", d), ("ln2", d)):
            put(name, torch.zeros((n, width), dtype=pdt))
        stack("wq", (d, H * hd))
        stack("wk", (d, KV * hd))
        stack("wv", (d, KV * hd))
        stack("wo", (H * hd, d))
        if cfg.qk_norm:
            put("q_norm", torch.zeros((n, hd), dtype=pdt))
            put("k_norm", torch.zeros((n, hd), dtype=pdt))
        if cfg.use_bias:
            for name, width in (("bq", H * hd), ("bk", KV * hd),
                                ("bv", KV * hd)):
                put(name, torch.zeros((n, width), dtype=pdt))
        if not moe:
            stack("wi", (d, ff))
            stack("wg", (d, ff))
            stack("wd", (ff, d))
            return p
        m = cfg.moe
        put("router", common.dense_init(gen, (n, d, m.n_experts), in_axis=1,
                                        dtype=pdt).to(torch.float32))
        stack("we_g", (m.n_experts, d, m.d_expert))
        stack("we_i", (m.n_experts, d, m.d_expert))
        stack("we_o", (m.n_experts, m.d_expert, d))
        if m.n_shared_experts:
            ds = m.d_expert * m.n_shared_experts
            stack("ws_g", (d, ds))
            stack("ws_i", (d, ds))
            stack("ws_o", (ds, d))
        return p

    params = {"dense_blocks": block_params(cfg.n_layers - n_moe, False),
              "moe_blocks": block_params(n_moe, True)}
    params["embed"] = common.embed_init(gen, (V, d), dtype=pdt).to(dev)
    params["final_norm"] = torch.zeros((d,), dtype=pdt, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(gen, (d, V), dtype=pdt).to(dev)
    return {k: v for k, v in params.items() if v is not None}


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


def _qkv(cfg: ArchConfig, bp, h, positions):
    """The projections of the normed ``h``, qk-norm and RoPE: q
    (B,S,H,hd), k/v (B,S,KV,hd) — or this rank's heads of each, from
    column shards."""
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    q = h @ _w(cfg, bp["wq"])
    k = h @ _w(cfg, bp["wk"])
    v = h @ _w(cfg, bp["wv"])
    if cfg.use_bias:
        q = q + _w(cfg, bp["bq"])
        k = k + _w(cfg, bp["bk"])
        v = v + _w(cfg, bp["bv"])
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, bp["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, bp["k_norm"], cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


_Q_LEAVES = ("wq", "bq", "wo")
_KV_LEAVES = ("wk", "wv", "bk", "bv")
_ATTN_LEAVES = ("ln1", "q_norm", "k_norm") + _Q_LEAVES + _KV_LEAVES


def _heads_tp(cfg: ArchConfig, sh) -> tuple:
    """(q's heads local to the model axis, k's and v's too): the
    reference's qspec/kvspec rule."""
    if sh is None or not sh.tp:
        return False, False
    tq = cfg.n_heads % sh.msize == 0
    return tq, tq and cfg.n_kv_heads % sh.msize == 0


def _kv_of_local_q(cfg: ArchConfig, sh, q, k, v):
    """k and v for this rank's q heads over replicated KV heads: each
    local q head's own KV head (group 1)."""
    G = cfg.n_heads // cfg.n_kv_heads
    hl = q.shape[2]
    idx = (torch.arange(hl) + sh.mesh.axis_index(sh.ctx.model) * hl) // G
    idx = idx.to(q.device)
    return k[:, :, idx], v[:, :, idx]


def _attn_weights(cfg: ArchConfig, bp, sh, tq: bool, tkv: bool):
    """One layer's attention leaves for use: FSDP dims gathered, the model
    dim kept where the heads are tensor-parallel."""
    return {k: sh.gather(v, k, keep_model=tq if k in _Q_LEAVES else tkv)
            for k, v in bp.items() if k in _ATTN_LEAVES}


def _attention(cfg: ArchConfig, bp, x, positions, sh=None, seq=False):
    """Full-sequence attention block: (x + attn, k, v) — k and v as the
    KV cache holds them (this rank's KV heads where they are local).
    ``seq``: x is this rank's S/m rows of the sequence, the normed rows
    are gathered whole before the projections and the output comes back
    onto the rows (``Sharded.seq_split``)."""
    tq, tkv = _heads_tp(cfg, sh)
    w = bp if sh is None else _attn_weights(cfg, bp, sh, tq, tkv)
    h = common.rms_norm(x, w["ln1"], cfg.norm_eps)
    if seq:
        h = sh.model_gather(h, 1)
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, w, h, positions)
    kq, vq = _kv_of_local_q(cfg, sh, q, k, v) if tq and not tkv else (k, v)
    if cfg.attn_impl == "flash":
        o = flash_attn_model(q, kq, vq, window=cfg.swa_window)
    else:
        o = common.chunked_causal_attention(q, kq, vq, window=cfg.swa_window)
    y = o.reshape(B, S, -1) @ _w(cfg, w["wo"])
    if tq:
        y = (sh.row_seq if seq else sh.row).sum(y)
    elif seq:
        y = sh.model_slice(y, 1)
    return x + y, k, v


_FFN_LEAVES = ("wg", "wi", "wd") + tuple(n + sfx for n in ("wg", "wi", "wd")
                                         for sfx in ("_q", "_s"))


def _dense_ffn(cfg: ArchConfig, bp, x, sh=None, seq=False):
    """x + the FFN of its norm; ``seq`` as in ``_attention``."""
    h = common.rms_norm(x, bp["ln2"], cfg.norm_eps)
    red = None
    if sh is not None:
        bp = {k: sh.gather(v, k, keep_model=True) if k in _FFN_LEAVES else v
              for k, v in bp.items()}
        if sh.tp:
            red = sh.row_seq if seq else sh.row
        if seq:
            h = sh.model_gather(h, 1)
    act = F.silu(_qdot(cfg, h, bp, "wg")) * _qdot(cfg, h, bp, "wi")
    return x + _qdot(cfg, act, bp, "wd", red)


# ------------------------------- MoE ----------------------------------------


class Route(NamedTuple):
    """``_local_route``'s maps over the (E_loc·C,) buffer rows, and
    ``tslot`` (n, top_k): each token's buffer rows in ascending order,
    E_loc·C where the choice was dropped or went to another rank's
    experts."""
    gather_idx: torch.Tensor     # (E_loc·C,) int64 token row of each row
    gates: torch.Tensor          # (E_loc·C,) f32
    filled: torch.Tensor         # (E_loc·C,) bool
    aux: torch.Tensor            # () f32 load-balance loss
    z_loss: torch.Tensor         # () f32
    tslot: torch.Tensor          # (n, top_k) int64


def capacity(m, n: int) -> int:
    """Buffer rows per expert for ``n`` routed tokens (Python arithmetic on
    a static n, as the reference)."""
    return max(int(m.top_k * n * m.capacity_factor / m.n_experts), 4)


def _local_route(h: torch.Tensor, router_w: torch.Tensor, m, cap: int,
                 e_lo: int = 0, E_loc: Optional[int] = None) -> Route:
    """Sort-based capacity routing of the (n, d) tokens ``h`` for the
    ``E_loc`` experts starting at ``e_lo`` (default all ``m.n_experts``),
    the reference's ``_local_route``.  The router product is f32 (never
    TF32: a flipped near tie sends a token elsewhere; f64 under a float64
    compute dtype, the precision witness); top-k is a stable
    descending sort (a tie to the lower index, as ``jax.lax.top_k``); the
    sort by local expert, the other ranks' choices last, is stable
    (``jnp.argsort``), so within an expert earlier tokens keep their slots
    and later ones are dropped.  Dropped and foreign assignments go to an
    overflow row E_loc·C, sliced off, so no write falls out of range."""
    n = h.shape[0]
    E, k = m.n_experts, m.top_k
    E_loc = E if E_loc is None else E_loc
    dev = h.device
    acc = torch.promote_types(h.dtype, torch.float32)   # f64: the witness
    logits = h.to(acc) @ router_w.to(acc)
    probs = torch.softmax(logits, dim=-1)                        # (n, E)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)             # renormalise

    local_e = top_i.reshape(-1) - e_lo                          # (n·k,)
    is_local = (local_e >= 0) & (local_e < E_loc)
    key = torch.where(is_local, local_e, E_loc)                 # foreign last
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(key, stable=True)
    se, st, sg = key[order], flat_t[order], top_p.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(E_loc + 1, device=dev))
    pos = torch.arange(n * k, device=dev) - starts[se]
    keep = (se < E_loc) & (pos < cap)
    slot = torch.where(keep, se * cap + pos, E_loc * cap)       # overflow row
    gather_idx = torch.zeros(E_loc * cap + 1, dtype=torch.int64, device=dev)
    gates = torch.zeros(E_loc * cap + 1, dtype=acc, device=dev)
    filled = torch.zeros(E_loc * cap + 1, dtype=torch.bool, device=dev)
    gather_idx[slot] = st
    gates[slot] = sg
    filled[slot] = keep
    # each token's buffer rows: slot of assignment i sits at order^-1[i]
    tslot = torch.empty_like(slot)
    tslot[order] = slot
    tslot = torch.sort(tslot.reshape(n, k), dim=-1).values
    # aux-loss ingredients (load balance over the global expert set)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_i, E).to(acc).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return Route(gather_idx[:-1], gates[:-1], filled[:-1], aux, z_loss,
                 tslot)


def _combine(out: torch.Tensor, route: Route) -> torch.Tensor:
    """The (E·C, d) gated expert rows onto the (n, d) token rows: each
    token's kept rows added in ascending buffer order, the order in which
    the reference's scatter-add meets them; a dropped choice adds an exact
    zero.  Gathers only, so two runs sum in the same order."""
    rows = torch.cat([out, out.new_zeros((1, out.shape[1]))])
    combined = rows[route.tslot[:, 0]]
    for j in range(1, route.tslot.shape[1]):
        combined = combined + rows[route.tslot[:, j]]
    return combined


def moe_mode(cfg: ArchConfig, model_size: int) -> str:
    """'ep' when experts divide the model axis, else expert-TP fallback."""
    return "ep" if cfg.moe.n_experts % model_size == 0 else "etp"


def _moe_ffn(cfg: ArchConfig, bp, x, sh=None, seq=False):
    """The reference's ``_moe_ffn_single`` (and, under ``sh``, its
    ``_moe_ffn_local``): (x + routed + shared, aux, z_loss) for x (B, S,
    d); all B·S tokens (this rank's) share the experts' capacity.
    ``seq``: x is this rank's S/m rows; the normed rows are gathered whole
    (the reference's ``x_spec``), so that the same B·S tokens route, and
    the sums come back onto the rows."""
    m = cfg.moe
    B, _, d = x.shape
    h = common.rms_norm(x.reshape(-1, d), bp["ln2"], cfg.norm_eps)
    if seq:
        h = sh.model_gather(h.reshape(B, -1, d), 1).reshape(-1, d)
    n = h.shape[0]
    S = n // B
    cap = capacity(m, n)
    E_loc, e_lo, ep, etp = m.n_experts, 0, None, None
    if sh is not None:
        bp = {k: sh.gather(v, k, keep_model=True)
              for k, v in bp.items() if k not in _ATTN_LEAVES}
        dim = sh.model_local("we_g_q" if "we_g_q" in bp else "we_g", 3)
        ep = sh.row if dim == 0 else None
        etp = sh.row if dim == 2 else None
        if ep is not None:
            E_loc = m.n_experts // sh.msize
            e_lo = sh.mesh.axis_index(sh.ctx.model) * E_loc
    route = _local_route(h, bp["router"], m, cap, e_lo, E_loc)
    buf = torch.where(route.filled[:, None], h[route.gather_idx], 0)
    buf = buf.reshape(E_loc, cap, d)
    act = F.silu(_qeinsum(cfg, buf, bp, "we_g")) * \
        _qeinsum(cfg, buf, bp, "we_i")
    out = _qeinsum(cfg, act, bp, "we_o", etp).reshape(-1, d) * \
        route.gates[:, None]
    combined = _combine(out, route)
    red = None if sh is None else sh.row
    if seq:                     # (B, S, ·): the sums onto this rank's rows
        combined, red = combined.reshape(B, S, d), sh.row_seq
        if ep is None:          # etp: whole rows on every rank
            combined = sh.model_slice(combined, 1)
    if ep is not None:
        combined = red.sum(combined)
    if m.n_shared_experts:
        sact = F.silu(_qdot(cfg, h, bp, "ws_g")) * _qdot(cfg, h, bp, "ws_i")
        if seq:
            sact = sact.reshape(B, S, -1)
        combined = combined + _qdot(cfg, sact, bp, "ws_o", red)
    aux, z = route.aux, route.z_loss
    if sh is not None:
        aux, z = sh.pmean_all(torch.stack([aux, z])).unbind()
    return x + combined.reshape(x.shape).to(x.dtype), aux, z


def _ffn(cfg: ArchConfig, bp, x, moe: bool, sh=None, seq=False):
    """The block's FFN half: (x, aux, z_loss), aux and z None when dense."""
    if moe:
        return _moe_ffn(cfg, bp, x, sh, seq)
    return _dense_ffn(cfg, bp, x, sh, seq), None, None


def _logits(cfg: ArchConfig, params, x, sh=None, vocab_local=False,
            seq=False):
    """Final norm and head: the tied embedding's transpose or
    ``lm_head``, gathered where it is used under ``sh``.  With
    ``vocab_local`` and ``sh.vocab_split`` the head is gathered over the
    dp axes only: this rank's columns of the vocabulary, (B, S, V/m)
    logits (the loss's, ``shard.cross_entropy``).  ``seq``: x is this
    rank's S/m rows, normed there and then gathered whole."""
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if seq:
        x = sh.model_gather(x, 1)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = params[name] if sh is None else sh.gather(
        params[name], name, keep_model=vocab_local and sh.vocab_split)
    if cfg.tie_embeddings:
        head = head.T
    return x @ head.to(x.dtype)


def _embed(cfg: ArchConfig, params, tokens, sh=None, seq=False):
    """The embedding rows of ``tokens``, an out-of-range id read as JAX's
    gather reads it: negative ids count from the end once, then clamp.
    Where ``sh.vocab_split`` the table is this rank's rows ``[v_lo, v_lo
    + V/m)`` (gathered over the dp axes only): the ids in them are looked
    up, the others read zero, and one SUM over the model axis gives every
    row (one nonzero term each, so exact); the gradient reaches only this
    rank's rows.  ``seq``: only this rank's S/m positions are returned
    (the SUM a reduce-scatter onto them)."""
    split = sh is not None and sh.vocab_split
    table = params["embed"] if sh is None else sh.gather(
        params["embed"], "embed", keep_model=split)
    V = table.shape[0] * (sh.msize if split else 1)
    ids = tokens.long()
    ids = torch.clamp(torch.where(ids < 0, ids + V, ids), 0, V - 1)
    if not split:
        if seq:
            ids = sh.model_slice(ids, 1)
        return F.embedding(ids, table).to(_cdt(cfg))
    local = ids - sh.vocab_lo(table.shape[0])
    mine = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(mine, local, 0), table).to(_cdt(cfg))
    rows = torch.where(mine[..., None], rows, 0)
    return sh.row_seq.sum(rows) if seq else sh.vocab_sum(rows)


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def _block(cfg: ArchConfig, bp, x, positions, moe, sh=None, seq=False):
    x, _, _ = _attention(cfg, bp, x, positions, sh, seq)
    return _ffn(cfg, bp, x, moe, sh, seq)


def _blocks(params):
    """Every layer as (block dict, is MoE): the dense layers, then the MoE
    layers, as the KV cache numbers them."""
    return [(bp, moe) for blk, moe in (("dense_blocks", False),
                                       ("moe_blocks", True))
            if params.get(blk) is not None
            for bp in _layers(params[blk])]


def _inputs(cfg: ArchConfig, params, tokens, embeds=None, sh=None,
            seq=False):
    """The token embeddings, or ``embeds`` in their place, in the compute
    dtype; ``seq``: this rank's S/m positions of them."""
    if embeds is None:
        return _embed(cfg, params, tokens, sh, seq)
    x = embeds.to(_cdt(cfg))
    return sh.model_slice(x, 1) if seq else x


def _trunk(cfg: ArchConfig, params, tokens, keep_kv=None, remat=False,
           embeds=None, sh=None, vocab_local=False, seq=False):
    """Embed (or take ``embeds`` (B, S, d) in its place), every block, final
    norm and head; ``keep_kv(layer, k, v)`` receives each layer's K/V;
    ``remat`` recomputes each block in the backward; ``vocab_local`` as in
    ``_logits``; ``seq``: the stream between blocks is this rank's S/m
    rows (``Sharded.seq_split``).  Returns (logits, aux, z_loss), the last
    two summed over the MoE layers."""
    S = (tokens if embeds is None else embeds).shape[1]
    x = _inputs(cfg, params, tokens, embeds, sh, seq)
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, (bp, moe) in enumerate(_blocks(params)):
        if remat:
            x, a, z = common.recompute(_block, cfg, bp, x, positions, moe,
                                       sh, seq)
        else:
            x, k, v = _attention(cfg, bp, x, positions, sh, seq)
            if keep_kv is not None:
                keep_kv(li, k, v)
            x, a, z = _ffn(cfg, bp, x, moe, sh, seq)
        if moe:
            aux, zl = aux + a, zl + z
    return _logits(cfg, params, x, sh, vocab_local, seq), aux, zl


def _remat(cfg: ArchConfig, params) -> bool:
    """Recompute blocks when ``cfg.remat`` asks and a gradient will flow."""
    return common.remat_wanted(cfg, [
        t for blk in ("dense_blocks", "moe_blocks")
        for t in (params.get(blk) or {}).values()])


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, ctx=None,
            embeds=None, vocab_local=False) -> ForwardOut:
    """tokens: (B, S) int (or embeds (B, S, d)) → logits (B, S, V), and the
    MoE layers' mean aux and z losses (zero for a dense config).  Under
    ``ctx`` the tokens, the logits and ``params`` are this rank's; the
    logits are whole (the head gathered over the model axis) unless
    ``vocab_local`` asks for this rank's columns of the vocabulary where
    it is split (``Sharded.vocab_split``), as ``loss_fn`` does.  Under
    ``cfg.seq_shard`` the stream between blocks is this rank's S/m rows
    where ``Sharded.seq_split`` says so (the logits whole all the
    same)."""
    sh = sharded(cfg, ctx)
    S = (tokens if embeds is None else embeds).shape[1]
    logits, aux, zl = _trunk(cfg, params, tokens, remat=_remat(cfg, params),
                             embeds=embeds, sh=sh, vocab_local=vocab_local,
                             seq=sh is not None and sh.seq_split(S))
    denom = max(_n_moe(cfg), 1)
    return ForwardOut(logits, aux / denom, zl / denom)


def loss_fn(cfg: ArchConfig, params, batch, ctx=None):
    """(mean next-token CE plus, for MoE, ``aux_loss``·aux +
    ``router_z_loss``·z, {"ce", "aux", "z"}) of ``batch`` ("tokens",
    "labels", optional "mask"); under ``ctx`` the CE is the global
    batch's, from this rank's rows."""
    out = forward(cfg, params, batch["tokens"], ctx,
                  embeds=batch.get("embeds"), vocab_local=True)
    loss = cross_entropy(sharded(cfg, ctx), out.logits, batch["labels"],
                         batch.get("mask"))
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss * out.aux_loss \
            + cfg.moe.router_z_loss * out.z_loss
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


def _empty_cache(cfg: ArchConfig, B: int, T: int, dtype, dev) -> KVCache:
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.resolved_head_dim)
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


def init_cache(cfg: ArchConfig, B: int, max_len: int, dtype=None, *,
               device="cuda") -> KVCache:
    return _empty_cache(cfg, B, cache_len(cfg, max_len), dtype,
                        resolve_device(device))


def _time_shards(cfg: ArchConfig, sh):
    """(axes, ranks, this rank's index) of a KV cache's time dim under
    ``sh`` (``cache_specs``: the model axis unless it is folded into
    dp)."""
    if sh is None:
        return (), 1, 0
    from repro_torch.parallel.sharding import cache_specs
    axes = entry_axes(cache_specs(cfg, sh.ctx.dp,
                                  sh.ctx.model if sh.tp else None).k[2])
    if not axes:
        return (), 1, 0
    return axes, sh.mesh.size(axes), sh.mesh.index(axes)


def decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                cache: KVCache, ctx=None, embed=None):
    """token: (B,) int (or embed (B, d)).  Writes each layer's new K/V row
    into ``cache`` in place (slot ``length % T`` of each row), advances
    ``length`` and returns (logits (B, V), cache).  Under ``ctx`` the
    tokens and ``cache`` are this rank's (``cache_specs``)."""
    sh = sharded(cfg, ctx)
    x = _inputs(cfg, params, token, embed, sh)[:, None, :]
    B = x.shape[0]
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    pos = cache.length
    rows = torch.arange(B, device=x.device)
    if sh is None:
        T = cache.k.shape[2]
        slot = (pos % T).long()
        valid = torch.clamp(pos + 1, max=T)
        write, t0, reduce = None, 0, None
    else:
        Tl = cache.k.shape[2]
        axes, n, i = _time_shards(cfg, sh)
        T, t0 = Tl * n, i * Tl
        gslot = (pos % T).long()
        own = (gslot >= t0) & (gslot < t0 + Tl)
        slot = torch.clamp(gslot - t0, 0, Tl - 1)
        valid = torch.clamp(pos + 1, max=T)

        def write(page, new):       # the row where this rank owns its slot
            new = new.to(page.dtype)
            old = page[rows, slot]
            page[rows, slot] = torch.where(
                own.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        def reduce(t, op):
            return C.all_reduce(t, sh.mesh, axes, op=op)
        reduce = reduce if n > 1 else None    # one shard: the whole T
    for li, (bp, moe) in enumerate(_blocks(params)):
        w = bp if sh is None else _attn_weights(cfg, bp, sh, False, False)
        q, k, v = _qkv(cfg, w, common.rms_norm(x, w["ln1"], cfg.norm_eps),
                       pos[:, None])
        kv = ((cache.k[li], k[:, 0]), (cache.v[li], v[:, 0]))
        if cache.k_s is not None:                    # int8 KV cache
            k_q, k_sc = _quantize_kv_rows(k[:, 0])   # (B, KV, hd), (B, KV)
            v_q, v_sc = _quantize_kv_rows(v[:, 0])
            kv = ((cache.k[li], k_q), (cache.v[li], v_q),
                  (cache.k_s[li], k_sc), (cache.v_s[li], v_sc))
        for page, new in kv:
            if write is None:
                page[rows, slot] = new.to(page.dtype)
            else:
                write(page, new)
        if cache.k_s is not None:
            o = common.decode_attention(q, cache.k[li], cache.v[li], valid,
                                        k_scale=cache.k_s[li],
                                        v_scale=cache.v_s[li], t0=t0,
                                        reduce=reduce)
        else:
            o = common.decode_attention(q, cache.k[li], cache.v[li], valid,
                                        t0=t0, reduce=reduce)
        x = x + (o.reshape(B, 1, H * hd) @ _w(cfg, w["wo"])).to(x.dtype)
        x = _ffn(cfg, bp, x, moe, sh)[0]    # MoE: the B rows route as one batch
    cache.length.add_(1)
    return _logits(cfg, params, x, sh).reshape(B, -1), cache


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, max_len: int,
            ctx=None, embeds=None):
    """Full-sequence forward that also fills a fresh KV cache in the same
    pass; ``embeds`` (B, S, d) takes the place of the token embedding.
    Returns (logits (B, S, V), cache).  Under ``ctx`` the tokens, the
    logits and the cache are this rank's (``cache_specs``: its slots of
    the time dim)."""
    sh = sharded(cfg, ctx)
    src = tokens if embeds is None else embeds
    B, S = src.shape[:2]
    T = cache_len(cfg, max_len)
    axes, n, i = _time_shards(cfg, sh)
    if T % n:
        raise ValueError(f"KV cache: {T} slots do not split over axis "
                         f"{axes} ({n} ways)")
    t0 = i * (T // n)
    cache = _empty_cache(cfg, B, T // n, None, src.device)
    tc = min(T, S)
    # keep the last T positions; SWA rings put position p at slot p % T
    ring = cfg.swa_window is not None and S >= T
    slots = (torch.arange(tc) + (S - tc)) % T if ring else torch.arange(tc)
    mine = torch.nonzero((slots >= t0) & (slots < t0 + T // n)).flatten()
    src_i, dst_i = mine.to(src.device), (slots[mine] - t0).to(src.device)
    everything = sh is None and not ring

    def write(page, new):
        if everything:
            page[:, :tc] = new
        else:
            page[:, dst_i] = new[:, src_i]

    _, tkv = _heads_tp(cfg, sh)

    def keep(li, k, v):
        k, v = k[:, S - tc:], v[:, S - tc:]
        if tkv:                     # this rank's KV heads: the cache's all
            k = C.all_gather(k, sh.mesh, sh.ctx.model, dim=2)
            v = C.all_gather(v, sh.mesh, sh.ctx.model, dim=2)
        if cache.k_s is None:
            write(cache.k[li], k.to(cache.k.dtype))
            write(cache.v[li], v.to(cache.v.dtype))
            return
        for page, scales, new in ((cache.k[li], cache.k_s[li], k),
                                  (cache.v[li], cache.v_s[li], v)):
            q, sc = _quantize_kv_rows(new)
            write(page, q)
            write(scales, sc)

    logits = _trunk(cfg, params, tokens, keep_kv=keep, embeds=embeds,
                    sh=sh)[0]
    cache.length.fill_(S)
    return logits, cache
