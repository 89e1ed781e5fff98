"""Plain PyTorch versions of the flash-attention kernels, and the oracle.

Three groups, all runnable on the CPU and on the card:

* ``flash_plain`` computes what the three hand kernels in ``kernel.py``
  compute (``flash_attention``, ``flash_attention_checked``,
  ``flash_attention_fwd_lse``): one blocked online softmax over K tiles of
  ``block_k`` keys, in f32 whatever the input type, with the reference's
  semantics — NEG_INF = -1e30 for masked scores, ``l`` clamped at 1e-30,
  the 1/sqrt(hd) scale multiplied after the QKᵀ product, q-head h reading
  kv-head h // G, output cast to q's type.  ``out`` is computed by the
  same operations whichever extra outputs are asked for, so it is bit
  identical across the three (ABFT recovery swaps rows of one for the
  other's).  The kernel wrappers run it for CPU tensors, and
  ``chip_smoke.py`` holds each kernel against it on the card.
* ``flash_bwd_plain`` computes what the two backward kernels compute
  (``flash_attention_bwd``): the probabilities rebuilt from the forward's
  lse, dS = P (dP - dvec) scale with dvec = rowsum(dO * O), and dQ, dK, dV
  from them, K tile by K tile, in f32, the GQA group summed into its kv
  head.
* ``attention_ref`` is the reference's ``repro.kernels.flashattn.ref``:
  materialised (S, S) scores and one softmax.

Every query row's tile loop runs over all K tiles: a tile that lies
wholly above the diagonal (or outside the window) for a row adds exactly
nothing once the row has seen a valid key (alpha = 1, p = 0), and one it
meets before any valid key is scaled away exactly (alpha = exp(-1e30 - m)
= 0) — the kernels' tile skipping changes no value.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.abft import output_row_checksums

NEG_INF = -1e30


def gqa_expand(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, KV, S, hd) → (B, KV·G, S, hd) f32: q-head h reads kv-head h // G."""
    return t.to(torch.float32).repeat_interleave(groups, dim=1)


def band_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(len(q_pos), len(k_pos)) bool: key visible from query (causal: not
    after it; windowed: at most ``window`` positions before it)."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] >= q_pos[:, None] - window
    return mask


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                block_k: int = 32, emit: str = "out"):
    """Blocked online-softmax attention.  q (B, H, S, hd), k/v (B, KV, S,
    hd).  ``emit`` picks the outputs:

      "out"      out (B, H, S, hd) in q's dtype
      "lse"      (out, lse (B, H, S) f32 = m + log l)
      "checked"  (out, check (B, H, S) f32, csum (B, H, S) int64): check is
                 the independent accumulation c ← c·α + p·rowsum_hd(v),
                 divided by l; csum the exact per-row mod-2^32 sum of out's
                 bit patterns (``core.abft.output_row_checksums``)
    """
    if emit not in ("out", "lse", "checked"):
        raise ValueError(f"emit must be out, lse or checked, not {emit!r}")
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32)
    kf, vf = gqa_expand(k, G), gqa_expand(v, G)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=dev)
    c = torch.zeros_like(l_sum)
    q_pos = torch.arange(S, device=dev)
    for k_lo in range(0, S, block_k):
        kb = kf[:, :, k_lo:k_lo + block_k]
        vb = vf[:, :, k_lo:k_lo + block_k]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        mask = band_mask(q_pos, q_pos[k_lo:k_lo + block_k], causal, window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        if emit == "checked":
            c = c * alpha + (p * vb.sum(dim=-1)[:, :, None, :]).sum(dim=-1)
        m = m_new
    l_sum = torch.clamp(l_sum, min=1e-30)
    out = (acc / l_sum[..., None]).to(q.dtype)
    if emit == "lse":
        return out, m + torch.log(l_sum)
    if emit == "checked":
        return out, c / l_sum, output_row_checksums(out)
    return out


def bwd_dvec(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """dvec (B, H, S) f32 = rowsum(dO * O), the softmax backward's row term
    (the reference's ``flash_attention_bwd``, kernel.py:583)."""
    return (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_k: int = 32):
    """(dq, dk, dv) of attention, q/out/do (B, H, S, hd), k/v (B, KV, S,
    hd), lse (B, H, S) f32 from the forward.  Per K tile of ``block_k``
    keys: P = exp(QKᵀ·scale - lse) where the key is visible (0 elsewhere),
    dP = dO·Vᵀ, dS = P∘(dP - dvec)·scale; dQ += dS·K, dK = dSᵀ·Q,
    dV = Pᵀ·dO.  f32 throughout; the gradients in the inputs' dtypes."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf, dof = q.to(torch.float32), do.to(torch.float32)
    kf, vf = gqa_expand(k, G), gqa_expand(v, G)
    dvec = bwd_dvec(do, out)[..., None]
    lse = lse[..., None]
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    pos = torch.arange(S, device=q.device)
    for k_lo in range(0, S, block_k):
        kb = kf[:, :, k_lo:k_lo + block_k]
        vb = vf[:, :, k_lo:k_lo + block_k]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        mask = band_mask(pos, pos[k_lo:k_lo + block_k], causal, window)
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - dvec) * scale
        dq += torch.matmul(ds, kb)
        dk[:, :, k_lo:k_lo + block_k] = torch.matmul(ds.transpose(-1, -2), qf)
        dv[:, :, k_lo:k_lo + block_k] = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.reshape(B, KV, G, S, hd).sum(dim=2)
    dv = dv.reshape(B, KV, G, S, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,S,hd), k/v (B,KV,S,hd) → (B,H,S,hd).  Materialises (S,S)."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    s = torch.matmul(q.to(torch.float32), gqa_expand(k, G).transpose(-1, -2)) \
        / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    s = torch.where(band_mask(pos, pos, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, gqa_expand(v, G)).to(q.dtype)
