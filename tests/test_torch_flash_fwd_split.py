"""The bf16 attention forward's operand split, emulated on the CPU.

``flashattn.cu`` runs the bf16 forward on tensor-core products with bf16
operands and f32 accumulators, over 64-key tiles.  S = Q·Kᵀ takes its
operands straight from bf16 memory, so it is exact.  P is an f32 value
formed on the accumulators; the P·V product takes it as a pair of bf16
values, hi = bf16(p) and lo = bf16(p - hi), two products summed in f32.

This file emulates that numerics without the kernel: per 64-key tile, S in
f32 from the bf16 inputs, the online softmax (m, alpha, p, l) in f32, P
split (or, to show why, rounded once, or kept in f32), the PV product in
f64 from the rounded operands and rounded to f32, the accumulator rescaled
and summed in f32, and ``out`` rounded to bf16 as the kernel stores it.
The result is held to the plain version ``ref.flash_plain`` (f32, 32-key
tiles) under ``chip_smoke.py``'s limit for bf16 outputs: one bf16 step of
|w| plus the f32 term 1e-5·(1 + |w|).  Rounding P once breaks that limit
many times over, so the split stays; and even exact f32 products summed in
another order break the older limit of one step alone, so the limit has
the f32 term.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flashattn import ref as R

CASES = [
    # B, H, KV, S, hd, window; causal
    (1, 9, 3, 1024, 64, None),         # the SmolLM-135M prefill shape
    (1, 9, 3, 300, 64, 100),           # a window
    (1, 4, 2, 1000, 128, None),        # hd = 128, ragged S
]
TILE = 64                              # the kernel's keys per tile


def _inputs(seed, B, H, KV, S, hd):
    """Seeded normal bf16 q (B, H, S, hd) and k, v (B, KV, S, hd)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(torch.bfloat16)
                 for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))


def split(x: torch.Tensor):
    """(hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def emulate(q, k, v, *, window=None, operand="split"):
    """out in bf16 as the tensor-core kernel forms it.  ``operand`` is how
    P enters P·V: "split" (hi + lo, the kernel), "round" (bf16 once) or
    "f32" (exact f32 products, only the summation order differs)."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qd = q.double()
    kd, vd = R.gqa_expand(k, G).double(), R.gqa_expand(v, G).double()
    m = torch.full((B, H, S), R.NEG_INF, dtype=torch.float32)
    l_sum = torch.zeros((B, H, S), dtype=torch.float32)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32)
    pos = torch.arange(S)
    for k_lo in range(0, S, TILE):
        kb, vb = kd[:, :, k_lo:k_lo + TILE], vd[:, :, k_lo:k_lo + TILE]
        s = torch.matmul(qd, kb.transpose(-1, -2)).float() * scale
        s = torch.where(R.band_mask(pos, pos[k_lo:k_lo + TILE], True, window),
                        s, R.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(dim=-1)
        if operand == "split":
            hi, lo = split(p)
            pd = hi.double() + lo.double()
        elif operand == "round":
            pd = p.to(torch.bfloat16).double()
        else:
            pd = p.double()
        acc = acc * alpha[..., None] + torch.matmul(pd, vb).float()
        m = m_new
    return (acc / torch.clamp(l_sum, min=1e-30)[..., None]).to(torch.bfloat16)


def _step(w):
    """One bf16 step at the magnitude of each element of ``w``."""
    return torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126)))
                      - 7)


def limit_ratio(got, want, *, f32_term=True) -> float:
    """max err / limit: ``chip_smoke._flash_err``'s bf16 limit, one bf16
    step of |w| plus 1e-5·(1 + |w|); without ``f32_term`` the older limit of
    one step alone."""
    g, w = got.float(), want.float()
    lim = _step(w) + (1e-5 * (1 + w.abs()) if f32_term else 0.0)
    return float(((g - w).abs() / lim).max())


def _case(i):
    B, H, KV, S, hd, window = CASES[i]
    q, k, v = _inputs(17, B, H, KV, S, hd)
    return (q, k, v), window, R.flash_plain(q, k, v, window=window)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_split_operand_within_chip_limit(i):
    args, window, want = _case(i)
    got = emulate(*args, window=window)
    assert got.dtype == want.dtype == torch.bfloat16
    assert limit_ratio(got, want) <= 1.0


def test_single_rounding_breaks_chip_limit():
    """P rounded once to bf16: out leaves the limit by more than 10× — the
    reason the kernel splits it."""
    args, window, want = _case(0)
    got = emulate(*args, window=window, operand="round")
    assert limit_ratio(got, want) > 10.0


def test_f32_reordering_breaks_one_step_limit():
    """Exact f32 products in another summation order already leave one bf16
    step alone, on outputs that cancel to near zero — the reason the limit
    has the f32 term — and stay within the limit with it."""
    args, window, want = _case(0)
    got = emulate(*args, window=window, operand="f32")
    assert limit_ratio(got, want, f32_term=False) > 1.0
    assert limit_ratio(got, want) <= 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_hi_lo_reconstructs_f32(seed):
    """hi + lo is x within 2^-16·|x| over the probabilities' range (0, 1]
    and beyond, zero included."""
    rng = np.random.default_rng(seed)
    x = rng.random(4096) * np.exp2(rng.integers(-40, 4, 4096))
    x = torch.from_numpy(np.concatenate([x, [0.0, 1.0, 0.5]])).float()
    hi, lo = split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())
    assert bool((hi.float() == x.to(torch.bfloat16).float()).all())
