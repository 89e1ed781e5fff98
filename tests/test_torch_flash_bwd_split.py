"""The bf16 attention backward's operand split, emulated on the CPU.

``flashattn_bwd.cu`` runs the bf16 backward on tensor-core products with
bf16 operands and f32 accumulators.  S = Q·Kᵀ and dP = dO·Vᵀ take their
operands straight from bf16 memory, so they are exact.  P and dS are f32
values formed on the accumulators; the dV = Pᵀ·dO, dK = dSᵀ·Q and dQ = dS·K
products take each of them as a pair of bf16 values, hi = bf16(x) and
lo = bf16(x - hi), two products summed in f32.

This file emulates that numerics without the kernel: S, P, dP and dS in f32
from the bf16 inputs, P and dS split (or, to show why, rounded once), the
three products in f64 from the rounded operands, then rounded to f32 and to
bf16 as the kernel stores them.  The result is held to the plain version
``ref.flash_bwd_plain`` (f32 throughout) under ``chip_smoke.py``'s limit for
bf16 gradients, 5e-5·(1 + |w|) plus one bf16 step of |w|.  Rounding P and
dS once breaks that limit many times over, so the split stays.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flashattn import ref as R

CASES = [
    # B, H, KV, S, hd, window; causal
    (1, 3, 1, 1024, 64, None),         # one GQA group of the training shape
    (1, 3, 1, 512, 64, 100),           # a window
    (1, 3, 1, 1000, 128, None),        # hd = 128, ragged S
]


def _inputs(seed, B, H, KV, S, hd, window):
    """Seeded normal bf16 q, k, v, dO; out and lse from the plain forward."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(torch.bfloat16)
                   for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd),
                             (B, H, S, hd)))
    out, lse = R.flash_plain(q, k, v, window=window, emit="lse")
    return q, k, v, out, lse, do


def split(x: torch.Tensor):
    """(hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def emulate(q, k, v, out, lse, do, *, window=None, split_operands=True):
    """(dq, dk, dv) in bf16 as the tensor-core kernel forms them."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qd, dod = q.double(), do.double()
    kd, vd = R.gqa_expand(k, G).double(), R.gqa_expand(v, G).double()
    pos = torch.arange(S)
    mask = R.band_mask(pos, pos, True, window)
    s = torch.matmul(qd, kd.transpose(-1, -2)).float()
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.matmul(dod, vd.transpose(-1, -2)).float()
    ds = p * (dp - R.bwd_dvec(do, out)[..., None]) * scale

    def operand(x):
        hi, lo = split(x)
        return hi.double() + lo.double() if split_operands else hi.double()

    pd, dsd = operand(p), operand(ds)
    dq = torch.matmul(dsd, kd)
    dk = torch.matmul(dsd.transpose(-1, -2), qd)
    dv = torch.matmul(pd.transpose(-1, -2), dod)
    dk = dk.reshape(B, KV, G, S, hd).sum(dim=2)
    dv = dv.reshape(B, KV, G, S, hd).sum(dim=2)
    return tuple(t.float().to(torch.bfloat16) for t in (dq, dk, dv))


def limit_ratio(got, want) -> float:
    """max err / limit, the limit of ``chip_smoke._bwd_check`` for bf16."""
    g, w = got.float(), want.float()
    step = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp(min=2.0 ** -126))) - 7)
    lim = 5e-5 * (1 + w.abs()) + step
    return float(((g - w).abs() / lim).max())


@pytest.mark.parametrize("B,H,KV,S,hd,window", CASES)
def test_split_operands_within_chip_limit(B, H, KV, S, hd, window):
    inputs = _inputs(16, B, H, KV, S, hd, window)
    want = R.flash_bwd_plain(*inputs, window=window)
    got = emulate(*inputs, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        assert limit_ratio(g, w) <= 1.0, name


def test_single_rounding_breaks_chip_limit():
    """P and dS rounded once to bf16: every gradient leaves the limit, by
    more than 10× — the reason the kernel splits them."""
    B, H, KV, S, hd, window = CASES[0]
    inputs = _inputs(16, B, H, KV, S, hd, window)
    want = R.flash_bwd_plain(*inputs, window=window)
    got = emulate(*inputs, window=window, split_operands=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert limit_ratio(g, w) > 10.0, name


@pytest.mark.parametrize("seed", [0, 1])
def test_hi_lo_reconstructs_f32(seed):
    """hi + lo is x within 2^-16·|x| (2^-18 by construction) over
    magnitudes the backward meets, zero and signs included."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))
    x = torch.from_numpy(np.concatenate([x, [0.0, -0.0, 1.0, -3.0]])).float()
    hi, lo = split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())
    assert bool((hi.float() == x.to(torch.bfloat16).float()).all())
