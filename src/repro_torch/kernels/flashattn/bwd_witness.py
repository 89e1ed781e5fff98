"""Precision witness for the attention backward (row 10): the bf16
kernel's and the plain version's gradients against the same function in
float64, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flashattn.bwd_witness \\
        [--out witness.json]

For each (B, H, KV, S, hd, window) of ``SHAPES`` (the training shapes of
``chip_smoke.py``, and llama3-405b's group of 16 query heads cut to 2, 4
and 8), seeded normal bf16 q, k, v and dO, with out and lse from the
forward kernel as training hands them over: ``flash_attention_bwd`` and
``flash_bwd_plain`` against ``witness`` (the plain version's formula in
float64 on the same inputs).  Prints per gradient the worst error / limit
of ``chip_smoke.py``'s bf16 check, 5e-5·(1 + |w|) plus one bf16 step of
|w|, of the kernel against the plain version and of each against the
witness rounded to bf16, the elements past that limit, and the mean
signed relative error of the kernel's and the plain version's gradients,
sign(t)·(g − t)/|t| over the witness's elements with |t| > 2^-4: sums
that come out short, as sums rounded toward zero do, show as a negative
mean that grows with the products summed per element (G·S for dK and
dV).  TF32 is off.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.kernels.flashattn import kernel as FK
from repro_torch.kernels.flashattn import ref as FR

SHAPES = [
    (8, 9, 3, 1024, 64, None),      # SmolLM-135M's training shape
    (1, 64, 8, 512, 112, None),     # kimi-k2's
    (1, 16, 8, 1024, 128, None),    # llama3-405b's, G cut to 2, 4, 8
    (1, 32, 8, 1024, 128, None),
    (1, 64, 8, 1024, 128, None),
    (1, 128, 8, 1024, 128, None),   # llama3-405b's training shape
    (1, 32, 8, 4608, 128, 4096),    # mixtral-8x7b's, windowed
]


def witness(q, k, v, out, lse, do, window=None):
    """(dq, dk, dv) in float64 of ``flash_bwd_plain``'s formula, one
    kv-head group at a time."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = FR.band_mask(pos, pos, True, window)
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        for j in range(KV):
            hs = slice(j * G, (j + 1) * G)
            qd, dod = q[b, hs].double(), do[b, hs].double()
            kd, vd = k[b, j].double(), v[b, j].double()
            p = torch.where(mask, torch.exp(qd @ kd.T * scale
                                            - lse[b, hs, :, None].double()),
                            0.0)
            dvec = (dod * out[b, hs].double()).sum(-1, keepdim=True)
            ds = p * (dod @ vd.T - dvec) * scale
            dq[b, hs] = ds @ kd
            dk[b, j] = (ds.transpose(-1, -2) @ qd).sum(0)
            dv[b, j] = (p.transpose(-1, -2) @ dod).sum(0)
            del p, ds
    return dq, dk, dv


def _ratio(got, want):
    """(worst error / limit, elements past it) of bf16 ``got`` against
    ``want``, ``chip_smoke._bwd_check``'s bf16 limit."""
    g, w = got.float(), want.float()
    step = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp(min=2.0 ** -126))) - 7)
    r = (g - w).abs() / (5e-5 * (1 + w.abs()) + step)
    return float(r.max()), int((r > 1).sum())


def _bias(got, truth):
    """Mean of sign(t)·(g − t)/|t| over |t| > 2^-4: negative when the
    magnitudes come out short."""
    t = truth
    keep = t.abs() > 2.0 ** -4
    rel = torch.sign(t) * (got.double() - t) / t.abs()
    return float(rel[keep].mean())


def run(shapes=SHAPES, seed=26, device="cuda"):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for b, h, kv, s, hd, window in shapes:
        def normal(*shape):
            return torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16)
        q, k, v = normal(b, h, s, hd), normal(b, kv, s, hd), \
            normal(b, kv, s, hd)
        out, lse = FK.flash_attention_fwd_lse(q, k, v, window=window)
        do = normal(b, h, s, hd)
        got = FK.flash_attention_bwd(q, k, v, out, lse, do, window=window)
        plain = FR.flash_bwd_plain(q, k, v, out, lse, do, window=window)
        truth = witness(q, k, v, out, lse, do, window)
        row = {"shape": [b, h, kv, s, hd, window], "G": h // kv}
        for name, g, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
            tb = t.float().to(torch.bfloat16)
            row[name] = {
                "kernel_vs_plain": _ratio(g, p),
                "kernel_vs_witness": _ratio(g, tb),
                "plain_vs_witness": _ratio(p, tb),
                "kernel_bias": _bias(g, t), "plain_bias": _bias(p, t),
                "max_abs": float(t.abs().max())}
        rows.append(row)
        print(f"{tuple(row['shape'])} G {row['G']}: " + "; ".join(
            f"{n} kernel/plain {row[n]['kernel_vs_plain'][0]:.3f} "
            f"({row[n]['kernel_vs_plain'][1]} past), kernel/f64 "
            f"{row[n]['kernel_vs_witness'][0]:.3f} "
            f"({row[n]['kernel_vs_witness'][1]}), plain/f64 "
            f"{row[n]['plain_vs_witness'][0]:.3f} "
            f"({row[n]['plain_vs_witness'][1]}), bias kernel "
            f"{row[n]['kernel_bias']:.2e} plain {row[n]['plain_bias']:.2e}"
            for n in ("dq", "dk", "dv")), flush=True)
        del q, k, v, out, lse, do, got, plain, truth
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the witness runs the kernels: it needs a CUDA "
                         "device")
    print(torch.cuda.get_device_name(0))
    FK.build_bwd()
    FK.build()
    rows = run()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
