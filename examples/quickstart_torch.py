"""Quickstart on the port: the paper's core op as a composable PyTorch module.

Runs the HPDP-style quantized conv+requant backend on one Ship-Detection
layer, verifies it against the float reference, then shows the same
parameter-driven design for a transformer qlinear — the "configure once,
stream parameters" idea that lets one kernel serve every layer — and exact
integer ABFT catching an injected SEU.  On the card the conv and the
qlinear run the fused-requant kernels (``qconv2d``, ``qmatmul``) and the
ABFT act the accumulator kernels; on the CPU their plain versions.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``--full`` runs the conv at the Table-1 layer's own 194 x 194 map, and the
qlinear and ABFT acts at SmolLM-135M's FFN width (576 -> 1,536, M = 8).
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels, resolve_device
from repro_torch.core import abft, quant

# conv map side, qlinear (M, K, N), ABFT act (M, K, N)
SIZES = {False: (24, (8, 64, 32), (16, 64, 32)),
         True: (194, (8, 576, 1536), (8, 576, 1536))}
FLIP_AT, FLIP_BY = (3, 7), 1 << 12       # the injected accumulator SEU


def float_conv(x, w, b):
    """The float yardstick: NHWC x HWIO SAME conv in full f32 (TF32 off)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding="same")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return y.permute(0, 2, 3, 1) + b


def strike(acc):
    """A copy of ``acc`` with the injected SEU added at ``FLIP_AT``."""
    acc = acc.clone()
    acc[FLIP_AT] += FLIP_BY
    return acc


def run(device="cuda", *, full=False) -> dict:
    """The three acts; returns their outputs, and under ``calls`` the
    arguments of each ``qconv_act`` / ``qlinear_act`` call."""
    dev = resolve_device(device)
    side, (m, k, n), (am, ak, an) = SIZES[full]

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def i8(a):
        return torch.from_numpy(a.astype(np.int8)).to(dev)

    print("=" * 70)
    print("1. Paper's op: int8 conv + fused requantization "
          "(one compiled config,")
    print("   weights/bias/requant params are runtime operands)")
    print("=" * 70)
    rng = np.random.default_rng(0)
    # a Table-1 layer: 24x3x3x24 on a 24x24x24 map (194x194 with --full)
    x = f32(rng.standard_normal((1, side, side, 24))) * 0.5
    w = f32(rng.standard_normal((3, 3, 24, 24))) * 0.2
    b = f32(rng.standard_normal((24,))) * 0.1

    params = kernels.make_qconv_params(w, b)          # int8 weights + colsum
    y_float = float_conv(x, w, b)
    # calibrated activation qparams (min/max observer, as in core.quant)
    x_scale, x_zp = quant.affine_qparams(x.amin(), x.amax())
    out_scale, out_zp = quant.affine_qparams(y_float.amin(), y_float.amax())
    conv_args = (x, params, x_scale, x_zp, out_scale, out_zp)
    y = kernels.qconv_act(*conv_args)
    err = float((y - y_float).abs().max())
    print(f"conv out {tuple(y.shape)}, max |int8 path − float path| = "
          f"{err:.4f} (≤ a few quantization steps of {float(out_scale):.4f})")
    assert err < 6 * float(out_scale)

    # same compiled configuration, NEW layer parameters — no recompilation
    w2 = f32(rng.standard_normal((3, 3, 24, 24))) * 0.3
    params2 = kernels.make_qconv_params(w2, b)
    conv2_args = (x, params2, x_scale, x_zp, out_scale, out_zp)
    y2 = kernels.qconv_act(*conv2_args)
    print(f"second layer through the SAME kernel config: out "
          f"{tuple(y2.shape)} ✓")

    print()
    print("=" * 70)
    print("2. Transformer-shaped rendition: int8 qlinear with fused requant")
    print("=" * 70)
    xt = f32(rng.standard_normal((m, k)))
    wt = f32(rng.standard_normal((k, n))) * (0.8 / math.sqrt(k))
    lp = kernels.make_qlinear_params(wt)
    xs, xzp = quant.affine_qparams(xt.amin(), xt.amax())
    os_, ozp = quant.affine_qparams(torch.tensor(-8.0, device=dev),
                                    torch.tensor(8.0, device=dev))
    lin_args = (xt, lp, xs, xzp, os_, ozp)
    yt = kernels.qlinear_act(*lin_args)
    yt_ref = xt @ wt
    rel = float(torch.linalg.norm(yt - yt_ref) / torch.linalg.norm(yt_ref))
    print(f"qlinear out {tuple(yt.shape)}, relative error vs float = "
          f"{rel:.4f}")
    assert rel < 0.05

    print()
    print("=" * 70)
    print("3. Dependability: exact integer ABFT catches an injected SEU")
    print("=" * 70)
    x_q = i8(rng.integers(-128, 128, (am, ak)))
    w_q = i8(rng.integers(-127, 128, (ak, an)))
    acc = kernels.matmul_acc(x_q, w_q)
    flipped = strike(acc)                             # single bit flip
    wc = abft.checksum_vector(w_q)
    clean_rows = abft.verify_rows(x_q, flipped, wc)   # True == clean
    flagged = np.flatnonzero(~clean_rows.cpu().numpy()).tolist()
    print(f"ABFT flagged rows: {flagged} (expected [{FLIP_AT[0]}])")
    assert flagged == [FLIP_AT[0]]
    res = abft.abft_qmatmul(
        x_q, torch.zeros((), dtype=torch.int32, device=dev), w_q,
        torch.zeros((an,), dtype=torch.int32, device=dev), inject=strike)
    assert torch.equal(res.acc, acc)
    print("recomputed flagged rows → output exact despite the fault ✓")

    print("\nquickstart OK")
    return {"conv": y, "conv_err": err, "out_scale": float(out_scale),
            "conv2": y2, "qlinear": yt, "qlinear_rel": rel,
            "flagged": flagged, "acc": acc, "recovered": res.acc,
            "calls": {"qconv_act": [conv_args, conv2_args],
                      "qlinear_act": [lin_args]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="the conv at 194 x 194, the qlinear and ABFT acts "
                         "at SmolLM-135M's FFN width")
    args = ap.parse_args(argv)
    run(args.device, full=args.full)


if __name__ == "__main__":
    main()
