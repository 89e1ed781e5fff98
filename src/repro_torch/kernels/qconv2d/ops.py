"""Public wrapper around the fused qconv2d kernel.

The counterpart of ``repro.kernels.qconv2d.ops``: zero-point padding,
parameter bundle preparation, then the fused kernel.  The reference falls
back to its jnp oracle when an image exceeds the TPU's VMEM budget; the port
has no such limit and no fallback: a CUDA tensor always reaches the kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels.qconv2d import kernel


class QConvParams(NamedTuple):
    """Runtime parameter bundle for one conv layer (the HPDP 'stream inputs')."""

    w_q: torch.Tensor       # (KH, KW, Cin, Cout) int8
    w_scale: torch.Tensor   # (Cout,) f32
    colsum: torch.Tensor    # (Cout,) int32
    bias_f: torch.Tensor    # (Cout,) f32


def weight_colsum(w_q: torch.Tensor) -> torch.Tensor:
    """(Cout,) int32 sum of ``w_q`` over (KH, KW, Cin)."""
    return w_q.to(torch.int32).sum(dim=(0, 1, 2)).to(torch.int32)


def make_qconv_params(w: torch.Tensor,
                      bias: torch.Tensor | None = None) -> QConvParams:
    qt = quant.quantize_weight(w, axis=-1)
    if bias is None:
        bias = torch.zeros((w.shape[-1],), dtype=torch.float32,
                           device=w.device)
    return QConvParams(qt.q, qt.scale, weight_colsum(qt.q),
                       bias.to(torch.float32))


def _same_pads(h: int, w: int, kh: int, kw: int, sh: int, sw: int):
    """XLA's SAME padding: the extra row/column goes after (asymmetric for
    stride 2, e.g. (0, 1) for the 388-wide 3×3/2 stem)."""
    oh = -(-h // sh)
    ow = -(-w // sw)
    ph = max((oh - 1) * sh + kh - h, 0)
    pw = max((ow - 1) * sw + kw - w, 0)
    return ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))


def resolve_pads(h, w, kh, kw, stride, padding):
    """``padding`` ("SAME", "VALID" or explicit ((top, bottom), (left,
    right))) as explicit pads."""
    if padding == "SAME":
        return _same_pads(h, w, kh, kw, *stride)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    return tuple(tuple(p) for p in padding)


def pad_zp(x_q: torch.Tensor, x_zp: torch.Tensor, pads) -> torch.Tensor:
    """Pad NHWC int8 ``x_q`` with the zero point: padded taps contribute
    (zp - zp)·w == 0, i.e. padding with the zp value is "pad with real 0.0".
    Built as a zp-filled tensor with ``x_q`` copied in, so the zero point
    never leaves the device."""
    (ph0, ph1), (pw0, pw1) = pads
    n, h, w, c = x_q.shape
    xp = x_zp.to(torch.int8).expand(n, h + ph0 + ph1, w + pw0 + pw1,
                                    c).contiguous()
    xp[:, ph0:ph0 + h, pw0:pw0 + w] = x_q
    return xp


def qconv2d_op(
    x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
    colsum: torch.Tensor, bias_i32: torch.Tensor, scale: torch.Tensor,
    out_zp: torch.Tensor, *, stride: Tuple[int, int] = (1, 1),
    padding="SAME",
) -> torch.Tensor:
    """int8 NHWC in → int8 NHWC out quantized conv+requant (fused kernel)."""
    _, h, w, _ = x_q.shape
    kh, kw = w_q.shape[0], w_q.shape[1]
    xp = pad_zp(x_q, x_zp, resolve_pads(h, w, kh, kw, stride, padding))
    zps = torch.stack([x_zp.to(torch.int32).reshape(()),
                       out_zp.to(torch.int32).reshape(())])
    return kernel.qconv2d(xp, w_q, colsum, bias_i32, scale, zps,
                          stride=tuple(stride))


def qconv_act(
    x: torch.Tensor,                  # (N, H, W, Cin) float
    params: QConvParams,
    x_scale: torch.Tensor, x_zp: torch.Tensor,
    out_scale: torch.Tensor, out_zp: torch.Tensor,
    *, stride: Tuple[int, int] = (1, 1), padding="SAME",
) -> torch.Tensor:
    """float → int8 conv+requant → float, integer arithmetic in between."""
    x_q = quant.quantize(x, x_scale, x_zp)
    bias_i32 = torch.round(
        params.bias_f / (x_scale * params.w_scale)).to(torch.int32)
    rq_scale = quant.requant_scale(x_scale, params.w_scale, out_scale)
    y_q = qconv2d_op(x_q, x_zp, params.w_q, params.colsum, bias_i32,
                     rq_scale, out_zp, stride=stride, padding=padding)
    return (y_q.to(torch.float32) - out_zp.to(torch.float32)) * out_scale
