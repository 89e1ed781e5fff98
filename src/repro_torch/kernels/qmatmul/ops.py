"""Layer-level wrappers around the qmatmul kernels.

The counterpart of ``repro.kernels.qmatmul.ops``.  ``qlinear_act`` takes a
float activation and a pre-quantized weight bundle and runs the matmul in
int8/int32 with the requantisation fused into the kernel (``qmatmul``).
The reference's ``use_kernel``/``interpret`` switches have no counterpart:
a CUDA tensor always reaches the fused kernel, a CPU tensor its plain
version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import quant
from repro_torch.core.abft import wrap_int32
from repro_torch.kernels.qmatmul import kernel


class QLinearParams(NamedTuple):
    """Pre-quantized weight bundle for one linear layer."""

    w_q: torch.Tensor       # (K, N) int8, per-output-channel symmetric
    w_scale: torch.Tensor   # (N,) f32
    colsum: torch.Tensor    # (N,) int32 — sum_k w_q
    bias_f: torch.Tensor    # (N,) f32; the int32 bias derives per input scale


def make_qlinear_params(w: torch.Tensor,
                        bias: torch.Tensor | None = None) -> QLinearParams:
    """Quantize a float (K, N) weight into the runtime parameter bundle."""
    qt = quant.quantize_weight(w, axis=-1)
    colsum = qt.q.to(torch.int32).sum(dim=0).to(torch.int32)
    if bias is None:
        bias = torch.zeros((w.shape[-1],), dtype=torch.float32,
                           device=w.device)
    return QLinearParams(qt.q, qt.scale, colsum, bias.to(torch.float32))


def qmatmul_op(x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
               colsum: torch.Tensor, bias_i32: torch.Tensor,
               scale: torch.Tensor, out_zp: torch.Tensor) -> torch.Tensor:
    """int8 in → int8 out quantized matmul (the fused kernel)."""
    zps = torch.stack([x_zp.to(torch.int32).reshape(()),
                       out_zp.to(torch.int32).reshape(())])
    return kernel.qmatmul(x_q, w_q, colsum, bias_i32, scale, zps)


def qlinear_act(x: torch.Tensor, params: QLinearParams,
                x_scale: torch.Tensor, x_zp: torch.Tensor,
                out_scale: torch.Tensor,
                out_zp: torch.Tensor) -> torch.Tensor:
    """float → [quantize] → int8 matmul+requant → [dequantize] → float."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q = quant.quantize(x.reshape(-1, k), x_scale, x_zp)
    bias_i32 = torch.round(
        params.bias_f / (x_scale * params.w_scale)).to(torch.int32)
    rq_scale = quant.requant_scale(x_scale, params.w_scale, out_scale)
    y_q = qmatmul_op(x_q, x_zp, params.w_q, params.colsum, bias_i32,
                     rq_scale, out_zp)
    y = (y_q.to(torch.float32) - out_zp.to(torch.float32)) * out_scale
    return y.reshape(*lead, -1)


def qlinear_int8_bf16out(x: torch.Tensor, params: QLinearParams,
                         x_scale: torch.Tensor,
                         x_zp: torch.Tensor) -> torch.Tensor:
    """W8A8 linear with float output (no output requantization): the int8
    dot runs on the ``qmatmul_acc`` kernel (CUDA has no int32 matmul), the
    zero-point correction and the f32 dequantize follow."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q = quant.quantize(x.reshape(-1, k), x_scale, x_zp)
    acc = kernel.qmatmul_acc(x_q, params.w_q).to(torch.int64)
    acc = wrap_int32(acc - x_zp.to(torch.int64) * params.colsum[None, :])
    y = acc.to(torch.float32) * (x_scale * params.w_scale)[None, :] \
        + params.bias_f
    return y.reshape(*lead, -1).to(x.dtype)
