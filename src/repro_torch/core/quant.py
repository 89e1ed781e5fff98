"""Integer-arithmetic-only quantization (Jacob et al., arXiv:1712.05877).

The counterpart of ``repro.core.quant``, cut to what the conv path uses.
Every qparam is a float32 (scale) or int32 (zero point) tensor, 0-dim when
per-tensor, so that products such as ``in_scale * w_scale / out_scale`` are
float32 operations in the same order as the reference.  Rounding is
half-to-even throughout (``torch.round``), as ``jnp.round``.

Conventions (TFLite-compatible):
  * activations: asymmetric int8 in [-128, 127], per-tensor (scale, zero_point)
  * weights:     symmetric  int8 in [-127, 127], per-channel scale, zp == 0
  * bias:        int32 with scale = s_in * s_w, zp == 0
  * accumulator: int32
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INT8_MIN, INT8_MAX = -128, 127
WEIGHT_QMIN, WEIGHT_QMAX = -127, 127  # symmetric, avoids -128 asymmetry


@dataclasses.dataclass
class QTensor:
    """An int8 tensor with its affine quantization parameters."""

    q: torch.Tensor                    # int8 payload
    scale: torch.Tensor                # f32 scalar or per-channel vector
    zero_point: torch.Tensor           # i32 scalar
    axis: Optional[int] = None


def symmetric_qparams(abs_max: torch.Tensor, qmax: int = WEIGHT_QMAX
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric (scale, zero_point=0) for weights."""
    scale = torch.clamp(abs_max, min=1e-9) / qmax
    return (scale.to(torch.float32),
            torch.zeros((), dtype=torch.int32, device=abs_max.device))


def quantize(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
             qmin: int = INT8_MIN, qmax: int = INT8_MAX) -> torch.Tensor:
    """Float → int8 with round-half-to-even."""
    q = torch.round(x / scale) + zero_point
    return torch.clamp(q, qmin, qmax).to(torch.int8)


def quantize_weight(w: torch.Tensor, axis: int = -1) -> QTensor:
    """Per-channel symmetric weight quantization along ``axis``."""
    axis = axis % w.dim()
    reduce_dims = tuple(d for d in range(w.dim()) if d != axis)
    abs_max = torch.amax(torch.abs(w), dim=reduce_dims)
    scale, zp = symmetric_qparams(abs_max)
    bshape = [1] * w.dim()
    bshape[axis] = -1
    q = torch.clamp(torch.round(w / scale.reshape(bshape)),
                    WEIGHT_QMIN, WEIGHT_QMAX)
    return QTensor(q.to(torch.int8), scale, zp, axis=axis)


def requant_scale(input_scale, weight_scale, output_scale) -> torch.Tensor:
    """The real multiplier M = s_in * s_w / s_out (per-channel if s_w is)."""
    return (input_scale * weight_scale / output_scale).to(torch.float32)


def requantize(acc: torch.Tensor, scale: torch.Tensor,
               out_zero_point: torch.Tensor,
               qmin: int = INT8_MIN, qmax: int = INT8_MAX) -> torch.Tensor:
    """int32 accumulator → int8 output, fp32 scaling, round-half-to-even.

    ``scale`` broadcasts against the trailing (channel) dimension.
    """
    y = acc.to(torch.float32) * scale
    y = torch.round(y) + out_zero_point.to(torch.float32)
    return torch.clamp(y, qmin, qmax).to(torch.int8)
