"""Integer-arithmetic-only quantization (Jacob et al., arXiv:1712.05877).

The counterpart of ``repro.core.quant``.  Every qparam is a float32
(scale) or int32 (zero point) tensor, 0-dim when per-tensor, so that
products such as ``in_scale * w_scale / out_scale`` are float32 operations
in the same order as the reference.  Rounding is half-to-even throughout
(``torch.round``), as ``jnp.round``.

Two requantization semantics, as in the reference: ``requantize`` (f32
scaling, what every kernel runs) and ``requantize_gemmlowp_np``, the
integer-exact gemmlowp oracle in numpy (SRDHM + rounding shift in int64),
the same code as the reference's, which the tests measure the f32 path
against.  ``fake_quant`` is a ``torch.autograd.Function`` with the
reference's straight-through gradient: the incoming gradient inside the
clip range, zero where the quantizer saturates.

Conventions (TFLite-compatible):
  * activations: asymmetric int8 in [-128, 127], per-tensor (scale, zero_point)
  * weights:     symmetric  int8 in [-127, 127], per-channel scale, zp == 0
  * bias:        int32 with scale = s_in * s_w, zp == 0
  * accumulator: int32
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
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

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def dequantize(self) -> torch.Tensor:
        scale = self.scale
        if self.axis is not None:
            bshape = [1] * self.q.dim()
            bshape[self.axis] = -1
            scale = scale.reshape(bshape)
        return (self.q.to(torch.float32)
                - self.zero_point.to(torch.float32)) * scale


def affine_qparams(min_val: torch.Tensor, max_val: torch.Tensor,
                   qmin: int = INT8_MIN, qmax: int = INT8_MAX
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric (scale, zero_point) covering [min_val, max_val], the
    range nudged to include 0.0 so that zero padding is exact."""
    min_val = torch.clamp(torch.as_tensor(min_val, dtype=torch.float32),
                          max=0.0)
    max_val = torch.clamp(torch.as_tensor(max_val, dtype=torch.float32),
                          min=0.0)
    scale = torch.clamp((max_val - min_val) / (qmax - qmin), min=1e-9)
    zp = qmin - min_val / scale
    zero_point = torch.clamp(torch.round(zp), qmin, qmax).to(torch.int32)
    return scale.to(torch.float32), zero_point


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


def quantize_activation(x: torch.Tensor) -> QTensor:
    """Per-tensor asymmetric activation quantization from observed
    min/max."""
    scale, zp = affine_qparams(torch.amin(x), torch.amax(x))
    return QTensor(quantize(x, scale, zp), scale, zp)


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


def quantize_bias(b: torch.Tensor, input_scale: torch.Tensor,
                  weight_scale: torch.Tensor) -> torch.Tensor:
    """Bias is int32 at scale s_in * s_w (per-channel if the weight is)."""
    return torch.round(b / (input_scale * weight_scale)).to(torch.int32)


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


# ---------------------------------------------------------------------------
# Requantization: the gemmlowp integer-exact oracle (numpy, as the reference)
# ---------------------------------------------------------------------------


def quantize_multiplier_np(real_multiplier: float) -> Tuple[int, int]:
    """real ~= qm * 2**(shift-31) with qm an int32 in [2^30, 2^31):
    TFLite's ``QuantizeMultiplier``.  Returns (quantized_multiplier,
    shift)."""
    if real_multiplier == 0.0:
        return 0, 0
    m, exponent = math.frexp(real_multiplier)  # m in [0.5, 1)
    qm = int(round(m * (1 << 31)))
    if qm == (1 << 31):
        qm //= 2
        exponent += 1
    assert qm <= (1 << 31)
    return qm, exponent


def srdhm_np(a: np.ndarray, b: int) -> np.ndarray:
    """gemmlowp SaturatingRoundingDoublingHighMul (vectorized int64)."""
    a = a.astype(np.int64)
    ab = a * np.int64(b)
    nudge = np.where(ab >= 0, np.int64(1 << 30), np.int64(1 - (1 << 30)))
    result = (ab + nudge) >> np.int64(31)
    # saturate the single overflow case a == b == INT32_MIN
    overflow = (a == np.int64(-(1 << 31))) & (np.int64(b)
                                               == np.int64(-(1 << 31)))
    return np.where(overflow, np.int64((1 << 31) - 1),
                    result).astype(np.int64)


def rounding_divide_by_pot_np(x: np.ndarray, exponent: int) -> np.ndarray:
    """gemmlowp RoundingDivideByPOT: round-half-away division by
    2**exponent."""
    if exponent == 0:
        return x
    mask = np.int64((1 << exponent) - 1)
    remainder = x & mask
    threshold = (mask >> 1) + np.where(x < 0, np.int64(1), np.int64(0))
    return (x >> np.int64(exponent)) + np.where(remainder > threshold,
                                                np.int64(1), np.int64(0))


def requantize_gemmlowp_np(acc: np.ndarray, real_multiplier: np.ndarray,
                           out_zero_point: int, qmin: int = INT8_MIN,
                           qmax: int = INT8_MAX) -> np.ndarray:
    """Integer-exact requantization, the HPDP/gemmlowp reference.
    ``real_multiplier`` is a scalar or a per-channel vector broadcast
    against acc's last dim."""
    acc = np.asarray(acc, dtype=np.int64)
    multipliers = np.broadcast_to(np.atleast_1d(real_multiplier),
                                  (acc.shape[-1],))
    out = np.empty_like(acc)
    for c in range(acc.shape[-1]):
        qm, shift = quantize_multiplier_np(float(multipliers[c]))
        x = acc[..., c] << np.int64(max(shift, 0))
        x = srdhm_np(x, qm)
        out[..., c] = rounding_divide_by_pot_np(x, max(-shift, 0))
    out = out + np.int64(out_zero_point)
    return np.clip(out, qmin, qmax).astype(np.int8)


# ---------------------------------------------------------------------------
# Fake quantization (QAT) with the straight-through estimator
# ---------------------------------------------------------------------------


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, qmin, qmax):
        q = torch.round(x / scale) + zero_point
        ctx.save_for_backward((q >= qmin) & (q <= qmax))
        return (torch.clamp(q, qmin, qmax) - zero_point) * scale

    @staticmethod
    def backward(ctx, g):
        mask, = ctx.saved_tensors
        # straight-through inside the clip range, zero outside
        return torch.where(mask, g, torch.zeros_like(g)), None, None, None, \
            None


def fake_quant(x: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor, qmin: int = INT8_MIN,
               qmax: int = INT8_MAX) -> torch.Tensor:
    """Quantize then dequantize: clip(round(x / s) + zp) - zp, times s."""
    return _FakeQuant.apply(x, scale, zero_point, qmin, qmax)


# ---------------------------------------------------------------------------
# Calibration observer (min/max running stats)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MinMaxObserver:
    """EMA min/max observer for post-training calibration."""

    min_val: torch.Tensor
    max_val: torch.Tensor
    momentum: float = 0.99

    @staticmethod
    def init() -> "MinMaxObserver":
        return MinMaxObserver(torch.zeros(()), torch.zeros(()))

    def update(self, x: torch.Tensor) -> "MinMaxObserver":
        m = self.momentum
        return MinMaxObserver(m * self.min_val + (1 - m) * torch.amin(x),
                              m * self.max_val + (1 - m) * torch.amax(x),
                              self.momentum)

    def qparams(self):
        return affine_qparams(self.min_val, self.max_val)
