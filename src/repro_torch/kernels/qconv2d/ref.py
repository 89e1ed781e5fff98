"""Plain PyTorch versions of the qconv2d kernels, and the conv oracle.

Two groups, both runnable on the CPU and on the card:

* ``qconv2d_acc_plain`` / ``qconv2d_acc_checksum_plain`` / ``qconv2d_plain``
  compute what each hand kernel in ``kernel.py`` computes, with its
  signature (zero-point-padded input, colsum correction).  The kernel
  wrappers run them for CPU tensors, and ``chip_smoke.py`` holds each
  kernel against its plain version on the card.
* ``conv_acc_ref`` / ``qconv2d_acc_ref`` / ``qconv2d_ref`` are the
  independent oracle (conv of ``x - zp`` zero-padded, no colsum algebra),
  the counterpart of ``repro.kernels.qconv2d.ref`` and of the ``ref``
  backend's tap loop.

Integer sums are exact: each tap's product runs in float64, exact because
every partial sum stays below 2^53, and taps accumulate in int64.  Results
wrap to int32 explicitly (``wrap_int32``).  There is no ``int8 @ int8``
(it returns int8 on the CPU) and no int32 matmul (CUDA has none).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.abft import wrap_int32
from repro_torch.core.quant import requantize


def _tap_sum(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """Valid direct conv of an already padded NHWC ``x`` with HWIO ``w``:
    an explicit (kh, kw) tap loop, exact, int64 (N, OH, OW, Cout)."""
    n, hp, wp, _ = x.shape
    kh, kw, _, cout = w.shape
    sh, sw = stride
    oh = (hp - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    x = x.to(torch.float64)
    w = w.to(torch.float64)
    acc = torch.zeros((n, oh, ow, cout), dtype=torch.int64, device=x.device)
    for i in range(kh):
        for j in range(kw):
            patch = x[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
            acc += torch.matmul(patch, w[i, j]).to(torch.int64)
    return acc


# ---------------------------------------------------------------------------
# plain versions of the three kernels (kernel signatures)
# ---------------------------------------------------------------------------


def qconv2d_acc_plain(x_p, w_q, colsum, zp, *, stride=(1, 1)):
    """conv(x_p, w) - zp·colsum mod 2^32 → int32 (N, OH, OW, Cout)."""
    acc = _tap_sum(x_p, w_q, stride) - zp.to(torch.int64) * colsum
    return wrap_int32(acc)


def qconv2d_acc_checksum_plain(x_p, w_q, colsum, w_check, zp, *,
                               stride=(1, 1)):
    """(acc, want): want = conv(x_p, w_check) - zp·Σw_check mod 2^32."""
    acc = qconv2d_acc_plain(x_p, w_q, colsum, zp, stride=stride)
    want = _tap_sum(x_p, w_check, stride)[..., 0] \
        - zp.to(torch.int64) * w_check.sum(dtype=torch.int64)
    return acc, wrap_int32(want)


def qconv2d_plain(x_p, w_q, colsum, bias, scale, zps, *, stride=(1, 1)):
    """Fused path: acc - x_zp·colsum + bias, then requantize to int8."""
    zps = zps.to(torch.int64)
    acc = _tap_sum(x_p, w_q, stride) - zps[0] * colsum + bias
    return requantize(wrap_int32(acc), scale, zps[1])


# ---------------------------------------------------------------------------
# independent oracle (unpadded input, x - zp zero-padded)
# ---------------------------------------------------------------------------


def conv_acc_ref(x_q, x_zp, w, stride, pads) -> torch.Tensor:
    """conv(x_q - x_zp, w) with zero padding ``pads`` → int32, mod 2^32."""
    x = x_q.to(torch.float64) - x_zp.to(torch.float64)
    (ph0, ph1), (pw0, pw1) = pads
    x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    return wrap_int32(_tap_sum(x, w, stride))


def qconv2d_acc_ref(
    x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
    bias: torch.Tensor, stride: Tuple[int, int] = (1, 1),
    padding: str | Sequence[Tuple[int, int]] = "SAME",
) -> torch.Tensor:
    """int32 accumulator: zero-point-corrected conv plus bias."""
    from repro_torch.kernels.qconv2d.ops import resolve_pads
    pads = resolve_pads(x_q.shape[1], x_q.shape[2], w_q.shape[0],
                        w_q.shape[1], stride, padding)
    acc = conv_acc_ref(x_q, x_zp, w_q, stride, pads)
    return wrap_int32(acc.to(torch.int64) + bias)


def qconv2d_ref(x_q, x_zp, w_q, bias, scale, out_zp, stride=(1, 1),
                padding="SAME") -> torch.Tensor:
    """Full quantized conv + requant. Returns int8 NHWC."""
    acc = qconv2d_acc_ref(x_q, x_zp, w_q, bias, stride, padding)
    return requantize(acc, scale, out_zp)
