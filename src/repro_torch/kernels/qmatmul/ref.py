"""Plain PyTorch versions of the qmatmul kernels, and the matmul oracle.

Two groups, both runnable on the CPU and on the card:

* ``qmatmul_acc_plain`` / ``qmatmul_acc_checksum_plain`` / ``qmatmul_plain``
  compute what each hand kernel in ``kernel.py`` computes, with its
  signature.  The kernel wrappers run them for CPU tensors, and
  ``chip_smoke.py`` holds each kernel against its plain version on the card.
* ``qmatmul_acc_ref`` / ``qmatmul_ref`` are the oracle of the reference's
  ``repro.kernels.qmatmul.ref``: the zero-point correction hoisted out of
  the inner product,

      acc = x_q @ w_q - x_zp * colsum(w_q) + bias        (int32, mod 2^32)
      y   = requantize(acc, scale, out_zp)               (int8)

Integer sums are exact: the products run in float64, exact because every
partial sum stays below 2^53 (|x|·|w|·K ≤ 2^14·K for int8, and an int32
check vector of an int8 weight times K int8 rows stays far below that at
any K the models use), then int64, wrapped to int32 explicitly
(``wrap_int32``).  There is no ``int8 @ int8`` (it returns int8 on the CPU)
and no int32 matmul (CUDA has none).
"""
from __future__ import annotations

import torch

from repro_torch.core.abft import exact_dot, wrap_int32
from repro_torch.core.quant import requantize


def qmatmul_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """X·W → int32 (M, N), mod 2^32."""
    return wrap_int32(exact_dot(x_q, w_q))


def qmatmul_acc_checksum_plain(x_q, w_q, w_check):
    """(acc, want): want (M,) int32 = X·w_check mod 2^32, which equals the
    row sum of acc mod 2^32 on a fault-free pass."""
    want = exact_dot(x_q, w_check[:, None])[:, 0]
    return qmatmul_acc_plain(x_q, w_q), wrap_int32(want)


def qmatmul_plain(x_q, w_q, colsum, bias, scale, zps):
    """Fused path: X·W - x_zp·colsum + bias, then requantize to int8.
    ``zps`` is (2,) int32 = [x_zp, out_zp]."""
    zps = zps.to(torch.int64)
    acc = exact_dot(x_q, w_q) - zps[0] * colsum + bias
    return requantize(wrap_int32(acc), scale, zps[1])


def qmatmul_acc_ref(x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """int32 accumulator (pre-requantization): X·W - x_zp·colsum + bias."""
    colsum = w_q.to(torch.int64).sum(dim=0)
    acc = exact_dot(x_q, w_q) - x_zp.to(torch.int64) * colsum + bias
    return wrap_int32(acc)


def qmatmul_ref(x_q, x_zp, w_q, bias, scale, out_zp) -> torch.Tensor:
    """Full quantized matmul + requant. Returns int8 (M, N)."""
    return requantize(qmatmul_acc_ref(x_q, x_zp, w_q, bias), scale, out_zp)
