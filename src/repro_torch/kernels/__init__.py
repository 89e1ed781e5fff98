"""Hand-written CUDA kernels and the execution-backend dispatch.

  qconv2d    int8 NHWC conv: accumulator, accumulator + ABFT check channel,
             fused requantisation
  qmatmul    int8 (M,K)·(K,N) matmul: accumulator, accumulator + ABFT
             check vector, fused requantisation
  flashattn  causal / windowed GQA attention forward: plain, with the
             two-tier ABFT check outputs, with the logsumexp rows; and its
             backward (dQ, dK/dV), under ``flash_attn_diff``

Each family is a (kernel.py, ops.py, ref.py) triple with its CUDA source
under ``csrc/``, built and bound by ``cuda_lib``.

``dispatch`` registers the ``ref`` and ``cuda`` backends into
``core.backend``; everything above the kernels selects among them by name.
"""
from repro_torch.kernels.flashattn.ops import (flash_attn, flash_attn_diff,
                                               flash_attn_model)

__all__ = ["flash_attn", "flash_attn_diff", "flash_attn_model"]
