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

``dispatch`` registers the ``torch``, ``ref`` and ``cuda`` backends into
``core.backend``; everything above the kernels selects among them by name.
The public names are the reference's ``repro.kernels`` ones, each bound to
the port's counterpart, plus ``flash_attn_diff``.  ``core`` imports this
package only lazily (``core.backend._ensure_builtins``), so importing it
here at once makes no cycle.
"""
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import (
    conv_acc, conv_acc_checksum, matmul_acc, matmul_acc_checksum)
from repro_torch.kernels.flashattn.ops import (flash_attn, flash_attn_diff,
                                               flash_attn_model)
from repro_torch.kernels.qconv2d.ops import (
    QConvParams, make_qconv_params, qconv2d_op, qconv_act)
from repro_torch.kernels.qmatmul.ops import (
    QLinearParams, make_qlinear_params, qlinear_act, qlinear_int8_bf16out,
    qmatmul_op)

__all__ = [
    "dispatch",
    "matmul_acc", "matmul_acc_checksum", "conv_acc", "conv_acc_checksum",
    "qmatmul_op", "qlinear_act", "qlinear_int8_bf16out",
    "QLinearParams", "make_qlinear_params",
    "qconv2d_op", "qconv_act", "QConvParams", "make_qconv_params",
    "flash_attn", "flash_attn_diff", "flash_attn_model",
]
