"""Hand-written CUDA kernels and the execution-backend dispatch.

  qconv2d    int8 NHWC conv: accumulator, accumulator + ABFT check channel,
             fused requantisation
  qmatmul    int8 (M,K)·(K,N) matmul: accumulator, accumulator + ABFT
             check vector, fused requantisation

Each family is a (kernel.py, ops.py, ref.py) triple with its CUDA source
under ``csrc/``, built and bound by ``cuda_lib``.

``dispatch`` registers the ``ref`` and ``cuda`` backends into
``core.backend``; everything above the kernels selects among them by name.
"""
