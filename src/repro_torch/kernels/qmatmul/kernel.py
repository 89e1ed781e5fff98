"""The three int8 matmul kernels: build, ctypes binding and wrappers.

CUDA C++ for ``sm_90a`` in ``csrc/qmatmul.cu`` (the source's header says
which TPU kernel each replaces, what bounds it and what its design does
about that), built and bound by ``kernels/cuda_lib.py``.

Each wrapper checks dtypes, shapes and contiguity, then:

* on CUDA tensors allocates its outputs with ``torch.empty``, launches on
  the current stream, raises if the launch reports an error, and adds one
  to its ``launches`` count;
* on CPU tensors runs the kernel's plain version (``ref.py``).

A CUDA tensor reaches the kernel or an exception, never the plain version.
"""
from __future__ import annotations

import functools
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import I as _I, P as _P
from repro_torch.kernels.qmatmul import ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "qmatmul.cu"
_SHAPE = [_I] * 3 + [_P]          # m k n, stream
_ENTRIES = {
    "qmatmul_acc_launch": [_P] * 3 + _SHAPE,
    "qmatmul_acc_checksum_launch": [_P] * 5 + _SHAPE,
    "qmatmul_launch": [_P] * 7 + _SHAPE,
}


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/qmatmul.cu`` unless a library built from the same
    source exists.  Returns (library path, nvcc's messages or "")."""
    return cuda_lib.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _lib():
    return cuda_lib.load(SOURCE, _ENTRIES)


def _shape(x_q, w_q):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype}, "
                        f"{w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"need (M,K) x_q and (K,N) w_q, got "
                         f"{tuple(x_q.shape)}, {tuple(w_q.shape)}")
    return x_q.shape[0], x_q.shape[1], w_q.shape[1]


def _on_card(*tensors) -> bool:
    return cuda_lib.on_card("qmatmul", *tensors)


def _launch(name, device, *args):
    cuda_lib.launch(_lib(), name, device, *args)


def qmatmul_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Raw int32 accumulator X·W, (M, K) int8 × (K, N) int8 → (M, N)."""
    m, k, n = _shape(x_q, w_q)
    if not _on_card(x_q, w_q):
        return ref.qmatmul_acc_plain(x_q, w_q)
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    _launch("qmatmul_acc_launch", x_q.device, x_q.data_ptr(), w_q.data_ptr(),
            out.data_ptr(), m, k, n)
    qmatmul_acc.launches += 1
    return out


def qmatmul_acc_checksum(x_q: torch.Tensor, w_q: torch.Tensor,
                         w_check: torch.Tensor):
    """(acc, want): ``qmatmul_acc`` plus the ABFT check vector want (M,)
    int32 = X·w_check mod 2^32, which equals the row sum of acc mod 2^32
    on a fault-free pass (``w_check`` is the (K,) int32 deploy-time
    ``abft.checksum_vector``)."""
    m, k, n = _shape(x_q, w_q)
    cuda_lib.expect(w_check, "w_check", torch.int32, (k,))
    if not _on_card(x_q, w_q, w_check):
        return ref.qmatmul_acc_checksum_plain(x_q, w_q, w_check)
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    want = torch.empty((m,), dtype=torch.int32, device=x_q.device)
    _launch("qmatmul_acc_checksum_launch", x_q.device, x_q.data_ptr(),
            w_q.data_ptr(), w_check.data_ptr(), out.data_ptr(),
            want.data_ptr(), m, k, n)
    qmatmul_acc_checksum.launches += 1
    return out, want


def qmatmul(x_q: torch.Tensor, w_q: torch.Tensor, colsum: torch.Tensor,
            bias: torch.Tensor, scale: torch.Tensor,
            zps: torch.Tensor) -> torch.Tensor:
    """Matmul with the fused requantisation epilogue → int8 (M, N):
    X·W - x_zp·colsum + bias, ×scale in f32, round half to even, + out_zp,
    clip.  zps is (2,) int32 = [x_zp, out_zp]."""
    m, k, n = _shape(x_q, w_q)
    cuda_lib.expect(colsum, "colsum", torch.int32, (n,))
    cuda_lib.expect(bias, "bias", torch.int32, (n,))
    cuda_lib.expect(scale, "scale", torch.float32, (n,))
    cuda_lib.expect(zps, "zps", torch.int32, (2,))
    if not _on_card(x_q, w_q, colsum, bias, scale, zps):
        return ref.qmatmul_plain(x_q, w_q, colsum, bias, scale, zps)
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    _launch("qmatmul_launch", x_q.device, x_q.data_ptr(), w_q.data_ptr(),
            colsum.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            zps.data_ptr(), out.data_ptr(), m, k, n)
    qmatmul.launches += 1
    return out


KERNELS = (qmatmul_acc, qmatmul_acc_checksum, qmatmul)
for _k in KERNELS:
    _k.launches = 0
del _k


def reset_launches() -> None:
    """Set every kernel's ``launches`` count to 0."""
    for k in KERNELS:
        k.launches = 0
