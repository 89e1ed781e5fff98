"""The three int8 matmul kernels: build, ctypes binding and wrappers.

CUDA C++ for ``sm_90a`` in ``csrc/qmatmul.cu`` (the source's header says
which TPU kernel each replaces, what bounds it and what its design does
about that), built and bound by ``kernels/cuda_lib.py``.  The three
kernels run on one tensor-core template launched as thread block
clusters; ``plan`` picks its tiles, K split and grid per shape, and each C
entry launches that plan after checking it.

Each wrapper checks dtypes, shapes and contiguity, then:

* on CUDA tensors allocates its outputs with ``torch.empty``, launches on
  the current stream, raises if the launch reports an error, and adds one
  to its ``launches`` count;
* on CPU tensors runs the kernel's plain version (``ref.py``);
* on meta tensors allocates the same outputs and launches nothing
  (``launch.dryrun``).

A CUDA tensor reaches the kernel or an exception, never the plain version.
Under ``launch.op_analysis`` each call counts 2·M·K·N int8 operations (and
2·M·K for the check vector) under int32, ``chip_smoke.py``'s bound.
"""
from __future__ import annotations

import functools
import pathlib
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import I as _I, P as _P
from repro_torch.kernels.qmatmul import ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "qmatmul.cu"
_SHAPE = [_I] * 3                 # m k n
_PLAN = [_I] * 5                  # tile_m k_rank k_chunk cluster grid
_ENTRIES = {
    "qmatmul_acc_launch": [_P] * 3 + _SHAPE + _PLAN + [_P],
    "qmatmul_acc_checksum_launch": [_P] * 5 + _SHAPE + _PLAN + [_P],
    "qmatmul_launch": [_P] * 7 + _SHAPE + _PLAN + [_P],
}
# The template's constants (qmatmul.cu) and the card's.
TILE_N = 32                       # W columns per block
MAX_TILE_M = 64                   # X rows per block
K_STEP = 32                       # K of one mma
MAX_K_CHUNK = 256                 # K rows staged at once
MAX_CLUSTER = 8                   # portable cluster size
MAX_SLOT_ROWS = 384               # partial-tile rows rank 0 sums (6 ranks
                                  # at 64 rows; sweep.py times every
                                  # cluster size)
MAX_SMEM = 232448                 # 227 KB a block can take
SMS = 132                         # H100 SXM
_WARPS = 8


class Plan(NamedTuple):
    """The template's launch: X rows per block tile, K rows per
    cluster rank, K rows per staged chunk, ranks per cluster, blocks."""

    tile_m: int
    k_rank: int
    k_chunk: int
    cluster: int
    grid: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(tile_m: int, k_chunk: int, cluster: int) -> int:
    """Dynamic shared memory of one block (``layout`` in qmatmul.cu): X
    rows and W^T rows padded to k_chunk/4 + 4 words, W rows as copied,
    w_check, the warps' partial tiles (32 + 4 words a row), and the
    cluster's partial tiles and wants that rank 0 sums."""
    row = 4 * (k_chunk // 4 + 4)
    k_split = _WARPS // (tile_m // 8)
    return ((tile_m + TILE_N) * row + TILE_N * k_chunk + 4 * k_chunk
            + 4 * (k_split + cluster) * tile_m * (TILE_N + 4)
            + 4 * cluster * MAX_TILE_M)


def _tile_m(m: int) -> int:
    return min(MAX_TILE_M, max(8, 8 * _cdiv(m, 8)))


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, ranks: int | None = None) -> Plan:
    """Tiles of 32 columns by up to 64 rows; each tile's K split, in whole
    32-deep steps, over the ranks of one cluster: ``ranks`` of them, or by
    default as many as fill about one wave of the card's SMs (at most 8,
    and at most 384 partial rows for rank 0 to sum); fewer where a rank
    would have no step."""
    tile_m = _tile_m(m)
    tiles = _cdiv(n, TILE_N) * _cdiv(m, tile_m)
    if ranks is None:
        ranks = min(MAX_CLUSTER, MAX_SLOT_ROWS // tile_m,
                    _cdiv(SMS, max(1, tiles)))
    steps = max(1, _cdiv(k, K_STEP))
    per_rank = _cdiv(steps, min(ranks, steps))
    cluster = _cdiv(steps, per_rank)
    k_rank = K_STEP * per_rank
    return Plan(tile_m, k_rank, min(k_rank, MAX_K_CHUNK), cluster,
                cluster * tiles)


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


def _ops(x_q, w_q, *rest):
    return torch.int32, 2 * x_q.shape[0] * x_q.shape[1] * w_q.shape[1]


def _ops_checksum(x_q, w_q, w_check):
    return torch.int32, _ops(x_q, w_q)[1] + 2 * x_q.shape[0] * x_q.shape[1]


@cuda_lib.counted(_ops)
def qmatmul_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Raw int32 accumulator X·W, (M, K) int8 × (K, N) int8 → (M, N)."""
    m, k, n = _shape(x_q, w_q)
    card = _on_card(x_q, w_q)
    if not card and x_q.device.type != "meta":
        return ref.qmatmul_acc_plain(x_q, w_q)
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    if card:
        _launch("qmatmul_acc_launch", x_q.device, x_q.data_ptr(),
                w_q.data_ptr(), out.data_ptr(), m, k, n, *plan(m, k, n))
        qmatmul_acc.launches += 1
    return out


@cuda_lib.counted(_ops_checksum)
def qmatmul_acc_checksum(x_q: torch.Tensor, w_q: torch.Tensor,
                         w_check: torch.Tensor):
    """(acc, want): ``qmatmul_acc`` plus the ABFT check vector want (M,)
    int32 = X·w_check mod 2^32, which equals the row sum of acc mod 2^32
    on a fault-free pass (``w_check`` is the (K,) int32 deploy-time
    ``abft.checksum_vector``)."""
    m, k, n = _shape(x_q, w_q)
    cuda_lib.expect(w_check, "w_check", torch.int32, (k,))
    card = _on_card(x_q, w_q, w_check)
    if not card and x_q.device.type != "meta":
        return ref.qmatmul_acc_checksum_plain(x_q, w_q, w_check)
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    want = torch.empty((m,), dtype=torch.int32, device=x_q.device)
    if card:
        _launch("qmatmul_acc_checksum_launch", x_q.device, x_q.data_ptr(),
                w_q.data_ptr(), w_check.data_ptr(), out.data_ptr(),
                want.data_ptr(), m, k, n, *plan(m, k, n))
        qmatmul_acc_checksum.launches += 1
    return out, want


@cuda_lib.counted(_ops)
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
    card = _on_card(x_q, w_q, colsum, bias, scale, zps)
    if not card and x_q.device.type != "meta":
        return ref.qmatmul_plain(x_q, w_q, colsum, bias, scale, zps)
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    if card:
        _launch("qmatmul_launch", x_q.device, x_q.data_ptr(), w_q.data_ptr(),
                colsum.data_ptr(), bias.data_ptr(), scale.data_ptr(),
                zps.data_ptr(), out.data_ptr(), m, k, n, *plan(m, k, n))
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
