"""The three int8 conv kernels: build, ctypes binding and wrappers.

CUDA C++ for ``sm_90a`` in ``csrc/qconv2d.cu`` (the source's header says
which TPU kernel each replaces, what bounds it and what its design does
about that), built and bound by ``kernels/cuda_lib.py``.  The three
kernels run on one int8 tensor-core template; ``plan`` picks its tiles and
how much of B it stages at once, and each C entry launches that plan after
checking it.

Each wrapper checks dtypes, shapes and contiguity, then:

* on CUDA tensors allocates its outputs with ``torch.empty``, launches on
  the current stream, raises if the launch reports an error, and adds one
  to its ``launches`` count;
* on CPU tensors runs the kernel's plain version (``ref.py``);
* on meta tensors allocates the same outputs and launches nothing
  (``launch.dryrun``).

A CUDA tensor reaches the kernel or an exception, never the plain version.
Under ``launch.op_analysis`` each call counts 2·pixels·Cout·taps int8
operations (and 2·pixels·taps for the check channel) under int32,
``chip_smoke.py``'s bound.
"""
from __future__ import annotations

import functools
import pathlib
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import P as _P, I as _I
from repro_torch.kernels.qconv2d import ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "qconv2d.cu"
_GEOMETRY = [_I] * 11             # n hp wp cin kh kw cout oh ow sh sw
_PLAN = [_I] * 3                  # tiles grid_y bt_k
_ENTRIES = {
    "qconv2d_acc_launch": [_P] * 5 + _GEOMETRY + _PLAN + [_P],
    "qconv2d_acc_checksum_launch": [_P] * 7 + _GEOMETRY + _PLAN + [_P],
    "qconv2d_launch": [_P] * 7 + _GEOMETRY + _PLAN + [_P],
}
# The template's constants (qconv2d.cu) and the card's.
TILE_M, TILE_N = 128, 24          # pixels, channels per block
WARPS = 8
MACRO = 64                        # K bytes of two mma steps
MAX_BT_K = 2048                   # K bytes of B staged at once where all of
                                  # K does not fit
MAX_SMEM = 232448                 # 227 KB a block can take


class Plan(NamedTuple):
    """The template's launch: pixel tiles, Cout tiles
    (gridDim.y), and the K bytes of B staged at once (all of K rounded up
    to 64 where that fits, else ``MAX_BT_K``).  The C entry refuses a plan
    that leaves a pixel or channel out or does not fit, and launches one
    wave of blocks over the pixel tiles (gridDim.x, from the occupancy
    query, each block walking every gridDim.x-th tile)."""

    tiles: int
    grid_y: int
    bt_k: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_padded(kh: int, kw: int, cin: int) -> int:
    """K as the kernel walks it: for each ky, the kw * cin bytes that lie
    together in x ((kx, ci) order), padded to 16."""
    return kh * 16 * _cdiv(kw * cin, 16)


def row_words(bt_k: int) -> int:
    """Words per staged B row (``row_words`` in qconv2d.cu): 16 mod 32."""
    return bt_k // 4 + (48 - bt_k // 4 % 32) % 32


def smem_bytes(bt_k: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in qconv2d.cu):
    B's rows, the tile's channels and the check's 8, over ``bt_k`` bytes of
    K; the K walk's table (8 bytes per 16 of K); the per-warp sums of
    w_check."""
    return (4 * (TILE_N + 8) * row_words(bt_k) + 8 * (bt_k // 16)
            + 4 * WARPS)


@functools.lru_cache(maxsize=256)
def plan(n: int, oh: int, ow: int, cin: int, kh: int, kw: int,
         cout: int) -> Plan:
    """Tiles of 128 pixels by 24 channels, Cout split into tiles of 24 on
    gridDim.y (64 x 48 tiles were slower per forward of the ship detector,
    PERF.md).  B is staged over all of K where it fits in shared memory,
    else in pieces of ``MAX_BT_K``.  The stride does not enter the plan;
    the output size does."""
    kpad = max(MACRO, MACRO * _cdiv(k_padded(kh, kw, cin), MACRO))
    bt_k = kpad if smem_bytes(kpad) <= MAX_SMEM else MAX_BT_K
    return Plan(_cdiv(n * oh * ow, TILE_M), _cdiv(cout, TILE_N), bt_k)


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/qconv2d.cu`` unless a library built from the same
    source exists.  Returns (library path, nvcc's messages or "")."""
    return cuda_lib.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _lib():
    return cuda_lib.load(SOURCE, _ENTRIES)


def _geometry(x_p, w_q, stride):
    if x_p.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_p and w_q must be int8, got {x_p.dtype}, "
                        f"{w_q.dtype}")
    if x_p.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"need NHWC x_p and HWIO w_q, got {tuple(x_p.shape)}"
                         f", {tuple(w_q.shape)}")
    n, hp, wp, cin = x_p.shape
    kh, kw, cin2, cout = w_q.shape
    sh, sw = stride
    if cin != cin2 or sh < 1 or sw < 1 or hp < kh or wp < kw:
        raise ValueError(f"bad conv geometry: x_p {tuple(x_p.shape)}, "
                         f"w_q {tuple(w_q.shape)}, stride {stride}")
    oh = (hp - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    return n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw


_expect = cuda_lib.expect


def _on_card(*tensors) -> bool:
    return cuda_lib.on_card("qconv2d", *tensors)


def _launch(name, device, *args):
    cuda_lib.launch(_lib(), name, device, *args)


def _ops(x_p, w_q, *rest, stride=(1, 1), checksum=False):
    _, _, _, cin, kh, kw, cout, oh, ow, _, _ = _geometry(x_p, w_q, stride)
    pix, taps = x_p.shape[0] * oh * ow, kh * kw * cin
    return torch.int32, 2 * pix * taps * (cout + checksum)


def _ops_checksum(*args, stride=(1, 1)):
    return _ops(*args, stride=stride, checksum=True)


@cuda_lib.counted(_ops)
def qconv2d_acc(x_p: torch.Tensor, w_q: torch.Tensor, colsum: torch.Tensor,
                zp: torch.Tensor, *, stride=(1, 1)) -> torch.Tensor:
    """conv(x_p - zp, w) as conv(x_p, w) - zp·colsum → int32 (N,OH,OW,Cout).
    ``x_p`` is already padded with the zero point; zp is (1,) int32."""
    geo = _geometry(x_p, w_q, stride)
    n, _, _, cin, kh, kw, cout, oh, ow, _, _ = geo
    _expect(colsum, "colsum", torch.int32, (cout,))
    _expect(zp, "zp", torch.int32, (1,))
    card = _on_card(x_p, w_q, colsum, zp)
    if not card and x_p.device.type != "meta":
        return ref.qconv2d_acc_plain(x_p, w_q, colsum, zp, stride=stride)
    p = plan(n, oh, ow, cin, kh, kw, cout)
    out = torch.empty((n, oh, ow, cout), dtype=torch.int32, device=x_p.device)
    if card:
        _launch("qconv2d_acc_launch", x_p.device, x_p.data_ptr(),
                w_q.data_ptr(), colsum.data_ptr(), zp.data_ptr(),
                out.data_ptr(), *geo, *p)
        qconv2d_acc.launches += 1
    return out


@cuda_lib.counted(_ops_checksum)
def qconv2d_acc_checksum(x_p: torch.Tensor, w_q: torch.Tensor,
                         colsum: torch.Tensor, w_check: torch.Tensor,
                         zp: torch.Tensor, *, stride=(1, 1)):
    """(acc, want): ``qconv2d_acc`` plus the per-pixel ABFT check channel
    want (N,OH,OW) int32 = conv(x_p - zp, w_check) mod 2^32, which equals
    the Cout-sum of acc mod 2^32 on a fault-free pass."""
    geo = _geometry(x_p, w_q, stride)
    n, _, _, cin, kh, kw, cout, oh, ow, _, _ = geo
    _expect(colsum, "colsum", torch.int32, (cout,))
    _expect(w_check, "w_check", torch.int32, (kh, kw, cin, 1))
    _expect(zp, "zp", torch.int32, (1,))
    card = _on_card(x_p, w_q, colsum, w_check, zp)
    if not card and x_p.device.type != "meta":
        return ref.qconv2d_acc_checksum_plain(x_p, w_q, colsum, w_check, zp,
                                              stride=stride)
    p = plan(n, oh, ow, cin, kh, kw, cout)
    out = torch.empty((n, oh, ow, cout), dtype=torch.int32, device=x_p.device)
    want = torch.empty((n, oh, ow), dtype=torch.int32, device=x_p.device)
    if card:
        _launch("qconv2d_acc_checksum_launch", x_p.device, x_p.data_ptr(),
                w_q.data_ptr(), colsum.data_ptr(), w_check.data_ptr(),
                zp.data_ptr(), out.data_ptr(), want.data_ptr(), *geo, *p)
        qconv2d_acc_checksum.launches += 1
    return out, want


@cuda_lib.counted(_ops)
def qconv2d(x_p: torch.Tensor, w_q: torch.Tensor, colsum: torch.Tensor,
            bias: torch.Tensor, scale: torch.Tensor, zps: torch.Tensor, *,
            stride=(1, 1)) -> torch.Tensor:
    """Conv with the fused requantisation epilogue → int8 (N,OH,OW,Cout):
    acc - x_zp·colsum + bias, ×scale in f32, round half to even, + out_zp,
    clip.  zps is (2,) int32 = [x_zp, out_zp]."""
    geo = _geometry(x_p, w_q, stride)
    n, _, _, cin, kh, kw, cout, oh, ow, _, _ = geo
    _expect(colsum, "colsum", torch.int32, (cout,))
    _expect(bias, "bias", torch.int32, (cout,))
    _expect(scale, "scale", torch.float32, (cout,))
    _expect(zps, "zps", torch.int32, (2,))
    card = _on_card(x_p, w_q, colsum, bias, scale, zps)
    if not card and x_p.device.type != "meta":
        return ref.qconv2d_plain(x_p, w_q, colsum, bias, scale, zps,
                                 stride=stride)
    p = plan(n, oh, ow, cin, kh, kw, cout)
    out = torch.empty((n, oh, ow, cout), dtype=torch.int8, device=x_p.device)
    if card:
        _launch("qconv2d_launch", x_p.device, x_p.data_ptr(), w_q.data_ptr(),
                colsum.data_ptr(), bias.data_ptr(), scale.data_ptr(),
                zps.data_ptr(), out.data_ptr(), *geo, *p)
        qconv2d.launches += 1
    return out


KERNELS = (qconv2d_acc, qconv2d_acc_checksum, qconv2d)
for _k in KERNELS:
    _k.launches = 0
del _k


def reset_launches() -> None:
    """Set every kernel's ``launches`` count to 0."""
    for k in KERNELS:
        k.launches = 0
