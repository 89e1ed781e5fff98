"""The flash-attention kernels: build, ctypes binding and wrappers.

CUDA C++ for ``sm_90a``: the three forward kernels in ``csrc/flashattn.cu``
and the backward's dQ and dK/dV kernels in ``csrc/flashattn_bwd.cu`` (each
source's header says which TPU kernel it replaces, what bounds it and what
its design does about that), both built with ``-fmad=false`` and bound by
``kernels/cuda_lib.py``, one library per source.

bf16 inputs run on the tensor cores (``mma.sync`` m16n8k16 fed by
``ldmatrix`` from shared memory, tiles copied by ``cp.async``,
double-buffered).  The forward: one template for the three entries, blocks
of 64 query rows over 64-key tiles.  The backward: dQ blocks of 64 query
rows over 64-key tiles, dK/dV blocks of 64 keys over the group's query
tiles (64 rows, 32 at hd 112 and 128).  P (and in the backward dS) enters its
products as a hi + lo bf16 pair: rounded once to bf16 it would leave the
tolerance (``tests/test_torch_flash_fwd_split.py``,
``tests/test_torch_flash_bwd_split.py``).  f32 inputs keep the f32 FMA
kernels on the CUDA cores, so they keep f32 accuracy.  No float atomics
on either path: two launches give the same bits, and the three forward
entries give the same ``out``.

Layouts as in the reference: q (B, H, S, hd), k/v (B, KV, S, hd), f32 or
bf16, H a multiple of KV, hd one of 16, 32, 64, 112, 128; ``causal``,
``window`` (keys at most ``window`` positions before the query),
``block_q`` and ``block_k`` keywords.  The keywords name the f32
forward's tiles: it is compiled for 16 query rows per block and 32 keys
per tile (``BLOCK_Q``, ``BLOCK_K``), and a CUDA call with other block sizes
raises.  The bf16 kernels and the backward take the same keywords, as
every caller passes them, and their own tiles are constants of their
sources.  On the CPU ``block_k`` tiles the plain version's K loop and
``block_q`` has no effect (rows are independent).

Each wrapper checks dtypes and shapes, then:

* on CUDA tensors allocates its outputs with ``torch.empty``, launches on
  the current stream, raises if the launch reports an error, and adds one
  to its ``launches`` count; the bf16 kernels copy 16-byte chunks, so a
  bf16 input that does not start at a 16-byte boundary raises;
* on CPU tensors runs the kernel's plain version (``ref.flash_plain``,
  ``ref.flash_bwd_plain``);
* on meta tensors allocates the launch path's outputs and temporaries (the
  backward's ``dvec`` and its f32 workspace, sized by ``bwd_workspace_
  floats``, the source's rule) and launches nothing (``launch.dryrun``).

A CUDA tensor reaches the kernel or an exception, never the plain version.
Under ``launch.op_analysis`` a forward counts 4·B·H·hd·S(S+1)/2 operations
(S² without causality) and the backward 10·B·H·hd·S(S+1)/2, under the
inputs' dtype: ``chip_smoke.py``'s bounds.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import F as _F, I as _I, P as _P
from repro_torch.kernels.flashattn import ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flashattn.cu"
BWD_SOURCE = SOURCE.with_name("flashattn_bwd.cu")
# no contraction of a*b+c behind the source's back: the three kernels'
# out must agree bit for bit, and the backward sums in the order written
FLAGS = ("-fmad=false",)
BLOCK_Q, BLOCK_K = 16, 32
HEAD_DIMS = (16, 32, 64, 112, 128)
_DIMS = [_I] * 8 + [_F, _P]   # b h kv s hd causal window bf16, scale, stream
_ENTRIES = {
    "flash_attention_launch": [_P] * 4 + _DIMS,
    "flash_attention_checked_launch": [_P] * 6 + _DIMS,
    "flash_attention_fwd_lse_launch": [_P] * 5 + _DIMS,
}
_BWD_ENTRIES = {"flash_attention_bwd_launch": [_P] * 10 + _DIMS}


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/flashattn.cu`` unless a library built from the same
    source and flags exists.  Returns (library path, nvcc's messages or
    "")."""
    return cuda_lib.build(SOURCE, FLAGS)


def build_bwd() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/flashattn_bwd.cu`` as ``build`` does the forward."""
    return cuda_lib.build(BWD_SOURCE, FLAGS)


@functools.lru_cache(maxsize=1)
def _lib():
    return cuda_lib.load(SOURCE, _ENTRIES, FLAGS)


@functools.lru_cache(maxsize=1)
def _bwd_lib():
    lib = cuda_lib.load(BWD_SOURCE, _BWD_ENTRIES, FLAGS)
    size = lib.flash_attention_bwd_workspace_floats     # (b, kv, s, hd)
    size.argtypes, size.restype = [_I] * 4, ctypes.c_longlong
    return lib


def _dims(q, k, v, causal, window):
    """The C entries' (b, h, kv, s, hd, causal, window, bf16, scale)."""
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"need (B,H,S,hd) q and (B,KV,S,hd) k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, hd) or v.shape != k.shape \
            or KV == 0 or H % KV or S == 0:
        raise ValueError(f"need (B,H,S,hd) q and (B,KV,S,hd) k/v with H a "
                         f"multiple of KV and S > 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not supported: the kernels are "
                         f"built for {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535 (b, h) "
                         f"blocks")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    return (B, H, KV, S, hd, int(bool(causal)),
            -1 if window is None else int(window),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd))


def _on_card(block_q, block_k, *tensors) -> bool:
    """True to launch, False for the plain version or meta; raises (on the
    card and on meta) on block sizes the kernels are not compiled for, and
    on a bf16 tensor that does not start at a 16-byte boundary."""
    card = cuda_lib.on_card("flashattn", *tensors)
    if not card and tensors[0].device.type != "meta":
        return False
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(f"the kernels are compiled for block_q={BLOCK_Q}, "
                         f"block_k={BLOCK_K}; got {block_q}, {block_k}")
    if not card:
        return False
    if any(t.data_ptr() % 16 for t in tensors if t.dtype == torch.bfloat16):
        raise ValueError("the bf16 kernels copy 16-byte chunks: their bf16 "
                         "inputs must start at 16-byte aligned addresses")
    return True


def bwd_workspace_floats(b: int, kv: int, s: int, hd: int) -> int:
    """``flash_attention_bwd_workspace_floats`` of ``csrc/flashattn_bwd.cu``
    (the bf16 dK/dV kernel's f32 totals: per (b, kv) and block of 64 keys,
    every thread's accumulator fragments of dk and dv), for meta inputs,
    which have no library to ask."""
    return b * kv * (-(-s // 64)) * 2 * (hd // 8) * 4 * 128


def _pairs(q, causal):
    s = q.shape[2]
    return s * (s + 1) // 2 if causal else s * s


def _fwd_ops(q, k, v, *, causal=True, **kw):
    return q.dtype, 4 * q.shape[0] * q.shape[1] * q.shape[3] * _pairs(q,
                                                                        causal)


def _bwd_ops(q, *args, causal=True, **kw):
    return q.dtype, 10 * q.shape[0] * q.shape[1] * q.shape[3] * _pairs(q,
                                                                         causal)


def _launch(name, device, *args):
    cuda_lib.launch(_bwd_lib() if name in _BWD_ENTRIES else _lib(), name,
                    device, *args)


@cuda_lib.counted(_fwd_ops)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K) -> torch.Tensor:
    """Causal (or windowed) GQA attention → out (B, H, S, hd), q's dtype."""
    dims = _dims(q, k, v, causal, window)
    card = _on_card(block_q, block_k, q, k, v)
    if not card and q.device.type != "meta":
        return ref.flash_plain(q, k, v, causal=causal, window=window,
                               block_k=block_k)
    out = torch.empty_like(q)
    if card:
        _launch("flash_attention_launch", q.device, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims)
        flash_attention.launches += 1
    return out


@cuda_lib.counted(_fwd_ops)
def flash_attention_checked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """(out, check, csum): ``out`` bit-identical to ``flash_attention``'s;
    ``check`` (B, H, S) f32 the fused independent rowsum_hd(out) column
    (tolerance-verified); ``csum`` (B, H, S) int64 the exact per-row
    mod-2^32 bit checksum of ``out`` (``core.abft.output_row_checksums``,
    bit-exact verification)."""
    dims = _dims(q, k, v, causal, window)
    card = _on_card(block_q, block_k, q, k, v)
    if not card and q.device.type != "meta":
        return ref.flash_plain(q, k, v, causal=causal, window=window,
                               block_k=block_k, emit="checked")
    B, H, S, _ = q.shape
    out = torch.empty_like(q)
    check = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    csum = torch.empty((B, H, S), dtype=torch.int64, device=q.device)
    if card:
        _launch("flash_attention_checked_launch", q.device, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), check.data_ptr(),
                csum.data_ptr(), *dims)
        flash_attention_checked.launches += 1
    return out, check, csum


@cuda_lib.counted(_fwd_ops)
def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """(out, lse): ``out`` bit-identical to ``flash_attention``'s and lse
    (B, H, S) f32 = m + log l, the logsumexp of each row's masked scores
    (what the backward recomputes the probabilities from)."""
    dims = _dims(q, k, v, causal, window)
    card = _on_card(block_q, block_k, q, k, v)
    if not card and q.device.type != "meta":
        return ref.flash_plain(q, k, v, causal=causal, window=window,
                               block_k=block_k, emit="lse")
    B, H, S, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if card:
        _launch("flash_attention_fwd_lse_launch", q.device, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                *dims)
        flash_attention_fwd_lse.launches += 1
    return out, lse


@cuda_lib.counted(_bwd_ops)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K):
    """(dq, dk, dv) of attention at ``out`` = attention(q, k, v) with lse
    from ``flash_attention_fwd_lse`` and ``do`` the gradient of ``out``:
    dq (B, H, S, hd), dk and dv (B, KV, S, hd), the inputs' dtypes.  The
    probabilities are rebuilt from lse; dvec = rowsum(do * out) in f32 is
    a tensor op before the two kernels, as in the reference."""
    dims = _dims(q, k, v, causal, window)
    B, H, S, _ = q.shape
    for name, t in (("out", out), ("do", do)):
        cuda_lib.expect(t, name, q.dtype, q.shape)
    cuda_lib.expect(lse, "lse", torch.float32, (B, H, S))
    card = _on_card(block_q, block_k, q, k, v, out, lse, do)
    if not card and q.device.type != "meta":
        return ref.flash_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                   window=window, block_k=block_k)
    dvec = ref.bwd_dvec(do, out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the bf16 dK/dV kernel's f32 totals, sized by its source
    size = (_bwd_lib().flash_attention_bwd_workspace_floats if card
            else bwd_workspace_floats)
    acc = None if q.dtype != torch.bfloat16 else torch.empty(
        size(B, k.shape[1], S, q.shape[-1]), dtype=torch.float32,
        device=q.device)
    if card:
        _launch("flash_attention_bwd_launch", q.device, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if acc is None else acc.data_ptr(), *dims)
        flash_attention_bwd.launches += 1
    return dq, dk, dv


KERNELS = (flash_attention, flash_attention_checked, flash_attention_fwd_lse,
           flash_attention_bwd)
for _k in KERNELS:
    _k.launches = 0
del _k


def reset_launches() -> None:
    """Set every kernel's ``launches`` count to 0."""
    for k in KERNELS:
        k.launches = 0
