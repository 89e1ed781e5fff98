"""Algorithm-Based Fault Tolerance for the integer matmul and conv (exact
checksums), and the per-row bit checksum of a float op's output.

The counterpart of ``repro.core.abft``, the storage scrub's per-leaf
checksums (``storage_checksums``, ``verify_storage``) included.  The hot
path is integer, so the Huang–Abraham identities

    rowsum_N( X·W )          ==  X · (W · 1_N)              (mod 2^32)
    sum_Cout( conv(x, W) )   ==  conv(x, sum_Cout W)        (mod 2^32)

hold bit for bit, and a flipped bit b < 32 in any accumulator changes the
checksum by ±2^b ≠ 0 (mod 2^32): zero false positives, zero false
negatives.  PyTorch sums int32 into int64, so every checksum here is summed
exactly in int64 and wrapped to int32 explicitly (``wrap_int32``), which is
the reference's int32 wrap-around sum.

Recovery is a host branch on the detection flag where the reference uses
``lax.cond``: one device-to-host synchronisation per checked op.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree
from repro_torch.core import backend as backend_mod
from repro_torch.core.fault_injection import _as_bits


class AbftResult(NamedTuple):
    acc: torch.Tensor              # (M,N) or (N,OH,OW,Cout) int32 (corrected)
    ok: torch.Tensor               # () bool — no fault left after correction
    faults_detected: torch.Tensor  # () int32 — rows/pixels flagged at first


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 into int32 two's complement.

    Done by arithmetic rather than a cast, so it does not rely on what a
    narrowing conversion does out of range."""
    return (((v.to(torch.int64) + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def exact_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) · (K, N) integer tensors → int64 (M, N), exact: the products
    run in float64, exact while every partial sum stays below 2^53."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(
        torch.int64)


def row_checksum(acc: torch.Tensor) -> torch.Tensor:
    """(M, N) int32 → (M,) int32: the row sum mod 2^32."""
    return wrap_int32(acc.sum(dim=1, dtype=torch.int64))


def checksum_vector(w_q: torch.Tensor) -> torch.Tensor:
    """W · 1_N — the column-sum check vector, precomputable per layer.
    (K,) int32."""
    return w_q.to(torch.int32).sum(dim=1).to(torch.int32)


def zp_bias_correct(acc_dot: torch.Tensor, x_zp: torch.Tensor,
                    w_q: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The matmul dequant algebra, in exactly one place: the zero-point
    correction hoisted out of the inner product plus the bias,
    acc = X·W - zp·colsum(W) + bias (mod 2^32).  Shared by the ABFT path
    here and by every non-ABFT policy in core/dependability.py."""
    colsum = w_q.to(torch.int64).sum(dim=0)
    return wrap_int32(acc_dot.to(torch.int64)
                      - x_zp.to(torch.int64) * colsum[None, :]
                      + bias[None, :])


def verify_rows(x_q: torch.Tensor, acc_dot: torch.Tensor,
                w_check: torch.Tensor) -> torch.Tensor:
    """Per-row fault mask for acc_dot = X·W. True == row is clean
    (mod 2^32)."""
    want = wrap_int32(exact_dot(x_q, w_check[:, None])[:, 0])
    return row_checksum(acc_dot) == want


def abft_qmatmul(
    x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
    bias: torch.Tensor, *, inject=None, w_check=None,
    backend: backend_mod.BackendLike = None,
) -> AbftResult:
    """Checksummed quantized matmul accumulator with detect +
    recompute-recover (detection per output row).

    ``w_check`` lets the caller supply the check vector computed from a
    known-good weight copy; with it a weight-memory SEU is detected too.
    Returns the zero-point- and bias-corrected accumulator.
    """
    be = backend_mod.resolve(backend)
    if w_check is None:
        w_check = checksum_vector(w_q)
    acc_dot, want = be.matmul_acc_checksum(x_q, w_q, w_check)
    if inject is not None:
        acc_dot = inject(acc_dot)

    row_ok = row_checksum(acc_dot) == want
    faults = torch.sum(~row_ok).to(torch.int32)
    # host branch (the reference's lax.cond): one sync per checked op
    if bool(faults > 0):
        fresh = be.matmul_acc(x_q, w_q)
        acc_dot = torch.where(row_ok[:, None], acc_dot, fresh)
    ok = torch.all(row_checksum(acc_dot) == want)
    return AbftResult(zp_bias_correct(acc_dot, x_zp, w_q, bias), ok, faults)


def output_row_checksums(x: torch.Tensor) -> torch.Tensor:
    """The exact mod-2^32 sum of ``x``'s bit patterns over its last axis
    (bf16 as 16 bits, zero-extended), the last axis reduced away.

    The verification side of the float-op output checksum: a kernel that
    emits its own per-row bit checksum beside the output
    (``kernels.flashattn.kernel.flash_attention_checked``) lets the
    consumer compare bit for bit, so any single-bit flip of the emitted
    output is detected.  The result is int64 holding the uint32 value in
    [0, 2^32): ``torch.uint32`` lacks elementwise arithmetic (no ``+`` on
    the CPU in torch 2.13) and its operator coverage differs between
    versions, while int64 holds every value exactly, works everywhere, and
    compares by value with numpy's uint32 and with itself under ``==``.
    """
    bits, _ = _as_bits(x)
    width = (1 << (8 * x.element_size())) - 1
    rows = (bits.to(torch.int64) & width).sum(dim=-1)
    return rows & 0xFFFFFFFF


def _leaf_checksum(x: torch.Tensor) -> torch.Tensor:
    """The sum mod 2^32 of ``x``'s bit patterns read as unsigned, as a ()
    int64 in [0, 2^32).  Reduced with an int32 result (the reduction
    accumulates in int64 and the result wraps mod 2^32), which reads a
    32-bit leaf in place; an 8- or 16-bit leaf is widened to int32 and
    masked to its unsigned value first.  Exact below 2^31 elements."""
    if x.numel() >= 2**31:
        raise ValueError(f"storage checksum of {x.numel()} elements: the "
                         "reduction is exact below 2^31")
    bits, _ = _as_bits(x)
    if x.element_size() < 4:
        bits = bits.to(torch.int32).bitwise_and_(
            (1 << (8 * x.element_size())) - 1)
    return bits.sum(dtype=torch.int32).to(torch.int64) & 0xFFFFFFFF


def storage_checksums(params):
    """Per-leaf mod-2^32 storage checksums of a parameter pytree: each
    leaf's same-width unsigned bit patterns summed mod 2^32, so any single
    flipped bit b changes its leaf's sum by +-2^b != 0 (mod 2^32).  A tree
    of () int64 tensors holding the reference's uint32 values, leaf for
    leaf (see ``output_row_checksums`` for why int64)."""
    return tree.map(_leaf_checksum, params)


def verify_storage(params, checks):
    """A tree of () bool tensors: True == the leaf still matches its
    deploy-time checksum."""
    return tree.map(lambda a, b: a == b, storage_checksums(params), checks)


def all_verified(flags) -> bool:
    """The verdict of a tree of () bool tensors (``verify_storage``'s), in
    one host readback."""
    leaves = tree.leaves(flags)
    return bool(torch.stack(leaves).all()) if leaves else True


def channel_checksum(acc: torch.Tensor) -> torch.Tensor:
    """(N,OH,OW,Cout) int32 → (N,OH,OW) int32: the Cout-sum mod 2^32."""
    return wrap_int32(acc.sum(dim=3, dtype=torch.int64))


def conv_checksum_weight(w_q: torch.Tensor) -> torch.Tensor:
    """(KH, KW, Cin, Cout) → (KH, KW, Cin, 1): the Cout-summed check filter."""
    return w_q.to(torch.int32).sum(dim=3, keepdim=True).to(torch.int32)


def abft_qconv2d(
    x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
    bias: torch.Tensor, stride=(1, 1), padding="SAME", *, inject=None,
    w_check=None, backend: backend_mod.BackendLike = None,
) -> AbftResult:
    """Checksummed quantized conv accumulator (detection per output pixel).

    ``w_check`` — optional precomputed ``conv_checksum_weight`` from a
    known-good weight copy; with it a weight-memory SEU is detected too.
    """
    be = backend_mod.resolve(backend)
    if w_check is None:
        w_check = conv_checksum_weight(w_q)
    acc_dot, want = be.conv_acc_checksum(x_q, x_zp, w_q, w_check, stride,
                                         padding)
    if inject is not None:
        acc_dot = inject(acc_dot)

    pix_ok = channel_checksum(acc_dot) == want           # (N, OH, OW)
    faults = torch.sum(~pix_ok).to(torch.int32)
    # host branch (the reference's lax.cond): one sync per checked op
    if bool(faults > 0):
        fresh = be.conv_acc(x_q, x_zp, w_q, stride, padding)
        acc_dot = torch.where(pix_ok[..., None], acc_dot, fresh)
    ok = torch.all(channel_checksum(acc_dot) == want)
    return AbftResult(acc_dot + bias[None, None, None, :], ok, faults)
