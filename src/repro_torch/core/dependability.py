"""Dependability policy layer — ABFT / NMR / checkpoint-restart around the
quantized matmul and conv, and around attention.

The counterpart of ``Policy``, ``DependabilityStats``,
``dependable_qmatmul``, ``dependable_matmul_acc``, ``dependable_attention``
and ``dependable_qconv2d`` in ``repro.core.dependability``:

  NONE  — plain accumulator path.
  ABFT  — exact integer checksum verify + recompute-recover (attention:
          the two-tier float check column + exact output bit checksum).
  DMR   — dual execution + bitwise compare (detect-only).
  TMR   — triple execution + bitwise majority vote.
  CKPT  — checksum detection, recovery by rolling back to the golden
          operand checkpoint and re-executing the whole op.

Every policy is written against a ``core.backend`` handle.  Where the
reference branches on the device with ``lax.cond`` (the integer ops), the
port branches on the host (``bool(detected)``): one device-to-host
synchronisation per ABFT- or CKPT-checked integer op — under
``ffn.*=abft`` one per W8A8 FFN matmul, 3 per layer.  Attention needs no
branch: as in the reference it recomputes unconditionally and selects on
the device.  The counters stay on the device of the op's operands.
"""
from __future__ import annotations

import enum
from typing import Optional

import torch

from repro_torch.core import abft as abft_mod
from repro_torch.core import backend as backend_mod
from repro_torch.core import redundancy
from repro_torch.core.quant import requantize


class Policy(str, enum.Enum):
    NONE = "none"
    ABFT = "abft"
    DMR = "dmr"
    TMR = "tmr"
    CKPT = "ckpt"


class DependabilityStats:
    """Counters exported by dependable ops (a dict of () int32 tensors).

    ``faults_detected``  checks that flagged a divergence.
    ``faults_corrected`` detected faults healed in place (ABFT recompute that
                         re-verified clean, TMR votes that out-voted the bad
                         replica); DMR never corrects.
    ``faults_recovered`` detected faults healed by rollback (CKPT).
    ``checks_run``       how many verification opportunities executed.
    """

    KEYS = ("faults_detected", "faults_corrected", "faults_recovered",
            "checks_run")

    @staticmethod
    def zero(device):
        """Zeroed counters on ``device`` (that of the op's operands)."""
        return {k: torch.zeros((), dtype=torch.int32, device=device)
                for k in DependabilityStats.KEYS}

    @staticmethod
    def merge(a: dict, b: dict) -> dict:
        """Keywise sum over the union of two stats dicts."""
        return {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}}

    @staticmethod
    def to_host(stats: dict) -> dict:
        """Device scalars → plain ints, for reports and log lines."""
        return {k: int(v) for k, v in stats.items()}


def _count(v):
    return v.to(torch.int32) if isinstance(v, torch.Tensor) else int(v)


def _bump(stats: dict, detected, corrected, recovered=False) -> dict:
    """One verification round folded into the running counters."""
    return {
        "faults_detected": stats["faults_detected"] + _count(detected),
        "faults_corrected": stats["faults_corrected"] + _count(corrected),
        "faults_recovered": stats["faults_recovered"] + _count(recovered),
        "checks_run": stats["checks_run"] + 1,
    }


def dependable_qmatmul(
    policy: Policy,
    x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
    bias: torch.Tensor, scale: torch.Tensor, out_zp: torch.Tensor,
    *, inject=None, stats: Optional[dict] = None, w_check=None,
    ckpt=None, backend: backend_mod.BackendLike = None,
):
    """Quantized matmul + requant executed under a dependability policy.

    ``inject`` corrupts the int32 accumulator (replica 0's under DMR/TMR);
    ``w_check`` is the optional deploy-time checksum vector; ``ckpt`` is the
    optional golden operand checkpoint ``(x_q, w_q)`` CKPT rolls back to
    (defaults to the live operands).  Returns (y_q int8, stats).
    """
    if stats is None:
        stats = DependabilityStats.zero(x_q.device)
    be = backend_mod.resolve(backend)

    def finish(acc_dot):
        return requantize(abft_mod.zp_bias_correct(acc_dot, x_zp, w_q, bias),
                          scale, out_zp)

    if policy == Policy.ABFT:
        res = abft_mod.abft_qmatmul(x_q, x_zp, w_q, bias, inject=inject,
                                    w_check=w_check, backend=be)
        y = requantize(res.acc, scale, out_zp)
        corrected = res.faults_detected * res.ok.to(torch.int32)
        return y, _bump(stats, res.faults_detected, corrected)

    if policy == Policy.CKPT:
        # checksum-detect, then roll back to the golden operands and
        # re-execute everything, epilogue included (a corrupted w_q must not
        # leak through the zp/colsum algebra)
        ck_x, ck_w = (x_q, w_q) if ckpt is None else ckpt
        wc = w_check if w_check is not None \
            else abft_mod.checksum_vector(ck_w)
        acc_dot, want = be.matmul_acc_checksum(x_q, w_q, wc)
        if inject is not None:
            acc_dot = inject(acc_dot)
        detected = torch.any(abft_mod.row_checksum(acc_dot) != want)
        w_eff = w_q
        # host branch (the reference's lax.cond): one sync per checked op
        if bool(detected):
            acc_dot, w_eff = be.matmul_acc(ck_x, ck_w), ck_w
        recovered = detected & torch.all(
            abft_mod.row_checksum(acc_dot) == want)
        y = requantize(abft_mod.zp_bias_correct(acc_dot, x_zp, w_eff, bias),
                       scale, out_zp)
        return y, _bump(stats, detected, False, recovered)

    def run(inj):
        acc = be.matmul_acc(x_q, w_q)
        if inj is not None:
            acc = inj(acc)
        return finish(acc)

    if policy == Policy.DMR:
        y = run(inject)
        detected = ~redundancy.agree([y, run(None)])
        return y, _bump(stats, detected, False)

    if policy == Policy.TMR:
        r0, r1 = run(inject), run(None)
        disagreed = ~redundancy.agree([r0, r1])
        y = redundancy.vote([r0, r1, run(None)])
        return y, _bump(stats, disagreed, disagreed)

    return run(inject), stats


def dependable_matmul_acc(
    policy: Policy,
    x_q: torch.Tensor, w_q: torch.Tensor,
    *, inject=None, stats: Optional[dict] = None, w_check=None,
    backend: backend_mod.BackendLike = None,
):
    """Bare int32 accumulator ``x_q @ w_q`` under a dependability policy —
    what a ``PolicyMap`` threads into hot paths that own their own dequant
    epilogue (the transformer's W8A8 FFN ``_qdot``).

    Every policy is bit-identical to the plain ``be.matmul_acc`` on clean
    runs.  ABFT recomputes the flagged rows, CKPT the whole op (each after
    one host sync on the detection flag); DMR detects only; TMR votes.
    Returns ``(acc int32, stats)``.
    """
    if stats is None:
        stats = DependabilityStats.zero(x_q.device)
    be = backend_mod.resolve(backend)

    if policy in (Policy.ABFT, Policy.CKPT):
        wc = w_check if w_check is not None \
            else abft_mod.checksum_vector(w_q)
        acc, want = be.matmul_acc_checksum(x_q, w_q, wc)
        if inject is not None:
            acc = inject(acc)
        row_bad = abft_mod.row_checksum(acc) != want
        detected = torch.any(row_bad)
        # host branch (the reference's lax.cond): one sync per checked op
        if bool(detected):
            fresh = be.matmul_acc(x_q, w_q)
            acc = torch.where(row_bad[:, None], fresh, acc) \
                if policy == Policy.ABFT else fresh
        healed = detected & torch.all(abft_mod.row_checksum(acc) == want)
        corrected = healed if policy == Policy.ABFT else False
        recovered = healed if policy == Policy.CKPT else False
        return acc, _bump(stats, detected, corrected, recovered)

    def run(inj):
        acc = be.matmul_acc(x_q, w_q)
        if inj is not None:
            acc = inj(acc)
        return acc

    if policy == Policy.DMR:
        acc = run(inject)
        detected = ~redundancy.agree([acc, run(None)])
        return acc, _bump(stats, detected, False)

    if policy == Policy.TMR:
        r0, r1 = run(inject), run(None)
        disagreed = ~redundancy.agree([r0, r1])
        acc = redundancy.vote([r0, r1, run(None)])
        return acc, _bump(stats, disagreed, disagreed)

    return run(inject), stats


def dependable_attention(
    policy: Policy,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal=True, window=None,
    inject=None, stats: Optional[dict] = None,
    backend: backend_mod.BackendLike = None, tol: float = 1e-3,
):
    """Fused attention (B,H,S,hd) under a dependability policy — the float
    twin of ``dependable_qmatmul``.

    Float math admits no exact compute checksum, so ABFT here is two-tier:

      * a float check column accumulated in the execution path beside the
        output, verified as
        ``|rowsum_hd(out) - check| <= tol*(|check|+1) + u*rowsum_hd(|out|)``
        — tolerance-based, covers the softmax/accumulate compute path.  The
        last term, with u the unit roundoff of out's dtype (2^-8 for bf16,
        2^-24 for f32), allows for the rounding of each output element to
        its dtype, which the check column (kept in f32) does not see; the
        reference has no such term and, for bf16 output, flags rows whose
        rounding alone exceeds ``tol``.  For f32 it is below 1e-7 of the
        row's magnitude;
      * an exact mod-2^32 bit checksum of the emitted output rows, verified
        bit for bit — any single bit flip of the output is detected (the
        float tier alone would miss low-mantissa flips).

    ``inject`` corrupts the kernel output (replica 0's under DMR/TMR).
    ABFT recovery replaces flagged rows with the plain ``be.attn`` output,
    which is bit-identical to the checked entry's, so correction is
    bit-exact.  ABFT and CKPT recompute unconditionally and select on the
    device, as the reference does: no host synchronisation.
    Returns (out, stats).
    """
    if stats is None:
        stats = DependabilityStats.zero(q.device)
    be = backend_mod.resolve(backend)
    if be.attn is None or be.attn_checksum is None:
        raise ValueError(f"backend {be.name!r} does not register attention")

    def plain(inj):
        out = be.attn(q, k, v, causal=causal, window=window)
        if inj is not None:
            out = inj(out)
        return out

    unit = torch.finfo(q.dtype).eps / 2

    def row_ok_mask(out, check, csum):
        bit_ok = abft_mod.output_row_checksums(out) == csum
        o = out.to(torch.float32)
        flt_ok = (o.sum(dim=-1) - check).abs() \
            <= tol * (check.abs() + 1.0) + unit * o.abs().sum(dim=-1)
        return bit_ok & flt_ok

    if policy == Policy.ABFT:
        out, check, csum = be.attn_checksum(q, k, v, causal=causal,
                                            window=window)
        if inject is not None:
            out = inject(out)
        row_ok = row_ok_mask(out, check, csum)
        faults = torch.sum(~row_ok).to(torch.int32)
        fresh = be.attn(q, k, v, causal=causal, window=window)
        out = torch.where(row_ok[..., None], out, fresh)
        ok = torch.all(row_ok_mask(out, check, csum))
        corrected = faults * ok.to(torch.int32)
        return out, _bump(stats, faults, corrected)

    if policy == Policy.CKPT:
        # detect via the fused two-tier check, recover by re-executing the
        # whole op from the operands instead of selected rows
        out, check, csum = be.attn_checksum(q, k, v, causal=causal,
                                            window=window)
        if inject is not None:
            out = inject(out)
        detected = torch.any(~row_ok_mask(out, check, csum))
        fresh = be.attn(q, k, v, causal=causal, window=window)
        out = torch.where(detected, fresh, out)
        recovered = detected & torch.all(row_ok_mask(out, check, csum))
        return out, _bump(stats, detected, False, recovered)

    if policy == Policy.DMR:
        out = plain(inject)
        detected = ~redundancy.agree([out, plain(None)])
        return out, _bump(stats, detected, False)

    if policy == Policy.TMR:
        r0, r1 = plain(inject), plain(None)
        disagreed = ~redundancy.agree([r0, r1])
        out = redundancy.vote([r0, r1, plain(None)])
        return out, _bump(stats, disagreed, disagreed)

    return plain(inject), stats


def dependable_qconv2d(
    policy: Policy,
    x_q: torch.Tensor, x_zp: torch.Tensor, w_q: torch.Tensor,
    bias: torch.Tensor, scale: torch.Tensor, out_zp: torch.Tensor,
    *, stride=(1, 1), padding="SAME",
    inject=None, stats: Optional[dict] = None, w_check=None,
    ckpt=None, backend: backend_mod.BackendLike = None,
):
    """Quantized NHWC conv + requant under a dependability policy.

    ``inject`` corrupts the int32 accumulator (replica 0's under DMR/TMR);
    ``w_check`` is the optional deploy-time check filter; ``ckpt`` is the
    optional golden operand checkpoint ``(x_q, w_q)`` CKPT rolls back to.
    Returns (y_q int8, stats dict).
    """
    if stats is None:
        stats = DependabilityStats.zero(x_q.device)
    be = backend_mod.resolve(backend)

    def finish(acc):
        return requantize(acc + bias[None, None, None, :], scale, out_zp)

    if policy == Policy.ABFT:
        res = abft_mod.abft_qconv2d(x_q, x_zp, w_q, bias, stride=stride,
                                    padding=padding, inject=inject,
                                    w_check=w_check, backend=be)
        y = requantize(res.acc, scale, out_zp)
        corrected = res.faults_detected * res.ok.to(torch.int32)
        return y, _bump(stats, res.faults_detected, corrected)

    if policy == Policy.CKPT:
        ck_x, ck_w = (x_q, w_q) if ckpt is None else ckpt
        wc = w_check if w_check is not None \
            else abft_mod.conv_checksum_weight(ck_w)
        acc_dot, want = be.conv_acc_checksum(x_q, x_zp, w_q, wc, stride,
                                             padding)
        if inject is not None:
            acc_dot = inject(acc_dot)
        detected = torch.any(abft_mod.channel_checksum(acc_dot) != want)
        # host branch (the reference's lax.cond): one sync per checked op
        if bool(detected):
            acc_dot = be.conv_acc(ck_x, x_zp, ck_w, stride, padding)
        recovered = detected & torch.all(
            abft_mod.channel_checksum(acc_dot) == want)
        return finish(acc_dot), _bump(stats, detected, False, recovered)

    def run(inj):
        acc = be.conv_acc(x_q, x_zp, w_q, stride, padding)
        if inj is not None:
            acc = inj(acc)
        return finish(acc)

    if policy == Policy.DMR:
        y = run(inject)
        detected = ~redundancy.agree([y, run(None)])
        return y, _bump(stats, detected, False)

    if policy == Policy.TMR:
        r0, r1 = run(inject), run(None)
        disagreed = ~redundancy.agree([r0, r1])
        y = redundancy.vote([r0, r1, run(None)])
        return y, _bump(stats, disagreed, disagreed)

    return run(inject), stats
