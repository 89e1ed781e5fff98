#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out measurements.json]

Phases, each of which raises on failure:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the qconv2d, qmatmul, flashattn and flashattn backward kernels
   from their ``csrc/`` sources, one ``nvcc`` each, all started together;
3. hold each conv kernel ``torch.equal`` to its plain version on the card
   (and the check channel equal to the Cout-sum of acc), at all 8
   ``network_specs(194)`` layer shapes (N = 2), a ragged Cout tail, a
   stride (2, 1) case, non-zero zero points, a check channel that wraps mod
   2^32, the template's edges (Cin 1, 3, 5; x_p off a 16-byte boundary by
   1, 4 and 8 bytes; Cout 6 and 100; two 5x5x600 convs; 1 to 200 pixels at
   24 and 48 channels), 48 seeded random geometries, and the fused kernel's
   rounding (sums on .5 ties, clamps at both ends); the fused kernel equal
   across two launches;
4. slice 1: ``shipdet.forward`` at ``network_specs(194)`` on 4 frames
   under the fused NONE path and, on the ``cuda`` backend, NONE, ABFT, CKPT
   (deploy checks + golden weights), DMR and TMR; all bit-identical to each
   other and to the ``ref`` backend; ABFT heals a flipped accumulator bit,
   CKPT a flipped weight bit; within 4 output steps of ``float_forward``;
   every kernel's launch count above 0;
5. hold each matmul kernel ``torch.equal`` to its plain version on the
   card (and the check vector equal to the row sums of acc): the W8A8 FFN
   shapes of SmolLM-135M at M = 8 and 64, a ragged case, zero points, a
   check vector that wraps past 2^31, odd K and N, the accumulator
   kernel's edges (M from 1 to 200 over K and N off multiples of 32, 16
   and 4), inputs off every 16-byte boundary, the flash prefills' FFN
   shapes at M = 256 and 1024, seeded random geometries, and the fused
   kernel's rounding (.5 ties, clamps at both ends); the fused kernel equal
   across two launches;
6. slice 2: ``Engine`` over SmolLM-135M at full width (30 layers, W8A8
   FFN, bf16 compute, random weights from a seed) serves 16 seeded requests
   under no map, ``ffn.*=abft``, ``ffn.*=tmr`` and the ``ref`` backend:
   every request completes, the four token streams are bit-identical, and
   each kernel's launch count equals the one derived from the engine's
   steps; ``dependable_matmul_acc`` heals an injected accumulator flip at
   each FFN shape; ``qlinear_act`` drives the fused ``qmatmul`` at the FFN
   shapes;
7. hold each attention kernel against its plain version on the card, f32
   and bf16: SmolLM-135M prefill shapes (1, 9, S, 64)/(1, 3, S, 64) at
   S = 64, 192, 1024; S = 200 at hd 16, 32, 128; G = 4 with B = 2; a
   window; non-causal; 12 seeded random geometries; within 1e-5 (f32) or
   one bf16 step plus 1e-5 (bf16), the worst error / limit printed per
   dtype.  The three kernels' out are torch.equal to each other and across
   two launches, csum equals the recomputed bit checksum, the check column
   is within 1e-4 of rowsum_hd(out);
8. slice 3: ``Engine`` over the same SmolLM-135M with
   ``attn_impl="flash"`` serves 8 seeded requests with prompts of 64-1000
   tokens under no map, ``ffn.*=abft`` and ``ffn.*=tmr``: every request
   completes, the streams are bit-identical, ``flash_attention_fwd_lse``
   ran 30 times per prefill; request 0's prefill logits agree with the
   chunked path's; ``dependable_attention`` on layer 0's q/k/v of a
   1024-token prefill under every policy: equal on clean input, ABFT and
   CKPT heal output bit flips, DMR detects, TMR outvotes, launch counts as
   derived;
9. hold the attention backward (dQ and dK/dV kernels, bf16 on the tensor
   cores, f32 on the CUDA cores, one wrapper) against its plain version on
   the card, f32 and bf16, at the training shape (8, 9, 1024, 64)/(8, 3,
   1024, 64) and the attention cases of 7; two launches torch.equal; the
   worst error / limit ratio per dtype;
10. slice 4: ``ft_loop.run`` trains SmolLM-135M at full width and depth
   (f32 params, bf16 compute, AdamW, remat save_dots, attn_impl flash,
   batch 8 × 1024) in a temporary directory: a clean run of 12 steps
   (the loss falls), a second clean run bit-identical to it, a NaN in
   embed[0, 0] at step 9 (one recovery, bit-identical losses), a run
   stopped at 8 and resumed (bit-identical), a bit-flip drill (finite
   losses); fwd_lse and bwd launches as derived from the steps executed;
   one step's gradients, flash against chunked, beside the bf16 noise
   floor;
11. slice 10: the port's SEU campaign through ``run_campaign`` and
   ``run_bit_sweep`` on the ``cuda`` backend at full width
   (``CAMPAIGN_CASES``: qmatmul at SmolLM-135M's decode FFN shapes 8x576x1536
   and 8x1536x576; qconv2d at the two Table-1 bit-sweep geometries and
   conv_24x3x3x24 at its 194x194 input; flashattn at (1, 9, 1024, 64) f32;
   the reduced ship detector and transformer), asserting the reference's
   verdicts: qmatmul ABFT/accumulator detection 1.000 and SDC 0, NONE
   SDC > 0, TMR SDC 0 at every site and under ``mbu_burst``, DMR detected
   exactly when the output differs and nothing corrected, CKPT SDC 0 and
   nothing uncorrected at the weights site; qconv2d and shipdet ABFT and
   CKPT SDC 0 at the accumulator; the ship detector's weights site covered
   (SDC 0, faults detected) under ABFT and CKPT; flashattn ABFT detects
   every output bit flip, NONE SDC > 0; the transformer's TMR SDC 0, DMR
   as above, NONE SDC > 0; the bit sweep (qmatmul and both Table-1 convs)
   ABFT SDC 0 at all 32 accumulator bits and NONE SDC at every bit-31
   trial; ``run_trials`` on the same seeds equal under ``ref``,
   ``torch`` and ``cuda`` (qmatmul, qconv2d, shipdet); rows 1, 2, 4, 5,
   7, 8 launched under ``cuda`` and no kernel under ``ref`` or ``torch``;
   trials/s per workload and policy; the phase within
   ``CAMPAIGN_BUDGET_S``;
12. slice 11: dependable serving at full width (SmolLM-135M at 15 of its
   30 layers since slice 13, W8A8 FFN, bf16, flash prefill, capacity 8,
   16 requests of 32 new tokens) under
   ``PolicyMap.uniform(ABFT)`` (scrubs ``detect``) and ``uniform(CKPT)``
   (``rollback``, the storage scrub every pump), the int8 KV cache off and
   on: clean runs raise no alarm; one run per map (8 requests) strikes the
   cache's k page, its k scales (int8 cache), the token buffer and a weight, four
   pumps apart, each detected one tick later, CKPT recovering every one
   with streams equal to the clean ones; ``multi_step`` 4 equal to 1; two
   same-seed runs with the tracer, metrics and event log byte-identical;
   the ``serving`` and ``serving_int8kv`` campaigns at the reference's
   case on the ``cuda`` backend (CKPT SDC 0, ABFT detection 1.000 at
   every site, ``ref`` equal to ``cuda`` trial by trial); rows 4, 5 and 9
   launched; decode ms/step and host syncs per step with the scrubs off,
   ``detect`` and ``rollback``, the int8 cache off and on; one pass of
   each scrub on the device beside its bound, the storage checksums equal
   to the CPU's; the phase within ``DEP_BUDGET_S``; it runs after the
   timings and profiles of 13;
14. slice 12, the serving fleet at full width (``phase_fleet``:
   SmolLM-135M at 15 of its 30 layers since slice 13, W8A8 FFN, bf16,
   flash prefill, capacity 8, 12 requests of
   16 new tokens, prompts of 8-512 tokens): NONE, ABFT (under
   ``PolicyMap.uniform(ABFT)``), DMR and CKPT fleets of 3 replicas serve
   one ``Engine``'s streams with rows 4, 5 and 9 launched as derived; a
   weight strike restored incrementally onto the card, a token-buffer
   strike replayed under DMR, a KV-cache strike rolled back under CKPT, a
   replica killed, a rolling deploy to seed-1 params and a strike mid-swap,
   each with the clean streams; the proc transport with 2 workers on the
   card, clean and with a worker SIGKILLed, its workers gone at the end;
   the ``fleet`` and ``fleet_mp`` campaigns (ABFT and CKPT SDC 0, NONE
   SDC > 0, DMR SDC 0 at the transient sites; ``ref`` == ``cuda`` trial
   by trial on the case with the W8A8 FFN, so that row 4 is held against
   its plain version); ms per tick and tokens/s per policy, recovery
   seconds, proc against in-process, peak memory, the seconds of each
   step; within ``FLEET_BUDGET_S``;
15. slice 12, the embedding-input models (``phase_embed``): musicgen-large
   at full width with 24 of its 48 layers (cut in slice 13 to keep the
   script's time) and llava-next-34b with 4 of its 60 layers, W8A8
   FFN, flash prefill: ``prefill(embeds=)`` at S 1500 and 2880 and 16
   ``decode_step(embed=)`` steps, logits finite, greedy streams under
   ``cuda`` equal to ``ref``, rows 4 and 9 launched as derived, row 9
   against its plain version at each model's attention shape; prefill ms
   and decode ms/step; within ``EMBED_BUDGET_S``.
16. slice 13, the selective-hardening DSE (``phase_dse``): the cost
   oracle at full width (``dse.cost.measure_serving`` on SmolLM-135M in
   full, W8A8 FFN, batch 8, reusing the main path's params; every decode
   window once with rows 4 and 5 launched as derived and its tokens equal
   to the unmapped window's, ``ref`` == ``cuda`` on two windows;
   ``measure_shipdet(reduced=False)`` at ``network_specs(194)``, rows 1
   and 2 as derived), printed per FFN site × policy, scrub and conv layer;
   then ``repro_torch.dse.cli search`` and ``certify`` (the CLI's 150
   trials per site) in both spaces on the ``cuda`` backend against this
   card's cost model, in a temporary
   directory: exit code 0 (SDC = 0 at every site, cost below uniform
   ABFT), the genes, ``campaigns_run`` and the cost ratio; the best maps'
   trials equal under ``ref`` and ``cuda``; within ``DSE_BUDGET_S``;
17. slice 13, the recurrent families (``phase_recurrent``): rwkv6-1.6b in
   full and recurrentgemma-2b at full width with 8 of its 26 layers, each
   with the logits of a 64-token prefill's last position and 16 decode
   steps against ``forward``'s in f32 (``REC_TOL``, which a bf16 control
   must miss), an ``Engine`` of capacity 4 serving prompts of 8–512
   tokens (and 2,560 for recurrentgemma, past its 2,048 window) with the
   streams of one request at a time, a strike on the recurrent state
   healed under ``state_scrub="rollback"``, and no kernel launched; param
   seconds, prefill ms and decode ms/step; within ``REC_BUDGET_S``.
13. time each kernel at the main paths' shapes with CUDA events beside its
   plain version, its bound and the library call where one exists
   (``scaled_dot_product_attention`` for attention and its backward,
   ``torch._int_mm`` on rows padded to M = 32 for the matmul accumulator,
   an f32 ``F.conv2d`` with TF32 off on the same integer values for the
   conv accumulators, and a decode step's 90 FFN calls over distinct,
   L2-cold weights), the
   forward's frames/s per policy, decode ms/step, tokens/s and prefill ms
   per map, flash and chunked prefill ms at S = 64, 256, 1024, train step
   ms and tokens/s; then, under torch.profiler, the device busy time and
   idle share of the forward, of decode steps, of a flash prefill and of a
   train step, and each kernel call's device time (the backward's dQ and
   dK/dV kernels apart; each call of the conv and matmul kernels exactly
   one device op, the row's kernel;
   ``torch._int_mm``'s and cuDNN's beside them).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that holds no checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
INT32_OPS_PER_S = 67e12            # CUDA-core rate, for the int32 check channel
BATCH = 4                          # frames per forward on the main path
RANDOM_CASES = 48                  # seeded random geometries in phase 3
FORWARD_ROUNDS = 3                 # timing rounds of 10 forwards per policy
DEVICE = "cuda"
CONV_SOURCE = "src/repro_torch/kernels/qconv2d/csrc/qconv2d.cu"
MATMUL_SOURCE = "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu"
REPLACES = {
    "qconv2d_acc": "src/repro/kernels/qconv2d/kernel.py:128",
    "qconv2d_acc_checksum": "src/repro/kernels/qconv2d/kernel.py:163",
    "qconv2d": "src/repro/kernels/qconv2d/kernel.py:211",
}
CONV_OPS = {                       # each row's device op, by name
    "qconv2d_acc": "qconv2d_mma_kernel<0",
    "qconv2d_acc_checksum": "qconv2d_mma_kernel<1",
    "qconv2d": "qconv2d_mma_kernel<2",
}
MATMUL_REPLACES = {
    "qmatmul_acc": "src/repro/kernels/qmatmul/kernel.py:138",
    "qmatmul_acc_checksum": "src/repro/kernels/qmatmul/kernel.py:176",
    "qmatmul": "src/repro/kernels/qmatmul/kernel.py:224",
}
MATMUL_OPS = {                     # each row's device op, by name
    "qmatmul_acc": "qmatmul_mma_kernel<0>",
    "qmatmul_acc_checksum": "qmatmul_mma_kernel<1>",
    "qmatmul": "qmatmul_mma_kernel<2>",
}
# slice 2: the serving path
ARCH = "smollm-135m"
CAPACITY = 8                       # decode slots: the FFN runs M = 8
PREFILL_PAD = 64                   # prefill FFN runs M = 64
N_REQUESTS = 16
MAX_NEW = 32
MAX_LEN = 256
MAPS = {                           # engine keywords per serving cell
    "none": {},
    "ffn_abft": {"policy_map": {"rules": [{"pattern": "ffn.*",
                                           "policy": "abft"}]}},
    "ffn_tmr": {"policy_map": {"rules": [{"pattern": "ffn.*",
                                          "policy": "tmr"}]}},
    "ref_backend": {"backend": "ref"},
}
RANDOM_MATMUL_CASES = 24
EDGE_ROWS = (1, 7, 8, 9, 16, 17, 63, 64, 65, 200)
EDGE_KN = ((600, 1000), (99, 41), (1536, 70))
COLD_LAYERS = 30                   # distinct FFN weights per cold decode step
INT_MM_MIN_M = 32                  # torch._int_mm refuses M <= 16
DECODE_ROUNDS = 2                  # timing rounds of 20 decode steps per map
# slice 3: the attention kernels
BF16_FLOPS_PER_S = 989e12          # tensor cores, dense
F32_FLOPS_PER_S = 67e12            # CUDA cores
FLASH_SOURCE = "src/repro_torch/kernels/flashattn/csrc/flashattn.cu"
FLASH_REPLACES = {
    "flash_attention": "src/repro/kernels/flashattn/kernel.py:106",
    "flash_attention_checked": "src/repro/kernels/flashattn/kernel.py:258",
    "flash_attention_fwd_lse": "src/repro/kernels/flashattn/kernel.py:522",
}
FLASH_REQUESTS = 8
FLASH_MAX_NEW = 16
FLASH_MAX_LEN = 1280               # prompts up to 1000 tokens, 1024 padded
FLASH_TIME_S = (64, 256, 1024)
RANDOM_FLASH_CASES = 12
# slice 4: fault-tolerant training on the backward kernels
FLASH_BWD_SOURCE = "src/repro_torch/kernels/flashattn/csrc/flashattn_bwd.cu"
BWD_REPLACES = {
    "flash_attention_bwd": "src/repro/kernels/flashattn/kernel.py:571",
}
TRAIN_BATCH, TRAIN_SEQ = 8, 1024   # ShapeConfig(kind="train"), 8192 tokens
TRAIN_STEPS = 12
TRAIN_CKPT_EVERY = 4
TRAIN_NAN_STEP = 9
TRAIN_RESUME_AT = 8
TRAIN_ROUNDS = 3                   # timing rounds of one train step
DRILL_SEED = 4                     # inject_into_pytree's generator seed


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to drive")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def _timed_build(build):
    t0 = time.perf_counter()
    lib, log = build()
    return lib, log, time.perf_counter() - t0


def _kernel_name(mangled: str) -> str:
    """The unqualified name and integer template arguments of a mangled
    kernel name: ``flash_bwd_dq_mma_kernel<64>``."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.findall(r"Li(-?\d+)E", mangled[i:]) \
        if mangled[i:i + 1] == "I" else []
    return f"{name}<{', '.join(args)}>" if args else name


def phase_build(builds) -> float:
    """One nvcc per source (each ``build`` function compiles one), all
    started together; prints ptxas's registers and spills per kernel;
    returns the wall time."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        builds = list(pool.map(_timed_build, builds))
    for lib, log, secs in builds:
        print(f"build: {lib.name} in {secs:.2f} s")
        name, spill = "?", ""
        for line in log.splitlines():
            if "Function properties for" in line:
                name = _kernel_name(line.split(" for ", 1)[1].strip())
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"  {name}: {line.split(':', 1)[1].strip()}; {spill}")
            elif "error" in line:
                print(f"  {line.strip()}")
    return time.perf_counter() - t0


class Case:
    """Random inputs of one kernel call, made on the card from a seed."""

    def __init__(self, gen, n, h, w, cin, cout, kh, kw, stride, padding,
                 x_zp=None, out_zp=None, x_fill=None, w_fill=None,
                 ties=False):
        """``ties``: x in [-4, 4), w in [-1, 1] and scale 0.5, so that the
        fused kernel's odd sums land on .5 and the larger ones clamp at
        both ends."""
        from repro_torch.core.abft import conv_checksum_weight
        from repro_torch.kernels.qconv2d import ops
        dev = DEVICE

        def ints(lo, hi, shape, dtype):
            return torch.randint(lo, hi, shape, generator=gen, device=dev,
                                 dtype=dtype)

        self.stride = stride
        x_q = ints(-4, 4, (n, h, w, cin), torch.int8) if ties \
            else ints(-128, 128, (n, h, w, cin), torch.int8)
        w_q = ints(-1, 2, (kh, kw, cin, cout), torch.int8) if ties \
            else ints(-127, 128, (kh, kw, cin, cout), torch.int8)
        if x_fill is not None:
            x_q.fill_(x_fill)
        if w_fill is not None:
            w_q.fill_(w_fill)
        x_zp = int(ints(-10, 11, (), torch.int32)) if x_zp is None else x_zp
        out_zp = int(ints(-10, 11, (), torch.int32)) if out_zp is None \
            else out_zp
        zp0 = torch.tensor(x_zp, dtype=torch.int32, device=dev)
        pads = ops.resolve_pads(h, w, kh, kw, stride, padding)
        self.x_p = ops.pad_zp(x_q, zp0, pads)
        self.w_q = w_q
        self.colsum = ops.weight_colsum(w_q)
        self.w_check = conv_checksum_weight(w_q)
        self.zp = zp0.reshape(1)
        self.bias = ints(-1000, 1000, (cout,), torch.int32)
        self.scale = torch.empty(cout, device=dev).uniform_(
            1e-4, 5e-3, generator=gen)
        if ties:
            self.scale.fill_(0.5)
        self.zps = torch.tensor([x_zp, out_zp], dtype=torch.int32, device=dev)

    def args(self, name):
        if name == "qconv2d_acc":
            return (self.x_p, self.w_q, self.colsum, self.zp)
        if name == "qconv2d_acc_checksum":
            return (self.x_p, self.w_q, self.colsum, self.w_check, self.zp)
        return (self.x_p, self.w_q, self.colsum, self.bias, self.scale,
                self.zps)

    def bound_ms(self, name):
        """Least time on an H100 SXM: each input read once, each output
        written once, int8 MACs at the tensor-core rate."""
        n, hp, wp, cin = self.x_p.shape
        kh, kw, _, cout = self.w_q.shape
        sh, sw = self.stride
        pix = n * ((hp - kh) // sh + 1) * ((wp - kw) // sw + 1)
        taps = kh * kw * cin
        nbytes = self.x_p.numel() + self.w_q.numel() + 4 * cout + 4
        int8_ops, int32_ops = 2 * pix * cout * taps, 0
        if name == "qconv2d":
            nbytes += 8 * cout + 4 + pix * cout
        else:
            nbytes += 4 * pix * cout
        if name == "qconv2d_acc_checksum":
            nbytes += 4 * taps + 4 * pix
            int32_ops = 2 * pix * taps
        t_ops = int8_ops / INT8_OPS_PER_S + int32_ops / INT32_OPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), \
            ("bytes" if t_bytes >= t_ops else "operations")


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _max_err(got, want) -> int:
    errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            for g, w in zip(_outputs(got), _outputs(want))]
    if any(not torch.equal(g, w)
           for g, w in zip(_outputs(got), _outputs(want))):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max abs err {max(errs)})")
    return max(errs)


def _kernels():
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.kernels.qconv2d import ref as R
    return {"qconv2d_acc": (K.qconv2d_acc, R.qconv2d_acc_plain),
            "qconv2d_acc_checksum": (K.qconv2d_acc_checksum,
                                     R.qconv2d_acc_checksum_plain),
            "qconv2d": (K.qconv2d, R.qconv2d_plain)}


def main_path_sides(specs):
    """Each layer's input side as the forward meets it: SAME convs, so a
    stride-2 layer halves the map rounding up (388 → 194 → 97 → 49, where
    the specs' nominal sizes say 98 and 50)."""
    sides, side = [], specs[0].h
    for s in specs:
        sides.append(side)
        side = -(-side // s.stride)
    return sides, side


def _random_case(gen, seed) -> Case:
    """A seeded random geometry: any Cin/Cout (ragged tails, Cin not a
    multiple of 4), 1/3/5-wide kernels, mixed strides, SAME or VALID, zero
    points over the whole int8 range."""
    rng = random.Random(seed)
    kh, kw = rng.choice((1, 3, 5)), rng.choice((1, 3, 5))
    return Case(gen, rng.randint(1, 3), rng.randint(kh, 40),
                rng.randint(kw, 40), rng.randint(1, 100), rng.randint(1, 100),
                kh, kw, (rng.randint(1, 2), rng.randint(1, 2)),
                rng.choice(("SAME", "VALID")), x_zp=rng.randint(-128, 127),
                out_zp=rng.randint(-128, 127))


def _offset_view(t, offset):
    """A contiguous copy of the int8 ``t`` that starts ``offset`` bytes past
    a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=torch.int8, device=t.device)
    v = buf[offset:offset + t.numel()].view(t.shape)
    v.copy_(t)
    return v


def conv_edge_cases(gen):
    """Geometries the accumulator kernels' design must survive: Cin of 1, 3
    and 5 (runs of x cut into words from any address), x_p off a 16-byte
    boundary by 1, 4 and 8 bytes (words cut, 4- and 8-byte loads at Cin =
    48), Cout 6 and 100 (a part-empty n tile, a 4-channel Cout tile),
    5x5x600 convs whose B (K = 15,040 bytes) does not fit a block's shared
    memory whole and is staged in pieces: one of a single pixel tile, and
    one of more pixel tiles than the card holds blocks at once, so that
    every block restages B's pieces between its barriers for several
    tiles; and pixel counts off every tile multiple (1 to 200 pixels at 24
    and 48 channels).  All three kernels run each."""
    from repro_torch.kernels.qconv2d import kernel as CK
    # at most this many blocks of the plan's shared memory per SM of an
    # H100 (228 KB an SM, 1 KB of it kept per block)
    p = CK.plan(2, 200, 200, 600, 5, 5, 24)
    per_sm = 233472 // (CK.smem_bytes(p.bt_k) + 1024)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if not (p.bt_k < CK.k_padded(5, 5, 600) and p.tiles > per_sm * sms):
        raise AssertionError(f"k_5x5x600_tiles: plan {p} does not walk more "
                             f"tiles than {per_sm} x {sms} blocks")
    cases = [(f"cin_{c}", Case(gen, 2, 15, 13, c, 24, 3, 3, (1, 1), "SAME"),
              tuple(REPLACES)) for c in (1, 3, 5)]
    for off in (1, 4, 8):
        case = Case(gen, 2, 11, 12, 48, 48, 3, 3, (1, 1), "SAME")
        case.x_p = _offset_view(case.x_p, off)
        cases.append((f"x_offset_{off}", case, tuple(REPLACES)))
    cases += [(f"cout_{c}", Case(gen, 2, 13, 13, 96, c, 1, 1, (1, 1),
                                 "SAME"), tuple(REPLACES)) for c in (6, 100)]
    cases.append(("k_5x5x600", Case(gen, 1, 9, 10, 600, 40, 5, 5, (1, 1),
                                    "SAME"), tuple(REPLACES)))
    cases.append(("k_5x5x600_tiles", Case(gen, 2, 200, 200, 600, 24, 5, 5,
                                          (1, 1), "SAME"), tuple(REPLACES)))
    cases += [(f"pixels_{p}_cout_{c}", Case(gen, 1, 1, p, 24, c, 1, 1,
                                            (1, 1), "VALID"), tuple(REPLACES))
              for p in (1, 63, 65, 127, 129, 200) for c in (24, 48)]
    return cases


def phase_compare(specs, gen) -> dict:
    from repro_torch.core.abft import channel_checksum
    every = tuple(REPLACES)
    cases = [(s.name, Case(gen, 2, h, h, s.cin, s.cout, s.kh, s.kw,
                           (s.stride, s.stride), "SAME"), every)
             for s, h in zip(specs, main_path_sides(specs)[0])]
    cases += [
        ("ragged_cout", Case(gen, 2, 13, 11, 10, 70, 3, 3, (1, 1), "SAME"),
         every),
        ("stride_2x1", Case(gen, 2, 17, 19, 8, 16, 5, 3, (2, 1), "VALID"),
         every),
        ("zero_points", Case(gen, 1, 21, 21, 24, 40, 3, 3, (2, 2), "SAME",
                             x_zp=-77, out_zp=53), every),
        ("check_wraps", Case(gen, 1, 6, 6, 96, 96, 3, 3, (1, 1), "VALID",
                             x_zp=127, out_zp=0, x_fill=-128, w_fill=127),
         every),
    ]
    cases += conv_edge_cases(gen)
    cases += [(f"random_{i}", _random_case(gen, i), every)
              for i in range(RANDOM_CASES)]
    # the fused kernel's rounding: .5 ties and clamps at both ends
    cases += [("ties_cout_24", Case(gen, 2, 9, 8, 24, 24, 3, 3, (1, 1),
                                    "SAME", ties=True), ("qconv2d",)),
              ("ties_cout_70", Case(gen, 1, 7, 9, 40, 70, 3, 3, (2, 2),
                                    "SAME", ties=True), ("qconv2d",))]
    max_err = {name: 0 for name in REPLACES}
    for label, case, names in cases:
        for name, (kern, plain) in _kernels().items():
            if name not in names:
                continue
            got = kern(*case.args(name), stride=case.stride)
            torch.cuda.synchronize()
            want = plain(*case.args(name), stride=case.stride)
            max_err[name] = max(max_err[name], _max_err(got, want))
            if name == "qconv2d_acc_checksum" and not torch.equal(
                    channel_checksum(got[0]), got[1]):
                raise AssertionError(f"{label}: check channel != Cout-sum")
            if name == "qconv2d" and not torch.equal(
                    got, kern(*case.args(name), stride=case.stride)):
                raise AssertionError(f"{label}: row 3 differs across two "
                                     f"launches")
            if name == "qconv2d" and label.startswith("ties"):
                acc = _kernels()["qconv2d_acc"][1](
                    *case.args("qconv2d_acc"), stride=case.stride)
                _ties_seen(label, got, acc.to(torch.int64) + case.bias)
    acc = sum("qconv2d_acc" in names for _, _, names in cases)
    fused = sum("qconv2d" in names for _, _, names in cases)
    print(f"compare: {len(cases)} cases ({acc} of rows 1 and 2, {fused} of "
          f"row 3) torch.equal to the plain versions on the card, want == "
          f"the Cout-sum of acc, row 3 equal across two launches")
    return max_err


def _ties_seen(label, out, v):
    """A tie case's int8 output reaches both clamps, and some of its sums
    ``v`` (int64, before requantisation) land on .5 unclamped: odd sums at
    scale 0.5."""
    ties = int(((v % 2 != 0) & (v.abs() < 250)).sum())
    lo, hi = bool((out == -128).any()), bool((out == 127).any())
    if not (ties and lo and hi):
        raise AssertionError(f"{label}: {ties} ties, clamps at -128 {lo}, "
                             f"at 127 {hi}")


def phase_slice(specs, params, frames):
    from repro_torch.core.dependability import DependabilityStats, Policy
    from repro_torch.core.fault_injection import flip_bit_at_index
    from repro_torch.core.policy_map import PolicyMap
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.models import shipdet

    def run(p=params, **kw):
        y, st = shipdet.forward(specs, p, frames, **kw)
        torch.cuda.synchronize()
        return y, DependabilityStats.to_host(st)

    checks = shipdet.deploy_checks(params)
    golden = shipdet.golden_weights(params)
    mid = len(specs) // 2
    faulty = list(params)
    faulty[mid] = dict(params[mid])
    faulty[mid]["qconv"] = params[mid]["qconv"]._replace(
        w_q=flip_bit_at_index(params[mid]["qconv"].w_q,
                              params[mid]["qconv"].w_q.numel() // 3, 6))

    K.reset_launches()
    t0 = time.perf_counter()
    y, _ = run()
    outs = {
        "none_cuda": run(backend="cuda"),
        "abft": run(policy=Policy.ABFT),
        "ckpt": run(policy=Policy.CKPT, w_checks=checks, golden_wq=golden),
        "dmr": run(policy_map=PolicyMap.uniform(Policy.DMR)),
        "tmr": run(policy_map=PolicyMap.uniform(Policy.TMR)),
        "abft_struck": run(policy=Policy.ABFT, inject=lambda acc:
                           flip_bit_at_index(acc, acc.numel() // 3, 18)),
        "ckpt_struck": run(faulty, policy=Policy.CKPT, w_checks=checks,
                           golden_wq=golden),
    }
    launches = {k.__name__: k.launches for k in K.KERNELS}
    secs = time.perf_counter() - t0
    print(f"slice: 8 forwards of {tuple(frames.shape)} in {secs:.2f} s, "
          f"launches {launches}")

    side = main_path_sides(specs)[1]
    n_out = (frames.shape[0], side, side, specs[-1].cout)
    if tuple(y.shape) != n_out or not torch.isfinite(y).all():
        raise AssertionError(f"bad detection map {tuple(y.shape)}")
    for name, (y_p, st) in outs.items():
        if not torch.equal(y_p, y):
            raise AssertionError(f"{name} output differs from the fused path")
        print(f"  {name:12s} == fused  stats {st}")
    for name in ("none_cuda", "abft", "ckpt", "dmr", "tmr"):
        if outs[name][1]["faults_detected"] != 0:
            raise AssertionError(f"{name}: false alarm {outs[name][1]}")
    if outs["abft"][1]["checks_run"] != len(specs):
        raise AssertionError(f"abft checks {outs['abft'][1]}")
    st = outs["abft_struck"][1]
    if st["faults_detected"] < 1 or st["faults_corrected"] < 1:
        raise AssertionError(f"ABFT missed the accumulator flip: {st}")
    st = outs["ckpt_struck"][1]
    if st["faults_detected"] < 1 or st["faults_recovered"] < 1:
        raise AssertionError(f"CKPT missed the weight flip: {st}")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")

    y_ref, _ = run(backend="ref")
    if not torch.equal(y_ref, y):
        raise AssertionError("cuda forward differs from the ref backend")
    y_float = shipdet.float_forward(specs, params, frames)
    step = float(params[-1]["out_scale"])
    err = float((y - y_float).abs().max())
    print(f"  ref backend == fused; quantised vs float: max abs {err:.6f} "
          f"= {err / step:.3f} output steps")
    if not err < 4 * step:
        raise AssertionError("int8 pipeline diverged from the float oracle")
    return launches


def _time_ms(fn, reps, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps, match) -> float | None:
    """Mean device time of the kernels ``fn`` launches whose name holds
    ``match`` (every device op where ``match`` is None), from the
    profiler's CUPTI trace (None where the profiler sees no device
    activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (match is None or match in e.name)]
    return sum(spans) / reps / 1e3 if spans else None


def _device_ops(fn, reps):
    """Device ms per run of ``fn``, device ops per run and the set of their
    names, from the profiler's CUPTI trace (ms None where it sees no device
    activity).  The trace can miss a record (it saw 48 of 50 calls in one
    run on an H100), so the ms per run is the mean op's time times the
    whole number of ops per run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e.time_range.end - e.time_range.start for e in ops]
    if not spans:
        return None, 0.0, set()
    per_run = max(1, round(len(spans) / reps))
    return (sum(spans) / len(spans) * per_run / 1e3, len(ops) / reps,
            {e.name for e in ops})


def _device_ops_seen(fn, reps, per_run, tries=5):
    """``_device_ops`` of ``fn``, over up to ``tries`` profiler windows,
    until one shows at least 90 % of the ``per_run`` ops expected of each
    run: a window can lose a few records and, now and then, all of them."""
    for _ in range(tries):
        ms, ops, names = _device_ops(fn, reps)
        if ops >= 0.9 * per_run:
            break
    return ms, ops, names


def cudnn_yardstick(case):
    """One ``F.conv2d`` in f32 on the case's integer values (NHWC in memory,
    TF32 off): the library yardstick of rows 1 and 2.  It is not the same
    function (no zero-point term, f32 out); summed directly it would be
    exact here (K <= 1024 products of at most 128 * 128 stay below 2^24),
    but cuDNN picks its own algorithm, so ``phase_time`` reports how far it
    is off.  The port never calls it."""
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    x = case.x_p.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)
    w = case.w_q.permute(3, 2, 0, 1).float().contiguous(
        memory_format=torch.channels_last)
    return functools.partial(F.conv2d, x, w, stride=case.stride)


def phase_time(specs, gen, max_err):
    """CUDA-event times per call at the main path's shapes, and the cuDNN
    yardstick's beside rows 1 and 2 with its largest difference from row
    1's acc (its f32 sums minus zp * colsum, mod 2^32).  Returns the
    per-layer rows, the per-kernel totals, the calls (with their cuDNN
    call or None), which ``phase_profile`` times again on the device after
    every event timing is done (a profiler window slows what runs after
    it), and the cuDNN yardstick's ms per forward for rows 1 and 2."""
    from repro_torch.core.abft import wrap_int32
    rows, calls = [], []
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "t_bytes": 0.0, "t_ops": 0.0} for name in REPLACES}
    library = {"qconv2d_acc": 0.0, "qconv2d_acc_checksum": 0.0}
    for s, h in zip(specs, main_path_sides(specs)[0]):
        case = Case(gen, BATCH, h, h, s.cin, s.cout, s.kh, s.kw,
                    (s.stride, s.stride), "SAME")
        lib = cudnn_yardstick(case)
        lib_acc = wrap_int32(lib().permute(0, 2, 3, 1).to(torch.int64)
                             - case.zp.to(torch.int64) * case.colsum)
        lib_err = int((lib_acc.to(torch.int64) - _kernels()["qconv2d_acc"][0](
            *case.args("qconv2d_acc"), stride=case.stride)).abs().max())
        lib_ms = _time_ms(lib, reps=50)
        for name, (kern, plain) in _kernels().items():
            args, st = case.args(name), case.stride
            max_err[name] = max(max_err[name], _max_err(
                kern(*args, stride=st), plain(*args, stride=st)))
            ms = _time_ms(lambda: kern(*args, stride=st), reps=50)
            plain_ms = _time_ms(lambda: plain(*args, stride=st), reps=3,
                                warmup=1)
            bound, by = case.bound_ms(name)
            yard = name in library
            rows.append({"layer": s.name, "kernel": name, "ms": ms,
                         "device_ms": None, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by,
                         "library_ms": lib_ms if yard else None,
                         "library_device_ms": None,
                         "library_max_abs_err": lib_err if yard else None})
            calls.append((functools.partial(kern, *args, stride=st),
                          lib if yard else None))
            tot = totals[name]
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["t_" + ("bytes" if by == "bytes" else "ops")] += bound
            if yard:
                library[name] += lib_ms
    return rows, totals, calls, library


def phase_forward(specs, params, frames):
    from repro_torch.core.dependability import Policy
    from repro_torch.core.policy_map import PolicyMap
    from repro_torch.models import shipdet
    checks = shipdet.deploy_checks(params)
    golden = shipdet.golden_weights(params)
    variants = {
        "none_fused": {},
        "none_cuda": {"backend": "cuda"},
        "abft": {"policy": Policy.ABFT},
        "ckpt": {"policy": Policy.CKPT, "w_checks": checks,
                 "golden_wq": golden},
        "dmr": {"policy_map": PolicyMap.uniform(Policy.DMR)},
        "tmr": {"policy_map": PolicyMap.uniform(Policy.TMR)},
    }
    # the forward is host-bound and the host is shared: rounds interleave
    # the variants so that drift lands on all of them, and the median and
    # range of the rounds are reported
    rounds = {name: [] for name in variants}
    for _ in range(FORWARD_ROUNDS):
        for name, kw in variants.items():
            rounds[name].append(_time_ms(
                lambda: shipdet.forward(specs, params, frames, **kw),
                reps=10))
    out = {}
    for name, times in rounds.items():
        ms = statistics.median(times)
        out[name] = {"ms_per_batch": ms, "ms_rounds": times,
                     "frames_per_s": frames.shape[0] / (ms / 1e3)}
        print(f"forward {name:10s} {ms:9.3f} ms per batch of "
              f"{frames.shape[0]} (median of {len(times)} rounds, range "
              f"{min(times):.3f}-{max(times):.3f})  "
              f"{out[name]['frames_per_s']:9.1f} frames/s")
    return out


def _profile_window(fn, reps):
    """``fn`` run ``reps`` times under torch.profiler (CUPTI): per run, the
    host wall ms, the device busy ms (the union of kernel and copy
    intervals), the idle share of the window, the device ops, and the six
    device entries that take the most time.  None where the profiler sees
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, kname in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[kname] = by_name.get(kname, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_us / reps / 1e3, "busy_ms": busy / reps / 1e3,
            "idle_share": 1.0 - busy / wall_us, "ops": len(spans) / reps,
            "top": [(k[:90], v / reps / 1e3) for k, v in top]}


def phase_profile(specs, params, frames, rows, calls, reps=5):
    """Device busy time of the forward under torch.profiler (CUPTI): the
    union of kernel and copy intervals over the host wall time of the same
    window, and the kernels that take the most device time; then each
    kernel call's device time, filled into ``rows``."""
    from repro_torch.core.dependability import Policy
    from repro_torch.models import shipdet
    out = {}
    for name, kw in (("none_fused", {}), ("abft", {"policy": Policy.ABFT})):
        w = _profile_window(
            lambda: shipdet.forward(specs, params, frames, **kw), reps)
        if w is None:
            print(f"profile {name}: the profiler saw no device time "
                  f"(not measured)")
            out[name] = None
            continue
        out[name] = {"wall_ms_per_forward": w["wall_ms"],
                     "device_busy_ms_per_forward": w["busy_ms"],
                     "idle_share": w["idle_share"],
                     "device_launches_per_forward": w["ops"],
                     "top": [{"name": k, "ms_per_forward": v}
                             for k, v in w["top"]]}
        print(f"profile {name}: wall {w['wall_ms']:.3f} ms, device busy "
              f"{w['busy_ms']:.3f} ms, idle share {w['idle_share']:.3f}, "
              f"{w['ops']:.0f} device ops/forward")
        for k, v in w["top"]:
            print(f"    {v:8.4f} ms  {k}")

    for row, (call, lib) in zip(rows, calls):
        op = CONV_OPS[row["kernel"]]
        ms, ops, names = _device_ops_seen(call, reps=20, per_run=1)
        # every op the trace saw is the row's kernel, never more than one
        # per call (a memset or a second pass would show), and the trace saw
        # at least 90 % of the calls (a row none of whose windows saw a
        # record fails)
        if not (0.9 <= ops <= 1.0 and len(names) == 1
                and op in next(iter(names))):
            raise AssertionError(f"{row['kernel']} {row['layer']}: {ops} "
                                 f"device ops per call ({sorted(names)}), "
                                 f"want one {op}")
        row["device_ms"], row["device_kernel"] = ms, sorted(names)
        if lib is not None:
            row["library_device_ms"] = _device_ms(lib, reps=20, match=None)
    print(f"kernel times per layer, N = {BATCH} (CUDA events per call; "
          f"device time from the profiler; each call one device op, the "
          f"row's kernel; cuDNN f32 yardstick beside rows 1 and 2):")
    for r in rows:
        dev = "n/m" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        lib = "" if r["library_ms"] is None else (
            f"  cudnn {r['library_ms']:.4f} ms (device "
            + ("n/m" if r["library_device_ms"] is None
               else f"{r['library_device_ms']:.4f}")
            + f", max abs err {r['library_max_abs_err']})")
        print(f"  {r['layer']:16s} {r['kernel']:22s} {r['ms']:9.4f} ms  "
              f"device {dev:>7s} ms  plain {r['plain_ms']:9.3f} ms  "
              f"bound {r['bound_ms']:8.5f} ms ({r['bound_by']}){lib}")
    for name in REPLACES:
        dev = [r["device_ms"] for r in rows if r["kernel"] == name]
        if None not in dev:
            print(f"  {name}: {sum(dev):.4f} ms of device time per forward")
    return out


# ---------------------------------------------------------------------------
# slice 2: the int8 matmul kernels under the W8A8 serving path
# ---------------------------------------------------------------------------


class MatmulCase:
    """Random inputs of one matmul kernel call, made on the card."""

    def __init__(self, gen, m, k, n, x_zp=None, out_zp=None, x_fill=None,
                 w_fill=None, offset=False, ties=False):
        """``offset``: x_q, w_q and w_check are views one row (one value)
        into larger tensors, off every 16-byte boundary where K, N are
        odd.  ``ties``: x in [-4, 4), w in [-1, 1] and scale 0.5, so that
        the fused kernel's odd sums land on .5 and the larger ones clamp
        at both ends."""
        from repro_torch.core.abft import checksum_vector

        def ints(lo, hi, shape, dtype):
            return torch.randint(lo, hi, shape, generator=gen, device=DEVICE,
                                 dtype=dtype)

        o = int(offset)
        self.shape = (m, k, n)
        self.x_q = ints(*((-4, 4) if ties else (-128, 128)), (m + o, k),
                        torch.int8)[o:]
        self.w_q = ints(*((-1, 2) if ties else (-127, 128)), (k + o, n),
                        torch.int8)[o:]
        if x_fill is not None:
            self.x_q.fill_(x_fill)
        if w_fill is not None:
            self.w_q.fill_(w_fill)
        x_zp = int(ints(-10, 11, (), torch.int32)) if x_zp is None else x_zp
        out_zp = int(ints(-10, 11, (), torch.int32)) if out_zp is None \
            else out_zp
        self.colsum = self.w_q.to(torch.int32).sum(0).to(torch.int32)
        self.w_check = checksum_vector(self.w_q)
        if offset:
            self.w_check = torch.cat([self.w_check[:1], self.w_check])[1:]
        self.bias = ints(-1000, 1000, (n,), torch.int32)
        self.scale = torch.empty(n, device=DEVICE).uniform_(
            1e-4, 5e-3, generator=gen)
        if ties:
            self.scale.fill_(0.5)
        self.zps = torch.tensor([x_zp, out_zp], dtype=torch.int32,
                                device=DEVICE)

    def args(self, name):
        if name == "qmatmul_acc":
            return (self.x_q, self.w_q)
        if name == "qmatmul_acc_checksum":
            return (self.x_q, self.w_q, self.w_check)
        return (self.x_q, self.w_q, self.colsum, self.bias, self.scale,
                self.zps)

    def bound_ms(self, name):
        """Least time on an H100 SXM: each input read once, each output
        written once, int8 MACs at the tensor-core rate (the check vector's
        int32 MACs at the CUDA-core rate)."""
        m, k, n = self.shape
        nbytes = m * k + k * n
        int8_ops, int32_ops = 2 * m * n * k, 0
        if name == "qmatmul":
            nbytes += 12 * n + 8 + m * n
        else:
            nbytes += 4 * m * n
        if name == "qmatmul_acc_checksum":
            nbytes += 4 * k + 4 * m
            int32_ops = 2 * m * k
        t_ops = int8_ops / INT8_OPS_PER_S + int32_ops / INT32_OPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), \
            ("bytes" if t_bytes >= t_ops else "operations")


def _matmul_kernels():
    from repro_torch.kernels.qmatmul import kernel as MK
    from repro_torch.kernels.qmatmul import ref as MR
    return {"qmatmul_acc": (MK.qmatmul_acc, MR.qmatmul_acc_plain),
            "qmatmul_acc_checksum": (MK.qmatmul_acc_checksum,
                                     MR.qmatmul_acc_checksum_plain),
            "qmatmul": (MK.qmatmul, MR.qmatmul_plain)}


def ffn_shapes(cfg):
    """The W8A8 FFN's (M, K, N): decode at M = capacity and prefill at
    M = prefill_pad, for wg/wi (d → d_ff) and wd (d_ff → d)."""
    d, ff = cfg.d_model, cfg.d_ff
    return [(m, k, n) for m in (CAPACITY, PREFILL_PAD)
            for k, n in ((d, ff), (ff, d))]


def phase_compare_matmul(cfg, gen) -> dict:
    from repro_torch.core.abft import row_checksum
    cases = [(f"ffn_{m}x{k}x{n}", MatmulCase(gen, m, k, n))
             for m, k, n in ffn_shapes(cfg)]
    cases += [
        ("ragged", MatmulCase(gen, 5, 100, 37)),
        ("odd_k_n", MatmulCase(gen, 3, 99, 41)),
        ("zero_points", MatmulCase(gen, 9, 64, 48, x_zp=-77, out_zp=53)),
        ("check_wraps", MatmulCase(gen, 8, 1536, 1536, x_zp=127, out_zp=0,
                                   x_fill=-128, w_fill=127)),
    ]
    # the accumulator kernel's edges: row groups of 8 and tiles of 64
    # rows, K and N off multiples of 32, 16 and 4, rows off 16 bytes
    cases += [(f"edge_{m}x{k}x{n}", MatmulCase(gen, m, k, n))
              for m in EDGE_ROWS for k, n in EDGE_KN]
    cases += [(f"offset_{m}x{k}x{n}", MatmulCase(gen, m, k, n, offset=True))
              for m, k, n in ((7, 99, 41), (9, 600, 1000))]
    # the flash prefills' FFN rows: one-rank clusters and several staged
    # K chunks per rank
    cases += [(f"prefill_{m}x{k}x{n}", MatmulCase(gen, m, k, n))
              for m in FLASH_TIME_S if m > PREFILL_PAD
              for _, k, n in ffn_shapes(cfg)[:2]]
    rng = random.Random(1)
    cases += [(f"random_{i}", MatmulCase(
        gen, rng.randint(1, 80), rng.randint(1, 1600), rng.randint(1, 700),
        x_zp=rng.randint(-128, 127), out_zp=rng.randint(-128, 127)))
        for i in range(RANDOM_MATMUL_CASES)]
    # the fused kernel's rounding: .5 ties and clamps at both ends
    cases += [(f"ties_{m}x{k}x{n}", MatmulCase(gen, m, k, n, ties=True))
              for m, k, n in ((8, 576, 96), (33, 130, 70))]
    max_err = {name: 0 for name in MATMUL_REPLACES}
    for label, case in cases:
        for name, (kern, plain) in _matmul_kernels().items():
            got = kern(*case.args(name))
            torch.cuda.synchronize()
            want = plain(*case.args(name))
            max_err[name] = max(max_err[name], _max_err(got, want))
            if name == "qmatmul_acc_checksum" and not torch.equal(
                    row_checksum(got[0]), got[1]):
                raise AssertionError(f"{label}: want != row sum of acc")
            if name == "qmatmul" and not torch.equal(
                    got, kern(*case.args(name))):
                raise AssertionError(f"{label}: row 6 differs across two "
                                     f"launches")
            if name == "qmatmul" and label.startswith("ties"):
                acc = _matmul_kernels()["qmatmul_acc"][1](case.x_q, case.w_q)
                _ties_seen(label, got, acc.to(torch.int64)
                           - case.zps[0] * case.colsum + case.bias)
    print(f"compare: {len(cases)} cases x 3 matmul kernels torch.equal to "
          f"the plain versions on the card, row 6 equal across two "
          f"launches")
    return max_err


def lm_setup():
    """SmolLM-135M at full width, W8A8 FFN, bf16 compute, random weights
    from a seed, on the card; and the seeded requests."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    cfg = dataclasses.replace(registry.get(ARCH), quant="w8a8_ffn")
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=DEVICE)
    torch.cuda.synchronize()
    rng = random.Random(2)
    prompts = [[rng.randrange(cfg.vocab_size)
                for _ in range(rng.randint(3, 16))]
               for _ in range(N_REQUESTS)]
    print(f"lm: {ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}), W8A8 FFN, "
          f"{cfg.compute_dtype} compute, params in "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, params, prompts


def _serve(cfg, params, prompts, max_new, **kw):
    from repro_torch.runtime.serving import Engine, Request
    eng = Engine(cfg, params, capacity=CAPACITY, max_len=MAX_LEN,
                 prefill_pad=PREFILL_PAD, **kw)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def phase_serve(cfg, params, prompts):
    """The main path of slice 2, with every launch count reset before it
    and read after it."""
    from repro_torch.kernels.qmatmul import kernel as MK
    per_call = 3 * cfg.n_layers               # FFN matmuls per token batch
    MK.reset_launches()
    runs, t_all = {}, time.perf_counter()
    for name, kw in MAPS.items():
        before = {k.__name__: k.launches for k in MK.KERNELS}
        eng, reqs = _serve(cfg, params, prompts, MAX_NEW, **kw)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        delta = {k.__name__: k.launches - before[k.__name__]
                 for k in MK.KERNELS}
        # every prefill and every decode step runs each FFN matmul once
        batches = len(reqs) + eng.stats.steps
        want = {"qmatmul_acc": 0, "qmatmul_acc_checksum": 0, "qmatmul": 0}
        if name == "none":
            want["qmatmul_acc"] = per_call * batches
        elif name == "ffn_abft":
            want["qmatmul_acc_checksum"] = per_call * batches
        elif name == "ffn_tmr":
            want["qmatmul_acc"] = 3 * per_call * batches
        if delta != want:
            raise AssertionError(f"{name}: launches {delta}, derived {want} "
                                 f"= {per_call} x ({len(reqs)} prefills + "
                                 f"{eng.stats.steps} steps)")
        if any(len(r.output or ()) != MAX_NEW for r in reqs):
            raise AssertionError(f"{name}: a request did not complete")
        tokens = sum(len(r.output) for r in reqs)
        runs[name] = {"streams": [list(r.output) for r in reqs],
                      "steps": eng.stats.steps, "tokens": tokens,
                      "wall_s": secs, "tokens_per_s": tokens / secs,
                      "launches": delta}
        print(f"  serve {name:11s} {len(reqs)} requests, {tokens} tokens, "
              f"{eng.stats.steps} decode steps in {secs:.2f} s "
              f"({tokens / secs:.1f} tokens/s); launches {delta} = derived")
    launches = {k.__name__: k.launches for k in MK.KERNELS}
    print(f"serve: 4 runs in {time.perf_counter() - t_all:.2f} s, launches "
          f"{launches}")
    base = runs["none"]["streams"]
    for name, run in runs.items():
        if run["streams"] != base:
            raise AssertionError(f"{name}: token streams differ from none")
    print(f"  all four token streams bit-identical (e.g. request 0: "
          f"{base[0][:8]}...)")
    for name in ("qmatmul_acc", "qmatmul_acc_checksum"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never ran on the serving path")
    return {name: {k: v for k, v in run.items() if k != "streams"}
            for name, run in runs.items()}, launches


def phase_heal(cfg, params, gen):
    """``dependable_matmul_acc`` under ABFT at each FFN shape, with one
    accumulator bit flipped: detected, corrected, and the clean result."""
    from repro_torch.core.dependability import (
        DependabilityStats, Policy, dependable_matmul_acc)
    from repro_torch.core.fault_injection import flip_bit_at_index
    blocks = params["dense_blocks"]
    weights = {(cfg.d_model, cfg.d_ff): blocks["wg_q"][0],
               (cfg.d_ff, cfg.d_model): blocks["wd_q"][0]}
    for m, k, n in ffn_shapes(cfg):
        x = torch.randint(-127, 128, (m, k), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        w = weights[(k, n)]
        clean, _ = dependable_matmul_acc(Policy.NONE, x, w)
        acc, st = dependable_matmul_acc(
            Policy.ABFT, x, w,
            inject=lambda a: flip_bit_at_index(a, a.numel() // 3, 18))
        st = DependabilityStats.to_host(st)
        if st["faults_corrected"] < 1 or not torch.equal(acc, clean):
            raise AssertionError(f"ABFT missed the flip at {(m, k, n)}: {st}")
        print(f"  heal ({m}, {k}, {n}): {st}")


def phase_qlinear(cfg, gen):
    """``qlinear_act`` (the fused ``qmatmul``) at the FFN shapes, with the
    launch count reset before and read after; each output equals the
    op's CPU run on the same inputs and is within 2 % of the float
    matmul."""
    from repro_torch.kernels.qmatmul import kernel as MK
    from repro_torch.kernels.qmatmul import ops

    def qparams(t):
        lo, hi = min(float(t.min()), 0.0), max(float(t.max()), 0.0)
        scale = torch.tensor((hi - lo) / 255.0, device=t.device)
        zp = torch.tensor(int(round(-128 - lo / float(scale))),
                          dtype=torch.int32, device=t.device)
        return scale, zp

    cases = []
    for m, k, n in ffn_shapes(cfg):
        x = torch.randn((m, k), generator=gen, device=DEVICE)
        w = torch.randn((k, n), generator=gen, device=DEVICE) * 0.05
        b = torch.randn((n,), generator=gen, device=DEVICE) * 0.1
        y_f = x @ w + b
        cases.append((x, ops.make_qlinear_params(w, b), *qparams(x),
                      *qparams(y_f), y_f))
    MK.reset_launches()
    outs = [ops.qlinear_act(*c[:6]) for c in cases]
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in MK.KERNELS}
    # one fused matmul per qlinear_act call, and no other matmul kernel
    derived = {"qmatmul_acc": 0, "qmatmul_acc_checksum": 0,
               "qmatmul": len(cases)}
    launches = counts["qmatmul"]
    for (m, k, n), c, y in zip(ffn_shapes(cfg), cases, outs):
        cpu = ops.qlinear_act(*(t.cpu() if isinstance(t, torch.Tensor)
                                else type(t)(*(u.cpu() for u in t))
                                for t in c[:6]))
        if not torch.equal(y.cpu(), cpu):
            raise AssertionError(f"qlinear_act ({m}, {k}, {n}) on the card "
                                 f"differs from its CPU run")
        rel = float((y - c[6]).norm() / c[6].norm())
        if not rel < 0.02:
            raise AssertionError(f"qlinear_act ({m}, {k}, {n}) rel err {rel}")
    print(f"qlinear_act: {len(cases)} calls at the FFN shapes, launches "
          f"{counts} = derived, equal to the CPU runs")
    if counts != derived:
        raise AssertionError(f"launches {counts}, derived {derived}")
    return launches


def phase_time_matmul(cfg, gen, max_err):
    """CUDA-event times per call at the FFN shapes, beside the plain
    version, the bound and ``torch._int_mm`` (the library yardstick for the
    accumulator, on the decode rows zero-padded to M = 32; the port never
    calls it).  Returns the rows, each row's call and its library call (or
    None), which ``matmul_device_times`` times again on the device."""
    rows, calls, lib_calls = [], [], []
    for m, k, n in ffn_shapes(cfg):
        case = MatmulCase(gen, m, k, n)
        for name, (kern, plain) in _matmul_kernels().items():
            args = case.args(name)
            max_err[name] = max(max_err[name],
                                _max_err(kern(*args), plain(*args)))
            ms = _time_ms(lambda: kern(*args), reps=100)
            plain_ms = _time_ms(lambda: plain(*args), reps=10, warmup=1)
            lib_ms, lib_note, lib_call = None, None, None
            if name == "qmatmul_acc":
                # torch._int_mm refuses M <= 16: the decode rows are
                # zero-padded to M = 32 outside the timing, which changes
                # no output row
                x_lib = case.x_q
                if m < INT_MM_MIN_M:
                    x_lib = torch.zeros((INT_MM_MIN_M, k), dtype=torch.int8,
                                        device=DEVICE)
                    x_lib[:m] = case.x_q
                    lib_note = f"rows zero-padded to M = {INT_MM_MIN_M}"
                if not torch.equal(torch._int_mm(x_lib, case.w_q)[:m],
                                   kern(*args)):
                    raise AssertionError(f"_int_mm != qmatmul_acc at "
                                         f"{(m, k, n)}")
                lib_call = functools.partial(torch._int_mm, x_lib, case.w_q)
                lib_ms = _time_ms(lib_call, reps=100)
            bound, by = case.bound_ms(name)
            rows.append({"shape": (m, k, n), "kernel": name, "ms": ms,
                         "device_ms": None, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by,
                         "library_ms": lib_ms, "library_note": lib_note})
            calls.append(functools.partial(kern, *args))
            lib_calls.append(lib_call)
    return rows, calls, lib_calls


def _cold_decode_weights(cfg, gen):
    """COLD_LAYERS layers of distinct FFN weights (wg, wi: (d, d_ff); wd:
    (d_ff, d)) with their check vectors, and the decode rows of each FFN
    input, also zero-padded to M = 32 for ``torch._int_mm``: a decode
    step's 80 MB of FFN weights outgrow the 50 MB L2, so each call finds
    its W cold, unlike the per-shape timings that reuse one W."""
    from repro_torch.core.abft import checksum_vector
    d, ff = cfg.d_model, cfg.d_ff

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=DEVICE,
                             dtype=torch.int8)

    layers = []
    for _ in range(COLD_LAYERS):
        ws = (ints(-127, 128, (d, ff)), ints(-127, 128, (d, ff)),
              ints(-127, 128, (ff, d)))
        layers.append([(w, checksum_vector(w)) for w in ws])
    xs = {}
    for k in (d, ff):
        x = ints(-128, 128, (CAPACITY, k))
        x_pad = torch.zeros((INT_MM_MIN_M, k), dtype=torch.int8,
                            device=DEVICE)
        x_pad[:CAPACITY] = x
        xs[k] = (x, x_pad)
    return layers, xs


def phase_time_matmul_cold(cfg, gen):
    """CUDA-event ms per call of rows 4 and 5 and of ``torch._int_mm`` over
    a decode step's FFN calls in their order, each layer with its own
    weights.  Returns the per-call times and each step's function, which
    ``matmul_device_times`` times again on the device."""
    from repro_torch.kernels.qmatmul import kernel as MK
    layers, xs = _cold_decode_weights(cfg, gen)
    calls = len(layers) * 3

    def step(fn):
        def run():
            for layer in layers:
                for w, w_check in layer:
                    fn(xs[w.shape[0]], w, w_check)
        return run

    steps = {
        "qmatmul_acc": step(lambda x, w, c: MK.qmatmul_acc(x[0], w)),
        "qmatmul_acc_checksum": step(
            lambda x, w, c: MK.qmatmul_acc_checksum(x[0], w, c)),
        "_int_mm": step(lambda x, w, c: torch._int_mm(x[1], w)),
    }
    out = {name: _time_ms(run, reps=10) / calls
           for name, run in steps.items()}
    print(f"matmul cold W ({COLD_LAYERS} layers x 3 distinct weights, a "
          f"decode step's order), ms per call by CUDA events: "
          + ", ".join(f"{k} {v:.5f}" for k, v in out.items()))
    return out, steps, calls


def matmul_device_times(rows, calls, lib_calls, cold, cold_steps,
                        cold_calls):
    """Device time per call of each matmul row and of its library call, by
    the profiler; each call of rows 4, 5 and 6 must be exactly one device
    op, its kernel, and each cold call likewise.  Fills ``rows``; returns
    the cold device times per call."""
    for row, call, lib_call in zip(rows, calls, lib_calls):
        ms, ops, names = _device_ops_seen(call, reps=50, per_run=1)
        want = MATMUL_OPS[row["kernel"]]
        # every op the trace saw is the kernel, never more than one per
        # call (a memset or a second pass would show), and the trace saw
        # at least 90 % of the calls
        if not (0.9 <= ops <= 1.0 and len(names) == 1
                and want in next(iter(names))):
            raise AssertionError(f"{row['kernel']} {row['shape']}: {ops} "
                                 f"device ops per call ({sorted(names)}), "
                                 f"want one {want}")
        row["device_ms"], row["device_ops"] = ms, ops
        row["device_kernel"] = sorted(names)
        row["library_device_ms"] = None if lib_call is None else \
            _device_ops(lib_call, reps=20)[0]
    cold_dev = {}
    for name, run in cold_steps.items():
        ms, ops, names = _device_ops_seen(run, reps=2, per_run=cold_calls)
        if name != "_int_mm" and not (0.9 * cold_calls <= ops <= cold_calls
                                      and len(names) == 1):
            raise AssertionError(f"cold {name}: {ops} device ops per step "
                                 f"of {cold_calls} calls ({sorted(names)})")
        cold_dev[name] = None if ms is None else ms / cold_calls
    print("matmul kernel times per call (CUDA events; device time from the "
          "profiler, by kernel name; each call one device op, the row's "
          "kernel):")
    for r in rows:
        dev = "n/m" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        lib = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms (device "
            + ("n/m" if r["library_device_ms"] is None
               else f"{r['library_device_ms']:.4f}") + " ms)"
            + (f" ({r['library_note']})" if r["library_note"] else ""))
        print(f"  {str(r['shape']):18s} {r['kernel']:22s} {r['ms']:8.4f} ms"
              f"  device {dev:>7s} ms {r['device_kernel']}  plain "
              f"{r['plain_ms']:8.3f} ms  bound {r['bound_ms']:8.5f} ms "
              f"({r['bound_by']})  _int_mm {lib}")
    print("matmul cold W, ms per call: " + ", ".join(
        f"{k} events {cold[k]:.5f} device "
        + ("n/m" if cold_dev[k] is None else f"{cold_dev[k]:.5f}")
        for k in cold))
    return cold_dev


def matmul_totals(cfg, rows):
    """Per kernel, the FFN matmuls of one decode step at capacity 8:
    n_layers x (2 x (8, d, d_ff) + (8, d_ff, d)); and the same sum of the
    library times where there is one (``torch._int_mm`` on the padded
    rows)."""
    mult = {(CAPACITY, cfg.d_model, cfg.d_ff): 2 * cfg.n_layers,
            (CAPACITY, cfg.d_ff, cfg.d_model): cfg.n_layers}
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "t_bytes": 0.0, "t_ops": 0.0} for name in MATMUL_REPLACES}
    library = {}
    for r in rows:
        c = mult.get(tuple(r["shape"]), 0)
        tot = totals[r["kernel"]]
        for key in ("ms", "plain_ms", "bound_ms"):
            tot[key] += c * r[key]
        tot["t_" + ("bytes" if r["bound_by"] == "bytes" else "ops")] += \
            c * r["bound_ms"]
        if c and r["library_ms"] is not None:
            library[r["kernel"]] = library.get(r["kernel"], 0.0) \
                + c * r["library_ms"]
    return totals, library


def _decoding(cfg, params, prompts, kw):
    """An engine with CAPACITY requests all decoding (long budgets), after
    the step that prefills and joins them."""
    eng, _ = _serve(cfg, params, prompts[:CAPACITY], MAX_LEN // 2, **kw)
    eng.step()
    if len(eng.active) != CAPACITY:
        raise AssertionError("the decode batch did not fill")
    return eng


def phase_serve_time(cfg, params, prompts, serve_runs):
    """Per map: ms per decode step at capacity 8 (host clock; each step
    ends in the host readback of its tokens), decode tokens/s, and ms per
    prefill of one 64-token prompt; rounds interleave the maps."""
    engines = {name: _decoding(cfg, params, prompts, kw)
               for name, kw in MAPS.items()}
    step_ms = {name: [] for name in MAPS}
    for _ in range(DECODE_ROUNDS):
        for name, eng in engines.items():
            eng.step()
            t0 = time.perf_counter()
            for _ in range(20):
                eng.step()
            step_ms[name].append((time.perf_counter() - t0) * 1e3 / 20)
    toks = torch.tensor([prompts[0] + [0] * (PREFILL_PAD - len(prompts[0]))],
                        dtype=torch.int32, device=DEVICE)
    out = {}
    for name, eng in engines.items():
        prefill = eng.executor._prefill
        prefill(eng.params, toks)
        torch.cuda.synchronize()
        t_pre = []
        for _ in range(5):
            t0 = time.perf_counter()
            prefill(eng.params, toks)
            torch.cuda.synchronize()
            t_pre.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(step_ms[name])
        out[name] = {"ms_per_decode_step": ms, "ms_rounds": step_ms[name],
                     "decode_tokens_per_s": CAPACITY / (ms / 1e3),
                     "ms_per_prefill": statistics.median(t_pre),
                     "serve_tokens_per_s": serve_runs[name]["tokens_per_s"]}
        o = out[name]
        print(f"decode {name:11s} {ms:8.3f} ms/step (rounds "
              f"{', '.join(f'{t:.3f}' for t in step_ms[name])})  "
              f"{o['decode_tokens_per_s']:8.1f} tokens/s  prefill "
              f"{o['ms_per_prefill']:8.3f} ms  serve "
              f"{o['serve_tokens_per_s']:.1f} tokens/s")
    return out, engines


def phase_serve_profile(engines, reps=5):
    """Decode steps of the none and ffn_abft engines under the profiler."""
    out = {}
    for name in ("none", "ffn_abft"):
        w = _profile_window(engines[name].step, reps)
        out[name] = w
        if w is None:
            print(f"profile decode {name}: the profiler saw no device time "
                  f"(not measured)")
            continue
        print(f"profile decode {name}: wall {w['wall_ms']:.3f} ms/step, "
              f"device busy {w['busy_ms']:.3f} ms, idle share "
              f"{w['idle_share']:.3f}, {w['ops']:.0f} device ops/step")
        for k, v in w["top"]:
            print(f"    {v:8.4f} ms  {k}")
    return out


# ---------------------------------------------------------------------------
# slice 3: the flash-attention kernels under attn_impl="flash" serving and
# dependable_attention
# ---------------------------------------------------------------------------


class FlashCase:
    """Seeded normal q (B, H, S, hd) and k, v (B, KV, S, hd), on the card."""

    def __init__(self, gen, b, h, kv, s, hd, dtype, causal=True, window=None):
        def normal(shape):
            return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

        self.shape = (b, h, kv, s, hd)
        self.dtype = dtype
        self.kw = {"causal": causal, "window": window}
        self.q = normal((b, h, s, hd))
        self.k = normal((b, kv, s, hd))
        self.v = normal((b, kv, s, hd))

    def args(self):
        return self.q, self.k, self.v

    def bound_ms(self, name):
        """Least time on an H100 SXM: q, k, v read once and the outputs
        written once over 3.35 TB/s, against 4·B·H·hd·S(S+1)/2 causal FLOPs
        (S² without causality) at 989 TFLOP/s for bf16, 67 for f32."""
        b, h, kv, s, hd = self.shape
        esz = torch.finfo(self.dtype).bits // 8
        nbytes = esz * hd * s * b * (2 * h + 2 * kv)
        nbytes += {"flash_attention": 0, "flash_attention_fwd_lse": 4,
                   "flash_attention_checked": 12}[name] * b * h * s
        pairs = s * (s + 1) / 2 if self.kw["causal"] else s * s
        rate = BF16_FLOPS_PER_S if self.dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        t_ops = 4 * b * h * hd * pairs / rate
        t_bytes = nbytes / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), \
            ("bytes" if t_bytes >= t_ops else "operations")

    def bwd_bound_ms(self):
        """Least time of the backward on an H100 SXM: q, k, v, out, dO and
        lse read once, dq, dk, dv written once, over 3.35 TB/s, against
        10·B·H·hd·S(S+1)/2 causal FLOPs (five products per visible score:
        S, dP, dV, dK, dQ) at 989 TFLOP/s for bf16, 67 for f32."""
        b, h, kv, s, hd = self.shape
        esz = torch.finfo(self.dtype).bits // 8
        nbytes = esz * hd * s * b * (3 * h + 2 * kv) + 4 * b * h * s \
            + esz * hd * s * b * (h + 2 * kv)
        pairs = s * (s + 1) / 2 if self.kw["causal"] else s * s
        rate = BF16_FLOPS_PER_S if self.dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        t_ops = 10 * b * h * hd * pairs / rate
        t_bytes = nbytes / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), \
            ("bytes" if t_bytes >= t_ops else "operations")


def _flash_kernels():
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    plain = {"flash_attention": "out", "flash_attention_checked": "checked",
             "flash_attention_fwd_lse": "lse"}
    return {name: (getattr(FK, name),
                   functools.partial(FR.flash_plain, emit=emit))
            for name, emit in plain.items()}


def _bf16_step(x):
    """One bf16 step (ulp) at the magnitude of each element of ``x``."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _flash_err(got, want, dtype):
    """(max abs error, max error / limit) of a kernel output against its
    plain version; raises beyond the tolerance.  f32: 1e-5·(1 + |w|), where
    both sum the same f32 products in other orders.  bf16: one bf16 step of
    |w| on top of that.  Both sides compute the same f32 values in other
    orders, which the f32 term covers, and then round once to bf16, which
    can flip the last bit: one step.  One step alone fails any reordering,
    even of exact f32 products, on outputs that cancel to near zero
    (``tests/test_torch_flash_fwd_split.py``)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = 1e-5 * (1 + w.abs())
    if dtype == torch.bfloat16:
        lim = lim + _bf16_step(w)
    if not bool((err <= lim).all()):
        raise AssertionError(f"flash kernel disagrees with its plain version "
                             f"(max abs err {float(err.max())}, "
                             f"{float((err / lim).max())} x the limit)")
    return float(err.max()), float((err / lim).max())


def flash_compare_cases(gen):
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        cases += [(f"prefill_S{s}_{tag}",
                   FlashCase(gen, 1, 9, 3, s, 64, dt))
                  for s in (64, 192, 1024)]
        cases += [(f"hd{hd}_S200_{tag}", FlashCase(gen, 1, 4, 4, 200, hd, dt))
                  for hd in (16, 32, 128)]
        cases += [
            (f"G4_B2_{tag}", FlashCase(gen, 2, 8, 2, 200, 64, dt)),
            (f"window_{tag}", FlashCase(gen, 1, 9, 3, 300, 64, dt,
                                        window=100)),
            (f"noncausal_{tag}", FlashCase(gen, 1, 4, 2, 200, 32, dt,
                                           causal=False)),
            (f"noncausal_window_{tag}", FlashCase(gen, 1, 2, 1, 37, 16, dt,
                                                  causal=False, window=9)),
        ]
    rng = random.Random(3)
    for i in range(RANDOM_FLASH_CASES):
        kv = rng.choice((1, 2, 3, 4))
        cases.append((f"random_{i}", FlashCase(
            gen, rng.randint(1, 3), kv * rng.choice((1, 2, 3, 4)), kv,
            rng.randint(1, 700), rng.choice((16, 32, 64, 128)),
            rng.choice((torch.float32, torch.bfloat16)),
            causal=rng.random() < 0.8,
            window=rng.choice((None, None, rng.randint(0, 300))))))
    return cases


def phase_compare_flash(gen) -> dict:
    """Each attention kernel against its plain version on the card; the
    three kernels' out torch.equal to each other and across two launches;
    csum equal to the recomputed bit checksum; the check column within
    1e-4 (rel and abs) of rowsum_hd of the f32 output (for bf16, of the
    f32 kernel on the same values upcast: the check column is kept in f32
    and never sees out's bf16 rounding)."""
    from repro_torch.core.abft import output_row_checksums
    from repro_torch.kernels.flashattn import kernel as FK
    kernels = _flash_kernels()
    max_err = {name: 0.0 for name in FLASH_REPLACES}
    ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = flash_compare_cases(gen)
    for label, case in cases:
        got = {name: kern(*case.args(), **case.kw)
               for name, (kern, _) in kernels.items()}
        again = FK.flash_attention(*case.args(), **case.kw)
        torch.cuda.synchronize()
        out = got["flash_attention"]
        for name, (_, plain) in kernels.items():
            want = plain(*case.args(), **case.kw)
            g, w = ((got[name], want) if name == "flash_attention"
                    else (got[name][0], want[0]))
            err, r = _flash_err(g, w, case.dtype)
            max_err[name] = max(max_err[name], err)
            ratio[case.dtype] = max(ratio[case.dtype], r)
            if name == "flash_attention_fwd_lse":
                _flash_err(got[name][1], want[1], torch.float32)
            if name == "flash_attention_checked":
                _flash_err(got[name][1], want[1], torch.float32)
        _, check, csum = got["flash_attention_checked"]
        lse_out = got["flash_attention_fwd_lse"][0]
        if not (torch.equal(out, got["flash_attention_checked"][0])
                and torch.equal(out, lse_out)):
            raise AssertionError(f"{label}: the three kernels' out differ")
        if not torch.equal(out, again):
            raise AssertionError(f"{label}: two launches differ")
        if not torch.equal(csum, output_row_checksums(out)):
            raise AssertionError(f"{label}: csum != bit checksum of out")
        ref_out = out if case.dtype == torch.float32 else FK.flash_attention(
            *(t.float() for t in case.args()), **case.kw)
        rows = ref_out.float().sum(dim=-1)
        if not bool(((check - rows).abs() <= 1e-4 * (1 + rows.abs())).all()):
            raise AssertionError(f"{label}: check column off rowsum_hd(out) "
                                 f"by {float((check - rows).abs().max())}")
    # the bf16 kernels copy 16-byte chunks: an input 2 bytes off raises
    q = torch.zeros(1 + 2 * 64 * 16, dtype=torch.bfloat16,
                    device=DEVICE)[1:].view(1, 2, 64, 16)
    for name, (kern, _) in kernels.items():
        try:
            kern(q, q, q)
        except ValueError:
            continue
        raise AssertionError(f"{name} took a bf16 input that is not "
                             f"16-byte aligned")
    print(f"compare: {len(cases)} attention cases x 3 kernels within "
          f"tolerance of the plain versions (f32 1e-5, bf16 one step + "
          f"1e-5); out equal across the three kernels and two launches; csum "
          f"exact; max abs err {max_err}; worst error / limit of out f32 "
          f"{ratio[torch.float32]:.4f}, bf16 {ratio[torch.bfloat16]:.4f}")
    return max_err


def flash_setup(cfg, params):
    """The flash config of the served LM, and 8 seeded prompts of 64-1000
    tokens."""
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    rng = random.Random(4)
    prompts = [[rng.randrange(cfg.vocab_size)
                for _ in range(rng.randint(64, 1000))]
               for _ in range(FLASH_REQUESTS)]
    return fcfg, prompts


def _serve_flash(cfg, params, prompts, **kw):
    from repro_torch.runtime.serving import Engine, Request
    eng = Engine(cfg, params, capacity=CAPACITY, max_len=FLASH_MAX_LEN,
                 prefill_pad=PREFILL_PAD, **kw)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=FLASH_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def phase_serve_flash(fcfg, params, prompts):
    """The flash serving path, with every attention launch count reset
    before it and read after it: the Engine under no map, ffn.*=abft and
    ffn.*=tmr; every request completes, the streams are bit-identical, and
    flash_attention_fwd_lse ran n_layers times per prefill."""
    from repro_torch.kernels.flashattn import kernel as FK
    FK.reset_launches()
    runs = {}
    for name in ("none", "ffn_abft", "ffn_tmr"):
        before = FK.flash_attention_fwd_lse.launches
        eng, reqs, secs = _serve_flash(fcfg, params, prompts, **MAPS[name])
        delta = FK.flash_attention_fwd_lse.launches - before
        if any(len(r.output or ()) != FLASH_MAX_NEW for r in reqs):
            raise AssertionError(f"flash {name}: a request did not complete")
        if delta != fcfg.n_layers * len(reqs):
            raise AssertionError(f"flash {name}: fwd_lse launches {delta}, "
                                 f"derived {fcfg.n_layers} x {len(reqs)} "
                                 f"prefills")
        tokens = sum(len(r.output) for r in reqs)
        runs[name] = {"streams": [list(r.output) for r in reqs],
                      "steps": eng.stats.steps, "tokens": tokens,
                      "wall_s": secs, "tokens_per_s": tokens / secs,
                      "fwd_lse_launches": delta}
        print(f"  serve flash {name:9s} {len(reqs)} requests "
              f"({sum(len(p) for p in prompts)} prompt tokens), {tokens} "
              f"tokens, {eng.stats.steps} decode steps in {secs:.2f} s; "
              f"fwd_lse launches {delta} = {fcfg.n_layers} x {len(reqs)}")
    launches = {k.__name__: k.launches for k in FK.KERNELS}
    print(f"serve flash: launches {launches}")
    base = runs["none"]["streams"]
    for name, run in runs.items():
        if run["streams"] != base:
            raise AssertionError(f"flash {name}: streams differ from none")
    if launches["flash_attention_fwd_lse"] == 0:
        raise AssertionError("flash_attention_fwd_lse never ran")
    return runs, launches


def phase_flash_vs_chunked(cfg, fcfg, params, prompts, runs):
    """The chunked engine on the same requests (the share of equal greedy
    tokens is printed, not asserted: the two round in other places), and
    request 0's prefill logits, flash against chunked, both bf16.

    The tolerance is the bf16 noise of the path itself, measured in the
    same run: the relative L2 distance between the chunked prefill's
    logits in bf16 and in f32 compute.  Flash and chunked differ where they
    round (chunked rounds the probabilities to bf16 before PV, flash keeps
    them f32), and each rounding can move a W8A8 activation one int8 step;
    they must not differ by more than twice what bf16 rounding does to one
    of them.  A wrong mask, scale or head mapping gives distances of order
    1."""
    from repro_torch.models import api
    _, reqs, _ = _serve_flash(cfg, params, prompts)
    chunked = [list(r.output) for r in reqs]
    flash = runs["none"]["streams"]
    same = sum(a == b for fs, cs in zip(flash, chunked)
               for a, b in zip(fs, cs))
    total = sum(len(fs) for fs in flash)
    p0 = prompts[0]
    pad = -(-len(p0) // PREFILL_PAD) * PREFILL_PAD
    toks = torch.tensor([p0 + [0] * (pad - len(p0))], dtype=torch.int32,
                        device=DEVICE)

    def logits(c):
        return api.prefill(c, params, toks, FLASH_MAX_LEN)[0][
            0, :len(p0)].float()
    lf, lc = logits(fcfg), logits(cfg)
    l32 = logits(dataclasses.replace(cfg, compute_dtype="float32"))
    if not bool(torch.isfinite(lf).all()):
        raise AssertionError("flash prefill logits are not finite")
    rel = float((lf - lc).norm() / lc.norm())
    floor = float((lc - l32).norm() / l32.norm())
    max_abs = float((lf - lc).abs().max())
    top1 = float((lf.argmax(-1) == lc.argmax(-1)).float().mean())
    print(f"flash vs chunked: greedy tokens equal {same}/{total} "
          f"({same / total:.3f}); request 0 ({len(p0)} tokens) prefill "
          f"logits rel L2 {rel:.5f} (bf16 noise floor, chunked bf16 vs f32: "
          f"{floor:.5f}), max abs {max_abs:.5f} (logits max abs "
          f"{float(lc.abs().max()):.3f}), top-1 agree {top1:.4f}")
    if not rel <= 2 * floor:
        raise AssertionError(f"flash prefill logits off chunked: rel {rel}, "
                             f"bf16 noise floor {floor}")
    return {"greedy_equal_share": same / total, "logits_rel_l2": rel,
            "bf16_noise_floor_rel_l2": floor, "logits_max_abs": max_abs,
            "top1_agree": top1}


def attention_inputs(fcfg, params, s=1024):
    """q, k, v of layer 0 of an s-token prefill, (1, H, s, hd) and
    (1, KV, s, hd), as the flash path hands them to the kernel."""
    from repro_torch.models import transformer as T
    toks = torch.randint(0, fcfg.vocab_size, (1, s),
                         generator=torch.Generator().manual_seed(5)).to(
                             DEVICE)
    x = T._embed(fcfg, params, toks)
    bp = T._layers(params["dense_blocks"])[0]
    pos = torch.arange(s, device=DEVICE)[None, :]
    q, k, v = T._qkv(fcfg, bp, x, pos)
    return [t.transpose(1, 2).contiguous() for t in (q, k, v)]


def phase_dependable_attention(fcfg, params):
    """dependable_attention at full width, bf16, with the attention launch
    counts reset before and read after: every policy equal to NONE on
    clean input with no alarm; ABFT heals a flip of out's bit 0, 7 and 15,
    CKPT recovers, DMR detects and ships replica 0, TMR outvotes; the
    launches equal those derived from the calls; NONE within one bf16
    step plus 1e-4 of the ref backend (an independent two-pass oracle)."""
    from repro_torch.core.dependability import (
        DependabilityStats, Policy, dependable_attention)
    from repro_torch.core.fault_injection import flip_bit_at_index
    from repro_torch.kernels.flashattn import kernel as FK
    q, k, v = attention_inputs(fcfg, params)
    per_call = {Policy.NONE: (1, 0), Policy.ABFT: (1, 1),
                Policy.CKPT: (1, 1), Policy.DMR: (2, 0), Policy.TMR: (3, 0)}
    want = [0, 0]

    def run(policy, bit=None):
        inj = None if bit is None else (
            lambda o: flip_bit_at_index(o, o.numel() // 3 + 5, bit))
        out, st = dependable_attention(policy, q, k, v, inject=inj)
        torch.cuda.synchronize()
        want[0] += per_call[policy][0]
        want[1] += per_call[policy][1]
        return out, DependabilityStats.to_host(st)

    FK.reset_launches()
    clean, _ = run(Policy.NONE)
    for policy in (Policy.ABFT, Policy.CKPT, Policy.DMR, Policy.TMR):
        out, st = run(policy)
        if not torch.equal(out, clean) or st["faults_detected"] != 0:
            raise AssertionError(f"{policy.value} on clean input: {st}")
    for bit in (0, 7, 15):
        out, st = run(Policy.ABFT, bit)
        if st["faults_corrected"] < 1 or not torch.equal(out, clean):
            raise AssertionError(f"ABFT missed the flip of bit {bit}: {st}")
        print(f"  attention abft bit {bit:2d}: {st}")
    out, st = run(Policy.CKPT, 0)
    if st["faults_recovered"] < 1 or not torch.equal(out, clean):
        raise AssertionError(f"CKPT did not recover: {st}")
    print(f"  attention ckpt bit  0: {st}")
    out, st = run(Policy.DMR, 0)
    if st["faults_detected"] != 1 or torch.equal(out, clean):
        raise AssertionError(f"DMR missed the flip or healed it: {st}")
    print(f"  attention dmr  bit  0: {st}")
    out, st = run(Policy.TMR, 15)
    if st["faults_corrected"] != 1 or not torch.equal(out, clean):
        raise AssertionError(f"TMR did not outvote: {st}")
    print(f"  attention tmr  bit 15: {st}")
    launches = {kk.__name__: kk.launches for kk in FK.KERNELS}
    derived = {"flash_attention": want[0], "flash_attention_checked": want[1],
               "flash_attention_fwd_lse": 0, "flash_attention_bwd": 0}
    if launches != derived or min(want) == 0:
        raise AssertionError(f"attention launches {launches}, derived "
                             f"{derived}")
    # the ref backend's two-pass softmax sums its 1024 f32 terms in
    # another order: outputs that cancel to near zero can differ by more
    # than one bf16 step of their own size, so 1e-4 absolute is allowed
    # on top of the step
    oracle, _ = dependable_attention(Policy.NONE, q, k, v, backend="ref")
    err = (clean.float() - oracle.float()).abs()
    over = float((err - _bf16_step(oracle)).max())
    if not over <= 1e-4:
        raise AssertionError(f"dependable_attention off the ref backend: "
                             f"max abs err {float(err.max())}, beyond one "
                             f"bf16 step by {over}")
    print(f"dependable_attention {tuple(q.shape)}/{tuple(k.shape)} "
          f"{q.dtype}: all policies equal on clean input, faults healed; "
          f"launches {launches} = derived; against the ref backend max abs "
          f"err {float(err.max()):.3e}, beyond one bf16 step by at most "
          f"{max(over, 0.0):.3e}")
    return launches


def phase_time_flash(gen, max_err):
    """CUDA-event ms per call of each kernel at the serving shape (1, 9, S,
    64)/(1, 3, S, 64) bf16, S in 64, 256, 1024, and at the training shape
    (8, 9, 1024, 64)/(8, 3, 1024, 64), beside its plain version, its bound
    and, for the kernels that have one, scaled_dot_product_attention (the
    library yardstick; the port never calls it)."""
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                             is_causal=True, enable_gqa=True)
    rows, calls = [], []
    for b, s in [(1, s) for s in FLASH_TIME_S] + [(TRAIN_BATCH, TRAIN_SEQ)]:
        case = FlashCase(gen, b, 9, 3, s, 64, torch.bfloat16)
        for name, (kern, plain) in _flash_kernels().items():
            args = case.args()
            got, want = kern(*args), plain(*args)
            g, w = (got, want) if name == "flash_attention" \
                else (got[0], want[0])
            max_err[name] = max(max_err[name],
                                _flash_err(g, w, torch.bfloat16)[0])
            ms = _time_ms(lambda: kern(*args), reps=50)
            plain_ms = _time_ms(lambda: plain(*args), reps=10, warmup=1)
            lib_ms = None
            if name != "flash_attention_checked":
                lib_ms = _time_ms(lambda: sdpa(*args), reps=50)
            bound, by = case.bound_ms(name)
            rows.append({"B": b, "S": s, "kernel": name, "ms": ms,
                         "device_ms": None, "plain_ms": plain_ms,
                         "bound_ms": bound,
                         "bound_by": by, "library_ms": lib_ms,
                         "library_device_ms": None})
            calls.append((functools.partial(kern, *args),
                          None if lib_ms is None
                          else functools.partial(sdpa, *args)))
    return rows, calls


def phase_prefill_flash(cfg, fcfg, params):
    """Host-clock ms per prefill (one padded prompt, ends in a sync) for
    flash and chunked, median of 5, at S in 64, 256, 1024, under no map."""
    from repro_torch.models import api
    out = {}
    for s in FLASH_TIME_S:
        toks = torch.randint(0, cfg.vocab_size, (1, s), device=DEVICE,
                             generator=torch.Generator(device=DEVICE
                                                       ).manual_seed(s))
        row = {}
        for name, c in (("flash", fcfg), ("chunked", cfg)):
            api.prefill(c, params, toks, FLASH_MAX_LEN)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                api.prefill(c, params, toks, FLASH_MAX_LEN)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            row[name] = statistics.median(times)
        out[s] = row
        print(f"prefill S {s:5d}: flash {row['flash']:9.3f} ms, chunked "
              f"{row['chunked']:9.3f} ms (median of 5)")
    return out


def phase_profile_flash(fcfg, params, rows, calls):
    """The device busy time and idle share of one flash prefill at S = 64
    and 1024 under torch.profiler; then each kernel call's and SDPA's
    device time, filled into ``rows``."""
    from repro_torch.models import api
    out = {}
    for s in (64, 1024):
        toks = torch.zeros((1, s), dtype=torch.int32, device=DEVICE)
        w = _profile_window(
            lambda: api.prefill(fcfg, params, toks, FLASH_MAX_LEN), reps=3)
        out[s] = w
        if w is None:
            print(f"profile flash prefill S {s}: the profiler saw no device "
                  f"time (not measured)")
            continue
        print(f"profile flash prefill S {s}: wall {w['wall_ms']:.3f} ms, "
              f"device busy {w['busy_ms']:.3f} ms, idle share "
              f"{w['idle_share']:.3f}, {w['ops']:.0f} device ops/prefill")
        for kname, v in w["top"]:
            print(f"    {v:8.4f} ms  {kname}")
    for row, (call, lib) in zip(rows, calls):
        row["device_ms"] = _device_ms(call, reps=20, match="flash_fwd")
        if lib is not None:
            row["library_device_ms"] = _device_ms(lib, reps=20, match=None)
    print("attention kernel times per call at (B, 9, S, 64)/(B, 3, S, 64) "
          "bf16 (CUDA events; device time from the profiler):")
    for r in rows:
        dev = "n/m" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        lib = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms'] or float('nan'):.4f})")
        print(f"  B {r['B']} S {r['S']:5d} {r['kernel']:24s} {r['ms']:8.4f} "
              f"ms  device {dev:>7s} ms  plain {r['plain_ms']:8.3f} ms  bound "
              f"{r['bound_ms']:8.5f} ms ({r['bound_by']})  sdpa {lib}")
    return out


def flash_totals(rows):
    """Per kernel, one call at (1, 9, 1024, 64) (the longest prefill bucket
    of the main path and dependable_attention's shape)."""
    return {r["kernel"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound_ms"],
                          "t_bytes": r["bound_ms"] * (r["bound_by"] == "bytes"),
                          "t_ops": r["bound_ms"] * (r["bound_by"] != "bytes")}
            for r in rows if (r["B"], r["S"]) == (1, max(FLASH_TIME_S))}, \
        {r["kernel"]: r["library_ms"] for r in rows
         if (r["B"], r["S"]) == (1, max(FLASH_TIME_S))}


# ---------------------------------------------------------------------------
# slice 4: fault-tolerant training of SmolLM-135M on the backward kernels
# ---------------------------------------------------------------------------


def _bwd_inputs(case, gen):
    """q, k, v, out, lse and a seeded dO: the backward's inputs as the
    training path hands them over (out and lse from the forward kernel)."""
    from repro_torch.kernels.flashattn import kernel as FK
    out, lse = FK.flash_attention_fwd_lse(*case.args(), **case.kw)
    do = torch.randn(out.shape, generator=gen, device=DEVICE).to(case.dtype)
    return (*case.args(), out, lse, do)


def _bwd_check(got, want, dtype):
    """(max abs error, max error / limit) of a gradient against the plain
    version's; raises beyond the tolerance: 5e-5·(1 + |w|) for f32, where
    both sum the same f32 products (up to G·S of them per element) in other
    orders, and for bf16 one bf16 step of |w| on top of that, where both
    round an f32 result that may differ in its last bits."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = 5e-5 * (1 + w.abs())
    if dtype == torch.bfloat16:
        lim = lim + _bf16_step(w)
    if not bool((err <= lim).all()):
        raise AssertionError(f"flash backward disagrees with its plain "
                             f"version (max abs err {float(err.max())})")
    return float(err.max()), float((err / lim).max())


def phase_compare_flash_bwd(gen) -> dict:
    """Row 10 against its plain version on the card, f32 and bf16, at the
    attention compare cases and the training shape (8, 9, 1024, 64)/(8, 3,
    1024, 64); two launches torch.equal; the worst error / limit ratio per
    dtype printed."""
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    cases = [(f"train_{tag}", FlashCase(gen, TRAIN_BATCH, 9, 3, TRAIN_SEQ,
                                        64, dt))
             for tag, dt in (("f32", torch.float32),
                             ("bf16", torch.bfloat16))]
    cases += flash_compare_cases(gen)
    max_err, ratio = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, case in cases:
        inputs = _bwd_inputs(case, gen)
        got = FK.flash_attention_bwd(*inputs, **case.kw)
        again = FK.flash_attention_bwd(*inputs, **case.kw)
        torch.cuda.synchronize()
        want = FR.flash_bwd_plain(*inputs, **case.kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{label}: {name} {g.dtype} "
                                     f"{tuple(g.shape)}")
            err, r = _bwd_check(g, w, case.dtype)
            max_err = max(max_err, err)
            ratio[case.dtype] = max(ratio[case.dtype], r)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two backward launches differ")
    print(f"compare: {len(cases)} backward cases (training shape, prefill "
          f"shapes, hd 16-128, GQA, window, non-causal, random) within "
          f"tolerance of the plain version (f32 5e-5, bf16 one step + 5e-5); "
          f"two launches torch.equal; max abs err {max_err:.3e}; worst "
          f"error / limit f32 {ratio[torch.float32]:.4f}, bf16 "
          f"{ratio[torch.bfloat16]:.4f}")
    return {"flash_attention_bwd": max_err}


def train_setup():
    """SmolLM-135M at full width and depth for training: f32 params, bf16
    compute, AdamW, remat save_dots, quant none, attn_impl flash; global
    batch 8 × 1024."""
    from repro_torch.configs import registry
    from repro_torch.models.config import ShapeConfig
    tcfg = dataclasses.replace(registry.get(ARCH), attn_impl="flash")
    if (tcfg.quant, tcfg.remat, tcfg.optimizer, tcfg.param_dtype,
            tcfg.compute_dtype) != ("none", "save_dots", "adamw", "float32",
                                    "bfloat16"):
        raise AssertionError(f"unexpected training config {tcfg}")
    return tcfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")


def _ft_run(tcfg, shape, ckpt_dir, n_steps, every=TRAIN_CKPT_EVERY,
            hook=None):
    from repro_torch.runtime import ft_loop
    ft = ft_loop.FTConfig(ckpt_dir=ckpt_dir, ckpt_every=every)
    t0 = time.perf_counter()
    rep = ft_loop.run(tcfg, shape, ft, n_steps=n_steps, fault_hook=hook,
                      device=DEVICE)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def _executed(rep) -> int:
    """Train-step calls of a run: the kept steps, the replayed ones and
    the faulted ones (each runs forward and backward before the loss is
    judged)."""
    return len(rep.losses) + rep.steps_replayed + rep.recoveries


def phase_train(tcfg, shape):
    """The main path of slice 4, with the attention launch counts reset
    before it and read after it: ``ft_loop.run`` in a temporary directory —
    a clean run of 12 steps (checkpoint every 4; the loss falls), a second
    clean run bit-identical to it, a NaN written into embed[0, 0] at step 9
    (one recovery, losses bit-identical to the clean run), a run stopped at
    8 and resumed to 12 (bit-identical to the clean run's steps 8-11) and
    an inject_into_pytree drill (finishes with finite losses).  fwd_lse
    launches = 2 × n_layers and bwd launches = n_layers per step executed:
    the forward runs once per block and again in its recompute."""
    from repro_torch.core import fault_injection as fi
    from repro_torch.kernels.flashattn import kernel as FK
    L = tcfg.n_layers
    FK.reset_launches()
    executed, runs = 0, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        free = shutil.disk_usage(root).free
        print(f"train: {ARCH} {L} layers, batch {shape.global_batch} x "
              f"{shape.seq_len}, {tcfg.optimizer}, remat {tcfg.remat}, "
              f"attn {tcfg.attn_impl}; checkpoints under a temporary "
              f"directory with {free / 2**30:.1f} GiB free")

        def go(name, n_steps, **kw):
            nonlocal executed
            rep, secs = _ft_run(tcfg, shape, os.path.join(root, name),
                                n_steps, **kw)
            executed += _executed(rep)
            runs.setdefault(name, []).append(
                {"losses": rep.losses, "recoveries": rep.recoveries,
                 "steps_replayed": rep.steps_replayed, "wall_s": secs,
                 "ckpt_stats": rep.ckpt_stats, "events": rep.events})
            print(f"  train {name:8s} {len(rep.losses):2d} steps kept, "
                  f"{rep.recoveries} recoveries, {rep.steps_replayed} "
                  f"replayed, {rep.ckpt_stats.get('saves', 0)} saves in "
                  f"{secs:.2f} s; losses {rep.losses[0]:.6f} .. "
                  f"{rep.losses[-1]:.6f}")
            return rep

        clean = go("clean", TRAIN_STEPS)
        again = go("clean2", TRAIN_STEPS)
        shutil.rmtree(os.path.join(root, "clean"))
        shutil.rmtree(os.path.join(root, "clean2"))

        fired = {"nan": False, "drill": False}

        def nan_hook(step, state):
            if step == TRAIN_NAN_STEP and not fired["nan"]:
                fired["nan"] = True
                embed = state.params["embed"].clone()
                embed[0, 0] = float("nan")
                return state._replace(params=dict(state.params, embed=embed))
            return None

        nan = go("nan", TRAIN_STEPS, hook=nan_hook)
        shutil.rmtree(os.path.join(root, "nan"))
        first = go("resume", TRAIN_RESUME_AT)
        resumed = go("resume", TRAIN_STEPS)
        shutil.rmtree(os.path.join(root, "resume"))

        def drill_hook(step, state):
            if step == 6 and not fired["drill"]:
                fired["drill"] = True
                return state._replace(params=fi.inject_into_pytree(
                    state.params, torch.Generator().manual_seed(DRILL_SEED),
                    n_flips=3))
            return None

        drill = go("drill", 10, every=3, hook=drill_hook)
    launches = {k.__name__: k.launches for k in FK.KERNELS}
    derived = {"flash_attention": 0, "flash_attention_checked": 0,
               "flash_attention_fwd_lse": 2 * L * executed,
               "flash_attention_bwd": L * executed}
    print(f"train: {executed} train steps executed, launches {launches}, "
          f"derived {derived}")

    losses = clean.losses
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"clean run: {losses}")
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if again.losses != losses:
        raise AssertionError("two clean runs differ")
    if nan.recoveries != 1 or nan.losses != losses:
        raise AssertionError(f"NaN drill: {nan.recoveries} recoveries, "
                             f"losses {nan.losses}")
    if len(first.losses) != TRAIN_RESUME_AT \
            or resumed.losses != losses[TRAIN_RESUME_AT:]:
        raise AssertionError(f"resume: {resumed.losses} against "
                             f"{losses[TRAIN_RESUME_AT:]}")
    if len(drill.losses) != 10 or not np.all(np.isfinite(drill.losses)):
        raise AssertionError(f"bit-flip drill: {drill.losses}")
    drill_clean = drill.losses == losses[:10]
    print(f"  bit identity: two clean runs, NaN recovery and resume equal "
          f"the clean run; loss {np.mean(losses[:4]):.4f} (first 4) -> "
          f"{np.mean(losses[-4:]):.4f} (last 4); bit-flip drill "
          f"{drill.recoveries} recoveries, finite, "
          f"{'equal to' if drill_clean else 'off'} the clean curve")
    if launches != derived:
        raise AssertionError(f"train launches {launches} != derived "
                             f"{derived}")
    return {"runs": runs, "steps_executed": executed,
            "drill_equals_clean": drill_clean}, launches


def _flat_grads(tcfg, params, batch):
    from repro_torch import tree
    from repro_torch.models import api
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    live = tree.unflatten(tree.structure(params), leaves)
    loss, _ = api.loss_fn(tcfg, live, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), torch.cat([g.float().reshape(-1) for g in grads])


def phase_train_grads(tcfg, shape):
    """One step's gradients (step 0's batch, seed-0 weights) under
    attn_impl flash against chunked, both bf16, beside the bf16 noise floor
    of the path measured in the same run: chunked in bf16 against chunked
    in f32 compute.  Flash and chunked round in other places (chunked
    rounds the probabilities to bf16 before PV); they must not differ by
    more than twice what bf16 rounding does to one of them."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import api
    params = api.init_params(tcfg, torch.Generator().manual_seed(0),
                             device=DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in TokenStream(tcfg, shape).batch_at(0).items()}
    chunked = dataclasses.replace(tcfg, attn_impl="chunked")
    lf, gf = _flat_grads(tcfg, params, batch)
    lc, gc = _flat_grads(chunked, params, batch)
    l32, g32 = _flat_grads(dataclasses.replace(chunked,
                                               compute_dtype="float32"),
                           params, batch)
    if not bool(torch.isfinite(gf).all()):
        raise AssertionError("flash gradients are not finite")
    rel = float((gf - gc).norm() / gc.norm())
    floor = float((gc - g32).norm() / g32.norm())
    print(f"train grads flash vs chunked ({gf.numel()} values): rel L2 "
          f"{rel:.5f} (bf16 noise floor, chunked bf16 vs f32: {floor:.5f}); "
          f"loss flash {lf:.6f}, chunked {lc:.6f}, chunked f32 {l32:.6f}")
    if not rel <= 2 * floor:
        raise AssertionError(f"flash gradients off chunked: rel {rel}, "
                             f"floor {floor}")
    return {"grads_rel_l2": rel, "bf16_noise_floor_rel_l2": floor,
            "loss_flash": lf, "loss_chunked": lc, "loss_chunked_f32": l32}


def _train_step_fixture(tcfg, shape):
    """A seed-0 train state, step 0's batch and the step function."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train import steps
    state = steps.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                   device=DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in TokenStream(tcfg, shape).batch_at(0).items()}
    step = steps.make_train_step(tcfg)

    def run():
        float(step(state, batch)[1]["loss"])     # the loop's own readback
    return run


def phase_train_time(tcfg, shape):
    """Host-clock ms per train step (the step and its loss readback, as
    the FT loop runs it), median of TRAIN_ROUNDS rounds after a warm-up;
    tokens/s; peak device memory of a step."""
    run = _train_step_fixture(tcfg, shape)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_ROUNDS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    tokens = shape.global_batch * shape.seq_len
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train step {ms:.3f} ms (median of {len(times)}, rounds "
          f"{', '.join(f'{t:.1f}' for t in times)}), {tokens / (ms / 1e3):.1f} "
          f"tokens/s, peak device memory {peak:.2f} GiB")
    return {"ms_per_step": ms, "ms_rounds": times,
            "tokens_per_s": tokens / (ms / 1e3), "peak_gib": peak}, run


def phase_time_bwd(gen, max_err):
    """CUDA-event ms per call of row 10 at (1, 9, 1024, 64) and the
    training shape (8, 9, 1024, 64), bf16, beside its plain version, its
    bound and SDPA's backward (the library yardstick, timed on k/v already
    expanded to 9 heads so that the flash backend takes it; the port never
    calls it)."""
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    rows, calls = [], []
    for b in (1, TRAIN_BATCH):
        case = FlashCase(gen, b, 9, 3, TRAIN_SEQ, 64, torch.bfloat16)
        inputs = _bwd_inputs(case, gen)
        for g, w in zip(FK.flash_attention_bwd(*inputs),
                        FR.flash_bwd_plain(*inputs)):
            max_err["flash_attention_bwd"] = max(
                max_err["flash_attention_bwd"],
                _bwd_check(g, w, torch.bfloat16)[0])
        ms = _time_ms(lambda: FK.flash_attention_bwd(*inputs), reps=20)
        plain_ms = _time_ms(lambda: FR.flash_bwd_plain(*inputs), reps=3,
                            warmup=1)
        q, k, v, _, _, do = inputs
        qs, ks, vs = (t.detach().requires_grad_() for t in
                      (q, k.repeat_interleave(3, dim=1),
                       v.repeat_interleave(3, dim=1)))
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qs, ks, vs), do,
                                       retain_graph=True)
        lib_ms = _time_ms(sdpa_bwd, reps=20)
        bound, by = case.bwd_bound_ms()
        rows.append({"B": b, "kernel": "flash_attention_bwd", "ms": ms,
                     "device_ms": None, "dq_device_ms": None,
                     "dkv_device_ms": None, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                     "library_device_ms": None})
        calls.append((functools.partial(FK.flash_attention_bwd, *inputs),
                      sdpa_bwd))
    return rows, calls


def phase_profile_train(run, rows, calls):
    """One train step under torch.profiler: device busy ms, idle share,
    device ops per step, top entries; then row 10's and SDPA backward's
    device time per call, filled into ``rows``: row 10's whole call (the
    dvec op included) and its dQ and dK/dV kernels apart."""
    w = _profile_window(run, reps=1)
    if w is None:
        print("profile train step: the profiler saw no device time "
              "(not measured)")
    else:
        print(f"profile train step: wall {w['wall_ms']:.3f} ms, device busy "
              f"{w['busy_ms']:.3f} ms, idle share {w['idle_share']:.3f}, "
              f"{w['ops']:.0f} device ops/step")
        for kname, v in w["top"]:
            print(f"    {v:8.4f} ms  {kname}")
    for row, (call, lib) in zip(rows, calls):
        row["device_ms"] = _device_ms(call, reps=10, match=None)
        row["dq_device_ms"] = _device_ms(call, reps=10, match="flash_bwd_dq")
        row["dkv_device_ms"] = _device_ms(call, reps=10,
                                          match="flash_bwd_dkv")
        row["library_device_ms"] = _device_ms(lib, reps=10, match=None)
    print("backward per call at (B, 9, 1024, 64)/(B, 3, 1024, 64) bf16 "
          "(CUDA events; device time from the profiler, dvec op "
          "included):")

    def n_m(x):
        return "n/m" if x is None else f"{x:.4f}"
    for r in rows:
        print(f"  B {r['B']} {r['kernel']:20s} {r['ms']:8.4f} ms  device "
              f"{n_m(r['device_ms']):>7s} ms (dQ {n_m(r['dq_device_ms'])}, "
              f"dK/dV {n_m(r['dkv_device_ms'])})  plain "
              f"{r['plain_ms']:8.3f} ms  bound "
              f"{r['bound_ms']:8.5f} ms ({r['bound_by']})  sdpa bwd "
              f"{r['library_ms']:.4f} ms (device "
              f"{r['library_device_ms'] or float('nan'):.4f})")
    return w


def bwd_totals(rows):
    """Row 10 per call at the training shape (the main path's)."""
    r = next(r for r in rows if r["B"] == TRAIN_BATCH)
    return {r["kernel"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound_ms"],
                          "t_bytes": r["bound_ms"] * (r["bound_by"] == "bytes"),
                          "t_ops": r["bound_ms"] * (r["bound_by"] != "bytes")}
            }, {r["kernel"]: r["library_ms"]}


CAMPAIGN_BUDGET_S = 120            # the campaign phase's share of the limit
BIT_TRIALS = 16                    # bit-sweep trials per bit and policy
# the campaign's geometries at full width: SmolLM-135M's two decode FFN
# shapes, the two Table-1 bit-sweep convs of benchmarks/table1_conv.py and
# the ship detector's conv_24x3x3x24 at its network_specs(194) input, and
# SmolLM-135M's query heads at a 1024-token prefill
CAMPAIGN_CASES = {
    "qmatmul 8x576x1536": ("qmatmul", dict(m=8, k=576, n=1536)),
    "qmatmul 8x1536x576": ("qmatmul", dict(m=8, k=1536, n=576)),
    "qconv2d t1_conv1": ("qconv2d", dict(h=24, w=24, cin=24, cout=24,
                                         kh=3, kw=3)),
    "qconv2d t1_conv4": ("qconv2d", dict(h=12, w=12, cin=96, cout=96,
                                         kh=1, kw=1)),
    "qconv2d conv_24x3x3x24@194": ("qconv2d", dict(h=194, w=194, cin=24,
                                                   cout=24, kh=3, kw=3)),
    "flashattn 1x9x1024x64": ("flashattn", dict(b=1, h=9, s=1024, hd=64)),
    "shipdet reduced": ("shipdet", {}),
    "transformer reduced smollm-135m": ("transformer", {}),
}
CAMPAIGN_ROWS = ("qconv2d_acc", "qconv2d_acc_checksum", "qmatmul_acc",
                 "qmatmul_acc_checksum", "flash_attention",
                 "flash_attention_checked")


def _campaign_configs():
    """(case label, policy, site, fault model, trials, verdict) per
    configuration; each verdict is a check on the report row that raises."""
    from repro_torch.core.dependability import Policy as P

    def sdc0(r):
        return r.sdc == 0

    def detect_all(r):
        return r.detection_rate == 1.0 and r.sdc == 0

    def has_sdc(r):
        return r.sdc > 0

    def dmr(r):          # detected exactly when the output differs
        return r.sdc == 0 and r.detected_corrected == 0

    def healed(r):
        return r.sdc == 0 and r.detected_uncorrected == 0

    def covered(r):
        return r.sdc == 0 and r.detected_corrected \
            + r.detected_uncorrected > 0

    out = []
    for label in ("qmatmul 8x576x1536", "qmatmul 8x1536x576"):
        out += [(label, P.ABFT, "accumulator", "single_bitflip", 500,
                 detect_all),
                (label, P.NONE, "accumulator", "single_bitflip", 200,
                 has_sdc),
                (label, P.CKPT, "weights", "single_bitflip", 200, healed),
                (label, P.TMR, "accumulator", "mbu_burst", 200, sdc0)]
        for site in ("accumulator", "weights", "activations"):
            out += [(label, P.TMR, site, "single_bitflip", 200, sdc0),
                    (label, P.DMR, site, "single_bitflip", 200, dmr)]
    for label in ("qconv2d t1_conv1", "qconv2d t1_conv4",
                  "qconv2d conv_24x3x3x24@194"):
        out += [(label, P.ABFT, "accumulator", "single_bitflip", 200, sdc0),
                (label, P.CKPT, "accumulator", "single_bitflip", 200, sdc0)]
    out += [("flashattn 1x9x1024x64", P.ABFT, "accumulator",
             "single_bitflip", 300, detect_all),
            ("flashattn 1x9x1024x64", P.NONE, "accumulator",
             "single_bitflip", 60, has_sdc)]
    out += [("shipdet reduced", P.ABFT, "accumulator", "single_bitflip", 60,
             sdc0),
            ("shipdet reduced", P.CKPT, "accumulator", "single_bitflip", 60,
             sdc0),
            ("shipdet reduced", P.ABFT, "weights", "single_bitflip", 60,
             covered),
            ("shipdet reduced", P.CKPT, "weights", "single_bitflip", 60,
             lambda r: covered(r) and healed(r))]
    for site in ("weights", "activations"):
        out += [("transformer reduced smollm-135m", P.TMR, site,
                 "single_bitflip", 40, sdc0),
                ("transformer reduced smollm-135m", P.DMR, site,
                 "single_bitflip", 40, dmr)]
    out.append(("transformer reduced smollm-135m", P.NONE, "activations",
                "single_bitflip", 40, has_sdc))
    return out


def _campaign_launches():
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.kernels.qmatmul import kernel as MK
    return {k.__name__: k.launches
            for k in (*K.KERNELS, *MK.KERNELS, *FK.KERNELS)}


def _reset_all_launches():
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.kernels.qmatmul import kernel as MK
    for mod in (K, MK, FK):
        mod.reset_launches()


def phase_campaign(card: str) -> dict:
    """Slice 10: the port's SEU campaign on the card, ``cuda`` backend,
    through ``run_campaign`` and ``run_bit_sweep``, at full width; the
    reference's verdicts asserted per configuration; ``run_trials`` on
    the same seeds equal under ``ref``, ``torch`` and ``cuda``; launch
    counts of rows 1, 2, 4, 5, 7, 8 above 0 under ``cuda`` and all 0
    under ``ref`` and ``torch``."""
    from repro_torch.campaign import (CampaignSpec, resolve_fault_model,
                                      runner, trial_seeds)
    from repro_torch.core.dependability import Policy

    t_phase = time.perf_counter()
    cases = {label: runner.CASES[w](0, "cuda", device=DEVICE, **geo)
             for label, (w, geo) in CAMPAIGN_CASES.items()}
    rows, failed = [], []
    _reset_all_launches()
    for label, policy, site, fm, trials, verdict in _campaign_configs():
        workload = CAMPAIGN_CASES[label][0]
        spec = CampaignSpec(workload, policy, site, fm, trials, seed=0)
        t0 = time.perf_counter()
        res, = runner.run_campaign(
            [spec], cache={(workload, 0, "cuda", DEVICE): cases[label]},
            device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ok = verdict(res)
        rows.append({"case": label, "policy": policy.value, "site": site,
                     "fault_model": fm, "trials": res.trials,
                     "masked": res.masked,
                     "detected_corrected": res.detected_corrected,
                     "detected_uncorrected": res.detected_uncorrected,
                     "sdc": res.sdc, "seconds": secs,
                     "trials_per_s": res.trials / secs, "ok": ok})
        print(f"campaign: {label:32s} {policy.value:4s} {site:11s} {fm:14s} "
              f"n={res.trials} det={res.detection_rate:.3f} sdc={res.sdc} "
              f"corr={res.detected_corrected} unc={res.detected_uncorrected}"
              f" {res.trials / secs:.1f} trials/s"
              + ("" if ok else "  VERDICT MISSED"))
        if not ok:
            failed.append(f"{label} {spec.label()}")

    bit_rows = {}
    for label in ("qmatmul 8x576x1536", "qconv2d t1_conv1",
                  "qconv2d t1_conv4"):
        t0 = time.perf_counter()
        sweep = runner.run_bit_sweep(
            CAMPAIGN_CASES[label][0], [Policy.NONE, Policy.ABFT],
            trials_per_bit=BIT_TRIALS, case=cases[label], device=DEVICE)
        secs = time.perf_counter() - t0
        abft = [r for r in sweep if r.policy == "abft"]
        none31 = [r for r in sweep if r.policy == "none" and r.bit == 31][0]
        ok = (len(abft) == 32 and all(r.sdc == 0 for r in abft)
              and none31.sdc == none31.trials)
        bit_rows[label] = [r.to_dict() for r in sweep]
        print(f"campaign: bit sweep {label}: abft sdc "
              f"{sum(r.sdc for r in abft)} over 32 bits, none bit 31 sdc "
              f"{none31.sdc}/{none31.trials}, "
              f"{sum(r.trials for r in sweep) / secs:.1f} trials/s"
              + ("" if ok else "  VERDICT MISSED"))
        if not ok:
            failed.append(f"bit sweep {label}")
    cuda_launches = _campaign_launches()
    print(f"campaign: launches under cuda {cuda_launches}")
    if any(cuda_launches[name] == 0 for name in CAMPAIGN_ROWS):
        failed.append(f"a campaign row never launched: {cuda_launches}")

    # trial-by-trial: the same seeds under ref, torch and cuda give equal
    # arrays (the plain backends launch no kernel)
    parity = [("qmatmul 8x576x1536", Policy.ABFT, "accumulator"),
              ("qmatmul 8x1536x576", Policy.NONE, "weights"),
              ("qconv2d conv_24x3x3x24@194", Policy.ABFT, "accumulator"),
              ("qconv2d t1_conv4", Policy.CKPT, "weights"),
              ("shipdet reduced", Policy.ABFT, "accumulator"),
              ("shipdet reduced", Policy.CKPT, "weights")]
    fault = resolve_fault_model("single_bitflip").apply

    def parity_arrays(label, policy, site, case):
        seeds = trial_seeds(CampaignSpec(CAMPAIGN_CASES[label][0], policy,
                                         site, "single_bitflip", 20))
        return case.run_trials(policy, site, fault, seeds)

    cuda_arrays = {p: parity_arrays(*p, cases[p[0]]) for p in parity}
    plain_launches = {}
    for backend in ("ref", "torch"):
        _reset_all_launches()
        for label, policy, site in parity:
            w, geo = CAMPAIGN_CASES[label]
            d_p, m_p = parity_arrays(
                label, policy, site,
                runner.CASES[w](0, backend, device=DEVICE, **geo))
            d_c, m_c = cuda_arrays[label, policy, site]
            same = np.array_equal(d_p, d_c) and np.array_equal(m_p, m_c)
            print(f"campaign: {backend} == cuda trial by trial, {label} "
                  f"{policy.value}/{site}: {same} (detected "
                  f"{int(d_c.sum())}, mismatch {int(m_c.sum())} of 20)")
            if not same:
                failed.append(f"{backend} != cuda: {label} "
                              f"{policy.value}/{site}")
        torch.cuda.synchronize()
        plain_launches[backend] = _campaign_launches()
        print(f"campaign: launches under {backend} "
              f"{plain_launches[backend]}")
        if any(plain_launches[backend].values()):
            failed.append(f"a kernel launched under {backend}: "
                          f"{plain_launches[backend]}")

    secs = time.perf_counter() - t_phase
    print(f"campaign: {sum(r['trials'] for r in rows)} trials in "
          f"{len(rows)} configurations and 3 bit sweeps in {secs:.1f} s "
          f"(budget {CAMPAIGN_BUDGET_S} s) on {card}")
    if secs > CAMPAIGN_BUDGET_S:
        failed.append(f"campaign phase took {secs:.1f} s")
    if failed:
        raise AssertionError("campaign: " + "; ".join(failed))
    return {"card": card, "seconds": secs, "configs": rows,
            "bit_sweep": bit_rows, "launches_cuda": cuda_launches,
            "launches_plain": plain_launches}


# slice 11: dependable serving at full width
DEP_STRIKE_TICKS = (2, 6, 10, 14)  # the strikes land after these pumps
DEP_ROWS = ("qmatmul_acc", "qmatmul_acc_checksum", "flash_attention_fwd_lse")
DEP_CAMPAIGN_TRIALS = 8            # per serving campaign configuration
DEP_TIMING_STEPS = 10              # decode steps per timing round
DEP_BUDGET_S = 180                 # the phase's share of the limit
DEP_LAYERS = 15                    # depth cut: 15 of 30 layers (slice 13)


def _dep_kw(name):
    """Engine keywords of a uniform map; under CKPT the storage scrub runs
    every pump, so the golden weights are back before any stage reads a
    struck one (its default cadence, snapshot_every, heals only later
    reads)."""
    from repro_torch.core.policy_map import PolicyMap
    kw = {"policy_map": PolicyMap.uniform(name)}
    if name == "ckpt":
        kw["storage_scrub_every"] = 1
    return kw


def _dep_strikes(quant_kv):
    """(label, site, leaf) of each strike of a run, in order: the cache's
    k page (int8 or bf16), its k scales (int8 cache), the token buffer
    and a weight leaf drawn by size."""
    out = [("kv_cache k", "kv_cache", ("k",))]
    if quant_kv:
        out.append(("kv_cache k_s", "kv_cache", ("k_s",)))
    return out + [("decode_state", "decode_state", None),
                  ("weights", "weights", None)]


def _dep_run(cfg, params, prompts, quant_kv, strikes=(), **kw):
    """Serve ``prompts`` on ``cfg`` (``quant_kv`` set) with an event log,
    striking one flip_one_bit after each pump of ``DEP_STRIKE_TICKS``
    (drawn from a generator seeded by ``trial_seed``); returns the engine,
    its requests, the log and the seconds."""
    from repro_torch.campaign import faultload as fl
    from repro_torch.core import fault_injection as fi
    from repro_torch.obs import EventLog
    log = kw.pop("event_log", None) or EventLog()
    eng, reqs = _serve(dataclasses.replace(cfg, quant_kv=quant_kv), params,
                       prompts, MAX_NEW, event_log=log, **kw)
    at = dict(zip(DEP_STRIKE_TICKS, strikes))
    t0 = time.perf_counter()
    while eng.executor.busy():
        eng.step()
        if eng.tick in at:
            label, site, leaf = at[eng.tick]
            gen = fl.generator(fl.trial_seed(
                0, f"chip_smoke/dependable/{quant_kv}/{label}", 0))
            eng.strike(site, fi.flip_one_bit, gen, leaf=leaf)
    torch.cuda.synchronize()
    if any(len(r.output or ()) != MAX_NEW for r in reqs):
        raise AssertionError("dependable: a request did not complete")
    return eng, reqs, log, time.perf_counter() - t0


def _syncs_per_step(eng, steps):
    """Host synchronisations per decode step, as torch's sync debug mode
    reports them (one warning per synchronising call)."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            for _ in range(steps):
                eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen) / steps


def _tree_bytes(t) -> int:
    from repro_torch import tree
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def phase_dependable(cfg, params, prompts, card: str) -> dict:
    """Slice 11: dependable serving at full width (SmolLM-135M with its
    depth cut to DEP_LAYERS of 30 layers, W8A8 FFN, bf16, flash prefill,
    capacity 8, 16 requests of 32 new tokens): (a)
    uniform ABFT (detect) and CKPT (rollback) maps with the int8 KV cache
    off and on, clean runs without an alarm and struck runs (the first 8
    requests) with one detection per strike, CKPT streams equal to the
    clean ones; (b) multi_step 4 equal to 1 (the first 8 requests); (c) two same-seed runs with all three
    observers byte-identical; (d) the serving campaign workloads on the
    ``cuda`` backend at the reference's case, CKPT SDC 0 and ABFT
    detection 1.000 at every site, ``ref`` equal to ``cuda`` trial by
    trial; (e) rows 4, 5 and 9 launched; (f) decode ms/step and host syncs
    per step by scrub mode, and one scrub pass of each kind beside its
    bound, the storage checksums equal to the CPU's.  Launch counts are
    reset at its start and read at its end."""
    from repro_torch import tree
    from repro_torch.campaign import CampaignSpec, runner, trial_seeds
    from repro_torch.campaign import resolve_fault_model
    from repro_torch.core import abft
    from repro_torch.core.dependability import Policy
    from repro_torch.obs import EventLog, Registry, SpanTracer
    from repro_torch.runtime.dataflow import _checks_equal, _state_checksums

    t_phase = time.perf_counter()
    # the first DEP_LAYERS layers at full width: views of the main path's
    # stacked weights
    dcfg = dataclasses.replace(cfg, attn_impl="flash", n_layers=DEP_LAYERS)
    params = {**params, "dense_blocks": {
        k: v[:DEP_LAYERS] for k, v in params["dense_blocks"].items()}}
    failed, out = [], {"card": card, "layers": DEP_LAYERS}
    _reset_all_launches()

    # (a) the maps, clean and struck, the int8 KV cache off and on
    clean, runs = {}, {}
    for qkv in (False, True):
        for name in ("abft", "ckpt"):
            eng, reqs, log, secs = _dep_run(dcfg, params, prompts, qkv,
                                            **_dep_kw(name))
            streams = [list(r.output) for r in reqs]
            alarms = (len(eng.drain_state_events()), len(log),
                      int(eng.dependability["faults_detected"]))
            if alarms != (0, 0, 0):
                failed.append(f"clean {name} quant_kv={qkv}: alarms "
                              f"{alarms}")
            clean.setdefault(qkv, streams)
            if streams != clean[qkv]:
                failed.append(f"clean {name} quant_kv={qkv}: streams "
                              f"differ between the maps")
            # a request's stream does not depend on its neighbours, so the
            # struck run serves one full batch and is held to its prefix
            strikes = _dep_strikes(qkv)
            eng, reqs, log, s_secs = _dep_run(dcfg, params,
                                              prompts[:CAPACITY], qkv,
                                              strikes, **_dep_kw(name))
            events = eng.drain_state_events()
            tls = log.timelines()
            lat = [t["detection_latency_ticks"] for t in tls]
            same = [list(r.output) for r in reqs] == clean[qkv][:CAPACITY]
            ok = (len(events) == len(tls) == len(strikes)
                  and all(t["detected"] for t in tls) and set(lat) == {1}
                  and all(e["recovered"] == (name == "ckpt")
                          for e in events)
                  and (same or name == "abft"))
            runs[f"{name} quant_kv={qkv}"] = {
                "clean_s": secs, "struck_s": s_secs,
                "strikes": [lbl for lbl, _, _ in strikes],
                "events": len(events), "detection_ticks": lat,
                "recovered": sum(e["recovered"] for e in events),
                "streams_equal_clean": same, "ok": ok}
            print(f"dependable: {name} quant_kv={qkv}: clean run "
                  f"{secs:.2f} s, no alarm; {len(strikes)} strikes "
                  f"({', '.join(lbl for lbl, _, _ in strikes)}) -> "
                  f"{len(events)} events, detection after {lat} ticks, "
                  f"{sum(e['recovered'] for e in events)} recovered, "
                  f"streams equal clean: {same} ({s_secs:.2f} s)"
                  + ("" if ok else "  FAILED"))
            if not ok:
                failed.append(f"struck {name} quant_kv={qkv}")
    out["maps"] = runs

    # (b) decode windows
    for qkv in (False, True):
        eng, reqs, _, secs = _dep_run(dcfg, params, prompts[:CAPACITY], qkv,
                                      multi_step=4)
        same = [list(r.output) for r in reqs] == clean[qkv][:CAPACITY]
        print(f"dependable: multi_step 4 quant_kv={qkv}: streams equal "
              f"multi_step 1: {same} ({eng.stats.steps} steps, "
              f"{secs:.2f} s)")
        if not same:
            failed.append(f"multi_step 4 quant_kv={qkv}")

    # (c) observers: two same-seed runs, byte for byte
    exports = []
    for _ in range(2):
        tracer, reg = SpanTracer(), Registry()
        _dep_run(dcfg, params, prompts[:CAPACITY], True,
                 [("decode_state", "decode_state", None)], multi_step=2,
                 tracer=tracer, metrics=reg, event_log=EventLog(),
                 **_dep_kw("ckpt"))
        exports.append((tracer.to_bytes(), reg.render_prometheus(),
                        json.dumps(reg.snapshot(), sort_keys=True)))
    same = exports[0] == exports[1]
    print(f"dependable: observers: trace {len(exports[0][0])} bytes, "
          f"metrics {len(exports[0][1])} bytes, byte-identical across two "
          f"runs: {same}")
    if not same:
        failed.append("observer exports differ")

    # (d) the serving campaign workloads at the reference's case
    camp = []
    fault = resolve_fault_model("single_bitflip").apply
    for w in ("serving", "serving_int8kv"):
        case = runner.CASES[w](0, "cuda", device=DEVICE)
        for policy in (Policy.CKPT, Policy.ABFT):
            for site in ("weights", "kv_cache", "decode_state"):
                spec = CampaignSpec(w, policy, site, "single_bitflip",
                                    DEP_CAMPAIGN_TRIALS)
                t0 = time.perf_counter()
                res, = runner.run_campaign(
                    [spec], cache={(w, 0, "cuda", DEVICE): case},
                    device=DEVICE)
                secs = time.perf_counter() - t0
                ok = (res.sdc == 0 if policy == Policy.CKPT
                      else res.detection_rate == 1.0)
                camp.append({"workload": w, "policy": policy.value,
                             "site": site, "trials": res.trials,
                             "detection_rate": res.detection_rate,
                             "sdc": res.sdc,
                             "faults_recovered": res.faults_recovered,
                             "trials_per_s": res.trials / secs, "ok": ok})
                print(f"dependable: campaign {w:14s} {policy.value:4s} "
                      f"{site:12s} n={res.trials} det="
                      f"{res.detection_rate:.3f} sdc={res.sdc} rec="
                      f"{res.faults_recovered} {res.trials / secs:.1f} "
                      f"trials/s" + ("" if ok else "  VERDICT MISSED"))
                if not ok:
                    failed.append(f"campaign {spec.label()}")
        ref = runner.CASES[w](0, "ref", device=DEVICE)
        for policy, site in ((Policy.NONE, "weights"),
                             (Policy.NONE, "kv_cache"),
                             (Policy.CKPT, "decode_state"),
                             (Policy.ABFT, "kv_cache")):
            seeds = trial_seeds(CampaignSpec(w, policy, site,
                                             "single_bitflip",
                                             DEP_CAMPAIGN_TRIALS))
            d_c, m_c = case.run_trials(policy, site, fault, seeds)
            d_r, m_r = ref.run_trials(policy, site, fault, seeds)
            same = np.array_equal(d_c, d_r) and np.array_equal(m_c, m_r)
            print(f"dependable: campaign {w} {policy.value}/{site}: ref == "
                  f"cuda trial by trial: {same} (detected "
                  f"{int(d_c.sum())}, mismatch {int(m_c.sum())} of "
                  f"{len(seeds)})")
            if not same:
                failed.append(f"ref != cuda: {w} {policy.value}/{site}")
    out["campaign"] = camp

    # (e) launches on the phase's path
    launches = _campaign_launches()
    print(f"dependable: launches {launches}")
    if any(launches[name] == 0 for name in DEP_ROWS):
        failed.append(f"a row of the path never launched: {launches}")
    out["launches"] = launches

    # (f) timings: decode by scrub mode, syncs, one pass of each scrub
    engines = {(qkv, mode): _decoding(
        dataclasses.replace(dcfg, quant_kv=qkv), params, prompts,
        {"state_scrub": mode, "storage_scrub": mode})
        for qkv in (False, True) for mode in ("off", "detect", "rollback")}
    step_ms = {k: [] for k in engines}
    for _ in range(DECODE_ROUNDS):
        for k, eng in engines.items():
            eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DEP_TIMING_STEPS):
                eng.step()
            torch.cuda.synchronize()
            step_ms[k].append((time.perf_counter() - t0) * 1e3
                              / DEP_TIMING_STEPS)
    timing = {}
    for (qkv, mode), eng in engines.items():
        ms = statistics.median(step_ms[qkv, mode])
        syncs = _syncs_per_step(eng, DEP_TIMING_STEPS)
        timing[f"quant_kv={qkv} {mode}"] = {
            "ms_per_decode_step": ms, "ms_rounds": step_ms[qkv, mode],
            "syncs_per_step": syncs}
        print(f"dependable: decode quant_kv={qkv!s:5s} scrubs {mode:8s} "
              f"{ms:8.3f} ms/step (rounds "
              f"{', '.join(f'{t:.3f}' for t in step_ms[qkv, mode])}), "
              f"{syncs:.2f} host syncs/step")
    for qkv in (False, True):
        base = timing[f"quant_kv={qkv} off"]["syncs_per_step"]
        for mode in ("detect", "rollback"):
            t = timing[f"quant_kv={qkv} {mode}"]
            t["syncs_added_per_step"] = t["syncs_per_step"] - base
    out["decode"] = timing

    checks = abft.storage_checksums(params)
    host = abft.storage_checksums(tree.map(lambda t: t.cpu(), params))
    if any(int(a) != int(b) for a, b in zip(tree.leaves(checks),
                                            tree.leaves(host))):
        failed.append("storage checksums on the card differ from the CPU's")
    print(f"dependable: storage checksums of {len(tree.leaves(checks))} "
          f"parameter leaves equal on the card and on the CPU")
    storage_bytes = _tree_bytes(params)
    dev_ms, ops, _ = _device_ops(lambda: abft.verify_storage(params, checks),
                                 5)
    host_ms = _time_ms(lambda: abft.all_verified(abft.verify_storage(
        params, checks)), 20)
    out["storage_scrub"] = {"device_ms": dev_ms, "ops": ops,
                            "events_ms": host_ms, "bytes": storage_bytes,
                            "bound_ms": storage_bytes / HBM_BYTES_PER_S
                            * 1e3}
    for qkv in (False, True):
        ex = engines[qkv, "detect"].executor
        state = ex._device_state()
        want = _state_checksums(state)
        state_bytes = _tree_bytes(state)
        s_dev, s_ops, _ = _device_ops(lambda: _state_checksums(state), 5)
        s_host = _time_ms(lambda: _checks_equal(_state_checksums(state),
                                                want), 20)
        out[f"state_scrub quant_kv={qkv}"] = {
            "device_ms": s_dev, "ops": s_ops, "events_ms": s_host,
            "bytes": state_bytes,
            "bound_ms": state_bytes / HBM_BYTES_PER_S * 1e3}
    for name in ("storage_scrub", "state_scrub quant_kv=False",
                 "state_scrub quant_kv=True"):
        r = out[name]
        print(f"dependable: one {name} pass: device "
              + (f"{r['device_ms']:.4f}" if r["device_ms"] is not None
                 else "not measured")
              + f" ms over {r['ops']:.0f} ops, {r['events_ms']:.4f} ms by "
              f"events with its readback, bound {r['bound_ms']:.4f} ms "
              f"({r['bytes']} bytes / 3.35 TB/s)")

    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"dependable: phase in {secs:.1f} s (budget {DEP_BUDGET_S} s) on "
          f"{card}")
    if secs > DEP_BUDGET_S:
        failed.append(f"dependable phase took {secs:.1f} s")
    if failed:
        raise AssertionError("dependable: " + "; ".join(failed))
    return out


# slice 12: the dependable serving fleet at full width
FLEET_REQUESTS = 12
FLEET_MAX_NEW = 16
FLEET_MAX_LEN = 576                # prompts of 8-512 tokens + 16 new, in 64s
FLEET_REPLICAS = 3
FLEET_SCRUB_EVERY = 4
FLEET_ROUNDS = 2                   # timing rounds of each policy's clean run
FLEET_PROC_ROUNDS = 1              # timed rounds of the proc fleet
FLEET_LAYERS = 15                  # depth cut: 15 of 30 layers (slice 13)
FLEET_ROWS = ("qmatmul_acc", "qmatmul_acc_checksum",
              "flash_attention_fwd_lse")
FLEET_CAMPAIGN_TRIALS = 16         # per fleet campaign configuration
FLEET_NONE_TRIALS = 64             # NONE: enough trials for a manifest SDC
FLEET_MP_TRIALS = 8                # fleet_mp ABFT / CKPT (NONE: 64)
FLEET_COMPARE_TRIALS = 8           # ref == cuda, per configuration
FLEET_BUDGET_S = 370               # the phase's share of the limit: 1.3 x
                                   # its slowest run, 284.8 s on an NVIDIA
                                   # H100 80GB HBM3 (700 W) with a slow host


def fleet_setup(cfg):
    """The served LM with the flash prefill, and 12 seeded prompts of
    8-512 tokens."""
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    rng = random.Random(5)
    prompts = [[rng.randrange(cfg.vocab_size)
                for _ in range(rng.randint(8, 512))]
               for _ in range(FLEET_REQUESTS)]
    return fcfg, prompts


def _fleet(cfg, params, **kw):
    from repro_torch.fleet import Fleet
    kw = {"n_replicas": FLEET_REPLICAS, "capacity": CAPACITY,
          "max_len": FLEET_MAX_LEN, "prefill_pad": PREFILL_PAD,
          "scrub_every": FLEET_SCRUB_EVERY, **kw}
    return Fleet(cfg, params, **kw)


def _fleet_serve(fleet, prompts, policy=None, mid_run=None, deploy=None):
    """Reset ``fleet`` (to ``policy``), submit ``prompts``, run a drill
    after two ticks (``mid_run(fleet)``, or ``deploy`` keywords of
    ``Fleet.deploy``), serve to the end.  Returns the released streams
    (None where a request was not released) and the run's numbers: host
    seconds, ticks, decode steps and prefills of the replicas, and the
    kernel launches it made."""
    from repro_torch.runtime.serving import Request
    fleet.reset(policy=policy)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=FLEET_MAX_NEW)
            for i, p in enumerate(prompts)]
    before = _campaign_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        if not fleet.submit(r):
            raise AssertionError(f"fleet: request {r.uid} rejected")
    summary = None
    if mid_run is not None or deploy is not None:
        fleet.tick()
        fleet.tick()
        if mid_run is not None:
            mid_run(fleet)
        if deploy is not None:
            summary = fleet.deploy(**deploy)
    fleet.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = _campaign_launches()
    streams = [list(fleet.released[r.uid].output)
               if r.uid in fleet.released else None for r in reqs]
    tokens = sum(len(s) for s in streams if s)
    copies = 2 if fleet.policy.value == "dmr" else 1
    return streams, {
        "seconds": secs, "ticks": fleet.tick_no,
        "ms_per_tick": secs * 1e3 / max(fleet.tick_no, 1),
        "engine_steps": fleet.metrics.engine_steps,
        "tokens": tokens, "tokens_per_s": tokens / secs,
        "decode_steps": sum(r.engine.stats.steps for r in fleet.replicas),
        "prefills": copies * len(reqs),
        "launches": {k: after[k] - before[k] for k in after},
        "metrics": fleet.metrics.to_json(), "summary": summary}


def _derived_fleet_launches(cfg, run, row):
    """What a clean run launches: ``row`` (4 unmapped, 5 under the ABFT
    map) once per FFN matmul of every prefill and decode step, row 9 once
    per layer of every prefill, nothing else."""
    want = {name: 0 for name in run["launches"]}
    want[row] = 3 * cfg.n_layers * (run["prefills"] + run["decode_steps"])
    want["flash_attention_fwd_lse"] = cfg.n_layers * run["prefills"]
    return want


def _strike_gen(label):
    from repro_torch.campaign import faultload as fl
    return fl.generator(fl.trial_seed(0, f"chip_smoke/fleet/{label}", 0))


def _fleet_golden(cfg, params, prompts):
    """The streams one ``Engine`` serves on the same params."""
    from repro_torch.runtime.serving import Engine, Request
    eng = Engine(cfg, params, capacity=CAPACITY, max_len=FLEET_MAX_LEN,
                 prefill_pad=PREFILL_PAD)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=FLEET_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.output) for r in reqs]


def _w8a8(cfg):
    return dataclasses.replace(cfg, quant="w8a8_ffn")


def _fleet_campaigns(failed, out):
    """The ``fleet`` and ``fleet_mp`` campaigns at the reference's case on
    the ``cuda`` backend: ABFT and CKPT SDC 0, NONE SDC > 0 at the weights
    site, DMR SDC 0 at the transient sites.  The reference's case serves
    unquantized and launches no kernel, so ``fleet`` under ``ref`` is held
    equal to ``cuda`` trial by trial on the same case with the W8A8 FFN,
    where ``cuda`` launches row 4 and ``ref`` runs its plain version."""
    from repro_torch.campaign import CampaignSpec, runner, trial_seeds
    from repro_torch.campaign import resolve_fault_model
    from repro_torch.core.dependability import Policy
    fault = resolve_fault_model("single_bitflip").apply
    rows = []

    def verdict(case, w, policy, site, n):
        spec = CampaignSpec(w, policy, site, "single_bitflip", n)
        t0 = time.perf_counter()
        res, = runner.run_campaign([spec], cache={(w, 0, "cuda", DEVICE):
                                                  case}, device=DEVICE)
        secs = time.perf_counter() - t0
        ok = res.sdc > 0 if policy == Policy.NONE else res.sdc == 0
        rows.append({"workload": w, "policy": policy.value, "site": site,
                     "trials": res.trials, "sdc": res.sdc,
                     "detection_rate": res.detection_rate,
                     "faults_recovered": res.faults_recovered,
                     "trials_per_s": res.trials / secs, "ok": ok})
        print(f"fleet: campaign {w:8s} {policy.value:4s} {site:12s} "
              f"n={res.trials} det={res.detection_rate:.3f} sdc={res.sdc} "
              f"rec={res.faults_recovered} {res.trials / secs:.1f} trials/s"
              + ("" if ok else "  VERDICT MISSED"))
        if not ok:
            failed.append(f"campaign {spec.label()}")

    case = runner.CASES["fleet"](0, "cuda", device=DEVICE)
    n = FLEET_CAMPAIGN_TRIALS
    for policy, site, trials in (
            (Policy.NONE, "weights", FLEET_NONE_TRIALS),
            (Policy.ABFT, "weights", n), (Policy.ABFT, "kv_cache", n),
            (Policy.ABFT, "decode_state", n), (Policy.CKPT, "weights", n),
            (Policy.CKPT, "kv_cache", n), (Policy.CKPT, "decode_state", n),
            (Policy.DMR, "kv_cache", n), (Policy.DMR, "decode_state", n)):
        verdict(case, "fleet", policy, site, trials)
    case.fleet.close()

    class W8A8Fleet(runner.CASES["fleet"]):
        _customize_cfg = staticmethod(_w8a8)

    q_cuda = W8A8Fleet(0, "cuda", device=DEVICE)
    q_ref = W8A8Fleet(0, "ref", device=DEVICE)
    for policy, site in ((Policy.NONE, "weights"), (Policy.ABFT, "weights"),
                         (Policy.CKPT, "kv_cache"),
                         (Policy.DMR, "decode_state")):
        seeds = trial_seeds(CampaignSpec("fleet", policy, site,
                                         "single_bitflip",
                                         FLEET_COMPARE_TRIALS))
        before = _campaign_launches()["qmatmul_acc"]
        d_c, m_c = q_cuda.run_trials(policy, site, fault, seeds)
        row4 = _campaign_launches()["qmatmul_acc"] - before
        d_r, m_r = q_ref.run_trials(policy, site, fault, seeds)
        same = np.array_equal(d_c, d_r) and np.array_equal(m_c, m_r)
        print(f"fleet: campaign fleet, W8A8 FFN, {policy.value}/{site}: ref "
              f"== cuda trial by trial: {same} (detected {int(d_c.sum())}, "
              f"mismatch {int(m_c.sum())} of {len(seeds)}; cuda launched "
              f"row 4 {row4} times)" + ("" if same and row4 else "  FAILED"))
        if not same or not row4:
            failed.append(f"ref != cuda: fleet {policy.value}/{site}")
    for c in (q_cuda, q_ref):
        c.fleet.close()
    mp = runner.CASES["fleet_mp"](0, "cuda", device=DEVICE)
    try:
        for policy, trials in ((Policy.NONE, FLEET_NONE_TRIALS),
                               (Policy.ABFT, FLEET_MP_TRIALS),
                               (Policy.CKPT, FLEET_MP_TRIALS)):
            verdict(mp, "fleet_mp", policy, "weights", trials)
    finally:
        mp.close()
    if any(r.handle.proc.is_alive() for r in mp.fleet.replicas):
        failed.append("fleet_mp: a worker outlived its case")
    out["campaign"] = rows


def phase_fleet(cfg, params, card: str) -> dict:
    """Slice 12: the dependable serving fleet at full width (SmolLM-135M
    with its depth cut to FLEET_LAYERS of 30 layers since slice 13, W8A8
    FFN, bf16, flash prefill, capacity 8, 12 requests of 16 new
    tokens, prompts of 8-512 tokens): (1) NONE, 3 replicas in process,
    streams equal to one Engine's; (2) ABFT under PolicyMap.uniform(ABFT),
    a weight strike on replica 0 detected, restored incrementally onto the
    card and readmitted; (3) DMR, a token-buffer strike detected and
    replayed; (4) CKPT, a KV-cache strike rolled back in place; (5) a
    replica killed mid-decode; (6) a rolling deploy to seed-1 params, and a
    strike on replica 0 while replica 1 is mid-swap; (7) the proc
    transport, 2 workers on the card, clean and with a worker SIGKILLed;
    (8) the fleet and fleet_mp campaigns; every healed stream equal to the
    clean one, rows 4, 5 and 9 launched as derived on the clean runs; (9)
    tokens/s and ms per tick per policy (median of FLEET_ROUNDS), recovery
    seconds, proc against in-process ms per tick, peak memory, the seconds
    each step took.  Launch counts are reset at its start and read at its
    end."""
    from repro_torch import tree
    from repro_torch.core import fault_injection as fi
    from repro_torch.core.dependability import Policy
    from repro_torch.core.policy_map import PolicyMap
    from repro_torch.fleet import ReplicaState
    from repro_torch.models import api

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fcfg, prompts = fleet_setup(cfg)
    # the first FLEET_LAYERS layers at full width: views of the main
    # path's stacked weights
    fcfg = dataclasses.replace(fcfg, n_layers=FLEET_LAYERS)
    params = {**params, "dense_blocks": {
        k: v[:FLEET_LAYERS] for k, v in params["dense_blocks"].items()}}
    failed, out = [], {"card": card, "steps_s": {}, "layers": FLEET_LAYERS}
    t_step = [t_phase]

    def step_done(label):
        now = time.perf_counter()
        out["steps_s"][label] = now - t_step[0]
        t_step[0] = now

    golden = _fleet_golden(fcfg, params, prompts)
    _reset_all_launches()
    fleets = []
    step_done("golden")

    def healed(label, streams, run, **want):
        m = run["metrics"]
        ok = streams == golden and all(m[k] >= v for k, v in want.items())
        print(f"fleet: {label}: streams equal clean: {streams == golden}; "
              + ", ".join(f"{k} {m[k]}" for k in ("detections", "recoveries",
                                                  "incremental_restores",
                                                  "state_rollbacks",
                                                  "failovers"))
              + f"; recovery_mean_seconds {m['recovery_mean_seconds']}"
              + ("" if ok else "  FAILED"))
        if not ok:
            failed.append(label)
        out.setdefault("drills", {})[label] = {
            k: run[k] for k in ("seconds", "ticks", "ms_per_tick")}
        out["drills"][label]["metrics"] = m
        return ok

    try:
        plain = _fleet(fcfg, params)
        abft = _fleet(fcfg, params, policy=Policy.ABFT,
                      policy_map=PolicyMap.uniform("abft"))
        fleets += [plain, abft]
        # (1)-(4) clean runs, FLEET_ROUNDS rounds interleaving the policies
        clean = {"none": (plain, Policy.NONE, "qmatmul_acc"),
                 "abft": (abft, Policy.ABFT, "qmatmul_acc_checksum"),
                 "dmr": (plain, Policy.DMR, "qmatmul_acc"),
                 "ckpt": (plain, Policy.CKPT, "qmatmul_acc")}
        rounds = {name: [] for name in clean}
        for _ in range(FLEET_ROUNDS):
            for name, (fleet, policy, row) in clean.items():
                streams, run = _fleet_serve(fleet, prompts, policy)
                want = _derived_fleet_launches(fcfg, run, row)
                if streams != golden:
                    failed.append(f"clean {name}: streams differ from the "
                                  f"Engine's")
                if run["launches"] != want:
                    failed.append(f"clean {name}: launches "
                                  f"{run['launches']}, derived {want}")
                if run["metrics"]["detections"]:
                    failed.append(f"clean {name}: a false alarm")
                rounds[name].append(run)
        timing = {}
        for name, runs in rounds.items():
            ms = statistics.median(r["ms_per_tick"] for r in runs)
            tps = statistics.median(r["tokens_per_s"] for r in runs)
            r0 = runs[0]
            timing[name] = {
                "ms_per_tick": ms, "tokens_per_s": tps,
                "ms_per_tick_rounds": [r["ms_per_tick"] for r in runs],
                "ticks": r0["ticks"], "engine_steps": r0["engine_steps"],
                "decode_steps": r0["decode_steps"],
                "prefills": r0["prefills"], "launches": r0["launches"]}
            print(f"fleet: clean {name:4s} {FLEET_REPLICAS} replicas: "
                  f"streams equal one Engine's, no alarm; {ms:.2f} ms/tick, "
                  f"{tps:.1f} tokens/s (median of {FLEET_ROUNDS}; rounds "
                  + ", ".join(f"{r['ms_per_tick']:.2f}" for r in runs)
                  + f" ms/tick); {r0['ticks']} ticks, {r0['decode_steps']} "
                  f"decode steps, {r0['prefills']} prefills; launches "
                  f"{ {k: v for k, v in r0['launches'].items() if v} } "
                  f"= derived")
        out["clean"] = timing
        step_done("clean")

        # (2) ABFT: a weight strike on replica 0, restored incrementally
        def strike_weights(f):
            f.strike(0, "weights", fi.flip_one_bit, _strike_gen("weights"))

        streams, run = _fleet_serve(abft, prompts, Policy.ABFT,
                                    mid_run=strike_weights)
        healed("abft weight strike", streams, run, detections=1,
               recoveries=1, incremental_restores=1)
        devices = {str(t.device) for r in abft.replicas
                   for t in tree.leaves(r.engine.params)}
        healthy = all(r.state is ReplicaState.HEALTHY for r in abft.replicas)
        print(f"fleet: after the restore every replica healthy: {healthy}; "
              f"parameter leaves on {sorted(devices)}")
        if devices != {str(abft.device)} or not healthy \
                or abft.device.type != torch.device(DEVICE).type:
            failed.append(f"abft restore: leaves on {devices}, healthy "
                          f"{healthy}")

        # (3) DMR: a token-buffer strike, detected by the pair and replayed
        streams, run = _fleet_serve(
            plain, prompts, Policy.DMR, mid_run=lambda f: f.strike(
                0, "decode_state", fi.flip_one_bit,
                _strike_gen("decode_state")))
        healed("dmr decode_state strike", streams, run, detections=1,
               failovers=1)
        # (4) CKPT: a KV-cache strike, rolled back in place
        streams, run = _fleet_serve(
            plain, prompts, Policy.CKPT, mid_run=lambda f: f.strike(
                0, "kv_cache", fi.flip_one_bit, _strike_gen("kv_cache")))
        healed("ckpt kv_cache strike", streams, run, detections=1,
               state_rollbacks=1)
        # (5) a replica killed mid-decode: bit-exact failover
        streams, run = _fleet_serve(plain, prompts, Policy.NONE,
                                    mid_run=lambda f: f.kill_replica(0))
        healed("kill replica 0", streams, run, failovers=1)
        plain.close()
        step_done("drills")

        # (6) rolling deploys under the ABFT map: to seed-1 params, then a
        # strike on replica 0 while replica 1 is mid-swap
        pb = api.init_params(fcfg, torch.Generator().manual_seed(1),
                             device=DEVICE)
        golden_b = _fleet_golden(fcfg, pb, prompts)
        streams, run = _fleet_serve(abft, prompts, Policy.ABFT,
                                    deploy={"params": pb})
        s = run["summary"]
        ok = (None not in streams and streams != golden
              and s["swapped"] == list(range(FLEET_REPLICAS))
              and not s["failed"] and s["changed"] > 0
              and run["metrics"]["detections"] == 0)
        post, _ = _fleet_serve(abft, prompts, Policy.ABFT)
        ok = ok and post == golden_b
        print(f"fleet: rolling deploy to seed-1 params mid-serve: "
              f"{s['changed']} leaves changed, swapped {s['swapped']}, "
              f"every request released, no alarm; afterwards the streams "
              f"equal one Engine's on the new params: {post == golden_b} "
              f"({run['seconds']:.2f} s)" + ("" if ok else "  FAILED"))
        if not ok:
            failed.append("rolling deploy")
        struck = []

        def mid_swap(rid):
            if rid == 1 and not struck:
                struck.append(rid)
                abft.strike(0, "weights", fi.flip_one_bit,
                            _strike_gen("deploy"))

        streams, run = _fleet_serve(abft, prompts, Policy.ABFT,
                                    deploy={"params": pb,
                                            "mid_swap": mid_swap})
        kinds = [e.kind for e in abft.event_log]
        ok = (streams == golden_b and struck
              and run["metrics"]["detections"] >= 1
              and run["metrics"]["recoveries"] >= 1
              and all(r.state is ReplicaState.HEALTHY and r.routable
                      for r in abft.replicas)
              and "strike" in kinds and "recovery" in kinds
              and kinds.index("deploy_start") < kinds.index("strike"))
        print(f"fleet: mid-swap strike on replica 0: detections "
              f"{run['metrics']['detections']}, recoveries "
              f"{run['metrics']['recoveries']}, streams equal clean: "
              f"{streams == golden_b}, every replica healthy and routable"
              + ("" if ok else "  FAILED"))
        if not ok:
            failed.append("mid-swap strike")
        out["deploy"] = {"metrics": run["metrics"],
                         "seconds": run["seconds"]}
        abft.close()
        del pb
        step_done("deploy")

        # (7) the proc transport: 2 workers on the card
        t0 = time.perf_counter()
        proc = _fleet(fcfg, params, n_replicas=2, transport="proc")
        fleets.append(proc)
        spawn_s = time.perf_counter() - t0
        # a cold pass (each worker's first steps load its kernels and
        # cuBLAS), then FLEET_PROC_ROUNDS timed ones
        p_runs = []
        same = True
        for _ in range(1 + FLEET_PROC_ROUNDS):
            streams, run = _fleet_serve(proc, prompts, Policy.NONE)
            same = same and streams == golden
            p_runs.append(run)
        cold, timed = p_runs[0], p_runs[1:]
        p_ms = statistics.median(r["ms_per_tick"] for r in timed)
        p_step_ms = statistics.median(
            r["seconds"] * 1e3 / max(r["engine_steps"], 1) for r in timed)
        streams, k_run = _fleet_serve(
            proc, prompts, Policy.NONE,
            mid_run=lambda f: f.replicas[0].handle.proc.kill())
        ok = (same and streams == golden
              and all(r.state is ReplicaState.HEALTHY for r in proc.replicas)
              and k_run["metrics"]["recoveries"] >= 1)
        proc.close()
        alive = [r.handle.proc.is_alive() for r in proc.replicas]
        inproc = timing["none"]
        out["proc"] = {
            "spawn_s": spawn_s, "ms_per_tick": p_ms,
            "ms_per_tick_rounds": [r["ms_per_tick"] for r in timed],
            "cold_ms_per_tick": cold["ms_per_tick"],
            "ms_per_engine_step": p_step_ms,
            "inproc_ms_per_engine_step": inproc["ms_per_tick"]
            * inproc["ticks"] / max(inproc["engine_steps"], 1),
            "sigkill_seconds": k_run["seconds"],
            "recovery_mean_seconds":
                k_run["metrics"]["recovery_mean_seconds"]}
        print(f"fleet: proc transport, 2 workers on the card (started in "
              f"{spawn_s:.1f} s): clean streams equal the in-process "
              f"fleet's: {same}; with worker 0 SIGKILLed mid-decode: "
              f"{streams == golden} (respawned, {k_run['seconds']:.1f} s); "
              f"{p_ms:.2f} ms/tick over 2 workers (median "
              f"of {FLEET_PROC_ROUNDS}; the cold first pass "
              f"{cold['ms_per_tick']:.2f}), "
              f"{out['proc']['ms_per_engine_step']:.2f} ms per engine step "
              f"against {out['proc']['inproc_ms_per_engine_step']:.2f} in "
              f"process; workers alive after close: {alive}"
              + ("" if ok and not any(alive) else "  FAILED"))
        if not ok or any(alive):
            failed.append("proc transport")
        step_done("proc")

        # (8) the fleet campaigns
        _fleet_campaigns(failed, out)
        step_done("campaigns")
    finally:
        for f in fleets:
            f.close()

    launches = _campaign_launches()
    print(f"fleet: launches {launches}")
    if any(launches[name] == 0 for name in FLEET_ROWS):
        failed.append(f"a row of the path never launched: {launches}")
    out["launches"] = launches
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print("fleet: seconds by step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["steps_s"].items()))
    print(f"fleet: peak memory {out['peak_bytes'] / 2**30:.2f} GiB; phase in "
          f"{secs:.1f} s (budget {FLEET_BUDGET_S} s) on {card}")
    if secs > FLEET_BUDGET_S:
        failed.append(f"fleet phase took {secs:.1f} s")
    if failed:
        raise AssertionError("fleet: " + "; ".join(failed))
    return out


# slice 12: the embedding-input models
EMBED_MUSICGEN_S = 1500            # 30 s of audio at EnCodec's 50 frames/s
EMBED_LLAVA_S = 2880               # anyres: 5 tiles x 576 patches
EMBED_LLAVA_LAYERS = 4             # depth cut: 4 of 60 layers, full width
EMBED_MUSICGEN_LAYERS = 24         # depth cut: 24 of 48 layers, full width
EMBED_STEPS = 16                   # decode steps after each prefill
EMBED_ROWS = ("qmatmul_acc", "flash_attention_fwd_lse")
EMBED_BUDGET_S = 180               # the phase's share of the limit


def _embed_serve(cfg, params, embeds, steps):
    """``prefill(embeds=)`` then ``decode_step(embed=)`` with the step
    embeddings; returns the greedy tokens, the logits, prefill ms and
    decode ms per step (host clock) and the launches of the run."""
    from repro_torch.models import api
    before = _campaign_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, params, None,
                                embeds.shape[1] + len(steps), embeds=embeds)
    tokens = [torch.argmax(logits[:, -1], dim=-1)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [logits[:, -1]]
    for e in steps:
        lg, cache = api.decode_step(cfg, params, None, cache, embed=e)
        tokens.append(torch.argmax(lg, dim=-1))
        out.append(lg)
    stream = torch.stack(tokens, dim=1).cpu().tolist()
    t2 = time.perf_counter()
    after = _campaign_launches()
    return stream, torch.stack(out), {
        "prefill_ms": (t1 - t0) * 1e3,
        "decode_ms_per_step": (t2 - t1) * 1e3 / len(steps),
        "launches": {k: after[k] - before[k] for k in after}}


def _embed_model(name, cfg, depth, gen, failed):
    """One embedding-input model at full width: prefill + EMBED_STEPS
    decode steps under the ``cuda`` and ``ref`` backends (streams equal,
    logits finite, rows 4 and 9 launched as derived), then row 9 against
    its plain version at the model's attention shape."""
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    from repro_torch.models import api
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s = EMBED_MUSICGEN_S if name == "musicgen-large" else EMBED_LLAVA_S
    embeds = torch.randn((1, s, cfg.d_model), generator=gen,
                         device=DEVICE)
    steps = [torch.randn((1, cfg.d_model), generator=gen, device=DEVICE)
             for _ in range(EMBED_STEPS)]
    api.prefill(cfg, params, None, 64, embeds=embeds[:, :64])   # warm up
    runs, logits = {}, {}
    for backend in ("cuda", "ref"):
        bcfg = api.with_backend(cfg, backend)
        stream, logits[backend], runs[backend] = _embed_serve(
            bcfg, params, embeds, steps)
        runs[backend]["stream"] = stream
    L = cfg.n_layers
    want = {"cuda": 3 * L * (1 + EMBED_STEPS), "ref": 0}
    finite = bool(torch.isfinite(logits["cuda"]).all())
    same = runs["cuda"]["stream"] == runs["ref"]["stream"]
    bit_equal = torch.equal(logits["cuda"], logits["ref"])
    launched = all(runs[b]["launches"]["qmatmul_acc"] == want[b]
                   and runs[b]["launches"]["flash_attention_fwd_lse"] == L
                   for b in runs)
    # row 9 at the model's shape, and at a length off the 64-row tiles
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    ratio = 0.0
    for length in sorted({s, s - 37}):
        q = torch.randn((1, H, length, hd), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        k, v = (torch.randn((1, KV, length, hd), generator=gen,
                            device=DEVICE).to(torch.bfloat16)
                for _ in range(2))
        got = FK.flash_attention_fwd_lse(q, k, v)
        ref = FR.flash_plain(q, k, v, emit="lse")
        ratio = max(ratio, _flash_err(got[0], ref[0], torch.bfloat16)[1],
                    _flash_err(got[1], ref[1], torch.float32)[1])
    ok = finite and same and launched
    r = runs["cuda"]
    print(f"embed: {name} ({depth}, d {cfg.d_model}, {H}/{KV} heads of "
          f"{hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
          f"W8A8 FFN, params in {init_s:.1f} s: prefill(embeds=) B 1 x S "
          f"{s} {r['prefill_ms']:.2f} ms, decode {r['decode_ms_per_step']:.2f}"
          f" ms/step; logits finite: {finite}; greedy streams cuda == ref: "
          f"{same} (logits bit-equal: {bit_equal}); launches cuda "
          f"{ {k: v for k, v in r['launches'].items() if v} }, ref "
          f"{ {k: v for k, v in runs['ref']['launches'].items() if v} } "
          f"= derived: {launched}; fwd_lse against flash_plain at S "
          f"{sorted({s, s - 37})}: worst error / limit {ratio:.4f}"
          + ("" if ok else "  FAILED"))
    if not ok:
        failed.append(name)
    return {"layers": L, "seq": s, "init_s": init_s,
            "prefill_ms": r["prefill_ms"],
            "decode_ms_per_step": r["decode_ms_per_step"],
            "ref_prefill_ms": runs["ref"]["prefill_ms"],
            "ref_decode_ms_per_step": runs["ref"]["decode_ms_per_step"],
            "launches": r["launches"], "streams_equal": same,
            "logits_bit_equal": bit_equal, "flash_ratio": ratio}


def phase_embed(card: str) -> dict:
    """Slice 12: the embedding-input models at full width, W8A8 FFN, bf16,
    flash prefill: musicgen-large with its depth cut to 24 of 48 layers
    (EMBED_MUSICGEN_LAYERS) at B 1 x S 1500,
    llava-next-34b with its depth cut to 4 of 60 layers at S 2880, each a
    prefill(embeds=) and 16 decode_step(embed=) steps under the ``cuda``
    and ``ref`` backends (``_embed_model``).  Launch counts are reset at
    its start and read at its end."""
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    full = registry.get("llava-next-34b").n_layers
    models = {
        "musicgen-large": (dataclasses.replace(
            registry.get("musicgen-large"), n_layers=EMBED_MUSICGEN_LAYERS),
            f"depth cut to {EMBED_MUSICGEN_LAYERS} of "
            f"{registry.get('musicgen-large').n_layers} layers"),
        "llava-next-34b": (dataclasses.replace(
            registry.get("llava-next-34b"), n_layers=EMBED_LLAVA_LAYERS),
            f"depth cut to {EMBED_LLAVA_LAYERS} of {full} layers"),
    }
    for name, (cfg, depth) in models.items():
        cfg = dataclasses.replace(cfg, quant="w8a8_ffn", attn_impl="flash")
        out[name] = _embed_model(name, cfg, depth, gen, failed)
        out[name]["depth"] = depth
        torch.cuda.empty_cache()
    launches = _campaign_launches()
    print(f"embed: launches {launches}")
    if any(launches[n] == 0 for n in EMBED_ROWS):
        failed.append(f"a row of the path never launched: {launches}")
    out["launches"] = launches
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"embed: phase in {secs:.1f} s (budget {EMBED_BUDGET_S} s) on "
          f"{card}")
    if secs > EMBED_BUDGET_S:
        failed.append(f"embed phase took {secs:.1f} s")
    if failed:
        raise AssertionError("embed: " + "; ".join(failed))
    return out


# slice 13: the selective-hardening DSE on the card
DSE_BATCH = 8                      # decode batch of the serving oracle
DSE_STEPS = 4                      # decode steps per timed window
DSE_REPS = 1                       # timed windows per variant and round
DSE_ROUNDS = 2                     # interleaved rounds (per-variant minimum)
DSE_SHIPDET_REPS = 30              # timed calls per conv layer and policy
# generations, population, trials per site and genome; certify runs the
# CLI's own 150 trials per site
DSE_SEARCH = {"serving": (2, 6, 20), "shipdet": (1, 4, 64)}
DSE_COMPARE_TRIALS = 4             # ref == cuda trials per site
DSE_ROWS = ("qconv2d_acc", "qconv2d_acc_checksum", "qmatmul_acc",
            "qmatmul_acc_checksum")
DSE_BUDGET_S = 270                 # the phase's share of the limit


def _dse_window_launches(key, n_layers, steps):
    """Row 4 and row 5 launches of one decode window of ``steps`` steps
    under a single-site map (``key`` = (site, policy)), as the code makes
    them: an unmapped FFN site launches row 4 once per layer; ABFT and
    CKPT row 5 once (clean, no recompute); DMR row 4 twice; TMR thrice."""
    per = {"abft": (0, 1), "ckpt": (0, 1), "dmr": (2, 0), "tmr": (3, 0)}
    site, pol = key
    if site == "__base__":
        r4, r5 = 3, 0              # three plain sites
    else:
        r4, r5 = per[pol]
        r4 += 2                    # the two other sites, plain
    return {"qmatmul_acc": r4 * n_layers * steps,
            "qmatmul_acc_checksum": r5 * n_layers * steps}


def _dse_oracle(cfg, params, failed):
    """The cost oracle at full width on the card: every window once with
    its launches counted (as derived) and its tokens against the unmapped
    window's, ``ref`` against ``cuda`` on two windows, then
    ``measure_serving`` (launches as derived in total) and
    ``measure_shipdet(reduced=False)`` at ``network_specs(194)``."""
    from repro_torch.dse import cost
    from repro_torch.models import api
    L = cfg.n_layers
    # 1. each window once: launches and tokens
    variants, _ = cost._windows(cfg, params, batch=DSE_BATCH, seed=0,
                                n_steps=DSE_STEPS, device=DEVICE)
    emitted, launch_ok = {}, True
    for key, run in variants.items():
        _reset_all_launches()
        emitted[key] = run(api.init_cache(cfg, DSE_BATCH, cost.MAX_LEN,
                                          device=DEVICE)).cpu()
        got = {k: v for k, v in _campaign_launches().items() if v}
        want = {k: v for k, v in _dse_window_launches(
            key, L, DSE_STEPS).items() if v}
        if got != want:
            launch_ok = False
            failed.append(f"window {key} launched {got}, derived {want}")
    base = emitted[("__base__", "none")]
    same = all(torch.equal(e, base) for e in emitted.values())
    if not same:
        failed.append("a mapped window's tokens differ from the unmapped")
    # 2. ref == cuda on the base window and one ABFT window
    rcfg = api.with_backend(cfg, "ref")
    rvars, _ = cost._windows(rcfg, params, batch=DSE_BATCH, seed=0,
                             n_steps=DSE_STEPS, device=DEVICE)
    _reset_all_launches()
    ref_equal = all(
        torch.equal(rvars[k](api.init_cache(rcfg, DSE_BATCH, cost.MAX_LEN,
                                            device=DEVICE)).cpu(),
                    emitted[k])
        for k in (("__base__", "none"), ("ffn.wg", "abft")))
    ref_launches = sum(_campaign_launches().values())
    if not ref_equal or ref_launches:
        failed.append(f"ref window: equal {ref_equal}, launches "
                      f"{ref_launches}")
    print(f"dse: windows of {DSE_STEPS} steps at batch {DSE_BATCH}: "
          f"{len(variants)} variants, launches as derived: {launch_ok}; "
          f"mapped tokens == unmapped: {same}; ref == cuda (base, "
          f"ffn.wg=abft): {ref_equal}, ref launches {ref_launches}")
    # 3. the oracle itself
    _reset_all_launches()
    t0 = time.perf_counter()
    serving = cost.measure_serving(cfg, batch=DSE_BATCH, reps=DSE_REPS,
                                   backend="cuda", n_steps=DSE_STEPS,
                                   rounds=DSE_ROUNDS, device=DEVICE,
                                   params=params)
    serving_s = time.perf_counter() - t0
    calls = 1 + DSE_ROUNDS * DSE_REPS
    want = {"qmatmul_acc": 0, "qmatmul_acc_checksum": 0}
    for key in variants:
        for k, v in _dse_window_launches(key, L, DSE_STEPS).items():
            want[k] += calls * v
    got = _campaign_launches()
    oracle_launches = {k: got[k] for k in want}
    if oracle_launches != want:
        failed.append(f"oracle launches {oracle_launches}, derived {want}")
    _reset_all_launches()
    t0 = time.perf_counter()
    shipdet = cost.measure_shipdet(reps=DSE_SHIPDET_REPS, backend="cuda",
                                   reduced=False, device=DEVICE)
    shipdet_s = time.perf_counter() - t0
    n_conv = len(shipdet["layers"])
    per = 1 + DSE_SHIPDET_REPS
    want_conv = {"qconv2d_acc": 6 * n_conv * per,       # none+dmr×2+tmr×3
                 "qconv2d_acc_checksum": 2 * n_conv * per}  # abft, ckpt
    got = _campaign_launches()
    conv_launches = {k: got[k] for k in want_conv}
    if conv_launches != want_conv:
        failed.append(f"shipdet oracle launches {conv_launches}, derived "
                      f"{want_conv}")
    for site, entry in serving["sites"].items():
        print(f"dse: {site} {entry['shape_mkn']} ms/step "
              + " ".join(f"{p} {v:.3f}" for p, v in entry["ms"].items()))
    print(f"dse: scrub ms storage_verify "
          f"{serving['scrub']['storage_verify_ms']:.3f} storage_checksum "
          f"{serving['scrub']['storage_checksum_ms']:.3f}; serving oracle "
          f"{serving_s:.1f} s, launches {oracle_launches} = derived: "
          f"{oracle_launches == want}")
    for name, entry in shipdet["layers"].items():
        print(f"dse: shipdet {name} ms "
              + " ".join(f"{p} {v:.4f}" for p, v in entry["ms"].items()))
    print(f"dse: shipdet oracle {shipdet_s:.1f} s, launches {conv_launches}"
          f" = derived: {conv_launches == want_conv}")
    doc = {"meta": {"arch": cfg.name, "batch": DSE_BATCH, "reps": DSE_REPS,
                    "backend": "cuda", "seed": 0,
                    "device": cost.device_name(DEVICE), "full_width": True},
           "serving": serving, "shipdet": shipdet}
    return doc, {"windows_equal": same, "ref_equal": ref_equal,
                 "window_launches_ok": launch_ok,
                 "oracle_launches": {**oracle_launches, **conv_launches},
                 "serving_s": serving_s, "shipdet_s": shipdet_s}


def _quiet(main, argv):
    """``main(argv)`` with its per-campaign lines kept out of the printed
    output (they are returned, and kept in ``--out``'s JSON): (exit code,
    lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def _dse_compare(space, genes, failed):
    """The best map's cases under ``ref`` and ``cuda``: equal
    ``detected``/``mismatch`` on DSE_COMPARE_TRIALS trials per site."""
    from repro_torch.campaign import faultload as fl
    from repro_torch.core.dependability import Policy
    from repro_torch.dse.fitness import MapServingCase, MapShipdetCase
    pm = space.to_policy_map(tuple(genes[s] for s in space.site_names))
    cases = {}
    for backend in ("ref", "cuda"):
        if space.name == "serving":
            cases[backend] = MapServingCase(0, backend, policy_map=pm,
                                            device=DEVICE)
        else:
            cases[backend] = MapShipdetCase(0, backend, policy_map=pm,
                                            device=DEVICE)
    fault = fl.resolve_fault_model("single_bitflip").apply
    equal = True
    for site in space.campaign_sites:
        policy = Policy(genes[site]) if space.name == "serving" \
            else Policy.NONE
        spec = fl.CampaignSpec(f"compare:{space.name}", policy, site,
                               "single_bitflip", DSE_COMPARE_TRIALS, 0)
        seeds = fl.trial_seeds(spec)
        out = {b: c.run_trials(policy, site, fault, seeds)
               for b, c in cases.items()}
        equal &= all(np.array_equal(a, b)
                     for a, b in zip(out["ref"], out["cuda"]))
    if not equal:
        failed.append(f"{space.name}: ref != cuda on the best map's trials")
    return equal


def phase_dse(cfg, params, card: str) -> dict:
    """Slice 13: the selective-hardening DSE on the card.  The cost oracle
    at full width (``_dse_oracle``: SmolLM-135M in full, W8A8 FFN, batch
    8; ``network_specs(194)``), saved as this card's cost model; then, in
    each space, ``repro_torch.dse.cli search`` (``DSE_SEARCH``,
    the shipdet space's addressed weight rows included) and ``certify`` of
    the best map at the CLI's 150 trials per site, on the ``cuda`` backend,
    into a temporary directory: exit code 0 (SDC = 0 at every site, predicted
    cost below uniform ABFT); the best map's trials equal under ``ref``
    and ``cuda``.  Rows 1, 2, 4 and 5 launched; counts reset at the start,
    read at the end."""
    from repro_torch.dse import cli
    from repro_torch.dse.cost import CostModel
    from repro_torch.dse.space import get_space
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    doc, out["oracle"] = _dse_oracle(cfg, params, failed)
    cm = CostModel(doc)
    for space_name in ("serving", "shipdet"):
        sp = get_space(space_name)
        uniform = {u: cm.predict(space_name, sp.genes(sp.uniform_genome(u)))
                   for u in ("none", "abft", "dmr", "tmr", "ckpt")}
        print(f"dse: {space_name} uniform maps (predicted ms) "
              + " ".join(f"{u} {v:.4f}" for u, v in uniform.items()))
        out[space_name] = {"uniform_ms": uniform}
    _reset_all_launches()
    with tempfile.TemporaryDirectory(prefix="dse_") as tmp:
        cm_path = cm.save(os.path.join(tmp, "cost_model.json"))
        for space_name in ("serving", "shipdet"):
            sp = get_space(space_name)
            gens, pop, n_search = DSE_SEARCH[space_name]
            d = os.path.join(tmp, space_name)
            common = ["--space", space_name, "--out", d, "--cost-model",
                      str(cm_path), "--device", DEVICE, "--backend", "cuda"]
            t0 = time.perf_counter()
            rc_s, log_s = _quiet(cli.main, [
                "search", *common, "--generations", str(gens),
                "--population", str(pop), "--trials", str(n_search),
                "--ci-halfwidth", "0", "--no-journal"])
            search_s = time.perf_counter() - t0
            with open(os.path.join(d, "pareto.json")) as f:
                pareto = json.load(f)
            bench = os.path.join(d, "BENCH_dse.json")
            t0 = time.perf_counter()
            rc_c, log_c = _quiet(cli.main, ["certify", *common,
                                            "--bench-out", bench])
            certify_s = time.perf_counter() - t0
            with open(bench) as f:
                b = json.load(f)
            genes = pareto["best"]["genes"]
            equal = _dse_compare(sp, genes, failed)
            ok = rc_s == 0 and rc_c == 0 and equal
            print(f"dse: {space_name} search {search_s:.1f} s (exit {rc_s},"
                  f" {pareto['evaluations']} genomes, campaigns_run "
                  f"{pareto['meta']['campaigns_run']}), best {genes}; "
                  f"certify {certify_s:.1f} s exit {rc_c}: sdc_max "
                  f"{b['certify']['sdc_max']} over {b['certify']['trials']} "
                  f"trials, cost {b['cost']['best_ms']:.4f} ms vs uniform "
                  f"ABFT {b['cost']['uniform_abft_ms']:.4f} ms (ratio "
                  f"{b['cost']['vs_uniform_abft']}); ref == cuda on "
                  f"{DSE_COMPARE_TRIALS} trials per site: {equal}"
                  + ("" if ok else "  FAILED"))
            if not ok:
                failed.append(f"{space_name}: search exit {rc_s}, certify "
                              f"exit {rc_c}, ref == cuda {equal}")
            out[space_name].update(
                genes=genes, search_s=search_s, certify_s=certify_s,
                campaigns_run=pareto["meta"]["campaigns_run"],
                evaluations=pareto["evaluations"],
                certify=b["certify"], cost=b["cost"],
                exit_codes=[rc_s, rc_c], ref_equal=equal,
                log=log_s + log_c)
    launches = _campaign_launches()
    out["search_launches"] = launches
    print(f"dse: search and certify launches {launches}")
    if any(launches[n] == 0 for n in DSE_ROWS):
        failed.append(f"a row of the DSE never launched: {launches}")
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"dse: phase in {secs:.1f} s (budget {DSE_BUDGET_S} s) on {card}")
    if secs > DSE_BUDGET_S:
        failed.append(f"dse phase took {secs:.1f} s")
    if failed:
        raise AssertionError("dse: " + "; ".join(failed))
    return out


# slice 13: the recurrent families
REC_PROMPTS = (8, 40, 200, 512)    # prompt lengths served by both families
REC_GRIFFIN_LONG = 2560            # past recurrentgemma's 2048 window
REC_GRIFFIN_LAYERS = 8             # depth cut: 2 super-blocks + 2 tail
REC_CAPACITY = 4
REC_MAX_NEW = 8
REC_CHECK_PROMPT = 64              # prefill + REC_CHECK_STEPS vs forward
REC_CHECK_STEPS = 16
REC_TOL = 1e-4                     # f32 logits the engine samples from
                                   # (prefill's last, each decode step):
                                   # max |err| / max |logit|
REC_BUDGET_S = 60                  # the phase's share of the limit


def _rec_serve(cfg, params, prompts, max_len, one_at_a_time=False,
               strike=None, **kw):
    """Serve ``prompts`` through an Engine of capacity REC_CAPACITY (all
    at once, or one request at a time); ``strike(eng)`` after the third
    pump.  Returns (streams, engine, seconds)."""
    from repro_torch.runtime.serving import Engine, Request
    eng = Engine(cfg, params, capacity=REC_CAPACITY, max_len=max_len, **kw)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=REC_MAX_NEW)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    groups = [[r] for r in reqs] if one_at_a_time else [reqs]
    for group in groups:
        for r in group:
            eng.submit(r)
        steps = 0
        while eng.executor.busy():
            eng.step()
            steps += 1
            if steps == 3 and strike is not None:
                strike(eng)
    torch.cuda.synchronize()
    return [tuple(r.output) for r in reqs], eng, time.perf_counter() - t0


def _rec_model(name, cfg, depth, gen, failed):
    """One recurrent family on the card: the sampled logits of prefill +
    decode against forward in f32 and a bf16 control, the bf16 Engine
    against one-request-at-a-time serving, a state strike healed under
    rollback, no kernel launched; times."""
    from repro_torch.core import fault_injection as fi
    from repro_torch.models import api
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # 1. the logits the engine samples from, prefill's last and each decode
    # step's, against forward over the whole sequence, normwise: f32 (TF32
    # off) within REC_TOL; a bf16 control must miss it.  Earlier prefill
    # positions are not held: f32 itself strays there, in forward as much
    # as in prefill (PERF.md; ``python -m repro_torch.models.witness``)
    n = REC_CHECK_PROMPT + REC_CHECK_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                         device=DEVICE)
    P = REC_CHECK_PROMPT

    def sampled(c):
        with torch.no_grad():
            lg, cache = api.prefill(c, params, toks[:, :P], n)
            got = [lg[0, -1:]]
            for t in range(P, n):
                step, cache = api.decode_step(c, params, toks[:, t], cache)
                got.append(step)
        return torch.cat(got).float()
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        full = api.forward(f32, params, toks).logits[0, P - 1:]
    scale = float(full.abs().max())
    rel = float((sampled(f32) - full).abs().max()) / scale
    rel_bf16 = float((sampled(cfg) - full).abs().max()) / scale
    ratio = rel / REC_TOL
    control_misses = rel_bf16 > REC_TOL
    # 2. the Engine (bf16), all at once against one request at a time
    lengths = REC_PROMPTS + ((REC_GRIFFIN_LONG,) if cfg.family == "hybrid"
                             else ())
    prompts = [torch.randint(0, cfg.vocab_size, (s,), generator=gen,
                             device=DEVICE).tolist() for s in lengths]
    max_len = max(lengths) + REC_MAX_NEW + 1
    with torch.no_grad():
        _rec_serve(cfg, params, prompts[:1], max_len)         # warm up
        batched, eng, serve_s = _rec_serve(cfg, params, prompts, max_len)
        alone, _, _ = _rec_serve(cfg, params, prompts, max_len,
                                 one_at_a_time=True)
    same = batched == alone
    steps = eng.stats.steps
    # prefill ms at the longest prompt, decode ms/step at full capacity
    longest = prompts[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        api.prefill(cfg, params, torch.tensor([longest], device=DEVICE),
                    len(longest) + 1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    bc = api.init_cache(cfg, REC_CAPACITY, 64, device=DEVICE)
    tok = torch.zeros((REC_CAPACITY,), dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        api.decode_step(cfg, params, tok, bc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REC_CHECK_STEPS):
            _, bc = api.decode_step(cfg, params, tok, bc)
        torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / REC_CHECK_STEPS
    # 3. a strike on the recurrent state under rollback heals
    leaf = ("tm_s",) if cfg.family == "rwkv" else ("h",)

    def strike(e):
        e.strike("kv_cache", lambda x, g: fi.flip_bit_at_index(
            x, 12345 % x.numel(), 30), None, leaf=leaf)
    short = prompts[:REC_CAPACITY]
    with torch.no_grad():
        clean, _, _ = _rec_serve(cfg, params, short, max_len,
                                 snapshot_every=2, state_scrub="rollback")
        healed, seng, _ = _rec_serve(cfg, params, short, max_len,
                                     strike=strike, snapshot_every=2,
                                     state_scrub="rollback")
    ev = seng.drain_state_events()
    heal_ok = healed == clean == batched[:REC_CAPACITY] \
        and len(ev) == 1 and ev[0]["recovered"]
    ok = ratio <= 1.0 and control_misses and same and heal_ok
    print(f"recurrent: {name} ({depth}, d {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}), params in {init_s:.1f} s; prefill "
          f"{P} + {REC_CHECK_STEPS} decode steps against forward at S "
          f"{n}, the {REC_CHECK_STEPS + 1} sampled positions: max |err| / "
          f"max |logit| {scale:.3f} f32 {rel:.3e} (limit {REC_TOL:.0e}), "
          f"bf16 control {rel_bf16:.3e} (misses the limit: "
          f"{control_misses});"
          f" Engine capacity {REC_CAPACITY}, prompts {list(lengths)}, "
          f"{REC_MAX_NEW} new: streams == one request at a time: {same} "
          f"({steps} steps, {serve_s:.2f} s); rollback heals the {leaf[0]} "
          f"strike: {heal_ok} ({len(ev)} event); prefill S "
          f"{len(longest)} {prefill_ms:.2f} ms, decode "
          f"{decode_ms:.2f} ms/step at batch {REC_CAPACITY}"
          + ("" if ok else "  FAILED"))
    if not ok:
        failed.append(name)
    return {"init_s": init_s, "logits_ratio": ratio, "logits_rel": rel,
            "bf16_control_rel": rel_bf16, "streams_equal": same,
            "healed": heal_ok, "prefill_ms": prefill_ms,
            "prefill_len": len(longest), "decode_ms_per_step": decode_ms,
            "serve_s": serve_s, "steps": steps}


def phase_recurrent(card: str) -> dict:
    """Slice 13: the recurrent families at full width on the card:
    rwkv6-1.6b in full (24 layers) and recurrentgemma-2b with its depth cut
    to 8 of 26 layers (two 2:1 super-blocks and the two-block recurrent
    tail), each through ``_rec_model``.  No hand kernel serves them (the
    reference runs them as plain jnp): the phase checks that none of rows
    1-10 launched."""
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    full = registry.get("recurrentgemma-2b").n_layers
    models = {
        "rwkv6-1.6b": (registry.get("rwkv6-1.6b"), "24 layers, in full"),
        "recurrentgemma-2b": (dataclasses.replace(
            registry.get("recurrentgemma-2b"), n_layers=REC_GRIFFIN_LAYERS),
            f"depth cut to {REC_GRIFFIN_LAYERS} of {full} layers"),
    }
    for name, (cfg, depth) in models.items():
        out[name] = _rec_model(name, cfg, depth, gen, failed)
        out[name]["depth"] = depth
        torch.cuda.empty_cache()
    launches = _campaign_launches()
    none = not any(launches.values())
    print(f"recurrent: rows 1-10 launched on this path: "
          f"{ {k: v for k, v in launches.items() if v} or 'none'}")
    if not none:
        failed.append(f"a kernel launched on the recurrent path: {launches}")
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"recurrent: phase in {secs:.1f} s (budget {REC_BUDGET_S} s) on "
          f"{card}")
    if secs > REC_BUDGET_S:
        failed.append(f"recurrent phase took {secs:.1f} s")
    if failed:
        raise AssertionError("recurrent: " + "; ".join(failed))
    return out


def _kernel_lines(names, source, replaces, launches, max_err, totals,
                  library):
    return [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": max_err[name], "ms": totals[name]["ms"],
        "plain_ms": totals[name]["plain_ms"],
        "bound_ms": totals[name]["bound_ms"],
        "bound_by": ("bytes" if totals[name]["t_bytes"]
                     >= totals[name]["t_ops"] else "operations"),
        "library_ms": library.get(name),
    } for name in names]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args()

    card = phase_card()
    # the plain versions' f32 products stay f32 (PyTorch's default, set
    # here so that no environment changes it)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.kernels.qmatmul import kernel as MK
    from repro_torch.models import shipdet
    build_s = phase_build([K.build, MK.build, FK.build, FK.build_bwd])
    specs = shipdet.network_specs(194)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    max_err = phase_compare(specs, gen)

    params = shipdet.init_params(specs, torch.Generator().manual_seed(0),
                                 device=DEVICE)
    frames = torch.rand((BATCH, specs[0].h, specs[0].w, 3),
                        generator=torch.Generator().manual_seed(1)).to(DEVICE)
    launches = phase_slice(specs, params, frames)

    cfg, lm_params, prompts = lm_setup()
    max_err.update(phase_compare_matmul(cfg, gen))
    serve_runs, serve_launches = phase_serve(cfg, lm_params, prompts)
    launches.update(serve_launches)
    phase_heal(cfg, lm_params, gen)
    launches["qmatmul"] = phase_qlinear(cfg, gen)

    max_err.update(phase_compare_flash(gen))
    fcfg, fprompts = flash_setup(cfg, lm_params)
    flash_runs, flash_launches = phase_serve_flash(fcfg, lm_params, fprompts)
    launches["flash_attention_fwd_lse"] = \
        flash_launches["flash_attention_fwd_lse"]
    flash_cmp = phase_flash_vs_chunked(cfg, fcfg, lm_params, fprompts,
                                       flash_runs)
    dep_launches = phase_dependable_attention(fcfg, lm_params)
    for name in ("flash_attention", "flash_attention_checked"):
        launches[name] = dep_launches[name]

    max_err.update(phase_compare_flash_bwd(gen))
    tcfg, tshape = train_setup()
    train, train_launches = phase_train(tcfg, tshape)
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    train_grads = phase_train_grads(tcfg, tshape)

    campaign = phase_campaign(card)

    # every CUDA-event timing before the first profiler session
    rows, totals, calls, conv_library = phase_time(specs, gen, max_err)
    mm_rows, mm_calls, mm_lib_calls = phase_time_matmul(cfg, gen, max_err)
    mm_cold, mm_cold_steps, mm_cold_calls = phase_time_matmul_cold(cfg, gen)
    fl_rows, fl_calls = phase_time_flash(gen, max_err)
    prefill_ms = phase_prefill_flash(cfg, fcfg, lm_params)
    bwd_rows, bwd_calls = phase_time_bwd(gen, max_err)
    train_time, train_run = phase_train_time(tcfg, tshape)
    forward = phase_forward(specs, params, frames)
    serving, engines = phase_serve_time(cfg, lm_params, prompts, serve_runs)
    profile = phase_profile(specs, params, frames, rows, calls)
    profile["decode"] = phase_serve_profile(engines)
    mm_cold_dev = matmul_device_times(mm_rows, mm_calls, mm_lib_calls,
                                      mm_cold, mm_cold_steps, mm_cold_calls)

    profile["flash_prefill"] = phase_profile_flash(fcfg, lm_params, fl_rows,
                                                   fl_calls)
    profile["train_step"] = phase_profile_train(train_run, bwd_rows,
                                                bwd_calls)
    # slices 11 and 12 last: no timing or profile above runs after their
    # engines
    dependable = phase_dependable(cfg, lm_params, prompts, card)
    fleet = phase_fleet(cfg, lm_params, card)
    embed = phase_embed(card)
    dse = phase_dse(cfg, lm_params, card)
    recurrent = phase_recurrent(card)

    mm_totals, mm_library = matmul_totals(cfg, mm_rows)
    fl_totals, fl_library = flash_totals(fl_rows)
    bwd_tot, bwd_library = bwd_totals(bwd_rows)
    # the cuDNN f32 conv (not the same function, exact here) as the library
    # time of #1 and #2, per forward
    kernels = _kernel_lines(REPLACES, CONV_SOURCE, REPLACES, launches,
                            max_err, totals, conv_library)
    # torch._int_mm on the decode rows zero-padded to M = 32 as the library
    # time of #4
    kernels += _kernel_lines(MATMUL_REPLACES, MATMUL_SOURCE, MATMUL_REPLACES,
                             launches, max_err, mm_totals, mm_library)
    # attention: one call at (1, 9, 1024, 64)/(1, 3, 1024, 64) bf16;
    # scaled_dot_product_attention as the library time of #7 and #9
    kernels += _kernel_lines(FLASH_REPLACES, FLASH_SOURCE, FLASH_REPLACES,
                             launches, max_err, fl_totals, fl_library)
    # the backward: one call at the training shape (8, 9, 1024, 64) bf16;
    # SDPA's backward as its library time
    kernels += _kernel_lines(BWD_REPLACES, FLASH_BWD_SOURCE, BWD_REPLACES,
                             launches, max_err, bwd_tot, bwd_library)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s,
                       "batch": BATCH, "kernels": kernels, "per_layer": rows,
                       "forward": forward, "profile": profile,
                       "matmul_per_call": mm_rows,
                       "matmul_cold_w": {"events_ms": mm_cold,
                                         "device_ms": mm_cold_dev},
                       "serve": serve_runs,
                       "serving": serving, "attention_per_call": fl_rows,
                       "serve_flash": {k: {kk: vv for kk, vv in v.items()
                                           if kk != "streams"}
                                       for k, v in flash_runs.items()},
                       "flash_vs_chunked": flash_cmp,
                       "prefill_ms": prefill_ms, "train": train,
                       "train_grads": train_grads, "train_time": train_time,
                       "backward_per_call": bwd_rows,
                       "campaign": campaign,
                       "dependable": dependable, "fleet": fleet,
                       "embed": embed, "dse": dse,
                       "recurrent": recurrent}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
