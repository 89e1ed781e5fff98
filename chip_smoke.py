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
   (the loss falls; the training example of 23 is the second clean run
   that must equal it bit for bit, and its SEU drill the unsharded
   recovery that must end on it; 22 drills a NaN in embed[0, 0] at step
   9 on the sharded loop), a run
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
12. slice 11: dependable serving at full width (SmolLM-135M at 4 of its
   30 layers, W8A8 FFN, bf16, flash prefill, capacity 8,
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
   SmolLM-135M at 4 of its 30 layers, W8A8 FFN, bf16,
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
   and decode ms/step; within ``EMBED_BUDGET_S``; then both trained
   (slice 20, ``phase_embed_train``) through ``make_train_step`` with the
   f32 ``embeds`` in the token embedding's place, AdamW, bf16 compute,
   flash attention, rows of 4,096 tokens at the ``TRAIN_POINTS`` the
   port's dry-run chose (musicgen-large in full at 8 rows, llava-next-34b
   at 7 of 60 layers at 1 row): two runs of 3 steps from clones of one
   state with losses ``==`` and final parameters torch.equal, rows 9 and
   10 launched as derived and row 4 never, peak device memory under 70
   GB, the dry-run's predicted rise (``TrainDry``) within 15 % of a
   step's ``max_memory_allocated`` rise; row 10 at each model's attention
   shape against its plain version, rows 9 and 10 there timed beside
   SDPA's forward and backward and their bounds; ms per step, tokens/s;
   within ``EMBED_TRAIN_BUDGET_S``.
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
   seconds, prefill ms and decode ms/step; then each trained from the
   same parameters (``_rec_train``: AdamW, remat save_dots, rows of 4,096
   tokens) at the largest batch of at most 8 rows that the port's dry-run
   puts under 70 GB (``TRAIN_POINTS``; ``TrainDry``: one train step on
   meta at a fake (1, 1) mesh per model, in spawned children started
   after 2): one batch's loss and gradients with remat "none" ``==`` and
   torch.equal to save_dots', two runs of REC_TRAIN_RUN_STEPS steps from
   clones of one state with losses ``==`` and final parameters
   torch.equal, peak device memory under 70 GB, the dry-run's predicted
   rise within 15 % of a step's ``max_memory_allocated`` rise; ms per
   train step and tokens/s; within ``REC_BUDGET_S``.
18. slice 14, the mixture-of-experts transformers (``phase_moe``), weights
   drawn on the card, W8A8 FFN and experts, bf16, flash prefill:
   mixtral-8x7b at full width with 4 of its 32 layers, an ``Engine`` of
   capacity 4 serving 8 requests with prompts of 8–4,608 tokens (one past
   the 4,096 window) and 16 new tokens under ``cuda`` and ``ref`` (streams
   equal; row 4 launched 3·8 times per MoE layer per prefill and decode
   step, row 9 once per layer per prefill), row 9 against its plain
   version at (1, 32, S, 128)/(1, 8, S, 128) with the window, and the
   logits of a 4,608-token prefill and 16 decode steps at batch 4 bit for
   bit equal under ``cuda`` and ``ref``; kimi-k2 at full width with 2 of
   its 61 layers (the dense layer and one MoE layer of 384 experts and a
   shared one), a 512-token prefill and 16 decode steps under ``cuda`` and
   ``ref`` (streams equal, the sampled logits finite and bit for bit
   equal, row 4 3·384 + 3 per MoE layer and 3 per dense layer per call),
   rows 7–10 at head dim 112 against their plain versions, f32 and bf16,
   out equal across rows 7–9; param seconds, prefill ms, decode ms/step, a
   profiled decode step of each model, row 4 per call at the expert
   shapes beside its bound, rows 7–10 beside SDPA; peak device memory
   under 70 GB; within ``MOE_BUDGET_S``.
19. slice 15, the dense transformers no earlier phase drives
   (``phase_dense``), weights drawn on the card, W8A8 FFN, bf16, flash
   prefill: command-r-plus-104b and llama3-405b at full width with 4
   layers each, qwen3-0.6b in full; a 2,048-token prefill and 16 decode
   steps at batch 4 after it (the prompt's cache in every row: each step
   attends to the 2,048 prefilled positions and the steps before) under
   ``cuda`` and ``ref``, their logits bit for bit equal and finite, row 4
   launched 3·L per call and row 9 L per prefill, row 9 against its plain
   version at each prefill's attention shape; then llama3-405b trained at
   full width with 2 of its 126 layers (Adafactor, remat full, batch 1 ×
   1,024): the first Adafactor update of its (2, 16,384, 53,248) FFN leaf
   within one bf16 step of the same rule in float64 on the same gradient,
   two runs of 3 steps from clones of one state, losses ``==`` and
   finite, final parameters torch.equal, row 9 launched 2·L and row 10 L
   per step, row 4 never; row
   10 at (1, 128, 1024, 128)/(1, 8, 1024, 128) bf16 against its plain
   version and timed beside SDPA's backward; param seconds, prefill ms,
   decode ms/step, ms per train step, peak device memory under 70 GB;
   within ``DENSE_BUDGET_S``;
20. slice 15, an MoE model trained (``phase_moe_train``): mixtral-8x7b
   at full width with 2 of its 32 layers (AdamW, its remat, batch 1 ×
   4,608, the last 512 queries past its 4,096 window) through the same
   two runs from clones, after its MoE layer's backward taken 5 times on
   one input, torch.equal each time at top-2 and top-8; row 10 at its
   windowed attention shape against its plain version; peak device memory
   under 70 GB; within ``MOE_TRAIN_BUDGET_S``;
21. slice 16, sharded execution (``phase_shard``) under NCCL at world size
   1 in this process, a (1, 1) ("data", "model") mesh and a ``ShardCtx``
   (every collective a one-rank NCCL call): mixtral-8x7b at full width with
   2 of its 32 layers (W8A8 FFN and experts, bf16, flash, FSDP, EP), a
   4,608-token prefill and 16 decode steps, the logits torch.equal to
   ``ctx=None``; one train run of 3 steps from the host-held start of
   phase 20's two runs, losses ``==`` and parameters torch.equal to its
   first; qwen3-0.6b in full: a 1,024-token prefill, 16 decode steps and a
   train step, each torch.equal to ``ctx=None``; rows 4, 9 and 10 launched
   as often as on the unsharded path; each kind of collective issued as
   often as ``_shard_collectives`` derives from the spec table and the
   code's sums; ms per decode step and per train step with and without the
   ctx; within ``SHARD_BUDGET_S``.
22. slice 17 (``phase_item17``) under NCCL at world size 1: the pipeline
   (``parallel.pipeline.pipeline_apply`` over a one-rank "stage" axis,
   qwen3-0.6b in full, 28 layers, bf16, flash, as the stage, 4
   microbatches of 1 x 1,024 embeddings): outputs and stage gradients
   torch.equal to a plain loop of the same blocks, rows 9 and 10 launched
   as the schedule and its checkpoint's recompute derive; the sharded FT
   loop (``ft_loop.run(mesh=)`` on a (1, 1) mesh, SmolLM-135M in full at
   8 x 1,024, 12 steps, with the NaN drill at step 9): one
   recovery, losses ``==`` the unsharded clean run of 10; the dry-run
   against the card: ``launch.dryrun.run_cell`` on meta at a fake (1, 1)
   mesh in a spawned child, and the same steps for real on the card under
   ``launch.op_analysis`` (qwen3-0.6b in full, a train step at 1 x 1,024;
   mixtral-8x7b at 2 of 32 layers, FSDP, EP, a train step at 1 x 4,608
   from phase 20's start and a W8A8 prefill of 4,608 tokens from the same
   weights quantized): FLOPs by dtype (kernel rows included), collective
   counts and bytes per kind, argument bytes and the tracked peak equal,
   the predicted peak within 15 % of the step's ``max_memory_allocated``
   rise; rows 4, 9 and 10 launched; slice 21's vocabulary split over the
   model axis: qwen3-0.6b in full (flash, AdamW) trained one step at 8 x
   4,096 as rank 0 of a fake (1, 16) process group in a spawned child, on
   the card's tensors (the collectives move nothing: no value is checked),
   against its dry-run on meta: FLOPs by dtype, collective counts (also
   as ``_shard_collectives`` derives them) and bytes, argument bytes and
   the tracked peak equal, the predicted rise within 15 % of the card's,
   rows 9 and 10 launched 56 and 28 times; the (1, 1) dry-run's peak of
   the same step, the vocabulary whole, printed beside it; slice 22's
   tensor parallelism inside the recurrence: recurrentgemma-2b in full
   (AdamW, remat save_dots) trained one step at 16 x 4,096 (train_4k's
   rows per data rank at pod16x16) as rank 0 of a fake (1, 16) group in
   the same child, held to its dry-run the same way, its collectives as
   derived, no kernel launched and its tracked peak under 70 GB a rank,
   printed beside the 84.16 GB of its layers replicated; within
   ``ITEM17_BUDGET_S``.
23. slice 18 (``phase_examples``): each of the seven walkthroughs in
   ``examples/*_torch.py`` through its ``run()`` on the card at full
   width, over what the earlier phases drew (SmolLM-135M, the training
   config and shape, ``network_specs(194)``; qwen3-0.6b drawn on the
   card), each with its launch counts reset before and read after it and
   held to the counts derived from its acts, and its peak device memory
   printed: the quickstart's conv at 194 x 194 and qlinear at (8, 576,
   1536) with every row-3 and row-6 call's operands ``torch.equal``
   through the kernel and its plain version; the ship detector within 4
   output steps of the float path; the campaign's grid (ABFT and TMR SDC
   0, ABFT detecting every single bit flip) and both drills detecting all
   their trials; dependable serving's rolled-back streams equal the clean
   ones and the TMR vote bit-exact; the fleet's four acts on the golden
   stream with one recovery; recovery's CKPT outputs golden, its
   checkpoint chain and both scrubs healed; the training example's clean
   losses ``==`` those of 10 with one recovery onto them; within
   ``EXAMPLES_BUDGET_S``.
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
import gc
import json
import math
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
TRAIN_CKPT_EVERY = 8               # saves at steps 0 and 8 (the resume point)
TRAIN_DRILL_CKPT_EVERY = 5         # the drill saves steps 0 and 5 (of 10)
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


def phase_time_matmul(cfg, gen, max_err, shapes=None,
                      names=MATMUL_REPLACES):
    """CUDA-event times per call of each row in ``names`` at each (M, K, N)
    of ``shapes`` (the FFN shapes by default), beside the plain version,
    the bound and ``torch._int_mm`` (the library yardstick for the
    accumulator, on the decode rows zero-padded to M = 32; the port never
    calls it).  Returns the rows, each row's call and its library call (or
    None), which ``matmul_row_device_times`` times again on the device."""
    rows, calls, lib_calls = [], [], []
    for m, k, n in ffn_shapes(cfg) if shapes is None else shapes:
        case = MatmulCase(gen, m, k, n)
        for name, (kern, plain) in _matmul_kernels().items():
            if name not in names:
                continue
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


def matmul_row_device_times(rows, calls, lib_calls):
    """Device time per call of each matmul row and of its library call, by
    the profiler; each call of rows 4, 5 and 6 must be exactly one device
    op, its kernel.  Fills ``rows`` and prints them."""
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


def matmul_device_times(rows, calls, lib_calls, cold, cold_steps,
                        cold_calls):
    """``matmul_row_device_times``, then each cold step's device time per
    call, by the profiler; each cold call must be one device op, its
    kernel.  Returns the cold device times per call."""
    matmul_row_device_times(rows, calls, lib_calls)
    cold_dev = {}
    for name, run in cold_steps.items():
        ms, ops, names = _device_ops_seen(run, reps=2, per_run=cold_calls)
        if name != "_int_mm" and not (0.9 * cold_calls <= ops <= cold_calls
                                      and len(names) == 1):
            raise AssertionError(f"cold {name}: {ops} device ops per step "
                                 f"of {cold_calls} calls ({sorted(names)})")
        cold_dev[name] = None if ms is None else ms / cold_calls
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


def _hold_flash(label, case, kernels, max_err, ratio):
    """The three forward kernels on ``case`` against their plain versions
    (``_flash_err``), out torch.equal across the three and two launches,
    csum equal to the recomputed bit checksum, the check column within
    1e-4 of rowsum_hd; the worst errors into ``max_err`` (per kernel) and
    ``ratio`` (per dtype)."""
    from repro_torch.core.abft import output_row_checksums
    from repro_torch.kernels.flashattn import kernel as FK
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
        if name in ("flash_attention_fwd_lse", "flash_attention_checked"):
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


def phase_compare_flash(gen) -> dict:
    """Each attention kernel against its plain version on the card; the
    three kernels' out torch.equal to each other and across two launches;
    csum equal to the recomputed bit checksum; the check column within
    1e-4 (rel and abs) of rowsum_hd of the f32 output (for bf16, of the
    f32 kernel on the same values upcast: the check column is kept in f32
    and never sees out's bf16 rounding)."""
    kernels = _flash_kernels()
    max_err = {name: 0.0 for name in FLASH_REPLACES}
    ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = flash_compare_cases(gen)
    for label, case in cases:
        _hold_flash(label, case, kernels, max_err, ratio)
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


def _flash_time_shapes():
    """(B, H, KV, S, hd, window) timed on the main path: the serving shape
    (1, 9, S, 64)/(1, 3, S, 64), S in FLASH_TIME_S, and the training shape
    (8, 9, 1024, 64)/(8, 3, 1024, 64)."""
    return [(1, 9, 3, s, 64, None) for s in FLASH_TIME_S] + \
        [(TRAIN_BATCH, 9, 3, TRAIN_SEQ, 64, None)]


def _shape_text(r):
    window = "" if r["window"] is None else f" window {r['window']}"
    return (f"({r['B']}, {r['H']}, {r['S']}, {r['hd']})/({r['B']}, "
            f"{r['KV']}, {r['S']}, {r['hd']}){window}")


def phase_time_flash(gen, max_err, shapes=None, names=FLASH_REPLACES,
                     reps=50):
    """CUDA-event ms per call of each kernel in ``names`` at each (B, H,
    KV, S, hd, window) of ``shapes`` (``_flash_time_shapes`` by default),
    bf16, beside its plain version, its bound and, for the kernels that
    have one, scaled_dot_product_attention (the library yardstick; the port
    never calls it; none with a window, which it does not take)."""
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                             is_causal=True, enable_gqa=True)
    rows, calls = [], []
    for b, h, kv, s, hd, window in shapes or _flash_time_shapes():
        case = FlashCase(gen, b, h, kv, s, hd, torch.bfloat16, window=window)
        args = case.args()
        for name, (kern, plain) in _flash_kernels().items():
            if name not in names:
                continue
            call = functools.partial(kern, *args, **case.kw)
            plain_call = functools.partial(plain, *args, **case.kw)
            got, want = call(), plain_call()
            g, w = (got, want) if name == "flash_attention" \
                else (got[0], want[0])
            max_err[name] = max(max_err[name],
                                _flash_err(g, w, torch.bfloat16)[0])
            ms = _time_ms(call, reps=reps)
            plain_ms = _time_ms(plain_call, reps=max(2, reps // 5), warmup=1)
            lib = None if window is not None \
                or name == "flash_attention_checked" \
                else functools.partial(sdpa, *args)
            lib_ms = None if lib is None else _time_ms(lib, reps=reps)
            bound, by = case.bound_ms(name)
            rows.append({"B": b, "H": h, "KV": kv, "S": s, "hd": hd,
                         "window": window, "kernel": name, "ms": ms,
                         "device_ms": None, "plain_ms": plain_ms,
                         "bound_ms": bound,
                         "bound_by": by, "library_ms": lib_ms,
                         "library_device_ms": None})
            calls.append((call, lib))
    return rows, calls


def flash_device_times(rows, calls, reps=20):
    """Each forward call's and SDPA's device time from the profiler, filled
    into ``rows``; prints the rows."""
    for row, (call, lib) in zip(rows, calls):
        row["device_ms"] = _device_ms(call, reps=reps, match="flash_fwd")
        if lib is not None:
            row["library_device_ms"] = _device_ms(lib, reps=reps, match=None)
    print("attention kernel times per call, bf16 (CUDA events; device time "
          "from the profiler):")
    for r in rows:
        dev = "n/m" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        lib = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms'] or float('nan'):.4f})")
        print(f"  {_shape_text(r)} {r['kernel']:24s} {r['ms']:8.4f} ms  "
              f"device {dev:>7s} ms  plain {r['plain_ms']:8.3f} ms  bound "
              f"{r['bound_ms']:8.5f} ms ({r['bound_by']})  sdpa {lib}")


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
    and 1024 under torch.profiler; then ``flash_device_times``."""
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
    flash_device_times(rows, calls)
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


def _hold_flash_bwd(label, case, gen, ratio) -> float:
    """Row 10 on ``case`` against its plain version (``_bwd_check``) and
    across two launches; returns the max abs error, the worst error /
    limit into ``ratio`` (per dtype)."""
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    inputs = _bwd_inputs(case, gen)
    got = FK.flash_attention_bwd(*inputs, **case.kw)
    again = FK.flash_attention_bwd(*inputs, **case.kw)
    torch.cuda.synchronize()
    want = FR.flash_bwd_plain(*inputs, **case.kw)
    max_err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}")
        err, r = _bwd_check(g, w, case.dtype)
        max_err = max(max_err, err)
        ratio[case.dtype] = max(ratio[case.dtype], r)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two backward launches differ")
    return max_err


def phase_compare_flash_bwd(gen) -> dict:
    """Row 10 against its plain version on the card, f32 and bf16, at the
    attention compare cases and the training shape (8, 9, 1024, 64)/(8, 3,
    1024, 64); two launches torch.equal; the worst error / limit ratio per
    dtype printed."""
    cases = [(f"train_{tag}", FlashCase(gen, TRAIN_BATCH, 9, 3, TRAIN_SEQ,
                                        64, dt))
             for tag, dt in (("f32", torch.float32),
                             ("bf16", torch.bfloat16))]
    cases += flash_compare_cases(gen)
    max_err, ratio = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, case in cases:
        max_err = max(max_err, _hold_flash_bwd(label, case, gen, ratio))
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
    a clean run of 12 steps (checkpoint every 8; the loss falls; the
    examples phase's training example is a second clean run and an SEU
    drill with one recovery, each held ``==`` to it there, and the item17
    phase's sharded loop recovers from a NaN at step 9 onto it), the clean
    run's directory cut back to its checkpoint at step 8 (a run stopped
    there) and resumed to 12 (bit-identical to the clean run's steps 8-11)
    and an inject_into_pytree drill (finishes with finite losses).
    fwd_lse launches = 2 × n_layers and bwd launches = n_layers per step
    executed: the forward runs once per block and again in its
    recompute."""
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
        # the clean run's checkpoints past TRAIN_RESUME_AT go: what stays
        # is a run stopped there, which resumes to TRAIN_STEPS
        for d in os.listdir(os.path.join(root, "clean")):
            if d.startswith("step_") and \
                    int(d.split("_")[1].split(".")[0]) > TRAIN_RESUME_AT:
                shutil.rmtree(os.path.join(root, "clean", d))
        os.rename(os.path.join(root, "clean"), os.path.join(root, "resume"))
        resumed = go("resume", TRAIN_STEPS)
        shutil.rmtree(os.path.join(root, "resume"))

        fired = {"drill": False}

        def drill_hook(step, state):
            if step == 6 and not fired["drill"]:
                fired["drill"] = True
                return state._replace(params=fi.inject_into_pytree(
                    state.params, torch.Generator().manual_seed(DRILL_SEED),
                    n_flips=3))
            return None

        drill = go("drill", 10, every=TRAIN_DRILL_CKPT_EVERY,
                   hook=drill_hook)
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
    if resumed.losses != losses[TRAIN_RESUME_AT:]:
        raise AssertionError(f"resume: {resumed.losses} against "
                             f"{losses[TRAIN_RESUME_AT:]}")
    if len(drill.losses) != 10 or not np.all(np.isfinite(drill.losses)):
        raise AssertionError(f"bit-flip drill: {drill.losses}")
    drill_clean = drill.losses == losses[:10]
    print(f"  bit identity: the resume equals "
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
        nonlocal state
        state, metrics = step(state, batch)
        float(metrics["loss"])                   # the loop's own readback
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


def phase_time_bwd(gen, max_err, shapes=None, reps=20):
    """CUDA-event ms per call of row 10 at each (B, H, KV, S, hd, window)
    of ``shapes`` (by default (1, 9, 1024, 64) and the training shape (8,
    9, 1024, 64)), bf16, beside its plain version, its bound and SDPA's
    backward (the library yardstick, timed on k/v already expanded to H
    heads so that the flash backend takes it; none with a window; the port
    never calls it)."""
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    rows, calls = [], []
    for b, h, kv, s, hd, window in shapes or [
            (b, 9, 3, TRAIN_SEQ, 64, None) for b in (1, TRAIN_BATCH)]:
        case = FlashCase(gen, b, h, kv, s, hd, torch.bfloat16, window=window)
        inputs = _bwd_inputs(case, gen)
        call = functools.partial(FK.flash_attention_bwd, *inputs, **case.kw)
        plain_call = functools.partial(FR.flash_bwd_plain, *inputs, **case.kw)
        for g, w in zip(call(), plain_call()):
            max_err["flash_attention_bwd"] = max(
                max_err["flash_attention_bwd"],
                _bwd_check(g, w, torch.bfloat16)[0])
        ms = _time_ms(call, reps=reps)
        plain_ms = _time_ms(plain_call, reps=3, warmup=1)
        sdpa_bwd, lib_ms = None, None
        if window is None:
            q, k, v, _, _, do = inputs
            qs, ks, vs = (t.detach().requires_grad_() for t in
                          (q, k.repeat_interleave(h // kv, dim=1),
                           v.repeat_interleave(h // kv, dim=1)))
            out = torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True)

            def sdpa_bwd():
                return torch.autograd.grad(out, (qs, ks, vs), do,
                                           retain_graph=True)
            lib_ms = _time_ms(sdpa_bwd, reps=reps)
        bound, by = case.bwd_bound_ms()
        rows.append({"B": b, "H": h, "KV": kv, "S": s, "hd": hd,
                     "window": window, "kernel": "flash_attention_bwd",
                     "ms": ms, "device_ms": None, "dq_device_ms": None,
                     "dkv_device_ms": None, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                     "library_device_ms": None})
        calls.append((call, sdpa_bwd))
    return rows, calls


def bwd_device_times(rows, calls, reps=10):
    """Row 10's device time per call (its whole call, the dvec op
    included, and its dQ and dK/dV kernels apart) and SDPA backward's, from
    the profiler, filled into ``rows``; prints the rows."""
    for row, (call, lib) in zip(rows, calls):
        row["device_ms"] = _device_ms(call, reps=reps, match=None)
        row["dq_device_ms"] = _device_ms(call, reps=reps, match="flash_bwd_dq")
        row["dkv_device_ms"] = _device_ms(call, reps=reps,
                                          match="flash_bwd_dkv")
        if lib is not None:
            row["library_device_ms"] = _device_ms(lib, reps=reps, match=None)
    print("backward per call, bf16 (CUDA events; device time from the "
          "profiler, dvec op included):")

    def n_m(x):
        return "n/m" if x is None else f"{x:.4f}"
    for r in rows:
        lib = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms (device "
            f"{n_m(r['library_device_ms'])})")
        print(f"  {_shape_text(r)} {r['kernel']:20s} {r['ms']:8.4f} ms  "
              f"device {n_m(r['device_ms']):>7s} ms (dQ "
              f"{n_m(r['dq_device_ms'])}, dK/dV {n_m(r['dkv_device_ms'])})  "
              f"plain {r['plain_ms']:8.3f} ms  bound {r['bound_ms']:8.5f} ms "
              f"({r['bound_by']})  sdpa bwd {lib}")


def phase_profile_train(run, rows, calls):
    """One train step under torch.profiler: device busy ms, idle share,
    device ops per step, top entries; then ``bwd_device_times``."""
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
    bwd_device_times(rows, calls)
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
DEP_LAYERS = 4                     # depth cut: 4 of 30 layers, full width


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
FLEET_LAYERS = 4                   # depth cut: 4 of 30 layers, full width
FLEET_ROWS = ("qmatmul_acc", "qmatmul_acc_checksum",
              "flash_attention_fwd_lse")
FLEET_CAMPAIGN_TRIALS = 8          # per ABFT, CKPT, DMR campaign config
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
    with its depth cut to FLEET_LAYERS of 30 layers, W8A8
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
    params, init_s = _card_params(cfg, 0)
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


# slices 19-20: the models trained on the card on rows of 4,096 tokens
TRAIN_4K_SEQ = 4096                # train_4k's rows
# (layers, rows) of each: the points the port's dry-run chose on the host's
# CPU (``python -m repro_torch.launch.dryrun --arch A --shape train_4k
# --mesh 1,1 --batch R --set n_layers=L``, and ``--set attn_impl=flash``
# for the transformers), the largest batch of at most 8 rows, or for
# llava-next-34b the largest depth of at most 8 of its 60 layers at 1 row,
# whose predicted peak is under MOE_PEAK_BYTES (GB: the peak, its rise):
#   rwkv6-1.6b, 24 layers: 8 rows 66.176 (47.111);
#   recurrentgemma-2b, 8 of 26 layers: 2 rows 67.698 (51.465); 3 rows
#     92.592;
#   musicgen-large, 48 layers: 8 rows 57.204 (18.177); 4 rows 55.569:
#     most of the rise is the step's f32 gradients, 12.9 GB;
#   llava-next-34b, 1 row: 7 layers 67.676 (19.334); 8 layers 74.444.
TRAIN_POINTS = {"rwkv6-1.6b": (24, 8), "recurrentgemma-2b": (8, 2),
                "musicgen-large": (48, 8), "llava-next-34b": (7, 1)}
TRAIN_DRY_WAIT_S = 300             # the longest wait for a dry-run cell
EMBED_TRAIN_ROWS = ("flash_attention_fwd_lse", "flash_attention_bwd")
EMBED_TRAIN_BUDGET_S = 150         # the phase's share of the limit


def _train_points():
    """name -> (config, rows) of each TRAIN_POINTS model: its registry
    config (its own optimizer, remat and dtypes) at that depth, with flash
    attention for the transformers."""
    from repro_torch.configs import registry
    out = {}
    for name, (layers, rows) in TRAIN_POINTS.items():
        cfg = dataclasses.replace(registry.get(name), n_layers=layers)
        if cfg.family == "transformer":
            cfg = dataclasses.replace(cfg, attn_impl="flash")
        out[name] = (cfg, rows)
    return out


class TrainDry:
    """One dry-run train step (``launch.dryrun.run_cells`` on meta at a
    fake (1, 1) mesh) per TRAIN_POINTS model at its point, in two spawned
    children started early (rwkv6's step on meta takes ~155 s of CPU), so
    that their fake process groups never meet this process's and the
    card's phases run meanwhile."""

    def __init__(self):
        from repro_torch.launch import dryrun
        from repro_torch.models.config import ShapeConfig
        self.pool = concurrent.futures.ProcessPoolExecutor(
            2, mp_context=__import__("multiprocessing").get_context("spawn"))
        self.runs = {
            name: self.pool.submit(dryrun.run_cells, [(cfg, ShapeConfig(
                f"train_{rows}x{TRAIN_4K_SEQ}", TRAIN_4K_SEQ, rows,
                "train"), (1, 1))])
            for name, (cfg, rows) in _train_points().items()}

    def result(self, name):
        """The dry-run's record for ``name``, waiting at most
        TRAIN_DRY_WAIT_S; raises what the child raised."""
        return self.runs[name].result(TRAIN_DRY_WAIT_S)[0]

    def close(self):
        self.pool.shutdown(cancel_futures=True)


def phase_embed_train(card: str, dry: TrainDry) -> dict:
    """Slice 20: the embedding-input models trained at full width on the
    card through ``train/steps.make_train_step``, the f32 ``embeds`` of
    their stub front ends in the token embedding's place: musicgen-large
    in full at 8 x 4,096 (f32 parameters, remat save_dots) and
    llava-next-34b at 7 of 60 layers at 1 x 4,096 (bf16 parameters, remat
    full), both AdamW, bf16 compute, flash attention, at the points
    TRAIN_POINTS fixes, each through ``_train_model`` (two runs from
    clones of one state, losses ``==``, parameters torch.equal, rows 9 and
    10 as derived, row 4 never, the peak under MOE_PEAK_BYTES and the
    dry-run's rise (``dry``, a ``TrainDry`` started early by the caller)
    against the card's); then row 10 at each model's training
    shape against its plain version (``_hold_flash_bwd``), and rows 9 and
    10 there timed beside SDPA's forward and backward and their bounds.
    Launch counts are reset at its start and read at its end."""
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    gc.collect()                   # engines of earlier phases hold cycles
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    peak = 0
    for name, (cfg, rows) in _train_points().items():
        if cfg.input_mode != "embeddings":
            continue
        full = registry.get(name).n_layers
        depth = (f"{full} layers, in full" if cfg.n_layers == full else
                 f"depth cut to {cfg.n_layers} of {full} layers")
        t0 = time.perf_counter()
        res = _train_model("embed_train", name, cfg, depth, TRAIN_4K_SEQ,
                           failed, rows=rows, dry=dry.result(name))
        res["train_s"] = time.perf_counter() - t0
        peak = max(peak, res["peak_bytes"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # row 10 at the model's training shape, then rows 9 and 10 timed
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}
        case = FlashCase(gen, rows, H, KV, TRAIN_4K_SEQ, hd,
                         torch.bfloat16)
        max_err = {"flash_attention_fwd_lse": 0.0,
                   "flash_attention_bwd": _hold_flash_bwd(
                       f"{name}_train", case, gen, ratio)}
        shape = [(rows, H, KV, TRAIN_4K_SEQ, hd, None)]
        fl_rows, fl_calls = phase_time_flash(
            gen, max_err, shapes=shape, names=("flash_attention_fwd_lse",),
            reps=MOE_TIME_REPS)
        bwd_rows, bwd_calls = phase_time_bwd(gen, max_err, shapes=shape,
                                             reps=MOE_TIME_REPS)
        flash_device_times(fl_rows, fl_calls, reps=MOE_TIME_REPS)
        bwd_device_times(bwd_rows, bwd_calls)
        fwd, bwd = fl_rows[0], bwd_rows[0]
        res["row10_s"] = time.perf_counter() - t0 - res["train_s"]
        text = (f"({rows}, {H}, {TRAIN_4K_SEQ}, {hd})/({rows}, {KV}, "
                f"{TRAIN_4K_SEQ}, {hd})")
        print(f"embed_train: {name}: row 10 at {text} bf16 (G·S = "
              f"{H // KV * TRAIN_4K_SEQ}): error / limit "
              f"{ratio[torch.bfloat16]:.4f}, two launches equal; row 9 "
              f"{fwd['ms']:.4f} ms (device {fwd['device_ms']}), SDPA "
              f"{fwd['library_ms']:.4f} ms, bound {fwd['bound_ms']:.5f} ms "
              f"({fwd['bound_by']}); row 10 {bwd['ms']:.4f} ms (device "
              f"{bwd['device_ms']}), SDPA backward {bwd['library_ms']:.4f} "
              f"ms, bound {bwd['bound_ms']:.5f} ms ({bwd['bound_by']}); "
              f"training {res['train_s']:.1f} s, row 10 held and timed in "
              f"{res['row10_s']:.1f} s")
        res["row10"] = {"bwd_ratio": ratio[torch.bfloat16],
                        "max_abs_err": max_err}
        res["times"] = fl_rows + bwd_rows
        out[name] = res
        peak = max(peak, torch.cuda.max_memory_allocated())
        del case, fl_calls, bwd_calls     # their inputs leave the card
        torch.cuda.empty_cache()
    return _phase_end("embed_train", out, failed, EMBED_TRAIN_ROWS, peak,
                      EMBED_TRAIN_BUDGET_S, t_phase, card)


# slice 13: the selective-hardening DSE on the card
DSE_BATCH = 8                      # decode batch of the serving oracle
DSE_STEPS = 4                      # decode steps per timed window
DSE_REPS = 1                       # timed windows per variant and round
DSE_ROUNDS = 2                     # interleaved rounds (per-variant minimum)
DSE_SHIPDET_REPS = 30              # timed calls per conv layer and policy
# generations, population, trials per site and genome; certify runs the
# CLI's own 150 trials per site
DSE_SEARCH = {"serving": (2, 6, 20), "shipdet": (1, 4, 32)}
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
REC_TRAIN_CHECK_ROWS = 1           # remat "none" against save_dots: one
REC_TRAIN_CHECK_SEQ = 1024         # row of 1,024 tokens, where none fits
REC_TRAIN_RUN_STEPS = 1            # steps per run (3 before slice 20:
                                   # rwkv6's step takes 22-31 s of host
                                   # time; the replay of several steps is
                                   # held on every other trained model)
REC_BUDGET_S = 300                 # the phase's share of the limit


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


def _rec_model(name, cfg, depth, params, init_s, gen, failed):
    """One recurrent family on the card, on ``params`` (drawn on the card
    in ``init_s`` seconds): the sampled logits of prefill + decode against
    forward in f32 and a bf16 control, the bf16 Engine against
    one-request-at-a-time serving, a state strike healed under rollback,
    no kernel launched; times."""
    from repro_torch.core import fault_injection as fi
    from repro_torch.models import api
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
          f"vocab {cfg.vocab_size}), params on the card in {init_s:.2f} s; "
          f"prefill "
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


def _rec_train(name, cfg, host, rows, rec, failed):
    """``cfg`` trained on the card from ``host`` (the serving checks'
    parameters, kept on the host) on ``rows`` rows of TRAIN_4K_SEQ tokens
    (its TRAIN_POINTS batch), with its own optimizer and remat, ``rec``
    the dry-run's record of one step there: first the loss and every
    gradient of one batch of REC_TRAIN_CHECK_ROWS x REC_TRAIN_CHECK_SEQ
    tokens (where remat "none" fits) with remat "none" and with the
    config's, ``==`` and
    torch.equal; then ``_train_twice`` on REC_TRAIN_RUN_STEPS
    batches: losses ``==`` and finite, final parameters torch.equal, the
    peak device memory under MOE_PEAK_BYTES, the dry-run's predicted rise
    within ITEM17_PEAK_RTOL of the largest ``max_memory_allocated`` rise
    of a step; ms per step, tokens/s."""
    from repro_torch import tree
    from repro_torch.models import api
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check = _train_batches(cfg, REC_TRAIN_CHECK_SEQ, REC_TRAIN_CHECK_ROWS,
                           1)[0]
    params = tree.map(lambda t: t.to(DEVICE, copy=True), host)
    got = {}
    for remat in ("none", cfg.remat):
        c = dataclasses.replace(cfg, remat=remat)
        live = tree.map(lambda t: t.detach().requires_grad_(), params)
        # the loss alone: its metrics would hold the graph, and the graph
        # every leaf it reached, past this function's end
        loss = api.loss_fn(c, live, check)[0]
        got[remat] = (loss.detach(), torch.autograd.grad(
            loss, tree.leaves(live)))
        del live, loss
    (l0, g0), (l1, g1) = got["none"], got[cfg.remat]
    differ = [tree.path_str(p) for (p, _), a, b in zip(
        tree.leaves_with_paths(params), g0, g1) if not torch.equal(a, b)]
    remat_equal = bool(torch.equal(l0, l1)) and not differ
    peak = torch.cuda.max_memory_allocated()
    del got, g0, g1, params, check
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = _train_batches(cfg, TRAIN_4K_SEQ, rows, REC_TRAIN_RUN_STEPS)
    rises = []
    runs, same, _ = _train_twice(cfg, host, batches, rises)
    del batches
    replay_s = time.perf_counter() - t0
    a, b = (r["losses"] for r in runs)
    replay = a == b
    finite = all(math.isfinite(x) for x in a + b)
    peak = max([peak] + [p for _, p in rises])
    card_rise = max(p - b0 for b0, p in rises)
    predicted = rec["memory_analysis"]["peak_live_bytes"]
    ratio = predicted / card_rise if card_rise else math.inf
    launched = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    tokens = rows * TRAIN_4K_SEQ
    ms = [r["ms_per_step"] for r in runs]
    ok = (remat_equal and replay and same and finite
          and peak < MOE_PEAK_BYTES
          and abs(ratio - 1) <= ITEM17_PEAK_RTOL)
    print(f"recurrent: {name} training ({cfg.n_layers} layers, "
          f"{cfg.optimizer}, remat {cfg.remat}, {cfg.param_dtype} params, "
          f"{cfg.compute_dtype} compute), rows of {TRAIN_4K_SEQ} tokens: "
          f"the dry-run's batch {rows} rows (predicted peak "
          f"{rec['memory_analysis']['peak_bytes'] / 1e9:.3f} GB, its step "
          f"{rec['run_s']:.1f} s in a child); remat none "
          f"against {cfg.remat} at {REC_TRAIN_CHECK_ROWS} x "
          f"{REC_TRAIN_CHECK_SEQ} ({check_s:.1f} s): loss "
          f"{float(l0):.6f} == {float(l1):.6f}, gradients torch.equal: "
          f"{remat_equal}{f' (differ: {differ})' if differ else ''}; "
          f"two runs of {len(a)} steps from clones of one state "
          f"({replay_s:.1f} s): losses "
          f"{[f'{x:.6f}' for x in a]} == {[f'{x:.6f}' for x in b]}: "
          f"{replay}, finite: {finite}; final parameters equal: {same}; "
          f"{ms[0]:.1f} / {ms[1]:.1f} ms/step, "
          f"{tokens / ms[1] * 1e3:.0f} tokens/s; peak device memory "
          f"{peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB held before); "
          f"predicted rise {predicted / 1e9:.3f} GB against the card's "
          f"{card_rise / 1e9:.3f} GB (ratio {ratio:.4f}, limit 1 ± "
          f"{ITEM17_PEAK_RTOL}); launches {launched}"
          + ("" if ok else "  FAILED"))
    if not ok:
        failed.append(f"{name} training")
    return {"rows": rows, "seq": TRAIN_4K_SEQ, "runs": runs,
            "remat_equal": remat_equal, "losses_equal": replay,
            "params_equal": same, "finite": finite, "peak_bytes": peak,
            "resident_bytes": resident, "card_rise_bytes": card_rise,
            "predicted_rise_bytes": predicted, "rise_ratio": ratio,
            "predicted_peak_bytes": rec["memory_analysis"]["peak_bytes"],
            "dry_run_s": rec["run_s"], "ms_per_step": ms,
            "check_s": check_s, "replay_s": replay_s,
            "tokens_per_s": tokens / ms[1] * 1e3}


def phase_recurrent(card: str, dry: TrainDry) -> dict:
    """Slice 13: the recurrent families at full width on the card, weights
    drawn on the card (slice 15; every check compares the port with itself,
    so none depends on which values were drawn): rwkv6-1.6b in full (24
    layers) and recurrentgemma-2b with its depth cut to 8 of 26 layers (two
    2:1 super-blocks and the two-block recurrent tail), each through
    ``_rec_model``, then trained from the same parameters (slice 19,
    ``_rec_train``) at its TRAIN_POINTS batch, against ``dry`` (a
    ``TrainDry``, started early by the caller).  No hand kernel serves or
    trains them (the reference runs them as plain jnp): the phase checks
    that none of rows 1-10 launched."""
    from repro_torch import tree
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
    trained = _train_points()
    gc.collect()                   # engines of earlier phases hold cycles
    torch.cuda.empty_cache()
    for name, (cfg, depth) in models.items():
        params, init_s = _card_params(cfg, 0)
        out[name] = _rec_model(name, cfg, depth, params, init_s, gen, failed)
        out[name]["depth"] = depth
        host = tree.map(lambda t: t.to("cpu", copy=True), params)
        del params
        gc.collect()               # the serving checks' engines hold cycles
        torch.cuda.empty_cache()
        tcfg, rows = trained[name]
        if tcfg != cfg:
            failed.append(f"{name}: the dry-run's config is not the card's")
        out[name]["train"] = _rec_train(name, cfg, host, rows,
                                        dry.result(name), failed)
        del host
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


# slice 14: the mixture-of-experts transformers on one card
MOE_MIXTRAL_LAYERS = 4             # depth cut: 4 of 32 layers, full width
MOE_KIMI_LAYERS = 2                # its dense layer and one MoE layer of 61
MOE_CAPACITY = 4
MOE_PROMPTS = (8, 40, 200, 512, 1000, 2048, 3000, 4608)   # 4608 > window
MOE_PREFILL_PAD = 64
MOE_MAX_NEW = 16
MOE_KIMI_PROMPT = 512
MOE_STEPS = 16                     # kimi's decode steps; timed steps of both
MOE_TIME_REPS = 20                 # row 9 and SDPA calls per timing
MOE_PEAK_BYTES = 70e9              # torch.cuda.max_memory_allocated limit
MOE_ROWS = ("qmatmul_acc", "flash_attention_fwd_lse")
MOE_BUDGET_S = 100                 # the phase's share of the limit


def _moe_configs():
    """(mixtral-8x7b at MOE_MIXTRAL_LAYERS, kimi-k2 at MOE_KIMI_LAYERS),
    full width, W8A8 FFN and experts, bf16, flash prefill."""
    from repro_torch.configs import registry
    kw = dict(quant="w8a8_ffn", attn_impl="flash")
    return (dataclasses.replace(registry.get("mixtral-8x7b"),
                                n_layers=MOE_MIXTRAL_LAYERS, **kw),
            dataclasses.replace(registry.get("kimi-k2-1t-a32b"),
                                n_layers=MOE_KIMI_LAYERS, **kw))


def _row4_per_call(cfg) -> int:
    """qmatmul_acc launches of one W8A8 forward call over a token batch (a
    prefill or a decode step): 3 per dense layer, and per MoE layer 3 per
    routed expert (every expert, empty ones too) plus 3 for the shared
    experts' one matrix."""
    m = cfg.moe
    if m is None:
        return 3 * cfg.n_layers
    n_moe = cfg.n_layers - m.n_dense_layers
    return 3 * m.n_dense_layers + n_moe * (3 * m.n_experts
                                           + 3 * (m.n_shared_experts > 0))


def _card_params(cfg, seed):
    """Seeded weights drawn on the card (a CUDA generator: on the host,
    mixtral's 6 B parameters at 4 layers would take tens of seconds);
    returns (params, seconds)."""
    from repro_torch.models import api
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=DEVICE)
                             .manual_seed(seed), device=DEVICE)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _moe_row4_at_experts(cfg, gen, tokens, failed):
    """Row 4 at the routed expert products of one prefill and one decode
    step, (M, K, N) with M the capacity of the ``tokens`` routed tokens:
    bit for bit against its plain version and ``torch._int_mm``, CUDA-event
    and device ms per call beside its bound.  Returns the rows."""
    from repro_torch.models import transformer as T
    d, de = cfg.d_model, cfg.moe.d_expert
    shapes = [(T.capacity(cfg.moe, n), k, nn) for n in tokens
              for k, nn in ((d, de), (de, d))]
    err = {"qmatmul_acc": 0}
    rows, calls, lib_calls = phase_time_matmul(
        cfg, gen, err, shapes=shapes, names=("qmatmul_acc",))
    matmul_row_device_times(rows, calls, lib_calls)
    if err["qmatmul_acc"]:
        failed.append(f"row 4 at the expert shapes of {cfg.name}: max abs "
                      f"err {err['qmatmul_acc']}")
    return rows


def _moe_decode_profile(name, cfg, params, tok, cache):
    """One decode step under the profiler (``_profile_window``, 3 steps):
    wall and device busy ms, idle share, device ops, the top entries."""
    from repro_torch.models import api
    with torch.no_grad():
        w = _profile_window(lambda: api.decode_step(cfg, params, tok, cache),
                            reps=3)
    if w is None:
        print(f"moe: profile {name} decode step: the profiler saw no device "
              f"time (not measured)")
        return None
    print(f"moe: profile {name} decode step at batch {tok.shape[0]}: wall "
          f"{w['wall_ms']:.3f} ms, device busy {w['busy_ms']:.3f} ms, idle "
          f"share {w['idle_share']:.3f}, {w['ops']:.0f} device ops/step")
    for kname, v in w["top"]:
        print(f"    {v:8.4f} ms  {kname}")
    return w


def _moe_mixtral(cfg, gen, failed):
    """mixtral-8x7b: an Engine of capacity MOE_CAPACITY serves
    MOE_PROMPTS under the ``cuda`` and ``ref`` backends (streams equal,
    rows 4 and 9 launched as derived: ``_row4_per_call`` per prefill
    and decode step, n_layers fwd_lse per prefill); the logits of a prefill
    at the longest prompt and of MOE_STEPS decode steps at batch
    MOE_CAPACITY bit for bit equal under both (row 4 at the expert shapes
    through the model); row 9 against ``flash_plain`` at its attention
    shape with the 4,096 window; prefill ms at the longest prompt, decode
    ms/step at full capacity, a profiled decode step and row 4 per call at
    the expert shapes."""
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    from repro_torch.models import api
    from repro_torch.runtime.serving import Engine, Request
    params, init_s = _card_params(cfg, 14)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=DEVICE).tolist() for n in MOE_PROMPTS]
    max_len = max(MOE_PROMPTS) + MOE_MAX_NEW + 1
    runs = {}
    for backend in ("cuda", "ref"):
        eng = Engine(api.with_backend(cfg, backend), params,
                     capacity=MOE_CAPACITY, max_len=max_len,
                     prefill_pad=MOE_PREFILL_PAD)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=MOE_MAX_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        before = _campaign_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = _campaign_launches()
        calls = len(reqs) + eng.stats.steps
        want = {"qmatmul_acc": _row4_per_call(cfg) * calls
                if backend == "cuda" else 0,
                "flash_attention_fwd_lse": cfg.n_layers * len(reqs)}
        got = {k: after[k] - before[k] for k in want}
        done = all(len(r.output or ()) == MOE_MAX_NEW for r in reqs)
        runs[backend] = {"streams": [list(r.output or ()) for r in reqs],
                         "steps": eng.stats.steps, "wall_s": secs,
                         "launches": got, "derived": want,
                         "as_derived": got == want and done}
    same = runs["cuda"]["streams"] == runs["ref"]["streams"]
    launched = all(r["as_derived"] for r in runs.values())
    # the logits of a prefill at the longest prompt (each expert's M = its
    # capacity) and of MOE_STEPS decode steps at batch MOE_CAPACITY (M = 4),
    # bit for bit under both backends: ``ref`` forms each integer product
    # exactly, and the rest of the path is the same code
    step_toks = torch.randint(0, cfg.vocab_size, (MOE_STEPS, MOE_CAPACITY),
                              generator=gen, device=DEVICE)
    logits, timed = {}, {}
    for backend in ("cuda", "ref"):
        bcfg = api.with_backend(cfg, backend)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = api.prefill(bcfg, params, torch.tensor(
                [prompts[-1]], device=DEVICE), max_len)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bc = api.init_cache(cfg, MOE_CAPACITY, max_len, device=DEVICE)
            steps = []
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for tok in step_toks:
                step, bc = api.decode_step(bcfg, params, tok, bc)
                steps.append(step)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        logits[backend] = (lg, torch.stack(steps))
        timed[backend] = ((t1 - t0) * 1e3, (t3 - t2) * 1e3 / MOE_STEPS)
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(logits["cuda"], logits["ref"]))
    finite = all(bool(torch.isfinite(t).all()) for t in logits["cuda"])
    del logits
    prefill_ms, decode_ms = timed["cuda"]
    profile = _moe_decode_profile("mixtral-8x7b", api.with_backend(
        cfg, "cuda"), params, step_toks[0], bc)
    del params, bc
    torch.cuda.empty_cache()
    row4 = _moe_row4_at_experts(cfg, gen, (MOE_CAPACITY, max(MOE_PROMPTS)),
                                failed)
    # row 9 at mixtral's attention shape, windowed, and off the 64-row tiles
    hd, H, KV, W = (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads,
                    cfg.swa_window)
    ratio, seqs = 0.0, (max(MOE_PROMPTS), max(MOE_PROMPTS) - 37)
    for length in seqs:
        q = torch.randn((1, H, length, hd), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        k, v = (torch.randn((1, KV, length, hd), generator=gen,
                            device=DEVICE).to(torch.bfloat16)
                for _ in range(2))
        got = FK.flash_attention_fwd_lse(q, k, v, window=W)
        ref = FR.flash_plain(q, k, v, window=W, emit="lse")
        ratio = max(ratio, _flash_err(got[0], ref[0], torch.bfloat16)[1],
                    _flash_err(got[1], ref[1], torch.float32)[1])
    fl_rows, fl_calls = phase_time_flash(
        gen, {"flash_attention_fwd_lse": 0.0},
        shapes=[(1, H, KV, seqs[-1], hd, W)],
        names=("flash_attention_fwd_lse",), reps=MOE_TIME_REPS)
    flash_device_times(fl_rows, fl_calls, reps=MOE_TIME_REPS)
    flash = fl_rows[0]
    ok = same and launched and bitwise and finite
    r = runs["cuda"]
    print(f"moe: mixtral-8x7b (depth cut to {cfg.n_layers} of 32 layers; d "
          f"{cfg.d_model}, {H}/{KV} heads of {hd}, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k} of {cfg.moe.d_expert}, window {W}, "
          f"vocab {cfg.vocab_size}), W8A8 FFN and experts, bf16, flash; "
          f"params on the card in {init_s:.2f} s; Engine capacity "
          f"{MOE_CAPACITY}, prompts {list(MOE_PROMPTS)}, {MOE_MAX_NEW} new: "
          f"streams cuda == ref: {same} ({r['steps']} steps, cuda "
          f"{r['wall_s']:.2f} s, ref {runs['ref']['wall_s']:.2f} s); "
          f"launches cuda {r['launches']}, ref {runs['ref']['launches']} = "
          f"derived ({_row4_per_call(cfg)} row-4 launches per prefill "
          f"and decode step): {launched}; logits of a prefill at S "
          f"{len(prompts[-1])} and {MOE_STEPS} decode steps at batch "
          f"{MOE_CAPACITY} equal bit for bit under cuda and ref: {bitwise}, "
          f"finite: {finite}; fwd_lse against flash_plain at "
          f"(1, {H}, S, {hd})/(1, {KV}, S, {hd}), window {W}, S "
          f"{list(seqs)}: worst error / limit {ratio:.4f}; prefill S "
          f"{len(prompts[-1])} {prefill_ms:.2f} ms, decode {decode_ms:.2f} "
          f"ms/step at batch {MOE_CAPACITY}; row 9 at S {seqs[-1]} "
          f"{flash['ms']:.4f} ms (device {flash['device_ms']})"
          + ("" if ok else "  FAILED"))
    if not ok:
        failed.append("mixtral-8x7b")
    return {"layers": cfg.n_layers, "init_s": init_s,
            "streams_equal": same, "launches_as_derived": launched,
            "logits_bitwise": bitwise, "finite": finite,
            "decode_profile": profile, "row4_experts": row4,
            "runs": {b: {k: v for k, v in run.items() if k != "streams"}
                     for b, run in runs.items()},
            "flash_ratio": ratio, "flash_seqs": list(seqs),
            "row9": flash, "prefill_ms": prefill_ms,
            "prefill_len": len(prompts[-1]), "decode_ms_per_step": decode_ms,
            "row4_per_call": _row4_per_call(cfg)}


def _moe_kimi(cfg, gen, failed):
    """kimi-k2-1t-a32b: a MOE_KIMI_PROMPT-token prefill and MOE_STEPS
    greedy decode steps under ``cuda`` and ``ref`` (streams equal, the
    sampled logits finite and bit for bit equal, rows 4 and 9 as derived),
    a profiled decode step and row 4 per call at the expert shapes; rows
    7-10 at its attention shape (hd 112) against their plain versions, f32
    and bf16, out equal across rows 7-9; their times beside SDPA's."""
    from repro_torch.models import api
    params, init_s = _card_params(cfg, 14)
    toks = torch.randint(0, cfg.vocab_size, (1, MOE_KIMI_PROMPT),
                         generator=gen, device=DEVICE)
    runs = {}
    for backend in ("cuda", "ref"):
        bcfg = api.with_backend(cfg, backend)
        before = _campaign_launches()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = api.prefill(bcfg, params, toks,
                                        MOE_KIMI_PROMPT + MOE_STEPS)
            out = [logits[:, -1]]
            tokens = [torch.argmax(logits[:, -1], dim=-1)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(MOE_STEPS):
                lg, cache = api.decode_step(bcfg, params, tokens[-1], cache)
                out.append(lg)
                tokens.append(torch.argmax(lg, dim=-1))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        after = _campaign_launches()
        calls = 1 + MOE_STEPS
        want = {"qmatmul_acc": _row4_per_call(cfg) * calls
                if backend == "cuda" else 0,
                "flash_attention_fwd_lse": cfg.n_layers}
        got = {k: after[k] - before[k] for k in want}
        runs[backend] = {
            "stream": torch.stack(tokens, dim=1).cpu().tolist(),
            "logits": torch.stack(out),
            "finite": bool(torch.isfinite(torch.stack(out)).all()),
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_step": (t2 - t1) * 1e3 / MOE_STEPS,
            "launches": got, "as_derived": got == want}
    same = runs["cuda"]["stream"] == runs["ref"]["stream"]
    bitwise = torch.equal(runs["cuda"].pop("logits"),
                          runs["ref"].pop("logits"))
    finite = all(r["finite"] for r in runs.values())
    launched = all(r["as_derived"] for r in runs.values())
    profile = _moe_decode_profile("kimi-k2-1t-a32b", api.with_backend(
        cfg, "cuda"), params, tokens[-1], cache)
    del params, cache
    torch.cuda.empty_cache()
    row4 = _moe_row4_at_experts(cfg, gen, (1, MOE_KIMI_PROMPT), failed)
    # rows 7-10 at kimi's attention shape, hd 112
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    kernels = _flash_kernels()
    max_err = {name: 0.0 for name in (*FLASH_REPLACES, *BWD_REPLACES)}
    ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bwd_ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for s in (MOE_KIMI_PROMPT, MOE_KIMI_PROMPT - 37):
        for dt in (torch.float32, torch.bfloat16):
            case = FlashCase(gen, 1, H, KV, s, hd, dt)
            label = f"kimi_hd{hd}_S{s}_{dt}"
            _hold_flash(label, case, kernels, max_err, ratio)
            max_err["flash_attention_bwd"] = max(
                max_err["flash_attention_bwd"],
                _hold_flash_bwd(label, case, gen, bwd_ratio))
    shape = [(1, H, KV, MOE_KIMI_PROMPT, hd, None)]
    fl_rows, fl_calls = phase_time_flash(gen, max_err, shapes=shape,
                                         reps=MOE_TIME_REPS)
    bwd_rows, bwd_calls = phase_time_bwd(gen, max_err, shapes=shape,
                                         reps=MOE_TIME_REPS)
    flash_device_times(fl_rows, fl_calls, reps=MOE_TIME_REPS)
    bwd_device_times(bwd_rows, bwd_calls)
    flash = next(r for r in fl_rows
                 if r["kernel"] == "flash_attention_fwd_lse")
    ok = same and bitwise and finite and launched
    r = runs["cuda"]
    print(f"moe: kimi-k2-1t-a32b (depth cut to {cfg.n_layers} of 61 layers: "
          f"its dense layer and one MoE layer; d {cfg.d_model}, {H}/{KV} "
          f"heads of {hd}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
          f"of {cfg.moe.d_expert} + {cfg.moe.n_shared_experts} shared, "
          f"vocab {cfg.vocab_size}), W8A8 FFN and experts, bf16, flash; "
          f"params on the card in {init_s:.2f} s; prefill S "
          f"{MOE_KIMI_PROMPT} {r['prefill_ms']:.2f} ms, decode "
          f"{r['decode_ms_per_step']:.2f} ms/step ({_row4_per_call(cfg)}"
          f" row-4 launches per step); streams cuda == ref: {same}; the "
          f"{1 + MOE_STEPS} sampled logits equal bit for bit: {bitwise}, "
          f"finite: {finite}; launches cuda {r['launches']}, ref "
          f"{runs['ref']['launches']} = derived: {launched}; rows 7-9 at "
          f"(1, {H}, S, {hd})/(1, {KV}, S, {hd}), S {MOE_KIMI_PROMPT} and "
          f"{MOE_KIMI_PROMPT - 37}: out equal across the three, worst "
          f"error / limit f32 {ratio[torch.float32]:.4f}, bf16 "
          f"{ratio[torch.bfloat16]:.4f}; row 10 f32 "
          f"{bwd_ratio[torch.float32]:.4f}, bf16 "
          f"{bwd_ratio[torch.bfloat16]:.4f}; row 9 at S {MOE_KIMI_PROMPT} "
          f"{flash['ms']:.4f} ms (device {flash['device_ms']}), SDPA "
          f"{flash['library_ms']:.4f} ms (device "
          f"{flash['library_device_ms']})" + ("" if ok else "  FAILED"))
    if not ok:
        failed.append("kimi-k2-1t-a32b")
    return {"layers": cfg.n_layers, "init_s": init_s,
            "streams_equal": same, "logits_bitwise": bitwise,
            "finite": finite, "launches_as_derived": launched,
            "decode_profile": profile, "row4_experts": row4,
            "runs": {b: {k: v for k, v in run.items() if k != "stream"}
                     for b, run in runs.items()},
            "flash_max_err": max_err,
            "flash_ratio": {str(k): v for k, v in ratio.items()},
            "bwd_ratio": {str(k): v for k, v in bwd_ratio.items()},
            "hd112": fl_rows + bwd_rows,
            "row4_per_call": _row4_per_call(cfg)}


def phase_moe(card: str) -> dict:
    """Slice 14: the mixture-of-experts transformers at full width on the
    card, weights drawn on the card: mixtral-8x7b at 4 of 32 layers served
    by an Engine (``_moe_mixtral``), kimi-k2-1t-a32b at 2 of 61 layers
    (``_moe_kimi``: its 384 routed experts, the shared expert, the dense
    layer, and rows 7-10 at head dim 112).  Launch counts are reset at its
    start and read at its end; the peak device memory is held under
    MOE_PEAK_BYTES."""
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    mixtral, kimi = _moe_configs()
    out["mixtral-8x7b"] = _moe_mixtral(mixtral, gen, failed)
    torch.cuda.empty_cache()
    out["kimi-k2-1t-a32b"] = _moe_kimi(kimi, gen, failed)
    torch.cuda.empty_cache()
    launches = _campaign_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"moe: launches {launches}; peak device memory {peak / 1e9:.2f} "
          f"GB (limit {MOE_PEAK_BYTES / 1e9:.0f} GB)")
    if any(launches[n] == 0 for n in MOE_ROWS):
        failed.append(f"a row of the path never launched: {launches}")
    if peak >= MOE_PEAK_BYTES:
        failed.append(f"peak memory {peak / 1e9:.2f} GB")
    out.update(launches=launches, peak_bytes=peak)
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"moe: phase in {secs:.1f} s (budget {MOE_BUDGET_S} s) on {card}")
    if secs > MOE_BUDGET_S:
        failed.append(f"moe phase took {secs:.1f} s")
    if failed:
        raise AssertionError("moe: " + "; ".join(failed))
    return out


# slice 15: every registry name on one card
DENSE_MODELS = (("command-r-plus-104b", 4), ("llama3-405b", 4),
                ("qwen3-0.6b", None))     # (name, depth cut; None: in full)
DENSE_PROMPT = 2048                # the prefill's S
DENSE_BATCH = 4                    # the decode steps' batch
DENSE_STEPS = 16
DENSE_TRAIN_LAYERS = 2             # llama3-405b training: 2 of 126 layers
DENSE_TRAIN_SEQ = 1024             # batch 1 x 1,024
TRAIN_RUN_STEPS = 3                # steps per run; two runs from one state
FLOAT64_ROWS = 2048                # the Adafactor hold's rows per block
DENSE_ROWS = ("qmatmul_acc", "flash_attention_fwd_lse", "flash_attention_bwd")
DENSE_BUDGET_S = 100               # the phase's share of the limit
MOE_TRAIN_LAYERS = 2               # mixtral-8x7b training: 2 of 32 layers
MOE_TRAIN_SEQ = 4608               # the last 512 queries meet the window
MOE_BWD_REPEATS = 5                # one MoE layer's backward, repeated
MOE_TRAIN_ROWS = ("flash_attention_fwd_lse", "flash_attention_bwd")
MOE_TRAIN_BUDGET_S = 40            # the phase's share of the limit


def _dense_model(name, cfg, depth, gen, failed):
    """One dense transformer at full width, W8A8 FFN, bf16, flash prefill,
    weights drawn on the card: a DENSE_PROMPT-token prefill and DENSE_STEPS
    decode steps at batch DENSE_BATCH after it (the prompt's cache spliced
    into every row, so each step attends to the DENSE_PROMPT prefilled
    positions and the steps before) under ``cuda`` and ``ref``, the
    prefill's logits and every step's torch.equal across the two (``ref``
    forms each integer product exactly, the rest is the same code), finite;
    rows 4 (``_row4_per_call`` per call under ``cuda``, none under ``ref``)
    and 9 (one per layer per prefill) launched as derived; row 9 against
    its plain version at the prefill's attention shape; param seconds,
    prefill ms, decode ms/step and the peak device memory of the model."""
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.kernels.flashattn import ref as FR
    from repro_torch.models import api
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _card_params(cfg, 15)
    S, L = DENSE_PROMPT, cfg.n_layers
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device=DEVICE)
    step_toks = torch.randint(0, cfg.vocab_size, (DENSE_STEPS, DENSE_BATCH),
                              generator=gen, device=DEVICE)
    with torch.no_grad():
        api.prefill(cfg, params, toks[:, :64], 64)              # warm up
    runs, logits = {}, {}
    for backend in ("cuda", "ref"):
        bcfg = api.with_backend(cfg, backend)
        before = _campaign_launches()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, one = api.prefill(bcfg, params, toks, S + DENSE_STEPS)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cache = api.init_cache(cfg, DENSE_BATCH, S + DENSE_STEPS,
                                   device=DEVICE)
            for row in range(DENSE_BATCH):
                api.cache_write_slot(cache, one, row, S)
            del one
            steps = []
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for tok in step_toks:
                step, cache = api.decode_step(bcfg, params, tok, cache)
                steps.append(step)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        after = _campaign_launches()
        want = {"qmatmul_acc": _row4_per_call(cfg) * (1 + DENSE_STEPS)
                if backend == "cuda" else 0,
                "flash_attention_fwd_lse": L}
        got = {k: after[k] - before[k] for k in want}
        logits[backend] = (lg, torch.stack(steps))
        runs[backend] = {"prefill_ms": (t1 - t0) * 1e3,
                         "decode_ms_per_step": (t3 - t2) * 1e3 / DENSE_STEPS,
                         "launches": got, "as_derived": got == want}
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(logits["cuda"], logits["ref"]))
    finite = all(bool(torch.isfinite(t).all()) for t in logits["cuda"])
    launched = all(r["as_derived"] for r in runs.values())
    del logits, lg, steps, cache, params
    torch.cuda.empty_cache()
    # row 9 at the prefill's attention shape, and off the 64-row tiles
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    ratio = 0.0
    for length in (S, S - 37):
        q = torch.randn((1, H, length, hd), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        k, v = (torch.randn((1, KV, length, hd), generator=gen,
                            device=DEVICE).to(torch.bfloat16)
                for _ in range(2))
        got = FK.flash_attention_fwd_lse(q, k, v)
        ref = FR.flash_plain(q, k, v, emit="lse")
        ratio = max(ratio, _flash_err(got[0], ref[0], torch.bfloat16)[1],
                    _flash_err(got[1], ref[1], torch.float32)[1])
    peak = torch.cuda.max_memory_allocated()
    ok = bitwise and finite and launched
    r = runs["cuda"]
    print(f"dense: {name} ({depth}; d {cfg.d_model}, {H}/{KV} heads of "
          f"{hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), W8A8 FFN, bf16, "
          f"flash; params on the card in {init_s:.2f} s; prefill S {S} "
          f"{r['prefill_ms']:.2f} ms, decode {r['decode_ms_per_step']:.2f} "
          f"ms/step at batch {DENSE_BATCH} after the {S}-token prompt (ref "
          f"{runs['ref']['prefill_ms']:.2f}"
          f" ms, {runs['ref']['decode_ms_per_step']:.2f} ms/step); the logits "
          f"of the prefill and {DENSE_STEPS} steps equal bit for bit under "
          f"cuda and ref: {bitwise}, finite: {finite}; launches cuda "
          f"{r['launches']}, ref {runs['ref']['launches']} = derived "
          f"({_row4_per_call(cfg)} row-4 launches per call): {launched}; "
          f"fwd_lse against flash_plain at (1, {H}, S, {hd})/(1, {KV}, S, "
          f"{hd}), S {[S, S - 37]}: worst error / limit {ratio:.4f}; peak "
          f"device memory {peak / 1e9:.2f} GB" + ("" if ok else "  FAILED"))
    if not ok:
        failed.append(name)
    return {"layers": L, "depth": depth, "init_s": init_s,
            "prefill_len": S, "decode_context": [S, S + DENSE_STEPS - 1],
            "prefill_ms": r["prefill_ms"],
            "decode_ms_per_step": r["decode_ms_per_step"],
            "ref_prefill_ms": runs["ref"]["prefill_ms"],
            "ref_decode_ms_per_step": runs["ref"]["decode_ms_per_step"],
            "launches": r["launches"], "launches_as_derived": launched,
            "logits_bitwise": bitwise, "finite": finite,
            "flash_ratio": ratio, "peak_bytes": peak,
            "row4_per_call": _row4_per_call(cfg)}


def _train_batches(cfg, seq, rows=1, steps=TRAIN_RUN_STEPS):
    """``steps`` seeded batches of ``rows`` x ``seq`` tokens (with
    ``embeds`` for an embedding-input model), on the card."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.config import ShapeConfig
    stream = TokenStream(cfg, ShapeConfig("train", seq, rows, "train"))
    return [{k: torch.from_numpy(v).to(DEVICE)
             for k, v in stream.batch_at(i).items()}
            for i in range(steps)]


def _adafactor_first_update(cfg, seq):
    """A closure over the drawn parameters: the port's first Adafactor
    update (``Optimizer.update`` at step 0) of the FFN leaf
    ``dense_blocks/wi``, (L, d, d_ff) at full width, held against the same
    rule in float64 on the same gradient, the loss's on step 0's batch.  At
    step 0 the state drops out (β = 1 − 1^-0.8 = 0): per layer, vr and vc
    are the row and column means of g² + ε, u = g / max(sqrt(vr ⊗ vc /
    max(mean(vr), ε)), ε); over the whole leaf u is scaled down to an RMS
    of at most 1, then times −lr.  Every element of the bf16 update must
    be within one bf16 step of the float64 value's magnitude (the f32
    rule's own error is ~1e-6 of it, and rounding to bf16 moves it by at
    most half a step).  The float64 side goes FLOAT64_ROWS rows at a
    time."""
    from repro_torch.models import api
    from repro_torch.train import optim
    lr, eps = 3e-4, 1e-30            # make_optimizer's Adafactor, clip 1

    def run(params):
        batch = _train_batches(cfg, seq)[0]
        wi = params["dense_blocks"]["wi"].detach().requires_grad_()
        live = dict(params, dense_blocks=dict(params["dense_blocks"], wi=wi))
        loss, _ = api.loss_fn(cfg, live, batch)
        g, = torch.autograd.grad(loss, [wi])
        wi, loss = wi.detach(), float(loss.detach())
        del live
        opt = optim.make_optimizer(cfg.optimizer)
        u = opt.update({"wi": g}, opt.init({"wi": wi}), {"wi": wi},
                       torch.zeros((), dtype=torch.int32, device=DEVICE)
                       )[0]["wi"]
        L, R, C = g.shape
        blocks = [(i, slice(r, r + FLOAT64_ROWS)) for i in range(L)
                  for r in range(0, R, FLOAT64_ROWS)]
        vr = torch.empty((L, R), dtype=torch.float64, device=DEVICE)
        vc = torch.zeros((L, C), dtype=torch.float64, device=DEVICE)
        for i, rs in blocks:
            g2 = g[i, rs].double().square_().add_(eps)
            vr[i, rs] = g2.mean(-1)
            vc[i] += g2.sum(-2)
        vc /= R
        den = torch.clamp(vr.mean(-1), min=eps)

        def u64(i, rs):                 # before the clip and the −lr
            r = vr[i, rs, None] * vc[i, None, :]
            r.div_(den[i]).sqrt_().clamp_(min=eps)
            return torch.div(g[i, rs].double(), r, out=r)

        sq = 0.0
        for i, rs in blocks:
            x = u64(i, rs).view(-1)
            sq += float(torch.dot(x, x))
        urms = math.sqrt(sq / g.numel())
        scale = -lr / max(urms, 1.0)
        worst, past = 0.0, 0
        for i, rs in blocks:
            w = u64(i, rs).mul_(scale)
            step = torch.exp2(torch.floor(torch.log2(
                w.abs().clamp(min=2.0 ** -126))) - 7)
            r = (u[i, rs].double() - w).abs_().div_(step)
            worst = max(worst, float(r.max()))
            past += int((r > 1).sum())
        rms = float(u.float().square().mean().sqrt())
        print(f"dense: llama3-405b's first Adafactor update of "
              f"dense_blocks/wi {tuple(g.shape)} (loss {loss:.6f} on step "
              f"0's batch): RMS of the normalised update before its clip "
              f"{urms:.4f}, after it {rms / lr:.4f} × lr {lr}; against "
              f"float64 on the same gradient: worst error / one bf16 step "
              f"{worst:.4f}, {past} elements past it")
        return {"adafactor_first_update": {
            "leaf": "dense_blocks/wi", "shape": list(g.shape), "loss": loss,
            "rms_before_clip": urms, "update_rms": rms,
            "worst_over_bf16_step": worst, "past": past}}
    return run


def _train_twice(cfg, host_params, batches, rises=None):
    """Two runs of train steps (``make_train_step``, which writes the
    state in place; the config's own optimizer), each from a clone of one
    state: the parameters drawn on the card and kept on the host, so that
    the card holds one state at a time beside its gradients, the
    optimizer's ``init`` and step 0; each clone is made before the timer
    starts.
    Returns per run the losses (read back each step, as the FT loop reads
    them), the seconds and the launches, and whether the two runs' final
    parameters are torch.equal (the first run's kept on the host).  A list
    ``rises`` receives each step's (bytes allocated before it, its
    ``max_memory_allocated``), the peak statistics reset before each
    step."""
    from repro_torch import tree
    from repro_torch.train import optim, steps
    opt = optim.make_optimizer(cfg.optimizer)
    step = steps.make_train_step(cfg, optimizer=opt)
    runs, first, same = [], None, None
    for r in range(2):
        params = tree.map(lambda t: t.to(DEVICE, copy=True), host_params)
        state = steps.TrainState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=DEVICE))
        del params
        before = _campaign_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in batches:
            if rises is not None:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            if rises is not None:
                rises.append((base, torch.cuda.max_memory_allocated()))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = _campaign_launches()
        runs.append({"losses": losses, "seconds": secs,
                     "ms_per_step": secs * 1e3 / len(batches),
                     "launches": {k: after[k] - before[k] for k in after}})
        if r == 0:
            first = tree.map(lambda t: t.to("cpu", copy=True), state.params)
        else:
            same = all(torch.equal(a.to(DEVICE), b) for a, b in zip(
                tree.leaves(first), tree.leaves(state.params)))
        del state, metrics
        torch.cuda.empty_cache()
    return runs, same, first


def _train_model(label, name, cfg, depth, seq, failed, before_runs=None,
                 keep=None, rows=1, dry=None):
    """Draw ``cfg``'s parameters on the card, call ``before_runs(params)``,
    keep them on the host, then ``_train_twice`` on TRAIN_RUN_STEPS
    batches of ``rows`` x ``seq`` (with ``embeds`` for an embedding-input
    model, as ``TokenStream`` draws them): the two runs' losses ``==``,
    finite, final parameters torch.equal; rows 9 (2·L per step: the
    forward and its recompute) and 10 (L per step) launched as derived,
    row 4 never (no W8A8 in training).  With ``dry`` (the dry-run's record
    of one step at this config and batch) the peak device memory is held
    under MOE_PEAK_BYTES and the dry-run's predicted rise within
    ITEM17_PEAK_RTOL of the largest ``max_memory_allocated`` rise of a
    step.  ``keep`` (a dict) receives the config, the host start, the
    first run's final parameters (on the host), the batches and the second
    run's record (its timing warm)."""
    from repro_torch import tree
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    params, init_s = _card_params(cfg, 15)
    extra = before_runs(params) if before_runs else {}
    host = tree.map(lambda t: t.to("cpu", copy=True), params)
    n_params = sum(t.numel() for t in tree.leaves(params))
    del params
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    batches = _train_batches(cfg, seq, rows)
    rises = [] if dry is not None else None
    runs, same, first = _train_twice(cfg, host, batches, rises)
    if keep is not None:          # the sharded phase's start and reference
        keep.update(cfg=cfg, host=host, first=first, batches=batches,
                    run=runs[1])
    del host, first, batches
    L, n = cfg.n_layers, TRAIN_RUN_STEPS
    want = {"qmatmul_acc": 0, "flash_attention_fwd_lse": 2 * L * n,
            "flash_attention_bwd": L * n}
    launched = all({k: r["launches"][k] for k in want} == want
                   for r in runs)
    a, b = (r["losses"] for r in runs)
    replay = a == b
    finite = all(math.isfinite(x) for x in a + b)
    ok = replay and same and finite and launched
    held = ""
    if dry is None:
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = max([peak] + [p for _, p in rises])
        card_rise = max(p - b0 for b0, p in rises)
        predicted = dry["memory_analysis"]["peak_live_bytes"]
        ratio = predicted / card_rise if card_rise else math.inf
        ok = ok and peak < MOE_PEAK_BYTES \
            and abs(ratio - 1) <= ITEM17_PEAK_RTOL
        extra.update(card_rise_bytes=card_rise,
                     predicted_rise_bytes=predicted, rise_ratio=ratio,
                     predicted_peak_bytes=dry["memory_analysis"]
                     ["peak_bytes"], resident_bytes=resident,
                     dry_run_s=dry["run_s"])
        held = (f" (limit {MOE_PEAK_BYTES / 1e9:.0f} GB; "
                f"{resident / 1e9:.3f} GB held before); the dry-run's "
                f"peak {dry['memory_analysis']['peak_bytes'] / 1e9:.3f} GB, "
                f"its rise {predicted / 1e9:.3f} GB against the card's "
                f"{card_rise / 1e9:.3f} GB (ratio {ratio:.4f}, limit 1 ± "
                f"{ITEM17_PEAK_RTOL})")
    tokens = rows * seq
    print(f"{label}: {name} training ({depth}; {n_params / 1e9:.2f} G "
          f"parameters, "
          f"{cfg.param_dtype}, {cfg.optimizer}, remat {cfg.remat}, flash, "
          f"batch {rows} x {seq}): params on the card in {init_s:.2f} s; "
          f"two runs "
          f"of {n} steps from clones of one state: losses "
          f"{[f'{x:.6f}' for x in a]} == {[f'{x:.6f}' for x in b]}: "
          f"{replay}, finite: {finite}; final parameters equal: {same}; "
          f"{runs[0]['ms_per_step']:.1f} / {runs[1]['ms_per_step']:.1f} "
          f"ms/step, {tokens / runs[1]['ms_per_step'] * 1e3:.0f} tokens/s; "
          f"launches per run {runs[0]['launches']} = derived "
          f"{want}: {launched}; peak device memory {peak / 1e9:.3f} GB"
          + held + ("" if ok else "  FAILED"))
    if not ok:
        failed.append(f"{name} training")
    return {"layers": L, "depth": depth, "seq": seq, "rows": rows,
            "params": n_params, "init_s": init_s, "runs": runs,
            "losses_equal": replay, "params_equal": same, "finite": finite,
            "launches_as_derived": launched, "peak_bytes": peak,
            "tokens_per_s": tokens / runs[1]["ms_per_step"] * 1e3, **extra}


def _phase_end(label, out, failed, launches_needed, peak, budget, t_phase,
               card):
    """A phase's closing checks: every row of its path launched, the peak
    device memory under MOE_PEAK_BYTES, the time within its budget."""
    launches = _campaign_launches()
    print(f"{label}: launches {launches}; peak device memory "
          f"{peak / 1e9:.2f} GB (limit {MOE_PEAK_BYTES / 1e9:.0f} GB)")
    if any(launches[n] == 0 for n in launches_needed):
        failed.append(f"a row of the path never launched: {launches}")
    if peak >= MOE_PEAK_BYTES:
        failed.append(f"peak memory {peak / 1e9:.2f} GB")
    secs = time.perf_counter() - t_phase
    out.update(launches=launches, peak_bytes=peak, seconds=secs)
    print(f"{label}: phase in {secs:.1f} s (budget {budget} s) on {card}")
    if secs > budget:
        failed.append(f"{label} phase took {secs:.1f} s")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return out


def phase_dense(card: str) -> dict:
    """Slice 15: the dense transformers the earlier phases do not drive,
    at full width, weights drawn on the card: command-r-plus-104b and
    llama3-405b with 4 layers each and qwen3-0.6b in full, each served
    through ``_dense_model``; then llama3-405b trained (``_train_model``:
    2 of 126 layers, Adafactor, remat full, batch 1 x 1,024, after its first
    Adafactor update of a full-width FFN leaf is held against float64 by
    ``_adafactor_first_update``), and row 10
    at its attention shape, (1, 128, 1024, 128)/(1, 8, 1024, 128) bf16,
    against its plain version and timed beside SDPA's backward.  Launch
    counts are reset at its start and read at its end; the peak device
    memory is held under MOE_PEAK_BYTES."""
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    peak = 0
    for name, layers in DENSE_MODELS:
        full = registry.get(name)
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers,
                                  quant="w8a8_ffn", attn_impl="flash")
        depth = (f"{full.n_layers} layers, in full" if layers is None else
                 f"depth cut to {layers} of {full.n_layers} layers")
        out[name] = _dense_model(name, cfg, depth, gen, failed)
        peak = max(peak, out[name]["peak_bytes"])
        torch.cuda.empty_cache()
    full = registry.get("llama3-405b")
    tcfg = dataclasses.replace(full, n_layers=DENSE_TRAIN_LAYERS,
                               attn_impl="flash")
    out["llama3-405b train"] = res = _train_model(
        "dense", "llama3-405b", tcfg, f"depth cut to {DENSE_TRAIN_LAYERS} of "
        f"{full.n_layers} layers", DENSE_TRAIN_SEQ, failed,
        before_runs=_adafactor_first_update(tcfg, DENSE_TRAIN_SEQ))
    first = res["adafactor_first_update"]
    if first["worst_over_bf16_step"] > 1:
        failed.append(f"llama3-405b's first Adafactor update off float64: "
                      f"{first}")
    peak = max(peak, out["llama3-405b train"]["peak_bytes"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # row 10 at the training path's attention shape
    H, KV, hd = tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim
    ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}
    case = FlashCase(gen, 1, H, KV, DENSE_TRAIN_SEQ, hd, torch.bfloat16)
    max_err = {"flash_attention_bwd": _hold_flash_bwd(
        "llama3_train", case, gen, ratio)}
    shape = [(1, H, KV, DENSE_TRAIN_SEQ, hd, None)]
    bwd_rows, bwd_calls = phase_time_bwd(gen, max_err, shapes=shape,
                                         reps=MOE_TIME_REPS)
    bwd_device_times(bwd_rows, bwd_calls)
    row = bwd_rows[0]
    print(f"dense: row 10 at (1, {H}, {DENSE_TRAIN_SEQ}, {hd})/(1, {KV}, "
          f"{DENSE_TRAIN_SEQ}, {hd}) bf16: error / limit "
          f"{ratio[torch.bfloat16]:.4f}, two launches equal; "
          f"{row['ms']:.4f} ms (device {row['device_ms']}), SDPA backward "
          f"{row['library_ms']:.4f} ms (device {row['library_device_ms']}), "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    out["row10"] = dict(row, bwd_ratio=ratio[torch.bfloat16],
                        max_abs_err=max_err["flash_attention_bwd"])
    peak = max(peak, torch.cuda.max_memory_allocated())
    return _phase_end("dense", out, failed, DENSE_ROWS, peak,
                      DENSE_BUDGET_S, t_phase, card)


def _moe_backward_repeats(cfg, gen):
    """A closure over the drawn parameters: MoE layer 0's ``_moe_ffn``
    backward, MOE_BWD_REPEATS times on one seeded bf16 input of
    MOE_TRAIN_SEQ tokens and one cotangent, at the config's top-k and with
    every expert chosen (top-8: a token's eight contributions, summed in
    another order, would show in the bits); the gradients of the input and
    of every weight the layer reads must be torch.equal each time."""
    from repro_torch.models import transformer as T

    def run(params):
        bp = T._layers(params["moe_blocks"])[0]
        names = [n for n in ("ln2", "router", "we_g", "we_i", "we_o",
                             "ws_g", "ws_i", "ws_o") if n in bp]
        x = torch.randn((1, MOE_TRAIN_SEQ, cfg.d_model), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        dy = torch.randn(x.shape, generator=gen,
                         device=DEVICE).to(torch.bfloat16)
        equal = {}
        for k in sorted({cfg.moe.top_k, cfg.moe.n_experts}):
            kcfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, top_k=k))
            first, same = None, True
            for _ in range(MOE_BWD_REPEATS):
                live = dict(bp, **{n: bp[n].detach().requires_grad_()
                                   for n in names})
                xi = x.detach().requires_grad_()
                y, aux, z = T._moe_ffn(kcfg, live, xi)
                grads = torch.autograd.grad(
                    (y, aux, z), [xi] + [live[n] for n in names],
                    (dy, torch.ones_like(aux), torch.ones_like(z)))
                if first is None:
                    first = grads
                else:
                    same = same and all(torch.equal(a, b)
                                        for a, b in zip(first, grads))
            equal[f"top{k}"] = same
            del first, grads
        print(f"moe_train: MoE layer 0's backward ({MOE_TRAIN_SEQ} tokens, "
              f"bf16; gradients of the input and of {names}) "
              f"{MOE_BWD_REPEATS} times on one input: torch.equal each time "
              f"{equal}")
        return {"moe_backward_equal": equal}
    return run


def phase_moe_train(card: str, keep=None) -> dict:
    """Slice 15: an MoE model trained on the card: mixtral-8x7b at full
    width, 2 of 32 layers, bf16, flash (its 4,096 window: the last 512 of
    4,608 queries meet it), AdamW, its own remat, batch 1 x 4,608, through
    ``_train_model`` (two runs of steps from clones of one state,
    losses ``==``, final parameters torch.equal, rows 9 and 10 as
    derived), after MoE layer 0's backward taken MOE_BWD_REPEATS times
    (``_moe_backward_repeats``); row 10 at its attention shape with the
    window against its plain version.  It drives the step function, not
    ``runtime/ft_loop.run``: the loop saves a checkpoint at step 0, and one
    of 2-layer mixtral with its AdamW moments is ~32 GB of disk per save
    (the SmolLM train phase drives the loop with its recovery and resume
    drills).  Launch counts are reset at its start and read at its end;
    the peak device memory is held under MOE_PEAK_BYTES."""
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    full = registry.get("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS,
                              attn_impl="flash")
    res = _train_model("moe_train", "mixtral-8x7b", cfg, f"depth cut to "
                       f"{MOE_TRAIN_LAYERS} of {full.n_layers} layers",
                       MOE_TRAIN_SEQ, failed,
                       before_runs=_moe_backward_repeats(cfg, gen),
                       keep=keep)
    if not all(res["moe_backward_equal"].values()):
        failed.append(f"MoE backward not repeatable: "
                      f"{res['moe_backward_equal']}")
    out["mixtral-8x7b train"] = res
    peak = res["peak_bytes"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # row 10 at the training path's attention shape, with the window
    ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}
    case = FlashCase(gen, 1, cfg.n_heads, cfg.n_kv_heads, MOE_TRAIN_SEQ,
                     cfg.resolved_head_dim, torch.bfloat16,
                     window=cfg.swa_window)
    err = _hold_flash_bwd("mixtral_train", case, gen, ratio)
    print(f"moe_train: row 10 at (1, {cfg.n_heads}, {MOE_TRAIN_SEQ}, "
          f"{cfg.resolved_head_dim})/(1, {cfg.n_kv_heads}, {MOE_TRAIN_SEQ}, "
          f"{cfg.resolved_head_dim}) bf16, window {cfg.swa_window}: error / "
          f"limit {ratio[torch.bfloat16]:.4f}, two launches equal")
    out["row10"] = {"bwd_ratio": ratio[torch.bfloat16], "max_abs_err": err}
    peak = max(peak, torch.cuda.max_memory_allocated())
    return _phase_end("moe_train", out, failed, MOE_TRAIN_ROWS, peak,
                      MOE_TRAIN_BUDGET_S, t_phase, card)


# slice 16: sharded execution on torch.distributed, NCCL at world size 1
SHARD_MOE_PROMPT = 4608            # mixtral's prefill: 512 queries past its window
SHARD_DENSE_PROMPT = 1024          # qwen3-0.6b's prefill and train sequence
SHARD_STEPS = 16                   # decode steps after each prefill
SHARD_ROWS = ("qmatmul_acc", "flash_attention_fwd_lse", "flash_attention_bwd")
SHARD_BUDGET_S = 45                # the phase's share of the limit


def _shard_collectives(cfg, kind, specs, calls=1, model=1, seq_len=None):
    """Each kind's count of the collectives that ``calls`` calls of
    ``kind`` ("prefill", "decode" or "train", a step) issue under a
    ShardCtx on a (1, ``model``) ("data", "model") mesh.  The gathers come
    from the parameters' spec table ``specs`` (``param_specs`` on that
    mesh) and the model's own leaf groups (``_ATTN_LEAVES``,
    ``_FFN_LEAVES``): each entry that names an axis is one gather where
    its layer uses the leaf, but for the model dim of a leaf that runs
    tensor-parallel (attention's q leaves in a prefill or a train step
    where the axis divides the heads, its k/v leaves where it divides the
    KV heads too; the FFN's and the experts' always); decode attention
    gathers its leaves whole.  The ends: at one model rank the embedding
    and the head gather theirs whole; on more (the vocabulary split) the
    embedding keeps its model dim and sums its rows over the axis (one
    all-reduce), and so does a train step's head (the loss's columns),
    while a prefill's and a decode step's head, which return whole
    logits, gather it whole.  What the table cannot give is written here:
    the code's sums, one per row-parallel product (attention's ``wo``
    outside decode where its q heads are local, the FFN's ``wd`` and the
    shared experts' ``ws_o``, two under W8A8: the absmax's MAX and the
    int32 sum), the expert combine's sum and the aux/z ``pmean`` of a MoE
    layer, the CE's sum over the batch and, with the vocabulary split, its
    MAX, sum of exponentials and gold logit over the model axis, and the
    prefill's K/V heads gathered for the cache where they are local.  At
    one shard the decode softmax is the unsharded one; on more its max,
    sum and P·V are reduced over the time shards (flash-decoding).  In a
    train step each forward gather's adjoint is a reduce-scatter and each
    sum's a sum (the MAX has none), the blocks' recompute under remat
    re-issues their gathers, attention's sum and, where shared experts
    follow it, the expert combine's sum (PyTorch's checkpoint recomputes a
    block only up to the last tensor its backward saves), then one sum per
    parameter whose spec leaves an axis out, one per set of axes in the
    global norm, and Adafactor's means over sharded dims
    (``optim.adafactor``).  Under ``cfg.seq_shard`` a train step of
    ``seq_len`` positions that ``model`` > 1 divides keeps the stream on
    this rank's rows (``Sharded.seq_split``): every row-parallel sum of a
    block (``wo`` where the q heads are local, ``wd``, the expert combine,
    ``ws_o``) is a reduce-scatter, each block gathers its normed rows twice
    (before attention and before its FFN), the embedding's sum over the
    vocabulary is a reduce-scatter and the final norm's rows are gathered
    for the head; each gather's adjoint is a reduce-scatter and each
    reduce-scatter's a gather, and the recompute runs the gathers again,
    and the sums it ran again before, now reduce-scatters.  The MoE's
    expert-TP layout (E not divided by the axis) is not derived.  The
    recurrent families as ``_recurrent_blocks`` derives their blocks'."""
    from repro_torch.models.transformer import (_ATTN_LEAVES, _FFN_LEAVES,
                                                _KV_LEAVES, moe_mode)

    m, L = cfg.moe, cfg.n_layers
    if m is not None and moe_mode(cfg, model) != "ep":
        raise ValueError("expert-TP collectives are not derived")
    n_moe = 0 if m is None else L - m.n_dense_layers
    split = model > 1                  # the vocabulary over the model axis
    tq = cfg.n_heads % model == 0
    tkv = tq and cfg.n_kv_heads % model == 0
    head = "embed" if cfg.tie_embeddings else "lm_head"
    embed_g = _gathers(specs["embed"], split)
    head_whole = _gathers(specs[head], False)
    if cfg.family != "transformer":
        blk = _recurrent_blocks(cfg, kind, specs, model)
        if kind == "train":
            return _train_collectives(cfg, specs, calls, split, *blk)
        out = {"all_gather": embed_g + head_whole + blk[0],
               "all_reduce": split + blk[1], "reduce_scatter": 0}
        out = {k: v * calls for k, v in out.items()}
        return dict(out, all_to_all=0, send_recv=0)
    attn_tp = attn_whole = ffn_g = 0   # a forward's gathers of the blocks
    for blk, n in (("dense_blocks", L - n_moe), ("moe_blocks", n_moe)):
        for k, spec in specs.get(blk, {}).items():
            if k in _ATTN_LEAVES:
                attn_tp += n * _gathers(spec, tkv if k in _KV_LEAVES else tq)
                attn_whole += n * _gathers(spec, False)
            elif k in _FFN_LEAVES or blk == "moe_blocks":
                ffn_g += n * _gathers(spec, True)
    prod = 2 if cfg.quant == "w8a8_ffn" else 1
    moe_r = 0 if m is None else 2 + (m.n_shared_experts > 0) * prod
    ffn_r = (L - n_moe) * prod + n_moe * moe_r
    attn_r = L * tq                    # wo's sum over local q heads
    if kind == "decode":
        out = {"all_gather": embed_g + head_whole + attn_whole + ffn_g,
               "all_reduce": split + 3 * L * (model > 1) + ffn_r,
               "reduce_scatter": 0}
    elif kind == "prefill":
        out = {"all_gather": embed_g + head_whole + attn_tp + ffn_g
               + 2 * L * tkv,
               "all_reduce": split + attn_r + ffn_r, "reduce_scatter": 0}
    else:
        if cfg.seq_shard and split and seq_len is None:
            raise ValueError("a seq_shard train step needs its seq_len")
        seq = cfg.seq_shard and split and seq_len % model == 0
        blk_g, blk_r = attn_tp + ffn_g + 2 * L * seq, attn_r + ffn_r
        shared = 0 if m is None else n_moe * (m.n_shared_experts > 0)
        re_g, re_r = (blk_g, attn_r + shared) if cfg.remat != "none" \
            else (0, 0)
        blk_s = re_s = 0
        if seq:                        # every sum but the aux/z pmean
            blk_s, blk_r = blk_r - n_moe, n_moe
            re_s, re_r = re_r, 0
        return _train_collectives(cfg, specs, calls, split, blk_g, blk_r,
                                  re_g, re_r, seq, blk_s, re_s)
    out = {k: v * calls for k, v in out.items()}
    return dict(out, all_to_all=0, send_recv=0)


def _gathers(spec, keep_model):
    """The gathers of a leaf of spec ``spec`` for use: one per dim that
    names an axis, but the model dim where ``keep_model``."""
    from repro_torch.parallel.sharding import entry_axes
    return sum(1 for e in spec if entry_axes(e) and not (
        keep_model and entry_axes(e) == ("model",)))


def _train_collectives(cfg, specs, calls, split, blk_g, blk_r, re_g, re_r,
                       seq=False, blk_s=0, re_s=0):
    """A train step's collectives from its blocks' forward gathers and
    sums (``blk_g``, ``blk_r``, and under ``seq`` the reduce-scatters
    ``blk_s``) and those their recompute runs again (``re_g``, ``re_r``,
    ``re_s``): see ``_shard_collectives``."""
    from repro_torch import tree
    from repro_torch.parallel.sharding import entry_axes
    head = "embed" if cfg.tie_embeddings else "lm_head"
    ends = _gathers(specs["embed"], split) + _gathers(specs[head], split)
    ce_f, ce_b = (1 + 3 * split), (1 + 2 * split)  # batch, vocab sums
    named = [{a for e in sp for a in entry_axes(e)}
             for sp in tree.leaves(specs)]
    opt_r = 0                          # Adafactor's means over shards
    for sp in tree.leaves(specs) if cfg.optimizer == "adafactor" else ():
        on = [bool(entry_axes(e)) for e in sp]
        if any(on):                    # the update's RMS; vr, vc, mean(vr)
            opt_r += 1 + (on[-1] + 2 * on[-2] if len(on) >= 2 else 0)
    emb_r = split and not seq        # the embedding's sum, and its adjoint
    emb_s = split and seq            # ... scattered onto the rows
    out = {"all_gather": ends + blk_g + re_g + seq + blk_s + emb_s,
           "reduce_scatter": ends + blk_g + seq + blk_s + re_s + emb_s,
           "all_reduce": (ce_f + emb_r + blk_r + re_r)
           + (ce_b + emb_r + blk_r)
           + sum(a != {"data", "model"} for a in named)
           + len({frozenset(a) for a in named if a}) + opt_r}
    out = {k: v * calls for k, v in out.items()}
    return dict(out, all_to_all=0, send_recv=0)


def _recurrent_blocks(cfg, kind, specs, model):
    """The gathers and sums of an rwkv6 or griffin call's blocks under a
    ShardCtx on a (1, ``model``) mesh: (gathers, sums) for a prefill or a
    decode step, (gathers, sums, and those the recompute runs again) for a
    train step's forward.  Where a block runs tensor-parallel (``model`` >
    1 dividing rwkv6's heads, griffin's width) its leaves keep their model
    dims, and it sums each row-parallel product (rwkv6's ``wo`` and
    ``cm_wv``; griffin's ``w_out``, each MLP's ``mlp_o``, and attention's
    ``wo`` where the axis divides the q heads, whose leaves then keep it,
    the k/v leaves where it divides the KV heads too); griffin gathers
    each recurrent block's conv output for ``w_a``/``w_i``.  Otherwise
    every leaf is gathered whole.  A prefill gathers a tensor-parallel
    rwkv6 layer's WKV state (replicated in the cache) and a griffin
    attention layer's local K/V heads; a decode step the WKV state too,
    and the cache's shift states (rwkv6's ``tm_x``, ``cm_x``) or, where
    griffin does not run tensor-parallel, its ``conv`` and ``h``.  Decode
    attention gathers its leaves whole.  Under remat a rwkv6 layer's
    recompute runs its gathers and both sums again (``cm_wv``'s is saved
    for the product with the receptance), a griffin super-block's all its
    gathers and all its sums but the last (its attention MLP's); the tail
    is not recomputed."""
    from repro_torch.models.transformer import _KV_LEAVES, _Q_LEAVES
    L = cfg.n_layers
    remat = kind == "train" and cfg.remat != "none"
    if cfg.family == "rwkv":
        tp = model > 1 and (cfg.d_model // cfg.recurrent.head_dim) % model \
            == 0
        g = L * sum(_gathers(sp, tp) for sp in specs["blocks"].values())
        r = 2 * L * tp
        if kind == "train":
            return (g, r) + ((g, r) if remat else (0, 0))
        return (g + L * tp + 2 * (kind == "decode"), r)
    n_super = L // 3
    W = cfg.recurrent.lru_width or cfg.d_model
    tp = model > 1 and W % model == 0
    tq = tp and kind != "decode" and cfg.n_heads % model == 0
    tkv = tq and cfg.n_kv_heads % model == 0
    keep = dict.fromkeys(_Q_LEAVES, tq) | dict.fromkeys(_KV_LEAVES, tkv)

    def block(name):
        """(gathers, sums) of one block of the stack ``name``."""
        g = sum(_gathers(sp, keep.get(k, tp))
                for k, sp in specs[name].items())
        if name == "attn_blocks":
            return g + 2 * tkv * (kind == "prefill"), tq + tp
        return g + tp, 2 * tp
    rg, rr = block("rec_blocks") if n_super else (0, 0)
    ag, ar = block("attn_blocks") if n_super else (0, 0)
    tg, tr = block("tail_rec") if "tail_rec" in specs else (0, 0)
    n_tail = L - 3 * n_super
    g = n_super * (2 * rg + ag) + n_tail * tg
    r = n_super * (2 * rr + ar) + n_tail * tr
    if kind == "train":
        if not remat:
            return g, r, 0, 0
        return g, r, n_super * (2 * rg + ag), n_super * (2 * rr + ar - tp)
    return g + 2 * (kind == "decode" and not tp), r


def _add(a, b):
    return {k: a[k] + b[k] for k in a}


def _shard_serve(label, cfg, params, prompt, ctx, gen, failed):
    """A ``prompt``-token prefill and SHARD_STEPS decode steps at batch 1,
    under ``ctx=None`` and under ``ctx`` on the parameters' shards
    (``shard_tree``): the logits torch.equal, finite; rows 4 and 9 launched
    as often under both and as derived; the collectives as
    ``_shard_collectives`` derives (none without the ctx); the prefill ms
    and the decode ms/step of each."""
    from repro_torch.models import api
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import param_specs, shard_tree
    specs = param_specs(cfg, params, ctx.dp, ctx.model, ctx.mesh)
    local = shard_tree(params, specs, ctx.mesh)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                         device=DEVICE)
    step_toks = torch.randint(0, cfg.vocab_size, (SHARD_STEPS, 1),
                              generator=gen, device=DEVICE)
    runs = {}
    for name, c, p in (("none", None, params), ("ctx", ctx, local)):
        before = _campaign_launches()
        C.reset_counts()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = api.prefill(cfg, p, toks, prompt + SHARD_STEPS, c)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps = []
            for tok in step_toks:
                step, cache = api.decode_step(cfg, p, tok, cache, c)
                steps.append(step)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        after = _campaign_launches()
        counts = C.counts()
        runs[name] = {"logits": (lg, torch.stack(steps)),
                      "prefill_ms": (t1 - t0) * 1e3,
                      "decode_ms_per_step": (t2 - t1) * 1e3 / SHARD_STEPS,
                      "launches": {k: after[k] - before[k]
                                   for k in SHARD_ROWS[:2]},
                      "collectives": counts}
        del cache, lg, steps
    equal = all(torch.equal(a, b) for a, b in zip(runs["none"]["logits"],
                                                  runs["ctx"]["logits"]))
    finite = all(bool(torch.isfinite(t).all())
                 for t in runs["ctx"]["logits"])
    want_l = {"qmatmul_acc": _row4_per_call(cfg) * (1 + SHARD_STEPS),
              "flash_attention_fwd_lse": cfg.n_layers}
    launched = runs["ctx"]["launches"] == runs["none"]["launches"] == want_l
    want_c = _add(_shard_collectives(cfg, "prefill", specs),
                  _shard_collectives(cfg, "decode", specs, calls=SHARD_STEPS))
    none_c = {k: 0 for k in want_c}
    counted = (runs["ctx"]["collectives"] == want_c
               and runs["none"]["collectives"] == none_c)
    ok = equal and finite and launched and counted
    r, n = runs["ctx"], runs["none"]
    print(f"shard: {label} serving, a {prompt}-token prefill and "
          f"{SHARD_STEPS} decode steps at batch 1: logits under the ctx "
          f"torch.equal to ctx=None: {equal}, finite: {finite}; launches "
          f"{r['launches']} = ctx=None's = derived: {launched}; collectives "
          f"{r['collectives']} = derived {want_c} (none without the ctx): "
          f"{counted}; prefill {r['prefill_ms']:.2f} ms (ctx=None "
          f"{n['prefill_ms']:.2f}), decode {r['decode_ms_per_step']:.3f} "
          f"ms/step (ctx=None {n['decode_ms_per_step']:.3f})"
          + ("" if ok else "  FAILED"))
    if not ok:
        failed.append(f"{label} serving")
    for v in runs.values():
        del v["logits"]
    del local, specs
    return {"runs": runs, "logits_equal": equal, "finite": finite,
            "launches_as_unsharded": launched,
            "collectives_as_derived": counted,
            "collectives_derived": want_c}


def _shard_train(label, cfg, host, batches, ctx, want, failed):
    """Train steps under ``ctx`` from the host-held start ``host`` on the
    parameters' shards (``shard_tree``; the config's optimizer, its state
    from ``init``), each batch this rank's slice (``shard_batch``):
    losses ``==`` and final parameters torch.equal to ``want`` (the
    unsharded run: "losses", "params" on the host, "launches", "ms");
    rows 9 and 10 launched as often; the collectives as derived."""
    from repro_torch import tree
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.train import optim, steps
    opt = optim.make_optimizer(cfg.optimizer)
    specs = steps.train_state_specs(cfg, host, ctx.dp, ctx.model,
                                    cfg.optimizer, ctx.mesh)
    params = shard_tree(host, specs.params, ctx.mesh)
    state = steps.TrainState(params, opt.init(params), torch.zeros(
        (), dtype=torch.int32, device=DEVICE))
    del params
    step = steps.make_train_step(cfg, ctx, optimizer=opt)
    local = [shard_batch({k: v.cpu().numpy() for k, v in b.items()},
                         ctx.mesh, ctx.dp) for b in batches]
    before = _campaign_launches()
    C.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in local:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(local)
    after = _campaign_launches()
    launches = {k: after[k] - before[k] for k in SHARD_ROWS}
    collectives = C.counts()
    same = all(torch.equal(a, b.to(DEVICE)) for a, b in zip(
        tree.leaves(state.params), tree.leaves(want["params"])))
    replay = losses == want["losses"]
    launched = launches == {k: want["launches"][k] for k in SHARD_ROWS}
    want_c = _shard_collectives(cfg, "train", specs.params, calls=len(local))
    counted = collectives == want_c
    ok = replay and same and launched and counted
    print(f"shard: {label} training under the ctx, {len(local)} steps from "
          f"the unsharded run's start: losses {[f'{x:.6f}' for x in losses]}"
          f" == ctx=None's: {replay}; parameters torch.equal: {same}; "
          f"launches {launches} = ctx=None's: {launched}; collectives "
          f"{collectives} = derived {want_c}: {counted}; {ms:.1f} ms/step "
          f"(ctx=None {want['ms']:.1f})" + ("" if ok else "  FAILED"))
    if not ok:
        failed.append(f"{label} training")
    del state, metrics
    return {"losses": losses, "losses_equal": replay, "params_equal": same,
            "launches": launches, "launches_as_unsharded": launched,
            "collectives": collectives, "collectives_derived": want_c,
            "collectives_as_derived": counted, "ms_per_step": ms,
            "unsharded_ms_per_step": want["ms"]}


def phase_shard(card: str, start: dict) -> dict:
    """Slice 16: the sharded paths under NCCL at world size 1, in this
    process, on a (1, 1) ("data", "model") mesh: mixtral-8x7b at full width
    with 2 of its 32 layers (W8A8 FFN and experts, bf16, flash, FSDP, EP)
    served (``_shard_serve``: a SHARD_MOE_PROMPT-token prefill and
    SHARD_STEPS decode steps) and trained (``_shard_train``: the steps of
    phase 20's first run from its host-held ``start``, against that run);
    then qwen3-0.6b in full served (a SHARD_DENSE_PROMPT-token prefill)
    and trained one step (bf16 compute, AdamW, remat, flash) from clones
    of one host-held state, ``ctx=None`` first (after a step outside the
    timer).  Each group's communicator is set up before the first timed
    run.  Every collective is a
    one-rank NCCL call: copies, so each result must be the unsharded
    path's bit for bit.  Launch counts are reset at its start and read at
    its end; the process group is torn down at its end."""
    import dataclasses as dc
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import Mesh, process_group
    from repro_torch.models.shard import ShardCtx
    from repro_torch.parallel import collectives as C
    from repro_torch.train import optim, steps
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    with process_group(DEVICE):
        mesh = Mesh((1, 1), ("data", "model"))
        ctx = ShardCtx(mesh, ("data",), "model")
        # each group's NCCL communicator is set up on its first call: make
        # those calls here, outside every timed run
        for axes in (("data",), ("model",), ("data", "model")):
            C.all_reduce(torch.zeros(1, device=DEVICE), mesh, axes)
        torch.cuda.synchronize()
        tcfg = start["cfg"]
        scfg = dc.replace(tcfg, quant="w8a8_ffn")
        params, _ = _card_params(scfg, 21)
        out["mixtral-8x7b serve"] = _shard_serve(
            "mixtral-8x7b (2 of 32 layers, W8A8, FSDP, EP)", scfg, params,
            SHARD_MOE_PROMPT, ctx, gen, failed)
        del params
        torch.cuda.empty_cache()
        run = start["run"]
        out["mixtral-8x7b train"] = _shard_train(
            "mixtral-8x7b (2 of 32 layers, bf16, AdamW)", tcfg,
            start["host"], start["batches"], ctx,
            {"losses": run["losses"], "params": start["first"],
             "launches": run["launches"], "ms": run["ms_per_step"]}, failed)
        start.pop("first")          # "host" stays for phase_item17
        torch.cuda.empty_cache()
        full = registry.get("qwen3-0.6b")
        qcfg = dc.replace(full, quant="w8a8_ffn", attn_impl="flash")
        params, _ = _card_params(qcfg, 22)
        out["qwen3-0.6b serve"] = _shard_serve(
            "qwen3-0.6b (28 layers, in full, W8A8)", qcfg, params,
            SHARD_DENSE_PROMPT, ctx, gen, failed)
        del params
        tcfg = dc.replace(full, attn_impl="flash")
        params, _ = _card_params(tcfg, 23)
        host = tree.map(lambda t: t.to("cpu", copy=True), params)
        del params
        batches = _train_batches(tcfg, SHARD_DENSE_PROMPT)[:1]
        opt = optim.make_optimizer(tcfg.optimizer)
        params = tree.map(lambda t: t.to(DEVICE, copy=True), host)
        state = steps.TrainState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=DEVICE))
        del params
        step = steps.make_train_step(tcfg, optimizer=opt)
        warm = tree.map(torch.clone, state)     # a step outside the timer
        step(warm, batches[0])
        del warm
        before = _campaign_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[0])
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = _campaign_launches()
        want = {"losses": [loss], "ms": ms,
                "params": tree.map(lambda t: t.to("cpu", copy=True),
                                   state.params),
                "launches": {k: after[k] - before[k] for k in SHARD_ROWS}}
        del state, metrics
        torch.cuda.empty_cache()
        out["qwen3-0.6b train"] = _shard_train(
            "qwen3-0.6b (28 layers, in full, AdamW)", tcfg, host, batches,
            ctx, want, failed)
        del host, want
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    return _phase_end("shard", out, failed, SHARD_ROWS, peak,
                      SHARD_BUDGET_S, t_phase, card)


# slice 17: pipeline parallelism, the sharded FT loop, the dry-run on the card
ITEM17_MICRO = 4                   # microbatches of the pipeline
ITEM17_SEQ = 1024                  # tokens per microbatch, and qwen3's train step
ITEM17_PEAK_RTOL = 0.15            # the dry-run's peak against the card's rise
ITEM17_CKPT_EVERY = 8              # the NaN drill's saves: steps 0 and 8
ITEM17_ROWS = ("qmatmul_acc", "flash_attention_fwd_lse", "flash_attention_bwd")
ITEM17_BUDGET_S = 60               # the phase's share of the limit


def _item17_pipeline(mesh, gen, failed):
    """``pipeline_apply`` over the one-rank "stage" axis ``mesh`` with
    qwen3-0.6b in full (28 layers, bf16, flash) as the stage, on
    ITEM17_MICRO microbatches of 1 x ITEM17_SEQ embeddings, against a plain
    loop of the same blocks: the outputs and the stage gradients of
    mean(out²) torch.equal; rows 9 and 10 launched as derived (the
    pipeline's forward, its checkpoint's recompute and the backward: 2·M·L
    and M·L; the plain loop M·L each)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.parallel import pipeline as pp
    from repro_torch.parallel.sharding import P, shard_tree
    cfg = dataclasses.replace(registry.get("qwen3-0.6b"), attn_impl="flash")
    params, _ = _card_params(cfg, 25)
    blocks = {"dense_blocks": params["dense_blocks"]}
    del params
    stacked = pp.stack_stage_params([blocks])
    local = shard_tree(stacked, tree.map(lambda _: P("stage"), stacked), mesh)
    del blocks, stacked
    leaves = [t.requires_grad_() for t in tree.leaves(local)]
    mbs = torch.randn((ITEM17_MICRO, 1, ITEM17_SEQ, cfg.d_model),
                      generator=gen, device=DEVICE).to(torch.bfloat16)

    def stage(p, x):
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        for bp, moe in T._blocks(p):
            x = T._block(cfg, bp, x, pos, moe)[0]
        return x

    def grads(out):
        loss = (out.float() ** 2).mean()
        return torch.autograd.grad(loss, leaves, grad_outputs=torch.ones_like(
            loss) / mesh.size(mesh.axis_names))

    runs = {}
    for name in ("pipeline", "plain"):
        before = _campaign_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "pipeline":
            out = pp.pipeline_apply(stage, local, mbs, mesh)
        else:
            view = tree.map(lambda x: x[0], local)
            out = torch.stack([stage(view, mbs[i])
                               for i in range(ITEM17_MICRO)])
        g = grads(out)
        torch.cuda.synchronize()
        after = _campaign_launches()
        runs[name] = {"out": out.detach(), "grads": g,
                      "s": time.perf_counter() - t0,
                      "launches": {k: after[k] - before[k]
                                   for k in ITEM17_ROWS}}
        del out
    a, b = runs["pipeline"], runs["plain"]
    equal = torch.equal(a["out"], b["out"]) and all(
        torch.equal(x, y) for x, y in zip(a["grads"], b["grads"]))
    ML = ITEM17_MICRO * cfg.n_layers
    want = {"pipeline": {"qmatmul_acc": 0, "flash_attention_fwd_lse": 2 * ML,
                         "flash_attention_bwd": ML},
            "plain": {"qmatmul_acc": 0, "flash_attention_fwd_lse": ML,
                      "flash_attention_bwd": ML}}
    launched = all(runs[k]["launches"] == want[k] for k in runs)
    ok = equal and launched
    print(f"item17: pipeline of qwen3-0.6b (28 layers, bf16, flash) over a "
          f"one-rank stage axis, {ITEM17_MICRO} microbatches of 1 x "
          f"{ITEM17_SEQ}: outputs and stage gradients torch.equal to the "
          f"plain loop: {equal}; launches {a['launches']} / "
          f"{b['launches']} = derived: {launched}; {a['s']:.2f} s "
          f"(plain {b['s']:.2f} s)" + ("" if ok else "  FAILED"))
    if not ok:
        failed.append("pipeline")
    del local, leaves, mbs
    torch.cuda.empty_cache()
    return {"equal": equal, "launches_as_derived": launched,
            "launches": {k: r["launches"] for k, r in runs.items()},
            "seconds": {k: r["s"] for k, r in runs.items()}}


def _item17_ft_loop(tcfg, shape, mesh, clean_losses, failed):
    """``ft_loop.run(mesh=)`` on the (1, 1) mesh: SmolLM-135M in full at
    TRAIN_BATCH x TRAIN_SEQ for TRAIN_STEPS steps with the NaN drill at
    TRAIN_NAN_STEP (one recovery), its losses ``==`` the unsharded loop's
    clean run (phase 10): every step of the sharded loop, the replayed one
    included, is the unsharded step bit for bit.  Rows 9 and 10 as derived
    per step executed.  Each save writes the 1.6 GB state: the drill saves
    every ITEM17_CKPT_EVERY steps (it restores step 8)."""
    from repro_torch.runtime import ft_loop
    L = tcfg.n_layers
    reps, secs, fired = {}, {}, []
    before = _campaign_launches()

    def nan_hook(step, state):
        if step == TRAIN_NAN_STEP and not fired:
            fired.append(step)
            embed = state.params["embed"].clone()
            embed.view(-1)[0] = float("nan")
            return state._replace(params=dict(state.params, embed=embed))
        return None

    with tempfile.TemporaryDirectory(prefix="chip_smoke_item17_") as root:
        for name, hook, every in (("nan", nan_hook, ITEM17_CKPT_EVERY),):
            t0 = time.perf_counter()
            reps[name] = ft_loop.run(
                tcfg, shape, ft_loop.FTConfig(
                    ckpt_dir=os.path.join(root, name), ckpt_every=every),
                n_steps=TRAIN_STEPS, fault_hook=hook, mesh=mesh)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            shutil.rmtree(os.path.join(root, name))
    after = _campaign_launches()
    executed = sum(_executed(r) for r in reps.values())
    launches = {k: after[k] - before[k] for k in ITEM17_ROWS}
    want = {"qmatmul_acc": 0, "flash_attention_fwd_lse": 2 * L * executed,
            "flash_attention_bwd": L * executed}
    nan = reps["nan"]
    replay = nan.losses == clean_losses and nan.recoveries == 1
    ok = replay and launches == want
    print(f"item17: sharded FT loop, {ARCH} in full on a (1, 1) mesh, "
          f"{TRAIN_STEPS} steps of {shape.global_batch} x {shape.seq_len}: "
          f"NaN-drill losses == the unsharded clean run's: "
          f"{replay} ({nan.recoveries} recovery, {nan.steps_replayed} "
          f"replayed); launches {launches} = derived {want}: "
          f"{launches == want}; {secs['nan']:.2f} s"
          + ("" if ok else "  FAILED"))
    if not ok:
        failed.append("sharded FT loop")
    return {"losses_equal": replay, "recoveries": nan.recoveries,
            "steps_replayed": nan.steps_replayed, "launches": launches,
            "launches_as_derived": launches == want, "seconds": secs}


def _item17_cells(start):
    """The dry-run's cells, each with the real inputs the card runs:
    qwen3-0.6b in full, a train step at 1 x ITEM17_SEQ (weights drawn on
    the card); mixtral-8x7b at 2 of 32 layers (FSDP, EP) trained one step
    at 1 x MOE_TRAIN_SEQ from phase 20's host-held start, and its W8A8
    prefill at 1 x MOE_TRAIN_SEQ from the same weights quantized.  Yields
    (label, cfg, shape, the step's arguments on the card: whole tensors,
    which on a (1, 1) mesh are this rank's shards), one cell at a time."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import optim, steps

    def state_of(params, cfg):
        return steps.TrainState(params, optim.make_optimizer(
            cfg.optimizer).init(params), torch.zeros(
                (), dtype=torch.int32, device=DEVICE))

    def batch(cfg, shape):
        b = TokenStream(cfg, shape).batch_at(0)
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()
                if shape.kind == "train" or k == "tokens"}

    qcfg = dataclasses.replace(registry.get("qwen3-0.6b"), attn_impl="flash")
    qshape = ShapeConfig("train_1k", ITEM17_SEQ, 1, "train")
    yield ("qwen3-0.6b train", qcfg, qshape,
           [state_of(_card_params(qcfg, 26)[0], qcfg), batch(qcfg, qshape)])
    mcfg = start["cfg"]
    mshape = ShapeConfig("train_4608", MOE_TRAIN_SEQ, 1, "train")

    def card(host):
        return tree.map(lambda t: t.to(DEVICE, copy=True), host)

    yield ("mixtral-8x7b train", mcfg, mshape,
           [state_of(card(start["host"]), mcfg), batch(mcfg, mshape)])
    scfg = dataclasses.replace(mcfg, quant="w8a8_ffn")
    pshape = ShapeConfig("prefill_4608", MOE_TRAIN_SEQ, 1, "prefill")
    yield ("mixtral-8x7b W8A8 prefill", scfg, pshape,
           [T.quantize_ffn_params(scfg, card(start.pop("host"))),
            batch(scfg, pshape)])


def _item17_dryrun_cells():
    """(label, cfg, shape) of ``_item17_cells`` without their inputs."""
    from repro_torch.configs import registry
    from repro_torch.models.config import ShapeConfig
    qcfg = dataclasses.replace(registry.get("qwen3-0.6b"), attn_impl="flash")
    mcfg = dataclasses.replace(registry.get("mixtral-8x7b"),
                               n_layers=MOE_TRAIN_LAYERS, attn_impl="flash")
    return [("qwen3-0.6b train", qcfg,
             ShapeConfig("train_1k", ITEM17_SEQ, 1, "train")),
            ("mixtral-8x7b train", mcfg,
             ShapeConfig("train_4608", MOE_TRAIN_SEQ, 1, "train")),
            ("mixtral-8x7b W8A8 prefill",
             dataclasses.replace(mcfg, quant="w8a8_ffn"),
             ShapeConfig("prefill_4608", MOE_TRAIN_SEQ, 1, "prefill"))]


def _item17_on_card(mesh, start, dry, failed):
    """Each cell's step (``dryrun.build_cell``'s, whose meta inputs must
    have the card inputs' shapes and dtypes leaf for leaf) for real on the
    card under ``op_analysis`` against ``dry`` (the dry-run's records, run
    on meta in a spawned child): FLOPs by dtype (kernel rows included),
    collective counts and bytes per kind, argument bytes and the tracked
    peak equal; the dry-run's peak of new storages within ITEM17_PEAK_RTOL
    of the step's ``max_memory_allocated`` rise.  Returns the records and
    the largest device peak seen."""
    from repro_torch import tree
    from repro_torch.launch import dryrun, op_analysis
    out, peak = {}, 0

    def layout(t):
        return [(tuple(x.shape), x.dtype) for x in tree.leaves(t)]

    for (label, cfg, shape, args), (_, dcfg, dshape), rec in zip(
            _item17_cells(start), _item17_dryrun_cells(), dry):
        fn, abstract = dryrun.build_cell(cfg, shape, mesh, device="meta")
        if (cfg, shape) != (dcfg, dshape) or \
                layout(abstract) != layout(args):
            failed.append(f"{label}: the dry-run's cell is not the card's")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        peak = max(peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res, an = op_analysis.analyze(fn, *args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated())
        rise = torch.cuda.max_memory_allocated() - base
        args.clear()            # a zip holds its last items: free them here
        del res, fn
        card_sum, card_mem = an.summary(), an.memory_analysis()
        dsum, dmem = rec["op_analysis"], rec["memory_analysis"]
        same = {k: card_sum[k] == dsum[k] for k in
                ("flops_by_dtype", "collective_counts", "collective_bytes")}
        same.update({k: card_mem[k] == dmem[k] for k in
                     ("argument_size_in_bytes", "peak_bytes")})
        ratio = dmem["peak_live_bytes"] / rise
        ok = all(same.values()) and abs(ratio - 1) <= ITEM17_PEAK_RTOL
        print(f"item17: dry-run of {label} at 1 x {shape.seq_len} on a (1, 1)"
              f" mesh against the card: equal {same}; flops "
              f"{card_sum['flops_by_dtype']}; collectives "
              f"{card_sum['collective_counts']}; args "
              f"{card_mem['argument_size_in_bytes'] / 1e9:.3f} GB; tracked "
              f"peak {card_mem['peak_bytes'] / 1e9:.3f} GB (dry "
              f"{dmem['peak_bytes'] / 1e9:.3f}); predicted rise "
              f"{dmem['peak_live_bytes'] / 1e9:.3f} GB against the card's "
              f"max_memory_allocated rise {rise / 1e9:.3f} GB (ratio "
              f"{ratio:.4f}, limit 1 ± {ITEM17_PEAK_RTOL}); step under the "
              f"analysis {secs:.2f} s, dry-run {rec['run_s']:.2f} s"
              + ("" if ok else "  FAILED"))
        if not ok:
            failed.append(f"dry-run of {label}")
            print(f"  card {card_mem} {card_sum}\n  dry {dmem} {dsum}")
        out[label] = {"equal": same, "card_memory": card_mem,
                      "dry_memory": dmem, "rise_bytes": rise,
                      "peak_ratio": ratio, "flops_by_dtype":
                      card_sum["flops_by_dtype"], "collective_counts":
                      card_sum["collective_counts"], "seconds": secs,
                      "dry_run_s": rec["run_s"]}
        torch.cuda.empty_cache()
    return out, peak


# the vocabulary split over the model axis: qwen3-0.6b's train cell as
# rank 0 of a fake (1, 16) mesh, on the card; and tensor parallelism inside
# the recurrence: recurrentgemma-2b's train_4k cell at pod16x16 likewise
VOCAB_MESH = (1, 16)
VOCAB_ROWS = 8                     # rows of TRAIN_4K_SEQ tokens
REC_TP_ROWS = 16                   # train_4k's rows per data rank at pod16x16
REC_TP_PEAK_BYTES = 70e9           # the cell's tracked peak a rank, limit
# the same cell's dry-run peak a rank with every recurrent layer gathered
# whole on each model rank (``python -m repro_torch.launch.dryrun --arch
# recurrentgemma-2b --shape train_4k`` before the layers ran on their
# shards), printed beside the cell's
REC_TP_REPLICATED_GB = 84.16
# sequence parallelism: command-r-plus-104b's train_4k cell under
# seq_shard, cut to the largest depth whose weights drawn whole on the card
# (with the f32 draw of the leaf being drawn), then beside this rank's
# shards of the state, stay under SEQ_DRAW_PEAK_BYTES (sized from the
# leaves of ``train.steps.abstract_train_state``, the dry-run's meta state)
SEQ_LAYERS = 10
SEQ_ROWS = 16                      # train_4k's rows per data rank at pod16x16
# the child's peak through the draw, limit: 60 GB, so that the pipeline
# and the FT loop running beside it in this process have room
SEQ_DRAW_PEAK_BYTES = 60e9


def _vocab_cell():
    """(cfg, shape) of the vocab-split cell: qwen3-0.6b in full (28
    layers, AdamW, remat save_dots), flash, VOCAB_ROWS x TRAIN_4K_SEQ."""
    from repro_torch.configs import registry
    from repro_torch.models.config import ShapeConfig
    return (dataclasses.replace(registry.get("qwen3-0.6b"),
                                attn_impl="flash"),
            ShapeConfig(f"train_{VOCAB_ROWS}x{TRAIN_4K_SEQ}", TRAIN_4K_SEQ,
                        VOCAB_ROWS, "train"))


def _rec_tp_cell():
    """(cfg, shape) of the recurrent tensor-parallel cell: recurrentgemma-2b
    in full (26 layers, AdamW, remat save_dots), REC_TP_ROWS x
    TRAIN_4K_SEQ."""
    from repro_torch.configs import registry
    from repro_torch.models.config import ShapeConfig
    return (registry.get("recurrentgemma-2b"),
            ShapeConfig(f"train_{REC_TP_ROWS}x{TRAIN_4K_SEQ}", TRAIN_4K_SEQ,
                        REC_TP_ROWS, "train"))


def _seq_cell(seq=True):
    """(cfg, shape) of the sequence-parallel cell: command-r-plus-104b at
    SEQ_LAYERS of 64 layers (full width, AdamW, remat full, FSDP), flash,
    ``seq_shard`` (off for the dry-run beside it), SEQ_ROWS x
    TRAIN_4K_SEQ."""
    from repro_torch.configs import registry
    from repro_torch.models.config import ShapeConfig
    return (dataclasses.replace(registry.get("command-r-plus-104b"),
                                n_layers=SEQ_LAYERS, attn_impl="flash",
                                seq_shard=seq),
            ShapeConfig(f"train_{SEQ_ROWS}x{TRAIN_4K_SEQ}", TRAIN_4K_SEQ,
                        SEQ_ROWS, "train"))


class VocabDry:
    """The dry-run (``launch.dryrun.run_cells`` on meta) of the vocab-split
    cell at VOCAB_MESH and, for the whole-vocabulary step beside it, at a
    (1, 1) mesh, of the recurrent tensor-parallel cell at VOCAB_MESH, and
    of the sequence-parallel cell at VOCAB_MESH with ``seq_shard`` on and
    off, in a spawned child started early (~40, ~40, ~15, ~10 and ~10 s of
    CPU)."""

    def __init__(self):
        from repro_torch.launch import dryrun
        cfg, shape = _vocab_cell()
        rcfg, rshape = _rec_tp_cell()
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=__import__("multiprocessing").get_context("spawn"))
        self.run = self.pool.submit(dryrun.run_cells, [
            (cfg, shape, VOCAB_MESH), (cfg, shape, (1, 1)),
            (rcfg, rshape, VOCAB_MESH), (*_seq_cell(), VOCAB_MESH),
            (*_seq_cell(False), VOCAB_MESH)])

    def result(self):
        """The five records, waiting at most TRAIN_DRY_WAIT_S."""
        try:
            return self.run.result(TRAIN_DRY_WAIT_S)
        finally:
            self.pool.shutdown(cancel_futures=True)


def _fake_rank_cells():
    """The vocab-split cell's step, the recurrent tensor-parallel cell's
    and the sequence-parallel cell's, each for real on the card as rank 0
    of a fake VOCAB_MESH group (``_fake_rank_step``), in a spawned child
    (its fake process groups never meet the caller's NCCL group): their
    records by name."""
    return {"vocab": _fake_rank_step(*_vocab_cell(), seed=32),
            "rec_tp": _fake_rank_step(*_rec_tp_cell(), seed=33),
            "seq": _fake_rank_step(*_seq_cell(), seed=34)}


def _fake_rank_step(cfg, shape, seed):
    """One train step of (``cfg``, ``shape``) for real on the card as rank
    0 of a fake VOCAB_MESH group (``dryrun.fake_process_group``, whose
    collectives move nothing, so no value is checked), the seeded state
    (``steps.init_train_state``'s) cut by ``dryrun.build_cell`` into this
    rank's shards: the parameters drawn whole on the card, the optimizer's
    zero moments as views of one zero each, so that only their shards take
    memory; the step run under ``launch.op_analysis``.  Returns its
    summary and memory analysis, the ``max_memory_allocated`` rise over
    the arguments, its peak through the draw and the cut, rows 9 and 10's
    launches, the collectives ``_shard_collectives`` derives for it and
    its seconds."""
    from repro_torch import tree
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flashattn import kernel as FK
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.train import optim, steps
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with dryrun.fake_process_group(math.prod(VOCAB_MESH)):
        mesh = make_mesh(VOCAB_MESH, ("data", "model"), device=DEVICE)
        params = api.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(seed),
            device=DEVICE)
        moments = optim.make_optimizer(cfg.optimizer).init(
            tree.map(lambda t: t.to("meta"), params))
        state = steps.TrainState(params, tree.map(
            lambda t: torch.zeros((), dtype=t.dtype, device=DEVICE).expand(
                t.shape), moments), torch.zeros((), dtype=torch.int32,
                                                device=DEVICE))
        del params, moments
        derived = _shard_collectives(
            cfg, "train", param_specs(cfg, state.params, ("data",), "model",
                                      mesh), model=VOCAB_MESH[1],
            seq_len=shape.seq_len)
        batch = {k: torch.from_numpy(v) for k, v in
                 TokenStream(cfg, shape).batch_at(0).items()}
        fn, args = dryrun.build_cell(cfg, shape, mesh, state=state,
                                     batch=batch)
        del state, batch
        torch.cuda.synchronize()
        draw_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        FK.reset_launches()
        t1 = time.perf_counter()
        res, an = op_analysis.analyze(fn, *args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        rise = torch.cuda.max_memory_allocated() - base
        del res, args
    return {"summary": an.summary(), "memory": an.memory_analysis(),
            "rise": rise, "draw_peak": draw_peak,
            "launches": {k.__name__: k.launches for k in FK.KERNELS},
            "derived": derived, "step_s": step_s,
            "seconds": time.perf_counter() - t0}


def _item17_vocab_split(card_run, dry, failed):
    """The vocab-split cell on the card (``card_run``, ``_fake_rank_step``'s
    record) against its dry-run on meta (``dry``, ``VocabDry``'s first two
    records):
    FLOPs by dtype (kernel rows included), collective counts and bytes per
    kind, argument bytes and the tracked peak equal; the collective counts
    as ``_shard_collectives`` derives them; the predicted rise within
    ITEM17_PEAK_RTOL of the card's; rows 9 and 10 launched 2·L and L times
    (the forward and its recompute, the backward).  The (1, 1) dry-run's
    predicted peak, the step with the vocabulary whole, is printed beside
    it."""
    cfg, shape = _vocab_cell()
    rec, whole = dry
    card_sum, card_mem = card_run["summary"], card_run["memory"]
    dmem = rec["memory_analysis"]
    same, derived, counted, ratio = _fake_rank_holds(card_run, rec)
    L = cfg.n_layers
    want_l = {"flash_attention_fwd_lse": (2 if cfg.remat != "none" else 1)
              * L, "flash_attention_bwd": L}
    launched = {k: card_run["launches"][k] for k in want_l} == want_l
    ok = all(same.values()) and counted and launched and \
        abs(ratio - 1) <= ITEM17_PEAK_RTOL
    print(f"item17: vocab split, {cfg.name} in full (flash, "
          f"{cfg.optimizer}) train step at {shape.global_batch} x "
          f"{shape.seq_len} as rank 0 of a fake {VOCAB_MESH} mesh on the "
          f"card (the collectives move nothing: values not checked): equal "
          f"to the dry-run {same}; collectives {card_sum['collective_counts']}"
          f" = derived: {counted}; launches {card_run['launches']} = derived "
          f"{want_l}: {launched}; args "
          f"{card_mem['argument_size_in_bytes'] / 1e9:.3f} GB; predicted "
          f"rise {dmem['peak_live_bytes'] / 1e9:.3f} GB against the card's "
          f"{card_run['rise'] / 1e9:.3f} GB (ratio {ratio:.4f}, limit 1 ± "
          f"{ITEM17_PEAK_RTOL}); predicted peak "
          f"{dmem['peak_bytes'] / 1e9:.3f} GB a rank, at a (1, 1) mesh "
          f"(the vocabulary whole) {whole['memory_analysis']['peak_bytes'] / 1e9:.3f}"
          f" GB; step {card_run['step_s']:.2f} s, child "
          f"{card_run['seconds']:.2f} s, dry-runs {rec['run_s']:.2f} + "
          f"{whole['run_s']:.2f} s" + ("" if ok else "  FAILED"))
    if not ok:
        failed.append("the vocab-split cell")
        print(f"  card {card_mem} {card_sum}\n  dry {dmem} "
              f"{rec['op_analysis']}\n  derived {derived}")
    return {"equal": same, "collectives_as_derived": counted,
            "launches": card_run["launches"], "launches_as_derived":
            launched, "card_memory": card_mem, "dry_memory": dmem,
            "rise_bytes": card_run["rise"], "peak_ratio": ratio,
            "whole_vocab_peak_bytes": whole["memory_analysis"]["peak_bytes"],
            "flops_by_dtype": card_sum["flops_by_dtype"],
            "collective_counts": card_sum["collective_counts"],
            "step_s": card_run["step_s"], "child_s": card_run["seconds"],
            "dry_run_s": [rec["run_s"], whole["run_s"]]}


def _fake_rank_holds(card_run, rec):
    """A fake-rank cell on the card (``_fake_rank_step``'s record) against
    its dry-run on meta (``rec``): which of FLOPs by dtype, collective
    counts and bytes, argument bytes and the tracked peak are equal; the
    collectives ``_shard_collectives`` derives, under op_analysis's names,
    and whether the card's counts are they; the predicted rise over the
    card's."""
    from repro_torch.launch.op_analysis import _KIND
    card_sum, card_mem = card_run["summary"], card_run["memory"]
    dsum, dmem = rec["op_analysis"], rec["memory_analysis"]
    same = {k: card_sum[k] == dsum[k] for k in
            ("flops_by_dtype", "collective_counts", "collective_bytes")}
    same.update({k: card_mem[k] == dmem[k] for k in
                 ("argument_size_in_bytes", "peak_bytes")})
    derived = {_KIND[k]: v for k, v in card_run["derived"].items()}
    return (same, derived, card_sum["collective_counts"] == derived,
            dmem["peak_live_bytes"] / card_run["rise"])


def _item17_rec_tp(card_run, rec, failed):
    """The recurrent tensor-parallel cell on the card (``card_run``,
    ``_fake_rank_step``'s record) against its dry-run on meta (``rec``,
    ``VocabDry``'s third record): FLOPs by dtype, collective counts and
    bytes per kind, argument bytes and the tracked peak equal; the
    collective counts as ``_shard_collectives`` derives them; the
    predicted rise within ITEM17_PEAK_RTOL of the card's; no hand kernel
    launched (recurrentgemma's local attention is the chunked one); the
    tracked peak a rank under REC_TP_PEAK_BYTES, printed beside the
    replicated layers' REC_TP_REPLICATED_GB."""
    cfg, shape = _rec_tp_cell()
    card_mem = card_run["memory"]
    dmem = rec["memory_analysis"]
    same, derived, counted, ratio = _fake_rank_holds(card_run, rec)
    no_kernel = not any(card_run["launches"].values())
    fits = dmem["peak_bytes"] < REC_TP_PEAK_BYTES
    ok = all(same.values()) and counted and no_kernel and fits and \
        abs(ratio - 1) <= ITEM17_PEAK_RTOL
    print(f"item17: recurrent TP, {cfg.name} in full ({cfg.n_layers} "
          f"layers, {cfg.optimizer}, remat {cfg.remat}) train step at "
          f"{shape.global_batch} x {shape.seq_len} as rank 0 of a fake "
          f"{VOCAB_MESH} mesh on the card (the collectives move nothing: "
          f"values not checked): equal to the dry-run {same}; collectives "
          f"{card_run['summary']['collective_counts']} = derived: {counted};"
          f" no kernel launched: {no_kernel}; args "
          f"{card_mem['argument_size_in_bytes'] / 1e9:.3f} GB; predicted "
          f"rise {dmem['peak_live_bytes'] / 1e9:.3f} GB against the card's "
          f"{card_run['rise'] / 1e9:.3f} GB (ratio {ratio:.4f}, limit 1 ± "
          f"{ITEM17_PEAK_RTOL}); peak {dmem['peak_bytes'] / 1e9:.3f} GB a "
          f"rank (limit {REC_TP_PEAK_BYTES / 1e9:.0f}; "
          f"{REC_TP_REPLICATED_GB} with the recurrent layers replicated); "
          f"step {card_run['step_s']:.2f} s, child part "
          f"{card_run['seconds']:.2f} s, dry-run {rec['run_s']:.2f} s"
          + ("" if ok else "  FAILED"))
    if not ok:
        failed.append("the recurrent tensor-parallel cell")
        print(f"  card {card_mem} {card_run['summary']}\n  dry {dmem} "
              f"{rec['op_analysis']}\n  derived {derived}")
    return {"equal": same, "collectives_as_derived": counted,
            "no_kernel": no_kernel, "launches": card_run["launches"],
            "card_memory": card_mem, "dry_memory": dmem,
            "rise_bytes": card_run["rise"], "peak_ratio": ratio,
            "peak_under_limit": fits,
            "replicated_peak_gb": REC_TP_REPLICATED_GB,
            "flops_by_dtype": card_run["summary"]["flops_by_dtype"],
            "collective_counts": card_run["summary"]["collective_counts"],
            "step_s": card_run["step_s"], "child_s": card_run["seconds"],
            "dry_run_s": rec["run_s"]}


def _item17_seq(card_run, dry, failed):
    """The sequence-parallel cell on the card (``card_run``,
    ``_fake_rank_step``'s record) against its dry-run on meta (``dry``,
    ``VocabDry``'s last two records: ``seq_shard`` on, then off): FLOPs by
    dtype (rows 9 and 10 included), collective counts and bytes per kind,
    argument bytes and the tracked peak equal; the collective counts as
    ``_shard_collectives`` derives them for the sequence layout; the
    predicted rise within ITEM17_PEAK_RTOL of the card's; rows 9 and 10
    launched 2·L and L times; the card's peak through the draw under
    SEQ_DRAW_PEAK_BYTES; the tracked peak below the same cut's with
    ``seq_shard`` off, the saving printed beside the stream's rows that
    the layout leaves to the other ranks (SEQ_ROWS x TRAIN_4K_SEQ x d
    bf16 a layer, times 15/16)."""
    cfg, shape = _seq_cell()
    rec, off = dry
    card_sum, card_mem = card_run["summary"], card_run["memory"]
    dmem, omem = rec["memory_analysis"], off["memory_analysis"]
    same, derived, counted, ratio = _fake_rank_holds(card_run, rec)
    L = cfg.n_layers
    want_l = {"flash_attention_fwd_lse": 2 * L, "flash_attention_bwd": L}
    launched = {k: card_run["launches"][k] for k in want_l} == want_l
    saved = omem["peak_bytes"] - dmem["peak_bytes"]
    rows = L * shape.global_batch * shape.seq_len * cfg.d_model * 2 * \
        (VOCAB_MESH[1] - 1) / VOCAB_MESH[1]
    drawn = card_run["draw_peak"] < SEQ_DRAW_PEAK_BYTES
    ok = all(same.values()) and counted and launched and saved > 0 and \
        drawn and abs(ratio - 1) <= ITEM17_PEAK_RTOL
    print(f"item17: sequence parallel, {cfg.name} at {L} of 64 layers "
          f"(flash, {cfg.optimizer}, remat {cfg.remat}, seq_shard) train "
          f"step at {shape.global_batch} x {shape.seq_len} as rank 0 of a "
          f"fake {VOCAB_MESH} mesh on the card (the collectives move "
          f"nothing: values not checked): equal to the dry-run {same}; "
          f"collectives {card_sum['collective_counts']} = derived: "
          f"{counted}; launches {card_run['launches']} = derived {want_l}: "
          f"{launched}; the draw's peak {card_run['draw_peak'] / 1e9:.3f} GB "
          f"(limit {SEQ_DRAW_PEAK_BYTES / 1e9:.0f}); args "
          f"{card_mem['argument_size_in_bytes'] / 1e9:.3f} GB; predicted rise {dmem['peak_live_bytes'] / 1e9:.3f} GB "
          f"against the card's {card_run['rise'] / 1e9:.3f} GB (ratio "
          f"{ratio:.4f}, limit 1 ± {ITEM17_PEAK_RTOL}); peak "
          f"{dmem['peak_bytes'] / 1e9:.3f} GB a rank, seq_shard off "
          f"{omem['peak_bytes'] / 1e9:.3f} (saved {saved / 1e9:.3f} GB, "
          f"{saved / L / 1e9:.3f} a layer; the other ranks' rows of the "
          f"stream {rows / L / 1e9:.3f} a layer); collective bytes "
          f"{card_sum['total_collective_bytes'] / 2**30:.3f} GiB, off "
          f"{off['op_analysis']['total_collective_bytes'] / 2**30:.3f}; "
          f"step {card_run['step_s']:.2f} s, child part "
          f"{card_run['seconds']:.2f} s, dry-runs {rec['run_s']:.2f} + "
          f"{off['run_s']:.2f} s" + ("" if ok else "  FAILED"))
    if not ok:
        failed.append("the sequence-parallel cell")
        print(f"  card {card_mem} {card_sum}\n  dry {dmem} "
              f"{rec['op_analysis']}\n  derived {derived}")
    return {"equal": same, "collectives_as_derived": counted,
            "launches": card_run["launches"], "launches_as_derived":
            launched, "card_memory": card_mem, "dry_memory": dmem,
            "off_memory": omem, "saved_bytes": saved,
            "draw_peak_bytes": card_run["draw_peak"],
            "rise_bytes": card_run["rise"], "peak_ratio": ratio,
            "flops_by_dtype": card_sum["flops_by_dtype"],
            "off_flops_by_dtype": off["op_analysis"]["flops_by_dtype"],
            "collective_counts": card_sum["collective_counts"],
            "collective_bytes": card_sum["collective_bytes"],
            "off_collective_bytes": off["op_analysis"]["collective_bytes"],
            "step_s": card_run["step_s"], "child_s": card_run["seconds"],
            "dry_run_s": [rec["run_s"], off["run_s"]]}


def phase_item17(card: str, start: dict, tcfg, tshape, clean_losses,
                 vocab_dry: VocabDry) -> dict:
    """Slice 17 under NCCL at world size 1 in this process: the pipeline
    (``_item17_pipeline``, a one-rank "stage" mesh), the sharded FT loop
    (``_item17_ft_loop``, a (1, 1) ("data", "model") mesh) and the dry-run
    against the card (``_item17_on_card``), its meta runs started first in
    a spawned child (``dryrun.run_cells``: its fake process group never
    meets this one) and read at the end; and slice 21's vocab-split cell,
    slice 22's recurrent tensor-parallel cell and slice 23's
    sequence-parallel cell (``_fake_rank_cells`` in a spawned child beside
    the pipeline and the FT loop, held by ``_item17_vocab_split``,
    ``_item17_rec_tp`` and ``_item17_seq`` against ``vocab_dry``).  Launch
    counts are reset at its start and read at its end; the process group
    is torn down at its end."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, process_group
    from repro_torch.parallel import collectives as C
    from repro_torch.kernels.flashattn import kernel as FK
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    _reset_all_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cells = _item17_dryrun_cells()
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=__import__("multiprocessing").get_context("spawn"))
    dry = pool.submit(dryrun.run_cells, [(c, s, (1, 1)) for _, c, s in cells])
    vocab_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=__import__("multiprocessing").get_context("spawn"))
    vocab_run = vocab_pool.submit(_fake_rank_cells)
    for b, kv, s, hd in ((1, 8, 1024, 128), (1, 8, 4608, 128),
                         (8, 3, 1024, 64)):
        if FK.bwd_workspace_floats(b, kv, s, hd) != \
                FK._bwd_lib().flash_attention_bwd_workspace_floats(b, kv, s,
                                                                   hd):
            failed.append("bwd_workspace_floats differs from the source's")
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    with process_group(DEVICE):
        stage_mesh = Mesh((1,), ("stage",))
        mesh = Mesh((1, 1), ("data", "model"))
        for m, axes in ((stage_mesh, "stage"), (mesh, "data"),
                        (mesh, "model"), (mesh, ("data", "model"))):
            # each group's communicator is set up here, outside every hold
            C.all_reduce(torch.zeros(1, device=DEVICE), m, axes)
        torch.cuda.synchronize()
        out["pipeline"] = _item17_pipeline(stage_mesh, gen, failed)
        out["ft_loop"] = _item17_ft_loop(tcfg, tshape, mesh, clean_losses,
                                         failed)
        try:
            card_runs = vocab_run.result(timeout=ITEM17_BUDGET_S)
        finally:
            vocab_pool.shutdown(cancel_futures=True)
        dry_runs = vocab_dry.result()
        out["vocab_split"] = _item17_vocab_split(card_runs["vocab"],
                                                 dry_runs[:2], failed)
        out["rec_tp"] = _item17_rec_tp(card_runs["rec_tp"], dry_runs[2],
                                       failed)
        out["seq"] = _item17_seq(card_runs["seq"], dry_runs[3:], failed)
        try:
            records = dry.result(timeout=ITEM17_BUDGET_S)
        finally:
            pool.shutdown(cancel_futures=True)
        print(f"item17: the dry-run's {len(records)} meta cells took "
              f"{sum(r['build_s'] + r['run_s'] for r in records):.2f} s in "
              f"the child")
        peak = torch.cuda.max_memory_allocated()
        out["dryrun"], card_peak = _item17_on_card(mesh, start, records,
                                                   failed)
    torch.cuda.empty_cache()
    peak = max(peak, card_peak, torch.cuda.max_memory_allocated())
    return _phase_end("item17", out, failed, ITEM17_ROWS, peak,
                      ITEM17_BUDGET_S, t_phase, card)


# slice 18: the walkthroughs of examples/ at full width
EXAMPLES_ROOT = os.path.join(ROOT, "examples")
EXAMPLES_DENSE = "qwen3-0.6b"      # dependable serving's model, drawn here
EXAMPLES_BUDGET_S = 120            # the phase's share of the limit: the
                                   # training example's two runs save the
                                   # 1.6 GB state 8 times


def _load_example(name):
    """``examples/<name>_torch.py`` as a module (examples/ is no package)."""
    import importlib.util
    path = os.path.join(EXAMPLES_ROOT, f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quickstart_holds(out, failed):
    """Every ``qconv_act`` / ``qlinear_act`` call of the quickstart again:
    its operands (as the op derives them) through the fused kernel and its
    plain version, ``torch.equal``, and the kernel's output dequantized
    equal to what the example got.  These launches come after the counts
    were read."""
    from repro_torch.core import quant
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.kernels.qconv2d import ops as CO
    from repro_torch.kernels.qconv2d import ref as R
    from repro_torch.kernels.qmatmul import kernel as MK
    from repro_torch.kernels.qmatmul import ref as MR
    i32 = torch.int32
    errs, shapes = {"qconv2d": 0, "qmatmul": 0}, {}
    outs = {"qconv_act": [out["conv"], out["conv2"]],
            "qlinear_act": [out["qlinear"]]}
    for op, calls in out["calls"].items():
        for args, got in zip(calls, outs[op]):
            x, p, xs, xzp, os_, ozp = args
            if op == "qlinear_act":
                x = x.reshape(-1, x.shape[-1])
            x_q = quant.quantize(x, xs, xzp)
            bias = torch.round(p.bias_f / (xs * p.w_scale)).to(i32)
            scale = quant.requant_scale(xs, p.w_scale, os_)
            zps = torch.stack([xzp.to(i32).reshape(()),
                               ozp.to(i32).reshape(())])
            if op == "qconv_act":
                name, kern, plain = "qconv2d", K.qconv2d, R.qconv2d_plain
                x_q = CO.pad_zp(x_q, xzp, CO.resolve_pads(
                    x.shape[1], x.shape[2], p.w_q.shape[0], p.w_q.shape[1],
                    (1, 1), "SAME"))
            else:
                name, kern, plain = "qmatmul", MK.qmatmul, MR.qmatmul_plain
            operands = (x_q, p.w_q, p.colsum, bias, scale, zps)
            y_q = kern(*operands)
            errs[name] = max(errs[name], _max_err(y_q, plain(*operands)))
            shapes.setdefault(name, []).append(
                [tuple(x_q.shape), tuple(p.w_q.shape)])
            y = (y_q.to(torch.float32) - ozp.to(torch.float32)) * os_
            if not torch.equal(y.reshape(got.shape), got):
                failed.append(f"quickstart: {op} differs from its kernel's "
                              f"output on the same operands")
    print(f"examples: quickstart's rows 3 and 6 at {shapes}: torch.equal "
          f"to their plain versions (max abs err {errs})")
    return shapes


def _campaign_quickstart_holds(out, failed):
    bad = [r for r in out["results"]
           if (r.policy in ("abft", "tmr") and r.sdc)
           or (r.policy == "abft" and r.fault_model == "single_bitflip"
               and r.detected_corrected + r.detected_uncorrected != r.trials)]
    if bad:
        failed.append(f"campaign quickstart verdicts: {bad}")
    for label in ("drill", "kernel_drill"):
        det, mis = out[label]
        if not (det.all() and not mis.any()):
            failed.append(f"campaign quickstart {label}: {det.sum()} of "
                          f"{len(det)} detected, {mis.sum()} corrupted")


def phase_examples(card: str, lm, train, ship, mm_rows) -> dict:
    """Each example's ``run()`` at full width on the card, over what main()
    holds: ``lm`` = (SmolLM-135M's W8A8 cfg, its params), ``train`` =
    (the training cfg, shape, the clean losses of phase 10), ``ship`` =
    (``network_specs(194)``, its params, the forward's frames).  Each
    example's launch counts are reset just before it and read just after
    it, against the counts its acts derive; its peak device memory is
    printed.  Holds raise at the phase's end."""
    from repro_torch.configs import registry
    from repro_torch.models import shipdet
    t_phase = time.perf_counter()
    failed, out = [], {"card": card}
    lm_cfg, lm_params = lm
    tcfg, tshape, clean_losses = train
    specs, ship_params, frames = ship
    L = tcfg.n_layers
    rows = tuple(_campaign_launches())
    zero = dict.fromkeys(rows, 0)
    qcfg = registry.get(EXAMPLES_DENSE)
    qparams, q_s = _card_params(qcfg, 0)
    print(f"examples: {EXAMPLES_DENSE} in full drawn on the card in "
          f"{q_s:.2f} s")

    def derived(name, res):
        """The counts each example's acts launch; None for a row that must
        launch but whose count follows the data."""
        if name == "quickstart":      # 2 convs, 1 qlinear; ABFT act: the
            return {**zero, "qconv2d": 2, "qmatmul": 1,  # product, its
                    "qmatmul_acc": 2, "qmatmul_acc_checksum": 1}  # recompute
        if name == "shipdet_pipeline":   # the forward and the layer table
            return {**zero, "qconv2d": 2 * len(specs)}
        if name == "campaign_quickstart":
            return {**zero, **dict.fromkeys(
                ("qconv2d_acc", "qconv2d_acc_checksum", "qmatmul_acc",
                 "qmatmul_acc_checksum"), None)}
        if name == "dependable_serving":  # qwen3: no int8 FFN, chunked
            return dict(zero)
        if name == "fleet_quickstart":    # the W8A8 FFN of every step
            return {**zero, "qmatmul_acc": None}
        if name == "recovery_quickstart":  # act 1: 2 checked products
            return {**zero, "qmatmul_acc": None, "qmatmul_acc_checksum": 2}
        return {**zero, "flash_attention_fwd_lse": 2 * L * res["executed"],
                "flash_attention_bwd": L * res["executed"]}

    runs = (
        ("quickstart", {"full": True}),
        ("shipdet_pipeline", {"full": True, "specs": specs,
                              "params": ship_params, "frames": frames}),
        ("campaign_quickstart", {"full": True}),
        ("dependable_serving", {"full": True, "cfg": qcfg,
                                "params": qparams}),
        ("fleet_quickstart", {"full": True, "cfg": lm_cfg,
                              "params": lm_params}),
        ("recovery_quickstart", {"full": True, "cfg": lm_cfg,
                                 "params": lm_params}),
        ("train_ft_e2e", {"full": True, "cfg": tcfg, "shape": tshape,
                          "steps": TRAIN_STEPS,
                          "ckpt_every": TRAIN_CKPT_EVERY}),
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        for name, kw in runs:
            mod = _load_example(name)
            if name == "campaign_quickstart":
                kw["out_dir"] = os.path.join(tmp, "quickstart_torch")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_launches()
            t0 = time.perf_counter()
            res = mod.run(DEVICE, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _campaign_launches()
            peak = torch.cuda.max_memory_allocated()
            want = derived(name, res)
            off = {k: (launches[k], v) for k, v in want.items()
                   if (v is None and launches[k] == 0)
                   or (v is not None and launches[k] != v)}
            print(f"examples: {name} in {secs:.2f} s, peak device memory "
                  f"{peak / 1e9:.3f} GB, launches "
                  f"{ {k: v for k, v in launches.items() if v} } "
                  f"{'as derived' if not off else f'OFF: {off}'}")
            if off:
                failed.append(f"{name}: launches (got, derived) {off}")
            out[name] = {"seconds": secs, "peak_bytes": peak,
                         "launches": launches}
            if name == "quickstart":
                out[name]["shapes"] = _quickstart_holds(res, failed)
                out[name].update(conv_err=res["conv_err"],
                                 qlinear_rel=res["qlinear_rel"])
                rq = [r for r in mm_rows if r["kernel"] == "qmatmul"
                      and tuple(r["shape"]) == tuple(
                          res["calls"]["qlinear_act"][0][0].shape)
                      + (res["qlinear"].shape[-1],)]
                for r in rq:
                    print(f"examples: row 6 at the quickstart's "
                          f"{tuple(r['shape'])}: {r['ms']:.4f} ms per call "
                          f"(CUDA events), device {r['device_ms']:.5f} ms, "
                          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}) "
                          f"(phase 13's timing)")
            elif name == "shipdet_pipeline":
                out[name].update(err_steps=res["err"] / res["step"],
                                 forward_ms=res["forward_ms"])
            elif name == "campaign_quickstart":
                _campaign_quickstart_holds(res, failed)
            elif name == "dependable_serving":
                if res["faulty"] != res["clean"] or not res["voted"]:
                    failed.append("dependable serving: rollback or vote")
                out[name].update(rolled_back=res["rolled_back"],
                                 replica_differs=res["replica_differs"])
            elif name == "fleet_quickstart":
                if any(res[a] != res["golden"]
                       for a in ("kill", "abft", "dmr")) \
                        or res["abft_recoveries"] != 1:
                    failed.append("fleet quickstart: streams or recoveries")
            elif name == "recovery_quickstart":
                if not (torch.equal(res["op_ckpt"], res["op_golden"])
                        and res["op_ckpt_recovered"] == 1
                        and res["engine_stream"] == res["engine_golden"]
                        and res["fleet_stream"] == res["fleet_golden"]
                        and res["incremental_restores"] == 1):
                    failed.append("recovery quickstart: an act did not heal")
                out[name].update(ckpt_stats=res["ckpt_stats"],
                                 recovery_ms=res["recovery_ms"])
            else:
                same = res["clean"] == clean_losses
                print(f"examples: train_ft_e2e clean losses == phase 10's: "
                      f"{same}; {res['recoveries']} recovery, faulty == "
                      f"clean: {res['faulty'] == res['clean']}; strike bit "
                      f"{res['strike_bit']}")
                if not same or res["recoveries"] != 1 \
                        or res["faulty"] != res["clean"]:
                    failed.append("train_ft_e2e: losses or recovery")
                out[name].update(recoveries=res["recoveries"],
                                 clean_s=res["clean_s"],
                                 faulty_s=res["faulty_s"],
                                 executed=res["executed"])
            del res
    del runs, qparams                  # qwen3-0.6b's weights
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"examples: phase in {secs:.1f} s (budget {EXAMPLES_BUDGET_S} s) "
          f"on {card}")
    if secs > EXAMPLES_BUDGET_S:
        failed.append(f"examples phase took {secs:.1f} s")
    if failed:
        raise AssertionError("examples: " + "; ".join(failed))
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
    # the trained models' dry-run steps run on meta in spawned children
    # beside the phases before them
    train_dry = TrainDry()
    vocab_dry = VocabDry()
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
    del train_run, engines         # their states leave the card
    # slices 11 and 12 last: no timing or profile above runs after their
    # engines
    dependable = phase_dependable(cfg, lm_params, prompts, card)
    fleet = phase_fleet(cfg, lm_params, card)
    embed = phase_embed(card)
    embed_train = phase_embed_train(card, train_dry)
    dse = phase_dse(cfg, lm_params, card)
    recurrent = phase_recurrent(card, train_dry)
    train_dry.close()
    moe = phase_moe(card)
    dense = phase_dense(card)
    start = {}
    moe_train = phase_moe_train(card, start)
    shard = phase_shard(card, start)
    item17 = phase_item17(card, start, tcfg, tshape,
                          train["runs"]["clean"][0]["losses"], vocab_dry)
    del start
    examples = phase_examples(
        card, (cfg, lm_params),
        (tcfg, tshape, train["runs"]["clean"][0]["losses"]),
        (specs, params, frames), mm_rows)

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
                       "embed": embed, "embed_train": embed_train,
                       "dse": dse,
                       "recurrent": recurrent, "moe": moe, "dense": dense,
                       "moe_train": moe_train, "shard": shard,
                       "item17": item17, "examples": examples}, f,
                      indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
