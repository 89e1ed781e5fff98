"""Recovery quickstart on the port: checkpoint/restart as a first-class policy.

Four acts, mirroring docs/recovery.md:

  1. op-level CKPT — a weight-memory SEU that ABFT can only *detect* is
     *healed* by rollback to the golden operand checkpoint,
  2. async incremental checkpointing — only dirty chunks hit disk, the
     chain restores bit-identically to a full checkpoint,
  3. decode-state scrubbing — a transient SEU in a live engine's KV cache
     is caught by checksum and rolled back to the verified snapshot,
  4. fleet CKPT policy — weight SEU → incremental restore of exactly the
     corrupted leaves, with the recovery wall-clock in the metrics.

    PYTHONPATH=src python examples/recovery_quickstart_torch.py --device cpu

By default act 1 runs the reference script's 16 x 64 x 32 matmul and acts
3 and 4 serve ``reduced(smollm-135m)``; ``--full`` runs act 1 at
SmolLM-135M's FFN width (8 x 576 x 1,536) and acts 3 and 4 over
SmolLM-135M in full.  Every restore names its device.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core import abft, fault_injection as fi
from repro_torch.core.dependability import Policy, dependable_qmatmul
from repro_torch.fleet import Fleet
from repro_torch.models import api as model_api
from repro_torch.models.config import reduced
from repro_torch.runtime.serving import Engine, Request
from repro_torch.train import checkpoint as ckpt

ARCH = "smollm-135m"
OP_SHAPES = {False: (16, 64, 32), True: (8, 576, 1536)}   # act 1's (M, K, N)


def run(device="cuda", *, full=False, cfg=None, params=None,
        w_flip=None) -> dict:
    """The four acts; ``cfg``/``params`` (acts 3 and 4) default to the
    reference script's ``reduced(smollm-135m)``, or the full config with
    ``full``, weights from a seed.  ``w_flip`` = (flat index, bit) addresses
    act 1's weight SEU; by default it is drawn (``flip_one_bit``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {}

    print("=" * 70)
    print("1. Op-level CKPT: rollback heals the weight SEU ABFT only detects")
    print("=" * 70)
    m, k, n = OP_SHAPES[full]
    x_q = torch.from_numpy(
        rng.integers(-128, 128, (m, k)).astype(np.int8)).to(dev)
    w_q = torch.from_numpy(
        rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    bias = torch.zeros((n,), **i32)
    scale = torch.full((n,), 1e-3, dtype=torch.float32, device=dev)
    zero = torch.zeros((), **i32)
    w_check = abft.checksum_vector(w_q)          # deploy-time checksum
    golden, _ = dependable_qmatmul(Policy.NONE, x_q, zero, w_q, bias, scale,
                                   zero)
    if w_flip is None:                           # SEU in weight memory
        w_bad = fi.flip_one_bit(w_q, torch.Generator().manual_seed(1))
    else:
        w_bad = fi.flip_bit_at_index(w_q, *w_flip)
    y_ab, st_ab = dependable_qmatmul(Policy.ABFT, x_q, zero, w_bad, bias,
                                     scale, zero, w_check=w_check)
    y_ck, st_ck = dependable_qmatmul(Policy.CKPT, x_q, zero, w_bad, bias,
                                     scale, zero, w_check=w_check,
                                     ckpt=(x_q, w_q))    # golden checkpoint
    print(f"ABFT: detected={int(st_ab['faults_detected'])}, output golden: "
          f"{torch.equal(y_ab, golden)}   (recompute re-reads bad storage)")
    print(f"CKPT: detected={int(st_ck['faults_detected'])}, "
          f"recovered={int(st_ck['faults_recovered'])}, output golden: "
          f"{torch.equal(y_ck, golden)}")
    assert torch.equal(y_ck, golden)
    out.update(op_golden=golden, op_abft=y_ab, op_ckpt=y_ck,
               op_abft_detected=int(st_ab["faults_detected"]),
               op_ckpt_detected=int(st_ck["faults_detected"]),
               op_ckpt_recovered=int(st_ck["faults_recovered"]))

    print()
    print("=" * 70)
    print("2. Async incremental checkpointing: dirty chunks only, bit-exact")
    print("=" * 70)
    state = {"w": torch.from_numpy(
                 rng.standard_normal((256, 256)).astype(np.float32)).to(dev),
             "step": torch.zeros((), **i32)}
    with tempfile.TemporaryDirectory() as d:
        with ckpt.IncrementalCheckpointer(d, chunk_bytes=16 * 1024) as c:
            c.save(1, state)
            w2 = state["w"].clone()
            w2[5, 5] = 9.0                              # tiny mutation
            state2 = {"w": w2, "step": torch.full((), 2, **i32)}
            c.save(2, state2)
            c.wait()
            stats = dict(c.stats)
            print(f"saves={c.stats['saves']}  chunks written="
                  f"{c.stats['chunks_written']}/{c.stats['chunks_total']} "
                  f"(dirty fraction {c.dirty_fraction():.2f})")
        step, restored = ckpt.restore(d, device=dev)    # walks the chain
        assert step == 2
        assert torch.equal(restored["w"], state2["w"])
        only_w = ckpt.restore_leaves(d, ["w"], device=dev)  # partial restore
        assert torch.equal(only_w["w"], state2["w"])
        print(f"restore(step {step}) bit-exact ✓   restore_leaves(['w']) → "
              f"{tuple(only_w['w'].shape)} ✓")
    out["ckpt_stats"] = stats

    print()
    print("=" * 70)
    print("3. Decode-state scrubbing: transient SEU → snapshot rollback")
    print("=" * 70)
    if cfg is None:
        cfg = registry.get(ARCH) if full else reduced(registry.get(ARCH))
    if params is None:
        params = model_api.init_params(cfg, torch.Generator().manual_seed(0),
                                       device=dev)
    prompts = [[5, 9, 2], [3, 1, 4, 1]]

    def serve(mode, strike=False):
        eng = Engine(cfg, params, capacity=2, max_len=64, prefill_pad=8,
                     snapshot_every=2, state_scrub=mode)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        steps = 0
        while (eng.queue or eng.active) and steps < 100:
            eng.step()
            steps += 1
            if steps == 2 and strike:
                print("   [drill] SEU flips one bit of the live KV cache …")
                eng.cache = fi.inject_pytree_with(
                    eng.cache, torch.Generator().manual_seed(7),
                    fi.flip_one_bit)
        return [tuple(r.output) for r in reqs], eng

    golden_stream, _ = serve("off")
    stream, eng = serve("rollback", strike=True)
    ev = eng.drain_state_events()
    print(f"scrub events: {ev}")
    print(f"streams identical to fault-free run: {stream == golden_stream} "
          f"(replayed ≤ snapshot_every steps)")
    assert stream == golden_stream and ev and ev[0]["recovered"]
    out.update(engine_golden=golden_stream, engine_stream=stream,
               scrub_events=ev)

    print()
    print("=" * 70)
    print("4. Fleet CKPT policy: weight SEU → incremental restore, measured")
    print("=" * 70)
    fleet = Fleet(cfg, params, n_replicas=2, policy=Policy.CKPT,
                  capacity=2, max_len=64, prefill_pad=8, scrub_every=3,
                  snapshot_every=2)

    def fleet_serve(drill=False):
        fleet.reset(policy=Policy.CKPT)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            fleet.submit(r)
        if drill:
            fleet.tick()
            victim = fleet.replicas[0]
            # new leaves: the replicas share their parameter tensors
            victim.engine.params = fi.inject_pytree_with(
                victim.engine.params, torch.Generator().manual_seed(11),
                fi.flip_one_bit)
            print("   [drill] SEU flips one bit of replica 0's weights …")
        fleet.run()
        return [tuple(r.output) for r in reqs]

    try:
        golden_fleet = fleet_serve()
        stream = fleet_serve(drill=True)
        m = fleet.metrics
        print(f"detections={m.detections}  recoveries={m.recoveries}  "
              f"incremental_restores={m.incremental_restores}  "
              f"leaves_restored={m.leaves_restored}  "
              f"recovery={m.recovery_mean_seconds() * 1e3:.1f} ms")
        for e in fleet.supervisor.events:
            print(f"   event: {e}")
        assert stream == golden_fleet, "released stream must be golden"
        assert m.incremental_restores == 1
        out.update(fleet_golden=golden_fleet, fleet_stream=stream,
                   incremental_restores=m.incremental_restores,
                   recovery_ms=m.recovery_mean_seconds() * 1e3)
    finally:
        fleet.close()

    print("\nrecovery quickstart OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="act 1 at the FFN width, acts 3-4 over "
                         "SmolLM-135M in full")
    args = ap.parse_args(argv)
    run(args.device, full=args.full)


if __name__ == "__main__":
    main()
