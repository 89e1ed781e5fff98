"""Dependable serving on the port: the paper's execution flow, with drills.

Payload computer → RTG4 → HPDP becomes: client → Engine → decode step on
the card.  Three drills prove the dependability story end to end:

  1. serve a batch of requests (continuous batching),
  2. SEU strikes the decode state mid-flight → snapshot rollback; final
     tokens are IDENTICAL to a fault-free run,
  3. SEU strikes the *weights* → TMR voting masks it (2-of-3 majority).

    PYTHONPATH=src python examples/dependable_serving_torch.py --device cpu

The default serves ``reduced(qwen3-0.6b)``; ``--full`` serves qwen3-0.6b
in full (28 layers, d 1,024, a 151,936-word vocabulary).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core import fault_injection as fi
from repro_torch.core import redundancy
from repro_torch.models import api as model_api
from repro_torch.models.config import reduced
from repro_torch.runtime.serving import Engine, Request

ARCH = "qwen3-0.6b"


def run(device="cuda", *, full=False, cfg=None, params=None) -> dict:
    """The three acts over ``cfg``/``params`` (by default the reference
    script's: ``reduced(qwen3-0.6b)``, or the full config with ``full``,
    weights from a seed); returns the streams and verdicts."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = registry.get(ARCH) if full else reduced(registry.get(ARCH))
    if params is None:
        params = model_api.init_params(cfg, torch.Generator().manual_seed(0),
                                       device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(3, 9))).tolist()
               for _ in range(6)]

    print("=" * 70)
    print(f"1. Continuous batching: 6 requests through capacity-3 engine "
          f"({cfg.name})")
    print("=" * 70)

    def serve(fault=False):
        eng = Engine(cfg, params, capacity=3, max_len=96, prefill_pad=8,
                     snapshot_every=2)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        lost = 0
        if fault:
            for _ in range(3):
                eng.step()
            print("   [drill] SEU flips the sampled-token buffer …")
            tokens = eng.tokens.clone()           # a new buffer, not in place
            tokens[0] ^= 0x40
            eng.tokens = tokens
            lost = eng.restore_snapshot()
            print(f"   [drill] rolled back {lost} decode steps (bound = "
                  f"snapshot_every = 2)")
        stats = eng.run()
        return reqs, stats, lost

    t0 = time.time()
    clean_reqs, stats, _ = serve(fault=False)
    print(f"   {stats.tokens_out} tokens, {stats.steps} steps, "
          f"{stats.tokens_out/(time.time()-t0):.1f} tok/s")
    for r in clean_reqs[:3]:
        print(f"   req{r.uid}: {r.output}")

    print()
    print("=" * 70)
    print("2. SEU in decode state → snapshot rollback → identical output")
    print("=" * 70)
    faulty_reqs, fstats, lost = serve(fault=True)
    same = all(a.output == b.output for a, b in zip(clean_reqs, faulty_reqs))
    print(f"   replays={fstats.replays}; outputs identical to fault-free "
          f"run: {same}")
    assert same

    print()
    print("=" * 70)
    print("3. SEU in weights → TMR majority vote masks it")
    print("=" * 70)
    tok = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)

    def logits_fn(p):
        with torch.no_grad():
            return model_api.forward(cfg, p, tok[None, :]).logits

    clean = logits_fn(params)
    corrupt = fi.inject_into_pytree(params, torch.Generator().manual_seed(7),
                                    n_flips=1)
    # three replicas, one with SEU-corrupted weights; majority vote masks it
    r1 = logits_fn(params)
    r2 = logits_fn(corrupt)
    r3 = logits_fn(params)
    masked = redundancy.vote([r1, r2, r3])
    ok = bool(torch.equal(masked, clean))
    print(f"   single corrupted replica out-voted, output bit-exact: {ok}")
    assert ok
    print("\ndependable_serving OK")
    return {"prompts": prompts,
            "clean": [list(r.output) for r in clean_reqs],
            "faulty": [list(r.output) for r in faulty_reqs],
            "rolled_back": lost, "replays": fstats.replays,
            "tokens_out": stats.tokens_out, "steps": stats.steps,
            "replica_differs": not torch.equal(r2, clean), "voted": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="qwen3-0.6b in full")
    args = ap.parse_args(argv)
    run(args.device, full=args.full)


if __name__ == "__main__":
    main()
