"""Serving launcher: batched requests through the continuous-batching
engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 16 --max-new 24 [--fault-drill] [--reduced]

The counterpart of ``repro.launch.serve``: the ``Engine`` admits requests
into a fixed decode batch, the decode step streams tokens out, and
checksummed snapshots bound the replay window after a fault.  It runs on
the card (``--device cuda``, the default); ``--device cpu`` runs the
kernels' plain versions, where ``--reduced`` keeps it small.
``--fault-drill`` serves the requests twice, clean and then with an SEU
struck into the token buffer mid-serve (``Engine.strike``) under the
decode-state scrub's ``rollback`` mode, and checks that the scrub caught
it, the engine rolled back, and every stream equals the clean run's.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.fault_injection import flip_bit_at_index
from repro_torch.models import api as model_api
from repro_torch.models.config import reduced
from repro_torch.runtime.serving import Engine, Request

DRILL_STEP = 5            # pumps before the strike
DRILL_BIT = 13            # the token-buffer bit it flips (slot 0)


def _serve(cfg, params, prompts, args, drill: bool):
    eng = Engine(cfg, params, capacity=args.capacity, max_len=args.max_len,
                 snapshot_every=8,
                 state_scrub="rollback" if drill else "off")
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=args.max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    if drill:
        for _ in range(DRILL_STEP):
            eng.step()
        print("[serve] striking an SEU into the decode state ...")
        eng.strike("decode_state",
                   lambda x, gen: flip_bit_at_index(x, 0, DRILL_BIT), None)
    stats = eng.run()
    if args.device != "cpu":
        torch.cuda.synchronize()
    return eng, reqs, stats, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-drill", action="store_true",
                    help="strike an SEU mid-serve and prove recovery")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"[serve] arch={cfg.name} capacity={args.capacity} "
          f"requests={args.requests} device={dev}")
    params = model_api.init_params(
        cfg, torch.Generator().manual_seed(args.seed), device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(3, 17))).tolist()
               for _ in range(args.requests)]

    eng, reqs, stats, dt = _serve(cfg, params, prompts, args, drill=False)
    if args.fault_drill:
        clean = [list(r.output) for r in reqs]
        eng, reqs, stats, dt = _serve(cfg, params, prompts, args,
                                      drill=True)
        events = eng.drain_state_events()
        print(f"[serve] scrub events {events}")
        if len(events) != 1 or not events[0]["recovered"]:
            raise SystemExit("[serve] the scrub did not recover the strike")
        if [list(r.output) for r in reqs] != clean:
            raise SystemExit("[serve] streams differ from the clean run")
        print(f"[serve] rolled back {events[0]['steps_replayed']} steps; "
              f"every stream equals the clean run's")

    lat = [r.finished_at - r.submitted_at for r in reqs if r.finished_at]
    print(f"[serve] {stats.tokens_out} tokens in {dt:.2f}s "
          f"({stats.tokens_out / dt:.1f} tok/s), steps={stats.steps}, "
          f"replays={stats.replays}")
    if lat:
        print(f"[serve] latency p50={statistics.median(lat):.2f}s "
              f"max={max(lat):.2f}s")
    assert all(len(r.output) >= 1 for r in reqs)
    print("[serve] all requests completed")


if __name__ == "__main__":
    main()
