"""Fleet quickstart on the port: dependable multi-replica serving.

Four acts, mirroring docs/fleet.md:

  1. serve a request stream through a 2-replica fleet (router + continuous
     batching),
  2. kill a replica mid-decode → deterministic failover, identical tokens,
  3. SEU strikes one replica's *weights* → ABFT scrub detects, checkpoint
     reload recovers, recalled requests replay — released stream identical,
  4. SEU strikes one replica's *decode state* → DMR pair-serving detects,
     replay restores the golden stream.

    PYTHONPATH=src python examples/fleet_quickstart_torch.py --device cpu

The default serves ``reduced(smollm-135m)``; ``--full`` serves
SmolLM-135M in full.  In-process replicas share their parameter tensors,
so every strike builds new tensors (``inject_pytree_with``, an XOR) and
never writes into one: an in-place write would strike both replicas.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core import fault_injection as fi
from repro_torch.core.dependability import Policy
from repro_torch.fleet import Fleet
from repro_torch.models import api as model_api
from repro_torch.models.config import reduced
from repro_torch.runtime.serving import Request

ARCH = "smollm-135m"


def run(device="cuda", *, full=False, cfg=None, params=None) -> dict:
    """The four acts over ``cfg``/``params`` (by default the reference
    script's ``reduced(smollm-135m)``, or the full config with ``full``,
    weights from a seed); returns each act's released streams."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = registry.get(ARCH) if full else reduced(registry.get(ARCH))
    if params is None:
        params = model_api.init_params(cfg, torch.Generator().manual_seed(0),
                                       device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(3, 8))).tolist()
               for _ in range(6)]

    fleet = Fleet(cfg, params, n_replicas=2, policy=Policy.NONE,
                  capacity=3, max_len=96, prefill_pad=8, scrub_every=4)

    def serve(policy, drill=None):
        fleet.reset(policy=policy)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            fleet.submit(r)
        if drill is not None:
            fleet.tick()
            fleet.tick()
            drill(fleet)
        fleet.run()
        return [list(fleet.released[r.uid].output) for r in reqs]

    out = {"prompts": prompts}
    try:
        print("=" * 70)
        print(f"1. 6 requests through a 2-replica fleet ({cfg.name})")
        print("=" * 70)
        golden = out["golden"] = serve(Policy.NONE)
        m = fleet.metrics
        print(f"   released {m.released}/{m.submitted}, "
              f"{m.tokens_out} tokens in {m.ticks} ticks "
              f"(p50={m.p50_ticks:.0f} p99={m.p99_ticks:.0f} ticks)")
        for uid, o in enumerate(golden[:3]):
            print(f"   req{uid}: {o}")

        print()
        print("=" * 70)
        print("2. Kill replica 0 mid-decode → deterministic failover")
        print("=" * 70)
        outs = out["kill"] = serve(Policy.NONE,
                                   drill=lambda f: f.kill_replica(0))
        print(f"   failovers={fleet.metrics.failovers}, "
              f"lost_tokens={fleet.metrics.lost_tokens} "
              f"(bound {fleet.metrics.lost_work_bound_tokens}"
              f"/replica-window)")
        print(f"   outputs identical to fault-free run: {outs == golden}")
        assert outs == golden

        print()
        print("=" * 70)
        print("3. SEU in replica-0 weights → ABFT scrub + checkpoint-reload "
              "recovery")
        print("=" * 70)

        def strike_weights(f):
            v = f.replicas[0]
            print("   [drill] flipping one random bit of replica 0's "
                  "parameters …")
            v.engine.params = fi.inject_pytree_with(
                v.engine.params, torch.Generator().manual_seed(7),
                fi.flip_one_bit)

        outs = out["abft"] = serve(Policy.ABFT, drill=strike_weights)
        for e in fleet.supervisor.events:
            print(f"   {e}")
        out["abft_recoveries"] = fleet.metrics.recoveries
        print(f"   detections={fleet.metrics.detections}, "
              f"recoveries={fleet.metrics.recoveries}, "
              f"replica 0 state={fleet.replicas[0].state.value}")
        print(f"   released stream identical to fault-free run: "
              f"{outs == golden}")
        assert outs == golden
        assert fleet.metrics.recoveries == 1

        print()
        print("=" * 70)
        print("4. SEU in replica-0 decode state → DMR pair-serving detects + "
              "replays")
        print("=" * 70)

        def strike_state(f):
            v = f.replicas[0]
            print("   [drill] XOR-ing replica 0's sampled-token buffer …")
            v.engine.tokens = v.engine.tokens ^ 1

        outs = out["dmr"] = serve(Policy.DMR, drill=strike_state)
        out["dmr_detections"] = fleet.metrics.detections
        print(f"   detections={fleet.metrics.detections}, "
              f"failovers={fleet.metrics.failovers}, "
              f"recoveries={fleet.metrics.recoveries} (transient ⇒ no "
              f"reload)")
        print(f"   released stream identical to fault-free run: "
              f"{outs == golden}")
        assert outs == golden
    finally:
        fleet.close()
    print("\nfleet_quickstart OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="SmolLM-135M in full")
    args = ap.parse_args(argv)
    run(args.device, full=args.full)


if __name__ == "__main__":
    main()
