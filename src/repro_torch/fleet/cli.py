"""Fleet CLI — serve a deterministic request stream through a dependable
multi-replica fleet, optionally striking one replica with an SEU, and write
the fleet metrics report.

    PYTHONPATH=src python -m repro_torch.fleet.cli \
        --arch smollm-135m --replicas 2 --requests 6 \
        --policy abft --inject weights --seed 0 [--device cpu]

The counterpart of ``repro.fleet.cli``, with the same flags plus
``--device`` (default ``cuda``: the card, raising where there is none;
``cpu`` runs the kernels' plain versions).  It serves ``reduced(...)``
configurations, as the reference does; ``chip_smoke.py`` drives the fleet
at full width through the ``Fleet`` API.

The run always serves the same stream twice: once fault-free (the golden
reference) and once under the requested fault.  The exit code is the
dependability verdict: 0 when every released token stream matches the
golden run, 1 when the fault silently corrupted the released output —
so ``--policy none --inject weights`` is *expected* to exit 1 on
manifesting faults, and abft/dmr/ckpt must always exit 0.

``--inject kv_cache`` / ``--inject decode_state`` strike a replica's live
transient state mid-serve: DMR catches the divergence by pair-comparison,
ABFT by the decode-state scrub (drain + failover), and CKPT by the scrub
with an in-place engine snapshot rollback (docs/recovery.md).

``--transport proc`` runs every replica in its own worker process over the
framed pipe transport (docs/multihost.md); the verdict contract is
identical.  ``--deploy`` performs a zero-drain rolling weight deploy
mid-serve in both passes; combined with ``--inject weights`` the drill
strikes replica 0 *while replica 1 is mid-swap* — the hardest window.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fault_injection as fi
from repro_torch.core.dependability import Policy
from repro_torch.fleet.fleet import FLEET_POLICIES, TRANSPORTS, Fleet
from repro_torch.fleet.router import POLICIES as ROUTER_POLICIES
from repro_torch.obs import SpanTracer, dump_merged
from repro_torch.runtime.serving import Request

INJECT_SITES = ("none", "weights", "kv_cache", "decode_state")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.fleet.cli",
        description="Dependable multi-replica serving drill")
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--policy", default="abft",
                   choices=[pol.value for pol in FLEET_POLICIES])
    p.add_argument("--router", default="least_loaded",
                   choices=list(ROUTER_POLICIES))
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new-tokens", type=int, default=6)
    p.add_argument("--capacity", type=int, default=3,
                   help="decode slots per replica")
    p.add_argument("--scrub-every", type=int, default=4,
                   help="weight-scrub cadence in fleet ticks (abft)")
    p.add_argument("--inject", default="none", choices=list(INJECT_SITES),
                   help="SEU drill: corrupt replica 0's weights before "
                        "serving, or its decode-state buffer mid-serve")
    p.add_argument("--kill", type=int, default=-1, metavar="RID",
                   help="kill replica RID mid-serve (failover drill)")
    p.add_argument("--transport", default="inproc", choices=list(TRANSPORTS),
                   help="replica isolation: inproc (threads of one process) "
                        "or proc (one worker process per replica)")
    p.add_argument("--deploy", action="store_true",
                   help="rolling weight deploy mid-serve in both passes; "
                        "with --inject weights the strike lands during the "
                        "swap window")
    p.add_argument("--backend", default=None,
                   help="execution backend for every replica's quantized "
                        "hot paths (torch | ref | cuda; default: cfg's)")
    p.add_argument("--device", default="cuda",
                   help="where every replica serves: cuda (default; raises "
                        "where there is no card) or cpu")
    p.add_argument("--policy-map", default=None, metavar="JSON",
                   help="per-site dependability policy map for the in-graph "
                        "hot paths: path to a PolicyMap JSON file (e.g. "
                        "reports/dse/best_map.json) or inline JSON text; "
                        "implies the W8A8 FFN quantized path so the ffn.* "
                        "sites exist (docs/dse.md)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="reports/fleet_torch",
                   help="output directory for fleet.json")
    p.add_argument("--trace-out", default=None,
                   help="write a Chrome trace_event JSON of the drill pass "
                        "(every replica's pipeline spans; ui.perfetto.dev)")
    p.add_argument("--metrics-out", default=None,
                   help="write the drill pass's metrics registry snapshot "
                        "(.prom extension → Prometheus text format)")
    p.add_argument("--events-out", default=None,
                   help="write the drill pass's structured dependability "
                        "event log + reconstructed timelines as JSON")
    p.add_argument("--quiet", action="store_true")
    return p


def _serve(fleet: Fleet, prompts, max_new_tokens: int, *,
           inject: str = "none", kill: int = -1, key=None,
           deploy: bool = False):
    fleet.reset()
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        fleet.submit(r)
    if inject == "weights" and not deploy:
        fleet.strike(0, "weights", fi.flip_one_bit, key)
    mid_drill = inject in ("kv_cache", "decode_state") or kill >= 0
    if mid_drill:
        for _ in range(2):
            fleet.tick()
        if inject in ("kv_cache", "decode_state"):
            fleet.strike(0, inject, fi.flip_one_bit, key)
        if kill >= 0:
            fleet.kill_replica(kill)
    if deploy:
        for _ in range(2):
            fleet.tick()
        mid_swap = None
        if inject == "weights":
            struck = []

            def mid_swap(rid):
                # strike replica 0's weights while a *different* replica is
                # mid-swap — the in-flight-deploy SEU window (once per pass)
                if rid != 0 and not struck:
                    struck.append(rid)
                    fleet.strike(0, "weights", fi.flip_one_bit, key)
        fleet.deploy(params=fleet._params0, mid_swap=mid_swap)
    fleet.run()
    outputs = tuple(
        tuple(fleet.released[r.uid].output) if r.uid in fleet.released
        else None
        for r in reqs)
    return outputs


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    from repro_torch.configs import registry
    from repro_torch.models import api as model_api
    from repro_torch.models.config import reduced

    log = (lambda s: None) if args.quiet else (lambda s: print(s, flush=True))
    cfg = reduced(registry.get(args.arch))
    policy_map = None
    if args.policy_map is not None:
        import dataclasses
        from repro_torch.core.policy_map import as_policy_map
        policy_map = as_policy_map(args.policy_map)
        # the mapped ffn.* sites live on the W8A8 quantized FFN path
        cfg = dataclasses.replace(cfg, quant="w8a8_ffn")
    dev = resolve_device(args.device)
    params = model_api.init_params(
        cfg, torch.Generator().manual_seed(args.seed), device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(2, 7))).tolist()
               for _ in range(args.requests)]

    fleet = Fleet(cfg, params, n_replicas=args.replicas,
                  policy=Policy(args.policy), router=args.router,
                  scrub_every=args.scrub_every, capacity=args.capacity,
                  max_len=96, prefill_pad=8, backend=args.backend,
                  policy_map=policy_map, transport=args.transport)

    log(f"fleet: {args.replicas}×{cfg.name} replicas on {dev}, "
        f"policy={args.policy}, router={args.router}, "
        f"transport={args.transport}")
    log("golden pass (fault-free%s) …"
        % (", rolling deploy" if args.deploy else ""))
    golden = _serve(fleet, prompts, args.max_new_tokens, deploy=args.deploy)

    drill = args.inject != "none" or args.kill >= 0
    if drill:
        log(f"drill pass (inject={args.inject}, kill="
            f"{args.kill if args.kill >= 0 else 'none'}) …")
    tracers = []
    if args.trace_out and args.transport == "inproc":
        # one tracer per replica engine (pid = replica id) — attached after
        # the golden pass so the trace covers exactly the drill.  (proc
        # replicas run their engine in another process; spans stay there.)
        for r in fleet.replicas:
            tr = SpanTracer(name=f"replica{r.rid}", pid=r.rid)
            r.engine.tracer = tr
            tracers.append(tr)
    observed = _serve(fleet, prompts, args.max_new_tokens,
                      inject=args.inject, kill=args.kill,
                      key=torch.Generator().manual_seed(args.seed + 1),
                      deploy=args.deploy)

    report = fleet.report()
    report["arch"] = cfg.name
    report["device"] = str(dev)
    report["router"] = args.router
    report["seed"] = args.seed
    report["inject"] = args.inject
    report["kill"] = args.kill
    report["deploy"] = bool(args.deploy)
    report["policy_map"] = policy_map.to_doc() if policy_map else None
    report["outputs_match_golden"] = observed == golden
    fleet.close()

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    jpath = out / "fleet.json"
    jpath.write_text(json.dumps(report, indent=2))

    if args.trace_out:
        tpath = dump_merged(tracers, args.trace_out)
        log(f"wrote {tpath} (open in ui.perfetto.dev)")
    if args.metrics_out:
        mpath = fleet.metrics.registry.dump(args.metrics_out)
        log(f"wrote {mpath}")
    if args.events_out:
        epath = fleet.event_log.dump(args.events_out)
        log(f"wrote {epath} ({len(fleet.event_log)} events)")

    log(json.dumps({k: v for k, v in report.items() if k != "events"},
                   indent=2))
    for e in report["events"]:
        log(f"  event: {e}")
    print(f"released {report['released']}/{report['submitted']} requests, "
          f"recoveries={report['recoveries']}, detections="
          f"{report['detections']}, outputs_match_golden="
          f"{report['outputs_match_golden']}; wrote {jpath}")

    if not report["outputs_match_golden"]:
        print("released output stream differs from golden run "
              "(silent corruption under this policy)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
