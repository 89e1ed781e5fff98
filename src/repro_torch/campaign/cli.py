"""Campaign CLI — run a statistical SEU fault-injection sweep and write a
DAVOS-style coverage report.

    PYTHONPATH=src python -m repro_torch.campaign.cli \
        --workload qmatmul --policies none,abft,tmr --trials 200 --seed 0

The counterpart of ``repro.campaign.cli``.  Runs on the card (``--device
cuda``, the default; it raises where there is none) unless ``--device cpu``
is asked for.  Writes <out>/campaign.json and <out>/campaign.md (default
``reports/campaign_torch``) and prints the coverage table.  Everything is
deterministic in --seed.  ``--backend`` sweeps the execution-backend axis
(torch | ref | cuda, the reference's jnp | ref | pallas; the default
``cuda`` runs the hand kernels); kernel workloads additionally get a
per-bit-position accumulator coverage table (``--bit-trials 0`` to
skip).

Adaptive mode (``--ci-halfwidth 0.05``) runs each configuration in chunks
and stops at the first chunk boundary where the SDC-rate confidence
interval is tighter than the target — ``--trials`` then acts as the hard
cap.  ``--workers N`` fans the model workloads across a process pool with
bit-identical results; ``--resume <dir>`` continues a killed campaign from
its journal.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.campaign import engine as engine_mod
from repro_torch.campaign import faultload as fl
from repro_torch.campaign import journal as journal_mod
from repro_torch.campaign import report as report_mod
from repro_torch.campaign import runner
from repro_torch.campaign import stats as stats_mod
from repro_torch.core.dependability import Policy

DEFAULT_FAULT_MODELS = "single_bitflip,multi_bitflip,stuck_at0,stuck_at1"


def _csv(s: str):
    return [t.strip() for t in s.split(",") if t.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.campaign.cli",
        description="Statistical SEU fault-injection campaign engine")
    p.add_argument("--workload", default="qmatmul",
                   help=f"comma list or 'all'; known: {sorted(runner.CASES)}")
    p.add_argument("--policies", default="none,abft,dmr,tmr,ckpt",
                   help="comma list of dependability policies")
    p.add_argument("--sites", default="all",
                   help=f"comma list or 'all'; known: {list(fl.SITES)}")
    p.add_argument("--fault-models", default=DEFAULT_FAULT_MODELS,
                   help="comma list (multi_bitflip@<rate> for custom rates, "
                        "mbu_burst@<elems>x<bits> for custom MBU clusters)")
    p.add_argument("--trials", "--max-trials", dest="trials", type=int,
                   default=200,
                   help="seeded trials per configuration; under "
                        "--ci-halfwidth this is the hard cap the sequential "
                        "sampler may stop short of")
    p.add_argument("--backend", "--backends", dest="backend",
                   default=fl.DEFAULT_BACKEND,
                   help="comma list of execution backends (torch, ref, cuda)")
    p.add_argument("--device", default="cuda",
                   help="where every operand lives: cuda (the default; "
                        "raises without a card) or cpu")
    p.add_argument("--bit-trials", type=int, default=8,
                   help="per-bit accumulator sweep trials for kernel "
                        "workloads (0 disables the bit-coverage table); "
                        "under --ci-halfwidth this too is a cap")
    p.add_argument("--seed", type=int, default=0)
    # ---- adaptive sequential sampling -----------------------------------
    p.add_argument("--ci-halfwidth", type=float, default=0.0,
                   help="stop a configuration once its SDC-rate CI "
                        "half-width is <= this (0 = fixed budget, run all "
                        "--trials)")
    p.add_argument("--confidence", type=float, default=0.95,
                   help="confidence level for the stopping CI and the "
                        "report's CI columns")
    p.add_argument("--ci-method", choices=("wilson", "clopper-pearson"),
                   default="wilson",
                   help="binomial interval: wilson (closed form) or "
                        "clopper-pearson (exact)")
    p.add_argument("--chunk", type=int, default=25,
                   help="trials per chunk for host-side workloads (the "
                        "stopping rule is checked at chunk boundaries)")
    p.add_argument("--kernel-chunk", type=int, default=100,
                   help="trials per chunk for kernel workloads")
    p.add_argument("--min-trials", type=int, default=25,
                   help="never stop a configuration before this many trials")
    # ---- sharding / resume ----------------------------------------------
    p.add_argument("--workers", type=int, default=0,
                   help="shard the model workloads across N worker "
                        "processes (0 = in-process serial); results are "
                        "bit-identical either way")
    p.add_argument("--resume", default=None, metavar="DIR",
                   help="resume a previous run from DIR (its journal/ "
                        "subdirectory); implies --out DIR")
    p.add_argument("--no-journal", action="store_true",
                   help="skip writing the per-config resume journal")
    p.add_argument("--out", default="reports/campaign_torch",
                   help="output directory for campaign.json / campaign.md")
    p.add_argument("--events-out", default=None,
                   help="also write the raw injection→detection→recovery "
                        "timelines (one entry per configuration) as JSON")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.trials < 1:
        print("--trials must be >= 1", file=sys.stderr)
        return 2
    if args.ci_halfwidth < 0:
        print("--ci-halfwidth must be >= 0", file=sys.stderr)
        return 2
    if args.workers < 0:
        print("--workers must be >= 0", file=sys.stderr)
        return 2
    if args.resume:
        args.out = args.resume
    log = (lambda s: None) if args.quiet else (lambda s: print(s, flush=True))
    device = resolve_device(args.device)

    workloads = sorted(runner.CASES) if args.workload == "all" \
        else _csv(args.workload)
    for w in workloads:
        runner.check_workload(w)
    policies = [Policy(p) for p in _csv(args.policies)]
    sites = list(fl.SITES) if args.sites == "all" else _csv(args.sites)
    fault_models = _csv(args.fault_models)
    backends = _csv(args.backend)

    specs = fl.expand_grid(workloads, policies, sites, fault_models,
                           trials=args.trials, seed=args.seed,
                           supported=runner.SUPPORTED, backends=backends)
    if not specs:
        print("no runnable configurations for this sweep", file=sys.stderr)
        return 2

    plan = stats_mod.SamplingPlan(
        ci_halfwidth=args.ci_halfwidth, confidence=args.confidence,
        ci_method=args.ci_method, chunk=args.chunk,
        kernel_chunk=args.kernel_chunk,
        min_trials=args.min_trials, workers=args.workers)
    journal = None
    if not args.no_journal:
        import pathlib
        journal = journal_mod.CampaignJournal(
            pathlib.Path(args.out) / "journal")

    mode = (f"adaptive (halfwidth {args.ci_halfwidth:g} @ "
            f"{args.confidence:g} {args.ci_method})"
            if plan.adaptive else "fixed budget")
    log(f"campaign: {len(specs)} configurations × ≤{args.trials} trials, "
        f"{mode} (seed {args.seed}, backends {','.join(backends)}, "
        f"device {device}"
        + (f", {args.workers} workers" if args.workers else "")
        + (", resuming" if args.resume else "") + ")")
    t0 = time.time()
    case_cache = {}
    event_sink = [] if args.events_out else None
    run_stats: dict = {}
    try:
        results = runner.run_campaign(specs, log=log, cache=case_cache,
                                      event_sink=event_sink, plan=plan,
                                      journal=journal, run_stats=run_stats,
                                      device=device)
    except engine_mod.CampaignInterrupted as e:
        print(f"campaign interrupted: {e}; resume with --resume {args.out}",
              file=sys.stderr)
        return 3

    bit_rows = []
    if args.bit_trials > 0 and "accumulator" in sites:
        for be in backends:
            for w in workloads:
                if w not in runner.kernel_workloads():
                    continue
                case_policies = [p for p in policies
                                 if p in runner.CASES[w].policies]
                log(f"bit sweep: {w} [{be}] × "
                    f"{','.join(p.value for p in case_policies)}")
                bit_rows.extend(runner.run_bit_sweep(
                    w, case_policies, trials_per_bit=args.bit_trials,
                    seed=args.seed, backend=be,
                    case=case_cache.get((w, args.seed, be, str(device))),
                    plan=plan, device=device))
    elapsed = time.time() - t0

    meta = {
        "workloads": ",".join(workloads),
        "policies": ",".join(p.value for p in policies),
        "sites": ",".join(sites),
        "fault_models": ",".join(fault_models),
        "backends": ",".join(backends),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "trials_per_config": args.trials,
        "bit_trials": args.bit_trials,
        "seed": args.seed,
        "configurations": len(results),
        "ci_halfwidth": args.ci_halfwidth,
        "confidence": args.confidence,
        "ci_method": args.ci_method,
        "workers": args.workers,
        "trials_executed": sum(r.trials for r in results),
        "trials_live": run_stats.get("trials_live", 0),
        "trials_resumed": run_stats.get("trials_resumed", 0),
        "configs_resumed": run_stats.get("configs_resumed", 0),
        "elapsed_seconds": round(elapsed, 2),
    }
    jpath, mpath = report_mod.write_report(results, args.out, meta,
                                           bit_coverage=bit_rows)
    if event_sink is not None:
        import json
        import pathlib
        epath = pathlib.Path(args.events_out)
        epath.parent.mkdir(parents=True, exist_ok=True)
        with open(epath, "w") as f:
            json.dump({"meta": meta, "configs": event_sink}, f,
                      indent=2, sort_keys=True)
        log(f"wrote {epath} ({sum(len(e['timelines']) for e in event_sink)} "
            "timelines)")
    print(report_mod.to_markdown(results, meta, bit_coverage=bit_rows))
    print(f"wrote {jpath} and {mpath} ({elapsed:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
