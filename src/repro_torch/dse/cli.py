"""Selective-hardening DSE CLI: measure → search → certify.

    # 1. time every (site × policy) into the cost oracle, on the card
    PYTHONPATH=src python -m repro_torch.dse.cli measure

    # 2. Pareto-search policy-map genomes (campaign-backed fitness,
    #    resumable via the journal under <out>/journal)
    PYTHONPATH=src python -m repro_torch.dse.cli search --space serving \\
        --generations 6 --population 12 --trials 60 --ci-halfwidth 0.08

    # 3. re-certify the selected map at full budget
    PYTHONPATH=src python -m repro_torch.dse.cli certify --trials 150 \\
        --bench-out reports/dse_torch/BENCH_dse.json

The counterpart of ``repro.dse.cli``: the same commands, flags and
exit-code gate (``certify`` exits 0 only when the map's certification
campaigns observe SDC = 0 and its predicted cost is below the uniform-ABFT
corner).  Where it differs:

* ``--device`` (default ``cuda``; it raises where there is none) and
  ``--backend`` (default ``cuda``, the hand kernels; ``torch``, ``ref``);
* ``--out`` defaults to ``reports/dse_torch``, not the reference's
  ``reports/dse``: the reference commits a cost model measured on its own
  device there, and a port run must neither read nor overwrite it;
* ``measure`` records the device in the cost model's ``meta``, and every
  command refuses a cost model measured on another device or with no
  device recorded.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

DEFAULT_OUT = "reports/dse_torch"


def _add_common(p):
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="artifact directory (cost model, frontier, journal)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="cuda",
                   help="execution backend: cuda (the hand kernels), "
                        "torch, ref")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.dse.cli",
        description="Selective hardening DSE: per-layer policy maps, "
                    "measured cost oracle, Pareto search (docs/dse.md)")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("measure", help="time the cost oracle")
    _add_common(m)
    m.add_argument("--arch", default="smollm-135m")
    m.add_argument("--batch", type=int, default=8,
                   help="decode batch for the FFN site shapes")
    m.add_argument("--reps", type=int, default=30)
    m.add_argument("--spaces", default="serving,shipdet",
                   help="comma list of spaces to measure")

    s = sub.add_parser("search", help="NSGA-lite Pareto search")
    _add_common(s)
    s.add_argument("--space", default="serving",
                   choices=("serving", "shipdet"))
    s.add_argument("--arch", default="smollm-135m")
    s.add_argument("--generations", type=int, default=8)
    s.add_argument("--population", type=int, default=16)
    s.add_argument("--mutation-rate", type=float, default=0.25)
    s.add_argument("--trials", type=int, default=60,
                   help="per-site campaign trial cap during search")
    s.add_argument("--ci-halfwidth", type=float, default=0.08,
                   help="adaptive early-stop CI half-width for search "
                        "campaigns (0 = fixed budget)")
    s.add_argument("--fault-model", default="single_bitflip")
    s.add_argument("--cost-model", default=None,
                   help="cost oracle JSON (default <out>/cost_model.json; "
                        "measured on the fly if absent)")
    s.add_argument("--no-journal", action="store_true",
                   help="skip the crash-consistent campaign journal")

    c = sub.add_parser("certify", help="re-certify a map at full budget")
    _add_common(c)
    c.add_argument("--space", default="serving",
                   choices=("serving", "shipdet"))
    c.add_argument("--arch", default="smollm-135m")
    c.add_argument("--map", default=None,
                   help="PolicyMap JSON to certify "
                        "(default <out>/best_map.json)")
    c.add_argument("--trials", type=int, default=150)
    c.add_argument("--ci-halfwidth", type=float, default=0.0,
                   help="0 = fixed budget (tightest committed CI)")
    c.add_argument("--fault-model", default="single_bitflip")
    c.add_argument("--cost-model", default=None)
    c.add_argument("--serving-bench", default=None,
                   help="BENCH_serving.json from `serving_bench "
                        "--policy-map` — folds the measured end-to-end "
                        "speedup into BENCH_dse.json")
    c.add_argument("--bench-out", default=None,
                   help="write the BENCH_dse.json summary here")
    c.add_argument("--allow-sdc", action="store_true",
                   help="exit 0 even if certification observes SDC > 0")
    return p


def _check_device(cm, path, device) -> None:
    """Refuse, by name, a cost model measured on another device than
    ``device`` or with no device recorded: its times price another
    machine."""
    from repro_torch.dse.cost import device_name
    want = device_name(device)
    if cm.device is None:
        raise SystemExit(f"cost model {path} records no device; measure one "
                         f"on {want} (repro_torch.dse.cli measure)")
    if cm.device != want:
        raise SystemExit(f"cost model {path} was measured on {cm.device!r}, "
                         f"not on this run's {want!r}; measure one here")


def _cost_model(args, out: pathlib.Path, log):
    from repro_torch.dse.cost import CostModel, measure
    path = pathlib.Path(args.cost_model) if args.cost_model \
        else out / "cost_model.json"
    if path.exists():
        cm = CostModel.load(path)
        _check_device(cm, path, args.device)
        return cm, path
    log(f"cost model {path} absent - measuring (reduced reps) ...")
    cm = measure(arch=args.arch, reps=10, backend=args.backend,
                 seed=args.seed, spaces=(args.space,), device=args.device)
    cm.save(path)
    return cm, path


def cmd_measure(args, log) -> int:
    from repro_torch.dse.cost import measure
    from repro_torch.dse.space import get_space
    spaces = tuple(s.strip() for s in args.spaces.split(",") if s.strip())
    cm = measure(arch=args.arch, batch=args.batch, reps=args.reps,
                 backend=args.backend, seed=args.seed, spaces=spaces,
                 device=args.device)
    path = cm.save(pathlib.Path(args.out) / "cost_model.json")
    log(f"wrote {path} (measured on {cm.device})")
    for space in spaces:
        for uniform in ("none", "abft", "tmr", "ckpt"):
            try:
                sp = get_space(space)
                genes = sp.genes(sp.uniform_genome(uniform))
                log(f"  {space}: uniform {uniform:5s} -> "
                    f"{cm.predict(space, genes):.4f} ms")
            except KeyError:
                pass
    return 0


def cmd_search(args, log) -> int:
    from repro_torch.campaign.journal import CampaignJournal
    from repro_torch.campaign.stats import SamplingPlan
    from repro_torch.dse import report as report_mod
    from repro_torch.dse.fitness import Evaluator
    from repro_torch.dse.search import search
    from repro_torch.dse.space import get_space
    out = pathlib.Path(args.out)
    space = get_space(args.space)
    cm, cm_path = _cost_model(args, out, log)
    journal = None if args.no_journal else CampaignJournal(out / "journal")
    plan = SamplingPlan(ci_halfwidth=args.ci_halfwidth,
                        chunk=max(args.trials // 3, 10),
                        min_trials=min(20, args.trials))
    ev = Evaluator(space, cm, seed=args.seed, backend=args.backend,
                   arch=args.arch, fault_model=args.fault_model,
                   trials=args.trials, plan=plan, journal=journal, log=log,
                   device=args.device)
    log(f"searching {args.space} space ({space.size()} designs) ...")
    result = search(space, ev, generations=args.generations,
                    population=args.population, seed=args.seed,
                    mutation_rate=args.mutation_rate, log=log)
    meta = {"seed": args.seed, "arch": args.arch, "backend": args.backend,
            "fault_model": args.fault_model, "trials": args.trials,
            "ci_halfwidth": args.ci_halfwidth,
            "population": args.population,
            "cost_model": str(cm_path),
            "campaigns_run": ev.campaigns_run}
    report_mod.write_pareto(out, space, result, meta=meta)
    log(f"wrote {out / 'pareto.json'}, {out / 'pareto.md'}"
        + ("" if result.best is None else f", {out / 'best_map.json'}"))
    if result.best is None:
        log("search produced no candidates")
        return 1
    b = result.best.fitness
    log(f"best: {b.genes}  sdc_max={b.sdc_max:g} "
        f"cost={b.cost_ms:.4f}ms det={b.detection_ticks:.2f} ticks "
        f"campaigns_run={ev.campaigns_run}")
    return 0


def cmd_certify(args, log) -> int:
    from repro_torch.campaign.stats import SamplingPlan
    from repro_torch.core.policy_map import as_policy_map
    from repro_torch.dse import report as report_mod
    from repro_torch.dse.fitness import Evaluator
    from repro_torch.dse.space import get_space
    out = pathlib.Path(args.out)
    space = get_space(args.space)
    map_path = pathlib.Path(args.map) if args.map else out / "best_map.json"
    pm = as_policy_map(str(map_path))
    genome = space.from_policy_map(pm)
    cm, _ = _cost_model(args, out, log)
    genes = space.genes(genome)
    cost_ms = cm.predict(args.space, genes)
    uniform_abft = cm.predict(
        args.space, space.genes(space.uniform_genome("abft")))
    plan = SamplingPlan(ci_halfwidth=args.ci_halfwidth,
                        chunk=max(args.trials // 3, 10))
    ev = Evaluator(space, cm, seed=args.seed, backend=args.backend,
                   arch=args.arch, fault_model=args.fault_model,
                   trials=args.trials, plan=plan, journal=None, log=log,
                   device=args.device)
    log(f"certifying {map_path} on the {args.space} space "
        f"({args.trials} trials/site, mapped engine) ...")
    rows = ev.certify(genome, trials=args.trials, plan=plan)

    pareto_doc = None
    ppath = out / "pareto.json"
    if ppath.exists():
        pareto_doc = json.loads(ppath.read_text())
    serving = None
    if args.serving_bench:
        sb = json.loads(pathlib.Path(args.serving_bench).read_text())
        pm_sec = sb.get("policy_map") or {}
        runs = pm_sec.get("runs", {})
        serving = {
            "source": args.serving_bench,
            "policy_map_speedup": sb.get("policy_map_speedup"),
            "bit_identical": pm_sec.get("bit_identical"),
            "mapped_tokens_per_s": runs.get("mapped", {})
            .get("tokens_per_s"),
            "uniform_abft_tokens_per_s": runs.get("uniform_abft", {})
            .get("tokens_per_s"),
        }
    doc = report_mod.bench_doc(
        space_name=args.space, map_doc=pm.to_doc(), certify_rows=rows,
        cost={"best_ms": round(cost_ms, 5),
              "uniform_abft_ms": round(uniform_abft, 5),
              "vs_uniform_abft": round(cost_ms / uniform_abft, 4)
              if uniform_abft else None},
        pareto_doc=pareto_doc, serving=serving)
    sdc = doc["certify"]["sdc_max"]
    log(f"certified: sdc_max={sdc} over {doc['certify']['trials']} trials, "
        f"cost {cost_ms:.4f} ms vs uniform-abft {uniform_abft:.4f} ms "
        f"({doc['cost']['vs_uniform_abft']}x)")
    if args.bench_out:
        bpath = pathlib.Path(args.bench_out)
        bpath.parent.mkdir(parents=True, exist_ok=True)
        bpath.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
        log(f"wrote {bpath}")

    ok = True
    if sdc > 0 and not args.allow_sdc:
        print(f"certification FAILED: observed SDC rate {sdc:g} > 0",
              file=sys.stderr)
        ok = False
    if uniform_abft and cost_ms >= uniform_abft and not space.genes(
            genome) == space.genes(space.uniform_genome("abft")):
        print(f"certification FAILED: map costs {cost_ms:.4f} ms, not "
              f"below uniform ABFT ({uniform_abft:.4f} ms)",
              file=sys.stderr)
        ok = False
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch import resolve_device
    resolve_device(args.device)
    log = lambda s: print(s, flush=True)                  # noqa: E731
    if args.cmd == "measure":
        return cmd_measure(args, log)
    if args.cmd == "search":
        return cmd_search(args, log)
    return cmd_certify(args, log)


if __name__ == "__main__":
    raise SystemExit(main())
