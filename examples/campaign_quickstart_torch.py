"""Quickstart on the port: run a small SEU fault-injection campaign.

    PYTHONPATH=src python examples/campaign_quickstart_torch.py [--device cpu]

Sweeps the paper's two hot-path primitives under all three dependability
policies, prints the coverage table, and shows how to drill one
configuration by hand (the API the CLI wraps).  Each trial draws its fault
from its own seed (``trial_seeds``); on the card every trial runs the
``cuda`` backend's kernels, on the CPU their plain versions.  The
workloads' operands are the campaign's own small shapes, so the default
is already the full run (``--full`` changes nothing); the report goes to
``reports/quickstart_torch``.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.campaign import (
    CampaignSpec, build_case, expand_grid, resolve_fault_model, run_campaign,
    to_markdown, trial_seeds, write_report)
from repro_torch.campaign.runner import SUPPORTED
from repro_torch.core.dependability import Policy


def run(device="cuda", *, trials=100, drill_trials=500, kernel_trials=50,
        kernel_backend="cuda", out_dir="reports/quickstart_torch",
        full=False) -> dict:
    """The grid, the hand drill and the drill on ``kernel_backend``;
    returns the grid's results and each drill's (detected, mismatch).
    ``full`` is accepted for symmetry with the other examples: the counts
    above are already the reference script's."""
    dev = resolve_device(device)
    # 1. A grid campaign: workloads × policies × sites × fault models.
    specs = expand_grid(
        workloads=["qmatmul", "qconv2d"],
        policies=[Policy.NONE, Policy.ABFT, Policy.TMR],
        sites=["accumulator", "weights"],
        fault_models=["single_bitflip", "stuck_at1"],
        trials=trials, seed=0, supported=SUPPORTED)
    results = run_campaign(specs, log=print, device=dev)
    print()
    print(to_markdown(results, {"example": "campaign_quickstart_torch"}))
    write_report(results, out_dir, {"seed": 0})

    # 2. Drilling a single configuration by hand — the same pieces the
    #    runner composes: a case, a fault model, a deterministic seed stream.
    spec = CampaignSpec("qmatmul", Policy.ABFT, "accumulator",
                        "single_bitflip", trials=drill_trials, seed=42)
    case = build_case(spec.workload, spec.seed, device=dev)
    fault = resolve_fault_model(spec.fault_model)
    detected, mismatch = case.run_trials(spec.policy, spec.site, fault.apply,
                                         trial_seeds(spec))
    print(f"hand-rolled drill: {detected.sum()}/{spec.trials} detected, "
          f"{mismatch.sum()} corrupted outputs "
          f"(ABFT zero-false-negative claim: detection == trials)")
    assert detected.all() and not mismatch.any()
    drill = (detected, mismatch)

    # 3. The same drill on the kernel path (docs/backends.md): the check
    #    vector is fused into the kernel as a second output, and the
    #    zero-false-negative claim must hold there too.
    pspec = CampaignSpec("qmatmul", Policy.ABFT, "accumulator",
                         "single_bitflip", trials=kernel_trials, seed=42,
                         backend=kernel_backend)
    pcase = build_case(pspec.workload, pspec.seed, pspec.backend,
                       device=dev)
    detected, mismatch = pcase.run_trials(pspec.policy, pspec.site,
                                          fault.apply, trial_seeds(pspec))
    print(f"{pspec.backend}-backend drill: {detected.sum()}/{pspec.trials} "
          f"detected, {mismatch.sum()} corrupted outputs")
    assert detected.all() and not mismatch.any()
    return {"results": results, "drill": drill,
            "kernel_drill": (detected, mismatch)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain versions)")
    ap.add_argument("--backend", default="cuda",
                    help="the backend of the third act's drill: cuda, "
                         "torch or ref")
    ap.add_argument("--out", default="reports/quickstart_torch",
                    help="the report's directory")
    ap.add_argument("--full", action="store_true",
                    help="the default: the reference's trial counts")
    args = ap.parse_args(argv)
    run(args.device, kernel_backend=args.backend, out_dir=args.out,
        full=args.full)


if __name__ == "__main__":
    main()
