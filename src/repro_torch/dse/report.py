"""Committed artifacts of a DSE run: frontier JSON + human-readable
markdown + the serving policy map + the BENCH_dse summary.

The counterpart of ``repro.dse.report``: the same renderers, so the same
docs give the same bytes in both packages.

Everything here is a pure renderer over :class:`~repro_torch.dse.search.
SearchResult` docs and campaign rows — no measurement happens in this
module, so the committed reports are exactly what the search saw.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional


def _dump(path: pathlib.Path, doc: dict) -> pathlib.Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return path


def write_pareto(out_dir, space, result, *, meta: dict) -> dict:
    """Write pareto.json + pareto.md + best_map.json; returns the doc."""
    out = pathlib.Path(out_dir)
    doc = {"report": "dse_pareto", "space": space.name, "meta": meta,
           **result.to_doc()}
    _dump(out / "pareto.json", doc)
    if result.best is not None:
        pm = space.to_policy_map(result.best.genome)
        _dump(out / "best_map.json", pm.to_doc())
    (out / "pareto.md").write_text(render_markdown(space, result, meta))
    return doc


def render_markdown(space, result, meta: dict) -> str:
    lines = [
        f"# Selective-hardening Pareto frontier — `{space.name}` space",
        "",
        f"Search: {result.generations} generations, "
        f"{result.evaluations} distinct genomes evaluated "
        f"(space size {space.size()}), seed {meta.get('seed', '?')}, "
        f"fault model `{meta.get('fault_model', '?')}`.",
        "",
        "Objectives (all minimized): worst per-site SDC-rate CI upper "
        "bound, measured dependability cost (ms, cost-oracle prediction "
        "from per-site microbenchmarks), mean detection latency (ticks).",
        "",
        "## Non-dominated front",
        "",
        "| # | " + " | ".join(space.site_names)
        + " | sdc_ci_hi | cost_ms | det_ticks |",
        "|---" * (len(space.site_names) + 4) + "|",
    ]
    for i, c in enumerate(result.front):
        genes = [c.fitness.genes[s] for s in space.site_names]
        o = c.objectives
        lines.append(f"| {i} | " + " | ".join(genes)
                     + f" | {o[0]:.4f} | {o[1]:.4f} | {o[2]:.2f} |")
    best = result.best
    lines += ["", "## Selected design (pick_best)", ""]
    if best is None:
        lines.append("no candidate evaluated")
    else:
        lines += [
            f"- digest `{best.digest}`; observed SDC max "
            f"{best.fitness.sdc_max:g} over {best.fitness.trials} trials; "
            f"predicted cost {best.fitness.cost_ms:.4f} ms; detection "
            f"latency {best.fitness.detection_ticks:.2f} ticks",
            "- genes: " + ", ".join(
                f"`{s}={best.fitness.genes[s]}`" for s in space.site_names),
            "",
            "The decision rule is the paper's: cheapest design whose "
            "campaign evidence is consistent with SDC = 0.  The committed "
            "`best_map.json` is this genome rendered as a PolicyMap "
            "(`repro.fleet.cli --policy-map`, `Engine(policy_map=...)`).",
        ]
    lines.append("")
    return "\n".join(lines)


def bench_doc(*, space_name: str, map_doc: dict, certify_rows: dict,
              cost: dict, pareto_doc: Optional[dict] = None,
              serving: Optional[dict] = None) -> dict:
    """Assemble the BENCH_dse.json summary: search provenance, the best
    map's certification campaign rows, its predicted cost vs the uniform
    corners, and (when ``benchmarks/serving_bench --policy-map`` ran) the
    end-to-end mapped-vs-uniform-ABFT throughput ratio."""
    doc = {
        "bench": "dse",
        "space": space_name,
        "policy_map": map_doc,
        "cost": cost,
        "certify": {
            "rows": certify_rows,
            "sdc_max": max((r["sdc"] for r in certify_rows.values()),
                           default=0),
            "sdc_ci_hi_max": max((r["sdc_ci_hi"]
                                  for r in certify_rows.values()),
                                 default=0.0),
            "trials": sum(r["trials"] for r in certify_rows.values()),
        },
    }
    if pareto_doc is not None:
        doc["search"] = {
            "generations": pareto_doc.get("generations"),
            "evaluations": pareto_doc.get("evaluations"),
            "front_size": len(pareto_doc.get("front", [])),
            "meta": pareto_doc.get("meta", {}),
        }
    if serving is not None:
        doc["serving"] = serving
    return doc
