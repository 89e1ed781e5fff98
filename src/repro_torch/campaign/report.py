"""Campaign result classification + coverage reports (JSON + markdown).

Every trial lands in exactly one DAVOS-style dependability class, derived
from two observables — did the policy raise a detection, and does the final
output differ bit-for-bit from the fault-free golden run:

                      output == golden     output != golden
  no detection        masked               SDC  (silent data corruption)
  detection raised    detected_corrected   detected_uncorrected

Coverage = 1 − SDC rate: the fraction of injected faults that could not
silently corrupt the result (either they never manifested, or the policy
caught them — caught-but-uncorrected faults still trigger recovery at a
higher layer, e.g. checkpoint restore, so they are not silent).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

CLASSES = ("masked", "detected_corrected", "detected_uncorrected", "sdc")


def classify_counts(detected: np.ndarray, mismatch: np.ndarray) -> Dict[str, int]:
    """Vector classification of a trial batch → per-class counts."""
    detected = np.asarray(detected, bool)
    mismatch = np.asarray(mismatch, bool)
    return {
        "masked": int((~detected & ~mismatch).sum()),
        "detected_corrected": int((detected & ~mismatch).sum()),
        "detected_uncorrected": int((detected & mismatch).sum()),
        "sdc": int((~detected & mismatch).sum()),
    }


@dataclasses.dataclass(frozen=True)
class ConfigResult:
    """One row of the coverage report: a configuration and its trial tallies.

    The recovery columns quantify the restart half of the dependability
    loop: ``faults_recovered`` counts rollback recoveries (CKPT op
    re-executions, engine snapshot restores, fleet incremental restores /
    drains) and the latency columns carry their measured wall-clock cost —
    host-side recoveries only; in-graph rollbacks (kernel workloads) are
    part of the op's own runtime and report latency 0.
    """
    workload: str
    policy: str
    site: str
    fault_model: str
    trials: int
    masked: int
    detected_corrected: int
    detected_uncorrected: int
    sdc: int
    backend: str = "cuda"      # execution backend the trials ran on
    faults_recovered: int = 0  # rollback/restart recoveries across trials
    recovery_ms_mean: float = 0.0
    recovery_ms_max: float = 0.0
    # injection→detection→recovery timelines reconstructed from the
    # structured dependability event log (repro_torch.obs.events): how many
    # strike chains were logged, and the detection-/recovery-latency
    # distributions in the emitting layer's deterministic ticks
    strikes_logged: int = 0
    detections_logged: int = 0
    detection_ticks_mean: float = 0.0
    detection_ticks_max: int = 0
    recovery_ticks_mean: float = 0.0
    recovery_ticks_max: int = 0
    # sequential-sampling columns (adaptive engine): ``trials`` above is the
    # *executed* count; ``max_trials`` the configured cap (0 in legacy
    # reports written before the adaptive engine).  The CI bounds are the
    # binomial interval on the SDC / detection rates at ``ci_confidence``
    # via ``ci_method`` (wilson or clopper-pearson).
    max_trials: int = 0
    early_stopped: bool = False
    ci_method: str = ""
    ci_confidence: float = 0.0
    sdc_ci_lo: float = 0.0
    sdc_ci_hi: float = 0.0
    detection_ci_lo: float = 0.0
    detection_ci_hi: float = 0.0

    @property
    def detection_rate(self) -> float:
        return (self.detected_corrected + self.detected_uncorrected) / max(self.trials, 1)

    @property
    def sdc_rate(self) -> float:
        return self.sdc / max(self.trials, 1)

    @property
    def coverage(self) -> float:
        return 1.0 - self.sdc_rate

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["detection_rate"] = self.detection_rate
        d["sdc_rate"] = self.sdc_rate
        d["coverage"] = self.coverage
        return d

    @staticmethod
    def from_dict(d: dict) -> "ConfigResult":
        fields = {f.name for f in dataclasses.fields(ConfigResult)}
        return ConfigResult(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class BitCoverageRow:
    """Per-bit-position accumulator coverage: ``trials`` flips targeted at
    int32 bit ``bit`` of the accumulator, classified like any campaign
    trial.  Low-bit rows are where requantization masks (the fp32 rescale
    rounds ±2^bit to the same int8); high-bit rows are where only the
    policy stands between the flip and SDC."""
    workload: str
    policy: str
    backend: str
    bit: int
    trials: int
    masked: int
    detected_corrected: int
    detected_uncorrected: int
    sdc: int

    @property
    def detection_rate(self) -> float:
        return (self.detected_corrected + self.detected_uncorrected) / max(self.trials, 1)

    @property
    def masked_rate(self) -> float:
        return self.masked / max(self.trials, 1)

    @property
    def sdc_rate(self) -> float:
        return self.sdc / max(self.trials, 1)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["detection_rate"] = self.detection_rate
        d["masked_rate"] = self.masked_rate
        d["sdc_rate"] = self.sdc_rate
        return d

    @staticmethod
    def from_dict(d: dict) -> "BitCoverageRow":
        fields = {f.name for f in dataclasses.fields(BitCoverageRow)}
        return BitCoverageRow(**{k: v for k, v in d.items() if k in fields})


def to_json_dict(results: Sequence[ConfigResult], meta: dict | None = None,
                 bit_coverage: Sequence[BitCoverageRow] | None = None) -> dict:
    out = {"meta": dict(meta or {}),
           "results": [r.to_dict() for r in results]}
    if bit_coverage:
        out["bit_coverage"] = [r.to_dict() for r in bit_coverage]
    return out


def from_json_dict(d: dict) -> Tuple[dict, List[ConfigResult]]:
    return d.get("meta", {}), [ConfigResult.from_dict(r) for r in d["results"]]


def bit_coverage_from_json_dict(d: dict) -> List[BitCoverageRow]:
    return [BitCoverageRow.from_dict(r) for r in d.get("bit_coverage", [])]


def load_report(path) -> Tuple[dict, List[ConfigResult]]:
    with open(path) as f:
        return from_json_dict(json.load(f))


def to_markdown(results: Sequence[ConfigResult], meta: dict | None = None,
                bit_coverage: Sequence[BitCoverageRow] | None = None) -> str:
    lines = ["# SEU fault-injection campaign report", ""]
    for k, v in (meta or {}).items():
        lines.append(f"- **{k}**: {v}")
    if meta:
        lines.append("")
    lines += [
        "| workload | backend | policy | site | fault model | trials | masked "
        "| det-corr | det-unc | SDC | det. rate | SDC rate | SDC 95% CI "
        "| coverage | recovered | rec. mean ms | det. lat ticks (mean/max) "
        "| rec. lat ticks (mean/max) |",
        "|---|---|---|---|---|---:|---:|---:|---:|---:|---:|---:|---:|---:"
        "|---:|---:|---:|---:|",
    ]
    for r in results:
        rec_ms = f"{r.recovery_ms_mean:.2f}" if r.faults_recovered else "—"
        det_lat = (f"{r.detection_ticks_mean:.1f}/{r.detection_ticks_max}"
                   if r.detections_logged else "—")
        rec_lat = (f"{r.recovery_ticks_mean:.1f}/{r.recovery_ticks_max}"
                   if r.faults_recovered and r.strikes_logged else "—")
        trials = (f"{r.trials}*" if r.early_stopped else f"{r.trials}")
        sdc_ci = (f"[{r.sdc_ci_lo:.3f}, {r.sdc_ci_hi:.3f}]"
                  if r.ci_method else "—")
        lines.append(
            f"| {r.workload} | {r.backend} | {r.policy} | {r.site} "
            f"| {r.fault_model} "
            f"| {trials} | {r.masked} | {r.detected_corrected} "
            f"| {r.detected_uncorrected} | {r.sdc} "
            f"| {r.detection_rate:.3f} | {r.sdc_rate:.3f} | {sdc_ci} "
            f"| {r.coverage:.3f} "
            f"| {r.faults_recovered} | {rec_ms} | {det_lat} | {rec_lat} |")
    if any(r.early_stopped for r in results):
        lines.append("")
        lines.append("\\* stopped early: SDC-rate CI half-width reached the "
                     "requested precision before the trial cap.")
    lines.append("")
    if bit_coverage:
        lines += [
            "## Accumulator bit-position coverage",
            "",
            "Which int32 accumulator bits the requantization rescale masks"
            " (flip never reaches the int8 output) vs. which the policy"
            " detects:",
            "",
            "| workload | backend | policy | bit | trials | masked "
            "| det-corr | det-unc | SDC | masked rate | det. rate |",
            "|---|---|---|---:|---:|---:|---:|---:|---:|---:|---:|",
        ]
        for r in bit_coverage:
            lines.append(
                f"| {r.workload} | {r.backend} | {r.policy} | {r.bit} "
                f"| {r.trials} | {r.masked} | {r.detected_corrected} "
                f"| {r.detected_uncorrected} | {r.sdc} "
                f"| {r.masked_rate:.3f} | {r.detection_rate:.3f} |")
        lines.append("")
    return "\n".join(lines)


def write_report(results: Sequence[ConfigResult], out_dir,
                 meta: dict | None = None,
                 basename: str = "campaign",
                 bit_coverage: Sequence[BitCoverageRow] | None = None,
                 ) -> Tuple[pathlib.Path, pathlib.Path]:
    """Write <out_dir>/<basename>.json and .md; returns both paths."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jpath = out / f"{basename}.json"
    mpath = out / f"{basename}.md"
    with open(jpath, "w") as f:
        json.dump(to_json_dict(results, meta, bit_coverage), f, indent=2)
    mpath.write_text(to_markdown(results, meta, bit_coverage))
    return jpath, mpath
