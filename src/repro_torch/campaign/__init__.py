"""Statistical SEU fault-injection campaign engine.

The counterpart of ``repro.campaign``, over the port's kernels.
DAVOS-style dependability assessment for the software-rendered rad-hard
stack: sweep fault models × injection sites × dependability policies ×
workloads, classify every seeded trial, and emit a per-configuration
coverage report.

The execution layer is adaptive: ``SamplingPlan`` turns on sequential
sampling with early stopping, ``CampaignPool`` shards the model workloads
across processes with bit-identical results, and ``CampaignJournal`` makes
runs crash-resumable.  Each trial draws its fault from its own seed
(``trial_seeds``), not from the reference's ``jax.random`` key stream, so
the port is held against the reference by verdict, and trial by trial where
a test gives both packages the same addressed faults.
"""
from repro_torch.campaign.engine import (
    AbortAfter, CampaignInterrupted, CampaignPool, ChunkOutcome, run_config)
from repro_torch.campaign.faultload import (
    FAULT_MODELS, CampaignSpec, expand_grid, resolve_fault_model, trial_seed,
    trial_seeds)
from repro_torch.campaign.journal import CampaignJournal
from repro_torch.campaign.report import (
    BitCoverageRow, ConfigResult, classify_counts, load_report, to_markdown,
    write_report)
from repro_torch.campaign.runner import (
    CASES, NOT_YET, build_case, kernel_workloads, run_bit_sweep, run_campaign)
from repro_torch.campaign.stats import (
    SamplingPlan, binomial_interval, clopper_pearson_interval, halfwidth,
    wilson_interval)

__all__ = [
    "FAULT_MODELS", "CampaignSpec", "expand_grid", "resolve_fault_model",
    "trial_seed", "trial_seeds", "BitCoverageRow", "ConfigResult",
    "classify_counts", "load_report", "to_markdown", "write_report", "CASES",
    "NOT_YET", "build_case", "kernel_workloads", "run_bit_sweep",
    "run_campaign",
    "SamplingPlan", "binomial_interval", "clopper_pearson_interval",
    "halfwidth", "wilson_interval", "CampaignJournal", "CampaignPool",
    "CampaignInterrupted", "ChunkOutcome", "AbortAfter", "run_config",
]
