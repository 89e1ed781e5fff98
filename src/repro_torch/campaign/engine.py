"""Adaptive campaign execution engine: chunked trials, sharding, resume.

The counterpart of ``repro.campaign.engine``.  This is the scheduling
layer between the campaign driver (``runner.py``) and the workload cases.
A configuration's trials run as ordered *chunks* of the deterministic seed
stream (``faultload.trial_seeds``), which buys three things at once:

  * **sequential sampling** — after each chunk the SDC-rate confidence
    interval is re-evaluated (``stats.SamplingPlan``) and the configuration
    stops at the first chunk boundary where it is tight enough;
  * **sharded execution** — the model cases (shipdet, transformer) fan
    chunks across a spawn-based process pool (``CampaignPool``): each
    worker builds the case once from the same (workload, seed, backend)
    triple on the pool's device and runs seed *slices* of the same stream,
    so per-trial results are bit-identical to a serial run.
    Speculative chunks computed past the stopping boundary are discarded,
    so adaptive sharded runs execute exactly the serial trial set;
  * **resumable campaigns** — every merged chunk is appended to the
    crash-consistent ``CampaignJournal``; a killed campaign resumes from
    the recorded trial offset with the correct seed slice.

Dependability events (``repro_torch.obs.EventLog``) and recovery accounting are
drained per chunk — in the worker when sharded — and shipped back inside
``ChunkOutcome``, so the report's timeline columns are identical whether
the trials ran in-process or across the pool.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pathlib
import sys
from typing import List, Optional, Sequence, Tuple

from repro_torch.campaign import faultload as fl
from repro_torch.campaign.journal import CampaignJournal
from repro_torch.campaign.stats import SamplingPlan
from repro_torch.obs.events import Event


class CampaignInterrupted(RuntimeError):
    """A campaign was aborted mid-run (test hook / simulated kill).  The
    journal already holds every merged chunk, so ``--resume`` continues."""


class AbortAfter:
    """Test hook: raise ``CampaignInterrupted`` after N merged chunks —
    a deterministic stand-in for kill -9 between journal publishes."""

    def __init__(self, chunks: Optional[int]):
        self.remaining = chunks

    def tick(self) -> None:
        if self.remaining is None:
            return
        self.remaining -= 1
        if self.remaining <= 0:
            raise CampaignInterrupted("aborted by AbortAfter test hook")


@dataclasses.dataclass
class ChunkOutcome:
    """Per-trial verdicts plus drained side accounting for trials [lo, hi)."""
    lo: int
    hi: int
    detected: List[bool]
    mismatch: List[bool]
    recovery_count: int = 0
    recovery_seconds: List[float] = dataclasses.field(default_factory=list)
    events: List[Event] = dataclasses.field(default_factory=list)

    def to_doc(self) -> dict:
        return {"lo": self.lo, "hi": self.hi,
                "detected": [int(b) for b in self.detected],
                "mismatch": [int(b) for b in self.mismatch],
                "recovery_count": self.recovery_count,
                "recovery_seconds": list(self.recovery_seconds),
                "events": [dataclasses.asdict(e) for e in self.events]}

    @staticmethod
    def from_doc(d: dict) -> "ChunkOutcome":
        return ChunkOutcome(
            lo=d["lo"], hi=d["hi"],
            detected=[bool(b) for b in d["detected"]],
            mismatch=[bool(b) for b in d["mismatch"]],
            recovery_count=d.get("recovery_count", 0),
            recovery_seconds=list(d.get("recovery_seconds", [])),
            events=[Event(**e) for e in d.get("events", [])])


def run_config_chunk(case, spec: fl.CampaignSpec, lo: int, hi: int,
                     ) -> ChunkOutcome:
    """Run trials [lo, hi) of ``spec`` on ``case`` and drain its accounting.

    Trial ``i``'s seed depends on (seed, label, i) alone, so any chunking
    of [0, trials) concatenates to the exact serial per-trial stream.
    """
    fault = fl.resolve_fault_model(spec.fault_model)
    seeds = fl.trial_seeds(spec, lo, hi)
    detected, mismatch = case.run_trials(spec.policy, spec.site,
                                         fault.apply, seeds)
    rec_count, rec_seconds = 0, []
    rlog = getattr(case, "_recovery", None)
    if rlog is not None:
        rec_count, rec_seconds = rlog.drain_raw()
    elog = getattr(case, "events", None)
    events = elog.drain() if elog is not None else []
    return ChunkOutcome(lo=lo, hi=hi,
                        detected=[bool(x) for x in detected],
                        mismatch=[bool(x) for x in mismatch],
                        recovery_count=rec_count,
                        recovery_seconds=rec_seconds,
                        events=events)


# ---------------------------------------------------------------------------
# Process-pool sharding
# ---------------------------------------------------------------------------

_WORKER_CASES: dict = {}


def _pool_init(src_path: str, threads: int) -> None:
    # workers are compute replicas of the parent: the repo's src on the path
    # (spawned interpreters don't inherit sys.path edits), and a share of
    # the host's cores each, so that CPU workers do not oversubscribe them
    if src_path and src_path not in sys.path:
        sys.path.insert(0, src_path)
    import torch
    torch.set_num_threads(threads)


def _pool_run_chunk(spec: fl.CampaignSpec, lo: int, hi: int,
                    device: str) -> ChunkOutcome:
    from repro_torch.campaign import runner
    key = (spec.workload, spec.seed, spec.backend, device)
    case = _WORKER_CASES.get(key)
    if case is None:
        case = _WORKER_CASES[key] = runner.build_case(*key)
    return run_config_chunk(case, spec, lo, hi)


class CampaignPool:
    """Persistent spawn-based worker pool for model-case trial chunks.

    Spawn (not fork): the parent may hold a CUDA context and torch's
    threads, which do not survive forking.  Every worker builds its cases
    on ``device`` (the parent's), pays the torch-import and case-build cost
    once and then serves chunks for the rest of the campaign, so
    per-worker state (parameters, golden outputs) is reused across
    configurations of the same workload.
    """

    def __init__(self, workers: int, device: str = "cuda"):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        import repro_torch
        src = str(pathlib.Path(repro_torch.__file__).resolve().parent.parent)
        ctx = multiprocessing.get_context("spawn")
        self.workers = workers
        self.device = str(device)
        threads = max(1, (os.cpu_count() or 1) // workers)
        self._pool = ctx.Pool(workers, initializer=_pool_init,
                              initargs=(src, threads))

    def run_chunks(self, spec: fl.CampaignSpec,
                   spans: Sequence[Tuple[int, int]]) -> List[ChunkOutcome]:
        """Dispatch the spans concurrently; return outcomes in span order."""
        handles = [self._pool.apply_async(_pool_run_chunk,
                                          (spec, lo, hi, self.device))
                   for lo, hi in spans]
        return [h.get() for h in handles]

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()

    def __enter__(self) -> "CampaignPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Per-configuration adaptive driver
# ---------------------------------------------------------------------------


class ConfigAccumulator:
    """Ordered merge of a configuration's chunk outcomes."""

    def __init__(self, spec: fl.CampaignSpec):
        self.spec = spec
        self.detected: List[bool] = []
        self.mismatch: List[bool] = []
        self.recovery_count = 0
        self.recovery_seconds: List[float] = []
        self.events: List[Event] = []
        self.sdc = 0
        self.resumed_trials = 0     # trials replayed from the journal
        self.early_stopped = False

    @property
    def n(self) -> int:
        return len(self.detected)

    def merge(self, oc: ChunkOutcome) -> None:
        if oc.lo != self.n:
            raise ValueError(f"chunk out of order: have {self.n} trials, "
                             f"got [{oc.lo}, {oc.hi})")
        self.detected.extend(oc.detected)
        self.mismatch.extend(oc.mismatch)
        self.sdc += sum(1 for d, m in zip(oc.detected, oc.mismatch)
                        if m and not d)
        self.recovery_count += oc.recovery_count
        self.recovery_seconds.extend(oc.recovery_seconds)
        self.events.extend(oc.events)


def _spans(start: int, cap: int, chunk: int, lanes: int,
           ) -> List[Tuple[int, int]]:
    """Up to ``lanes`` contiguous chunk spans starting at ``start``."""
    spans = []
    lo = start
    for _ in range(lanes):
        if lo >= cap:
            break
        hi = min(lo + chunk, cap)
        spans.append((lo, hi))
        lo = hi
    return spans


def run_config(spec: fl.CampaignSpec, plan: SamplingPlan, chunk_size: int,
               case=None, pool: Optional[CampaignPool] = None,
               journal: Optional[CampaignJournal] = None,
               abort: Optional[AbortAfter] = None) -> ConfigAccumulator:
    """Execute one configuration under the sampling plan.

    Exactly one of ``case`` (serial, in-process) or ``pool`` (sharded)
    drives the trials.  The stopping rule is evaluated at every chunk
    boundary *in trial order*; sharded lanes that ran past the boundary are
    discarded unmerged, so the executed trial set — and therefore every
    count, CI, and timeline column — is identical to a serial run.
    """
    if (case is None) == (pool is None):
        raise ValueError("exactly one of case / pool must be given")
    acc = ConfigAccumulator(spec)
    chunk_docs: List[dict] = []
    if journal is not None:
        rec = journal.load(spec)
        if rec is not None:
            for cd in rec["chunks"]:
                acc.merge(ChunkOutcome.from_doc(cd))
                chunk_docs.append(cd)
            acc.resumed_trials = acc.n
            if rec["done"]:
                acc.early_stopped = plan.adaptive and acc.n < spec.trials
                return acc
    cap = spec.trials
    lanes = pool.workers if pool is not None else 1
    stopped = plan.should_stop(acc.sdc, acc.n, cap) if acc.n else False
    while not stopped:
        spans = _spans(acc.n, cap, chunk_size, lanes)
        if not spans:
            break
        if pool is not None:
            outcomes = pool.run_chunks(spec, spans)
        else:
            outcomes = [run_config_chunk(case, spec, lo, hi)
                        for lo, hi in spans]
        for oc in outcomes:
            acc.merge(oc)
            chunk_docs.append(oc.to_doc())
            if journal is not None:
                journal.publish(spec, chunk_docs, done=False)
            if abort is not None:
                abort.tick()
            if plan.should_stop(acc.sdc, acc.n, cap):
                stopped = True
                break               # later lanes were speculative: discard
    acc.early_stopped = plan.adaptive and acc.n < cap
    if journal is not None:
        journal.publish(spec, chunk_docs, done=True)
    return acc
