"""Crash-consistent campaign journal — resumable runs.

Every configuration appends its trial chunks to a per-config record under
``<out>/journal/``; a killed campaign resumes with ``--resume <dir>``:
completed configurations are skipped outright, half-finished ones continue
from the recorded trial offset with the correct key stream.

Publish discipline is the same as ``train/checkpoint.IncrementalCheckpointer``
manifests: the whole record is rewritten to ``<name>.tmp``, fsynced, then
``os.rename``d over the live file — a crash at any instant leaves either the
previous consistent record or the new one, never a torn file.  Unparseable
records (including a torn ``.tmp`` from a crash mid-write) are ignored and
the configuration simply re-runs.

The counterpart of ``repro.campaign.journal``.  Resume correctness hinges
on one contract: trial ``i``'s fault is drawn from
``faultload.trial_seed(seed, label, i)``.  A record is only continued when
the stored spec (seed, cap, fault model, backend, …) matches the requested
one bit-for-bit, as in the reference, and when it was written under the
same seed-stream scheme (``faultload.STREAM_SCHEME``, stored in the record
as ``stream``): the reference's journals draw from ``jax.random`` keys, so
the same spec injects other faults there and such a record is never
continued.  Any mismatch discards the record and restarts that
configuration.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import zlib
from typing import Dict, List, Optional

from repro_torch.campaign.faultload import STREAM_SCHEME, CampaignSpec
from repro_torch.core.dependability import Policy

JOURNAL_VERSION = 1


def spec_to_doc(spec: CampaignSpec) -> dict:
    d = dataclasses.asdict(spec)
    d["policy"] = spec.policy.value
    return d


def spec_from_doc(d: dict) -> CampaignSpec:
    d = dict(d)
    d["policy"] = Policy(d["policy"])
    return CampaignSpec(**d)


class CampaignJournal:
    """Directory of per-configuration trial records, atomically published."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path_for(self, spec: CampaignSpec) -> pathlib.Path:
        label = spec.label()
        slug = label.replace("/", "_").replace("@", "_")
        return self.root / f"{zlib.crc32(label.encode()):08x}_{slug}.json"

    # ------------------------------------------------------------- read
    def load(self, spec: CampaignSpec) -> Optional[dict]:
        """The stored record for ``spec``, or None if absent, torn, or
        written by a different spec (changed seed/cap/… ⇒ stale keys) or
        under another seed-stream scheme."""
        path = self.path_for(spec)
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            return None
        if doc.get("version") != JOURNAL_VERSION \
                or doc.get("stream") != STREAM_SCHEME:
            return None
        try:
            stored = spec_from_doc(doc["spec"])
        except (KeyError, TypeError, ValueError):
            return None
        if stored != spec:
            return None
        return doc

    # ------------------------------------------------------------ write
    def publish(self, spec: CampaignSpec, chunks: List[dict],
                done: bool) -> pathlib.Path:
        """Atomically rewrite the record: tmp → fsync → rename."""
        path = self.path_for(spec)
        doc = {
            "version": JOURNAL_VERSION,
            "stream": STREAM_SCHEME,
            "label": spec.label(),
            "spec": spec_to_doc(spec),
            "trials_done": sum(c["hi"] - c["lo"] for c in chunks),
            "done": bool(done),
            "chunks": list(chunks),
        }
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        return path

    # ---------------------------------------------------------- inspect
    def records(self) -> Dict[str, dict]:
        """Every parseable record in the journal, keyed by config label."""
        out: Dict[str, dict] = {}
        for p in sorted(self.root.glob("*.json")):
            try:
                doc = json.loads(p.read_text())
            except (OSError, ValueError):
                continue
            if doc.get("version") == JOURNAL_VERSION \
                    and doc.get("stream") == STREAM_SCHEME and "label" in doc:
                out[doc["label"]] = doc
        return out
