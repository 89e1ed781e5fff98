"""Batched serving engine — a thin facade over the streaming dataflow
executor (``runtime/dataflow.py``).

The counterpart of ``repro.runtime.serving.Engine``, with the same
constructor and surface: ``backend=`` pins the execution backend of the
W8A8 FFN matmuls and ``policy_map=`` bakes a per-site dependability map
into the config (``ffn.*`` rules run in ``_qdot``; the ``kv_cache`` and
``decode_state`` policies set the decode-state scrub, CKPT => rollback and
ABFT => detect, and the ``weights`` policy the storage scrub: ABFT =>
detect at every pump, CKPT => rollback every ``snapshot_every`` pumps);
``strike`` is the campaign's per-stage SEU surface, and ``tracer``,
``event_log`` and ``metrics`` attach the ``repro_torch.obs`` observers.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core.dependability import Policy
from repro_torch.models import api as model_api
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.dataflow import (     # noqa: F401 — re-exports
    Channel, Closed, EngineStats, Request, StreamingExecutor,
    check_scrub_mode)


class Engine:
    """Fixed-capacity continuous-batching engine over the staged executor.

    capacity: decode batch width (slots).  Prefill runs per request (right-
    padded to ``prefill_pad`` buckets); decode steps the whole batch while
    requests join and leave mid-flight.
    """

    def __init__(self, cfg: ArchConfig, params, capacity: int = 8,
                 max_len: int = 512, prefill_pad: int = 64,
                 snapshot_every: int = 32, eos_id: int = -1,
                 compiled=None, backend: Optional[str] = None,
                 policy_map=None, state_scrub: str = "off",
                 storage_scrub: Optional[str] = None,
                 storage_scrub_every: Optional[int] = None,
                 certify: Optional[Callable[[Request], bool]] = None,
                 drain_barrier: bool = False, multi_step: int = 1,
                 tracer=None, event_log=None, metrics=None):
        cfg = model_api.with_backend(cfg, backend)
        cfg = model_api.with_policy_map(cfg, policy_map)
        if policy_map is not None:
            # the scrub schedule follows the state sites unless pinned
            pm = cfg.policy_map
            if state_scrub == "off":
                state_scrub = pm.scrub_mode()
            if storage_scrub is None:
                storage_scrub = {Policy.ABFT: "detect",
                                 Policy.CKPT: "rollback"}.get(
                    pm.storage_policy(), "off")
        if storage_scrub is None:
            storage_scrub = "off"
        if storage_scrub_every is None:
            storage_scrub_every = 1 if storage_scrub == "detect" \
                else snapshot_every
        self._ex = StreamingExecutor(
            cfg, params, capacity=capacity, max_len=max_len,
            prefill_pad=prefill_pad, snapshot_every=snapshot_every,
            eos_id=eos_id, compiled=compiled, state_scrub=state_scrub,
            storage_scrub=storage_scrub,
            storage_scrub_every=storage_scrub_every,
            certify=certify, drain_barrier=drain_barrier,
            multi_step=multi_step, tracer=tracer, event_log=event_log,
            metrics=metrics)

    # ------------------------------------------------------------- pipeline
    @property
    def executor(self) -> StreamingExecutor:
        return self._ex

    @property
    def cfg(self):
        return self._ex.cfg

    @property
    def compiled(self):
        return self._ex.compiled

    # --------------------------------------------------- state pass-through
    @property
    def params(self):
        return self._ex.params

    @params.setter
    def params(self, value):
        self._ex.params = value

    @property
    def capacity(self):
        return self._ex.capacity

    @property
    def max_len(self):
        return self._ex.max_len

    @property
    def prefill_pad(self):
        return self._ex.prefill_pad

    @property
    def snapshot_every(self):
        return self._ex.snapshot_every

    @property
    def eos_id(self):
        return self._ex.eos_id

    @property
    def multi_step(self):
        return self._ex.multi_step

    @property
    def queue(self):
        """The submission channel's deque (admit-stage inbox)."""
        return self._ex.submit_ch.items

    @property
    def active(self):
        """slot -> Request mapping of the decode stage's live batch."""
        return self._ex.decode.active

    @property
    def slot_pos(self):
        return self._ex.decode.slot_pos

    @property
    def slot_remaining(self):
        return self._ex.decode.slot_remaining

    @property
    def cache(self):
        return self._ex.decode.cache

    @cache.setter
    def cache(self, value):
        self._ex.decode.cache = value

    @property
    def tokens(self):
        return self._ex.decode.tokens

    @tokens.setter
    def tokens(self, value):
        self._ex.decode.tokens = value

    @property
    def stats(self) -> EngineStats:
        return self._ex.stats

    @property
    def certify(self):
        return self._ex.certify

    @certify.setter
    def certify(self, hook):
        self._ex.certify = hook

    @property
    def policy_map(self):
        return self._ex.cfg.policy_map

    @property
    def state_scrub(self) -> str:
        return self._ex.state_scrub

    @state_scrub.setter
    def state_scrub(self, mode: str):
        self._ex.state_scrub = check_scrub_mode("state_scrub", mode)

    @property
    def storage_scrub(self) -> str:
        return self._ex.storage_scrub

    @property
    def storage_scrub_every(self) -> int:
        return self._ex.storage_scrub_every

    @property
    def state_events(self):
        return self._ex.state_events

    # ------------------------------------------------------- observability
    @property
    def tick(self) -> int:
        """The executor's deterministic pump-cycle clock."""
        return self._ex.tick

    @property
    def tracer(self):
        return self._ex.tracer

    @tracer.setter
    def tracer(self, value):
        self._ex.tracer = value

    @property
    def event_log(self):
        return self._ex.event_log

    @event_log.setter
    def event_log(self, value):
        self._ex.event_log = value

    @property
    def metrics(self):
        return self._ex.metrics

    @property
    def dependability(self):
        return self._ex.dependability

    @property
    def _snapshot(self):
        return self._ex._snapshot

    @_snapshot.setter
    def _snapshot(self, value):
        self._ex._snapshot = value

    # ------------------------------------------------------------ lifecycle
    def reset(self, params=None):
        self._ex.reset(params=params)

    def submit(self, req: Request):
        self._ex.submit(req)

    def cancel(self, uid: int) -> bool:
        return self._ex.cancel(uid)

    def step(self) -> List[Request]:
        """One cooperative pump of every stage; returns the requests that
        cleared the release stage this cycle."""
        return self._ex.step()

    def run(self, max_steps: int = 10_000) -> EngineStats:
        """Drain the pipeline."""
        return self._ex.run(max_steps=max_steps)

    # ------------------------------------------------------- dependability
    def scrub_decode_state(self) -> bool:
        return self._ex.scrub_decode_state()

    def scrub_storage(self) -> bool:
        """Verify live params against the golden storage checksums
        (True == clean); True when storage scrubbing is off."""
        return self._ex.scrub_storage()

    def refresh_storage_baseline(self):
        """Re-bless the current params as golden (rolling-deploy hook)."""
        self._ex.refresh_storage_baseline()

    def drain_state_events(self) -> List[dict]:
        return self._ex.drain_state_events()

    def record_dependability(self, stats: dict):
        self._ex.record_dependability(stats)

    def strike(self, site: str, fault, key, leaf=None) -> None:
        """Per-stage SEU injection (the campaign's drill surface)."""
        self._ex.strike(site, fault, key, leaf=leaf)

    def dependability_report(self) -> dict:
        """Host-side dependability summary: detection counters and the
        replay/snapshot state a campaign judges recovery cost by."""
        from repro_torch.core.dependability import DependabilityStats
        ex = self._ex
        out = DependabilityStats.to_host(ex.dependability)
        out.update(steps=ex.stats.steps, replays=ex.stats.replays,
                   tokens_out=ex.stats.tokens_out,
                   snapshot_every=ex.snapshot_every,
                   state_scrub=ex.state_scrub,
                   storage_scrub=ex.storage_scrub,
                   state_events_pending=len(ex.state_events))
        return out

    def restore_snapshot(self) -> int:
        """Roll back to the last (checksum-verified) snapshot; returns the
        steps replayed."""
        return self._ex.restore_snapshot()
