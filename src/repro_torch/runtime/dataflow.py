"""Streaming dataflow executor — the Klepsydra-style staged serving pipeline.

The counterpart of ``repro.runtime.dataflow``:

    submit ─▶ [admit] ─▶ [prefill] ─▶ [decode] ─▶ [certify] ─▶ [release]

Every arrow is a bounded single-producer/single-consumer ``Channel``; the
decode stage does continuous batching (requests join free slots of the
fixed-capacity KV-cache batch and leave it mid-flight); the certify stage
is the release gate.  The cooperative driver (``StreamingExecutor.step``)
pumps the stages in topological order on the caller's thread, so token
streams are a pure function of submission order.

The port decodes one step per pump (``decode_once``).  The decode state is
mutable (the cache is written in place by ``decode_step`` and by the slot
splice), so a snapshot holds clones and a restore installs clones of those.

Not in this slice (the constructor raises ``NotImplementedError`` on a
non-default value, naming the ROADMAP item): the decode-state and storage
scrubs, ``multi_step > 1`` windows, and the ``tracer`` / ``event_log`` /
``metrics`` observers; ``strike`` and ``ThreadedSource`` come with them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.dependability import DependabilityStats
from repro_torch.models import api as model_api
from repro_torch.models.config import ArchConfig

_SCRUB_ITEM = ("decode-state and storage scrubs come with ROADMAP.md "
               "queue 1, item 9")
_WINDOW_ITEM = ("multi-step decode windows come with ROADMAP.md queue 1, "
                "item 9")
_OBS_ITEM = ("the tracer, event_log and metrics observers (repro_torch.obs) "
             "are wired in with the scrubs and strike, ROADMAP.md queue 1, "
             "item 9")


def _clone_cache(cache):
    return type(cache)(*(t.clone() for t in cache))


# ---------------------------------------------------------------------------
# Queue/stage primitives
# ---------------------------------------------------------------------------


class Channel:
    """Bounded single-producer/single-consumer queue between two stages:
    ``try_put``/``try_get`` never block and take no locks (the cooperative
    driver pumps every stage on one thread).  ``capacity=0`` means
    unbounded.  The blocking API of the reference comes with its threaded
    driver (``ThreadedSource``)."""

    _EMPTY = object()

    def __init__(self, capacity: int = 0, name: str = ""):
        self.capacity = int(capacity)
        self.name = name
        self.items: deque = deque()

    def full(self) -> bool:
        return self.capacity > 0 and len(self.items) >= self.capacity

    def try_put(self, item) -> bool:
        if self.full():
            return False
        self.items.append(item)
        return True

    def try_get(self):
        """Next item or ``Channel.EMPTY`` — non-blocking."""
        if not self.items:
            return self._EMPTY
        return self.items.popleft()

    @classmethod
    def is_empty_token(cls, item) -> bool:
        return item is cls._EMPTY

    def drain(self) -> list:
        out = list(self.items)
        self.items.clear()
        return out

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self):
        return iter(self.items)


class Stage:
    """One pipeline stage: ``pump()`` moves as much work as channel
    capacity allows and returns whether any progress was made."""

    name = "stage"

    def pump(self) -> bool:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Pipeline payloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    # filled by the pipeline
    output: Optional[List[int]] = None
    submitted_at: float = 0.0
    finished_at: float = 0.0
    # tick-clock stamps (the executor's pump counter; -1 = not stamped)
    submitted_tick: int = -1
    finished_tick: int = -1


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens_out: int = 0
    replays: int = 0
    faults_detected: int = 0

    def tokens_per_step(self) -> float:
        return self.tokens_out / max(self.steps, 1)


@dataclasses.dataclass
class _Prefilled:
    """A request that cleared the prefill stage: its single-request cache,
    first sampled token, and true (unpadded) prompt length."""
    req: Request
    cache: Any
    first_token: int
    prompt_len: int


# ---------------------------------------------------------------------------
# Stages of the serving pipeline
# ---------------------------------------------------------------------------


class AdmitStage(Stage):
    """Submission queue → prefill inbox, gated on slot reservations:
    reservable = free slots − requests already in flight through prefill.
    FIFO order is preserved.  ``drain_barrier=True`` admits a new group
    only once the decode batch has fully drained (static batching, the
    baseline continuous batching is priced against)."""

    name = "admit"

    def __init__(self, inbox: Channel, outbox: Channel,
                 prefill: "PrefillStage", decode: "DecodeStage",
                 drain_barrier: bool = False):
        self.inbox = inbox
        self.outbox = outbox
        self.prefill = prefill
        self.decode = decode
        self.drain_barrier = drain_barrier

    def reservable(self) -> int:
        if self.drain_barrier and self.decode.active:
            return 0
        in_prefill = len(self.outbox) + len(self.prefill.outbox)
        return self.decode.n_free() - in_prefill

    def pump(self) -> bool:
        moved = False
        while (self.inbox.items and self.reservable() > 0
               and not self.outbox.full()):
            self.outbox.try_put(self.inbox.items.popleft())
            moved = True
        return moved


class PrefillStage(Stage):
    """Per-request prefill: prompt → (single-request cache, first token).
    Prompts are right-padded to a multiple of ``prefill_pad``: the cache
    masks past each row's length, so padding is free."""

    name = "prefill"

    def __init__(self, ex: "StreamingExecutor", inbox: Channel,
                 outbox: Channel):
        self.ex = ex
        self.inbox = inbox
        self.outbox = outbox

    def _prefill_one(self, req: Request) -> _Prefilled:
        ex = self.ex
        # reserve cache rows for the token budget, but never truncate the
        # prompt to nothing; generation stops at the cache edge instead
        prompt = req.prompt[: max(1, ex.max_len - req.max_new_tokens)]
        pad = -(-len(prompt) // ex.prefill_pad) * ex.prefill_pad
        toks = torch.tensor([prompt + [0] * (pad - len(prompt))],
                            dtype=torch.int32, device=ex.device)
        logits, cache1 = ex._prefill(ex.params, toks)
        nxt = int(torch.argmax(logits[0, len(prompt) - 1]))
        return _Prefilled(req, cache1, nxt, len(prompt))

    def pump(self) -> bool:
        moved = False
        while not self.outbox.full():
            req = self.inbox.try_get()
            if Channel.is_empty_token(req):
                break
            self.outbox.try_put(self._prefill_one(req))
            moved = True
        return moved


class DecodeStage(Stage):
    """The continuous-batching core: owns the slotted decode batch.

    ``join()`` splices prefilled requests into free slot rows;
    ``decode_once()`` steps the whole batch (free slots included) and
    emits finished requests downstream."""

    name = "decode"

    def __init__(self, ex: "StreamingExecutor", inbox: Channel,
                 outbox: Channel):
        self.ex = ex
        self.inbox = inbox
        self.outbox = outbox
        self.reset_state()

    def reset_state(self):
        ex = self.ex
        self.cache = model_api.init_cache(ex.cfg, ex.capacity, ex.max_len,
                                          device=ex.device)
        self.tokens = torch.zeros((ex.capacity,), dtype=torch.int32,
                                  device=ex.device)
        self.slot_pos = np.zeros(ex.capacity, np.int32)
        self.slot_remaining = np.zeros(ex.capacity, np.int32)
        self.active: dict = {}                    # slot -> Request
        # finished requests the (bounded) outbox refused: re-offered every
        # pump — backpressure must never drop a request
        self._pending: deque = deque()

    def n_free(self) -> int:
        return self.ex.capacity - len(self.active)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.ex.capacity) if s not in self.active]

    def _emit(self, req: Request) -> None:
        req.finished_tick = self.ex.tick
        self._pending.append(req)
        self.flush_pending()

    def flush_pending(self) -> bool:
        moved = False
        while self._pending and self.outbox.try_put(self._pending[0]):
            self._pending.popleft()
            moved = True
        return moved

    def join(self) -> bool:
        """Splice prefilled requests into free slots.  Requests whose
        prompt already produced their only token (or EOS) finish here."""
        ex = self.ex
        moved = self.flush_pending()
        for slot in self.free_slots():
            item = self.inbox.try_get()
            if Channel.is_empty_token(item):
                break
            req, n = item.req, item.prompt_len
            ex._since_snapshot.append(req)
            self.cache = model_api.cache_write_slot(self.cache, item.cache,
                                                    slot, n)
            self.tokens[slot] = item.first_token
            self.slot_pos[slot] = n
            # the prefill itself produced the first new token
            self.slot_remaining[slot] = req.max_new_tokens - 1
            req.output = [item.first_token]
            self.active[slot] = req
            moved = True
            if self.slot_remaining[slot] <= 0 or item.first_token == ex.eos_id:
                req.finished_at = time.time()
                del self.active[slot]
                self._emit(req)
        return moved

    def decode_once(self) -> bool:
        """One decode step for every slot; finished requests are emitted
        to the certify stage.  One host readback of the tokens per step."""
        ex = self.ex
        if not self.active:
            return False
        nxt, self.cache = ex._decode(ex.params, self.tokens, self.cache)
        self.tokens = nxt
        ex.stats.steps += 1
        nxt_host = nxt.cpu().numpy()
        done_slots = []
        for slot, req in list(self.active.items()):
            req.output.append(int(nxt_host[slot]))
            self.slot_pos[slot] += 1
            self.slot_remaining[slot] -= 1
            ex.stats.tokens_out += 1
            if (self.slot_remaining[slot] <= 0
                    or int(nxt_host[slot]) == ex.eos_id
                    or self.slot_pos[slot] >= ex.max_len - 1):
                req.finished_at = time.time()
                done_slots.append(slot)
        for slot in done_slots:
            self._emit(self.active.pop(slot))
        return True

    def pump(self) -> bool:
        joined = self.join()
        return self.decode_once() or joined


class CertifyStage(Stage):
    """The release gate: ``hook(req) -> bool`` decides whether a finished
    request flows on to release (True) or is withheld (the hook's owner
    takes custody).  No hook means trivially certified."""

    name = "certify"

    def __init__(self, ex: "StreamingExecutor", inbox: Channel,
                 outbox: Channel):
        self.ex = ex
        self.inbox = inbox
        self.outbox = outbox
        # certified requests a full release channel refused, retried
        self._pending: deque = deque()

    def _forward(self, req: Request) -> None:
        if self._pending or not self.outbox.try_put(req):
            self._pending.append(req)

    def pump(self) -> bool:
        moved = False
        while self._pending and self.outbox.try_put(self._pending[0]):
            self._pending.popleft()
            moved = True
        while True:
            req = self.inbox.try_get()
            if Channel.is_empty_token(req):
                return moved
            moved = True
            hook = self.ex.certify
            if hook is None or hook(req):
                self._forward(req)


class ReleaseStage(Stage):
    """Terminal stage: certified requests accumulate here until the caller
    collects them (``StreamingExecutor.step`` drains once per pump)."""

    name = "release"

    def __init__(self, inbox: Channel):
        self.inbox = inbox

    def pump(self) -> bool:
        return False

    def collect(self) -> List[Request]:
        return self.inbox.drain()


# ---------------------------------------------------------------------------
# The executor: stages + cooperative driver + snapshot/rollback
# ---------------------------------------------------------------------------


class StreamingExecutor:
    """Staged streaming executor with a deterministic cooperative driver.

    One ``step()`` pumps every stage once in topological order.  Every
    ``snapshot_every`` steps the decode state and admission bookkeeping are
    snapshotted; ``restore_snapshot`` rolls back to it.  The device is
    that of ``params["embed"]``.
    """

    def __init__(self, cfg: ArchConfig, params, capacity: int = 8,
                 max_len: int = 512, prefill_pad: int = 64,
                 snapshot_every: int = 32, eos_id: int = -1,
                 compiled=None, state_scrub: str = "off",
                 storage_scrub: str = "off", storage_scrub_every: int = 1,
                 certify: Optional[Callable[[Request], bool]] = None,
                 drain_barrier: bool = False, multi_step: int = 1,
                 tracer=None, event_log=None, metrics=None):
        for name, mode in (("state_scrub", state_scrub),
                           ("storage_scrub", storage_scrub)):
            if mode not in ("off", "detect", "rollback"):
                raise ValueError(f"{name} must be off|detect|rollback, "
                                 f"got {mode!r}")
            if mode != "off":
                raise NotImplementedError(_SCRUB_ITEM)
        if multi_step != 1:
            raise NotImplementedError(_WINDOW_ITEM)
        if any(o is not None for o in (tracer, event_log, metrics)):
            raise NotImplementedError(_OBS_ITEM)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.capacity = capacity
        self.max_len = max_len
        self.prefill_pad = prefill_pad
        self.eos_id = eos_id
        self.snapshot_every = snapshot_every
        self.certify = certify
        self.multi_step = multi_step
        self.state_scrub = state_scrub
        self.storage_scrub = storage_scrub
        self.stats = EngineStats()
        self.tick = 0                   # pump-cycle clock

        if compiled is not None:
            self._decode, self._prefill = compiled
        else:
            def _step(p, t, c):
                logits, c = model_api.decode_step(cfg, p, t, c)
                return torch.argmax(logits, dim=-1).to(torch.int32), c

            self._decode = _step
            self._prefill = (lambda p, t:
                             model_api.prefill(cfg, p, t, max_len))

        self.submit_ch = Channel(0, "submit")
        self._admit_ch = Channel(capacity, "admitted")
        self._prefill_ch = Channel(capacity, "prefilled")
        self._certify_ch = Channel(0, "finished")
        self._release_ch = Channel(0, "certified")

        self.prefill = PrefillStage(self, self._admit_ch, self._prefill_ch)
        self.decode = DecodeStage(self, self._prefill_ch, self._certify_ch)
        self.admit = AdmitStage(self.submit_ch, self._admit_ch,
                                self.prefill, self.decode,
                                drain_barrier=drain_barrier)
        self.certifier = CertifyStage(self, self._certify_ch,
                                      self._release_ch)
        self.release = ReleaseStage(self._release_ch)
        self.stages: List[Stage] = [self.admit, self.prefill, self.decode,
                                    self.certifier, self.release]

        self._snapshot = None
        self._snapshot_step = 0
        self._since_snapshot: List[Request] = []   # admitted after snapshot
        self.dependability = DependabilityStats.zero(self.device)

    @property
    def compiled(self):
        """The (decode, prefill) pair, shareable with same-config
        executors via the ``compiled=`` constructor argument."""
        return (self._decode, self._prefill)

    def reset(self, params=None):
        """Return run state (channels, slots, cache, per-run stats) to
        fresh, optionally with new (same-shaped) params.  Lifetime
        dependability counters survive resets."""
        if params is not None:
            self.params = params
        for ch in (self.submit_ch, self._admit_ch, self._prefill_ch,
                   self._certify_ch, self._release_ch):
            ch.items.clear()
        self.decode.reset_state()
        self.certifier._pending.clear()
        self.stats = EngineStats()
        self._snapshot = None
        self._snapshot_step = 0
        self._since_snapshot = []

    def record_dependability(self, stats: dict):
        """Fold a DependabilityStats dict into the lifetime counters."""
        self.dependability = DependabilityStats.merge(self.dependability,
                                                      stats)

    # ------------------------------------------------------------- driving
    def submit(self, req: Request):
        req.submitted_at = time.time()
        req.submitted_tick = self.tick
        self.submit_ch.items.append(req)

    def cancel(self, uid: int) -> bool:
        """Evict a request from any stage it occupies, and from the
        snapshot bookkeeping so a later restore cannot resurrect it.
        Returns True if the request was found live in the pipeline."""
        self._since_snapshot = [r for r in self._since_snapshot
                                if r.uid != uid]
        if self._snapshot is not None:
            for slot, r in list(self._snapshot["active"].items()):
                if r.uid == uid:
                    del self._snapshot["active"][slot]
                    del self._snapshot["outputs"][slot]
        for ch in (self.submit_ch, self._admit_ch):
            for i, r in enumerate(ch.items):
                if r.uid == uid:
                    del ch.items[i]
                    return True
        for i, item in enumerate(self._prefill_ch.items):
            if item.req.uid == uid:
                del self._prefill_ch.items[i]
                return True
        for slot, r in list(self.decode.active.items()):
            if r.uid == uid:
                del self.decode.active[slot]
                self.decode.slot_remaining[slot] = 0
                return True
        for held in (self.decode._pending, self.certifier._pending):
            for r in list(held):
                if r.uid == uid:
                    held.remove(r)
                    return True
        for ch in (self._certify_ch, self._release_ch):
            for i, r in enumerate(ch.items):
                if r.uid == uid:
                    del ch.items[i]
                    return True
        return False

    def step(self) -> List[Request]:
        """One cooperative pump cycle: admit → prefill → decode-join →
        snapshot cadence → decode step → certify → release.  Returns the
        requests that cleared the release stage this cycle."""
        self.tick += 1
        self.admit.pump()
        self.prefill.pump()
        self.decode.join()
        if self.decode.active:
            if (self._snapshot is None
                    or self.stats.steps - self._snapshot_step
                    >= self.snapshot_every):
                self._take_snapshot()
            self.decode.decode_once()
        self.certifier.pump()
        self.release.pump()
        return self.release.collect()

    def busy(self) -> bool:
        """Work anywhere in the pipeline before the release stage?"""
        return bool(self.submit_ch.items or self._admit_ch.items
                    or self._prefill_ch.items or self.decode.active
                    or self.decode._pending or self.certifier._pending)

    def in_flight(self) -> List[Request]:
        """Every request the pipeline currently owns, in stage-then-slot
        order."""
        return (list(self.submit_ch) + list(self._admit_ch)
                + [item.req for item in self._prefill_ch]
                + [self.decode.active[s] for s in sorted(self.decode.active)]
                + list(self.decode._pending) + list(self.certifier._pending))

    def pending_count(self) -> int:
        """How many requests the pipeline owns — O(1)."""
        return (len(self.submit_ch) + len(self._admit_ch)
                + len(self._prefill_ch) + len(self.decode.active)
                + len(self.decode._pending) + len(self.certifier._pending))

    def run(self, max_steps: int = 10_000) -> EngineStats:
        """Drain the pipeline."""
        while self.busy() and self.stats.steps < max_steps:
            self.step()
        return self.stats

    # ----------------------------------------------------- fault tolerance
    def _take_snapshot(self):
        d = self.decode
        self._snapshot = {
            # clones: decode_step and the slot splice write in place
            "cache": _clone_cache(d.cache),
            "tokens": d.tokens.clone(),
            "slot_pos": d.slot_pos.copy(),
            "slot_remaining": d.slot_remaining.copy(),
            "active": dict(d.active),
            "outputs": {s: list(r.output) for s, r in d.active.items()},
            "steps": self.stats.steps,
            "tokens_out": self.stats.tokens_out,
        }
        self._snapshot_step = self.stats.steps
        self._since_snapshot = []

    def restore_snapshot(self) -> int:
        """Roll back to the last snapshot: cache, token buffer, per-slot
        bookkeeping, active set, request outputs and the step/token
        counters.  Requests that finished after the snapshot are re-decoded;
        requests admitted after it are requeued.  Returns the number of
        steps replayed."""
        if self._snapshot is None:
            raise RuntimeError("no snapshot taken yet")
        snap = self._snapshot
        d = self.decode
        # clones again: the restored state is written in place from here
        d.cache = _clone_cache(snap["cache"])
        d.tokens = snap["tokens"].clone()
        d.slot_pos = snap["slot_pos"].copy()
        d.slot_remaining = snap["slot_remaining"].copy()
        d.active = dict(snap["active"])
        # a request that finished after the snapshot may still be parked
        # behind a full channel; its resurrected copy re-decodes
        resurrected = {r.uid for r in d.active.values()}
        d._pending = deque(r for r in d._pending
                           if r.uid not in resurrected)
        for s, req in d.active.items():
            req.output = list(snap["outputs"][s])
            req.finished_at = 0.0
            req.finished_tick = -1
        for req in reversed(self._since_snapshot):
            req.output = None
            req.finished_at = 0.0
            req.finished_tick = -1
            self.submit_ch.items.appendleft(req)
        self._since_snapshot = []
        lost = self.stats.steps - snap["steps"]
        self.stats.steps = snap["steps"]
        self.stats.tokens_out = snap["tokens_out"]
        self.stats.replays += 1
        return lost
