"""Streaming dataflow executor — the Klepsydra-style staged serving pipeline.

The counterpart of ``repro.runtime.dataflow``:

    submit ─▶ [admit] ─▶ [prefill] ─▶ [decode] ─▶ [certify] ─▶ [release]

Every arrow is a bounded single-producer/single-consumer ``Channel``; the
decode stage does continuous batching (requests join free slots of the
fixed-capacity KV-cache batch and leave it mid-flight); the certify stage
is the release gate.  The cooperative driver (``StreamingExecutor.step``)
pumps the stages in topological order on the caller's thread, so token
streams are a pure function of submission order; the threaded driver
(``ThreadedSource``) runs a producer stage on a daemon thread over the
blocking ``Channel.put``/``get``.

Fault tolerance, as in the reference: every ``snapshot_every`` steps a
checksummed snapshot; the decode-state scrub (``state_scrub``: the storage
checksums of the cache and token buffer, compared before each pump) and
the weight-storage scrub (``storage_scrub``, against the checksums of the
parameters blessed at construction) in ``detect`` or ``rollback`` mode;
``strike(site, fault, key)`` routes an SEU to the stage that owns the site.
The ``tracer``, ``event_log`` and ``metrics`` observers (``repro_torch.obs``)
see what the reference's see, on the same tick clock, so their exports are
byte for byte the reference's.

Where torch differs from JAX:

* the decode state is mutable (``decode_step`` and the slot splice write
  the cache in place), so a snapshot holds clones and a restore installs
  clones of those;
* the golden parameters of the storage scrub are a clone too, and a
  rollback installs a clone of them: nothing written to the live
  parameters reaches the golden copy;
* a ``multi_step`` window is a Python loop of device steps (the reference
  jits a scan): ``remaining``, ``pos`` and the active mask stay on the
  device as ``torch.where`` masks, every slot steps every inner step, and
  the window's tokens and finish masks come back in one host readback;
* each scrub reads its verdict back in one host synchronisation.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import abft
from repro_torch.core import fault_injection as fi
from repro_torch.core.dependability import DependabilityStats
from repro_torch.models import api as model_api
from repro_torch.models.config import ArchConfig

STRIKE_SITES = ("kv_cache", "decode_state", "weights")
SCRUB_MODES = ("off", "detect", "rollback")


def check_scrub_mode(name: str, mode: str) -> str:
    if mode not in SCRUB_MODES:
        raise ValueError(f"{name} must be off|detect|rollback, got {mode!r}")
    return mode


def _clone(state):
    return tree.map(torch.clone, state)


def _state_checksums(state):
    """The storage-scrub identity over decode state (cache and tokens)."""
    return abft.storage_checksums(state)


def _checks_equal(a, b) -> bool:
    """Host verdict: does every leaf checksum match?"""
    return abft.all_verified(tree.map(lambda p, q: p == q, a, b))


# ---------------------------------------------------------------------------
# Queue/stage primitives
# ---------------------------------------------------------------------------


class Closed(Exception):
    """Raised by blocking Channel ops once the channel is closed."""


class Channel:
    """Bounded single-producer/single-consumer queue between two stages.

    Two APIs over one deque: cooperative ``try_put``/``try_get`` never
    block and take no locks (the cooperative driver pumps every stage on
    one thread); streaming ``put``/``get`` block on capacity/emptiness and
    wake on ``close()`` (the threaded driver).  ``capacity=0`` means
    unbounded."""

    _EMPTY = object()

    def __init__(self, capacity: int = 0, name: str = ""):
        self.capacity = int(capacity)
        self.name = name
        self.items: deque = deque()
        self._closed = False
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    # ---------------------------------------------------------- cooperative
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

    # ------------------------------------------------------------ streaming
    def put(self, item):
        with self._not_full:
            while self.full() and not self._closed:
                self._not_full.wait()
            if self._closed:
                raise Closed(self.name)
            self.items.append(item)
            self._not_empty.notify()

    def get(self):
        with self._not_empty:
            while not self.items and not self._closed:
                self._not_empty.wait()
            if not self.items:
                raise Closed(self.name)
            item = self.items.popleft()
            self._not_full.notify()
            return item

    def close(self):
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()


class Stage:
    """One pipeline stage: ``pump()`` moves as much work as channel
    capacity allows and returns whether any progress was made."""

    name = "stage"

    def pump(self) -> bool:
        raise NotImplementedError


class SourceStage(Stage):
    """Producer stage: pushes ``produce(i)`` for i = start, start+1, ...
    into its outbox."""

    name = "source"

    def __init__(self, produce: Callable[[int], Any], outbox: Channel,
                 start: int = 0):
        self.produce = produce
        self.outbox = outbox
        self._i = start
        self._pending = Channel._EMPTY   # produced but not yet enqueued

    def pump(self) -> bool:
        moved = False
        while True:
            if Channel.is_empty_token(self._pending):
                self._pending = self.produce(self._i)
                self._i += 1
            if not self.outbox.try_put(self._pending):
                return moved
            self._pending = Channel._EMPTY
            moved = True

    def pump_blocking(self):
        """Streaming-driver variant: block on outbox space (raises
        Closed)."""
        if Channel.is_empty_token(self._pending):
            self._pending = self.produce(self._i)
            self._i += 1
        self.outbox.put(self._pending)
        self._pending = Channel._EMPTY


class ThreadedSource:
    """Drive a ``SourceStage`` on a daemon thread; the consumer reads the
    stage's outbox, and ``close()`` unblocks the producer and joins the
    thread."""

    def __init__(self, stage: SourceStage):
        self.stage = stage
        self._thread = threading.Thread(
            target=self._run, name=f"stage-{stage.name}", daemon=True)

    def start(self) -> "ThreadedSource":
        self._thread.start()
        return self

    def _run(self):
        try:
            while True:
                self.stage.pump_blocking()
        except Closed:
            pass

    def close(self):
        self.stage.outbox.close()
        self._thread.join(timeout=5.0)


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
        tr = self.decode.ex.tracer
        while (self.inbox.items and self.reservable() > 0
               and not self.outbox.full()):
            req = self.inbox.items.popleft()
            self.outbox.try_put(req)
            if tr is not None:
                tr.close_span(req.uid, "admit")
                tr.open_span(req.uid, "prefill", prompt_len=len(req.prompt))
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
    emits finished requests downstream; ``decode_window()`` runs
    ``multi_step`` such steps with one host readback."""

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
        ex = self.ex
        req.finished_tick = ex.tick
        if ex.tracer is not None:
            ex.tracer.close_span(req.uid, "decode",
                                 tokens=len(req.output or ()))
            ex.tracer.open_span(req.uid, "certify")
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
            if ex.tracer is not None:
                ex.tracer.close_span(req.uid, "prefill")
                ex.tracer.open_span(req.uid, "decode", slot=slot,
                                    prompt_len=n)
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

    def decode_window(self) -> bool:
        """``multi_step`` decode steps of every slot, then one host
        readback of the per-step tokens and finish masks; the host
        bookkeeping replays the window from them.  Streams equal per-step
        decoding: slots are independent, every slot steps every inner step
        (as a finished, not yet re-filled slot does per step), and joins
        happen between windows."""
        ex = self.ex
        if not self.active:
            return False
        dev = self.tokens.device
        active_mask = np.zeros(ex.capacity, bool)
        active_mask[list(self.active)] = True
        remaining = torch.as_tensor(self.slot_remaining, device=dev)
        pos = torch.as_tensor(self.slot_pos, device=dev)
        active = torch.as_tensor(active_mask, device=dev)
        tokens, cache = self.tokens, self.cache
        nxt_steps, fin_steps = [], []
        for _ in range(ex.multi_step):
            nxt, cache = ex._decode(ex.params, tokens, cache)
            remaining = torch.where(active, remaining - 1, remaining)
            pos = torch.where(active, pos + 1, pos)
            finished = active & ((remaining <= 0) | (nxt == ex.eos_id)
                                 | (pos >= ex.max_len - 1))
            active = active & ~finished
            tokens = nxt
            nxt_steps.append(nxt)
            fin_steps.append(finished.to(torch.int32))
        self.tokens, self.cache = tokens, cache
        n = ex.multi_step
        host = torch.cat(nxt_steps + fin_steps).reshape(
            2 * n, ex.capacity).cpu().numpy()       # the window's one sync
        nxt_host, fin_host = host[:n], host[n:].astype(bool)
        for i in range(n):
            if not self.active:
                break                  # trailing idle steps are not counted
            ex.stats.steps += 1
            done_slots = []
            for slot, req in list(self.active.items()):
                req.output.append(int(nxt_host[i, slot]))
                self.slot_pos[slot] += 1
                self.slot_remaining[slot] -= 1
                ex.stats.tokens_out += 1
                if fin_host[i, slot]:
                    req.finished_at = time.time()
                    done_slots.append(slot)
            for slot in done_slots:
                self._emit(self.active.pop(slot))
        return True

    def decode_any(self) -> bool:
        """Per-step or windowed decode, per the executor's
        ``multi_step``."""
        if self.ex.multi_step > 1:
            return self.decode_window()
        return self.decode_once()

    def pump(self) -> bool:
        joined = self.join()
        return self.decode_any() or joined


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
        tr = self.ex.tracer
        while True:
            req = self.inbox.try_get()
            if Channel.is_empty_token(req):
                return moved
            moved = True
            hook = self.ex.certify
            if hook is None or hook(req):
                if tr is not None:
                    tr.close_span(req.uid, "certify", certified=True)
                self._forward(req)
            elif tr is not None:
                # withheld: the hook's owner takes custody; the span
                # closes with the verdict
                tr.close_span(req.uid, "certify", certified=False,
                              withheld=True)


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
    snapshotted (checksummed when the state scrub is on, so a struck
    snapshot is refused at restore); ``state_scrub`` and ``storage_scrub``
    guard the decode state and the parameters before each pump; ``strike``
    is the per-stage SEU injection surface.  The device is that of
    ``params["embed"]``.
    """

    def __init__(self, cfg: ArchConfig, params, capacity: int = 8,
                 max_len: int = 512, prefill_pad: int = 64,
                 snapshot_every: int = 32, eos_id: int = -1,
                 compiled=None, state_scrub: str = "off",
                 storage_scrub: str = "off", storage_scrub_every: int = 1,
                 certify: Optional[Callable[[Request], bool]] = None,
                 drain_barrier: bool = False, multi_step: int = 1,
                 tracer=None, event_log=None, metrics=None):
        check_scrub_mode("state_scrub", state_scrub)
        check_scrub_mode("storage_scrub", storage_scrub)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.capacity = capacity
        self.max_len = max_len
        self.prefill_pad = prefill_pad
        self.eos_id = eos_id
        self.snapshot_every = snapshot_every
        self.certify = certify
        if multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {multi_step}")
        self.multi_step = multi_step
        self.stats = EngineStats()

        # observers, all optional; tick is the pump-cycle clock spans and
        # events key on: it advances once per step() and never rolls back
        self.tick = 0
        self.tracer = tracer
        self.event_log = event_log
        self.metrics = metrics
        if metrics is not None:
            self._m_submitted = metrics.counter(
                "engine_requests_submitted_total", "requests submitted")
            self._m_released = metrics.counter(
                "engine_requests_released_total",
                "requests that cleared the release stage")
            self._m_tokens = metrics.counter(
                "engine_tokens_out_total", "decoded tokens")
            self._m_steps = metrics.counter(
                "engine_decode_steps_total", "decode steps executed")
            self._m_latency = metrics.histogram(
                "engine_release_latency_ticks",
                "submit-to-release latency in pump ticks",
                buckets=tuple(float(2 ** i) for i in range(14)))
            self._m_qdepth = metrics.gauge(
                "engine_queue_depth", "requests queued before decode")
            self._m_slots = metrics.gauge(
                "engine_active_slots", "occupied decode slots")
            self._mm_steps = 0          # last stats.steps folded in
            self._mm_tokens = 0

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

        # decode-state scrubbing: "off" | "detect" | "rollback"
        self.state_scrub = state_scrub
        self._expected_check = None        # checksums after last mutation
        self.state_events: List[dict] = []  # drained by campaigns

        # weight-storage scrubbing against the parameters blessed at
        # construction: "detect" alarms (every pump by default), "rollback"
        # restores the golden parameters (amortised cadence).  reset(params=)
        # keeps the baseline; refresh_storage_baseline() re-blesses.
        self.storage_scrub = storage_scrub
        self.storage_scrub_every = max(1, int(storage_scrub_every))
        self._storage_checks = None
        self._golden_params = None
        self._storage_alarmed = False
        if storage_scrub != "off":
            self.refresh_storage_baseline()

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
        if self.metrics is not None:
            self._mm_steps = 0
            self._mm_tokens = 0
        self._snapshot = None
        self._snapshot_step = 0
        self._since_snapshot = []
        self._expected_check = None
        self.state_events = []
        self._storage_alarmed = False

    # ------------------------------------------------------- dependability
    def _device_state(self) -> dict:
        """The device-resident decode state the scrub covers (the host-side
        slot bookkeeping is outside the SEU threat surface)."""
        return {"cache": self.decode.cache, "tokens": self.decode.tokens}

    def _refresh_state_check(self):
        """Re-checksum after a legitimate mutation: the fingerprint every
        later scrub compares against."""
        if self.state_scrub != "off":
            self._expected_check = _state_checksums(self._device_state())

    def scrub_decode_state(self) -> bool:
        """Verify the live decode state against the post-mutation
        checksums; True == clean (one host readback)."""
        if self._expected_check is None:
            return True
        fresh = _state_checksums(self._device_state())
        clean = _checks_equal(fresh, self._expected_check)
        # _scrub_and_recover emits the site-attributed detection event
        self.record_dependability({"faults_detected": 0 if clean else 1,
                                   "checks_run": 1}, emit_events=False)
        return clean

    def _scrub_and_recover(self):
        """The pre-decode scrub guard: detect, and under ``rollback``
        restore the last verified snapshot.  One event per detection."""
        if self.scrub_decode_state():
            return
        event = {"step": self.stats.steps, "recovered": False,
                 "seconds": 0.0, "steps_replayed": 0}
        if self.tracer is not None:
            self.tracer.instant("scrub_detection", site="decode_state")
        if self.event_log is not None:
            self.event_log.emit("detection", tick=self.tick,
                                site="decode_state",
                                detail={"check": "state_scrub"})
        if self.state_scrub == "rollback" and self._snapshot is not None:
            t0 = time.perf_counter()
            try:
                event["steps_replayed"] = self.restore_snapshot()
                event["recovered"] = True
                event["seconds"] = time.perf_counter() - t0
                self.record_dependability({"faults_recovered": 1})
                if self.tracer is not None:
                    self.tracer.instant(
                        "rollback", steps_replayed=event["steps_replayed"])
                if self.event_log is not None:
                    self.event_log.emit(
                        "rollback", tick=self.tick, site="decode_state",
                        seconds=event["seconds"],
                        detail={"steps_replayed": event["steps_replayed"]})
            except RuntimeError:
                # the snapshot itself failed verification: not recovered
                pass
        if not event["recovered"]:
            # accept the corrupted fingerprint so one strike raises one
            # alarm, not one per remaining step
            self._refresh_state_check()
        self.state_events.append(event)

    def refresh_storage_baseline(self):
        """Bless the current parameters as the golden storage state: their
        checksums, and a clone of them as the rollback target."""
        self._golden_params = _clone(self.params)
        self._storage_checks = abft.storage_checksums(self.params)
        self._storage_alarmed = False

    def scrub_storage(self) -> bool:
        """Verify the live parameters against the golden storage checksums;
        True == clean (one host readback)."""
        if self._storage_checks is None:
            return True
        clean = abft.all_verified(abft.verify_storage(self.params,
                                                      self._storage_checks))
        self.record_dependability({"faults_detected": 0 if clean else 1,
                                   "checks_run": 1}, emit_events=False)
        return clean

    def _storage_scrub_and_recover(self):
        """The in-serve storage scrub: detect a weight-memory SEU; under
        ``rollback`` install a clone of the golden parameters."""
        if self._storage_alarmed or self.scrub_storage():
            return
        event = {"step": self.stats.steps, "site": "weights",
                 "recovered": False, "seconds": 0.0, "steps_replayed": 0}
        if self.tracer is not None:
            self.tracer.instant("scrub_detection", site="weights")
        if self.event_log is not None:
            self.event_log.emit("detection", tick=self.tick, site="weights",
                                detail={"check": "storage_scrub"})
        if self.storage_scrub == "rollback":
            t0 = time.perf_counter()
            self.params = _clone(self._golden_params)
            event["recovered"] = True
            event["seconds"] = time.perf_counter() - t0
            self.record_dependability({"faults_recovered": 1})
            if self.tracer is not None:
                self.tracer.instant("rollback", site="weights")
            if self.event_log is not None:
                self.event_log.emit(
                    "rollback", tick=self.tick, site="weights",
                    seconds=event["seconds"],
                    detail={"action": "golden_restore"})
        else:
            # detect-only: the baseline stays golden, so latch; reset() and
            # refresh_storage_baseline() clear the latch
            self._storage_alarmed = True
        self.state_events.append(event)

    def drain_state_events(self) -> List[dict]:
        ev, self.state_events = self.state_events, []
        return ev

    def record_dependability(self, stats: dict, emit_events: bool = True):
        """Fold a DependabilityStats dict into the lifetime counters.  With
        an event log attached, a positive ``faults_detected`` also surfaces
        as a ``detection`` event (``emit_events=False`` for callers that
        emit their own)."""
        self.dependability = DependabilityStats.merge(self.dependability,
                                                      stats)
        if emit_events and self.event_log is not None \
                and isinstance(stats, dict):
            detected = int(stats.get("faults_detected", 0))
            if detected > 0:
                self.event_log.emit(
                    "detection", tick=self.tick,
                    detail={"check": "dependability", "count": detected})

    # ------------------------------------------------- per-stage injection
    def strike(self, site: str, fault, key, leaf: Optional[tuple] = None
               ) -> None:
        """Inject an SEU into the state the named stage owns: ``kv_cache``
        strikes the decode stage's cache, ``decode_state`` its token
        buffer, ``weights`` the parameter store.  ``fault(x, key) -> x'``
        takes ``key`` (a ``torch.Generator``, e.g. seeded by
        ``campaign.faultload.trial_seed``); the cache or parameter leaf is
        drawn from ``key`` weighted by size, or is the one at the path
        ``leaf`` (e.g. ``("k_s",)``)."""
        def into(state):
            if leaf is not None:
                return fi.inject_leaf_with(state, leaf, key, fault)
            return fi.inject_pytree_with(state, key, fault)

        if site == "kv_cache":
            self.decode.cache = into(self.decode.cache)
        elif site == "decode_state":
            self.decode.tokens = fault(self.decode.tokens, key)
        elif site == "weights":
            self.params = into(self.params)
        else:
            raise ValueError(
                f"no stage owns fault site {site!r} "
                f"(known: {', '.join(STRIKE_SITES)})")
        fault_name = getattr(fault, "name", getattr(fault, "__name__", ""))
        if self.tracer is not None:
            self.tracer.instant("strike", site=site, fault=fault_name)
        if self.event_log is not None:
            self.event_log.emit("strike", tick=self.tick, site=site,
                                fault=fault_name)

    # ------------------------------------------------------------- driving
    def submit(self, req: Request):
        req.submitted_at = time.time()
        req.submitted_tick = self.tick
        self.submit_ch.items.append(req)
        if self.tracer is not None:
            self.tracer.open_span(req.uid, "admit",
                                  prompt_len=len(req.prompt),
                                  max_new_tokens=req.max_new_tokens)
        if self.metrics is not None:
            self._m_submitted.inc()

    def cancel(self, uid: int) -> bool:
        """Evict a request from any stage it occupies, and from the
        snapshot bookkeeping so a later restore cannot resurrect it.
        Returns True if the request was found live in the pipeline."""
        if self.tracer is not None:
            for stage in ("admit", "prefill", "decode", "certify"):
                self.tracer.cancel_span(uid, stage)
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
        """One cooperative pump cycle: scrubs → admit → prefill →
        decode-join → snapshot cadence → decode step or window → certify →
        release.  Returns the requests that cleared the release stage this
        cycle."""
        self.tick += 1
        if self.tracer is not None:
            self.tracer.tick_to(self.tick)
        # scrub before this cycle consumes (or a join mutates) the decode
        # state: any change since the last legitimate mutation is an SEU
        if self.state_scrub != "off" and self.decode.active:
            self._scrub_and_recover()
        # storage scrub on its own cadence, before any stage reads weights
        if self.storage_scrub != "off" \
                and self.tick % self.storage_scrub_every == 0:
            self._storage_scrub_and_recover()
        self.admit.pump()
        self.prefill.pump()
        self.decode.join()
        if self.decode.active:
            # cadence by steps since the snapshot (a window advances steps
            # by up to multi_step per pump)
            if (self._snapshot is None
                    or self.stats.steps - self._snapshot_step
                    >= self.snapshot_every):
                self._take_snapshot()
            self.decode.decode_any()
        self._refresh_state_check()
        # certify/release after the decode state is settled: a certify
        # hook may re-enter the executor
        self.certifier.pump()
        self.release.pump()
        released = self.release.collect()
        if self.tracer is not None:
            for req in released:
                self.tracer.instant("release", stage="release", uid=req.uid,
                                    tokens=len(req.output or ()))
            self.tracer.counter(
                "queue_depth", submit=len(self.submit_ch),
                admitted=len(self._admit_ch),
                prefilled=len(self._prefill_ch),
                parked=len(self.decode._pending)
                + len(self.certifier._pending))
            self.tracer.counter("slots", active=len(self.decode.active),
                                capacity=self.capacity)
        if self.metrics is not None:
            self._m_released.inc(len(released))
            self._m_steps.inc(self.stats.steps - self._mm_steps)
            self._m_tokens.inc(self.stats.tokens_out - self._mm_tokens)
            self._mm_steps = self.stats.steps
            self._mm_tokens = self.stats.tokens_out
            self._m_qdepth.set(len(self.submit_ch) + len(self._admit_ch)
                               + len(self._prefill_ch))
            self._m_slots.set(len(self.decode.active))
            for req in released:
                if req.submitted_tick >= 0:
                    self._m_latency.observe(self.tick - req.submitted_tick)
        return released

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
        # clones: decode_step and the slot splice write in place
        state = _clone({"cache": d.cache, "tokens": d.tokens})
        self._snapshot = {
            "cache": state["cache"],
            "tokens": state["tokens"],
            "slot_pos": d.slot_pos.copy(),
            "slot_remaining": d.slot_remaining.copy(),
            "active": dict(d.active),
            "outputs": {s: list(r.output) for s, r in d.active.items()},
            "steps": self.stats.steps,
            "tokens_out": self.stats.tokens_out,
            # checksummed at capture, so a restore refuses a struck snapshot
            "check": (_state_checksums(state)
                      if self.state_scrub != "off" else None),
        }
        self._snapshot_step = self.stats.steps
        self._since_snapshot = []

    def restore_snapshot(self) -> int:
        """Roll back to the last snapshot: cache, token buffer, per-slot
        bookkeeping, active set, request outputs and the step/token
        counters.  Requests that finished after the snapshot are re-decoded;
        requests admitted after it are requeued.  A snapshot that fails its
        checksums is refused (``RuntimeError``).  Returns the number of
        steps replayed."""
        if self._snapshot is None:
            raise RuntimeError("no snapshot taken yet")
        snap = self._snapshot
        if snap["check"] is not None:
            fresh = _state_checksums(
                {"cache": snap["cache"], "tokens": snap["tokens"]})
            if not _checks_equal(fresh, snap["check"]):
                raise RuntimeError(
                    "snapshot failed checksum verification (an SEU struck "
                    "the snapshot itself): refusing to restore; escalate "
                    "to drain + failover")
        d = self.decode
        # clones again: the restored state is written in place from here
        d.cache = _clone(snap["cache"])
        d.tokens = snap["tokens"].clone()
        d.slot_pos = snap["slot_pos"].copy()
        d.slot_remaining = snap["slot_remaining"].copy()
        d.active = dict(snap["active"])
        # a request that finished after the snapshot may still be parked
        # behind a full channel; its resurrected copy re-decodes
        resurrected = {r.uid for r in d.active.values()}
        d._pending = deque(r for r in d._pending
                           if r.uid not in resurrected)
        tr = self.tracer
        for s, req in d.active.items():
            req.output = list(snap["outputs"][s])
            req.finished_at = 0.0
            req.finished_tick = -1
            if tr is not None:
                # back in decode: drop a stale certify span, reopen decode
                tr.cancel_span(req.uid, "certify")
                tr.open_span(req.uid, "decode", slot=s, replayed=True)
        for req in reversed(self._since_snapshot):
            req.output = None
            req.finished_at = 0.0
            req.finished_tick = -1
            self.submit_ch.items.appendleft(req)
            if tr is not None:
                for stage in ("prefill", "decode", "certify"):
                    tr.cancel_span(req.uid, stage)
                tr.open_span(req.uid, "admit", requeued=True)
        self._since_snapshot = []
        lost = self.stats.steps - snap["steps"]
        self.stats.steps = snap["steps"]
        self.stats.tokens_out = snap["tokens_out"]
        self.stats.replays += 1
        self._refresh_state_check()
        return lost
