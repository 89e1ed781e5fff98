"""Process-isolation transport for the serving fleet.

The counterpart of ``repro.fleet.transport``, with the same frames byte
for byte.  Where torch differs from JAX:

* numpy has no bfloat16, so a bf16 tensor travels as its 16-bit patterns
  under the header dtype name ``"bfloat16"`` (the reference's
  ``ml_dtypes`` name) and is read back with ``.view(torch.bfloat16)``;
  ``decode_frame`` gives CPU torch tensors;
* a fault key is a ``torch.Generator``: it crosses as its
  ``get_state()`` bytes (uint8) and the worker ``set_state``s a fresh CPU
  generator, so a fault drawn on the host strikes the same cells on either
  side;
* the worker's device (``"cuda:0"``, or ``"cpu"`` in the tests) travels
  in the ``init`` payload; the worker builds everything there and raises,
  as a ``WorkerError`` in the parent, where that device is missing;
* the config crosses as a JSON doc, its ``PolicyMap`` as the map's own doc.

The fleet's stages already communicate over bounded SPSC ``Channel``s
(runtime/dataflow.py); this module is the cut point that lets one of those
seams cross a *process* boundary: a ``Replica`` whose ``StreamingExecutor``
runs in a spawned worker process (``fleet/worker.py``), driven by the
parent fleet through the same ``submit``/``step``/``cancel``/``scrub``
surface the in-process replica exposes — ``Fleet``/``Supervisor``/``Router``
code is unchanged.

Wire protocol (length-prefixed, msgpack-free):

    MAGIC "RFT1" | u32 header_len | header JSON (utf-8) | raw array bytes…

The header carries ``{"seq", "op", "payload", "arrays": [{name, dtype,
shape, nbytes}, …]}``; array payloads (weight leaves, golden checksums,
generator states) ride as concatenated raw bytes after the header, in header
order — JSON for structure, numpy bytes for bulk, no third-party codec.
Each direction numbers its frames with a monotonically increasing ``seq``
and the receiver rejects any gap or reordering (``ProtocolError``), so a
torn or duplicated frame can never be silently absorbed.

Dead-peer detection is deadline-based: every parent-side RPC bounds its
wait (``WorkerHandle.call(deadline=…)``); a timeout, pipe EOF, or a worker
process that is no longer alive raises ``TransportDead``, which the fleet
maps onto the same drain → failover path a heartbeat loss takes.  Every
answered RPC doubles as a transport-level heartbeat — there is no separate
keepalive traffic to schedule.

``ProcReplica`` duck-types ``fleet.replica.Replica``: health state, the
uncertified list, and request custody live parent-side (the canonical
``Request`` objects the fleet's records reference), while the engine, its
weights, and the golden checksums live in the worker.  The certify gate
runs parent-side via an *upcall*: when the worker's certify stage holds a
finished request, it sends a ``certify`` frame and blocks for the verdict —
servicing nested RPCs (scrub, cancel, reload) while it waits, because the
fleet's gate may re-enter the very replica being certified (DMR
attribution scrubs both replicas of a pair).
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MAGIC = b"RFT1"
_HEADER_LEN = struct.Struct(">I")

# parent-side RPC deadlines (seconds).  ``init`` covers a cold torch import
# and the worker's checkpoint restore, the kernels already built by the
# parent: two SmolLM-135M workers were ready in 10.8 s on an NVIDIA H100
# 80GB HBM3 (700 W).
READY_DEADLINE = 120.0
CALL_DEADLINE = 120.0


class TransportError(Exception):
    """Base class for transport faults."""


class ProtocolError(TransportError):
    """Framing violation: bad magic, short frame, or a sequence gap."""


class TransportDead(TransportError):
    """The peer is gone (EOF / deadline exceeded / process exit)."""

    def __init__(self, msg: str, rid: int = -1):
        super().__init__(msg)
        self.rid = rid


class WorkerError(TransportError):
    """The worker executed the op and raised; carries its traceback."""


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def _wire_array(value) -> Tuple[np.ndarray, str]:
    """(host array, header dtype name) of a tensor or numpy array; bf16 as
    its 16-bit patterns named "bfloat16"."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        value = t.numpy()
    # asarray(order="C"), not ascontiguousarray: the latter silently
    # promotes 0-d arrays (scalar leaves) to shape (1,) on the wire
    arr = np.asarray(value, order="C")
    return arr, str(arr.dtype)


def _from_wire(buf: bytes, dtype: str, n: int, off: int,
               shape) -> torch.Tensor:
    """A CPU tensor of the frame bytes ``buf[off:off + n]``."""
    np_dtype = np.dtype(np.int16 if dtype == "bfloat16" else dtype)
    arr = np.frombuffer(buf, dtype=np_dtype,
                        count=n // max(np_dtype.itemsize, 1),
                        offset=off).reshape(shape)
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def encode_frame(seq: int, op: str, payload: Optional[dict] = None,
                 arrays: Optional[Dict[str, Any]] = None) -> bytes:
    """One wire frame: JSON header + concatenated raw array bytes
    (``arrays``: tensors on any device, or numpy arrays)."""
    arrays = arrays or {}
    metas, blobs = [], []
    for name, value in arrays.items():
        arr, dtype = _wire_array(value)
        metas.append({"name": name, "dtype": dtype,
                      "shape": list(arr.shape), "nbytes": int(arr.nbytes)})
        blobs.append(arr.tobytes())
    header = json.dumps({"seq": int(seq), "op": op,
                         "payload": payload or {}, "arrays": metas},
                        separators=(",", ":")).encode("utf-8")
    return b"".join([MAGIC, _HEADER_LEN.pack(len(header)), header] + blobs)


def decode_frame(buf: bytes
                 ) -> Tuple[int, str, dict, Dict[str, torch.Tensor]]:
    """Inverse of ``encode_frame``, the arrays as CPU tensors; raises
    ``ProtocolError`` on any damage."""
    if len(buf) < len(MAGIC) + _HEADER_LEN.size or buf[:len(MAGIC)] != MAGIC:
        raise ProtocolError(f"bad frame magic: {buf[:8]!r}")
    off = len(MAGIC)
    (hlen,) = _HEADER_LEN.unpack_from(buf, off)
    off += _HEADER_LEN.size
    if len(buf) < off + hlen:
        raise ProtocolError(f"truncated header: want {hlen} bytes, "
                            f"frame holds {len(buf) - off}")
    header = json.loads(buf[off:off + hlen].decode("utf-8"))
    off += hlen
    arrays: Dict[str, torch.Tensor] = {}
    for meta in header.get("arrays", []):
        n = int(meta["nbytes"])
        if len(buf) < off + n:
            raise ProtocolError(f"truncated array {meta['name']!r}")
        arrays[meta["name"]] = _from_wire(buf, meta["dtype"], n, off,
                                          meta["shape"])
        off += n
    if off != len(buf):
        raise ProtocolError(f"{len(buf) - off} trailing bytes after frame")
    return int(header["seq"]), str(header["op"]), header.get("payload", {}), \
        arrays


class PipeChannel:
    """The ``Channel`` API shimmed over one end of a multiprocessing pipe.

    Same surface as the in-process SPSC channel — ``put``/``try_put``,
    ``get``/``try_get``, ``close`` — with frames instead of object refs:
    an *item* is an ``(op, payload, arrays)`` triple.  Outgoing frames are
    seq-stamped; incoming frames must arrive with strictly consecutive
    seqs.  ``get`` takes a deadline (seconds) and raises ``TransportDead``
    when the peer misses it or the pipe hits EOF — the transport analogue
    of ``Channel``'s ``Closed`` wake-up.
    """

    _EMPTY = object()

    def __init__(self, conn, name: str = ""):
        self.conn = conn
        self.name = name
        self._send_seq = 0
        self._recv_seq = 0
        self._closed = False

    @classmethod
    def is_empty_token(cls, item) -> bool:
        return item is cls._EMPTY

    def put(self, item) -> None:
        op, payload, arrays = item
        if self._closed:
            raise TransportDead(f"{self.name}: channel closed", -1)
        self._send_seq += 1
        try:
            self.conn.send_bytes(encode_frame(self._send_seq, op, payload,
                                              arrays))
        except (BrokenPipeError, EOFError, OSError) as e:
            self._closed = True
            raise TransportDead(f"{self.name}: peer gone on send ({e})") \
                from e

    def try_put(self, item) -> bool:
        if self._closed:
            return False
        self.put(item)
        return True

    def _decode(self, buf: bytes):
        seq, op, payload, arrays = decode_frame(buf)
        self._recv_seq += 1
        if seq != self._recv_seq:
            raise ProtocolError(
                f"{self.name}: sequence gap (got {seq}, "
                f"want {self._recv_seq})")
        return op, payload, arrays

    def get(self, deadline: Optional[float] = None):
        """Next frame, blocking up to ``deadline`` seconds (None = forever).
        Raises ``TransportDead`` on timeout or EOF."""
        if self._closed:
            raise TransportDead(f"{self.name}: channel closed")
        try:
            if deadline is not None and not self.conn.poll(deadline):
                raise TransportDead(
                    f"{self.name}: peer missed {deadline:.0f}s deadline")
            return self._decode(self.conn.recv_bytes())
        except (BrokenPipeError, EOFError, OSError) as e:
            self._closed = True
            raise TransportDead(f"{self.name}: peer gone on recv ({e})") \
                from e

    def try_get(self):
        if self._closed or not self.conn.poll(0):
            return self._EMPTY
        return self.get(deadline=0.1)

    def close(self) -> None:
        self._closed = True
        try:
            self.conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Doc serialization for the structured payloads (config, requests, faults)
# ---------------------------------------------------------------------------


def cfg_to_doc(cfg) -> dict:
    """ArchConfig → JSON doc (nested MoE/recurrent configs flatten too; a
    policy map as its own doc)."""
    doc = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ("moe", "recurrent"):
        if doc[name] is not None:
            doc[name] = dataclasses.asdict(doc[name])
    if doc["policy_map"] is not None:
        doc["policy_map"] = doc["policy_map"].to_doc()
    return doc


def cfg_from_doc(doc: dict):
    from repro_torch.core.policy_map import as_policy_map
    from repro_torch.models.config import (ArchConfig, MoEConfig,
                                           RecurrentConfig)
    doc = dict(doc)
    doc["policy_map"] = as_policy_map(doc.get("policy_map"))
    if doc.get("moe"):
        doc["moe"] = MoEConfig(**doc["moe"])
    if doc.get("recurrent"):
        rec = dict(doc["recurrent"])
        rec["block_pattern"] = tuple(rec.get("block_pattern", ()))
        doc["recurrent"] = RecurrentConfig(**rec)
    return ArchConfig(**doc)


def fault_to_name(fault) -> str:
    """Serialize an injection callable by *name* so the worker can resolve
    the identical function: campaign fault models by registry name,
    ``core.fault_injection`` primitives by attribute name."""
    from repro_torch.campaign import faultload as fl
    for name, fm in fl.FAULT_MODELS.items():
        if fault is fm or fault is fm.apply:
            return "model:" + name
    n = getattr(fault, "__name__", "")
    from repro_torch.core import fault_injection as fi
    if n and getattr(fi, n, None) is fault:
        return "fi:" + n
    raise ValueError(
        f"cannot serialize fault {fault!r} for the proc transport; use a "
        f"registered campaign fault model or a core.fault_injection "
        f"primitive")


def fault_from_name(name: str):
    kind, _, n = name.partition(":")
    if kind == "model":
        from repro_torch.campaign import faultload as fl
        return fl.resolve_fault_model(n).apply
    from repro_torch.core import fault_injection as fi
    return getattr(fi, n)


def leaves_to_arrays(state) -> Dict[str, torch.Tensor]:
    """Flatten a pytree to {manifest-path: leaf} — the wire form of weight
    and checksum payloads (paths are ``train/checkpoint.path_str``, the
    same addressing scrub verdicts and ``restore_leaves`` speak)."""
    from repro_torch import tree
    from repro_torch.train import checkpoint as ckpt_mod
    return {ckpt_mod.path_str(path): leaf
            for path, leaf in tree.leaves_with_paths(state)}


# ---------------------------------------------------------------------------
# Parent-side worker handle
# ---------------------------------------------------------------------------


class WorkerHandle:
    """One spawned worker process + its framed control pipe.

    ``call`` is the single RPC surface: send one frame, then pump replies
    until the worker answers — handling ``certify`` upcalls (the worker's
    certify stage asking the parent's release gate for a verdict) and
    ``error`` frames (worker-side exceptions, re-raised as ``WorkerError``)
    along the way.  Any deadline miss, EOF, or dead process raises
    ``TransportDead``; after that the handle is permanently dead and every
    further call fails fast.
    """

    def __init__(self, rid: int, *, deadline: float = CALL_DEADLINE):
        self.rid = rid
        self.deadline = deadline
        self.proc = None
        self.ch: Optional[PipeChannel] = None
        self.dead = False

    def spawn(self) -> None:
        import multiprocessing as mp
        from repro_torch.fleet import worker as worker_mod
        ctx = mp.get_context("spawn")      # never fork a live CUDA context
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        # the worker's device travels in its init frame, not in the
        # environment
        self.proc = ctx.Process(
            target=worker_mod.worker_entry, args=(child_conn, self.rid),
            name=f"fleet-worker-{self.rid}", daemon=True)
        self.proc.start()
        child_conn.close()
        self.ch = PipeChannel(parent_conn, f"worker{self.rid}")
        self.dead = False

    def alive(self) -> bool:
        return (not self.dead and self.proc is not None
                and self.proc.is_alive())

    def _mark_dead(self, why: str) -> TransportDead:
        self.dead = True
        return TransportDead(f"worker {self.rid}: {why}", self.rid)

    def call(self, op: str, payload: Optional[dict] = None,
             arrays: Optional[Dict[str, Any]] = None, *,
             deadline: Optional[float] = None,
             on_upcall: Optional[Callable[[dict], dict]] = None
             ) -> Tuple[dict, Dict[str, torch.Tensor]]:
        if self.dead or self.ch is None:
            raise self._mark_dead("transport already dead")
        deadline = self.deadline if deadline is None else deadline
        try:
            self.ch.put((op, payload or {}, arrays or {}))
            while True:
                rop, rpayload, rarrays = self.ch.get(deadline)
                if rop == "certify":
                    if on_upcall is None:
                        raise ProtocolError(
                            f"worker {self.rid}: certify upcall outside a "
                            f"step call")
                    verdict = on_upcall(rpayload)
                    self.ch.put(("verdict", verdict, {}))
                    continue
                if rop == "error":
                    raise WorkerError(
                        f"worker {self.rid} failed op {op!r}:\n"
                        f"{rpayload.get('traceback', rpayload)}")
                return rpayload, rarrays
        except TransportDead as e:
            raise self._mark_dead(str(e)) from e

    def kill(self) -> None:
        """Hard-stop the worker (chaos hook / cleanup)."""
        self.dead = True
        if self.proc is not None and self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=5.0)
        if self.ch is not None:
            self.ch.close()

    def shutdown(self) -> None:
        """Graceful stop: ask, wait briefly, then kill."""
        if not self.dead and self.ch is not None and self.alive():
            try:
                self.call("shutdown", deadline=10.0)
            except TransportError:
                pass
        if self.proc is not None:
            self.proc.join(timeout=5.0)
        self.kill()


# ---------------------------------------------------------------------------
# ProcReplica: the Replica surface over a WorkerHandle
# ---------------------------------------------------------------------------


class _StatsView:
    """Parent-side mirror of the worker engine's EngineStats."""

    def __init__(self):
        self.steps = 0
        self.tokens_out = 0
        self.replays = 0
        self.faults_detected = 0


class _EngineProxy:
    """The slice of the ``Engine`` surface the fleet drives, forwarded over
    the transport.  Queue/occupancy reads are served from a cache refreshed
    by every RPC ack (the worker answers each op with a sync blob), so the
    router's load decisions see exactly the values an in-process fleet
    would at the same decision points — no extra round trips."""

    def __init__(self, owner: "ProcReplica"):
        self._o = owner

    # cached occupancy (refreshed from every ack's sync blob)
    @property
    def queue(self) -> bool:
        return self._o._queue

    @property
    def active(self) -> bool:
        return self._o._active

    @property
    def stats(self) -> _StatsView:
        return self._o._stats

    @property
    def state_scrub(self) -> str:
        return self._o._state_scrub

    @state_scrub.setter
    def state_scrub(self, mode: str) -> None:
        self._o._set_state_scrub(mode)

    def submit(self, req) -> None:
        self._o._submit(req)

    def cancel(self, uid: int) -> bool:
        return self._o._cancel(uid)

    def step(self) -> List:
        return self._o._step()

    def reset(self, params=None) -> None:
        self._o._engine_reset(params=params)

    def strike(self, site: str, fault, key) -> None:
        self._o._strike(site, fault, key)

    def drain_state_events(self) -> List[dict]:
        ev, self._o._state_events = self._o._state_events, []
        return ev


class ProcReplica:
    """A fleet replica whose engine lives in a worker process.

    Duck-types ``fleet.replica.Replica``: same attributes (``rid``,
    ``state``, ``paused``, ``routable``, ``uncertified``, ``recoveries``,
    scrub bookkeeping) and methods (``install_certifier``, ``load``,
    ``in_flight``, ``scrub``, ``reload``/``reload_leaves``/``patch_leaves``,
    ``reset``).  The canonical ``Request`` objects stay parent-side in a
    submission-ordered registry, so custody transfers (certify verdicts,
    drains after a worker dies, failover replays) operate on the same
    objects the fleet's records track — exactly like the in-process fleet.
    """

    def __init__(self, rid: int, cfg, *, ckpt_dir: str, step: int = 0,
                 device: str = "cuda",
                 capacity: int = 4, max_len: int = 128, prefill_pad: int = 8,
                 snapshot_every: int = 16, eos_id: int = -1,
                 backend: Optional[str] = None, state_scrub: str = "off",
                 deadline: float = CALL_DEADLINE,
                 ready_deadline: float = READY_DEADLINE):
        from repro_torch.fleet.replica import ReplicaState
        self._RS = ReplicaState
        self.rid = rid
        self.cfg = cfg
        # the worker's device: its engine, weights and restores live there,
        # and the parent restores the leaves it ships onto it too
        self.device = torch.device(device)
        self.state = ReplicaState.HEALTHY
        self.paused = False
        self.routable = True
        self.golden = None                 # lives worker-side
        self.uncertified: List[Any] = []
        self.recoveries = 0
        self.last_clean_scrub_tick = 0
        self.last_scrub_bad: List[str] = []
        self.engine = _EngineProxy(self)
        self._gate = None
        self._owned: Dict[int, Any] = {}   # uid -> canonical Request
        self._queue = False
        self._active = False
        self._pending = 0
        self._stats = _StatsView()
        self._state_events: List[dict] = []
        self._state_scrub = state_scrub
        self._ready_deadline = ready_deadline
        self._init_payload = {
            "cfg": cfg_to_doc(cfg), "ckpt_dir": str(ckpt_dir),
            "step": int(step), "device": str(device),
            # a CPU worker runs the parent's intra-op thread count
            "threads": torch.get_num_threads(),
            "capacity": int(capacity),
            "max_len": int(max_len), "prefill_pad": int(prefill_pad),
            "snapshot_every": int(snapshot_every), "eos_id": int(eos_id),
            "backend": backend, "state_scrub": state_scrub,
        }
        self.handle = WorkerHandle(rid, deadline=deadline)
        self.handle.spawn()
        self._init_sent = False
        self._start_init()

    # ------------------------------------------------------------ lifecycle
    def _start_init(self) -> None:
        """Send the init frame without waiting — callers spawn a fleet of
        workers first and then ``wait_ready`` on each, so cold torch imports
        and checkpoint restores overlap across workers."""
        self.handle.ch.put(("init", self._init_payload, {}))
        self._init_sent = True
        self._ready = False

    def wait_ready(self) -> None:
        if self._ready:
            return
        # the init reply is the first frame the worker sends; read it
        # directly rather than issuing a second op
        try:
            rop, rpayload, _ = self.handle.ch.get(self._ready_deadline)
        except TransportDead as e:
            self.handle.dead = True
            raise TransportDead(
                f"worker {self.rid} died during init: {e}", self.rid) from e
        if rop == "error":
            raise WorkerError(
                f"worker {self.rid} failed init:\n"
                f"{rpayload.get('traceback', rpayload)}")
        if rop != "ready":
            raise ProtocolError(f"worker {self.rid}: expected ready frame, "
                                f"got {rop!r}")
        self._sync(rpayload)
        self._ready = True

    def respawn(self, ckpt_dir: str, step: int) -> None:
        """Replace a dead worker with a fresh one restored from the named
        checkpoint step (the transport-loss recovery path)."""
        self.handle.kill()
        self._init_payload["ckpt_dir"] = str(ckpt_dir)
        self._init_payload["step"] = int(step)
        self._init_payload["state_scrub"] = self._state_scrub
        self.handle = WorkerHandle(self.rid, deadline=self.handle.deadline)
        self.handle.spawn()
        self._start_init()
        self.wait_ready()
        self._owned = {}
        self._queue = self._active = False
        self._pending = 0
        self._state_events = []

    def close(self) -> None:
        self.handle.shutdown()

    @property
    def alive(self) -> bool:
        return self.handle.alive()

    # ----------------------------------------------------- replica surface
    def install_certifier(self, gate) -> None:
        self._gate = gate

    @property
    def healthy(self) -> bool:
        return self.state is self._RS.HEALTHY and not self.paused

    def load(self) -> int:
        return self._pending

    def in_flight(self) -> List[Any]:
        """Canonical Request objects still inside the worker's pipeline, in
        the worker's deterministic stage order.  A dead transport falls
        back to the parent-side registry (submission order) — that is the
        drain list failover replays from, so it must survive the worker."""
        if not self.handle.alive() or self.handle.dead:
            return list(self._owned.values())
        payload, _ = self.handle.call("in_flight")
        self._sync(payload)
        out = []
        for doc in payload["reqs"]:
            req = self._owned.get(int(doc["uid"]))
            if req is None:
                from repro_torch.runtime.dataflow import Request
                req = Request.from_doc(doc)
            else:
                req.sync_from_doc(doc)
            out.append(req)
        return out

    def scrub(self) -> List[str]:
        payload, _ = self.handle.call("scrub")
        self._sync(payload)
        self.last_scrub_bad = list(payload["bad"])
        return self.last_scrub_bad

    def reload(self, params) -> None:
        self.handle.call("reload_leaves", {},
                         leaves_to_arrays(params))
        self._after_reset()

    def reload_leaves(self, leaves: Dict[str, Any]) -> None:
        self.handle.call("reload_leaves", {},
                         {str(k): v for k, v in leaves.items()})
        self._after_reset()

    def patch_leaves(self, leaves: Dict[str, Any], golden=None) -> None:
        """Live weight swap: patch leaves into the running worker engine
        without clearing its pipeline (the zero-drain deploy path); the new
        golden checksums ship alongside as one int64 per tensor."""
        arrays = {"leaf:" + str(k): v for k, v in leaves.items()}
        if golden is not None:
            arrays.update({"gold:" + k: v
                           for k, v in leaves_to_arrays(golden).items()})
        payload, _ = self.handle.call("patch_leaves", {}, arrays)
        self._sync(payload)

    def reset_from_ckpt(self, ckpt_dir: str, step: int) -> None:
        """Fresh-trial revival: worker restores the named checkpoint step
        (byte-identical to the parent's golden params — crc32-verified) and
        resets its run state.  A dead worker is respawned first."""
        if not self.handle.alive() or self.handle.dead:
            self.respawn(ckpt_dir, step)
        else:
            payload, _ = self.handle.call(
                "reset", {"ckpt_dir": str(ckpt_dir), "step": int(step)})
            self._sync(payload)
        self._after_reset()
        self.state = self._RS.HEALTHY
        self.paused = False
        self.routable = True
        self.last_clean_scrub_tick = 0
        self.last_scrub_bad = []

    def reset(self, params=None) -> None:
        """Replica.reset parity.  The proc replica restores its baseline
        from the checkpoint store rather than shipping ``params`` over the
        wire; callers that need a specific step use ``reset_from_ckpt``."""
        self.reset_from_ckpt(self._init_payload["ckpt_dir"],
                             self._init_payload["step"])

    # ----------------------------------------------------- engine forwards
    def _sync(self, payload: dict) -> None:
        s = payload.get("sync")
        if not s:
            return
        self._pending = int(s["pending"])
        self._queue = bool(s["queue"])
        self._active = bool(s["active"])
        self._stats.steps = int(s["steps"])
        self._stats.tokens_out = int(s["tokens_out"])
        self._stats.replays = int(s["replays"])
        self._stats.faults_detected = int(s["faults_detected"])

    def _after_reset(self) -> None:
        self._owned = {}
        self._queue = self._active = False
        self._pending = 0
        self._state_events = []

    def _submit(self, req) -> None:
        self._owned[req.uid] = req
        payload, _ = self.handle.call("submit", {"req": req.to_doc()})
        self._sync(payload)

    def _cancel(self, uid: int) -> bool:
        self._owned.pop(uid, None)
        if self.handle.dead or not self.handle.alive():
            return False
        payload, _ = self.handle.call("cancel", {"uid": int(uid)})
        self._sync(payload)
        return bool(payload["found"])

    def _on_certify(self, payload: dict) -> dict:
        doc = payload["req"]
        uid = int(doc["uid"])
        req = self._owned.pop(uid, None)
        if req is None:
            from repro_torch.runtime.dataflow import Request
            req = Request.from_doc(doc)
        else:
            req.sync_from_doc(doc)
        release = bool(self._gate(self, req)) if self._gate else True
        return {"uid": uid, "release": release}

    def _step(self) -> List:
        payload, _ = self.handle.call("step", on_upcall=self._on_certify)
        self._sync(payload)
        self._state_events.extend(payload.get("state_events", []))
        for uid in payload.get("released", []):
            self._owned.pop(int(uid), None)
        return []

    def _engine_reset(self, params=None) -> None:
        if params is not None:
            self.handle.call("reload_leaves", {}, leaves_to_arrays(params))
        else:
            payload, _ = self.handle.call("engine_reset")
            self._sync(payload)
        self._after_reset()

    def _strike(self, site: str, fault, key) -> None:
        payload, _ = self.handle.call(
            "strike", {"site": site, "fault": fault_to_name(fault)},
            {"key": key.get_state()})
        self._sync(payload)

    def _set_state_scrub(self, mode: str) -> None:
        self._state_scrub = mode
        payload, _ = self.handle.call("set_state_scrub", {"mode": mode})
        self._sync(payload)
