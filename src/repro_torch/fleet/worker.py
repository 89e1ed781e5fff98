"""Worker-process side of the fleet's process-isolation transport.

The counterpart of ``repro.fleet.worker``.  ``worker_entry`` is the spawn
target: it owns one real ``Replica`` (engine, weights, golden checksums) on
the device its ``init`` frame names, and serves the parent's framed RPCs
over a ``PipeChannel``.  The module top imports nothing heavy; the model
stack is imported inside the handlers, after the spawn.  A worker asked
for a device that is missing raises in ``init`` (the parent sees a
``WorkerError``); it never falls back to another device.

Certify-before-release crosses the boundary as an *upcall*: the worker
installs a certifier on its replica that sends the finished request to the
parent and blocks for the verdict frame.  While blocked it keeps serving
nested RPCs (``_serve_until``), because the parent's gate may re-enter this
worker — e.g. a DMR mismatch scrubs both replicas of the pair, including
the one whose certify stage is mid-upcall.
"""
from __future__ import annotations

import traceback
from typing import Any, Dict, Optional


def _sync_blob(replica) -> dict:
    """Occupancy + stats snapshot attached to every ack, so the parent's
    cached view matches the live engine at each fleet decision point."""
    eng = replica.engine
    return {
        "pending": int(eng.executor.pending_count()),
        "queue": bool(eng.queue),
        "active": bool(eng.active),
        "steps": int(eng.stats.steps),
        "tokens_out": int(eng.stats.tokens_out),
        "replays": int(eng.stats.replays),
        "faults_detected": int(eng.stats.faults_detected),
    }


class _Server:
    def __init__(self, ch, rid: int):
        self.ch = ch
        self.rid = rid
        self.replica = None
        self.device = None
        self._params_cache: Dict[int, Any] = {}   # ckpt step -> restored tree
        self._ckpt_dir: Optional[str] = None
        self.running = True

    # ------------------------------------------------------------ plumbing
    def _reply(self, op: str, payload: dict, arrays=None) -> None:
        self.ch.put((op, payload, arrays or {}))

    def _serve_until(self, want_op: str) -> dict:
        """Block for a ``want_op`` frame, dispatching any other ops that
        arrive first.  This re-entrancy is what lets the parent's certify
        gate issue nested RPCs against this same worker mid-upcall."""
        while True:
            op, payload, arrays = self.ch.get(None)
            if op == want_op:
                return payload
            self.dispatch(op, payload, arrays)

    def _restore(self, ckpt_dir: str, step: int):
        """crc32-verified checkpoint restore onto the worker's device,
        cached per step — the fleet resets replicas to the same step across
        every campaign trial, and the store round-trip guarantees
        byte-identity with the parent."""
        from repro_torch.train import checkpoint as ckpt_mod
        if step not in self._params_cache or ckpt_dir != self._ckpt_dir:
            if ckpt_dir != self._ckpt_dir:
                self._params_cache.clear()
                self._ckpt_dir = ckpt_dir
            _, params = ckpt_mod.restore(ckpt_dir, step, device=self.device)
            self._params_cache[step] = params
            # rolling deploys advance the step every time — keep the cache
            # bounded to the store's own retention window
            while len(self._params_cache) > 3:
                del self._params_cache[min(self._params_cache)]
        return self._params_cache[step]

    def _certify_upcall(self, req) -> bool:
        self._reply("certify", {"req": req.to_doc()})
        payload = self._serve_until("verdict")
        return bool(payload.get("release", True))

    # ------------------------------------------------------------ handlers
    def dispatch(self, op: str, payload: dict, arrays) -> None:
        try:
            handler = getattr(self, "op_" + op, None)
            if handler is None:
                raise ValueError(f"unknown op {op!r}")
            handler(payload, arrays)
        except Exception:
            self._reply("error", {"op": op,
                                  "traceback": traceback.format_exc()})

    def op_init(self, payload: dict, arrays) -> None:
        import torch
        from repro_torch import resolve_device
        from repro_torch.fleet.replica import Replica
        from repro_torch.fleet.transport import cfg_from_doc
        self.device = resolve_device(payload["device"])
        if self.device.type == "cpu" and payload.get("threads"):
            # the parent's intra-op thread count: the same CPU kernels
            torch.set_num_threads(int(payload["threads"]))
        cfg = cfg_from_doc(payload["cfg"])
        params = self._restore(payload["ckpt_dir"], int(payload["step"]))
        self.replica = Replica(
            self.rid, cfg, params,
            capacity=int(payload["capacity"]),
            max_len=int(payload["max_len"]),
            prefill_pad=int(payload["prefill_pad"]),
            snapshot_every=int(payload["snapshot_every"]),
            eos_id=int(payload["eos_id"]),
            backend=payload.get("backend"),
            state_scrub=payload.get("state_scrub", "off"))
        self.replica.install_certifier(
            lambda _replica, req: self._certify_upcall(req))
        self._reply("ready", {"rid": self.rid,
                              "sync": _sync_blob(self.replica)})

    def op_submit(self, payload: dict, arrays) -> None:
        from repro_torch.runtime.dataflow import Request
        self.replica.engine.submit(Request.from_doc(payload["req"]))
        self._reply("submit_ok", {"sync": _sync_blob(self.replica)})

    def op_cancel(self, payload: dict, arrays) -> None:
        found = self.replica.engine.cancel(int(payload["uid"]))
        self._reply("cancel_ok", {"found": bool(found),
                                  "sync": _sync_blob(self.replica)})

    def op_step(self, payload: dict, arrays) -> None:
        released = self.replica.engine.step()
        self._reply("step_done", {
            "released": [int(r.uid) for r in released],
            "state_events": self.replica.engine.drain_state_events(),
            "sync": _sync_blob(self.replica)})

    def op_in_flight(self, payload: dict, arrays) -> None:
        self._reply("in_flight_ok", {
            "reqs": [r.to_doc() for r in self.replica.in_flight()],
            "sync": _sync_blob(self.replica)})

    def op_scrub(self, payload: dict, arrays) -> None:
        bad = self.replica.scrub()
        self._reply("scrub_ok", {"bad": list(bad),
                                 "sync": _sync_blob(self.replica)})

    def op_reload_leaves(self, payload: dict, arrays) -> None:
        # the leaves move to the replica's device inside reload_leaves
        self.replica.reload_leaves(dict(arrays))
        self._reply("reload_ok", {"sync": _sync_blob(self.replica)})

    def op_patch_leaves(self, payload: dict, arrays) -> None:
        from repro_torch import tree
        from repro_torch.fleet.replica import as_leaf
        from repro_torch.train import checkpoint as ckpt_mod
        leaves = {name[len("leaf:"):]: a for name, a in arrays.items()
                  if name.startswith("leaf:")}
        gold = {name[len("gold:"):]: a for name, a in arrays.items()
                if name.startswith("gold:")}
        golden = None
        if gold:
            # the wire carries the golden checksums flattened; rebuild the
            # tree against the existing golden's structure (paths match —
            # checksum trees mirror the params tree)
            old = self.replica.golden
            golden = tree.unflatten(tree.structure(old), [
                as_leaf(gold[ckpt_mod.path_str(p)], leaf)
                if ckpt_mod.path_str(p) in gold else leaf
                for p, leaf in tree.leaves_with_paths(old)])
        self.replica.patch_leaves(leaves, golden=golden)
        self._reply("patch_ok", {"sync": _sync_blob(self.replica)})

    def op_reset(self, payload: dict, arrays) -> None:
        from repro_torch.core import abft
        params = self._restore(payload["ckpt_dir"], int(payload["step"]))
        self.replica.reset(params=params)
        # re-pin the scrub baseline to the restored step (mirrors the
        # parent-side Fleet.reset, which re-pins golden for inproc replicas)
        self.replica.golden = abft.storage_checksums(params)
        self._reply("reset_ok", {"sync": _sync_blob(self.replica)})

    def op_engine_reset(self, payload: dict, arrays) -> None:
        self.replica.engine.reset()
        self.replica.uncertified.clear()
        self._reply("reset_ok", {"sync": _sync_blob(self.replica)})

    def op_set_state_scrub(self, payload: dict, arrays) -> None:
        self.replica.engine.state_scrub = payload["mode"]
        self._reply("scrub_mode_ok", {"sync": _sync_blob(self.replica)})

    def op_strike(self, payload: dict, arrays) -> None:
        import torch
        from repro_torch.fleet.transport import fault_from_name
        fault = fault_from_name(payload["fault"])
        gen = torch.Generator()
        gen.set_state(arrays["key"])
        self.replica.engine.strike(payload["site"], fault, gen)
        self._reply("strike_ok", {"sync": _sync_blob(self.replica)})

    def op_ping(self, payload: dict, arrays) -> None:
        self._reply("pong", {"rid": self.rid})

    def op_shutdown(self, payload: dict, arrays) -> None:
        self._reply("bye", {})
        self.running = False


def worker_entry(conn, rid: int) -> None:
    """Spawn target: build the transport channel, then serve until the
    parent says shutdown or the pipe dies (parent exit → EOF → clean
    process exit; the fleet treats the reverse direction the same way)."""
    from repro_torch.fleet.transport import PipeChannel, TransportDead
    ch = PipeChannel(conn, f"worker{rid}:child")
    server = _Server(ch, rid)
    try:
        while server.running:
            try:
                op, payload, arrays = ch.get(None)
            except TransportDead:
                break
            server.dispatch(op, payload, arrays)
    finally:
        ch.close()
