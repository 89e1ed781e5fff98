"""Campaign trial execution: workload cases, policy wrapping, classification.

The counterpart of ``repro.campaign.runner``.  Each workload case exposes
one method —

    run_trials(policy, site, fault, seeds) -> (detected[n], mismatch[n])

where ``fault(x, gen) -> x'`` is a fault-model primitive and trial ``i``
draws its fault from ``torch.Generator().manual_seed(seeds[i])``.  The
*golden* reference for a configuration is the same code path run with an
identity fault, so classification measures exactly the injected fault's
effect, never incidental numeric differences between execution paths.

Faults are drawn on the host and applied on the case's device, so one seed
strikes the same cells on the CPU and on the card: on the integer
workloads ``run_trials`` gives equal arrays under every backend and device.

Injection-site semantics per policy:

  accumulator   fault the int32 matmul/conv accumulator via the ``inject=``
                hook (compute-path SEU — what ABFT's checksum covers); for
                flashattn, the kernel's emitted output
  weights       fault the stored quantized weights before execution
                (memory SEU — ABFT detects it only with a deploy-time
                checksum; recompute-recovery cannot fix it, CKPT's
                golden-checkpoint rollback can)
  activations   fault the layer input (upstream data SEU — outside any
                single layer's ABFT contract; TMR still corrects it when
                only one replica's copy is hit)

CKPT classifies through the same machinery: detection comes from the op's
own checksum verdicts, recovery is rollback — re-execution from golden
state — and every recovered trial lands ``detected_corrected``.

TMR is evaluated at the campaign level with explicit replica voting
(``redundancy.vote``/``agree``): replica 0 executes with the fault, replicas
1–2 clean, matching spatial TMR where a single event upsets one replica.
DMR is its detect-only half: replica 0 (faulted) vs one clean replica,
disagreement raises the alarm but replica 0's output ships unchanged —
manifested faults classify ``detected_uncorrected``.

The reference jits and vmaps a kernel case's trials into one program; the
port loops over them.  Its kernels are deterministic (two launches give the
same bits), so the golden output is computed once per ``run_trials`` call.
Every trial reads its detection flag back to the host (one sync).

The engine cases ``serving`` and ``serving_int8kv`` strike a live
``Engine`` (its weights, KV cache or token buffer) and compare whole token
streams; they log real event chains and host recovery times, as the
reference's do.  ``fleet`` strikes one replica of an in-process
``fleet.Fleet`` and ``fleet_mp`` one of a process-transport fleet mid
rolling deploy; both judge the fleet's released streams.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.campaign import engine as engine_mod
from repro_torch.campaign import faultload as fl
from repro_torch.campaign import stats as stats_mod
from repro_torch.campaign.report import (BitCoverageRow, ConfigResult,
                                         classify_counts)
from repro_torch.core import abft as abft_mod
from repro_torch.core import fault_injection as fi
from repro_torch.core import redundancy
from repro_torch.core.dependability import (
    Policy, dependable_attention, dependable_qconv2d, dependable_qmatmul)
from repro_torch.core.fault_injection import _as_bits
from repro_torch.obs import EventLog

_IDENTITY = lambda x, gen: x        # noqa: E731


def _timeline_columns(ev_log: EventLog) -> Tuple[dict, List[dict]]:
    """Reduce an event log to the report's timeline columns (and the raw
    reconstructed chains, for ``--events-out``).  Drains the log."""
    tls = ev_log.timelines()
    ev_log.clear()
    det = [t["detection_latency_ticks"] for t in tls if t["detected"]]
    rec = [t["recovery_latency_ticks"] for t in tls if t["recovered"]]
    cols = {
        "strikes_logged": len(tls),
        "detections_logged": len(det),
        "detection_ticks_mean": float(np.mean(det)) if det else 0.0,
        "detection_ticks_max": int(max(det)) if det else 0,
        "recovery_ticks_mean": float(np.mean(rec)) if rec else 0.0,
        "recovery_ticks_max": int(max(rec)) if rec else 0,
    }
    return cols, tls


def _bitwise_mismatch(a, b) -> torch.Tensor:
    """() bool — any leaf of ``a`` (a tensor or a list of them) differs
    bit-for-bit from ``b`` (bit-pattern compare: NaN-safe, dtype-uniform).
    Stays on the device."""
    out = None
    for la, lb in zip(tree.leaves(a), tree.leaves(b)):
        diff = torch.any(_as_bits(la)[0] != _as_bits(lb)[0])
        out = diff if out is None else out | diff
    return out


def _tmr_vote(faulty, clean) -> Tuple[torch.Tensor, torch.Tensor]:
    """(voted_output, detected) for replicas [faulty, clean, clean]."""
    detected = ~redundancy.agree([faulty, clean])
    voted = redundancy.vote([faulty, clean, clean])
    return voted, detected


def _dmr_check(faulty, clean) -> Tuple[torch.Tensor, torch.Tensor]:
    """(replica-0 output, detected) for replicas [faulty, clean] — DMR is
    detect-only, so the faulted replica's output ships unchanged."""
    return faulty, ~redundancy.agree([faulty, clean])


def _voted(policy: Policy, out, clean):
    """Campaign-level replicas around one faulted output: (out, detected)."""
    if policy == Policy.TMR:
        return _tmr_vote(out, clean)
    return _dmr_check(out, clean)


class _RecoveryLog:
    """Host-side recovery accounting of the engine cases: rollback counts
    and wall-clock latencies during run_trials, drained into the report's
    recovery columns by the campaign runner."""

    def __init__(self):
        self.count = 0
        self.seconds: List[float] = []

    def drain_raw(self) -> Tuple[int, List[float]]:
        """(count, wall seconds) since the last drain."""
        count, secs = self.count, self.seconds
        self.count, self.seconds = 0, []
        return count, secs

    def drain(self) -> dict:
        count, secs = self.drain_raw()
        return {"faults_recovered": count,
                "recovery_ms_mean": float(np.mean(secs) * 1e3) if secs
                else 0.0,
                "recovery_ms_max": float(np.max(secs) * 1e3) if secs
                else 0.0}


def _ints(gen, lo, hi, shape, dtype, dev):
    return torch.randint(lo, hi, shape, generator=gen).to(dtype).to(dev)


# ---------------------------------------------------------------------------
# Kernel-shaped cases
# ---------------------------------------------------------------------------


class _KernelCase:
    """Shared trial machinery for the op cases: subclasses build the
    quantized operands in __init__ (drawn from a CPU generator seeded with
    ``seed``, then moved to ``device``) and implement ``_op`` (the
    dependable op call); site dispatch, TMR voting, and the trial loop live
    here.

    ``backend`` selects the execution engine (core/backend.py) every trial
    runs on — the axis that lets one campaign certify the plain paths and
    the hand kernels side by side."""

    sites = ("accumulator", "weights", "activations")
    policies = (Policy.NONE, Policy.ABFT, Policy.DMR, Policy.TMR, Policy.CKPT)

    # the op cases run in-process; model cases fan out across a pool
    shardable = False

    def __init__(self, backend: str, device):
        self.backend = backend
        self.device = resolve_device(device)

    def _op(self, policy: Policy, x_q, w_q, inject, w_check):
        raise NotImplementedError

    def _one(self, policy: Policy, site: str, fault, gen):
        x_q, w_q, inject = self.x_q, self.w_q, None
        if site == "weights":
            w_q = fault(w_q, gen)
        elif site == "activations":
            x_q = fault(x_q, gen)
        else:
            inject = lambda acc: fault(acc, gen)        # noqa: E731

        if policy in (Policy.TMR, Policy.DMR) and site != "accumulator":
            # spatial redundancy: the SEU hit one replica's *operand copy*,
            # so the clean replicas and the vote live at the campaign level
            y, _ = self._op(Policy.NONE, x_q, w_q, inject, None)
            y_clean, _ = self._op(Policy.NONE, self.x_q, self.w_q, None, None)
            return _voted(policy, y, y_clean)

        # accumulator faults (and every NONE/ABFT/CKPT trial) drive the
        # dependable op itself — its stats are the detection verdict, so TMR
        # correction counts, ABFT checksum hits, and CKPT rollbacks surface
        # exactly as deployed code would report them
        y, st = self._op(policy, x_q, w_q, inject,
                         self.w_check if policy in (Policy.ABFT, Policy.CKPT)
                         else None)
        if policy == Policy.NONE:
            return y, False
        return y, st["faults_detected"] > 0

    def golden(self, policy: Policy, site: str):
        """The configuration's output under the identity fault."""
        return self._one(policy, site, _IDENTITY, None)[0]

    def trial(self, policy: Policy, site: str, fault, seed: int,
              golden) -> Tuple[bool, bool]:
        """(detected, mismatch) of one trial against ``golden``."""
        y, detected = self._one(policy, site, fault, fl.generator(seed))
        return bool(detected), bool(_bitwise_mismatch(y, golden))

    def run_trials(self, policy, site, fault, seeds):
        golden = self.golden(policy, site)
        out = [self.trial(policy, site, fault, s, golden) for s in seeds]
        return (np.asarray([d for d, _ in out], bool),
                np.asarray([m for _, m in out], bool))


class QMatmulCase(_KernelCase):
    """int8×int8→int32 matmul + requant (the paper's hot-path primitive)."""

    name = "qmatmul"

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 m: int = 32, k: int = 64, n: int = 48, *, device="cuda"):
        super().__init__(backend, device)
        g, dev = torch.Generator().manual_seed(seed), self.device
        self.x_q = _ints(g, -128, 128, (m, k), torch.int8, dev)
        self.w_q = _ints(g, -127, 128, (k, n), torch.int8, dev)
        self.bias = _ints(g, -500, 500, (n,), torch.int32, dev)
        self.x_zp = torch.tensor(3, dtype=torch.int32, device=dev)
        self.out_zp = torch.tensor(0, dtype=torch.int32, device=dev)
        self.scale = torch.full((n,), 1e-3, dtype=torch.float32, device=dev)
        # deploy-time checksum from the known-good weights (weight-SEU cover)
        self.w_check = abft_mod.checksum_vector(self.w_q)

    def _op(self, policy, x_q, w_q, inject, w_check):
        # the case's pristine operands ARE the golden checkpoint CKPT rolls
        # back to — healing weight-site SEUs the other in-op policies can
        # only detect
        ckpt = (self.x_q, self.w_q) if policy == Policy.CKPT else None
        return dependable_qmatmul(
            policy, x_q, self.x_zp, w_q, self.bias, self.scale, self.out_zp,
            inject=inject, w_check=w_check, ckpt=ckpt, backend=self.backend)


class QConv2dCase(_KernelCase):
    """int8 NHWC conv + requant (the HPDP's Table-1 op, reduced geometry)."""

    name = "qconv2d"

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 h: int = 12, w: int = 12, cin: int = 8, cout: int = 8,
                 kh: int = 3, kw: int = 3, *, device="cuda"):
        super().__init__(backend, device)
        g, dev = torch.Generator().manual_seed(seed), self.device
        self.x_q = _ints(g, -128, 128, (1, h, w, cin), torch.int8, dev)
        self.w_q = _ints(g, -127, 128, (kh, kw, cin, cout), torch.int8, dev)
        self.bias = _ints(g, -100, 100, (cout,), torch.int32, dev)
        self.x_zp = torch.tensor(2, dtype=torch.int32, device=dev)
        self.out_zp = torch.tensor(0, dtype=torch.int32, device=dev)
        self.scale = torch.full((cout,), 1e-3, dtype=torch.float32,
                                device=dev)
        self.w_check = abft_mod.conv_checksum_weight(self.w_q)

    def _op(self, policy, x_q, w_q, inject, w_check):
        ckpt = (self.x_q, self.w_q) if policy == Policy.CKPT else None
        return dependable_qconv2d(
            policy, x_q, self.x_zp, w_q, self.bias, self.scale, self.out_zp,
            inject=inject, w_check=w_check, ckpt=ckpt, backend=self.backend)


class FlashAttnCase(_KernelCase):
    """Float flash attention under the two-tier ABFT check — the one hot
    kernel the integer-checksum story cannot absorb
    (``dependable_attention``).

    Site mapping onto the kernel-case hooks: ``x_q`` is the query tensor
    (the ``activations`` site strikes an operand, covered at campaign level
    by the DMR/TMR replicas like every operand SEU); the ``accumulator``
    site strikes the kernel's *emitted output* — the float analog of the
    int32 accumulator hook — where the fused exact bit checksum certifies
    detection of every flip, including the low-mantissa ones a tolerance
    check must wave through."""

    name = "flashattn"
    sites = ("accumulator", "activations")

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 b: int = 1, h: int = 2, s: int = 24, hd: int = 16, *,
                 device="cuda"):
        super().__init__(backend, device)
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn((b, h, s, hd), generator=g).to(self.device)
                   for _ in range(3))
        self.x_q, self.k, self.v = q, k, v
        self.w_q = None          # attention has no weight operand
        self.w_check = None

    def _op(self, policy, x_q, w_q, inject, w_check):
        return dependable_attention(policy, x_q, self.k, self.v,
                                    inject=inject, backend=self.backend)


# ---------------------------------------------------------------------------
# Model cases: whole-network forwards, faults injected between them
# ---------------------------------------------------------------------------


class ShipdetCase:
    """The paper's ship-detection CNN (reduced geometry), full-network
    forward under a per-layer dependability policy.

    Deploy-time weight integrity (``shipdet.deploy_checks``) makes the
    ``weights`` site a *covered* site at model level: ABFT layers verify the
    live weights against the shipped checksums (detect), CKPT layers roll
    back to the shipped golden weights and re-execute (heal).  The backend
    is passed explicitly, as in the reference, so every layer runs
    ``dependable_qconv2d`` (never the fused requant kernel).
    """

    name = "shipdet"
    sites = ("accumulator", "weights", "activations")
    policies = (Policy.NONE, Policy.ABFT, Policy.DMR, Policy.TMR, Policy.CKPT)
    shardable = True          # host-side trial loop: chunks fan across a pool

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND, *,
                 device="cuda"):
        from repro_torch.models import shipdet
        self._shipdet = shipdet
        self.backend = backend
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.specs = shipdet.reduced_specs()
        self.params = shipdet.init_params(self.specs, gen, device=dev)
        s0 = self.specs[0]
        self.x = torch.rand((1, s0.h, s0.w, 3), generator=gen).to(dev)
        # deploy-time golden state: checksums for ABFT scrubs, weights for
        # CKPT rollback (computed once, from the known-good parameters)
        self.w_checks = shipdet.deploy_checks(self.params)
        self.golden_wq = shipdet.golden_weights(self.params)

    def _wq_leaves(self, params) -> List[torch.Tensor]:
        return [p["qconv"].w_q for p in params]

    def _with_wq(self, wq_leaves) -> list:
        return [{**p, "qconv": p["qconv"]._replace(w_q=wq)}
                for p, wq in zip(self.params, wq_leaves)]

    def run_trials(self, policy, site, fault, seeds):
        base = Policy.NONE if policy in (Policy.TMR, Policy.DMR) else policy
        deploy = base in (Policy.ABFT, Policy.CKPT)

        def fwd(params, x, inject=None):
            out, st = self._shipdet.forward(
                self.specs, params, x, policy=base,
                inject=inject, backend=self.backend,
                w_checks=self.w_checks if deploy else None,
                golden_wq=self.golden_wq if base == Policy.CKPT else None)
            return out, st["faults_detected"] > 0

        if site == "weights":
            def one(gen):
                wq = fi.inject_pytree_with(self._wq_leaves(self.params), gen,
                                           fault)
                return fwd(self._with_wq(wq), self.x)
            golden, _ = fwd(self.params, self.x)
        elif site == "activations":
            def one(gen):
                return fwd(self.params, fault(self.x, gen))
            golden, _ = fwd(self.params, self.x)
        else:   # accumulator — mid-layer int32 accumulator hook
            def one(gen):
                return fwd(self.params, self.x,
                           inject=lambda acc: fault(acc, gen))
            golden, _ = fwd(self.params, self.x, inject=lambda a: a)
        return _model_trials(policy, one, golden, seeds)


def _model_trials(policy, one, golden, seeds):
    """The model cases' trial loop: ``one(gen) -> (out, detected)`` per
    seed, campaign-level replicas for DMR/TMR against the clean output."""
    detected_l, mismatch_l = [], []
    for s in seeds:
        out, det = one(fl.generator(s))
        if policy in (Policy.TMR, Policy.DMR):
            out, det = _voted(policy, out, golden)
        detected_l.append(bool(det) if policy != Policy.NONE else False)
        mismatch_l.append(bool(_bitwise_mismatch(out, golden)))
    return np.asarray(detected_l, bool), np.asarray(mismatch_l, bool)


class TransformerCase:
    """Small transformer LM forward from the config registry (float path —
    no integer checksum exists, so the supported policies are
    NONE/DMR/TMR)."""

    name = "transformer"
    sites = ("weights", "activations")
    policies = (Policy.NONE, Policy.DMR, Policy.TMR)
    shardable = True

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 arch: str = "smollm-135m", *, device="cuda"):
        from repro_torch.configs import registry
        from repro_torch.models import api as model_api
        from repro_torch.models.config import reduced
        self._api = model_api
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = model_api.with_backend(reduced(registry.get(arch)),
                                          backend)
        self.params = model_api.init_params(self.cfg, gen, device=dev)
        self.tokens = torch.randint(0, self.cfg.vocab_size, (2, 16),
                                    generator=gen).to(dev)

    @torch.no_grad()
    def run_trials(self, policy, site, fault, seeds):
        api = self._api
        if site == "weights":
            def one(gen):
                params = fi.inject_pytree_with(self.params, gen, fault)
                return api.forward(self.cfg, params, self.tokens).logits, \
                    False
            golden = api.forward(self.cfg, self.params, self.tokens).logits
        else:   # activations — fault the token embeddings feeding the stack
            embeds = self.params["embed"][self.tokens.long()]

            def one(gen):
                return api.forward(self.cfg, self.params, self.tokens,
                                   embeds=fault(embeds, gen)).logits, False
            golden = api.forward(self.cfg, self.params, self.tokens,
                                 embeds=embeds).logits
        return _model_trials(policy, one, golden, seeds)


class ServingCase:
    """End-to-end serving drill: SEUs strike a live continuous-batching
    engine — its weight memory (``weights``) or its transient decode state
    (``kv_cache`` / ``decode_state``) — and classification compares whole
    generated token streams.

      NONE      undefended baseline
      ABFT      detect-only scrubbing: weights against deploy-time storage
                checksums after the run, transient sites by the engine's
                decode-state scrub in ``detect`` mode (the corrupted stream
                ships: detected_uncorrected)
      CKPT      the same detection plus recovery: snapshot rollback
                mid-run, or the golden parameters re-executed
                (detected_corrected, recovery latency measured)
      DMR/TMR   temporal redundancy judged on the replayed stream
                (weights site)

    Trial ``i`` draws its fault from ``faultload.generator(seed_i)``: the
    struck leaf (weighted by size), then the fault's own draws.
    """

    name = "serving"
    sites = ("weights", "kv_cache", "decode_state")
    policies = (Policy.NONE, Policy.ABFT, Policy.DMR, Policy.TMR,
                Policy.CKPT)
    quant_kv = False    # subclass hook: run on the int8 KV cache
    shardable = True          # host-side trial loop: chunks fan across a pool
    event_logged = True       # emits real EventLog chains (no synthesis)
    recovery_logged = True    # host recovery accounting in _RecoveryLog

    # the tick after which mid-run state strikes land; > 0 so prefill and
    # at least one decode step have populated real state
    STRIKE_STEP = 2

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 arch: str = "smollm-135m", *, device="cuda"):
        from repro_torch.configs import registry
        from repro_torch.models import api as model_api
        from repro_torch.models.config import reduced
        dev = resolve_device(device)
        cfg = reduced(registry.get(arch))
        if self.quant_kv:
            cfg = dataclasses.replace(cfg, quant_kv=True)
        # subclass hook: adjust the config before params and engine exist
        self.cfg = self._customize_cfg(cfg)
        self.backend = backend
        # dependability events on the engine's tick clock: the engine's
        # strikes, scrubs and rollbacks emit into it; weight-site
        # injections (host pytree surgery) are stamped by run_trials
        self.events = EventLog()
        self.prompts = [[5, 9, 2], [3, 1, 4, 1]]
        self._recovery = _RecoveryLog()
        self.use_params(model_api.init_params(
            self.cfg, torch.Generator().manual_seed(seed), device=dev))

    def _customize_cfg(self, cfg):
        return cfg

    def use_params(self, params) -> None:
        """Serve ``params``: a fresh engine over them and their deploy-time
        storage checksums (the scrub baseline of the weights site)."""
        from repro_torch.runtime.serving import Engine
        self.params = params
        self.engine = Engine(self.cfg, params, capacity=2, max_len=64,
                             prefill_pad=8, snapshot_every=2,
                             backend=self.backend, event_log=self.events)
        self.storage_checks = abft_mod.storage_checksums(params)

    @staticmethod
    def supports(policy: Policy, site: str) -> bool:
        # DMR/TMR are stream-replay drills over persistent faults; the
        # transient sites belong to the scrubbing policies and NONE
        if policy in (Policy.DMR, Policy.TMR):
            return site == "weights"
        return True

    def _run_engine(self, params, scrub_mode: str = "off",
                    state_site: str = None, fault=None, gen=None
                    ) -> Tuple[Tuple[int, ...], ...]:
        from repro_torch.runtime.serving import Request
        eng = self.engine
        eng.state_scrub = scrub_mode
        eng.reset(params=params)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
                for i, p in enumerate(self.prompts)]
        for r in reqs:
            eng.submit(r)
        steps = 0
        while (eng.queue or eng.active) and steps < 1000:
            eng.step()
            steps += 1
            if steps == self.STRIKE_STEP and state_site is not None:
                # the decode stage owns both transient sites
                eng.strike(state_site, fault, gen)
        return tuple(tuple(r.output) for r in reqs)

    def _weight_scrub_failed(self) -> bool:
        return not abft_mod.all_verified(abft_mod.verify_storage(
            self.engine.params, self.storage_checks))

    @torch.no_grad()
    def run_trials(self, policy, site, fault, seeds):
        scrub_mode = {Policy.ABFT: "detect", Policy.CKPT: "rollback"}.get(
            policy, "off")
        state_site = site if site in ("kv_cache", "decode_state") else None
        self.events.ctx.update(policy=policy.value)
        golden = self._run_engine(self.params)
        self.events.clear()               # the golden pass leaves no chains
        detected_l, mismatch_l = [], []
        for s in seeds:
            gen = fl.generator(s)
            params = self.params
            if state_site is None:
                params = fi.inject_pytree_with(self.params, gen, fault)
                # a weight-site injection is host pytree surgery, not an
                # Engine.strike: stamp its strike event here
                self.events.emit(
                    "strike", tick=self.engine.tick, site=site,
                    fault=getattr(fault, "__name__", ""))
            out = self._run_engine(params, scrub_mode=scrub_mode,
                                   state_site=state_site, fault=fault,
                                   gen=gen)
            events = self.engine.drain_state_events()
            detected = len(events) > 0
            self._recovery.count += sum(1 for e in events if e["recovered"])
            self._recovery.seconds += [e["seconds"] for e in events
                                       if e["recovered"]]
            if site == "weights" and policy in (Policy.ABFT, Policy.CKPT):
                # post-run storage scrub against deploy-time checksums
                bad = self._weight_scrub_failed()
                self.engine.record_dependability({
                    "faults_detected": 1 if bad else 0, "checks_run": 1})
                detected = detected or bad
                if bad and policy == Policy.CKPT:
                    # rollback: re-execute from the golden parameters
                    t0 = time.perf_counter()
                    out = self._run_engine(self.params)
                    seconds = time.perf_counter() - t0
                    self._recovery.seconds.append(seconds)
                    self._recovery.count += 1
                    self.engine.record_dependability(
                        {"faults_recovered": 1})
                    self.events.emit(
                        "recovery", tick=self.engine.tick, site="weights",
                        seconds=seconds,
                        detail={"action": "golden_reexecute"})
            differs = out != golden
            if policy == Policy.TMR:
                # clean replicas replay deterministically: the per-token
                # majority of (faulty, clean, clean) is the clean stream,
                # and disagreement is the detection signal
                detected_l.append(differs)
                mismatch_l.append(False)
                if differs:
                    self.engine.record_dependability({
                        "faults_detected": 1, "checks_run": 1})
            elif policy == Policy.DMR:
                # detect-only: the faulted stream is what shipped
                detected_l.append(differs)
                mismatch_l.append(differs)
                if differs:
                    self.engine.record_dependability({
                        "faults_detected": 1, "checks_run": 1})
            elif policy == Policy.NONE:
                detected_l.append(False)
                mismatch_l.append(differs)
            else:                                   # ABFT / CKPT
                detected_l.append(bool(detected))
                mismatch_l.append(differs)
        return np.asarray(detected_l, bool), np.asarray(mismatch_l, bool)

    def drain_recovery_stats(self) -> dict:
        return self._recovery.drain()


class ServingInt8KVCase(ServingCase):
    """ServingCase on the int8 KV cache (``ArchConfig.quant_kv``): the
    ``kv_cache`` site strikes a mixed pytree (int8 rows and f32 per-row
    scales); the dtype-uniform state scrub covers both."""

    name = "serving_int8kv"
    quant_kv = True


class FleetCase:
    """Fleet-level end-to-end drill: an SEU strikes ONE replica of a live
    multi-replica serving fleet (``repro_torch/fleet/``) and the campaign
    judges the *released output stream*.

    Sites:
      weights       persistent storage SEU in replica 0's parameters.  The
                    scrub-gated policies (ABFT, CKPT) verify against
                    deploy-time storage checksums, quarantine, restore the
                    corrupted leaves from the golden checkpoint, re-verify,
                    readmit, and replay recalled requests — trials end
                    ``detected_corrected`` with a measured recovery time.
      kv_cache      transient SEU in replica 0's live KV cache mid-flight.
      decode_state  transient SEU in replica 0's sampled-token buffer
                    mid-flight.  A CKPT fleet rolls the engine back to its
                    verified snapshot in place, an ABFT fleet detects and
                    drains + fails over, and DMR pair-serving detects by
                    stream divergence.

    Under NONE the fleet releases whatever the corrupted replica produced.
    One fleet is reused across all trials; ``Fleet.reset`` restores golden
    params and a fully-healthy fleet.  Trial ``i`` draws its fault from
    ``faultload.generator(seed_i)``.
    """

    name = "fleet"
    sites = ("weights", "kv_cache", "decode_state")
    policies = (Policy.NONE, Policy.ABFT, Policy.DMR, Policy.CKPT)
    shardable = True
    event_logged = True
    recovery_logged = True
    transport = "inproc"
    max_new_tokens = 4

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 arch: str = "smollm-135m", *, device="cuda"):
        from repro_torch.configs import registry
        from repro_torch.models import api as model_api
        from repro_torch.models.config import reduced
        from repro_torch.runtime.serving import Request
        self._Request = Request
        self.backend = backend
        self.cfg = self._customize_cfg(reduced(registry.get(arch)))
        self.prompts = [[5, 9, 2], [3, 1, 4, 1], [2, 7]]
        self._recovery = _RecoveryLog()
        # accumulates the fleet's per-trial dependability events (fleet-tick
        # clock) across a configuration's trials, drained by the runner into
        # the report's timeline columns
        self.events = EventLog()
        self.fleet = None
        self.use_params(model_api.init_params(
            self.cfg, torch.Generator().manual_seed(seed),
            device=resolve_device(device)))

    def _customize_cfg(self, cfg):
        return cfg

    def use_params(self, params) -> None:
        """Serve ``params``: a fresh fleet over them (on their device)."""
        from repro_torch.fleet.fleet import Fleet
        if self.fleet is not None:
            self.fleet.close()
        self.params = params
        self.fleet = Fleet(self.cfg, params, n_replicas=2,
                           policy=Policy.NONE, capacity=2, max_len=64,
                           prefill_pad=8, scrub_every=3, snapshot_every=2,
                           backend=self.backend, transport=self.transport)

    @staticmethod
    def supports(policy: Policy, site: str) -> bool:
        # DMR pair-serving judges output streams, so a cache strike that
        # never manifests in tokens is invisible to it — the pair agrees
        # and the (clean) stream releases.  That is masked, not SDC, so
        # every policy covers every site.
        return True

    def _submit(self, policy: Policy):
        fleet = self.fleet
        fleet.reset(policy=policy)
        reqs = [self._Request(uid=i, prompt=list(p),
                              max_new_tokens=self.max_new_tokens)
                for i, p in enumerate(self.prompts)]
        for r in reqs:
            fleet.submit(r)
        return reqs

    def _serve(self, policy: Policy, site: str, fault, gen):
        fleet = self.fleet
        reqs = self._submit(policy)
        if site == "weights":
            # strike the parameter store before serving (deploy-window SEU)
            fleet.strike(0, "weights", fault, gen)
        else:   # transient sites: strike the live decode stage two ticks in
            fleet.tick()
            fleet.tick()
            fleet.strike(0, site, fault, gen)
        fleet.run()
        return self._collect(reqs)

    def _collect(self, reqs):
        """Reduce a finished trial to (released streams, detected flag) and
        fold recovery/timeline accounting into the case's logs."""
        fleet = self.fleet
        outs = tuple(
            tuple(fleet.released[r.uid].output) if r.uid in fleet.released
            else None
            for r in reqs)
        m = fleet.metrics
        self._recovery.count += m.recoveries + m.state_rollbacks \
            + m.state_drains
        rec_hist = m.recovery_seconds
        if rec_hist.count:
            # histogram, not a list: reconstruct count entries preserving the
            # exact sum and max — all the report's recovery columns need
            n, total, peak = rec_hist.count, rec_hist.sum, float(rec_hist.max)
            if n == 1:
                self._recovery.seconds.append(total)
            else:
                self._recovery.seconds += [(total - peak) / (n - 1)] * (n - 1)
                self._recovery.seconds.append(peak)
        self.events.events.extend(fleet.event_log.drain())
        return outs, m.detections > 0

    def run_trials(self, policy, site, fault, seeds):
        golden, _ = self._serve(policy, site, _IDENTITY,
                                fl.generator(seeds[0]))
        # the golden pass must not contribute recovery or timeline accounting
        self._recovery.drain()
        self.events.clear()
        detected_l, mismatch_l = [], []
        for s in seeds:
            out, det = self._serve(policy, site, fault, fl.generator(s))
            detected_l.append(bool(det))
            mismatch_l.append(out != golden)
        return np.asarray(detected_l, bool), np.asarray(mismatch_l, bool)

    def drain_recovery_stats(self) -> dict:
        return self._recovery.drain()


class FleetMPCase(FleetCase):
    """The rolling-deploy scenario on the process transport: a 2-replica
    fleet whose engines live in spawned worker processes performs a
    zero-drain rolling weight deploy *while serving*, and the SEU strikes
    **during the in-flight swap** — ``mid_swap`` fires while replica 1 is
    out of the router being patched, and the strike lands on replica 0,
    already swapped and carrying the fleet alone at that instant.  Under
    ABFT/CKPT the certify-before-release scrub (against the *new* storage
    checksums) catches the corruption before any token ships; under NONE
    the corrupted stream releases.

    ``shardable = False``: each trial drives real worker processes, so the
    case owns them.  One fleet (and its two workers) is reused across all
    trials via ``Fleet.reset``.
    """

    name = "fleet_mp"
    sites = ("weights",)
    policies = (Policy.NONE, Policy.ABFT, Policy.CKPT)
    shardable = False
    transport = "proc"
    max_new_tokens = 6

    def _serve(self, policy: Policy, site: str, fault, gen):
        fleet = self.fleet
        reqs = self._submit(policy)
        fleet.tick()
        fleet.tick()
        strike = fault is not _IDENTITY

        def mid_swap(rid):
            # replica 1 is mid-swap (out of the router, weights half new):
            # strike the already-swapped replica 0 — the only one serving
            if strike and rid == 1:
                fleet.strike(0, "weights", fault, gen)

        fleet.deploy(params=self.params, mid_swap=mid_swap)
        fleet.run()
        return self._collect(reqs)

    def close(self):
        if self.fleet is not None:
            self.fleet.close()

    def __del__(self):
        try:
            self.close()
        except Exception:       # noqa: BLE001 — interpreter teardown
            pass


# ---------------------------------------------------------------------------
# Campaign driver
# ---------------------------------------------------------------------------

CASES: Dict[str, type] = {
    "qmatmul": QMatmulCase,
    "qconv2d": QConv2dCase,
    "flashattn": FlashAttnCase,
    "shipdet": ShipdetCase,
    "transformer": TransformerCase,
    "serving": ServingCase,
    "serving_int8kv": ServingInt8KVCase,
    "fleet": FleetCase,
    "fleet_mp": FleetMPCase,
}

SUPPORTED = {name: (cls.sites, cls.policies) for name, cls in CASES.items()}


def check_workload(workload: str) -> None:
    """Raise ``KeyError`` for a workload the port does not know."""
    if workload not in CASES:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(CASES)}")


def build_case(workload: str, seed: int = 0,
               backend: str = fl.DEFAULT_BACKEND, device="cuda"):
    check_workload(workload)
    return CASES[workload](seed, backend, device=device)


def _spec_supported(spec: fl.CampaignSpec, cls: type) -> bool:
    """Class-level support check — no case instance needed, so sharded
    campaigns can filter the grid without paying a parent-side build."""
    supported = spec.site in cls.sites and spec.policy in cls.policies
    if supported and hasattr(cls, "supports"):
        supported = cls.supports(spec.policy, spec.site)
    return supported


def _finalize_config(spec: fl.CampaignSpec, cls: type,
                     acc: "engine_mod.ConfigAccumulator",
                     plan: stats_mod.SamplingPlan,
                     event_sink: List[dict] | None) -> ConfigResult:
    """Reduce an accumulator (however its chunks were executed) to a report
    row: classification, recovery columns, timeline columns, CI columns."""
    detected = np.asarray(acc.detected, bool)
    mismatch = np.asarray(acc.mismatch, bool)
    counts = classify_counts(detected, mismatch)
    n = acc.n
    if getattr(cls, "recovery_logged", False):
        secs = acc.recovery_seconds
        recovery = {
            "faults_recovered": acc.recovery_count,
            "recovery_ms_mean": float(np.mean(secs) * 1e3) if secs else 0.0,
            "recovery_ms_max": float(np.max(secs) * 1e3) if secs else 0.0}
    elif spec.policy == Policy.CKPT:
        # in-op rollback: every corrected CKPT trial was a rollback
        # re-execution; its latency is part of the op, not the host
        recovery = {"faults_recovered": counts["detected_corrected"]}
    else:
        recovery = {}
    if getattr(cls, "event_logged", False):
        # real chains, merged from the chunk outcomes in trial order
        elog = EventLog()
        elog.events.extend(acc.events)
        tl_cols, tls = _timeline_columns(elog)
    else:
        # the op cases emit no host events: synthesize the chains from the
        # trial verdicts, as the reference does for its in-graph cases —
        # strike at trial index i, same-tick detection (the in-op check
        # verdict lands within the op call itself)
        synth = EventLog(policy=spec.policy.value, site=spec.site,
                         fault=spec.fault_model)
        for i, (det, mis) in enumerate(zip(detected, mismatch)):
            synth.emit("strike", tick=i)
            if det:
                synth.emit("detection", tick=i, detail={"check": "in_op"})
                if spec.policy == Policy.CKPT and not mis:
                    synth.emit("recovery", tick=i,
                               detail={"action": "in_op_rollback"})
        tl_cols, tls = _timeline_columns(synth)
    if event_sink is not None:
        event_sink.append({"config": spec.label(), "timelines": tls})
    sdc_lo, sdc_hi = plan.sdc_interval(counts["sdc"], n)
    det_lo, det_hi = stats_mod.binomial_interval(
        counts["detected_corrected"] + counts["detected_uncorrected"], n,
        plan.confidence, plan.ci_method)
    return ConfigResult(
        workload=spec.workload, policy=spec.policy.value, site=spec.site,
        fault_model=spec.fault_model, trials=n, backend=spec.backend,
        max_trials=spec.trials, early_stopped=acc.early_stopped,
        ci_method=plan.ci_method, ci_confidence=plan.confidence,
        sdc_ci_lo=sdc_lo, sdc_ci_hi=sdc_hi,
        detection_ci_lo=det_lo, detection_ci_hi=det_hi,
        **counts, **recovery, **tl_cols)


def run_campaign(specs: Sequence[fl.CampaignSpec],
                 log: Callable[[str], None] = lambda s: None,
                 cache: Dict[tuple, object] | None = None,
                 event_sink: List[dict] | None = None,
                 plan: stats_mod.SamplingPlan | None = None,
                 journal: "engine_mod.CampaignJournal | None" = None,
                 pool: "engine_mod.CampaignPool | None" = None,
                 run_stats: dict | None = None,
                 device="cuda",
                 _abort_after_chunks: int | None = None,
                 ) -> List[ConfigResult]:
    """Execute every configuration; returns one ConfigResult per spec.

    Deterministic: results depend only on (specs, their seeds, the plan's
    stopping rule) — never on how trials were scheduled.  Chunked, sharded
    (``plan.workers``), and resumed (``journal``) executions all merge the
    same seed slices in the same order, so their counts, CI columns, and
    timeline columns are bit-identical to a serial run.

    Every case is built on ``device`` (the card unless the caller asks for
    the CPU; a pool the caller passes builds on its own device).  Cases are
    cached per (workload, seed, backend, device) so all configurations of
    one workload share data and params; pass ``cache`` (a dict, populated
    in place) to reuse the built cases afterwards, e.g. for a
    ``run_bit_sweep`` over the same workloads.  Sharded model cases are
    built inside the pool workers instead and never appear in ``cache``.

    ``plan`` selects fixed-budget (default) or sequential-sampling
    execution — see ``stats.SamplingPlan``.  ``journal`` makes the run
    resumable; ``run_stats`` (a dict, populated in place) reports
    ``{"trials_live", "trials_resumed", "configs_resumed"}``.

    Every configuration also yields injection→detection→recovery timelines,
    synthesized from the trial verdicts; pass ``event_sink`` (a list,
    appended in place) to also capture the raw per-configuration chains,
    e.g. for ``--events-out``.
    """
    if cache is None:
        cache = {}
    if plan is None:
        plan = stats_mod.SamplingPlan()
    if run_stats is None:
        run_stats = {}
    device = str(resolve_device(device))
    run_stats.setdefault("trials_live", 0)
    run_stats.setdefault("trials_resumed", 0)
    run_stats.setdefault("configs_resumed", 0)
    abort = engine_mod.AbortAfter(_abort_after_chunks) \
        if _abort_after_chunks is not None else None
    for spec in specs:
        check_workload(spec.workload)
    own_pool = None
    if pool is None and plan.workers > 0 and any(
            CASES[s.workload].shardable for s in specs):
        own_pool = pool = engine_mod.CampaignPool(plan.workers, device)
    results: List[ConfigResult] = []
    try:
        for spec in specs:
            cls = CASES[spec.workload]
            if not _spec_supported(spec, cls):
                log(f"skip {spec.label()}: unsupported for workload")
                continue
            sharded = pool is not None and cls.shardable
            case = None
            if not sharded:
                cache_key = (spec.workload, spec.seed, spec.backend, device)
                case = cache.get(cache_key)
                if case is None:
                    case = build_case(*cache_key)
                    cache[cache_key] = case
            chunk_size = plan.kernel_chunk if issubclass(cls, _KernelCase) \
                else plan.chunk
            acc = engine_mod.run_config(
                spec, plan, chunk_size, case=case,
                pool=pool if sharded else None, journal=journal, abort=abort)
            run_stats["trials_resumed"] += acc.resumed_trials
            run_stats["trials_live"] += acc.n - acc.resumed_trials
            if acc.resumed_trials and acc.resumed_trials == acc.n:
                run_stats["configs_resumed"] += 1
            res = _finalize_config(spec, cls, acc, plan, event_sink)
            log(f"{spec.label()}: det={res.detection_rate:.3f} "
                f"sdc={res.sdc_rate:.3f} cov={res.coverage:.3f} "
                f"n={res.trials}/{res.max_trials}"
                + (" (early stop)" if res.early_stopped else "")
                + (f" rec={res.faults_recovered}"
                   if res.faults_recovered else ""))
            results.append(res)
    finally:
        if own_pool is not None:
            own_pool.close()
    return results


# ---------------------------------------------------------------------------
# Per-bit-position accumulator coverage
# ---------------------------------------------------------------------------

ACC_BITS = 32          # the accumulator site is int32


def kernel_workloads() -> List[str]:
    """Workloads with an accumulator hook (bit-sweepable)."""
    return sorted(n for n, c in CASES.items() if issubclass(c, _KernelCase))


def _bit_sweep_seed(seed: int, workload: str, policy: Policy, backend: str,
                    bit: int, trial: int) -> int:
    """The seed of one bit-sweep trial: a pure function of its arguments."""
    return fl.trial_seed(
        seed, f"bitsweep/{workload}/{policy.value}/{backend}/{bit}", trial)


def run_bit_sweep(workload: str, policies: Sequence[Policy],
                  trials_per_bit: int = 8, seed: int = 0,
                  backend: str = fl.DEFAULT_BACKEND, case=None,
                  plan: stats_mod.SamplingPlan | None = None,
                  device="cuda",
                  ) -> List[BitCoverageRow]:
    """Targeted accumulator sweep: for every int32 bit position, inject
    ``trials_per_bit`` flips at that exact bit (random element each time)
    and classify.  The resulting table separates the two masking regimes —
    low bits the requantization rescale rounds away (``masked``) from high
    bits that corrupt the output — and shows which of those a policy
    detects.  Kernel-shaped workloads only (~``ACC_BITS × trials_per_bit``
    trials per policy).

    Under an adaptive ``plan`` the sweep runs in trial chunks and stops —
    per policy — at the first chunk boundary where *every* bit position's
    SDC-rate CI half-width is within ``plan.ci_halfwidth``; rows then carry
    the executed (not requested) trial count.  Each (bit, trial) has its
    own seed (``_bit_sweep_seed``), so adaptive and fixed sweeps inject
    identical faults on their shared prefix.  ``case`` (built on its own
    device) is used as given; otherwise one is built on ``device``.
    """
    if case is None:
        check_workload(workload)
        cls = CASES[workload]
    else:
        cls = type(case)
    if not issubclass(cls, _KernelCase):
        raise ValueError(
            f"bit sweep is only supported for the kernel workloads "
            f"{kernel_workloads()} (they expose an accumulator hook); got "
            f"{workload!r}")
    if case is None:
        case = build_case(workload, seed, backend, device)
    if plan is None:
        plan = stats_mod.SamplingPlan()
    rows: List[BitCoverageRow] = []
    for policy in policies:
        if policy not in case.policies:
            continue
        golden = case.golden(policy, "accumulator")
        det = np.zeros((ACC_BITS, 0), bool)
        mis = np.zeros((ACC_BITS, 0), bool)
        step = min(plan.chunk, trials_per_bit) if plan.adaptive \
            else trials_per_bit
        lo = 0
        while lo < trials_per_bit:
            hi = min(lo + step, trials_per_bit)
            d = np.zeros((ACC_BITS, hi - lo), bool)
            m = np.zeros((ACC_BITS, hi - lo), bool)
            for b in range(ACC_BITS):
                def fault(x, gen, b=b):
                    return fi.flip_bit_at(x, gen, b)
                for j, t in enumerate(range(lo, hi)):
                    s = _bit_sweep_seed(seed, workload, policy, backend, b,
                                        t)
                    d[b, j], m[b, j] = case.trial(policy, "accumulator",
                                                  fault, s, golden)
            det = np.concatenate([det, d], axis=1)
            mis = np.concatenate([mis, m], axis=1)
            lo = hi
            if plan.adaptive and lo < trials_per_bit \
                    and lo >= min(plan.min_trials, trials_per_bit):
                sdc = np.sum(mis & ~det, axis=1)
                if all(stats_mod.halfwidth(plan.sdc_interval(int(k), lo))
                       <= plan.ci_halfwidth for k in sdc):
                    break
        n = det.shape[1]
        for b in range(ACC_BITS):
            counts = classify_counts(det[b], mis[b])
            rows.append(BitCoverageRow(
                workload=workload, policy=policy.value, backend=backend,
                bit=b, trials=n, **counts))
    return rows
