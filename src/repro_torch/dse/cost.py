"""Measured cost oracle for the selective-hardening DSE.

The counterpart of ``repro.dse.cost``.  Every (site × policy) combination
of a search space is timed at the shapes the real workload executes — the
transformer FFN sites on the engine's own ``multi_step`` decode window
(mapped config, argmax decode step), the shipdet conv layers through
``dependable_qconv2d``, and the engine-level scrub machinery
(storage-checksum verify, storage checksum) that the engine pays on its
pump cadence.  The result is one JSON document (``measure(...)`` →
``CostModel.to_doc``) that the search consumes as its cost objective.

``CostModel.predict(space, genome)`` combines the measurements as the
reference's does:

    serving:  Σ_site (ms[site][gene] − ms[site][none])   # mapped decode-step Δ
              + storage-verify ms ÷ cadence(weights gene)
              + state-scrub ms by derived mode (detect: one checksum per
                pump; rollback: checksum + snapshot bookkeeping, ≈ 2×)
    shipdet:  Σ_layer ms[layer][gene]

Where the port differs:

* the times are the device's, on the card (``device="cuda"``, the
  default) or the CPU, and ``measure`` records which in
  ``meta["device"]`` (``torch.cuda.get_device_name()`` or ``"cpu"``): a
  cost model prices the device it was measured on, and the CLI refuses one
  measured elsewhere;
* eager PyTorch runs every replica, so a TMR site costs about three times
  its matmuls here (the reference's XLA merges the clean replicas);
* the decode window is a Python loop of device steps that writes the KV
  cache in place, so each timed window starts from a copy of the same
  fresh cache, made before its timer starts, and the host clock is read
  only after ``torch.cuda.synchronize``.  Every variant is timed in
  interleaved rounds (round-robin, per-variant minimum), as in the
  reference.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.dependability import Policy


def device_name(device) -> str:
    """The name a cost model records for ``device``: the card's
    ``torch.cuda.get_device_name`` or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ms(fn, dev: torch.device, reps: int = 20) -> float:
    """ms per call: one warm call, then ``reps`` calls between two
    synchronisations."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _serving_site_shapes(cfg, batch: int):
    """(M, K, N) per FFN matmul site at decode-batch geometry."""
    return {"ffn.wg": (batch, cfg.d_model, cfg.d_ff),
            "ffn.wi": (batch, cfg.d_model, cfg.d_ff),
            "ffn.wd": (batch, cfg.d_ff, cfg.d_model)}


MAX_LEN = 96          # the window's cache length; no timed window passes it
START_POS = 8         # every window starts at position 8, 64 tokens to go


def _windows(cfg, params, *, batch, seed, n_steps, device):
    """{(site, policy): run(cache) -> emitted} for the unmapped window and
    every single-site map, each over its own mapped config; the fresh
    cache they start from; the window's other inputs."""
    from repro_torch.core.policy_map import PolicyMap, PolicyRule
    from repro_torch.models import api as model_api
    from repro_torch.runtime.dataflow import decode_window_steps
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch,)),
                             dtype=torch.int32, device=device)
    rem = torch.full((batch,), 64, dtype=torch.int32, device=device)
    pos = torch.full((batch,), START_POS, dtype=torch.int32, device=device)
    act = torch.ones((batch,), dtype=torch.bool, device=device)

    def window_for(policy_map):
        mcfg = model_api.with_policy_map(cfg, policy_map)

        def step(p, tok, cache):
            logits, cache = model_api.decode_step(mcfg, p, tok, cache)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        def run(cache):
            return decode_window_steps(step, params, tokens, cache, rem, pos,
                                       act, n_steps, -1, MAX_LEN)[2]
        return run

    variants = {("__base__", "none"): window_for(None)}
    for site in _serving_site_shapes(cfg, batch):
        for pol in Policy:
            if pol is not Policy.NONE:
                variants[(site, pol.value)] = window_for(PolicyMap(
                    rules=(PolicyRule(site, pol),), default=Policy.NONE))
    fresh = model_api.init_cache(cfg, batch, MAX_LEN, device=device)
    return variants, fresh


@torch.no_grad()
def measure_serving(cfg, *, batch: int = 8, reps: int = 30,
                    backend: Optional[str] = None, seed: int = 0,
                    n_steps: int = 4, rounds: int = 4, device="cuda",
                    params=None) -> dict:
    """ms per decode step for every (FFN site × policy) plus the engine
    scrub costs, at the given config's geometry.

    FFN site costs are measured on the real decode window — ``n_steps``
    argmax decode steps of the engine's window code with a single-site
    PolicyMap baked into the config — not on an isolated matmul.  The
    stored per-site numbers are whole-step ms; the predictor uses the delta
    over the unmapped step.  ``params`` (the config's, W8A8 where the
    config quantizes) are drawn from ``seed`` when not given."""
    from repro_torch.core import abft as abft_mod
    from repro_torch.models import api as model_api
    dev = resolve_device(device)
    cfg = model_api.with_backend(cfg, backend)
    if params is None:
        params = model_api.init_params(
            cfg, torch.Generator().manual_seed(seed), device=dev)
    variants, fresh = _windows(cfg, params, batch=batch, seed=seed,
                               n_steps=n_steps, device=dev)
    work = tuple(None if t is None else t.clone() for t in fresh)

    def reset():
        for w, f in zip(work, fresh):
            if w is not None:
                w.copy_(f)

    for run in variants.values():                 # warm every variant
        reset()
        run(type(fresh)(*work))
    best: Dict[tuple, float] = {k: float("inf") for k in variants}
    for _ in range(rounds):
        for key, run in variants.items():
            total = 0.0
            for _ in range(reps):
                reset()
                _sync(dev)
                t0 = time.perf_counter()
                run(type(fresh)(*work))
                _sync(dev)
                total += time.perf_counter() - t0
            best[key] = min(best[key], total / reps / n_steps * 1e3)

    base_ms = best[("__base__", "none")]
    sites: Dict[str, dict] = {}
    for site, (m, k, n) in _serving_site_shapes(cfg, batch).items():
        per_policy = {"none": round(base_ms, 5)}
        for pol in Policy:
            if pol is not Policy.NONE:
                per_policy[pol.value] = round(best[(site, pol.value)], 5)
        sites[site] = {"shape_mkn": [m, k, n], "ms": per_policy}

    # engine scrub costs on the real parameter tree: one storage verify
    # (the weights-site scrub the engine pays per cadence tick) and one
    # storage checksum (the baseline/bless cost, paid per deploy)
    checks = abft_mod.storage_checksums(params)
    scrub = {
        "storage_verify_ms": round(_time_ms(
            lambda: abft_mod.verify_storage(params, checks), dev, reps), 5),
        "storage_checksum_ms": round(_time_ms(
            lambda: abft_mod.storage_checksums(params), dev, reps), 5),
    }
    return {"arch": cfg.name, "batch": batch, "n_layers": cfg.n_layers,
            "sites": sites, "scrub": scrub}


@torch.no_grad()
def measure_shipdet(*, reps: int = 10, backend: Optional[str] = None,
                    seed: int = 0, reduced: bool = True,
                    device="cuda") -> dict:
    """ms per call for every (conv layer × policy) of the ship detector
    (``network_specs()`` unless ``reduced``)."""
    from repro_torch.core import quant
    from repro_torch.core.dependability import dependable_qconv2d
    from repro_torch.models import shipdet
    dev = resolve_device(device)
    specs = shipdet.reduced_specs() if reduced else shipdet.network_specs()
    params = shipdet.init_params(specs, torch.Generator().manual_seed(seed),
                                 device=dev)
    rng = np.random.default_rng(seed)
    layers: Dict[str, dict] = {}
    for s, p in zip(specs, params):
        x_q = torch.as_tensor(rng.integers(-127, 128, (1, s.h, s.w, s.cin)),
                              dtype=torch.int8, device=dev)
        q = p["qconv"]
        bias_i32 = torch.round(
            q.bias_f / (p["in_scale"] * q.w_scale)).to(torch.int32)
        rq = quant.requant_scale(p["in_scale"], q.w_scale, p["out_scale"])
        per_policy = {}
        for pol in Policy:
            def call(pol=pol):
                return dependable_qconv2d(
                    pol, x_q, p["in_zp"], q.w_q, bias_i32, rq, p["out_zp"],
                    stride=(s.stride, s.stride), padding="SAME",
                    backend=backend)[0]
            per_policy[pol.value] = round(_time_ms(call, dev, reps), 5)
        layers[s.name] = {"macs": s.macs, "ms": per_policy}
    return {"reduced": reduced, "layers": layers}


def measure(*, arch: str = "smollm-135m", batch: int = 8, reps: int = 30,
            backend: Optional[str] = "cuda", seed: int = 0,
            spaces=("serving", "shipdet"), device="cuda") -> "CostModel":
    """The full oracle at the reference's geometry (the ``reduced()``
    config, W8A8 FFN; the reduced ship detector): measure every space's
    site table; returns the CostModel (``.save(path)`` for the JSON)."""
    from repro_torch.configs import registry
    from repro_torch.models.config import reduced as reduced_cfg
    dev = resolve_device(device)
    doc: dict = {"meta": {"arch": arch, "batch": batch, "reps": reps,
                          "backend": backend or "cuda", "seed": seed,
                          "device": device_name(dev)}}
    if "serving" in spaces:
        cfg = dataclasses.replace(reduced_cfg(registry.get(arch)),
                                  quant="w8a8_ffn")
        doc["serving"] = measure_serving(cfg, batch=batch, reps=reps,
                                         backend=backend, seed=seed,
                                         device=dev)
    if "shipdet" in spaces:
        doc["shipdet"] = measure_shipdet(reps=max(reps // 3, 3),
                                         backend=backend, seed=seed,
                                         device=dev)
    return CostModel(doc)


@dataclasses.dataclass
class CostModel:
    """Measured (site × policy) → ms table + analytic genome predictor."""

    doc: dict

    # cadence assumptions mirrored from Engine(policy_map=...) defaults:
    # ABFT storage scrub runs every pump, CKPT amortizes over the snapshot
    # cadence (snapshot_every defaults near this in the serving cases)
    CKPT_SCRUB_CADENCE = 8

    def to_doc(self) -> dict:
        return self.doc

    @property
    def device(self) -> Optional[str]:
        """The device the costs were measured on (None: not recorded)."""
        return self.doc.get("meta", {}).get("device")

    def save(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.doc, indent=2, sort_keys=True) + "\n")
        return p

    @classmethod
    def load(cls, path) -> "CostModel":
        return cls(json.loads(pathlib.Path(path).read_text()))

    def predict_serving(self, genes: Dict[str, str]) -> float:
        """Estimated dependability cost per decode step, ms: each FFN
        gene's delta over the unmapped step, plus the scrubs."""
        sv = self.doc["serving"]
        total = 0.0
        for site, entry in sv["sites"].items():
            ms = entry["ms"]
            total += max(ms[genes.get(site, "none")] - ms["none"], 0.0)
        storage = genes.get("weights", "none")
        if storage == "abft":
            total += sv["scrub"]["storage_verify_ms"]
        elif storage == "ckpt":
            total += sv["scrub"]["storage_verify_ms"] / self.CKPT_SCRUB_CADENCE
        # transient-state scrub: the engine derives ONE mode from the
        # kv_cache/decode_state genes (the stronger ask wins):
        #   detect (any abft/dmr)   — one state checksum per pump
        #   rollback (any ckpt/tmr) — checksum + snapshot bookkeeping
        transient = {genes.get("kv_cache", "none"),
                     genes.get("decode_state", "none")}
        if transient & {"ckpt", "tmr"}:
            total += (sv["scrub"]["storage_verify_ms"]
                      + sv["scrub"]["storage_checksum_ms"])
        elif transient & {"abft", "dmr"}:
            total += sv["scrub"]["storage_verify_ms"]
        return total

    def predict_shipdet(self, genes: Dict[str, str]) -> float:
        """Estimated forward cost, ms (full network, mapped policies)."""
        layers = self.doc["shipdet"]["layers"]
        return sum(entry["ms"][genes.get(name, "none")]
                   for name, entry in layers.items())

    def predict(self, space_name: str, genes: Dict[str, str]) -> float:
        if space_name == "serving":
            return self.predict_serving(genes)
        if space_name == "shipdet":
            return self.predict_shipdet(genes)
        raise KeyError(f"no cost table for space {space_name!r}")
