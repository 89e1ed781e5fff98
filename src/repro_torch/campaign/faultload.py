"""Faultload generation — which faults strike where, reproducibly.

The counterpart of ``repro.campaign.faultload``.  A *faultload* (DAVOS
terminology) is the set of faults a campaign injects: a fault model (what
kind of corruption), an injection site (which tensor in the execution
path), and a deterministic per-trial seed stream.  One ``CampaignSpec``
pins all of it plus the policy under test, so a campaign row is rerunnable
bit-for-bit from (spec, seed) alone.

Fault models map 1:1 onto ``core.fault_injection`` primitives, each a
``(x, gen) -> x'`` over a CPU ``torch.Generator``:

  single_bitflip   one SEU: one random bit of one random element XORed
  multi_bitflip    fleet-scale rate model: every bit flips independently
                   (default rate 1e-4; ``multi_bitflip@3e-4`` overrides)
  stuck_at0/1      permanent fault: one random bit forced to 0 / 1
  mbu_burst        multi-bit upset: a seeded cluster of adjacent cells —
                   elems × bits rectangle, default 2×2 (``mbu_burst@4x1``
                   overrides) — per the neutron-irradiation MBU signature

Seed streams.  The reference splits one ``jax.random`` key per
configuration into ``trials`` keys, which torch cannot reproduce.  Here
trial ``i`` of a configuration draws from its own generator, seeded with
``trial_seed(seed, label, i)``: the first 63 bits of a BLAKE2b digest of
``"{seed}/{label}/{i}"``.  A trial's seed is a pure function of (seed,
label, index), so any slice ``[lo, hi)`` of the stream draws what the whole
run draws there: adaptive stopping, sharding and resume all rely on it.
``STREAM_SCHEME`` names the scheme; journals record it, because the two
packages inject different faults for the same spec.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core import fault_injection as fi
from repro_torch.core.dependability import Policy

DEFAULT_MULTI_RATE = 1e-4
DEFAULT_BURST = (2, 2)          # elems × bits: the smallest 2-D MBU cluster
DEFAULT_BACKEND = "cuda"

SITES = ("accumulator", "weights", "activations", "kv_cache", "decode_state")

STREAM_SCHEME = "blake2b63(seed/label/trial) -> torch.Generator (cpu)"


@dataclasses.dataclass(frozen=True)
class FaultModel:
    name: str
    apply: Callable[[torch.Tensor, torch.Generator], torch.Tensor]
    description: str


def _rate_model(rate: float) -> FaultModel:
    return FaultModel(
        f"multi_bitflip@{rate:g}" if rate != DEFAULT_MULTI_RATE
        else "multi_bitflip",
        lambda x, gen: fi.flip_bits_at_rate(x, gen, rate),
        f"each bit flips independently with p={rate:g}")


def _burst_model(elems: int, bits: int) -> FaultModel:
    if elems < 1 or bits < 1:
        raise ValueError(f"mbu_burst cluster must be >= 1x1, got "
                         f"{elems}x{bits}")
    name = ("mbu_burst" if (elems, bits) == DEFAULT_BURST
            else f"mbu_burst@{elems}x{bits}")
    return FaultModel(
        name, lambda x, gen: fi.flip_burst(x, gen, elems, bits),
        f"MBU cluster: {elems} adjacent elements x {bits} adjacent bits "
        "flipped around a seeded anchor")


FAULT_MODELS = {
    "single_bitflip": FaultModel(
        "single_bitflip", fi.flip_one_bit,
        "one random bit of one random element XOR-flipped"),
    "multi_bitflip": _rate_model(DEFAULT_MULTI_RATE),
    "stuck_at0": FaultModel(
        "stuck_at0", lambda x, gen: fi.stuck_at(x, gen, 0),
        "one random bit forced to 0"),
    "stuck_at1": FaultModel(
        "stuck_at1", lambda x, gen: fi.stuck_at(x, gen, 1),
        "one random bit forced to 1"),
    "mbu_burst": _burst_model(*DEFAULT_BURST),
}


def resolve_fault_model(name: str) -> FaultModel:
    """Registry lookup; ``multi_bitflip@<rate>`` builds a custom-rate model,
    ``mbu_burst@<elems>x<bits>`` a custom-geometry burst cluster."""
    if name in FAULT_MODELS:
        return FAULT_MODELS[name]
    if name.startswith("multi_bitflip@"):
        return _rate_model(float(name.split("@", 1)[1]))
    if name.startswith("mbu_burst@"):
        try:
            elems, bits = name.split("@", 1)[1].split("x", 1)
            return _burst_model(int(elems), int(bits))
        except ValueError as e:
            raise KeyError(f"bad mbu_burst geometry in {name!r}; expected "
                           "mbu_burst@<elems>x<bits>, e.g. mbu_burst@4x1") \
                from e
    raise KeyError(f"unknown fault model {name!r}; known: "
                   f"{sorted(FAULT_MODELS)}, multi_bitflip@<rate>, "
                   "or mbu_burst@<elems>x<bits>")


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One campaign configuration = one row of the coverage report."""
    workload: str
    policy: Policy
    site: str
    fault_model: str
    trials: int
    seed: int = 0
    backend: str = DEFAULT_BACKEND   # execution backend (core/backend.py)

    def label(self) -> str:
        base = (f"{self.workload}/{self.policy.value}/{self.site}/"
                f"{self.fault_model}")
        # the default backend is left out, as in the reference
        return base if self.backend == DEFAULT_BACKEND \
            else f"{base}/{self.backend}"


def trial_seed(seed: int, label: str, trial: int) -> int:
    """The seed of one trial: a pure function of (seed, label, trial)."""
    digest = hashlib.blake2b(f"{seed}/{label}/{trial}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big") >> 1


def trial_seeds(spec: CampaignSpec, lo: int = 0,
                hi: Optional[int] = None) -> List[int]:
    """Seeds of trials ``[lo, hi)`` (default: all ``spec.trials``)."""
    hi = spec.trials if hi is None else hi
    label = spec.label()
    return [trial_seed(spec.seed, label, i) for i in range(lo, hi)]


def generator(seed: int) -> torch.Generator:
    """A fresh CPU generator for one trial's fault draws."""
    return torch.Generator().manual_seed(seed)


def expand_grid(
    workloads: Sequence[str],
    policies: Sequence[Policy],
    sites: Sequence[str],
    fault_models: Sequence[str],
    trials: int,
    seed: int = 0,
    supported: dict | None = None,
    backends: Sequence[str] = (DEFAULT_BACKEND,),
) -> List[CampaignSpec]:
    """Cartesian sweep, filtered to combinations the workload supports.

    ``supported`` maps workload -> (sites, policies); unsupported combos are
    dropped (e.g. ABFT on the float transformer has no checksum to check).
    ``backends`` adds the execution-backend axis (validated against the
    registry) so one sweep certifies e.g. torch *and* cuda side by side.
    """
    from repro_torch.core import backend as backend_mod
    for be in backends:
        backend_mod.get_backend(be)                  # fail fast on typos
    specs = []
    for w in workloads:
        if supported is not None and w not in supported:
            raise KeyError(f"unknown workload {w!r}; known: {sorted(supported)}")
        ok_sites, ok_policies = (supported or {}).get(w, (SITES, tuple(Policy)))
        for be in backends:
            for p in policies:
                if p not in ok_policies:
                    continue
                for s in sites:
                    if s not in ok_sites:
                        continue
                    for fm in fault_models:
                        resolve_fault_model(fm)      # fail fast on typos
                        specs.append(
                            CampaignSpec(w, p, s, fm, trials, seed, backend=be))
    return specs
