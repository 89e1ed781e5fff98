"""Fitness oracle for the selective-hardening DSE.

The counterpart of ``repro.dse.fitness``.  A design point (genome →
:class:`~repro_torch.core.policy_map.PolicyMap`) is scored on three
minimized objectives:

  1. **SDC upper bound** — the worst per-site ``sdc_ci_hi`` from adaptive
     fault-injection campaigns (the port's ``campaign/``: the same engine,
     stopping rule and journal).
  2. **Cost** — the measured cost oracle's prediction for the genome
     (``repro_torch.dse.cost.CostModel``).
  3. **Detection latency** — mean detection ticks across the covered
     sites' reconstructed event timelines.

The serving space exploits a structural decomposition: campaign outcomes
at one injection site depend only on (site, that site's effective policy).
In-graph FFN policies are bit-identical on clean data (exact integer
math), so they cannot change what a *state* strike does to the token
stream, and the engine's scrub machinery never looks at FFN genes.  The
evaluator therefore memoizes one campaign per (site, policy) pair.  The
memoization is exact only while mapped and unmapped engines give
bit-identical clean streams, which ``tests/test_torch_dse.py`` holds on the
CPU and ``chip_smoke.py`` on the card.  FFN genes are scored by the
kernel-level accumulator campaign (``qmatmul`` workload) at the gene's
policy.

The shipdet space has true per-layer structure, so it is evaluated per
genome (memoized by digest) through :class:`MapShipdetCase`.

Where the port differs:

* cases take an integer ``seed`` and a ``device`` (the reference's take a
  key), and no compiled function is cached per layer; the reference's "one
  live mapped case at a time" eviction stays, which bounds the memory a
  search holds on the card;
* a shipdet genome also gets one campaign of addressed strikes into the
  stored weights of each layer whose policy leaves them unchecked (NONE,
  DMR, TMR: ``WEIGHT_GUARDS`` are the others), at site ``weights:<layer>``.
  The uniform ``weights`` campaign strikes a layer in proportion to its
  size, so a layer holding 0.3–0.4 % of the weights (the stem, the
  detection head) draws almost none of a search's strikes, nor of
  certification's 150.  On the card DMR costs what ABFT costs, so maps that trade a small
  layer's ABFT for DMR win on cost and pass the search unseen; these rows
  show their SDC to the search.  They are memoized per (layer, policy),
  exact for the same reason as the serving memo: clean outputs are
  bit-identical under every map, and no other layer checks a corrupted
  weight of this one.  ``certify`` runs the reference's sites only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.campaign import engine as engine_mod
from repro_torch.campaign import faultload as fl
from repro_torch.campaign import stats as stats_mod
from repro_torch.campaign.report import ConfigResult
from repro_torch.campaign.runner import (
    ServingCase, ShipdetCase, _bitwise_mismatch, _finalize_config, build_case)
from repro_torch.core import fault_injection as fi
from repro_torch.core.dependability import Policy
from repro_torch.core.policy_map import PolicyMap

FFN_SITES = ("ffn.wg", "ffn.wi", "ffn.wd")
WEIGHT_GUARDS = ("abft", "ckpt")   # policies that check a layer's w_q


class MapServingCase(ServingCase):
    """ServingCase on the W8A8 FFN path with an optional baked-in policy
    map — the engine the DSE certifies its best map on.  With
    ``policy_map=None`` the engine runs the same quantized forward with no
    in-graph policies: bit-identical to any mapped engine on clean data,
    which is what makes the evaluator's per-(site, policy) memoization
    exact rather than approximate."""

    name = "serving_map"

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 arch: str = "smollm-135m", policy_map: PolicyMap = None, *,
                 device="cuda"):
        self._pm = policy_map
        super().__init__(seed, backend, arch, device=device)

    def _customize_cfg(self, cfg):
        cfg = dataclasses.replace(cfg, quant="w8a8_ffn")
        if self._pm is not None:
            from repro_torch.models import api as model_api
            cfg = model_api.with_policy_map(cfg, self._pm)
        return cfg


class MapShipdetCase(ShipdetCase):
    """ShipdetCase driven by a per-layer policy map instead of one uniform
    policy.  The ``policy`` argument of ``run_trials`` is ignored; coverage
    comes from what the map assigns to the layer each trial strikes:

    ``accumulator``
        the strike layer is drawn per trial, uniform over layers, and the
        int32 accumulator of exactly that layer is faulted.  The trial's
        generator (``faultload.generator(seed)``) draws the layer first,
        then the fault draws its cells from the same generator; the
        reference draws the layer from its own fold of the trial key.
    ``weights``
        host pytree surgery over the per-layer ``w_q`` leaves (uniform
        over weight elements); ABFT layers detect against the deploy-time
        checksums, CKPT layers roll back to the shipped golden weights,
        DMR/TMR layers replicate compute, not storage, so a weight-memory
        SEU sails through them.
    ``weights:<layer>``
        the same surgery on that layer's ``w_q`` alone (the port's
        addressed rows, see the module docstring).
    """

    name = "shipdet_map"

    def __init__(self, seed: int = 0, backend: str = fl.DEFAULT_BACKEND,
                 policy_map: PolicyMap = None, *, device="cuda"):
        super().__init__(seed, backend, device=device)
        self.policy_map = policy_map or PolicyMap.uniform(Policy.NONE)

    def _fwd(self, params, x, inject=None, layer=None):
        out, st = self._shipdet.forward(
            self.specs, params, x, policy_map=self.policy_map,
            inject=inject, inject_layer=layer, backend=self.backend,
            w_checks=self.w_checks, golden_wq=self.golden_wq)
        return out, st["faults_detected"] > 0

    def strike_layer(self, gen: torch.Generator) -> int:
        """The layer an accumulator trial strikes: the first draw of the
        trial's generator."""
        return int(torch.randint(0, len(self.specs), (), generator=gen))

    @torch.no_grad()
    def run_trials(self, policy, site, fault, seeds):
        detected_l, mismatch_l = [], []
        if site == "weights" or site.startswith("weights:"):
            names = [sp.name for sp in self.specs]
            at = None if site == "weights" \
                else (names.index(site.split(":", 1)[1]),)
            golden, _ = self._fwd(self.params, self.x)
            for s in seeds:
                leaves = self._wq_leaves(self.params)
                wq = fi.inject_pytree_with(leaves, fl.generator(s), fault) \
                    if at is None else fi.inject_leaf_with(
                        leaves, at, fl.generator(s), fault)
                out, det = self._fwd(self._with_wq(wq), self.x)
                detected_l.append(bool(det))
                mismatch_l.append(bool(_bitwise_mismatch(out, golden)))
        elif site == "accumulator":
            golden, _ = self._fwd(self.params, self.x)
            for s in seeds:
                gen = fl.generator(s)
                layer = self.strike_layer(gen)
                out, det = self._fwd(self.params, self.x,
                                     inject=lambda acc: fault(acc, gen),
                                     layer=layer)
                detected_l.append(bool(det))
                mismatch_l.append(bool(_bitwise_mismatch(out, golden)))
        else:
            raise ValueError(f"unsupported mapped shipdet site {site!r}")
        return np.asarray(detected_l, bool), np.asarray(mismatch_l, bool)


@dataclasses.dataclass
class Fitness:
    """One genome's evaluated objectives + the evidence behind them."""

    genes: Dict[str, str]
    objectives: Tuple[float, float, float]   # (sdc_ci_hi, cost_ms, det_ticks)
    sdc_max: float                            # worst observed per-site rate
    cost_ms: float
    detection_ticks: float
    trials: int
    site_rows: Dict[str, dict]               # site -> ConfigResult doc
    # sites left at "none": structural coverage gap (pick_best's tie-break
    # prefers the design that detects every injected fault)
    uncovered: int = 0

    def to_doc(self) -> dict:
        return {"genes": self.genes, "objectives": list(self.objectives),
                "sdc_max": self.sdc_max, "cost_ms": self.cost_ms,
                "detection_ticks": self.detection_ticks,
                "trials": self.trials, "uncovered": self.uncovered,
                "site_rows": self.site_rows}


class Evaluator:
    """Campaign-backed fitness with per-(site, policy) memoization.

    Every campaign row is produced by ``engine_mod.run_config`` under the
    given :class:`~repro_torch.campaign.stats.SamplingPlan` and, when a
    journal is given, is crash-consistent and reusable across search runs.
    """

    def __init__(self, space, cost_model, *, seed: int = 0,
                 backend: str = fl.DEFAULT_BACKEND,
                 arch: str = "smollm-135m",
                 fault_model: str = "single_bitflip", trials: int = 60,
                 plan: Optional[stats_mod.SamplingPlan] = None,
                 journal=None, log=lambda s: None, device="cuda"):
        self.space = space
        self.cost_model = cost_model
        self.seed = seed
        self.backend = backend
        self.arch = arch
        self.fault_model = fault_model
        self.trials = trials
        self.plan = plan or stats_mod.SamplingPlan(
            ci_halfwidth=0.08, chunk=20, min_trials=20)
        self.journal = journal
        self.log = log
        self.device = device
        self._rows: Dict[Tuple[str, str, str], ConfigResult] = {}
        self._cases: Dict[str, object] = {}
        self._genomes: Dict[str, Fitness] = {}
        self.campaigns_run = 0

    # -- campaign plumbing -------------------------------------------------

    def _finish(self, spec, case, plan, what: str) -> ConfigResult:
        acc = engine_mod.run_config(spec, plan, plan.chunk, case=case,
                                    journal=self.journal)
        res = _finalize_config(spec, type(case), acc, plan, None)
        self.log(f"  {what} {spec.label()}: sdc={res.sdc_rate:.3f} "
                 f"(ci_hi={res.sdc_ci_hi:.3f}) det={res.detection_rate:.3f} "
                 f"n={res.trials}")
        return res

    def _run(self, spec: fl.CampaignSpec, case) -> ConfigResult:
        res = self._finish(spec, case, self.plan, "campaign")
        self.campaigns_run += 1
        return res

    def _spec(self, workload, policy, site, trials=None):
        return fl.CampaignSpec(workload, policy, site, self.fault_model,
                               self.trials if trials is None else trials,
                               self.seed, self.backend)

    def _serving_row(self, site: str, gene: str) -> ConfigResult:
        key = ("serving_map", site, gene)
        if key not in self._rows:
            case = self._cases.get("serving_map")
            if case is None:
                case = MapServingCase(self.seed, self.backend, self.arch,
                                      device=self.device)
                self._cases["serving_map"] = case
            self._rows[key] = self._run(
                self._spec("serving_map", Policy(gene), site), case)
        return self._rows[key]

    def _kernel_row(self, gene: str) -> ConfigResult:
        key = ("qmatmul", "accumulator", gene)
        if key not in self._rows:
            case = self._cases.get("qmatmul")
            if case is None:
                case = build_case("qmatmul", self.seed, self.backend,
                                  device=self.device)
                self._cases["qmatmul"] = case
            self._rows[key] = self._run(
                self._spec("qmatmul", Policy(gene), "accumulator"), case)
        return self._rows[key]

    def _shipdet_case(self, genome) -> MapShipdetCase:
        case_key = f"shipdet_map:{self.space.digest(genome)}"
        case = self._cases.get(case_key)
        if case is None:
            case = MapShipdetCase(
                self.seed, self.backend,
                policy_map=self.space.to_policy_map(genome),
                device=self.device)
            # one live mapped case at a time
            self._cases = {k: v for k, v in self._cases.items()
                           if not k.startswith("shipdet_map:")}
            self._cases[case_key] = case
        return case

    def _shipdet_rows(self, genome) -> Dict[str, ConfigResult]:
        case_key = f"shipdet_map:{self.space.digest(genome)}"
        rows = {}
        for site in self.space.campaign_sites:
            key = (case_key, site, "map")
            if key not in self._rows:
                # the digest rides in the workload field so the journal
                # (and the trial seed stream) key on the map
                self._rows[key] = self._run(
                    self._spec(case_key, Policy.NONE, site),
                    self._shipdet_case(genome))
            rows[site] = self._rows[key]
        for layer, gene in self.space.genes(genome).items():
            if gene in WEIGHT_GUARDS:
                continue
            site = f"weights:{layer}"
            key = ("shipdet_layer", site, gene)
            if key not in self._rows:
                self._rows[key] = self._run(
                    self._spec("shipdet_layer", Policy(gene), site),
                    self._shipdet_case(genome))
            rows[site] = self._rows[key]
        return rows

    # -- public API --------------------------------------------------------

    def evaluate(self, genome) -> Fitness:
        digest = self.space.digest(genome)
        if digest in self._genomes:
            return self._genomes[digest]
        genes = self.space.genes(genome)
        rows: Dict[str, ConfigResult] = {}
        if self.space.name == "serving":
            for site in self.space.campaign_sites:
                rows[site] = self._serving_row(site, genes[site])
            for site in FFN_SITES:
                rows[site] = self._kernel_row(genes[site])
        elif self.space.name == "shipdet":
            rows = self._shipdet_rows(genome)
        else:
            raise KeyError(f"no fitness oracle for space "
                           f"{self.space.name!r}")

        sdc_max = max(r.sdc_rate for r in rows.values())
        sdc_hi = max(r.sdc_ci_hi for r in rows.values())
        cost_ms = float(self.cost_model.predict(self.space.name, genes))
        det = [r.detection_ticks_mean for r in rows.values()
               if r.detections_logged]
        det_ticks = float(np.mean(det)) if det else 0.0
        fit = Fitness(
            genes=genes,
            objectives=(round(sdc_hi, 6), round(cost_ms, 5),
                        round(det_ticks, 4)),
            sdc_max=sdc_max, cost_ms=cost_ms, detection_ticks=det_ticks,
            trials=sum(r.trials for r in rows.values()),
            site_rows={s: dataclasses.asdict(r) for s, r in rows.items()},
            uncovered=sum(1 for g in genes.values() if g == "none"))
        self._genomes[digest] = fit
        return fit

    def certify(self, genome, *, trials: int,
                plan: Optional[stats_mod.SamplingPlan] = None,
                ) -> Dict[str, dict]:
        """Re-evaluate a single map at certification budget — running the
        actual mapped engine/network (not the memoized decomposition)."""
        plan = plan or stats_mod.SamplingPlan()
        pm = self.space.to_policy_map(genome)
        digest = self.space.digest(genome)
        if self.space.name == "serving":
            case = MapServingCase(self.seed, self.backend, self.arch,
                                  policy_map=pm, device=self.device)
            genes = self.space.genes(genome)
            policies = {s: Policy(genes[s]) for s in self.space.campaign_sites}
        else:
            case = MapShipdetCase(self.seed, self.backend, policy_map=pm,
                                  device=self.device)
            policies = {s: Policy.NONE for s in self.space.campaign_sites}
        rows: Dict[str, dict] = {}
        for site, policy in policies.items():
            spec = self._spec(f"certify_map:{digest}", policy, site, trials)
            rows[site] = dataclasses.asdict(
                self._finish(spec, case, plan, "certify"))
        return rows
