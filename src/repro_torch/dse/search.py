"""NSGA-lite Pareto search over policy-map genomes.

The counterpart of ``repro.dse.search``, line for line: the same
``random.Random(seed)`` stream, so a search over the same evaluator
replays the reference's archive, front, best and history.

A deliberately small, dependency-free genetic loop in the DAVOS
``Evolutionary_DSE`` shape: non-dominated sorting + crowding-distance
ranking (NSGA-II's selection pressure), binary tournaments, uniform
crossover, per-gene mutation — all driven by one ``random.Random(seed)``
so a search replays bit-for-bit.  Every genome ever evaluated lands in an
archive; the reported frontier is the archive's first non-dominated front
(so nothing good is lost to generational drift), and the *decision* —
``pick_best`` — is the paper's criterion stated directly: the cheapest
design whose campaign evidence is consistent with SDC = 0.

The evaluator memoizes per-(site, policy) campaigns (see fitness.py), so
generations after the first are nearly free for the serving space: the
search explores the combinatorial space while the campaign budget stays
bounded by the number of distinct site policies.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.dse.fitness import Fitness


@dataclasses.dataclass
class Candidate:
    genome: tuple
    digest: str
    fitness: Fitness

    @property
    def objectives(self) -> Tuple[float, ...]:
        return self.fitness.objectives

    def to_doc(self) -> dict:
        return {"digest": self.digest, **self.fitness.to_doc()}


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """a Pareto-dominates b (all objectives minimized)."""
    return all(x <= y for x, y in zip(a, b)) and \
        any(x < y for x, y in zip(a, b))


def non_dominated_sort(cands: Sequence[Candidate]) -> List[List[int]]:
    """Indices grouped into fronts, best first (NSGA-II fast sort)."""
    n = len(cands)
    dominated_by: List[List[int]] = [[] for _ in range(n)]
    dom_count = [0] * n
    for i in range(n):
        for j in range(i + 1, n):
            if dominates(cands[i].objectives, cands[j].objectives):
                dominated_by[i].append(j)
                dom_count[j] += 1
            elif dominates(cands[j].objectives, cands[i].objectives):
                dominated_by[j].append(i)
                dom_count[i] += 1
    fronts: List[List[int]] = []
    current = [i for i in range(n) if dom_count[i] == 0]
    while current:
        fronts.append(current)
        nxt = []
        for i in current:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        current = nxt
    return fronts


def crowding_distance(cands: Sequence[Candidate],
                      front: Sequence[int]) -> Dict[int, float]:
    """Per-index crowding distance within one front (bigger = lonelier)."""
    dist = {i: 0.0 for i in front}
    if len(front) <= 2:
        return {i: float("inf") for i in front}
    n_obj = len(cands[front[0]].objectives)
    for m in range(n_obj):
        order = sorted(front, key=lambda i: cands[i].objectives[m])
        lo = cands[order[0]].objectives[m]
        hi = cands[order[-1]].objectives[m]
        dist[order[0]] = dist[order[-1]] = float("inf")
        if hi <= lo:
            continue
        for k in range(1, len(order) - 1):
            gap = (cands[order[k + 1]].objectives[m]
                   - cands[order[k - 1]].objectives[m])
            dist[order[k]] += gap / (hi - lo)
    return dist


def _rank(cands: Sequence[Candidate]) -> Dict[int, Tuple[int, float]]:
    """index -> (front number, -crowding) — lexicographic NSGA-II rank."""
    ranks: Dict[int, Tuple[int, float]] = {}
    for f_no, front in enumerate(non_dominated_sort(cands)):
        dist = crowding_distance(cands, front)
        for i in front:
            ranks[i] = (f_no, -dist[i])
    return ranks


@dataclasses.dataclass
class SearchResult:
    archive: List[Candidate]          # every distinct genome evaluated
    front: List[Candidate]            # archive's first non-dominated front
    best: Optional[Candidate]         # pick_best over the archive
    generations: int
    evaluations: int                  # distinct genomes evaluated
    history: List[dict]               # per-generation progress rows

    def to_doc(self) -> dict:
        return {
            "generations": self.generations,
            "evaluations": self.evaluations,
            "history": self.history,
            "front": [c.to_doc() for c in self.front],
            "best": self.best.to_doc() if self.best else None,
            "archive_size": len(self.archive),
        }


def pick_best(cands: Sequence[Candidate],
              sdc_budget: float = 0.0) -> Optional[Candidate]:
    """The certified decision rule: cheapest candidate whose observed SDC
    rate is within budget (0 by default — every injected fault masked,
    detected, or healed).  Cost ties break toward *structural coverage*
    (fewest unprotected sites): at search trial budgets an unprotected
    site with every flip masked is statistically indistinguishable from a
    protected one, but only the protected design survives the 150-trial
    certification gate reliably — prefer detects-everything over
    not-caught-yet whenever it costs nothing.  Remaining ties break by
    detection latency then digest.  Falls back to the lowest-SDC
    candidate when nothing is feasible."""
    if not cands:
        return None
    feasible = [c for c in cands if c.fitness.sdc_max <= sdc_budget]
    if feasible:
        return min(feasible, key=lambda c: (c.fitness.cost_ms,
                                            c.fitness.uncovered,
                                            c.fitness.detection_ticks,
                                            c.digest))
    return min(cands, key=lambda c: (c.fitness.sdc_max, c.fitness.cost_ms,
                                     c.digest))


def search(space, evaluator, *, generations: int = 8, population: int = 16,
           seed: int = 0, mutation_rate: float = 0.25,
           log=lambda s: None) -> SearchResult:
    """Run the genetic loop; deterministic in (space, evaluator, args)."""
    rng = random.Random(seed)
    archive: Dict[str, Candidate] = {}

    def admit(genome) -> Candidate:
        digest = space.digest(genome)
        if digest not in archive:
            archive[digest] = Candidate(genome=tuple(genome), digest=digest,
                                        fitness=evaluator.evaluate(genome))
        return archive[digest]

    # seed population: the uniform corner maps (the designs selective
    # hardening must beat) plus random fill
    pop: List[Candidate] = []
    for uniform in ("none", "abft", "ckpt"):
        pop.append(admit(space.uniform_genome(uniform)))
    while len(pop) < population:
        pop.append(admit(space.random_genome(rng)))

    history: List[dict] = []
    for gen in range(generations):
        ranks = _rank(pop)

        def tournament() -> Candidate:
            i, j = rng.randrange(len(pop)), rng.randrange(len(pop))
            return pop[i] if ranks[i] <= ranks[j] else pop[j]

        children = []
        while len(children) < population:
            child = space.crossover(tournament().genome,
                                    tournament().genome, rng)
            child = space.mutate(child, rng, mutation_rate)
            children.append(admit(child))

        merged = list({c.digest: c for c in pop + children}.values())
        m_ranks = _rank(merged)
        order = sorted(range(len(merged)), key=lambda i: m_ranks[i])
        pop = [merged[i] for i in order[:population]]

        front0 = [pop[i] for i in non_dominated_sort(pop)[0]]
        best = pick_best(list(archive.values()))
        history.append({
            "generation": gen,
            "evaluated": len(archive),
            "front_size": len(front0),
            "best_cost_ms": best.fitness.cost_ms,
            "best_sdc_max": best.fitness.sdc_max,
        })
        log(f"gen {gen}: archive={len(archive)} front={len(front0)} "
            f"best_cost={best.fitness.cost_ms:.4f}ms "
            f"best_sdc={best.fitness.sdc_max:.3f}")

    # memetic polish: coordinate descent on the incumbent best.  Fitness
    # memoization makes every probe a cache hit on the campaign side, so
    # this closes the last-gene gaps a small-population genetic loop tends
    # to leave (e.g. one FFN site stuck on a costlier-but-safe policy)
    # without any extra injection budget.
    incumbent = pick_best(list(archive.values()))
    improved = incumbent is not None
    while improved:
        improved = False
        for idx, (_, choices) in enumerate(space.sites):
            for choice in choices:
                if choice == incumbent.genome[idx]:
                    continue
                probe = admit(incumbent.genome[:idx] + (choice,)
                              + incumbent.genome[idx + 1:])
                if pick_best([incumbent, probe]) is probe:
                    incumbent, improved = probe, True
    if incumbent is not None:
        log(f"polish: best_cost={incumbent.fitness.cost_ms:.4f}ms "
            f"best_sdc={incumbent.fitness.sdc_max:.3f} "
            f"archive={len(archive)}")

    all_c = list(archive.values())
    front_idx = non_dominated_sort(all_c)[0] if all_c else []
    front = sorted((all_c[i] for i in front_idx),
                   key=lambda c: c.objectives)
    return SearchResult(archive=all_c, front=front, best=pick_best(all_c),
                        generations=generations, evaluations=len(all_c),
                        history=history)
