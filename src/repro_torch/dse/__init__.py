"""Selective-hardening design-space exploration on the port.

The counterpart of ``repro.dse``: per-layer policy maps
(``repro_torch.core.policy_map``) define the design space; this package
searches it with a cost oracle measured on the device it runs on
(``cost``), campaign-backed fitness over the port's ``campaign/`` with
exact per-site memoization (``fitness``), an NSGA-lite Pareto loop
(``search``) and the artifacts (``report``, ``cli``).
"""
from repro_torch.dse.space import SERVING_SPACE, SearchSpace, get_space
from repro_torch.dse.cost import CostModel, measure
from repro_torch.dse.fitness import Evaluator, MapServingCase, MapShipdetCase
from repro_torch.dse.search import (
    Candidate, SearchResult, dominates, non_dominated_sort, pick_best,
    search)

__all__ = [
    "SERVING_SPACE", "SearchSpace", "get_space",
    "CostModel", "measure",
    "Evaluator", "MapServingCase", "MapShipdetCase",
    "Candidate", "SearchResult", "dominates", "non_dominated_sort",
    "pick_best", "search",
]
