"""Genome encoding for the selective-hardening design-space exploration.

The counterpart of ``repro.dse.space``: the same spaces, genomes,
operators and ``digest`` (crc32 of the same JSON), so a seed draws the
same genomes in both packages.

A genome is a tuple of policy names, one gene per *site* of a
:class:`SearchSpace`, in declared site order.  ``to_policy_map`` renders it
as the :class:`~repro_torch.core.policy_map.PolicyMap` the rest of the system
executes; ``from_policy_map``/``digest``/``to_doc`` give the search loop a
canonical, journal-stable identity per design point.

Two spaces ship:

``serving``
    The streaming engine (W8A8 FFN transformer).  Genes: the three dense
    FFN matmul sites (``ffn.wg``/``ffn.wi``/``ffn.wd`` — uniform across the
    scanned layer stack, see core/policy_map.py) and the three engine state
    sites (``weights``, ``kv_cache``, ``decode_state``).  Two policies are
    pruned from the FFN genes rather than left for the search to
    rediscover as degenerate every run:

    * **DMR** — inside a ``lax.scan`` its detect-only alarm has no surface
      to escape through, so it buys 2× cost for zero usable coverage;
    * **TMR** — in the reference, XLA CSE collapses the clean replicas of
      an in-graph NMR op into one computation (its cost oracle shows TMR ≈
      NONE there), so the compiled serving graph carries no actual
      redundancy.  Eager PyTorch runs every replica, so on the card a TMR
      site costs about 3× its matmuls, which the port's cost oracle
      measures and prints; the space stays the reference's, for parity.
      Replicated serving belongs at fleet level (physically separate
      replicas, fleet/).

    TMR is likewise excluded from the state genes (the engine's state
    machinery implements scrub/rollback, not replicated serving).

``shipdet``
    The paper's ship-detection CNN: one gene per conv layer (true
    per-layer granularity — the Python layer loop), all five policies
    available in-op per layer.
"""
from __future__ import annotations

import dataclasses
import json
import random
import zlib
from typing import Dict, Optional, Tuple

from repro_torch.core.dependability import Policy
from repro_torch.core.policy_map import PolicyMap, PolicyRule

Genome = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Named, ordered (site → allowed policies) table."""

    name: str
    sites: Tuple[Tuple[str, Tuple[str, ...]], ...]
    # which campaign injection sites the fitness oracle strikes, and how the
    # struck site maps onto the genome (identity for engine state sites)
    campaign_sites: Tuple[str, ...]

    @property
    def site_names(self) -> Tuple[str, ...]:
        return tuple(s for s, _ in self.sites)

    def size(self) -> int:
        n = 1
        for _, choices in self.sites:
            n *= len(choices)
        return n

    # -- genome constructors ----------------------------------------------

    def uniform_genome(self, policy) -> Genome:
        """Every site gets ``policy`` where allowed, else the strongest
        available fallback (ordering by the site's choice list)."""
        name = policy.value if isinstance(policy, Policy) else str(policy)
        genes = []
        for _, choices in self.sites:
            genes.append(name if name in choices else choices[-1])
        return tuple(genes)

    def random_genome(self, rng: random.Random) -> Genome:
        return tuple(rng.choice(choices) for _, choices in self.sites)

    def validate(self, genome: Genome) -> Genome:
        if len(genome) != len(self.sites):
            raise ValueError(f"genome length {len(genome)} != "
                             f"{len(self.sites)} sites of {self.name!r}")
        for gene, (site, choices) in zip(genome, self.sites):
            if gene not in choices:
                raise ValueError(f"{gene!r} not allowed at {site!r} "
                                 f"(choices: {choices})")
        return tuple(genome)

    # -- genetic operators (plain ``random.Random`` — deterministic) -------

    def mutate(self, genome: Genome, rng: random.Random,
               rate: float) -> Genome:
        genes = list(genome)
        for i, (_, choices) in enumerate(self.sites):
            if rng.random() < rate:
                genes[i] = rng.choice(choices)
        return tuple(genes)

    def crossover(self, a: Genome, b: Genome, rng: random.Random) -> Genome:
        return tuple(ga if rng.random() < 0.5 else gb
                     for ga, gb in zip(a, b))

    # -- rendition ---------------------------------------------------------

    def to_policy_map(self, genome: Genome) -> PolicyMap:
        self.validate(genome)
        rules = tuple(PolicyRule(site, Policy(gene))
                      for gene, (site, _) in zip(genome, self.sites))
        return PolicyMap(rules=rules, default=Policy.NONE)

    def from_policy_map(self, pm: PolicyMap) -> Genome:
        return self.validate(tuple(pm.policy_for(site)
                                   .value for site in self.site_names))

    def genes(self, genome: Genome) -> Dict[str, str]:
        return dict(zip(self.site_names, genome))

    def to_doc(self, genome: Genome) -> dict:
        return {"space": self.name, "genes": self.genes(genome)}

    def from_doc(self, doc: dict) -> Genome:
        genes = doc["genes"]
        return self.validate(tuple(genes[s] for s in self.site_names))

    def digest(self, genome: Genome) -> str:
        """Short stable identity of a design point — keys the in-memory
        fitness cache and the search journal records."""
        blob = json.dumps(self.to_doc(genome), sort_keys=True)
        return f"{zlib.crc32(blob.encode()):08x}"


_FFN_CHOICES = ("none", "abft", "ckpt")     # no DMR/TMR: see module doc
_STATE_CHOICES = ("none", "abft", "ckpt")

SERVING_SPACE = SearchSpace(
    name="serving",
    sites=(
        ("ffn.wg", _FFN_CHOICES),
        ("ffn.wi", _FFN_CHOICES),
        ("ffn.wd", _FFN_CHOICES),
        ("weights", _STATE_CHOICES),
        ("kv_cache", _STATE_CHOICES),
        ("decode_state", _STATE_CHOICES),
    ),
    campaign_sites=("weights", "kv_cache", "decode_state"),
)


def _shipdet_space() -> SearchSpace:
    from repro_torch.models import shipdet
    choices = ("none", "abft", "dmr", "tmr", "ckpt")
    return SearchSpace(
        name="shipdet",
        sites=tuple((s.name, choices) for s in shipdet.network_specs()),
        campaign_sites=("accumulator", "weights"),
    )


_SPACES: Dict[str, Optional[SearchSpace]] = {"serving": SERVING_SPACE,
                                             "shipdet": None}


def get_space(name: str) -> SearchSpace:
    if name not in _SPACES:
        raise KeyError(f"unknown search space {name!r}; "
                       f"known: {sorted(_SPACES)}")
    if _SPACES[name] is None:       # lazy: shipdet imports the model module
        _SPACES[name] = _shipdet_space()
    return _SPACES[name]
