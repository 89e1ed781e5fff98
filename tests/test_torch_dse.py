"""The port's selective-hardening DSE (``repro_torch.dse``) on the CPU: the
cases of tests/test_dse.py, and the port held against ``repro.dse``.

Equal to the reference, exactly: genomes, operators and digests for the
same seeds in both spaces; ``search`` over the same stub evaluator
(archive digests, front, best, history); ``CostModel.predict`` on the
reference's committed ``reports/dse/cost_model.json`` (read here as a
fixture); the bytes of ``write_pareto``, ``render_markdown`` and
``bench_doc``; ``MapShipdetCase``'s ``detected``/``mismatch`` trial by
trial at both sites, on the reference's weights, when both packages strike
the same addressed (layer, cell, bit) faults.  ``measure`` gives the
structure of the reference's committed ``measure`` doc.  Beside them: the evaluator's memo counts, a
mapped engine's clean streams equal to the unmapped one's (what makes the
memo exact), the shipdet evaluator's addressed weight rows (the port's
own, see ``repro_torch.dse.fitness``), the CLI's three commands, and the
refusal of a cost model measured on another device."""
from __future__ import annotations

import importlib
import json
import pathlib
import random
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign import faultload as jfl
from repro.core import fault_injection as jfi
from repro.dse import cost as jcost
from repro.dse import fitness as jfitness
from repro.dse import report as jreport
from repro.dse import space as jspace
from repro_torch.convert import shipdet_params_from_numpy
from repro_torch.core import fault_injection as tfi
from repro_torch.core.dependability import Policy
from repro_torch.core.policy_map import PolicyMap, PolicyRule
from repro_torch.dse import cli
from repro_torch.dse import cost as tcost
from repro_torch.dse import report as treport
from repro_torch.dse.cost import CostModel
from repro_torch.dse.fitness import (FFN_SITES, Evaluator, Fitness,
                                     MapServingCase, MapShipdetCase)
from repro_torch.dse.search import (
    Candidate, crowding_distance, dominates, non_dominated_sort, pick_best,
    search)
from repro_torch.dse.space import SERVING_SPACE, get_space
from repro_torch.models import shipdet as tshipdet

jax.config.update("jax_platform_name", "cpu")

# the modules, not the ``search`` functions both packages re-export
jsearch = importlib.import_module("repro.dse.search")
tsearch = importlib.import_module("repro_torch.dse.search")

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_COST_MODEL = ROOT / "reports" / "dse" / "cost_model.json"
SPACES = ("serving", "shipdet")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Trials are many small ops: one intra-op thread keeps them from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ space

def test_space_roundtrip_and_digest_determinism():
    sp = SERVING_SPACE
    g = sp.uniform_genome("abft")
    assert sp.from_doc(sp.to_doc(g)) == g
    assert sp.from_policy_map(sp.to_policy_map(g)) == g
    assert sp.digest(g) == sp.digest(tuple(g))
    assert sp.digest(g) != sp.digest(sp.uniform_genome("ckpt"))
    assert sp.size() == 3 ** 6          # 3 FFN choices × 3 state choices


def test_space_prunes_unsound_policies():
    sp = SERVING_SPACE
    for site, choices in sp.sites:
        assert "dmr" not in choices
        assert "tmr" not in choices     # kept as the reference's space
    g = sp.uniform_genome("tmr")
    assert all(gene == "ckpt" for gene in g)


def test_space_operators_are_seeded_and_valid():
    sp = SERVING_SPACE
    a = sp.random_genome(random.Random(0))
    b = sp.random_genome(random.Random(1))
    assert a == sp.random_genome(random.Random(0))
    child1 = sp.crossover(a, b, random.Random(2))
    child2 = sp.crossover(a, b, random.Random(2))
    assert child1 == child2
    sp.validate(child1)
    sp.validate(sp.mutate(a, random.Random(3), rate=1.0))
    with pytest.raises(ValueError):
        sp.validate(("dmr",) * 6)


def test_shipdet_space_matches_network():
    sp = get_space("shipdet")
    assert sp.site_names == tuple(s.name for s in tshipdet.network_specs())
    assert all(len(c) == 5 for _, c in sp.sites)


@pytest.mark.parametrize("name", SPACES)
@pytest.mark.parametrize("seed", range(5))
def test_genomes_and_digests_equal_reference(name, seed):
    tsp, jsp = get_space(name), jspace.get_space(name)
    assert tsp.sites == jsp.sites
    assert tsp.campaign_sites == jsp.campaign_sites
    tr, jr = random.Random(seed), random.Random(seed)
    for _ in range(20):
        a, b = tsp.random_genome(tr), tsp.random_genome(tr)
        assert (a, b) == (jsp.random_genome(jr), jsp.random_genome(jr))
        c = tsp.crossover(a, b, tr)
        assert c == jsp.crossover(a, b, jr)
        m = tsp.mutate(c, tr, 0.3)
        assert m == jsp.mutate(c, jr, 0.3)
        for g in (a, b, c, m):
            assert tsp.digest(g) == jsp.digest(g)
            assert tsp.to_doc(g) == jsp.to_doc(g)
            assert tsp.to_policy_map(g).to_doc() \
                == jsp.to_policy_map(g).to_doc()
    for u in ("none", "abft", "dmr", "tmr", "ckpt"):
        assert tsp.uniform_genome(u) == jsp.uniform_genome(u)


# ----------------------------------------------------------------- pareto

def _cand(digest, objectives, sdc=0.0, cost=None, uncovered=0):
    cost = objectives[1] if cost is None else cost
    return Candidate(genome=(), digest=digest, fitness=Fitness(
        genes={}, objectives=tuple(objectives), sdc_max=sdc, cost_ms=cost,
        detection_ticks=objectives[2], trials=10, site_rows={},
        uncovered=uncovered))


def test_dominates_and_sort():
    assert dominates((0, 1, 1), (0, 2, 1))
    assert not dominates((0, 1, 1), (0, 1, 1))
    assert not dominates((0, 1, 2), (1, 2, 1))      # trade-off: neither
    cands = [_cand("a", (0.0, 1.0, 1.0)),           # front 0
             _cand("b", (0.0, 2.0, 0.5)),           # front 0 (trade-off)
             _cand("c", (0.0, 2.0, 1.0)),           # dominated by a
             _cand("d", (1.0, 3.0, 2.0))]           # dominated by all
    fronts = non_dominated_sort(cands)
    assert sorted(fronts[0]) == [0, 1]
    assert fronts[1] == [2]
    assert fronts[2] == [3]


def test_crowding_distance_prefers_extremes():
    cands = [_cand(str(i), (0.0, float(i), float(3 - i)))
             for i in range(4)]
    dist = crowding_distance(cands, [0, 1, 2, 3])
    assert dist[0] == float("inf") and dist[3] == float("inf")
    assert dist[1] > 0 and dist[2] > 0


def test_pick_best_is_cheapest_sdc_zero():
    cands = [_cand("cheap_unsafe", (0.3, 0.1, 0.0), sdc=0.3),
             _cand("safe_expensive", (0.1, 2.0, 1.0), sdc=0.0),
             _cand("safe_cheap", (0.1, 1.0, 1.0), sdc=0.0)]
    assert pick_best(cands).digest == "safe_cheap"
    assert pick_best(cands, sdc_budget=-1).digest == "safe_cheap"
    unsafe_only = [c for c in cands if c.fitness.sdc_max > 0]
    assert pick_best(unsafe_only).digest == "cheap_unsafe"
    assert pick_best([]) is None


def test_pick_best_cost_tie_prefers_coverage():
    cands = [_cand("gap", (0.1, 1.0, 0.2), sdc=0.0, uncovered=1),
             _cand("covered", (0.1, 1.0, 0.9), sdc=0.0, uncovered=0)]
    assert pick_best(cands).digest == "covered"
    cands.append(_cand("gap_cheaper", (0.1, 0.5, 0.2), sdc=0.0,
                       uncovered=1))
    assert pick_best(cands).digest == "gap_cheaper"


# ------------------------------------------------------------ cost oracle

def _toy_doc():
    site_ms = {"none": 0.0, "abft": 1.0, "dmr": 2.0, "tmr": 3.0,
               "ckpt": 1.5}
    return {
        "meta": {"device": "cpu"},
        "serving": {
            "n_layers": 2,
            "sites": {s: {"ms": dict(site_ms)} for s in FFN_SITES},
            "scrub": {"storage_verify_ms": 8.0, "storage_checksum_ms": 1.0},
        },
        "shipdet": {"layers": {
            "stem": {"ms": dict(site_ms)},
            "det_head": {"ms": {k: 2 * v for k, v in site_ms.items()}},
        }},
    }


def _toy_cost_model():
    return CostModel(_toy_doc())


def test_cost_predict_monotone_and_amortized():
    cm = _toy_cost_model()
    none = cm.predict("serving", {s: "none" for s in SERVING_SPACE.site_names})
    abft = cm.predict("serving",
                      SERVING_SPACE.genes(SERVING_SPACE.uniform_genome("abft")))
    assert none == 0.0 and abft > none
    base = {s: "none" for s in SERVING_SPACE.site_names}
    w_abft = cm.predict("serving", {**base, "weights": "abft"})
    w_ckpt = cm.predict("serving", {**base, "weights": "ckpt"})
    assert 0 < w_ckpt < w_abft
    assert cm.predict("shipdet", {"stem": "abft", "det_head": "ckpt"}) \
        == pytest.approx(1.0 + 3.0)
    with pytest.raises(KeyError):
        cm.predict("nope", {})


def test_cost_model_roundtrip(tmp_path):
    cm = _toy_cost_model()
    p = cm.save(tmp_path / "cm.json")
    assert CostModel.load(p).doc == cm.doc
    assert CostModel.load(p).device == "cpu"


@pytest.mark.parametrize("name", SPACES)
def test_cost_predict_equals_reference(name):
    """Every uniform genome and 50 random ones, on the reference's
    committed cost model: equal floats."""
    doc = json.loads(REF_COST_MODEL.read_text())
    tcm, jcm = CostModel(doc), jcost.CostModel(doc)
    sp = get_space(name)
    rng = random.Random(11)
    genomes = [sp.uniform_genome(u)
               for u in ("none", "abft", "dmr", "tmr", "ckpt")]
    genomes += [sp.random_genome(rng) for _ in range(50)]
    for g in genomes:
        genes = sp.genes(g)
        assert tcm.predict(name, genes) == jcm.predict(name, genes)


def test_measure_doc_structure_equals_reference():
    """``measure`` at the reference's reduced width, one repetition: the
    same keys, shapes, policy columns and MACs as the reference's
    ``measure`` doc (its committed ``reports/dse/cost_model.json``; the
    times are each device's, and the port adds the device to ``meta``)."""
    t = tcost.measure(reps=1, device="cpu").doc
    j = json.loads(REF_COST_MODEL.read_text())

    def shape(d):
        if isinstance(d, dict):
            return {k: shape(v) for k, v in d.items()}
        return type(d).__name__
    assert set(t["meta"]) == set(j["meta"]) | {"device"}
    assert t["meta"]["device"] == "cpu"
    for space in SPACES:
        assert shape(t[space]) == shape(j[space])
    for site, entry in j["serving"]["sites"].items():
        assert t["serving"]["sites"][site]["shape_mkn"] == entry["shape_mkn"]
    for key in ("arch", "batch", "n_layers"):
        assert t["serving"][key] == j["serving"][key]
    assert t["shipdet"]["reduced"] == j["shipdet"]["reduced"]
    for name, entry in j["shipdet"]["layers"].items():
        assert t["shipdet"]["layers"][name]["macs"] == entry["macs"]


def test_measure_serving_windows_emit_the_same_tokens():
    """Every single-site map's decode window (the oracle's variants)
    emits the unmapped window's tokens and finish masks: the integer FFN
    is exact under every policy."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.models.config import reduced
    cfg = dataclasses.replace(reduced(registry.get("smollm-135m")),
                              quant="w8a8_ffn")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    variants, _ = tcost._windows(cfg, params, batch=8, seed=0, n_steps=4,
                                 device="cpu")
    assert len(variants) == 1 + 3 * 4
    emitted = {k: run(api.init_cache(cfg, 8, tcost.MAX_LEN, device="cpu"))
               for k, run in variants.items()}
    base = emitted[("__base__", "none")]
    assert base.shape == (8, 8)
    for key, e in emitted.items():
        assert torch.equal(e, base), key
    doc = tcost.measure_serving(cfg, reps=1, rounds=1, device="cpu",
                                params=params)
    assert set(doc["sites"]["ffn.wd"]["ms"]) == {
        "none", "abft", "dmr", "tmr", "ckpt"}


# ------------------------------------------------ search loop (stubbed)

class _StubEvaluator:
    """Deterministic analytic fitness: no campaigns, instant evaluate."""

    def __init__(self, space, cost_model, fitness_cls=Fitness):
        self.space = space
        self.cm = cost_model
        self.fitness_cls = fitness_cls
        self.calls = 0

    def evaluate(self, genome):
        self.calls += 1
        genes = self.space.genes(genome)
        unsafe = sum(1 for g in genes.values() if g == "none")
        cost = self.cm.predict(self.space.name, genes)
        return self.fitness_cls(
            genes=genes, objectives=(unsafe / len(genes), cost, 1.0),
            sdc_max=unsafe / len(genes), cost_ms=cost, detection_ticks=1.0,
            trials=1, site_rows={})


def test_search_is_deterministic_and_picks_cheapest_safe():
    cm = _toy_cost_model()
    r1 = search(SERVING_SPACE, _StubEvaluator(SERVING_SPACE, cm),
                generations=4, population=10, seed=7)
    r2 = search(SERVING_SPACE, _StubEvaluator(SERVING_SPACE, cm),
                generations=4, population=10, seed=7)
    assert [c.digest for c in r1.front] == [c.digest for c in r2.front]
    assert r1.best.digest == r2.best.digest
    assert r1.best.fitness.sdc_max == 0.0
    sp = SERVING_SPACE
    corners = [cm.predict("serving", sp.genes(sp.uniform_genome(u)))
               for u in ("abft", "ckpt")]
    assert r1.best.fitness.cost_ms < min(corners)
    assert r1.generations == 4 and r1.evaluations == len(r1.archive)
    assert len(r1.history) == 4


def _both_searches(name, seed):
    doc = _toy_doc()
    if name == "shipdet":
        doc = json.loads(REF_COST_MODEL.read_text())
    tsp, jsp = get_space(name), jspace.get_space(name)
    kw = dict(generations=3, population=8, seed=seed)
    t = tsearch.search(tsp, _StubEvaluator(tsp, CostModel(doc)), **kw)
    j = jsearch.search(jsp, _StubEvaluator(jsp, jcost.CostModel(doc),
                                           jfitness.Fitness), **kw)
    return tsp, jsp, t, j


@pytest.mark.parametrize("name", SPACES)
@pytest.mark.parametrize("seed", [0, 7])
def test_search_equals_reference(name, seed):
    _, _, t, j = _both_searches(name, seed)
    assert [c.digest for c in t.archive] == [c.digest for c in j.archive]
    assert [c.digest for c in t.front] == [c.digest for c in j.front]
    assert t.best.digest == j.best.digest
    assert t.history == j.history
    assert t.to_doc() == j.to_doc()


@pytest.mark.parametrize("name", SPACES)
def test_report_bytes_equal_reference(name, tmp_path):
    tsp, jsp, t, j = _both_searches(name, 3)
    meta = {"seed": 3, "fault_model": "single_bitflip", "trials": 4}
    td = treport.write_pareto(tmp_path / "t", tsp, t, meta=meta)
    jd = jreport.write_pareto(tmp_path / "j", jsp, j, meta=meta)
    assert td == jd
    for f in ("pareto.json", "pareto.md", "best_map.json"):
        assert (tmp_path / "t" / f).read_bytes() \
            == (tmp_path / "j" / f).read_bytes()
    assert treport.render_markdown(tsp, t, meta) \
        == jreport.render_markdown(jsp, j, meta)
    rows = {"weights": {"sdc": 0, "sdc_ci_hi": 0.1, "trials": 12},
            "kv_cache": {"sdc": 1, "sdc_ci_hi": 0.3, "trials": 9}}
    kw = dict(space_name=name, map_doc=tsp.to_policy_map(
        t.best.genome).to_doc(), certify_rows=rows,
        cost={"best_ms": 1.5, "uniform_abft_ms": 2.0, "vs_uniform_abft": 0.75},
        pareto_doc=td, serving={"policy_map_speedup": 1.2})
    assert json.dumps(treport.bench_doc(**kw), sort_keys=True) \
        == json.dumps(jreport.bench_doc(**kw), sort_keys=True)
    assert treport.bench_doc(**{**kw, "certify_rows": {}})["certify"] \
        == jreport.bench_doc(**{**kw, "certify_rows": {}})["certify"]


# ------------------------------------ evaluator memoization (integration)

def test_evaluator_memoizes_per_site_policy():
    from repro_torch.campaign.stats import SamplingPlan
    cm = _toy_cost_model()
    ev = Evaluator(SERVING_SPACE, cm, seed=0, trials=4,
                   plan=SamplingPlan(chunk=4, min_trials=4), device="cpu")
    g1 = SERVING_SPACE.uniform_genome("abft")
    f1 = ev.evaluate(g1)
    ran_after_first = ev.campaigns_run
    assert ran_after_first == 4          # 3 state sites + 1 kernel row
    assert f1.trials > 0
    assert ev.evaluate(g1) is f1
    g2 = list(g1)
    g2[SERVING_SPACE.site_names.index("weights")] = "ckpt"
    ev.evaluate(tuple(g2))
    assert ev.campaigns_run == ran_after_first + 1      # only weights/ckpt


def test_mapped_engine_clean_streams_equal_unmapped():
    """The memo's premise: an engine with any FFN map serves the unmapped
    engine's clean streams, bit for bit."""
    base = MapServingCase(0, device="cpu")
    golden = base._run_engine(base.params)
    for policy in ("abft", "ckpt", "dmr", "tmr"):
        pm = PolicyMap(rules=tuple(PolicyRule(s, Policy(policy))
                                   for s in FFN_SITES), default=Policy.NONE)
        case = MapServingCase(0, policy_map=pm, device="cpu")
        assert case._run_engine(case.params) == golden, policy


# ------------------------------- mapped shipdet, trial by trial, addressed

_SEED_BITS, _IDX_BITS = 6, 34         # seed = layer | index | bit


def _rows(seed, n, layers):
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(0, layers, n), rng.integers(0, 2**30, n),
                     rng.integers(0, 32, n)], axis=1)
    rows[:4, 2] = [31, 30, 7, 0]
    return rows.astype(np.int32)


def _seeds(rows):
    return [(int(l) << (_IDX_BITS + _SEED_BITS)) | (int(i) << _SEED_BITS)
            | int(b) for l, i, b in rows]


def _decode(seed):
    return (seed >> (_IDX_BITS + _SEED_BITS),
            (seed >> _SEED_BITS) & ((1 << _IDX_BITS) - 1),
            seed & ((1 << _SEED_BITS) - 1))


def j_fault(x, key):
    """The reference side: flip bit ``key[2] % width`` of flat element
    ``key[1] % size``."""
    bits, u = jfi._as_bits(x)
    flat = bits.reshape(-1)
    width = x.dtype.itemsize * 8
    idx = key[1] % flat.shape[0]
    mask = (jnp.ones((), u) << (key[2] % width).astype(u)).astype(u)
    flat = flat.at[idx].set(flat[idx] ^ mask)
    return jax.lax.bitcast_convert_type(flat.reshape(x.shape), x.dtype)


def t_fault(x, gen):
    """The port side: the same cell, read back from the trial's seed."""
    _, idx, bit = _decode(gen.initial_seed())
    return tfi.flip_bit_at_index(x, idx % x.numel(),
                                 bit % (x.element_size() * 8))


def _j_leaf_injector(leaves, key, fault):
    leaves = list(leaves)
    leaves[int(key[0])] = fault(leaves[int(key[0])], key)
    return leaves


def _t_leaf_injector(leaves, gen, fault):
    leaves = list(leaves)
    leaf = _decode(gen.initial_seed())[0]
    leaves[leaf] = fault(leaves[leaf], gen)
    return leaves


MAPS = {"mixed": ("none", "abft", "dmr", "tmr", "ckpt", "none", "abft",
                  "ckpt"),
        "cheap": ("dmr", "none", "tmr", "none", "dmr", "tmr", "none",
                  "abft")}


@pytest.mark.parametrize("site", ["accumulator", "weights"])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_map_shipdet_trials_equal_reference(monkeypatch, name, site):
    genome = MAPS[name]
    jcase = jfitness.MapShipdetCase(
        jax.random.key(0), policy_map=jspace.get_space(
            "shipdet").to_policy_map(genome))
    tcase = MapShipdetCase(0, policy_map=get_space("shipdet").to_policy_map(
        genome), device="cpu")
    tcase.params = shipdet_params_from_numpy(jax.device_get(jcase.params),
                                             device="cpu")
    tcase.x = torch.from_numpy(np.array(jax.device_get(jcase.x)))
    tcase.w_checks = tshipdet.deploy_checks(tcase.params)
    tcase.golden_wq = tshipdet.golden_weights(tcase.params)
    # the same addressed (layer, cell, bit) per trial: the reference draws
    # its strike layer from the key's first entry, the port from the seed
    monkeypatch.setattr(jfitness, "jax", types.SimpleNamespace(
        jit=jax.jit, random=types.SimpleNamespace(
            fold_in=lambda k, d: k, randint=lambda k, shape, lo, hi: k[0])))
    monkeypatch.setattr(MapShipdetCase, "strike_layer",
                        lambda self, gen: _decode(gen.initial_seed())[0])
    monkeypatch.setattr(jfl, "inject_pytree_with", _j_leaf_injector)
    monkeypatch.setattr(tfi, "inject_pytree_with", _t_leaf_injector)
    rows = _rows(zlib.crc32(f"{name}/{site}".encode()), 8, len(jcase.specs))
    with jax.disable_jit():
        d_j, m_j = jcase.run_trials(None, site, j_fault, jnp.asarray(rows))
    d_t, m_t = tcase.run_trials(None, site, t_fault, _seeds(rows))
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(m_t, np.asarray(m_j))


def test_map_shipdet_strike_layer_is_the_first_draw():
    case = MapShipdetCase(0, device="cpu")
    seen = {case.strike_layer(torch.Generator().manual_seed(s))
            for s in range(64)}
    assert seen == set(range(len(case.specs)))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    layer = case.strike_layer(g1)
    assert layer == int(torch.randint(0, len(case.specs), (), generator=g2))
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))


# ------------------ the port's addressed weight rows (see dse/fitness.py)

SHIPDET_SPACE = get_space("shipdet")


def _shipdet_genome(**genes):
    """Uniform ABFT, but for ``genes``."""
    g = {**SHIPDET_SPACE.genes(SHIPDET_SPACE.uniform_genome("abft")),
         **genes}
    return tuple(g[s] for s in SHIPDET_SPACE.site_names)


@pytest.mark.parametrize("layer", ["stem", "det_head"])
def test_map_shipdet_addressed_weights_strike_that_layer(layer):
    """``weights:<layer>`` strikes that layer's ``w_q`` alone: every fault
    lands in a leaf of its shape, and under uniform ABFT the deploy-time
    checksums detect every strike that reaches the output (a weight whose
    input channel is all zero is masked)."""
    case = MapShipdetCase(0, policy_map=SHIPDET_SPACE.to_policy_map(
        _shipdet_genome()), device="cpu")
    names = [s.name for s in case.specs]
    want = tuple(case.params[names.index(layer)]["qconv"].w_q.shape)
    seen = []

    def fault(x, gen):
        seen.append(tuple(x.shape))
        return tfi.flip_one_bit(x, gen)
    detected, mismatch = case.run_trials(None, f"weights:{layer}", fault,
                                         range(8))
    assert seen == [want] * 8
    assert detected.any() and not (mismatch & ~detected).any()


def test_evaluator_shows_unguarded_layer_weights():
    """DMR at the stem, which holds 0.4 % of the weights, leaves them
    unchecked: its addressed row shows the SDC that the uniform weights
    campaign rarely draws, and is memoized per (layer, policy); a map that
    checks every layer's weights gets no such row."""
    from repro_torch.campaign.stats import SamplingPlan
    cm = CostModel(json.loads(REF_COST_MODEL.read_text()))
    ev = Evaluator(SHIPDET_SPACE, cm, seed=0, trials=8,
                   plan=SamplingPlan(chunk=8, min_trials=8), device="cpu")
    safe = ev.evaluate(_shipdet_genome())
    assert set(safe.site_rows) == set(SHIPDET_SPACE.campaign_sites)
    assert safe.sdc_max == 0.0
    ran = ev.campaigns_run
    f1 = ev.evaluate(_shipdet_genome(stem="dmr"))
    assert set(f1.site_rows) == {*SHIPDET_SPACE.campaign_sites,
                                 "weights:stem"}
    assert f1.site_rows["weights:stem"]["sdc"] > 0 and f1.sdc_max > 0
    assert ev.campaigns_run == ran + 3
    f2 = ev.evaluate(_shipdet_genome(stem="dmr", det_head="ckpt"))
    assert ev.campaigns_run == ran + 5          # the stem's row is reused
    assert f2.site_rows["weights:stem"] == f1.site_rows["weights:stem"]


# -------------------------------------------------------------------- CLI

def _cli(argv):
    return cli.main(argv + ["--device", "cpu"])


def test_cli_measure_search_certify(tmp_path, capsys):
    out = str(tmp_path / "dse")
    assert _cli(["measure", "--out", out, "--reps", "1"]) == 0
    cm = CostModel.load(pathlib.Path(out) / "cost_model.json")
    assert cm.device == "cpu" and set(cm.doc) >= {"serving", "shipdet"}
    for space in SPACES:
        assert _cli(["search", "--space", space, "--out", out,
                     "--generations", "1", "--population", "4",
                     "--trials", "4", "--ci-halfwidth", "0"]) == 0
        pareto = json.loads((pathlib.Path(out) / "pareto.json").read_text())
        assert pareto["space"] == space and pareto["best"] is not None
        bench = tmp_path / f"BENCH_{space}.json"
        rc = _cli(["certify", "--space", space, "--out", out,
                   "--trials", "4", "--bench-out", str(bench)])
        doc = json.loads(bench.read_text())
        uniform = get_space(space).genes(
            get_space(space).uniform_genome("abft"))
        cheaper = (doc["cost"]["best_ms"] < doc["cost"]["uniform_abft_ms"]
                   or doc["policy_map"] == get_space(space).to_policy_map(
                       tuple(uniform.values())).to_doc())
        assert rc == (0 if doc["certify"]["sdc_max"] == 0 and cheaper else 1)
        assert doc["certify"]["trials"] == 4 * len(
            get_space(space).campaign_sites)
    assert "certified: sdc_max=" in capsys.readouterr().out


def test_cli_refuses_a_cost_model_of_another_device(tmp_path):
    assert cli.DEFAULT_OUT != "reports/dse"
    args = cli.build_parser().parse_args(["search"])
    assert args.out == "reports/dse_torch" and args.device == "cuda" \
        and args.backend == "cuda"
    SERVING_SPACE.to_policy_map(SERVING_SPACE.uniform_genome("abft")).save(
        tmp_path / "best_map.json")
    foreign = tmp_path / "foreign.json"
    CostModel({**_toy_doc(), "meta": {"device": "TPU v5 lite"}}).save(foreign)
    with pytest.raises(SystemExit, match="measured on 'TPU v5 lite'"):
        _cli(["certify", "--space", "serving", "--out", str(tmp_path),
              "--cost-model", str(foreign)])
    # the reference's committed cost model records no device at all
    with pytest.raises(SystemExit, match="records no device"):
        _cli(["search", "--out", str(tmp_path), "--cost-model",
              str(REF_COST_MODEL)])
