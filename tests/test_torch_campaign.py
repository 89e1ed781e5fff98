"""The port's SEU campaign (``repro_torch.campaign``) on the CPU: the cases
of ``tests/test_campaign.py`` over the five workloads the port runs
(``qmatmul``, ``qconv2d``, ``flashattn``, ``shipdet``, ``transformer``).

The paper-level invariants the campaign must certify empirically:
  * ABFT detects 100% of single accumulator bit-flips (exact mod-2^32
    checksum — zero false negatives) over hundreds of seeded trials.
  * TMR's bitwise majority vote yields zero SDC for any single-replica
    corruption, at every injection site; DMR detects exactly the faults
    that manifest and corrects none.
  * CKPT heals the weight-memory SEUs ABFT can only flag.
  * A campaign is a pure function of its spec + seed (bit-exact replay).
  * Reports round-trip through JSON.

The reference's fleet cases wait for ROADMAP item 14; their names raise
``NotImplementedError`` here (the serving cases are held in
``test_torch_serving_campaign.py``).  Every case runs on the
CPU (``device="cpu"``), where the ``cuda`` backend's wrappers run their
kernels' plain versions.  The float ``flashattn`` workload is held against
the reference by verdict here; the integer workloads trial by trial in
``test_torch_campaign_parity.py``."""
from __future__ import annotations

import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.campaign import faultload as jfl
from repro.campaign import report as jreport
from repro.campaign import runner as jrunner
from repro.core import fault_injection as jfi
from repro.core.dependability import Policy as JPolicy
from repro_torch import tree
from repro_torch.campaign import (
    CampaignSpec, ConfigResult, build_case, classify_counts, expand_grid,
    load_report, resolve_fault_model, run_campaign, trial_seed, trial_seeds,
    write_report)
from repro_torch.campaign import cli
from repro_torch.campaign import faultload as fl
from repro_torch.campaign.runner import (ACC_BITS, NOT_YET, SUPPORTED,
                                         kernel_workloads, run_bit_sweep)
from repro_torch.core import fault_injection as tfi
from repro_torch.core.dependability import Policy
from repro_torch.models import api as model_api

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
_CASES: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Trials are many small ops: one intra-op thread keeps them from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(workload, seed=0, backend="cuda"):
    key = (workload, seed, backend)
    if key not in _CASES:
        _CASES[key] = build_case(workload, seed, backend, device=CPU)
    return _CASES[key]


def _run_spec(spec: CampaignSpec):
    case = _case(spec.workload, spec.seed, spec.backend)
    fault = resolve_fault_model(spec.fault_model)
    return case.run_trials(spec.policy, spec.site, fault.apply,
                           trial_seeds(spec))


# ---------------------------------------------------------------------------
# (a) ABFT zero-false-negative claim, empirically
# ---------------------------------------------------------------------------


def test_abft_detects_all_accumulator_bitflips_200_trials():
    spec = CampaignSpec("qmatmul", Policy.ABFT, "accumulator",
                        "single_bitflip", trials=200, seed=0)
    detected, mismatch = _run_spec(spec)
    assert detected.shape == (200,)
    assert detected.all(), "ABFT missed an accumulator bit flip"
    assert not mismatch.any(), "ABFT recovery did not restore the golden output"


def test_none_policy_has_nonzero_sdc():
    spec = CampaignSpec("qmatmul", Policy.NONE, "accumulator",
                        "single_bitflip", trials=200, seed=0)
    detected, mismatch = _run_spec(spec)
    assert not detected.any()
    assert mismatch.any(), "expected some silent corruption under Policy.NONE"


# ---------------------------------------------------------------------------
# (b) TMR corrects any single-replica corruption; DMR detects, never heals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["accumulator", "weights", "activations"])
def test_tmr_zero_sdc_every_site(site):
    spec = CampaignSpec("qmatmul", Policy.TMR, site, "single_bitflip",
                        trials=100, seed=1)
    counts = classify_counts(*_run_spec(spec))
    assert counts["sdc"] == 0
    assert counts["detected_uncorrected"] == 0
    assert counts["detected_corrected"] + counts["masked"] == 100


@pytest.mark.parametrize("site", ["accumulator", "weights", "activations"])
def test_dmr_detects_every_manifested_fault_but_corrects_none(site):
    spec = CampaignSpec("qmatmul", Policy.DMR, site, "single_bitflip",
                        trials=100, seed=2)
    detected, mismatch = _run_spec(spec)
    counts = classify_counts(detected, mismatch)
    assert counts["sdc"] == 0
    assert counts["detected_corrected"] == 0
    assert counts["detected_uncorrected"] > 0
    np.testing.assert_array_equal(detected, mismatch)


# ---------------------------------------------------------------------------
# (c) determinism and the seed stream
# ---------------------------------------------------------------------------


def test_trial_classification_deterministic_for_fixed_seed():
    spec = CampaignSpec("qmatmul", Policy.NONE, "accumulator",
                        "single_bitflip", trials=64, seed=7)
    d1, m1 = _run_spec(spec)
    d2, m2 = _run_spec(spec)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(m1, m2)
    other = CampaignSpec("qmatmul", Policy.NONE, "accumulator",
                         "single_bitflip", trials=64, seed=8)
    d3, m3 = _run_spec(other)
    assert not (np.array_equal(m1, m3) and np.array_equal(d1, d3)), \
        "different seeds must draw different faultloads"


def test_trial_seeds_differ_across_configurations():
    a = trial_seeds(CampaignSpec("qmatmul", Policy.NONE, "accumulator",
                                 "single_bitflip", 8, seed=0))
    b = trial_seeds(CampaignSpec("qmatmul", Policy.ABFT, "accumulator",
                                 "single_bitflip", 8, seed=0))
    assert len(a) == len(b) == 8 and not set(a) & set(b)
    assert len(set(a)) == 8


def test_trial_seeds_are_a_pure_function_of_seed_label_and_index():
    """Any slice draws what the whole stream draws there (resume, shards,
    adaptive prefixes), whatever the cap; each seed fits a generator."""
    spec = CampaignSpec("shipdet", Policy.TMR, "weights", "single_bitflip",
                        40, seed=3)
    full = trial_seeds(spec)
    assert trial_seeds(spec, 10, 25) == full[10:25]
    longer = CampaignSpec("shipdet", Policy.TMR, "weights",
                          "single_bitflip", 100, seed=3)
    assert trial_seeds(longer)[:40] == full
    assert full[7] == trial_seed(3, spec.label(), 7)
    assert all(0 <= s < 2**63 for s in full)
    torch.Generator().manual_seed(max(full))


# ---------------------------------------------------------------------------
# (d) report round-trip
# ---------------------------------------------------------------------------


def test_report_json_round_trip(tmp_path):
    specs = expand_grid(["qmatmul"], [Policy.NONE, Policy.ABFT],
                        ["accumulator"], ["single_bitflip", "stuck_at1"],
                        trials=16, seed=0, supported=SUPPORTED)
    results = run_campaign(specs, device=CPU)
    assert len(results) == 4
    meta = {"seed": 0, "trials_per_config": 16}
    jpath, mpath = write_report(results, tmp_path, meta)
    meta2, results2 = load_report(jpath)
    assert meta2["seed"] == 0
    assert results2 == list(results)
    for orig, rt in zip(results, results2):
        assert rt.detection_rate == orig.detection_rate
        assert rt.coverage == orig.coverage
    assert "| workload |" in mpath.read_text()


def test_config_result_rates():
    r = ConfigResult("w", "none", "s", "m", trials=10, masked=4,
                     detected_corrected=3, detected_uncorrected=1, sdc=2)
    assert r.detection_rate == pytest.approx(0.4)
    assert r.sdc_rate == pytest.approx(0.2)
    assert r.coverage == pytest.approx(0.8)


def test_stuck_at_intrinsic_masking_in_campaign():
    spec = CampaignSpec("qmatmul", Policy.ABFT, "accumulator", "stuck_at1",
                        trials=200, seed=3)
    detected, _ = _run_spec(spec)
    assert 0.25 < detected.mean() < 0.95, detected.mean()


# ---------------------------------------------------------------------------
# per-bit-position accumulator coverage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["qmatmul", "qconv2d"])
def test_bit_sweep_separates_masked_and_detected_bits(workload):
    """Requantization (scale 1e-3) rounds away bit 0, the sign bit always
    corrupts silently under NONE, and ABFT detects the targeted flip at
    every bit position."""
    rows = run_bit_sweep(workload, [Policy.NONE, Policy.ABFT],
                         trials_per_bit=4, seed=0, case=_case(workload))
    assert len(rows) == 2 * ACC_BITS
    none = {r.bit: r for r in rows if r.policy == "none"}
    abft = {r.bit: r for r in rows if r.policy == "abft"}
    assert none[0].masked == 4 and none[0].sdc == 0
    assert none[31].sdc == 4
    assert all(r.detection_rate == 1.0 for r in abft.values())
    assert all(r.sdc == 0 for r in abft.values())


def test_bit_sweep_rejects_model_workloads():
    with pytest.raises(ValueError) as ei:
        run_bit_sweep("transformer", [Policy.NONE], trials_per_bit=1,
                      device=CPU)
    msg = str(ei.value)
    assert "'transformer'" in msg
    for w in kernel_workloads():
        assert w in msg
    assert kernel_workloads() == ["flashattn", "qconv2d", "qmatmul"]
    with pytest.raises(KeyError, match="unknown workload"):
        run_bit_sweep("nope", [Policy.NONE], trials_per_bit=1, device=CPU)
    with pytest.raises(ValueError, match="'serving'"):
        run_bit_sweep("serving", [Policy.NONE], trials_per_bit=1,
                      device=CPU)
    with pytest.raises(NotImplementedError, match="item 14"):
        run_bit_sweep("fleet", [Policy.NONE], trials_per_bit=1,
                      device=CPU)


def test_backend_axis_in_grid_and_report(tmp_path):
    """One sweep over three backends: rows carry the backend, labels (and
    so the seed streams) stay unchanged for the default backend."""
    specs = expand_grid(["qmatmul"], [Policy.ABFT], ["accumulator"],
                        ["single_bitflip"], trials=8, seed=0,
                        supported=SUPPORTED,
                        backends=["cuda", "torch", "ref"])
    assert [s.backend for s in specs] == ["cuda", "torch", "ref"]
    assert specs[0].label() == "qmatmul/abft/accumulator/single_bitflip"
    assert specs[1].label().endswith("/torch")
    results = run_campaign(specs, device=CPU)
    assert [r.backend for r in results] == ["cuda", "torch", "ref"]
    assert all(r.detection_rate == 1.0 for r in results)
    jpath, _ = write_report(results, tmp_path, {"seed": 0})
    _, rt = load_report(jpath)
    assert [r.backend for r in rt] == ["cuda", "torch", "ref"]
    with pytest.raises(KeyError, match="unknown backend"):
        expand_grid(["qmatmul"], [Policy.ABFT], ["accumulator"],
                    ["single_bitflip"], 8, backends=["pallas"])


@pytest.mark.parametrize("workload,policy,site", [
    ("qmatmul", Policy.ABFT, "accumulator"),
    ("qmatmul", Policy.CKPT, "weights"),
    ("qmatmul", Policy.NONE, "activations"),
    ("qconv2d", Policy.ABFT, "accumulator"),
    ("qconv2d", Policy.TMR, "weights"),
    ("qconv2d", Policy.CKPT, "activations"),
])
def test_integer_trials_equal_on_every_backend(workload, policy, site):
    """The same seeds strike the same cells whatever runs the op: on the
    integer workloads the trial arrays are equal under torch, ref and
    cuda."""
    seeds = trial_seeds(CampaignSpec(workload, policy, site,
                                     "single_bitflip", 40))
    fault = resolve_fault_model("single_bitflip").apply
    got = [_case(workload, 0, be).run_trials(policy, site, fault, seeds)
           for be in ("cuda", "torch", "ref")]
    for d, m in got[1:]:
        np.testing.assert_array_equal(d, got[0][0])
        np.testing.assert_array_equal(m, got[0][1])


# ---------------------------------------------------------------------------
# CLI end-to-end
# ---------------------------------------------------------------------------


def _cli(tmp_path, *extra):
    return cli.main([
        "--workload", "qmatmul", "--policies", "none,abft",
        "--sites", "accumulator", "--fault-models", "single_bitflip",
        "--trials", "32", "--bit-trials", "2", "--seed", "0",
        "--device", "cpu", "--out", str(tmp_path), "--quiet", *extra])


def test_cli_writes_reports(tmp_path):
    assert _cli(tmp_path) == 0
    meta, results = load_report(tmp_path / "campaign.json")
    assert meta["configurations"] == 2
    assert meta["backends"] == "cuda" and meta["device"] == "cpu"
    abft = [r for r in results if r.policy == "abft"][0]
    none = [r for r in results if r.policy == "none"][0]
    assert abft.detection_rate == 1.0
    assert none.sdc_rate > 0.0
    md = (tmp_path / "campaign.md").read_text()
    assert "Accumulator bit-position coverage" in md
    bits = json.loads((tmp_path / "campaign.json").read_text())["bit_coverage"]
    assert len(bits) == 2 * 32
    assert {b["policy"] for b in bits} == {"none", "abft"}


def test_cli_same_seed_identical_results(tmp_path):
    assert _cli(tmp_path / "a", "--no-journal") == 0
    assert _cli(tmp_path / "b", "--no-journal") == 0
    a = json.loads((tmp_path / "a" / "campaign.json").read_text())
    b = json.loads((tmp_path / "b" / "campaign.json").read_text())
    assert a["results"] == b["results"]
    assert a["bit_coverage"] == b["bit_coverage"]
    assert not (tmp_path / "a" / "journal").exists()


def test_cli_defaults_are_the_card_and_the_port_report_dir():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.backend == "cuda"
    assert args.out == "reports/campaign_torch"


def test_cli_without_a_card_raises_and_does_not_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--workload", "qmatmul", "--trials", "2",
                  "--out", str(tmp_path), "--quiet"])
    assert not (tmp_path / "campaign.json").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_case("qmatmul")


@pytest.mark.parametrize("workload", sorted(NOT_YET))
def test_engine_workloads_name_their_item(workload, tmp_path):
    assert sorted(NOT_YET) == ["fleet", "fleet_mp"]
    item = "14"
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        build_case(workload, device=CPU)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        run_campaign([CampaignSpec(workload, Policy.NONE, "weights",
                                   "single_bitflip", 2)], device=CPU)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        cli.main(["--workload", workload, "--device", "cpu", "--quiet",
                  "--out", str(tmp_path)])


# ---------------------------------------------------------------------------
# (e) CKPT policy axis + recovery columns
# ---------------------------------------------------------------------------


def test_ckpt_detects_and_recovers_all_accumulator_bitflips():
    spec = CampaignSpec("qmatmul", Policy.CKPT, "accumulator",
                        "single_bitflip", trials=200, seed=0)
    detected, mismatch = _run_spec(spec)
    assert detected.all(), "CKPT checksum missed an accumulator bit flip"
    assert not mismatch.any(), "CKPT rollback did not restore golden output"


def test_ckpt_heals_weight_site_where_abft_cannot():
    ck = classify_counts(*_run_spec(CampaignSpec(
        "qmatmul", Policy.CKPT, "weights", "single_bitflip", 50, seed=0)))
    ab = classify_counts(*_run_spec(CampaignSpec(
        "qmatmul", Policy.ABFT, "weights", "single_bitflip", 50, seed=0)))
    assert ck["sdc"] == 0 and ab["sdc"] == 0
    assert ck["detected_corrected"] == 50
    assert ab["detected_uncorrected"] == 50


def test_ckpt_activations_blind_spot_is_honest():
    counts = classify_counts(*_run_spec(CampaignSpec(
        "qmatmul", Policy.CKPT, "activations", "single_bitflip", 50, seed=0)))
    assert counts["detected_corrected"] == 0
    assert counts["sdc"] > 0


def test_recovery_columns_in_report(tmp_path):
    specs = expand_grid(["qmatmul"], [Policy.CKPT], ["accumulator"],
                        ["single_bitflip"], trials=16, seed=0,
                        supported=SUPPORTED)
    results = run_campaign(specs, device=CPU)
    assert len(results) == 1
    r = results[0]
    assert r.faults_recovered == r.detected_corrected == 16
    jpath, mpath = write_report(results, tmp_path, {"seed": 0})
    _, rt = load_report(jpath)
    assert rt[0].faults_recovered == 16
    assert "recovered" in mpath.read_text()


def test_expanded_sites_registry():
    assert "kv_cache" in fl.SITES and "decode_state" in fl.SITES
    specs = expand_grid(["qmatmul"], [Policy.CKPT], ["kv_cache"],
                        ["single_bitflip"], trials=2, seed=0,
                        supported=SUPPORTED)
    assert run_campaign(specs, device=CPU) == []


# ---------------------------------------------------------------------------
# (f) qconv2d and the ship detector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", [Policy.ABFT, Policy.CKPT])
def test_qconv2d_accumulator_covered(policy):
    spec = CampaignSpec("qconv2d", policy, "accumulator", "single_bitflip",
                        trials=100, seed=0)
    detected, mismatch = _run_spec(spec)
    assert detected.all() and not mismatch.any()


@pytest.mark.parametrize("policy", [Policy.ABFT, Policy.CKPT])
def test_shipdet_accumulator_zero_sdc(policy):
    counts = classify_counts(*_run_spec(CampaignSpec(
        "shipdet", policy, "accumulator", "single_bitflip", 20, seed=0)))
    assert counts["sdc"] == 0
    assert counts["detected_uncorrected"] == 0


def test_shipdet_weights_site_covered_by_deploy_checks():
    """ABFT layers verify live weights against the deploy-time checksums
    (detect, zero SDC), CKPT layers additionally roll back to the golden
    weights (heal); NONE is the undefended baseline."""
    det, mis = _run_spec(CampaignSpec("shipdet", Policy.ABFT, "weights",
                                      "single_bitflip", 20, seed=0))
    counts = classify_counts(det, mis)
    assert counts["sdc"] == 0
    assert counts["detected_uncorrected"] + counts["detected_corrected"] > 0
    assert not np.logical_and(~det, mis).any()

    counts = classify_counts(*_run_spec(CampaignSpec(
        "shipdet", Policy.CKPT, "weights", "single_bitflip", 20, seed=0)))
    assert counts["sdc"] == 0
    assert counts["detected_uncorrected"] == 0
    assert counts["detected_corrected"] > 0

    counts = classify_counts(*_run_spec(CampaignSpec(
        "shipdet", Policy.NONE, "weights", "single_bitflip", 20, seed=0)))
    assert counts["sdc"] > 0


def test_shipdet_tmr_activations_zero_sdc():
    counts = classify_counts(*_run_spec(CampaignSpec(
        "shipdet", Policy.TMR, "activations", "single_bitflip", 12, seed=1)))
    assert counts["sdc"] == 0 and counts["detected_uncorrected"] == 0


# ---------------------------------------------------------------------------
# (g) the float attention workload
# ---------------------------------------------------------------------------


def test_flashattn_abft_detects_all_output_bitflips():
    spec = CampaignSpec("flashattn", Policy.ABFT, "accumulator",
                        "single_bitflip", trials=60, seed=0)
    detected, mismatch = _run_spec(spec)
    assert detected.all(), "flashattn ABFT missed an output bit flip"
    assert not mismatch.any(), "flashattn ABFT recovery left a corrupt row"


def test_flashattn_none_policy_has_nonzero_sdc():
    spec = CampaignSpec("flashattn", Policy.NONE, "accumulator",
                        "single_bitflip", trials=60, seed=0)
    detected, mismatch = _run_spec(spec)
    assert not detected.any()
    assert mismatch.any()


def test_flashattn_tmr_covers_operand_site():
    spec = CampaignSpec("flashattn", Policy.TMR, "activations",
                        "single_bitflip", trials=30, seed=1)
    assert classify_counts(*_run_spec(spec))["sdc"] == 0


# ---------------------------------------------------------------------------
# flashattn against the reference: float, so held by verdict
# ---------------------------------------------------------------------------


def _verdict(policy, site, det, mis):
    det, mis = np.asarray(det, bool), np.asarray(mis, bool)
    counts = jreport.classify_counts(det, mis)
    if policy == "none":
        return ("none", bool(det.any()), counts["sdc"] > 0)
    if policy == "dmr":
        return ("dmr", bool(np.array_equal(det, mis)),
                counts["detected_corrected"])
    if policy in ("abft", "ckpt") and site == "accumulator":
        return (policy, bool(det.all()), counts["sdc"])
    return (policy, counts["sdc"] == 0 if policy == "tmr"
            else counts["sdc"] > 0)


@pytest.mark.parametrize("site", ["accumulator", "activations"])
@pytest.mark.parametrize("policy", ["none", "abft", "dmr", "tmr", "ckpt"])
def test_flashattn_verdicts_equal_reference(policy, site):
    n = 40
    jcase = jrunner.build_case("flashattn", 0)
    jspec = jfl.CampaignSpec("flashattn", JPolicy(policy), site,
                             "single_bitflip", n)
    with jax.disable_jit():
        d_j, m_j = jcase.run_trials(JPolicy(policy), site, jfi.flip_one_bit,
                                    jfl.trial_keys(jspec))
    spec = CampaignSpec("flashattn", Policy(policy), site, "single_bitflip",
                        n)
    d_t, m_t = _case("flashattn").run_trials(Policy(policy), site,
                                             tfi.flip_one_bit,
                                             trial_seeds(spec))
    assert _verdict(policy, site, d_t, m_t) \
        == _verdict(policy, site, d_j, m_j)


# ---------------------------------------------------------------------------
# (h) the transformer workload and its embeddings input
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["weights", "activations"])
def test_transformer_tmr_dmr_verdicts(site):
    tmr = classify_counts(*_run_spec(CampaignSpec(
        "transformer", Policy.TMR, site, "single_bitflip", 12, seed=0)))
    assert tmr["sdc"] == 0 and tmr["detected_uncorrected"] == 0
    det, mis = _run_spec(CampaignSpec(
        "transformer", Policy.DMR, site, "single_bitflip", 12, seed=0))
    np.testing.assert_array_equal(det, mis)


def test_transformer_none_activations_has_sdc():
    counts = classify_counts(*_run_spec(CampaignSpec(
        "transformer", Policy.NONE, "activations", "single_bitflip", 12,
        seed=0)))
    assert counts["sdc"] > 0 and counts["detected_corrected"] == 0


def test_transformer_embeds_replace_the_token_embedding():
    """``embeds`` is the lookup's stand-in: the same values give the same
    logits, caches and decode steps, bit for bit."""
    case = _case("transformer")
    cfg, params, tokens = case.cfg, case.params, case.tokens
    embeds = params["embed"][tokens.long()]
    a = model_api.forward(cfg, params, tokens).logits
    b = model_api.forward(cfg, params, None, embeds=embeds).logits
    assert torch.equal(a, b)
    la, ca = model_api.prefill(cfg, params, tokens, 24)
    lb, cb = model_api.prefill(cfg, params, None, 24, embeds=embeds)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y)
               for x, y in zip(tree.leaves(ca), tree.leaves(cb)))
    nxt = torch.argmax(la[:, -1], dim=-1)
    da, _ = model_api.decode_step(cfg, params, nxt, ca)
    db, _ = model_api.decode_step(cfg, params, None, cb,
                                  embed=params["embed"][nxt])
    assert torch.equal(da, db)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import jax|from jax|(from|import) repro"
                         r"(\.| |$))")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    hits = [f"{p}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []
