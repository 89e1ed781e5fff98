"""The port's adaptive campaign engine: the cases of
``tests/test_campaign_adaptive.py`` over the port's workloads, on the CPU.

  * the sequential sampler reaches the fixed-budget verdicts with fewer
    trials, on an exact prefix of the seed stream;
  * sharded execution (two spawned workers) is bit-identical to serial —
    same counts, same CI columns, same timeline columns;
  * a killed campaign resumes from its crash-consistent journal and ends
    bit-identical to an uninterrupted run; a record of another spec or of
    another seed-stream scheme (the reference's journals) is discarded;
  * the mbu_burst fault model injects seeded clusters of adjacent cells,
    and TMR's majority vote still yields zero SDC against them."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.campaign import (
    CampaignInterrupted, CampaignJournal, CampaignPool, CampaignSpec,
    ChunkOutcome, ConfigResult, SamplingPlan, binomial_interval,
    clopper_pearson_interval, halfwidth, load_report, resolve_fault_model,
    run_campaign, wilson_interval, write_report)
from repro_torch.campaign import cli
from repro_torch.campaign import engine as engine_mod
from repro_torch.campaign import faultload as fl
from repro_torch.campaign import runner
from repro_torch.core.dependability import Policy
from repro_torch.obs.events import Event

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Trials are many small ops: one intra-op thread keeps them from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) interval math — dependency-free binomial CIs
# ---------------------------------------------------------------------------


def test_wilson_interval_basics():
    lo, hi = wilson_interval(0, 25, 0.95)
    assert lo == 0.0 and 0.0 < hi < 0.25
    lo1, hi1 = wilson_interval(25, 25, 0.95)
    assert hi1 == 1.0 and 0.75 < lo1 < 1.0
    lo2, hi2 = wilson_interval(5, 50, 0.95)
    lo3, hi3 = wilson_interval(45, 50, 0.95)
    assert lo2 == pytest.approx(1.0 - hi3) and hi2 == pytest.approx(1.0 - lo3)
    assert halfwidth(wilson_interval(0, 400)) < halfwidth(wilson_interval(0, 25))


def test_clopper_pearson_matches_closed_form_at_boundary():
    for n in (10, 25, 100):
        lo, hi = clopper_pearson_interval(0, n, 0.95)
        assert lo == 0.0
        assert hi == pytest.approx(1.0 - 0.025 ** (1.0 / n), abs=1e-9)
    lo, hi = clopper_pearson_interval(25, 25, 0.95)
    assert hi == 1.0
    assert lo == pytest.approx(0.025 ** (1.0 / 25), abs=1e-9)


def test_clopper_pearson_is_wider_than_wilson():
    for k, n in ((0, 25), (1, 25), (3, 50), (10, 100), (50, 100), (99, 100)):
        w = wilson_interval(k, n, 0.95)
        cp = clopper_pearson_interval(k, n, 0.95)
        assert halfwidth(cp) >= halfwidth(w) - 1e-12


def test_interval_validation():
    with pytest.raises(ValueError, match="unknown CI method"):
        binomial_interval(1, 10, method="wald")
    with pytest.raises(ValueError, match="unsupported confidence"):
        wilson_interval(1, 10, confidence=0.5)
    assert binomial_interval(0, 0) == (0.0, 1.0)


def test_sampling_plan_stopping_rule():
    fixed = SamplingPlan()
    assert not fixed.adaptive
    assert not fixed.should_stop(0, 99, 100)
    assert fixed.should_stop(0, 100, 100)
    adaptive = SamplingPlan(ci_halfwidth=0.1, min_trials=25)
    assert adaptive.adaptive
    assert not adaptive.should_stop(0, 10, 1000)
    assert adaptive.should_stop(0, 100, 1000)
    assert not adaptive.should_stop(5, 25, 1000)
    with pytest.raises(ValueError):
        SamplingPlan(ci_halfwidth=-1)
    with pytest.raises(ValueError):
        SamplingPlan(ci_method="wald")


# ---------------------------------------------------------------------------
# (b) adaptive early stopping reaches fixed-budget verdicts, cheaper
# ---------------------------------------------------------------------------


def test_adaptive_matches_fixed_verdicts_with_fewer_trials():
    spec = CampaignSpec("qmatmul", Policy.ABFT, "accumulator",
                        "single_bitflip", trials=100)
    fixed = run_campaign([spec], device=CPU)[0]
    assert fixed.trials == 100 and not fixed.early_stopped
    assert fixed.detection_rate == 1.0 and fixed.sdc == 0

    plan = SamplingPlan(ci_halfwidth=0.1, chunk=25, kernel_chunk=25,
                        min_trials=25)
    adaptive = run_campaign([spec], plan=plan, device=CPU)[0]
    assert adaptive.early_stopped
    assert adaptive.trials == 25
    assert adaptive.detection_rate == 1.0 and adaptive.sdc == 0
    assert adaptive.max_trials == 100
    assert halfwidth((adaptive.sdc_ci_lo, adaptive.sdc_ci_hi)) <= 0.1
    assert adaptive.ci_method == "wilson" and adaptive.ci_confidence == 0.95


@pytest.mark.parametrize("workload", ["qmatmul", "flashattn", "transformer"])
def test_adaptive_executes_exact_prefix_of_seed_stream(workload):
    """Early-stopped trials are the first N seeds of the same stream the
    full-budget run uses, whatever the chunking."""
    site = "activations"
    spec = CampaignSpec(workload, Policy.NONE, site, "single_bitflip",
                        trials=40)
    case = runner.build_case(workload, device=CPU)
    full = engine_mod.run_config_chunk(case, spec, 0, 40)
    plan = SamplingPlan(ci_halfwidth=0.5, chunk=10, kernel_chunk=10,
                        min_trials=10)
    acc = engine_mod.run_config(spec, plan, 10, case=case)
    assert acc.early_stopped and acc.n < 40
    assert acc.detected == full.detected[:acc.n]
    assert acc.mismatch == full.mismatch[:acc.n]
    parts = [engine_mod.run_config_chunk(case, spec, lo, hi)
             for lo, hi in ((0, 7), (7, 8), (8, 40))]
    assert sum((p.mismatch for p in parts), []) == full.mismatch


def test_nonzero_rate_needs_more_trials_than_zero_rate():
    plan = SamplingPlan(ci_halfwidth=0.12, chunk=25, kernel_chunk=25,
                        min_trials=25)
    mk = lambda pol: CampaignSpec("qmatmul", pol, "accumulator",   # noqa
                                  "single_bitflip", trials=400)
    abft, none = run_campaign([mk(Policy.ABFT), mk(Policy.NONE)], plan=plan,
                              device=CPU)
    assert abft.sdc == 0 and abft.trials == 25
    assert none.sdc_rate > 0.2
    assert none.trials > abft.trials


# ---------------------------------------------------------------------------
# (c) mbu_burst fault model
# ---------------------------------------------------------------------------


def test_mbu_burst_model_resolution():
    assert resolve_fault_model("mbu_burst").name == "mbu_burst"
    assert resolve_fault_model("mbu_burst@3x2").name == "mbu_burst@3x2"
    assert resolve_fault_model("mbu_burst@2x2").name == "mbu_burst"
    assert resolve_fault_model("multi_bitflip@3e-4").name \
        == "multi_bitflip@0.0003"
    with pytest.raises(KeyError, match="mbu_burst@<elems>x<bits>"):
        resolve_fault_model("mbu_burst@banana")
    with pytest.raises(KeyError):
        resolve_fault_model("mbu_burst@0x2")
    with pytest.raises(KeyError, match="unknown fault model"):
        resolve_fault_model("cosmic_ray")


@pytest.mark.parametrize("workload", ["qmatmul", "qconv2d"])
def test_mbu_burst_campaign_tmr_zero_sdc(workload):
    """Majority vote is burst-agnostic: a whole cluster corrupts only one
    replica, so TMR still yields zero SDC — while the unprotected kernel
    shows the burst is genuinely damaging.  A 2x2 burst flips the same two
    bits of two adjacent accumulators, whose changes can cancel in one row
    or pixel checksum: it aliases under ABFT, as in the reference (about a
    quarter of the trials in both packages at these shapes)."""
    mk = lambda pol: CampaignSpec(workload, pol, "accumulator",   # noqa
                                  "mbu_burst", trials=40)
    tmr, none, abft = run_campaign(
        [mk(Policy.TMR), mk(Policy.NONE), mk(Policy.ABFT)], device=CPU)
    assert tmr.sdc == 0
    assert none.sdc > 0
    assert abft.sdc > 0 and abft.detected_corrected > 0
    again = run_campaign([mk(Policy.NONE)], device=CPU)[0]
    assert again == none


# ---------------------------------------------------------------------------
# (d) resume from the crash-consistent journal
# ---------------------------------------------------------------------------


def _qm_spec(trials=48):
    return CampaignSpec("qmatmul", Policy.NONE, "accumulator",
                        "single_bitflip", trials=trials)


def test_resume_after_midconfig_kill_is_bit_identical(tmp_path):
    plan = SamplingPlan(chunk=16, kernel_chunk=16)
    uninterrupted = run_campaign([_qm_spec()], plan=plan, device=CPU)[0]

    journal = CampaignJournal(tmp_path / "journal")
    with pytest.raises(CampaignInterrupted):
        run_campaign([_qm_spec()], plan=plan, journal=journal, device=CPU,
                     _abort_after_chunks=1)
    rec = journal.load(_qm_spec())
    assert rec is not None and not rec["done"]
    assert rec["trials_done"] == 16

    stats: dict = {}
    resumed = run_campaign([_qm_spec()], plan=plan, journal=journal,
                           run_stats=stats, device=CPU)[0]
    assert resumed == uninterrupted
    assert stats["trials_resumed"] == 16 and stats["trials_live"] == 32
    stats2: dict = {}
    final = run_campaign([_qm_spec()], plan=plan, journal=journal,
                         run_stats=stats2, device=CPU)[0]
    assert final == uninterrupted
    assert stats2["trials_live"] == 0 and stats2["configs_resumed"] == 1


def test_journal_discards_mismatched_spec(tmp_path):
    journal = CampaignJournal(tmp_path)
    plan = SamplingPlan(chunk=16, kernel_chunk=16)
    run_campaign([_qm_spec(48)], plan=plan, journal=journal, device=CPU)
    assert journal.load(_qm_spec(48)) is not None
    assert journal.load(_qm_spec(64)) is None
    stats: dict = {}
    run_campaign([_qm_spec(64)], plan=plan, journal=journal, run_stats=stats,
                 device=CPU)
    assert stats["trials_resumed"] == 0 and stats["trials_live"] == 64


def test_journal_discards_another_seed_stream(tmp_path):
    """A record the reference's journal wrote (no ``stream``, or another
    scheme) is never continued: its faults were drawn from jax.random."""
    journal = CampaignJournal(tmp_path)
    spec = _qm_spec(32)
    plan = SamplingPlan(chunk=16, kernel_chunk=16)
    run_campaign([spec], plan=plan, journal=journal, device=CPU,
                 _abort_after_chunks=None)
    path = journal.path_for(spec)
    doc = json.loads(path.read_text())
    assert doc["stream"] == fl.STREAM_SCHEME and doc["done"]
    for stream in (None, "jax.random.split(fold_in(key(seed), crc32))"):
        doc2 = dict(doc)
        if stream is None:
            doc2.pop("stream")
        else:
            doc2["stream"] = stream
        path.write_text(json.dumps(doc2))
        assert journal.load(spec) is None
        assert journal.records() == {}
        stats: dict = {}
        run_campaign([spec], plan=plan, journal=journal, run_stats=stats,
                     device=CPU)
        assert stats["trials_resumed"] == 0 and stats["trials_live"] == 32


def test_journal_tolerates_corruption(tmp_path):
    journal = CampaignJournal(tmp_path)
    spec = _qm_spec()
    path = journal.path_for(spec)
    path.write_text("{ torn json")
    assert journal.load(spec) is None
    assert journal.records() == {}
    path.with_suffix(".tmp").write_text("garbage")
    journal.publish(spec, [], done=False)
    assert journal.load(spec)["trials_done"] == 0


def test_chunk_outcome_roundtrips_events():
    oc = ChunkOutcome(lo=5, hi=7, detected=[True, False],
                      mismatch=[False, True], recovery_count=1,
                      recovery_seconds=[0.25],
                      events=[Event(tick=3, kind="strike", site="kv_cache",
                                    policy="abft", fault="mbu_burst",
                                    detail={"x": 1})])
    back = ChunkOutcome.from_doc(json.loads(json.dumps(oc.to_doc())))
    assert back == oc


# ---------------------------------------------------------------------------
# (e) sharded execution — bit-identical to serial (spawned workers)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool():
    with CampaignPool(2, device=CPU) as p:
        yield p


def _ship_spec(trials=12):
    return CampaignSpec("shipdet", Policy.TMR, "weights", "single_bitflip",
                        trials=trials)


def test_sharded_bit_identical_to_serial(pool):
    serial = run_campaign([_ship_spec()], plan=SamplingPlan(chunk=4),
                          device=CPU)[0]
    sharded = run_campaign([_ship_spec()],
                           plan=SamplingPlan(chunk=4, workers=2),
                           pool=pool, device=CPU)[0]
    assert sharded == serial
    assert serial.trials == 12 and serial.strikes_logged == 12


def test_sharded_transformer_bit_identical_to_serial(pool):
    spec = CampaignSpec("transformer", Policy.DMR, "activations",
                        "single_bitflip", trials=8)
    serial = run_campaign([spec], plan=SamplingPlan(chunk=2), device=CPU)[0]
    sharded = run_campaign([spec], plan=SamplingPlan(chunk=2, workers=2),
                           pool=pool, device=CPU)[0]
    assert sharded == serial


def test_sharded_adaptive_stops_at_serial_boundary(pool):
    plan = SamplingPlan(ci_halfwidth=0.2, chunk=4, min_trials=4)
    serial = run_campaign([_ship_spec()], plan=plan, device=CPU)[0]
    sharded = run_campaign([_ship_spec()],
                           plan=SamplingPlan(ci_halfwidth=0.2, chunk=4,
                                             min_trials=4, workers=2),
                           pool=pool, device=CPU)[0]
    assert serial.early_stopped and serial.trials < 12
    assert sharded == serial


def test_sharded_resume_bit_identical(pool, tmp_path):
    plan = SamplingPlan(chunk=4, workers=2)
    uninterrupted = run_campaign([_ship_spec()], plan=plan, pool=pool,
                                 device=CPU)[0]
    journal = CampaignJournal(tmp_path / "journal")
    with pytest.raises(CampaignInterrupted):
        run_campaign([_ship_spec()], plan=plan, pool=pool, journal=journal,
                     device=CPU, _abort_after_chunks=1)
    stats: dict = {}
    resumed = run_campaign([_ship_spec()], plan=plan, pool=pool,
                           journal=journal, run_stats=stats, device=CPU)[0]
    assert resumed == uninterrupted
    assert stats["trials_resumed"] == 4


def test_pool_workers_build_on_the_pool_device(pool):
    assert pool.device == CPU and pool.workers == 2
    oc, = pool.run_chunks(_ship_spec(), [(0, 3)])
    case = runner.build_case("shipdet", device=CPU)
    assert oc == engine_mod.run_config_chunk(case, _ship_spec(), 0, 3)


# ---------------------------------------------------------------------------
# (f) adaptive bit sweep + report/CLI round trips
# ---------------------------------------------------------------------------


def test_adaptive_bit_sweep_stops_early_per_policy():
    plan = SamplingPlan(ci_halfwidth=0.5, chunk=4, min_trials=4)
    case = runner.build_case("qmatmul", device=CPU)
    rows = runner.run_bit_sweep("qmatmul", [Policy.NONE], trials_per_bit=16,
                                plan=plan, case=case)
    assert len(rows) == runner.ACC_BITS
    assert all(r.trials == rows[0].trials for r in rows)
    assert rows[0].trials < 16
    fixed = runner.run_bit_sweep("qmatmul", [Policy.NONE], trials_per_bit=16,
                                 case=case)
    assert all(r.trials == 16 for r in fixed)
    assert {r.bit: r.sdc > 0 for r in rows}[31] \
        == {r.bit: r.sdc > 0 for r in fixed}[31]
    # the adaptive sweep ran the fixed sweep's first trials of every bit
    for a, f in zip(rows, fixed):
        assert a.sdc <= f.sdc and a.masked <= f.masked


def test_config_result_ci_columns_roundtrip(tmp_path):
    plan = SamplingPlan(ci_halfwidth=0.1, chunk=25, kernel_chunk=25,
                        min_trials=25, ci_method="clopper-pearson")
    res = run_campaign([CampaignSpec("qmatmul", Policy.ABFT, "accumulator",
                                     "single_bitflip", trials=100)],
                       plan=plan, device=CPU)
    write_report(res, tmp_path, {"note": "ci"})
    _, loaded = load_report(tmp_path / "campaign.json")
    assert loaded[0] == res[0]
    assert loaded[0].ci_method == "clopper-pearson"
    assert loaded[0].early_stopped and loaded[0].max_trials == 100
    legacy = ConfigResult.from_dict({
        "workload": "qmatmul", "policy": "abft", "site": "accumulator",
        "fault_model": "single_bitflip", "trials": 10, "masked": 0,
        "detected_corrected": 10, "detected_uncorrected": 0, "sdc": 0})
    assert legacy.max_trials == 0 and legacy.ci_method == ""


def test_cli_adaptive_run_and_resume(tmp_path):
    out = tmp_path / "camp"
    argv = ["--workload", "qmatmul", "--policies", "none,abft",
            "--sites", "accumulator", "--fault-models", "single_bitflip",
            "--trials", "60", "--ci-halfwidth", "0.12", "--chunk", "20",
            "--kernel-chunk", "20", "--min-trials", "20",
            "--bit-trials", "0", "--quiet", "--device", "cpu"]
    assert cli.main(argv + ["--out", str(out)]) == 0
    meta, rows = load_report(out / "campaign.json")
    assert meta["ci_halfwidth"] == 0.12 and meta["ci_method"] == "wilson"
    abft = [r for r in rows if r.policy == "abft"][0]
    assert abft.early_stopped and abft.trials < 60
    assert (out / "journal").is_dir()

    assert cli.main(argv + ["--resume", str(out)]) == 0
    meta2, rows2 = load_report(out / "campaign.json")
    assert rows2 == rows
    assert meta2["trials_live"] == 0
    assert meta2["trials_resumed"] == meta["trials_executed"]


def test_cli_events_out_and_workers(tmp_path):
    events = tmp_path / "ev.json"
    argv = ["--workload", "qmatmul,shipdet", "--policies", "abft",
            "--sites", "accumulator", "--fault-models", "single_bitflip",
            "--trials", "6", "--chunk", "3", "--bit-trials", "0",
            "--workers", "2", "--quiet", "--device", "cpu", "--no-journal",
            "--out", str(tmp_path), "--events-out", str(events)]
    assert cli.main(argv) == 0
    doc = json.loads(events.read_text())
    assert [c["config"] for c in doc["configs"]] == [
        "qmatmul/abft/accumulator/single_bitflip",
        "shipdet/abft/accumulator/single_bitflip"]
    assert all(len(c["timelines"]) == 6 for c in doc["configs"])
    _, rows = load_report(tmp_path / "campaign.json")
    assert all(r.sdc == 0 for r in rows)
    assert np.all([r.trials == 6 for r in rows])
