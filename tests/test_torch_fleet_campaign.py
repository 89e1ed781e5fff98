"""The fleet campaign workloads (``fleet``, ``fleet_mp``).

First the campaign cases of tests/test_fleet.py, on the port's ``fleet``
case and its own seeds, by verdict: ABFT detects and heals every weight
flip and NONE ships corrupted streams; DMR covers the token buffer; the
scrub policies cover both transient sites with measured recoveries; CKPT
restores incrementally.  Then trial by trial: both packages' cases serve
the reference's parameters (W8A8 FFN, f32 compute) and take the same
addressed faults — a (leaf, index, bit) row per trial, the reference's key
and the port's seed, each package's leaf draw replaced by the row's leaf —
so ``detected`` and ``mismatch`` are equal under every policy and site.
Last, ``fleet_mp`` (a process fleet on the CPU, struck mid rolling deploy)
by its verdicts: ABFT and CKPT SDC 0, NONE SDC > 0.
"""
from __future__ import annotations

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign import runner as jrunner
from repro.core import fault_injection as jfi
from repro.core.dependability import Policy as JPolicy
from repro_torch import tree
from repro_torch.campaign import runner as trunner
from repro_torch.campaign.faultload import (CampaignSpec, resolve_fault_model,
                                            trial_seeds)
from repro_torch.campaign.report import classify_counts
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core import fault_injection as tfi
from repro_torch.core.dependability import Policy

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
N_TRIALS = 8
_SEED_BITS, _IDX_BITS = 6, 34         # seed = leaf | index | bit
_W8A8 = dict(quant="w8a8_ffn", compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The reference's campaign cases, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_case():
    return trunner.build_case("fleet", 0, device=CPU)


def _run(case, policy, site, trials, seed):
    spec = CampaignSpec("fleet", policy, site, "single_bitflip",
                        trials=trials, seed=seed)
    det, mis = case.run_trials(policy, site,
                               resolve_fault_model("single_bitflip").apply,
                               trial_seeds(spec))
    return det, classify_counts(det, mis)


def test_fleet_campaign_abft_zero_sdc_none_nonzero_100_trials(fleet_case):
    det, counts = _run(fleet_case, Policy.ABFT, "weights", 100, 0)
    assert counts["sdc"] == 0
    assert counts["detected_uncorrected"] == 0
    assert counts["detected_corrected"] == 100
    det, counts = _run(fleet_case, Policy.NONE, "weights", 100, 0)
    assert not det.any()
    assert counts["sdc"] > 0


def test_fleet_campaign_dmr_covers_transient_site(fleet_case):
    _, counts = _run(fleet_case, Policy.DMR, "decode_state", 40, 1)
    assert counts["sdc"] == 0
    assert counts["detected_corrected"] > 0


@pytest.mark.parametrize("policy", [Policy.ABFT, Policy.CKPT])
@pytest.mark.parametrize("site", ["decode_state", "kv_cache"])
def test_fleet_scrub_policies_cover_transient_sites(fleet_case, policy,
                                                    site):
    fleet_case.drain_recovery_stats()
    _, counts = _run(fleet_case, policy, site, 20, 3)
    assert counts["sdc"] == 0
    assert counts["detected_corrected"] == 20
    stats = fleet_case.drain_recovery_stats()
    assert stats["faults_recovered"] >= 20
    assert stats["recovery_ms_mean"] > 0.0


def test_fleet_ckpt_weight_seu_recovers_incrementally(fleet_case):
    _, counts = _run(fleet_case, Policy.CKPT, "weights", 20, 4)
    assert counts["sdc"] == 0
    assert counts["detected_corrected"] == 20
    m = fleet_case.fleet.metrics
    assert m.incremental_restores >= 1
    assert m.full_reloads == 0
    assert m.leaves_restored >= 1


def test_fleet_cases_match_the_reference_registry():
    for w in ("fleet", "fleet_mp"):
        trunner.check_workload(w)
        j, t = jrunner.CASES[w], trunner.CASES[w]
        assert t.sites == j.sites
        assert [p.value for p in t.policies] == [p.value for p in j.policies]
        assert (t.shardable, t.transport, t.max_new_tokens) \
            == (j.shardable, j.transport, j.max_new_tokens)


# ---------------------------------------------------------------------------
# Trial by trial against the reference, on shared addressed faults
# ---------------------------------------------------------------------------


def _f32(cfg):
    return dataclasses.replace(cfg, **_W8A8)


class JFleet(jrunner.FleetCase):
    """The reference's case, its fleet rebuilt on the f32-compute W8A8
    config (the reference's case has no config hook)."""

    def __init__(self, key):
        super().__init__(key)
        from repro.fleet.fleet import Fleet
        from repro.models import api as japi
        self.fleet.close()
        self.cfg = _f32(self.cfg)
        self.params = japi.init_params(self.cfg, key)
        self.fleet = Fleet(self.cfg, self.params, n_replicas=2,
                           policy=JPolicy.NONE, capacity=2, max_len=64,
                           prefill_pad=8, scrub_every=3, snapshot_every=2,
                           backend="jnp", transport=self.transport)


class TFleet(trunner.FleetCase):
    _customize_cfg = staticmethod(_f32)


@pytest.fixture(scope="module")
def case_pair():
    jcase = JFleet(jax.random.key(0))
    tcase = TFleet(0, "cuda", device=CPU)
    tcase.use_params(transformer_params_from_numpy(
        jax.device_get(jcase.params), device=CPU))
    for case in (jcase, tcase):
        # straggler verdicts read wall-clock step times: off, in both
        case.fleet.supervisor.straggler_factor = float("inf")
    yield jcase, tcase
    jcase.fleet.close()
    tcase.fleet.close()


def _decode(seed):
    return (seed >> (_IDX_BITS + _SEED_BITS),
            (seed >> _SEED_BITS) & ((1 << _IDX_BITS) - 1),
            seed & ((1 << _SEED_BITS) - 1))


def j_fault(x, key):
    """Flip bit ``key[2] % width`` of flat element ``key[1] % size``."""
    bits, u = jfi._as_bits(x)
    flat = bits.reshape(-1)
    width = x.dtype.itemsize * 8
    idx = int(key[1]) % flat.shape[0]
    flat = flat.at[idx].set(flat[idx] ^ u(1 << (int(key[2]) % width)))
    return jax.lax.bitcast_convert_type(flat.reshape(x.shape), x.dtype)


def t_fault(x, gen):
    _, idx, bit = _decode(gen.initial_seed())
    return tfi.flip_bit_at_index(x, idx % x.numel(),
                                 bit % (x.element_size() * 8))


def j_inject(params, key, fault):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    i = int(key[0]) % len(leaves)
    leaves[i] = fault(leaves[i], key)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def t_inject(params, gen, fault):
    leaves = tree.leaves_with_paths(params)
    path, leaf = leaves[_decode(gen.initial_seed())[0] % len(leaves)]
    return tree.replace(params, path, fault(leaf, gen))


def _rows(seed, sizes):
    """(N_TRIALS, 3) rows (leaf, index, bit): the leaf drawn by size, the
    sign, exponent and low bits all reached."""
    rng = np.random.default_rng(seed)
    p = np.asarray(sizes, np.float64)
    rows = np.stack([rng.choice(len(sizes), N_TRIALS, p=p / p.sum()),
                     rng.integers(0, 2**30, N_TRIALS),
                     rng.integers(0, 32, N_TRIALS)], axis=1)
    rows[:4, 2] = [31, 30, 7, 0]
    return rows.astype(np.int32)


CONFIGS = [(p, s) for p in ("none", "abft", "dmr", "ckpt")
           for s in ("weights", "kv_cache", "decode_state")]


@pytest.mark.parametrize("policy,site", CONFIGS)
def test_fleet_trials_equal_reference(case_pair, monkeypatch, policy, site):
    jcase, tcase = case_pair
    monkeypatch.setattr(jfi, "inject_pytree_with", j_inject)
    monkeypatch.setattr(tfi, "inject_pytree_with", t_inject)
    eng = tcase.fleet.replicas[0].engine
    state = {"weights": eng.params, "kv_cache": eng.cache,
             "decode_state": eng.tokens}[site]
    sizes = [leaf.numel() for leaf in tree.leaves(state)]
    jeng = jcase.fleet.replicas[0].engine
    assert len(sizes) == len(jax.tree_util.tree_leaves(
        {"weights": jeng.params, "kv_cache": jeng.cache,
         "decode_state": jeng.tokens}[site]))
    rows = _rows(zlib.crc32(f"fleet/{policy}/{site}".encode()), sizes)
    d_j, m_j = jcase.run_trials(JPolicy(policy), site, j_fault,
                                jnp.asarray(rows))
    seeds = [(int(lf) << (_IDX_BITS + _SEED_BITS)) | (int(i) << _SEED_BITS)
             | int(b) for lf, i, b in rows]
    d_t, m_t = tcase.run_trials(Policy(policy), site, t_fault, seeds)
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(m_t, np.asarray(m_j))
    if policy in ("abft", "ckpt"):
        assert not m_t.any()
    if policy == "none":
        assert not d_t.any()
    # one logged strike per trial, the same timelines in both (but for the
    # fault functions' names and the measured wall seconds)
    jt, tt = jcase.events.timelines(), tcase.events.timelines()
    assert len(tt) == N_TRIALS
    for tl in (jt, tt):
        for t in tl:
            t.pop("recovery_seconds")
            t.pop("fault")
    assert tt == jt
    jcase.events.clear()
    tcase.events.clear()
    jcase.drain_recovery_stats()
    tcase.drain_recovery_stats()


# ---------------------------------------------------------------------------
# fleet_mp: a process fleet struck mid rolling deploy, by its verdicts
# ---------------------------------------------------------------------------


def test_fleet_mp_campaign_verdicts():
    case = trunner.FleetMPCase(0, "cuda", device=CPU)
    try:
        assert case.fleet.transport == "proc"
        for policy in (Policy.ABFT, Policy.CKPT, Policy.NONE):
            det, counts = _run_mp(case, policy)
            if policy == Policy.NONE:
                assert not det.any()
                assert counts["sdc"] > 0
            else:
                assert counts["sdc"] == 0
                assert counts["detected_uncorrected"] == 0
        assert case.fleet.metrics.deploys == 1
    finally:
        case.close()
    assert not any(r.handle.proc.is_alive() for r in case.fleet.replicas)


def _run_mp(case, policy):
    spec = CampaignSpec("fleet_mp", policy, "weights", "single_bitflip",
                        trials=64, seed=0)
    det, mis = case.run_trials(policy, "weights",
                               resolve_fault_model("single_bitflip").apply,
                               trial_seeds(spec))
    return det, classify_counts(det, mis)
