"""The serving campaign workloads (``serving``, ``serving_int8kv``).

The cases of tests/test_campaign.py (CKPT ends with zero SDC and a
measured recovery; the int8 cache's ``kv_cache`` strikes detected under
ABFT and healed under CKPT), of tests/test_campaign_adaptive.py (an MBU
burst on the KV cache caught whole) and of tests/test_obs.py (one logged
strike per trial, detection and recovery chains per policy, nothing
detected under NONE), on the port's cases.  Then trial by trial: both
packages' cases serve the reference's parameters (f32 compute, through
each case's ``_customize_cfg`` hook) and take the same addressed faults —
a (leaf, index, bit) row per trial, the reference's key and the port's
seed, with each package's leaf draw replaced by the row's leaf, in the
same leaf order — so ``detected`` and ``mismatch`` are equal under every
policy and site."""
from __future__ import annotations

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign import faultload as jfl
from repro.campaign import runner as jrunner
from repro.core import fault_injection as jfi
from repro.core.dependability import Policy as JPolicy
from repro_torch import tree
from repro_torch.campaign import runner as trunner
from repro_torch.campaign.faultload import (CampaignSpec, expand_grid,
                                            resolve_fault_model, trial_seeds)
from repro_torch.campaign.runner import SUPPORTED, build_case, run_campaign
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core import fault_injection as tfi
from repro_torch.core.dependability import Policy

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
N_TRIALS = 10
_SEED_BITS, _IDX_BITS = 6, 34         # seed = leaf | index | bit


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The reference's cases, on the port
# ---------------------------------------------------------------------------


def test_serving_ckpt_zero_sdc_with_measured_recovery():
    specs = expand_grid(["serving"], [Policy.CKPT],
                        ["weights", "decode_state"], ["single_bitflip"],
                        trials=10, seed=0, supported=SUPPORTED)
    results = run_campaign(specs, device=CPU)
    assert len(results) == 2
    for r in results:
        assert r.sdc == 0
        assert r.faults_recovered > 0
        assert r.recovery_ms_mean > 0.0


def test_serving_int8kv_scrub_covers_kv_cache():
    case = build_case("serving_int8kv", seed=0, device=CPU)
    assert case.cfg.quant_kv
    assert case.engine.cache.k.dtype == torch.int8
    fault = resolve_fault_model("single_bitflip")
    for policy in (Policy.ABFT, Policy.CKPT):
        spec = CampaignSpec("serving_int8kv", policy, "kv_cache",
                            "single_bitflip", trials=4, seed=0)
        detected, mismatch = case.run_trials(policy, "kv_cache", fault.apply,
                                             trial_seeds(spec))
        assert detected.all(), f"{policy} missed an int8 kv_cache strike"
        if policy == Policy.CKPT:
            assert not mismatch.any()


def test_mbu_burst_on_serving_kv_cache():
    r = run_campaign([CampaignSpec("serving", Policy.ABFT, "kv_cache",
                                   "mbu_burst", trials=6)], device=CPU)[0]
    assert r.trials == 6
    assert r.sdc == 0
    assert r.detection_rate == 1.0


def test_cli_and_serve_launcher_run_the_serving_path(tmp_path, capsys):
    from repro_torch.campaign import cli
    from repro_torch.launch import serve
    assert cli.main(["--workload", "serving_int8kv", "--device", CPU,
                     "--policies", "ckpt", "--sites", "kv_cache",
                     "--fault-models", "single_bitflip", "--trials", "2",
                     "--bit-trials", "0", "--no-journal",
                     "--out", str(tmp_path), "--quiet"]) == 0
    assert (tmp_path / "campaign.json").exists()
    serve.main(["--arch", "smollm-135m", "--reduced", "--device", CPU,
                "--requests", "3", "--capacity", "2", "--max-new", "12",
                "--fault-drill"])
    out = capsys.readouterr().out
    assert "every stream equals the clean run's" in out
    assert "replays=1" in out


def test_serving_unsupported_pairs_are_skipped():
    specs = [CampaignSpec("serving", p, "kv_cache", "single_bitflip", 2)
             for p in (Policy.DMR, Policy.TMR)]
    assert run_campaign(specs, device=CPU) == []
    assert trunner.ServingCase.supports(Policy.TMR, "weights")


@pytest.fixture(scope="module")
def serving_campaign():
    specs = expand_grid(["serving"], [Policy.NONE, Policy.ABFT, Policy.CKPT],
                        ["kv_cache", "weights"], ["single_bitflip"], 2, 0,
                        supported=SUPPORTED)
    sink = []
    results = run_campaign(specs, event_sink=sink, device=CPU)
    return ({(r.policy, r.site): r for r in results},
            {e["config"]: e["timelines"] for e in sink})


def test_campaign_logs_exactly_one_strike_per_trial(serving_campaign):
    results, _ = serving_campaign
    for r in results.values():
        assert r.strikes_logged == r.trials, (r.policy, r.site)


def test_campaign_detection_recovery_under_policies(serving_campaign):
    results, timelines = serving_campaign
    for site in ("kv_cache", "weights"):
        for policy in ("abft", "ckpt"):
            r = results[(policy, site)]
            assert r.detections_logged == r.trials, (policy, site)
            tls = timelines[f"serving/{policy}/{site}/single_bitflip"]
            assert all(t["detected"] for t in tls)
            assert all(t["detection_latency_ticks"] >= 0 for t in tls)
            if policy == "ckpt":
                assert all(t["recovered"] for t in tls), site
                assert all(t["recovery_latency_ticks"] >= 0 for t in tls)


def test_campaign_none_policy_detects_nothing(serving_campaign):
    results, timelines = serving_campaign
    for site in ("kv_cache", "weights"):
        assert results[("none", site)].detections_logged == 0, site
        tls = timelines[f"serving/none/{site}/single_bitflip"]
        assert all(not t["detected"] and not t["recovered"] for t in tls)


# ---------------------------------------------------------------------------
# Trial by trial against the reference, on shared addressed faults
# ---------------------------------------------------------------------------


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


class JServing(jrunner.ServingCase):
    _customize_cfg = staticmethod(_f32)


class JServingInt8KV(jrunner.ServingInt8KVCase):
    _customize_cfg = staticmethod(_f32)


class TServing(trunner.ServingCase):
    _customize_cfg = staticmethod(_f32)


class TServingInt8KV(trunner.ServingInt8KVCase):
    _customize_cfg = staticmethod(_f32)


CASE_PAIRS = {"serving": (JServing, TServing),
              "serving_int8kv": (JServingInt8KV, TServingInt8KV)}
CONFIGS = [(w, p, s) for w in CASE_PAIRS
           for p in ("none", "abft", "dmr", "tmr", "ckpt")
           for s in ("weights", "kv_cache", "decode_state")
           if trunner.ServingCase.supports(Policy(p), s)]


@pytest.fixture(scope="module")
def case_pairs():
    out = {}
    for w, (J, T) in CASE_PAIRS.items():
        jcase = J(jax.random.key(0))
        tcase = T(0, "cuda", device=CPU)
        tcase.use_params(transformer_params_from_numpy(
            jax.device_get(jcase.params), device=CPU))
        out[w] = (jcase, tcase)
    return out


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
    """(N_TRIALS, 3) rows (leaf, index, bit): the leaf drawn by size as the
    packages draw it, the sign, exponent and low bits all reached."""
    rng = np.random.default_rng(seed)
    p = np.asarray(sizes, np.float64)
    rows = np.stack([rng.choice(len(sizes), N_TRIALS, p=p / p.sum()),
                     rng.integers(0, 2**30, N_TRIALS),
                     rng.integers(0, 32, N_TRIALS)], axis=1)
    rows[:4, 2] = [31, 30, 7, 0]
    return rows.astype(np.int32)


@pytest.mark.parametrize("workload,policy,site", CONFIGS)
def test_serving_trials_equal_reference(case_pairs, monkeypatch, workload,
                                        policy, site):
    jcase, tcase = case_pairs[workload]
    for mod in (jfi, jfl):
        monkeypatch.setattr(mod, "inject_pytree_with", j_inject)
    monkeypatch.setattr(tfi, "inject_pytree_with", t_inject)
    state = {"weights": tcase.params, "kv_cache": tcase.engine.cache,
             "decode_state": tcase.engine.tokens}[site]
    sizes = [leaf.numel() for leaf in tree.leaves(state)]
    assert len(sizes) == len(jax.tree_util.tree_leaves(
        {"weights": jcase.params, "kv_cache": jcase.engine.cache,
         "decode_state": jcase.engine.tokens}[site]))
    rows = _rows(zlib.crc32(f"{workload}/{policy}/{site}".encode()), sizes)
    d_j, m_j = jcase.run_trials(JPolicy(policy), site, j_fault,
                                jnp.asarray(rows))
    seeds = [(int(l) << (_IDX_BITS + _SEED_BITS)) | (int(i) << _SEED_BITS)
             | int(b) for l, i, b in rows]
    d_t, m_t = tcase.run_trials(Policy(policy), site, t_fault, seeds)
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(m_t, np.asarray(m_j))
    if policy in ("abft", "ckpt"):
        assert d_t.all()
    if policy == "ckpt":
        assert not m_t.any()
    if policy == "none" and site == "decode_state":
        assert m_t.any()                  # the comparison sees SDC too
    jcase.events.clear()
    tcase.events.clear()
    jcase.drain_recovery_stats()
    tcase.drain_recovery_stats()
