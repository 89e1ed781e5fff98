"""The port's campaign held against the reference's, case by case.

Both packages get the same operands (the reference case's, set on the
port's case; the ship detector's through ``shipdet_params_from_numpy``)
and the same list of addressed faults: the reference's ``keys`` array
holds one (leaf, index, bit) row per trial, which its ``run_trials`` hands
to ``fault(x, key)`` unchanged, and the port's trial seed encodes the same
row, which its fault reads back from ``gen.initial_seed()``.  Then
``detected`` and ``mismatch`` must be equal trial by trial for ``qmatmul``,
``qconv2d`` and ``shipdet`` under every policy and site.  The ship
detector's weight site draws its leaf inside the reference case
(``inject_pytree_with``, from a key), so there the test strikes the same
leaf in both packages itself.  (``flashattn`` is float and is held by
verdict, in ``test_torch_campaign.py``.)  Beside them, the registries,
``stats`` and ``report`` against the reference's."""
from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign import faultload as jfl
from repro.campaign import report as jreport
from repro.campaign import runner as jrunner
from repro.campaign import stats as jstats
from repro.core import fault_injection as jfi
from repro.core.dependability import Policy as JPolicy
from repro_torch.campaign import faultload as tfl
from repro_torch.campaign import report as treport
from repro_torch.campaign import runner as trunner
from repro_torch.campaign import stats as tstats
from repro_torch.convert import shipdet_params_from_numpy
from repro_torch.core import abft as tabft
from repro_torch.core import fault_injection as tfi
from repro_torch.core.dependability import Policy
from repro_torch.models import shipdet as tshipdet

jax.config.update("jax_platform_name", "cpu")

POLICIES = ["none", "abft", "dmr", "tmr", "ckpt"]
SITES = ["accumulator", "weights", "activations"]
N_TRIALS = 24
_SEED_BITS, _IDX_BITS = 6, 34         # seed = leaf | index | bit


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Trials are many small ops: one intra-op thread keeps them from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _targets(seed, n=N_TRIALS, leaves=1):
    """(n, 3) int32 rows (leaf, index, bit); the bits cover every width,
    the sign and top bits included."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(0, leaves, n),
                     rng.integers(0, 2**30, n),
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
    ``key[1] % size`` (a test-local jnp fault; traceable under vmap)."""
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


def _np(a):
    return np.asarray(jax.device_get(a))


def _t(a):
    return torch.from_numpy(np.array(_np(a), copy=True))


@pytest.fixture(scope="module")
def kernel_cases():
    out = {}
    for w in ("qmatmul", "qconv2d"):
        jcase = jrunner.build_case(w, 0)
        tcase = trunner.build_case(w, 0, device="cpu")
        for name in ("x_q", "w_q", "bias", "x_zp", "out_zp", "scale"):
            setattr(tcase, name, _t(getattr(jcase, name)))
        tcase.w_check = (tabft.checksum_vector if w == "qmatmul"
                         else tabft.conv_checksum_weight)(tcase.w_q)
        np.testing.assert_array_equal(tcase.w_check.numpy(),
                                      _np(jcase.w_check))
        out[w] = (jcase, tcase)
    return out


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workload", ["qmatmul", "qconv2d"])
def test_kernel_case_trials_equal_reference(kernel_cases, workload, policy,
                                            site):
    jcase, tcase = kernel_cases[workload]
    rows = _targets(zlib.crc32(f"{workload}/{policy}/{site}".encode()))
    with jax.disable_jit():
        d_j, m_j = jcase.run_trials(JPolicy(policy), site, j_fault,
                                    jnp.asarray(rows))
    d_t, m_t = tcase.run_trials(Policy(policy), site, t_fault, _seeds(rows))
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(m_t, np.asarray(m_j))
    if policy != "none" and site == "accumulator":
        assert d_t.any()


@pytest.fixture(scope="module")
def shipdet_cases():
    jcase = jrunner.build_case("shipdet", 0)
    tcase = trunner.build_case("shipdet", 0, device="cpu")
    tcase.params = shipdet_params_from_numpy(jax.device_get(jcase.params),
                                             device="cpu")
    tcase.x = _t(jcase.x)
    tcase.w_checks = tshipdet.deploy_checks(tcase.params)
    tcase.golden_wq = tshipdet.golden_weights(tcase.params)
    return jcase, tcase


def _j_leaf_injector(leaves, key, fault):
    leaves = list(leaves)
    leaves[int(key[0])] = fault(leaves[int(key[0])], key)
    return leaves


def _t_leaf_injector(leaves, gen, fault):
    leaves = list(leaves)
    leaf = _decode(gen.initial_seed())[0]
    leaves[leaf] = fault(leaves[leaf], gen)
    return leaves


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("policy", POLICIES)
def test_shipdet_trials_equal_reference(shipdet_cases, monkeypatch, policy,
                                        site):
    jcase, tcase = shipdet_cases
    monkeypatch.setattr(jfl, "inject_pytree_with", _j_leaf_injector)
    monkeypatch.setattr(tfi, "inject_pytree_with", _t_leaf_injector)
    rows = _targets(zlib.crc32(f"shipdet/{policy}/{site}".encode()), n=6,
                    leaves=len(jcase.specs))
    # eager: one compile of the whole network per configuration would cost
    # more than its six trials
    with jax.disable_jit():
        d_j, m_j = jcase.run_trials(JPolicy(policy), site, j_fault,
                                    jnp.asarray(rows))
    d_t, m_t = tcase.run_trials(Policy(policy), site, t_fault, _seeds(rows))
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(m_t, np.asarray(m_j))


# ---------------------------------------------------------------------------
# registries, stats and report
# ---------------------------------------------------------------------------


def test_faultload_registries_match_reference():
    assert tfl.SITES == jfl.SITES
    assert sorted(tfl.FAULT_MODELS) == sorted(jfl.FAULT_MODELS)
    for name in ("multi_bitflip@3e-4", "mbu_burst@4x1", "mbu_burst@2x2"):
        assert tfl.resolve_fault_model(name).name \
            == jfl.resolve_fault_model(name).name
    assert trunner.SUPPORTED == {
        w: (sites, tuple(Policy(p.value) for p in pols))
        for w, (sites, pols) in jrunner.SUPPORTED.items()
        if w in trunner.CASES}
    assert set(trunner.CASES) == set(jrunner.CASES)
    j = jfl.expand_grid(["qmatmul", "transformer"], list(JPolicy),
                        list(jfl.SITES), ["single_bitflip"], 5,
                        supported=jrunner.SUPPORTED)
    t = tfl.expand_grid(["qmatmul", "transformer"], list(Policy),
                        list(tfl.SITES), ["single_bitflip"], 5,
                        supported=trunner.SUPPORTED)
    assert [s.label() for s in t] == [s.label() for s in j]


GRID = [(k, n) for n in (1, 7, 25, 100, 400) for k in sorted({0, 1, n // 3,
                                                              n - 1, n})]


@pytest.mark.parametrize("method", ["wilson", "clopper-pearson"])
@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
def test_stats_intervals_equal_reference(method, confidence):
    for k, n in GRID:
        a = tstats.binomial_interval(k, n, confidence, method)
        b = jstats.binomial_interval(k, n, confidence, method)
        assert a == pytest.approx(b, abs=1e-12), (k, n)
    tp = tstats.SamplingPlan(ci_halfwidth=0.1, confidence=confidence,
                             ci_method=method, min_trials=5)
    jp = jstats.SamplingPlan(ci_halfwidth=0.1, confidence=confidence,
                             ci_method=method, min_trials=5)
    assert [tp.should_stop(k, n, 200) for k, n in GRID] \
        == [jp.should_stop(k, n, 200) for k, n in GRID]


def test_report_bytes_equal_reference(tmp_path):
    specs = tfl.expand_grid(["qmatmul"], [Policy.NONE, Policy.CKPT],
                            ["accumulator"], ["single_bitflip"], 12,
                            supported=trunner.SUPPORTED,
                            backends=["cuda", "torch"])
    plan = tstats.SamplingPlan(ci_halfwidth=0.3, kernel_chunk=4,
                               min_trials=4)
    results = trunner.run_campaign(specs, plan=plan, device="cpu")
    bits = trunner.run_bit_sweep("qmatmul", [Policy.ABFT], trials_per_bit=2,
                                 device="cpu")
    meta = {"workloads": "qmatmul", "seed": 0, "elapsed_seconds": 1.5}
    j_results = [jreport.ConfigResult.from_dict(r.to_dict()) for r in results]
    j_bits = [jreport.BitCoverageRow.from_dict(r.to_dict()) for r in bits]
    paths = [treport.write_report(results, tmp_path / "port", meta,
                                  bit_coverage=bits),
             jreport.write_report(j_results, tmp_path / "ref", meta,
                                  bit_coverage=j_bits)]
    for a, b in zip(*paths):
        assert a.read_bytes() == b.read_bytes()
    assert treport.to_markdown(results, meta, bits) \
        == jreport.to_markdown(j_results, meta, j_bits)
