"""The port's ship-detection CNN held bit-exact against the reference on
``reduced_specs``: every policy, a per-layer ``PolicyMap``, per-layer
backends, accumulator and weight strikes, from the reference's parameters
converted with ``shipdet_params_from_numpy``; plus the float oracle and the
device contract."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dependability import Policy as JPolicy
from repro.core.policy_map import PolicyMap as JPolicyMap
from repro.models import shipdet as jshipdet
from repro_torch.convert import shipdet_params_from_numpy
from repro_torch.core.dependability import DependabilityStats
from repro_torch.core.dependability import Policy as TPolicy
from repro_torch.core.fault_injection import flip_bit_at_index
from repro_torch.core.policy_map import PolicyMap as TPolicyMap
from repro_torch.models import shipdet as tshipdet

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = ["none", "abft", "dmr", "tmr", "ckpt"]
MAP_DOC = {"default": "none", "rules": [
    {"pattern": "stem", "policy": "tmr"},
    {"pattern": "conv_*", "policy": "abft"},
    {"pattern": "down*", "policy": "ckpt"},
    {"pattern": "det_head", "policy": "dmr", "backend": "ref"}]}


@pytest.fixture(scope="module")
def net():
    specs = jshipdet.reduced_specs()
    j_params = jshipdet.init_params(specs, jax.random.key(0))
    x = np.random.default_rng(1).uniform(
        size=(2, specs[0].h, specs[0].w, 3)).astype(np.float32)
    t_params = shipdet_params_from_numpy(jax.device_get(j_params),
                                         device="cpu")
    return specs, j_params, t_params, x


def _stats(s):
    return {k: int(v) for k, v in s.items()}


def _both(net, j_kw=None, t_kw=None, t_params=None, j_params=None):
    specs, jp, tp, x = net
    y_j, s_j = jshipdet.forward(specs, jp if j_params is None else j_params,
                                jnp.asarray(x), **(j_kw or {}))
    y_t, s_t = tshipdet.forward(tshipdet.reduced_specs(),
                                tp if t_params is None else t_params,
                                torch.from_numpy(x), **(t_kw or {}))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert DependabilityStats.to_host(s_t) == _stats(s_j)
    return y_t, _stats(s_j)


@pytest.mark.parametrize("policy", POLICIES)
def test_forward_matches_reference(net, policy):
    _, stats = _both(net, {"policy": JPolicy(policy)},
                     {"policy": TPolicy(policy)})
    assert stats["faults_detected"] == 0


def test_fused_forward_matches_pallas(net):
    """The default path (fused kernel) against the reference's Pallas
    kernel in interpret mode and its jnp path."""
    y_t, _ = _both(net, {"use_kernel": True, "interpret": True})
    specs, jp, _, x = net
    y_j, _ = jshipdet.forward(specs, jp, jnp.asarray(x), use_kernel=False)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


def test_policy_map_matches_reference(net):
    y_t, stats = _both(net, {"policy_map": JPolicyMap.from_doc(MAP_DOC)},
                       {"policy_map": TPolicyMap.from_doc(MAP_DOC)})
    assert stats["checks_run"] == len(net[0]) - 1
    y_plain, _ = _both(net)
    np.testing.assert_array_equal(y_t.numpy(), y_plain.numpy())


def test_per_layer_backends_match_reference(net):
    n = len(net[0])
    _both(net, {"backend": ["ref", "jnp"] * (n // 2), "policy": JPolicy.ABFT},
          {"backend": ["ref", "cuda"] * (n // 2), "policy": TPolicy.ABFT})


@pytest.mark.parametrize("policy", POLICIES)
def test_struck_forward_matches_reference(net, policy):
    """The same accumulator cell of the middle layer struck on both sides."""
    index, bit = 101, 18
    mask = jnp.int32(1 << bit)

    def j_inject(acc):
        flat = acc.reshape(-1)
        return flat.at[index].set(flat[index] ^ mask).reshape(acc.shape)

    if policy in ("dmr", "tmr"):        # replicate in the op, per layer
        j_kw = {"policy_map": JPolicyMap.uniform(policy)}
        t_kw = {"policy_map": TPolicyMap.uniform(policy)}
    else:
        j_kw, t_kw = {"policy": JPolicy(policy)}, {"policy": TPolicy(policy)}
    _, stats = _both(net, {**j_kw, "inject": j_inject},
                     {**t_kw, "inject": lambda acc:
                      flip_bit_at_index(acc, index, bit)})
    assert stats["faults_detected"] == (0 if policy == "none" else 1)


@pytest.mark.parametrize("policy,golden", [("abft", False), ("ckpt", True)])
def test_weight_seu_matches_reference(net, policy, golden):
    """A flipped weight bit in the middle layer, checked against the deploy
    checks: ABFT detects, CKPT with the golden weights heals."""
    specs, jp, tp, _ = net
    mid = len(specs) // 2
    j_struck = list(jp)
    w = np.asarray(jp[mid]["qconv"].w_q)
    w_bad = flip_bit_at_index(torch.from_numpy(w.copy()), 40, 6).numpy()
    j_struck[mid] = dict(jp[mid], qconv=jp[mid]["qconv"]._replace(
        w_q=jnp.asarray(w_bad)))
    t_struck = shipdet_params_from_numpy(jax.device_get(j_struck),
                                         device="cpu")
    j_kw = {"policy": JPolicy(policy),
            "w_checks": jshipdet.deploy_checks(jp)}
    t_kw = {"policy": TPolicy(policy),
            "w_checks": tshipdet.deploy_checks(tp)}
    if golden:
        j_kw["golden_wq"] = jshipdet.golden_weights(jp)
        t_kw["golden_wq"] = tshipdet.golden_weights(tp)
    y_t, stats = _both(net, j_kw, t_kw, t_params=t_struck, j_params=j_struck)
    assert stats["faults_detected"] >= 1
    if golden:
        assert stats["faults_recovered"] == 1
        np.testing.assert_array_equal(y_t.numpy(), _both(net)[0].numpy())


def test_float_forward_matches_reference(net):
    """Float oracle: the conv sums run in another order than XLA's, so it is
    held to a relative tolerance of 1e-5 of the output's scale."""
    specs, jp, tp, x = net
    y_j = np.asarray(jshipdet.float_forward(specs, jp, jnp.asarray(x)))
    y_t = tshipdet.float_forward(tshipdet.reduced_specs(), tp,
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5,
                               atol=1e-5 * np.abs(y_j).max())
    s_j, s_t = specs[0], tshipdet.reduced_specs()[0]
    np.testing.assert_array_equal(
        tshipdet.layer_forward(s_t, tp[0], torch.from_numpy(x)).numpy(),
        np.asarray(jshipdet.layer_forward(s_j, jp[0], jnp.asarray(x))))
    np.testing.assert_allclose(
        tshipdet.layer_forward(s_t, tp[0], torch.from_numpy(x),
                               quantized=False).numpy(),
        np.asarray(jshipdet.layer_forward(s_j, jp[0], jnp.asarray(x),
                                          quantized=False)),
        rtol=1e-5, atol=1e-6)


def test_specs_and_params_mirror_reference(net):
    assert [dataclasses.astuple(s) for s in tshipdet.network_specs()] \
        == [dataclasses.astuple(s) for s in jshipdet.network_specs()]
    assert [dataclasses.astuple(s) for s in tshipdet.reduced_specs()] \
        == [dataclasses.astuple(s) for s in jshipdet.reduced_specs()]
    assert [s.macs for s in tshipdet.TABLE1_LAYERS] \
        == [s.macs for s in jshipdet.TABLE1_LAYERS]
    _, jp, tp, _ = net
    for a, b in zip(tshipdet.deploy_checks(tp), jshipdet.deploy_checks(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tshipdet.golden_weights(tp), jshipdet.golden_weights(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    params = tshipdet.init_params(tshipdet.reduced_specs(),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    for s, p in zip(tshipdet.reduced_specs(), params):
        assert p["qconv"].w_q.dtype == torch.int8
        assert tuple(p["qconv"].w_q.shape) == (s.kh, s.kw, s.cin, s.cout)
        assert p["in_scale"].dtype == torch.float32 and p["in_zp"].dim() == 0


def test_entry_points_refuse_a_missing_card(net):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshipdet.init_params(tshipdet.reduced_specs(),
                             torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shipdet_params_from_numpy(jax.device_get(net[1]))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
