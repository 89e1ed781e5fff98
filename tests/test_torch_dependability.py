"""The port's dependability layer held bit-exact against the reference:
``dependable_qconv2d`` under all five policies (outputs and
``DependabilityStats``), the same (index, bit) strikes on both sides, the
voting and bit-flip primitives, and the backend registry's precedence."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import redundancy as jred
from repro.core.dependability import Policy as JPolicy
from repro.core.dependability import dependable_qconv2d as j_dep_conv
from repro_torch.core import abft as tabft
from repro_torch.core import backend as tbackend
from repro_torch.core import redundancy as tred
from repro_torch.core.dependability import DependabilityStats
from repro_torch.core.dependability import Policy as TPolicy
from repro_torch.core.dependability import dependable_qconv2d as t_dep_conv
from repro_torch.core.fault_injection import flip_bit_at_index
from repro_torch.kernels import dispatch as tdispatch

jax.config.update("jax_platform_name", "cpu")

POLICIES = ["none", "abft", "dmr", "tmr", "ckpt"]


def _case(seed, n=2, h=9, w=8, cin=12, cout=20, k=3):
    rng = np.random.default_rng(seed)
    return dict(
        x_q=rng.integers(-128, 128, (n, h, w, cin)).astype(np.int8),
        w_q=rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8),
        bias=rng.integers(-2000, 2000, (cout,)).astype(np.int32),
        scale=rng.uniform(1e-4, 2e-3, (cout,)).astype(np.float32),
        x_zp=np.int32(-3), out_zp=np.int32(4))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j_flip(index, bit):
    """The reference side of ``flip_bit_at_index`` on an int32 tensor."""
    mask = jnp.int32(np.uint32(1 << bit).astype(np.int32))

    def inject(acc):
        flat = acc.reshape(-1)
        return flat.at[index].set(flat[index] ^ mask).reshape(acc.shape)
    return inject


def _run_both(policy, c, *, j_backend, t_backend, stride=(1, 1),
              padding="SAME", j_inject=None, t_inject=None, w_live=None,
              golden=False):
    """One dependable conv on each side; ``w_live`` replaces the live
    weights (a weight SEU), checked against the clean deploy-time filter
    and, with ``golden``, rolled back to the clean weights."""
    w_live = c["w_q"] if w_live is None else w_live
    j_kw, t_kw = {}, {}
    if w_live is not c["w_q"]:
        j_kw["w_check"] = jabft.conv_checksum_weight(jnp.asarray(c["w_q"]))
        t_kw["w_check"] = tabft.conv_checksum_weight(_t(c["w_q"]))
    y_j, s_j = j_dep_conv(
        JPolicy(policy), jnp.asarray(c["x_q"]), jnp.int32(c["x_zp"]),
        jnp.asarray(w_live), jnp.asarray(c["bias"]), jnp.asarray(c["scale"]),
        jnp.int32(c["out_zp"]), stride=stride, padding=padding,
        inject=j_inject, backend=j_backend,
        ckpt=(jnp.asarray(c["x_q"]), jnp.asarray(c["w_q"])) if golden
        else None, **j_kw)
    y_t, s_t = t_dep_conv(
        TPolicy(policy), _t(c["x_q"]), _t(c["x_zp"]), _t(w_live),
        _t(c["bias"]), _t(c["scale"]), _t(c["out_zp"]), stride=stride,
        padding=padding, inject=t_inject, backend=t_backend,
        ckpt=(_t(c["x_q"]), _t(c["w_q"])) if golden else None, **t_kw)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    s_j = {k: int(v) for k, v in s_j.items()}
    assert DependabilityStats.to_host(s_t) == s_j
    return s_j


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stride,padding", [((1, 1), "SAME"),
                                            ((2, 2), "SAME"),
                                            ((2, 1), "VALID")])
def test_policies_match_reference(policy, stride, padding, t_backend):
    c = _case(5)
    stats = _run_both(policy, c, j_backend="ref", t_backend=t_backend,
                      stride=stride, padding=padding)
    assert stats["faults_detected"] == 0


@pytest.mark.parametrize("policy", ["none", "abft"])
def test_policies_match_pallas_backend(policy):
    """Against the reference's Pallas kernels (interpret mode off-TPU)."""
    _run_both(policy, _case(6), j_backend="pallas", t_backend="cuda")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("bit", [3, 18, 31])
def test_same_strike_same_counts(policy, bit):
    """The same accumulator cell struck on both sides: detected, corrected
    and recovered counts (and the outputs) match."""
    c = _case(7)
    index = 2 * 9 * 8 * 20 // 3 + 5
    stats = _run_both(policy, c, j_backend="ref", t_backend="cuda",
                      j_inject=_j_flip(index, bit),
                      t_inject=lambda acc: flip_bit_at_index(acc, index, bit))
    # the checksum sees every flipped bit; DMR/TMR compare requantised
    # outputs, where a low accumulator bit can be masked
    if policy in ("abft", "ckpt") or (policy != "none" and bit >= 18):
        assert stats["faults_detected"] == 1


@pytest.mark.parametrize("policy,golden", [("abft", False), ("ckpt", False),
                                           ("ckpt", True)])
def test_weight_seu_against_deploy_checks(policy, golden):
    """A flipped weight bit, checked against the deploy-time filter: ABFT
    detects, CKPT with the golden weights rolls back and recovers."""
    c = _case(8)
    w_live = flip_bit_at_index(_t(c["w_q"]), 100, 6).numpy()
    stats = _run_both(policy, c, j_backend="ref", t_backend="cuda",
                      w_live=w_live, golden=golden)
    assert stats["faults_detected"] >= 1       # ABFT counts pixels
    assert stats["faults_recovered"] == int(golden)


@pytest.mark.parametrize("dtype,bits", [(np.int8, 8), (np.int32, 32),
                                        (np.float32, 32)])
def test_vote_agree_and_flips_match(dtype, bits):
    rng = np.random.default_rng(bits)
    a = rng.integers(-100, 100, (5, 7)).astype(dtype)
    for bit in (0, bits // 2, bits - 1):
        flipped = flip_bit_at_index(_t(a), 11, bit).numpy()
        u = np.dtype(f"uint{bits}")
        want = a.copy().view(u).reshape(-1)
        want[11] ^= u.type(1 << bit)
        np.testing.assert_array_equal(flipped.view(u).reshape(-1), want)
        for reps in ([a, a, flipped], [a, flipped, a], [flipped, a, a]):
            t_vote = tred.vote([_t(r) for r in reps])
            j_vote = jred.vote([jnp.asarray(r) for r in reps])
            np.testing.assert_array_equal(t_vote.numpy().view(u),
                                          np.asarray(j_vote).view(u))
            np.testing.assert_array_equal(t_vote.numpy().view(u),
                                          a.view(u))
            assert bool(tred.agree([_t(r) for r in reps])) \
                == bool(jred.agree([jnp.asarray(r) for r in reps])) is False
    assert bool(tred.agree([_t(a), _t(a)]))


def test_backend_precedence():
    assert tbackend.default_backend() == "cuda"
    assert {"cuda", "ref"} <= set(tbackend.available_backends())
    with tbackend.use_backend("ref"):
        assert tbackend.resolve(None).name == "ref"
        assert tbackend.resolve("cuda").name == "cuda"       # per-call wins
        with tbackend.use_backend("cuda"):
            assert tbackend.resolve(None).name == "cuda"
        assert tbackend.default_backend() == "ref"
    assert tbackend.default_backend() == "cuda"
    be = tbackend.get_backend("ref")
    assert tbackend.resolve(be) is be
    tbackend.set_default_backend("ref")
    try:
        assert tbackend.resolve(None).name == "ref"
    finally:
        tbackend.set_default_backend("cuda")
    with pytest.raises(KeyError, match="unknown backend"):
        tbackend.get_backend("jnp")


def test_scoped_backend_reaches_dependable_ops():
    c = _case(9)
    args = (_t(c["x_q"]), _t(c["x_zp"]), _t(c["w_q"]), _t(c["bias"]),
            _t(c["scale"]), _t(c["out_zp"]))
    calls = []
    spy = tbackend.Backend(
        name="spy",
        conv_acc=lambda *a: calls.append("acc") or tdispatch.conv_acc(
            *a, backend="ref"),
        conv_acc_checksum=lambda *a: calls.append("chk")
        or tdispatch.conv_acc_checksum(*a, backend="ref"))
    tbackend.register_backend(spy, overwrite=True)
    try:
        y_default, _ = t_dep_conv(TPolicy.ABFT, *args)
        with tbackend.use_backend("spy"):
            y_spy, _ = t_dep_conv(TPolicy.ABFT, *args)
            t_dep_conv(TPolicy.TMR, *args, backend="ref")    # per-call wins
    finally:
        del tbackend._REGISTRY["spy"]
    assert calls == ["chk"]
    np.testing.assert_array_equal(y_spy.numpy(), y_default.numpy())


def test_unported_entries_name_their_roadmap_item():
    """Every registry entry is in, and so is the attention backward
    (training): a gradient flows through ``flash_attn_model`` where it was
    refused before."""
    from repro_torch.kernels import flash_attn_model
    x = torch.zeros((2, 2), dtype=torch.int8)
    q = torch.zeros((1, 4, 2, 16))
    for be in ("ref", "cuda"):
        assert tdispatch.matmul_acc(x, x, backend=be).dtype == torch.int32
        assert tdispatch.attn(q, q, q, backend=be).shape == q.shape
    qg = q.clone().requires_grad_()
    flash_attn_model(qg, q, q).sum().backward()
    assert qg.grad is not None and qg.grad.shape == q.shape
    assert bool(torch.isfinite(qg.grad).all())
