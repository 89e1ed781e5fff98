"""The port's quantization core and temporal redundancy held against the
reference's: the cases of tests/test_quant.py (hypothesis round trips,
zero exactly representable, the f32 requant against the gemmlowp oracle,
the straight-through gradient) on ``repro_torch.core.quant``, each
function bit-exact to ``repro.core.quant`` on shared inputs, and the
``dmr_apply`` case of tests/test_dependability.py with a ``tmr_apply``
twin."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import quant as jquant
from repro.core import redundancy as jred
from repro_torch.core import quant
from repro_torch.core import redundancy

jax.config.update("jax_platform_name", "cpu")


@st.composite
def float_arrays(draw, max_dim=64):
    n = draw(st.integers(1, max_dim))
    lo = draw(st.floats(-100.0, 0.0))
    hi = draw(st.floats(0.001, 100.0))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n,)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == getattr(torch, str(want.dtype))
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=50, deadline=None)
@given(float_arrays())
def test_quantize_roundtrip_bounded(x):
    scale, zp = quant.affine_qparams(torch.amin(_t(x)), torch.amax(_t(x)))
    q = quant.quantize(_t(x), scale, zp)
    deq = (q.to(torch.float32) - zp) * scale
    err = np.max(np.abs(deq.numpy() - x))
    assert err <= float(scale) * 0.501 + 1e-6
    # the same qparams and payload as the reference, bit for bit
    js, jz = jquant.affine_qparams(jnp.min(x), jnp.max(x))
    _eq(scale, js)
    _eq(zp, jz)
    _eq(q, jquant.quantize(jnp.asarray(x), js, jz))
    qt = quant.quantize_activation(_t(x))
    jqt = jquant.quantize_activation(jnp.asarray(x))
    _eq(qt.q, jqt.q)
    _eq(qt.dequantize(), jqt.dequantize())


@settings(max_examples=50, deadline=None)
@given(float_arrays())
def test_zero_exactly_representable(x):
    scale, zp = quant.affine_qparams(torch.amin(_t(x)), torch.amax(_t(x)))
    q0 = quant.quantize(torch.zeros(()), scale, zp)
    deq0 = (q0.to(torch.float32) - zp) * scale
    assert float(deq0) == 0.0


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.floats(1e-6, 0.99))
def test_fp32_requant_matches_gemmlowp(seed, multiplier):
    rng = np.random.default_rng(seed)
    acc = rng.integers(-(2**20), 2**20, size=(256, 8),
                       dtype=np.int64).astype(np.int32)
    out_zp = int(rng.integers(-20, 20))
    got = quant.requantize(_t(acc), torch.tensor(multiplier,
                                                 dtype=torch.float32),
                           torch.tensor(out_zp, dtype=torch.int32)).numpy()
    want = quant.requantize_gemmlowp_np(acc, multiplier, out_zp)
    np.testing.assert_array_equal(
        want, jquant.requantize_gemmlowp_np(acc, multiplier, out_zp))
    np.testing.assert_array_equal(got, np.asarray(jquant.requantize(
        jnp.asarray(acc), jnp.float32(multiplier), jnp.int32(out_zp))))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    # identical except possibly off-by-one on round-to-even ties
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-2


def test_quantize_multiplier_reconstruction():
    for real in [0.25, 0.5, 0.75, 1e-4, 0.9999, 0.0001234]:
        qm, shift = quant.quantize_multiplier_np(real)
        assert (qm, shift) == jquant.quantize_multiplier_np(real)
        assert abs(qm * 2.0 ** (shift - 31) - real) / real < 1e-8
    x = np.array([-(2**31), -7, -4, -3, 0, 3, 4, 5, 2**31 - 1], np.int64)
    for e in (0, 1, 2, 5):
        np.testing.assert_array_equal(quant.rounding_divide_by_pot_np(x, e),
                                      jquant.rounding_divide_by_pot_np(x, e))
    np.testing.assert_array_equal(quant.srdhm_np(x, -(2**31)),
                                  jquant.srdhm_np(x, -(2**31)))


def test_weight_quant_per_channel_symmetric():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    qt = quant.quantize_weight(_t(w), axis=-1)
    assert qt.q.dtype == torch.int8 and qt.dtype == torch.int8
    assert qt.shape == (32, 16) and qt.scale.shape == (16,)
    assert int(qt.zero_point) == 0
    assert int(qt.q.to(torch.int32).abs().max()) <= 127
    deq = qt.dequantize()
    err = (deq - _t(w)).abs().amax(dim=0)
    assert bool(torch.all(err <= qt.scale * 0.5 + 1e-7))
    _eq(deq, jquant.quantize_weight(jnp.asarray(w), axis=-1).dequantize())


def test_quantize_bias_matches_reference():
    rng = np.random.default_rng(2)
    b = (rng.normal(size=(16,)) * 3).astype(np.float32)
    s_in = np.float32(0.037)
    s_w = rng.uniform(0.001, 0.02, size=(16,)).astype(np.float32)
    _eq(quant.quantize_bias(_t(b), torch.tensor(s_in), _t(s_w)),
        jquant.quantize_bias(jnp.asarray(b), jnp.float32(s_in),
                             jnp.asarray(s_w)))


def test_fake_quant_idempotent_and_ste():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64,)).astype(np.float32) * 3
    scale, zp = quant.affine_qparams(torch.amin(_t(x)), torch.amax(_t(x)))
    y = quant.fake_quant(_t(x), scale, zp)
    y2 = quant.fake_quant(y, scale, zp)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), atol=1e-6)
    js, jz = jquant.affine_qparams(jnp.min(x), jnp.max(x))
    _eq(y, jquant.fake_quant(jnp.asarray(x), js, jz))

    # STE: grad == 1 in range, 0 where the quantizer saturates, equal to
    # jax.grad of the reference
    big = np.array([1e6, -1e6, 0.0, 1.5, -2.5], np.float32)
    v = _t(big).requires_grad_(True)
    quant.fake_quant(v, scale, zp).sum().backward()
    g = v.grad
    assert float(g[0]) == 0.0 and float(g[1]) == 0.0 and float(g[2]) == 1.0
    jg = jax.grad(lambda u: jnp.sum(jquant.fake_quant(u, js, jz)))(
        jnp.asarray(big))
    _eq(g, jg)


def test_observer_tracks_range():
    obs = quant.MinMaxObserver(torch.zeros(()), torch.zeros(()),
                               momentum=0.9)
    jobs = jquant.MinMaxObserver(jnp.zeros(()), jnp.zeros(()), momentum=0.9)
    batch = np.array([-2.0, 3.0], np.float32)
    for _ in range(100):
        obs = obs.update(_t(batch))
        jobs = jobs.update(jnp.asarray(batch))
    scale, zp = obs.qparams()
    assert float(scale) > 0
    assert float(obs.max_val) > 2.5 and float(obs.min_val) < -1.5
    _eq(obs.min_val, jobs.min_val)
    _eq(obs.max_val, jobs.max_val)
    js, jz = jobs.qparams()
    _eq(scale, js)
    _eq(zp, jz)
    fresh = quant.MinMaxObserver.init()
    assert float(fresh.min_val) == 0.0 and fresh.momentum == 0.99


# ---------------------------------------------------------------------------
# Temporal redundancy: dmr_apply, tmr_apply
# ---------------------------------------------------------------------------


def test_dmr_apply_detects_but_returns_replica0():
    f = lambda: torch.arange(8, dtype=torch.int32)            # noqa: E731

    def corrupt(y):
        y = y.clone()
        y[3] += 1
        return y

    y, det = redundancy.dmr_apply(f, injectors=(corrupt, None))
    assert bool(det)
    assert torch.equal(y, corrupt(f()))
    jy, jdet = jred.dmr_apply(lambda: jnp.arange(8, dtype=jnp.int32),
                              injectors=(lambda v: v.at[3].add(1), None))
    assert bool(det) == bool(jdet)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    y, det = redundancy.dmr_apply(f, injectors=(None, None))
    assert not bool(det)
    assert torch.equal(y, f())


@pytest.mark.parametrize("bad", [0, 1, 2])
def test_tmr_apply_outvotes_one_corrupted_replica(bad):
    """The ``tmr_apply`` twin: any one corrupted replica is outvoted bit
    for bit, over a pytree of mixed dtypes, as the reference's."""
    rng = np.random.default_rng(bad)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    n = rng.integers(-100, 100, size=(7,)).astype(np.int8)

    def f(a, b):
        return {"w": a * 2, "n": b}

    def hit(v):
        bits = v.view(torch.int32 if v.dtype == torch.float32
                      else torch.int8).clone()
        bits.reshape(-1)[1] ^= 1 << 6
        return bits.view(v.dtype)

    inj = [None, None, None]
    inj[bad] = hit
    got = redundancy.tmr_apply(f, _t(w), _t(n), injectors=inj)
    assert torch.equal(got["w"], _t(w) * 2) and torch.equal(got["n"], _t(n))

    def jhit(v):
        u = jnp.uint32 if v.dtype == jnp.float32 else jnp.uint8
        bits = jax.lax.bitcast_convert_type(v, u).reshape(-1)
        bits = bits.at[1].set(bits[1] ^ u(1 << 6))
        return jax.lax.bitcast_convert_type(bits.reshape(v.shape), v.dtype)

    jinj = [None, None, None]
    jinj[bad] = jhit
    want = jred.tmr_apply(lambda a, b: {"w": a * 2, "n": b},
                          jnp.asarray(w), jnp.asarray(n), injectors=jinj)
    _eq(got["w"], want["w"])
    _eq(got["n"], want["n"])
    # two corrupted replicas agree on the wrong bit and outvote the third
    two = redundancy.tmr_apply(f, _t(w), _t(n), injectors=(hit, hit, None))
    assert not torch.equal(two["w"], _t(w) * 2)
