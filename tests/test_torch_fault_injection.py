"""The port's fault models (``repro_torch.core.fault_injection``) held
against ``repro.core.fault_injection``.

The reference draws its targets from ``jax.random`` keys, which torch
cannot reproduce, so each drawn model is held through its addressed twin:
the reference strikes a numpy input, the target (element, bit, cluster) is
recovered from its output by XOR, and the twin, given that target, must
give the same bits.  Then the drawn models' own contracts: clamping, the
stuck-at masking floor, idempotence, the binomial flip count of the rate
model, and the same fault for the same seed."""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fault_injection as jfi
from repro_torch.core import fault_injection as tfi

jax.config.update("jax_platform_name", "cpu")

DTYPES = ["int8", "int32", "bfloat16", "float32"]
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _input(dtype, shape=(6, 7), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)
    a = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16)) if dtype == "bfloat16" \
        else a


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize]).reshape(-1)


def _t(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _t_bits(t: torch.Tensor) -> np.ndarray:
    return _bits(tfi._as_bits(t)[0].numpy())


def _target(x, y):
    """(changed elements, per-element XOR masks) of a strike x → y."""
    diff = _bits(x) ^ _bits(y)
    idx = np.nonzero(diff)[0]
    return idx, diff[idx]


def _ref_strike(model, x, key):
    xj = jnp.asarray(x)
    if model == "flip_one_bit":
        return jfi.flip_one_bit(xj, key)
    if model == "flip_bit_at":
        return jfi.flip_bit_at(xj, key, 5)
    if model == "flip_burst":
        return jfi.flip_burst(xj, key, 3, 2)
    return jfi.stuck_at(xj, key, int(model[-1]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", ["flip_one_bit", "flip_bit_at",
                                   "flip_burst", "stuck_at0", "stuck_at1"])
def test_addressed_twin_bit_exact_to_reference(model, dtype):
    x = _input(dtype)
    width = x.dtype.itemsize * 8
    hits = 0
    for k in range(12):
        y = np.asarray(_ref_strike(model, x, jax.random.key(k)))
        idx, masks = _target(x, y)
        if model.startswith("stuck_at") and len(idx) == 0:
            continue                      # masked at the site: no target
        hits += 1
        if model == "flip_burst":
            assert len(idx) == 3 and np.all(np.diff(idx) == 1)
            assert np.all(masks == masks[0])
            b0 = int(masks[0]).bit_length() - bin(int(masks[0])).count("1")
            got = tfi.flip_burst_at(_t(x), int(idx[0]), b0, 3, 2)
        else:
            assert len(idx) == 1 and bin(int(masks[0])).count("1") == 1
            bit = int(masks[0]).bit_length() - 1
            if model == "flip_bit_at":
                assert bit == 5
            if model.startswith("stuck_at"):
                got = tfi.stuck_at_index(_t(x), int(idx[0]), bit,
                                         int(model[-1]))
            else:
                got = tfi.flip_bit_at_index(_t(x), int(idx[0]), bit)
        assert got.shape == tuple(x.shape) and got.element_size() * 8 == width
        np.testing.assert_array_equal(_t_bits(got), _bits(y))
    assert hits >= 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_stuck_at_masked_where_the_bit_already_holds(dtype):
    """The reference's masking floor, cell by cell: at a bit that already
    holds the stuck value both packages leave the tensor as it is."""
    x = _input(dtype)
    xb = _bits(x)
    for index in (0, 5, x.size - 1):
        for bit in range(x.dtype.itemsize * 8):
            value = (int(xb[index]) >> bit) & 1
            got = tfi.stuck_at_index(_t(x), index, bit, value)
            np.testing.assert_array_equal(_t_bits(got), xb)


def test_flip_burst_clamps_to_tensor_and_word():
    """As the reference's: a 4x64 burst on a one-element int32 tensor is
    clamped to every bit of that element, and lands."""
    x = np.asarray([[3]], np.int32)
    want = np.asarray(jfi.flip_burst(jnp.asarray(x), jax.random.key(0),
                                     elems=4, bits=64))
    for seed in range(3):
        y = tfi.flip_burst(_t(x), torch.Generator().manual_seed(seed),
                           elems=4, bits=64)
        assert y.shape == (1, 1) and int(y[0, 0]) != 3
        np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flip_burst_stays_inside_tensor_and_word(dtype):
    x = _t(_input(dtype, shape=(5,)))
    width = x.element_size() * 8
    for seed in range(40):
        y = tfi.flip_burst(x, torch.Generator().manual_seed(seed), 3, 4)
        diff = _t_bits(x) ^ _t_bits(y)
        idx = np.nonzero(diff)[0]
        assert len(idx) == 3 and idx[0] + 2 == idx[-1] <= 4
        mask = int(diff[idx[0]])
        assert np.all(diff[idx] == mask) and bin(mask).count("1") == 4
        assert mask.bit_length() <= width
        low = (mask & -mask).bit_length() - 1
        assert mask == 0b1111 << low


def test_addressed_faults_refuse_a_target_outside():
    x = torch.zeros(4, dtype=torch.int8)
    with pytest.raises(ValueError, match="bits"):
        tfi.flip_bit_at_index(x, 0, 8)
    with pytest.raises(ValueError, match="bits"):
        tfi.flip_burst_at(x, 0, 7, 1, 2)
    with pytest.raises(ValueError, match="elements"):
        tfi.flip_burst_at(x, 3, 0, 2, 1)
    with pytest.raises(ValueError, match="bits"):
        tfi.stuck_at_index(x, 0, -1, 1)


@pytest.mark.parametrize("value", [0, 1])
def test_stuck_at_is_idempotent(value):
    x = _t(_input("int32"))
    once = tfi.stuck_at(x, torch.Generator().manual_seed(3), value)
    twice = tfi.stuck_at(once, torch.Generator().manual_seed(3), value)
    assert torch.equal(once, twice)
    for index, bit in ((0, 0), (7, 31), (41, 13)):
        a = tfi.stuck_at_index(x, index, bit, value)
        assert torch.equal(a, tfi.stuck_at_index(a, index, bit, value))


def test_stuck_at_forces_single_bit():
    x = torch.zeros(128, dtype=torch.int32)
    y1 = tfi.stuck_at(x, torch.Generator().manual_seed(0), 1)
    diff = y1 != 0
    assert int(diff.sum()) == 1
    assert bin(int(y1[diff][0]) & 0xFFFFFFFF).count("1") == 1
    y0 = tfi.stuck_at(x, torch.Generator().manual_seed(0), 0)
    assert torch.equal(y0, x)


@pytest.mark.parametrize("rate", [1e-3, 2e-2])
def test_flip_bits_at_rate_count_within_binomial_bound(rate):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    y = tfi.flip_bits_at_rate(x, torch.Generator().manual_seed(2), rate)
    flips = sum(bin(int(v) & 0xFFFFFFFF).count("1")
                for v in (_t_bits(x) ^ _t_bits(y)).tolist())
    n = x.numel() * 32
    mean, sd = n * rate, math.sqrt(n * rate * (1 - rate))
    assert abs(flips - mean) <= 6 * sd, (flips, mean, sd)
    assert y.dtype == x.dtype and y.shape == x.shape


def test_flip_bits_at_rate_edges():
    x = _t(_input("int8"))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tfi.flip_bits_at_rate(x, g, 0.0), x)
    assert torch.equal(tfi.flip_bits_at_rate(x, g, 1.0), ~x)


MODELS = {
    "flip_one_bit": tfi.flip_one_bit,
    "flip_bit_at": lambda x, g: tfi.flip_bit_at(x, g, 3),
    "flip_burst": lambda x, g: tfi.flip_burst(x, g, 2, 2),
    "stuck_at1": lambda x, g: tfi.stuck_at(x, g, 1),
    "flip_bits_at_rate": lambda x, g: tfi.flip_bits_at_rate(x, g, 0.05),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_same_seed_same_fault_and_input_untouched(model):
    x = _t(_input("float32", shape=(64,)))
    before = x.clone()
    fault = MODELS[model]
    a = fault(x, torch.Generator().manual_seed(11))
    b = fault(x, torch.Generator().manual_seed(11))
    assert torch.equal(_t_bits_tensor(a), _t_bits_tensor(b))
    assert torch.equal(_t_bits_tensor(x), _t_bits_tensor(before))
    others = [fault(x, torch.Generator().manual_seed(s)) for s in range(12)]
    assert any(not torch.equal(_t_bits_tensor(o), _t_bits_tensor(a))
               for o in others)


def _t_bits_tensor(t):
    return tfi._as_bits(t)[0]
