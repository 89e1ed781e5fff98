"""The port's qconv2d (ops, kernel wrappers' plain versions, oracle) held
bit-exact against the reference package: its jnp oracle and its Pallas
kernels in interpret mode, on the same numpy inputs."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.kernels.qconv2d import kernel as jkernel
from repro.kernels.qconv2d import ops as jops
from repro.kernels.qconv2d.ref import qconv2d_ref as jqconv2d_ref
from repro_torch.core import abft as tabft
from repro_torch.core import quant as tquant
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.qconv2d import kernel as tkernel
from repro_torch.kernels.qconv2d import ops as tops
from repro_torch.kernels.qconv2d import ref as tref

jax.config.update("jax_platform_name", "cpu")

# (n, h, w, cin, kh, kw, cout, stride, padding)
CASES = [
    # the four Table-1 layers of tests/test_qconv2d.py, reduced spatially
    (1, 48, 48, 24, 3, 3, 24, (1, 1), "SAME"),
    (1, 24, 24, 48, 3, 3, 48, (1, 1), "SAME"),
    (1, 12, 12, 96, 3, 3, 96, (1, 1), "SAME"),
    (1, 24, 24, 96, 1, 1, 96, (1, 1), "SAME"),
    # the stem: Cin = 3 at stride 2, asymmetric SAME pads
    (2, 24, 24, 3, 3, 3, 24, (2, 2), "SAME"),
] + [(2, 17, 19, 8, 3, 3, 16, stride, padding)
     for stride in ((1, 1), (2, 2), (2, 1)) for padding in ("SAME", "VALID")]
IDS = [f"{c[3]}x{c[4]}x{c[5]}x{c[6]}@{c[1]}x{c[2]}-s{c[7][0]}{c[7][1]}-{c[8]}"
       for c in CASES]


def _case(seed, n, h, w, cin, kh, kw, cout):
    rng = np.random.default_rng(seed)
    return dict(
        x_q=rng.integers(-128, 128, (n, h, w, cin)).astype(np.int8),
        w_q=rng.integers(-127, 128, (kh, kw, cin, cout)).astype(np.int8),
        bias=rng.integers(-1000, 1000, (cout,)).astype(np.int32),
        scale=rng.uniform(1e-4, 5e-3, (cout,)).astype(np.float32),
        x_zp=np.int32(rng.integers(-10, 10)),
        out_zp=np.int32(rng.integers(-10, 10)))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_qconv2d_op_matches_reference(case):
    n, h, w, cin, kh, kw, cout, stride, padding = case
    c = _case(7 * cin + kh, n, h, w, cin, kh, kw, cout)
    colsum = c["w_q"].astype(np.int32).sum(axis=(0, 1, 2)).astype(np.int32)
    want = jqconv2d_ref(jnp.asarray(c["x_q"]), jnp.int32(c["x_zp"]),
                        jnp.asarray(c["w_q"]), jnp.asarray(c["bias"]),
                        jnp.asarray(c["scale"]), jnp.int32(c["out_zp"]),
                        stride=stride, padding=padding)
    pallas = jops.qconv2d_op(
        jnp.asarray(c["x_q"]), jnp.int32(c["x_zp"]), jnp.asarray(c["w_q"]),
        jnp.asarray(colsum), jnp.asarray(c["bias"]), jnp.asarray(c["scale"]),
        jnp.int32(c["out_zp"]), stride=stride, padding=padding,
        use_kernel=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    got = tops.qconv2d_op(_t(c["x_q"]), _t(c["x_zp"]), _t(c["w_q"]),
                          _t(colsum), _t(c["bias"]), _t(c["scale"]),
                          _t(c["out_zp"]), stride=stride, padding=padding)
    _eq(got, want)
    oracle = tref.qconv2d_ref(_t(c["x_q"]), _t(c["x_zp"]), _t(c["w_q"]),
                              _t(c["bias"]), _t(c["scale"]), _t(c["out_zp"]),
                              stride=stride, padding=padding)
    _eq(oracle, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_acc_kernels_match_pallas(case):
    """The accumulator kernels' plain versions against the Pallas kernels
    (interpret mode) on the same zero-point-padded input, and the port's
    two backends against the reference's ref backend."""
    n, h, w, cin, kh, kw, cout, stride, padding = case
    c = _case(11 * cin + kw, n, h, w, cin, kh, kw, cout)
    x_zp = jnp.int32(c["x_zp"])
    pads = jdispatch._resolve_pads(h, w, kh, kw, stride, padding)
    assert tops.resolve_pads(h, w, kh, kw, stride, padding) == pads
    xp = jdispatch._pad_zp(jnp.asarray(c["x_q"]), x_zp, pads)
    colsum = jnp.sum(jnp.asarray(c["w_q"]).astype(jnp.int32), axis=(0, 1, 2))
    w_check = jabft.conv_checksum_weight(jnp.asarray(c["w_q"]))
    zp = x_zp.reshape(1)

    acc = jkernel.qconv2d_acc(xp, jnp.asarray(c["w_q"]), colsum, zp,
                              stride=stride, interpret=True)
    acc2, want = jkernel.qconv2d_acc_checksum(
        xp, jnp.asarray(c["w_q"]), colsum, w_check, zp, stride=stride,
        interpret=True)

    t_xp = tops.pad_zp(_t(c["x_q"]), _t(c["x_zp"]), pads)
    _eq(t_xp, xp)
    t_w = _t(c["w_q"])
    t_wc = tabft.conv_checksum_weight(t_w)
    _eq(t_wc, w_check)
    _eq(tkernel.qconv2d_acc(t_xp, t_w, tops.weight_colsum(t_w),
                            _t(zp), stride=stride), acc)
    t_acc, t_want = tkernel.qconv2d_acc_checksum(
        t_xp, t_w, tops.weight_colsum(t_w), t_wc, _t(zp), stride=stride)
    _eq(t_acc, acc2)
    _eq(t_want, want)
    _eq(tabft.channel_checksum(t_acc), want)

    ref_acc, ref_want = jdispatch.conv_acc_checksum(
        jnp.asarray(c["x_q"]), x_zp, jnp.asarray(c["w_q"]), w_check, stride,
        padding, backend="ref")
    for be in ("ref", "cuda"):
        _eq(tdispatch.conv_acc(_t(c["x_q"]), _t(c["x_zp"]), t_w, stride,
                               padding, backend=be), ref_acc)
        b_acc, b_want = tdispatch.conv_acc_checksum(
            _t(c["x_q"]), _t(c["x_zp"]), t_w, t_wc, stride, padding,
            backend=be)
        _eq(b_acc, ref_acc)
        _eq(b_want, ref_want)


def test_check_channel_wraps_mod_2_32():
    """Extreme operands drive the ABFT check channel past 2^31 in magnitude
    (Cout = 96: each w_check entry is 96·127); every path must wrap it to
    the same int32."""
    n, h, w, cin, cout = 1, 5, 5, 96, 96
    x_q = np.full((n, h, w, cin), -128, np.int8)
    w_q = np.full((3, 3, cin, cout), 127, np.int8)
    x_zp = np.int32(127)
    exact = 9 * cin * (-128 - 127) * (cout * 127)
    assert exact < -2**31
    wrapped = np.int64(exact) % 2**32
    wrapped = np.int32(wrapped - 2**32 if wrapped >= 2**31 else wrapped)

    w_check = jabft.conv_checksum_weight(jnp.asarray(w_q))
    _, j_want = jdispatch.conv_acc_checksum(
        jnp.asarray(x_q), jnp.int32(x_zp), jnp.asarray(w_q), w_check,
        (1, 1), "VALID", backend="ref")
    colsum = jnp.sum(jnp.asarray(w_q).astype(jnp.int32), axis=(0, 1, 2))
    _, p_want = jkernel.qconv2d_acc_checksum(
        jnp.asarray(x_q), jnp.asarray(w_q), colsum, w_check,
        jnp.int32(x_zp).reshape(1), interpret=True)
    np.testing.assert_array_equal(np.asarray(j_want), wrapped)
    np.testing.assert_array_equal(np.asarray(p_want), wrapped)

    t_w = _t(w_q)
    for be in ("ref", "cuda"):
        acc, want = tdispatch.conv_acc_checksum(
            _t(x_q), _t(x_zp), t_w, tabft.conv_checksum_weight(t_w), (1, 1),
            "VALID", backend=be)
        np.testing.assert_array_equal(want.numpy(), wrapped)
        _eq(tabft.channel_checksum(acc), want.numpy())


def test_make_qconv_params_and_quant_match():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 3, 24, 40)).astype(np.float32) * 0.05
    b = rng.normal(size=(40,)).astype(np.float32)
    j = jops.make_qconv_params(jnp.asarray(w), jnp.asarray(b))
    t = tops.make_qconv_params(_t(w), _t(b))
    for f in tops.QConvParams._fields:
        _eq(getattr(t, f), getattr(j, f))

    # round-half-to-even ties, clipping and per-channel requantisation
    scale = np.float32(0.25)
    x = np.concatenate([np.arange(-40, 40, 0.125, dtype=np.float32),
                        np.float32([1e6, -1e6])])
    _eq(tquant.quantize(_t(x), _t(scale), _t(np.int32(3))),
        jquant.quantize(jnp.asarray(x), jnp.float32(scale), jnp.int32(3)))
    acc = rng.integers(-2**31, 2**31, (64, 40), dtype=np.int64).astype(
        np.int32)
    rq = tquant.requant_scale(_t(np.float32(0.05)), t.w_scale,
                              _t(np.float32(0.07)))
    _eq(rq, jquant.requant_scale(jnp.float32(0.05), j.w_scale,
                                 jnp.float32(0.07)))
    _eq(tquant.requantize(_t(acc), rq, _t(np.int32(-5))),
        jquant.requantize(jnp.asarray(acc), jnp.asarray(rq.numpy()),
                          jnp.int32(-5)))


def test_same_pads_stem_is_asymmetric():
    assert tops._same_pads(388, 388, 3, 3, 2, 2) == ((0, 1), (0, 1))
    for args in ((388, 388, 3, 3, 2, 2), (194, 194, 3, 3, 2, 2),
                 (17, 19, 3, 3, 2, 1), (50, 50, 1, 1, 1, 1)):
        assert tops._same_pads(*args) == jops._same_pads(*args)


def test_kernel_wrappers_validate_inputs():
    x_p = torch.zeros((1, 6, 6, 8), dtype=torch.int8)
    w_q = torch.zeros((3, 3, 8, 4), dtype=torch.int8)
    colsum = torch.zeros((4,), dtype=torch.int32)
    zp = torch.zeros((1,), dtype=torch.int32)
    assert tkernel.qconv2d_acc(x_p, w_q, colsum, zp).shape == (1, 4, 4, 4)
    with pytest.raises(TypeError):
        tkernel.qconv2d_acc(x_p.to(torch.int32), w_q, colsum, zp)
    with pytest.raises(ValueError, match="colsum"):
        tkernel.qconv2d_acc(x_p, w_q, colsum[:3], zp)
    with pytest.raises(ValueError, match="geometry"):
        tkernel.qconv2d_acc(x_p, w_q[:, :, :4], colsum, zp)
    # meta inputs (the dry-run): the kernel's output, shape and dtype
    # only, and no launch; a mix of devices raises
    out = tkernel.qconv2d_acc(x_p.to("meta"), w_q.to("meta"),
                              colsum.to("meta"), zp.to("meta"))
    assert (out.device.type, out.shape, out.dtype) == \
        ("meta", (1, 4, 4, 4), torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        tkernel.qconv2d_acc(x_p.to("meta"), w_q, colsum, zp)
    # neither the plain version nor the meta path is a kernel launch
    assert tkernel.qconv2d_acc.launches == 0
