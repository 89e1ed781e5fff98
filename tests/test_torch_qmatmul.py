"""The port's qmatmul (ref, kernel wrappers' plain versions, ops, the
matmul entries of the backends, ABFT and the matmul policies) held
bit-exact against the reference package: its jnp oracle and its Pallas
kernels in interpret mode, on the same numpy inputs.  Mirrors
tests/test_qmatmul.py and the matmul cases of tests/test_backend.py."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import quant as jquant
from repro.core.dependability import Policy as JPolicy
from repro.core.dependability import dependable_matmul_acc as j_dep_acc
from repro.core.dependability import dependable_qmatmul as j_dep_mm
from repro.kernels.qmatmul import kernel as jkernel
from repro.kernels.qmatmul import ops as jops
from repro.kernels.qmatmul.ref import qmatmul_acc_ref as j_acc_ref
from repro.kernels.qmatmul.ref import qmatmul_ref as j_qmatmul_ref
from repro.models import transformer as jtfm
from repro_torch.core import abft as tabft
from repro_torch.core.dependability import DependabilityStats
from repro_torch.core.dependability import Policy as TPolicy
from repro_torch.core.dependability import dependable_matmul_acc as t_dep_acc
from repro_torch.core.dependability import dependable_qmatmul as t_dep_mm
from repro_torch.core.fault_injection import flip_bit_at_index
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.qmatmul import kernel as tkernel
from repro_torch.kernels.qmatmul import ops as tops
from repro_torch.kernels.qmatmul import ref as tref
from repro_torch.models import transformer as ttfm

jax.config.update("jax_platform_name", "cpu")

POLICIES = ["none", "abft", "dmr", "tmr", "ckpt"]
# the shapes of tests/test_qmatmul.py
SHAPES = [(8, 16, 8), (128, 128, 128), (256, 512, 384), (1, 4096, 128),
          (130, 257, 129)]


def _case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    return dict(
        x_q=rng.integers(-128, 128, (m, k)).astype(np.int8), w_q=w_q,
        colsum=w_q.astype(np.int32).sum(axis=0).astype(np.int32),
        bias=rng.integers(-1000, 1000, (n,)).astype(np.int32),
        scale=rng.uniform(1e-4, 2e-2, (n,)).astype(np.float32),
        x_zp=np.int32(rng.integers(-10, 10)),
        out_zp=np.int32(rng.integers(-10, 10)))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _j(c, *names):
    return [jnp.asarray(c[n]) for n in names]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_qmatmul_kernel_matches_reference(m, k, n):
    """The fused kernel's plain version and the port's oracle against the
    Pallas kernel (interpret mode) and the reference oracle."""
    c = _case(m * 7919 + k * 31 + n, m, k, n)
    x_q, w_q, colsum, bias, scale = _j(c, "x_q", "w_q", "colsum", "bias",
                                       "scale")
    zps = jnp.stack([jnp.int32(c["x_zp"]), jnp.int32(c["out_zp"])])
    want = j_qmatmul_ref(x_q, jnp.int32(c["x_zp"]), w_q, bias, scale,
                         jnp.int32(c["out_zp"]))
    pallas = jkernel.qmatmul(x_q, w_q, colsum, bias, scale, zps,
                             interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    _eq(tkernel.qmatmul(_t(c["x_q"]), _t(c["w_q"]), _t(c["colsum"]),
                        _t(c["bias"]), _t(c["scale"]), _t(np.asarray(zps))),
        want)
    _eq(tref.qmatmul_ref(_t(c["x_q"]), _t(c["x_zp"]), _t(c["w_q"]),
                         _t(c["bias"]), _t(c["scale"]), _t(c["out_zp"])),
        want)
    _eq(tops.qmatmul_op(_t(c["x_q"]), _t(c["x_zp"]), _t(c["w_q"]),
                        _t(c["colsum"]), _t(c["bias"]), _t(c["scale"]),
                        _t(c["out_zp"])), want)


@pytest.mark.parametrize("m,k,n,blocks", [
    (33, 130, 70, (16, 32, 48)),          # multi-block grid, ragged K/N tails
    (17, 70, 24, (128, 128, 512)),
    (8, 128, 64, (8, 32, 48)),
    (5, 100, 37, (128, 128, 512)),
])
def test_acc_kernels_match_pallas(m, k, n, blocks):
    """``qmatmul_acc`` and ``qmatmul_acc_checksum`` against the Pallas
    kernels, including forced multi-block grids with K-tail masking and the
    n == 0 check-vector accumulation."""
    c = _case(m + k + n, m, k, n)
    x_q, w_q = _j(c, "x_q", "w_q")
    bm, bn, bk = blocks
    w_check = jabft.checksum_vector(w_q)
    j_acc = jkernel.qmatmul_acc(x_q, w_q, block_m=bm, block_n=bn, block_k=bk,
                                interpret=True)
    j_acc2, j_want = jkernel.qmatmul_acc_checksum(
        x_q, w_q, w_check, block_m=bm, block_n=bn, block_k=bk,
        interpret=True)
    t_check = tabft.checksum_vector(_t(c["w_q"]))
    _eq(t_check, w_check)
    _eq(tkernel.qmatmul_acc(_t(c["x_q"]), _t(c["w_q"])), j_acc)
    t_acc2, t_want = tkernel.qmatmul_acc_checksum(_t(c["x_q"]),
                                                  _t(c["w_q"]), t_check)
    _eq(t_acc2, j_acc2)
    _eq(t_want, j_want)
    _eq(tabft.row_checksum(t_acc2), t_want)


def test_check_vector_wraps_like_the_reference():
    """At K = N = 1536 with extreme operands X·w_check passes 2^31; both
    sides wrap it mod 2^32."""
    x = np.full((4, 1536), -128, np.int8)
    w = np.full((1536, 1536), 127, np.int8)
    w_check = jabft.checksum_vector(jnp.asarray(w))
    _, j_want = jkernel.qmatmul_acc_checksum(jnp.asarray(x), jnp.asarray(w),
                                             w_check, interpret=True)
    assert abs(-128 * 127 * 1536 * 1536) > 2 ** 31
    _, t_want = tkernel.qmatmul_acc_checksum(
        _t(x), _t(w), tabft.checksum_vector(_t(w)))
    _eq(t_want, j_want)


@pytest.mark.parametrize("seed", range(8))
def test_qmatmul_acc_int_exact_vs_numpy(seed):
    """The int32 accumulator is exact against int64 numpy (no hidden
    float), on the oracle and on both backends' raw entries."""
    rng = np.random.default_rng(seed)
    m, k, n = (int(rng.integers(1, 64)) for _ in range(3))
    c = _case(seed, m, k, n)
    want = (c["x_q"].astype(np.int64) - int(c["x_zp"])) \
        @ c["w_q"].astype(np.int64) + c["bias"].astype(np.int64)
    acc = tref.qmatmul_acc_ref(_t(c["x_q"]), _t(c["x_zp"]), _t(c["w_q"]),
                               _t(c["bias"]))
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), want)
    _eq(acc, j_acc_ref(*_j(c, "x_q", "x_zp", "w_q", "bias")))
    raw = c["x_q"].astype(np.int64) @ c["w_q"].astype(np.int64)
    for be in ("ref", "cuda"):
        got = tdispatch.matmul_acc(_t(c["x_q"]), _t(c["w_q"]), backend=be)
        np.testing.assert_array_equal(got.numpy().astype(np.int64), raw)


def _qparams(x):
    scale, zp = jquant.affine_qparams(jnp.min(x), jnp.max(x))
    return scale, zp, _t(np.asarray(scale)), _t(np.asarray(zp))


def test_qlinear_act_matches_reference_and_float():
    """float→int8→float round trip: bit-exact to the reference's fused
    kernel path, and within 2 % of the float matmul (the reference's
    bound)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 64)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    j_params = jops.make_qlinear_params(jnp.asarray(w), jnp.asarray(b))
    t_params = tops.make_qlinear_params(_t(w), _t(b))
    for got, want in zip(t_params, j_params):
        _eq(got, want)
    y_f = x @ w + b
    xs, xz, t_xs, t_xz = _qparams(jnp.asarray(x))
    os_, oz, t_os, t_oz = _qparams(jnp.asarray(y_f))
    j_y = jops.qlinear_act(jnp.asarray(x), j_params, xs, xz, os_, oz,
                           use_kernel=True, interpret=True)
    t_y = tops.qlinear_act(_t(x), t_params, t_xs, t_xz, t_os, t_oz)
    _eq(t_y, j_y)
    rel = np.linalg.norm(t_y.numpy() - y_f) / np.linalg.norm(y_f)
    assert rel < 0.02, rel


def test_qlinear_bf16out_matches_reference_and_float():
    """The float-output W8A8 linear: the int32 accumulator path is exact,
    the f32 epilogue agrees to 1e-6 relative (XLA may contract its
    multiply-add into an FMA, the port does not) and stays within 2 % of
    the float matmul."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 32)) * 0.02).astype(np.float32)
    j_params = jops.make_qlinear_params(jnp.asarray(w))
    t_params = tops.make_qlinear_params(_t(w))
    xs, xz, t_xs, t_xz = _qparams(jnp.asarray(x))
    j_y = jops.qlinear_int8_bf16out(jnp.asarray(x), j_params, xs, xz)
    t_y = tops.qlinear_int8_bf16out(_t(x), t_params, t_xs, t_xz)
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), rtol=1e-6,
                               atol=1e-6)
    y_f = x @ w
    rel = np.linalg.norm(t_y.numpy() - y_f) / np.linalg.norm(y_f)
    assert rel < 0.02, rel


# ---------------------------------------------------------------------------
# The backends' matmul entries and the policies (tests/test_backend.py)
# ---------------------------------------------------------------------------


def _mm_case(seed, m=17, k=70, n=24):
    rng = np.random.default_rng(seed)
    return dict(x_q=rng.integers(-128, 128, (m, k)).astype(np.int8),
                w_q=rng.integers(-127, 128, (k, n)).astype(np.int8),
                bias=rng.integers(-500, 500, (n,)).astype(np.int32),
                scale=np.full((n,), 1e-3, np.float32),
                x_zp=np.int32(3), out_zp=np.int32(0))


def _j_flip(index, bit):
    """The reference side of ``flip_bit_at_index`` on an int32 tensor."""
    mask = jnp.int32(np.uint32(1 << bit).astype(np.int32))

    def inject(acc):
        flat = acc.reshape(-1)
        return flat.at[index].set(flat[index] ^ mask).reshape(acc.shape)
    return inject


def _qmatmul_both(policy, c, *, t_backend, j_inject=None, t_inject=None,
                  w_live=None, golden=False):
    """One ``dependable_qmatmul`` on each side; outputs and every counter
    must agree bit for bit."""
    w_live = c["w_q"] if w_live is None else w_live
    j_kw, t_kw = {}, {}
    if w_live is not c["w_q"]:
        j_kw["w_check"] = jabft.checksum_vector(jnp.asarray(c["w_q"]))
        t_kw["w_check"] = tabft.checksum_vector(_t(c["w_q"]))
    y_j, s_j = j_dep_mm(
        JPolicy(policy), jnp.asarray(c["x_q"]), jnp.int32(c["x_zp"]),
        jnp.asarray(w_live), jnp.asarray(c["bias"]), jnp.asarray(c["scale"]),
        jnp.int32(c["out_zp"]), inject=j_inject, backend="ref",
        ckpt=(jnp.asarray(c["x_q"]), jnp.asarray(c["w_q"])) if golden
        else None, **j_kw)
    y_t, s_t = t_dep_mm(
        TPolicy(policy), _t(c["x_q"]), _t(c["x_zp"]), _t(w_live),
        _t(c["bias"]), _t(c["scale"]), _t(c["out_zp"]), inject=t_inject,
        backend=t_backend,
        ckpt=(_t(c["x_q"]), _t(c["w_q"])) if golden else None, **t_kw)
    _eq(y_t, y_j)
    s_j = {k: int(v) for k, v in s_j.items()}
    assert DependabilityStats.to_host(s_t) == s_j
    return s_j


def _acc_both(policy, c, *, t_backend, j_inject=None, t_inject=None):
    acc_j, s_j = j_dep_acc(JPolicy(policy), jnp.asarray(c["x_q"]),
                           jnp.asarray(c["w_q"]), inject=j_inject,
                           backend="ref")
    acc_t, s_t = t_dep_acc(TPolicy(policy), _t(c["x_q"]), _t(c["w_q"]),
                           inject=t_inject, backend=t_backend)
    _eq(acc_t, acc_j)
    s_j = {k: int(v) for k, v in s_j.items()}
    assert DependabilityStats.to_host(s_t) == s_j
    return s_j


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policies_match_reference(policy, t_backend):
    c = _mm_case(11)
    assert _qmatmul_both(policy, c, t_backend=t_backend)[
        "faults_detected"] == 0
    assert _acc_both(policy, c, t_backend=t_backend)["faults_detected"] == 0


@pytest.mark.parametrize("policy", ["none", "abft"])
def test_policies_match_pallas_backend(policy):
    """Against the reference's Pallas kernels (interpret mode off-TPU)."""
    c = _mm_case(6)
    y_j, _ = j_dep_mm(JPolicy(policy), jnp.asarray(c["x_q"]),
                      jnp.int32(c["x_zp"]), jnp.asarray(c["w_q"]),
                      jnp.asarray(c["bias"]), jnp.asarray(c["scale"]),
                      jnp.int32(c["out_zp"]), backend="pallas")
    y_t, _ = t_dep_mm(TPolicy(policy), _t(c["x_q"]), _t(c["x_zp"]),
                      _t(c["w_q"]), _t(c["bias"]), _t(c["scale"]),
                      _t(c["out_zp"]), backend="cuda")
    _eq(y_t, y_j)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("bit", [0, 18, 31])
def test_same_strike_same_counts(policy, bit):
    """The same accumulator cell struck on both sides: outputs and the
    detected / corrected / recovered counts match, for the requantising op
    and for the bare accumulator."""
    c = _mm_case(7)
    index = 17 * 24 // 3 + 5
    kw = dict(t_backend="cuda", j_inject=_j_flip(index, bit),
              t_inject=lambda acc: flip_bit_at_index(acc, index, bit))
    stats = _qmatmul_both(policy, c, **kw)
    acc_stats = _acc_both(policy, c, **kw)
    if policy in ("abft", "ckpt"):
        assert stats["faults_detected"] == 1
    if policy != "none":
        assert acc_stats["faults_detected"] == 1    # bare acc: every bit
        assert acc_stats["faults_corrected"] == int(policy in ("abft", "tmr"))
        assert acc_stats["faults_recovered"] == int(policy == "ckpt")


@pytest.mark.parametrize("policy,golden", [("abft", False), ("ckpt", False),
                                           ("ckpt", True)])
def test_weight_seu_against_deploy_checks(policy, golden):
    """A flipped weight bit against the deploy-time check vector: ABFT
    detects, CKPT with the golden weights rolls back and recovers."""
    c = _mm_case(8)
    w_live = flip_bit_at_index(_t(c["w_q"]), 100, 6).numpy()
    stats = _qmatmul_both("abft" if policy == "abft" else "ckpt", c,
                          t_backend="cuda", w_live=w_live, golden=golden)
    assert stats["faults_detected"] >= 1
    assert stats["faults_recovered"] == int(golden)


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
def test_matmul_checksum_identity_and_abft_helpers(t_backend):
    c = _mm_case(5)
    x_q, w_q = _t(c["x_q"]), _t(c["w_q"])
    w_check = tabft.checksum_vector(w_q)
    acc, want = tdispatch.matmul_acc_checksum(x_q, w_q, w_check,
                                              backend=t_backend)
    _eq(tabft.row_checksum(acc), want)
    j_x, j_w = jnp.asarray(c["x_q"]), jnp.asarray(c["w_q"])
    j_acc = jnp.matmul(j_x.astype(jnp.int32), j_w.astype(jnp.int32))
    _eq(tabft.verify_rows(x_q, acc, w_check),
        jabft.verify_rows(j_x, j_acc, jabft.checksum_vector(j_w)))
    _eq(tabft.zp_bias_correct(acc, _t(c["x_zp"]), w_q, _t(c["bias"])),
        jabft.zp_bias_correct(j_acc, jnp.int32(c["x_zp"]), j_w,
                              jnp.asarray(c["bias"])))
    res_t = tabft.abft_qmatmul(x_q, _t(c["x_zp"]), w_q, _t(c["bias"]),
                               backend=t_backend)
    res_j = jabft.abft_qmatmul(j_x, jnp.int32(c["x_zp"]), j_w,
                               jnp.asarray(c["bias"]), backend="ref")
    for got, want in zip(res_t, res_j):
        _eq(got, want)


def test_tmr_counts_corrected_faults():
    c = _mm_case(17, m=8, k=16, n=12)
    args = (_t(c["x_q"]), _t(c["x_zp"]), _t(c["w_q"]), _t(c["bias"]),
            _t(c["scale"]), _t(c["out_zp"]))

    def inject(acc):
        acc = acc.clone()
        acc[2, 5] += 1 << 20
        return acc

    y_clean, st = t_dep_mm(TPolicy.TMR, *args)
    assert DependabilityStats.to_host(st)["faults_detected"] == 0
    y, st = t_dep_mm(TPolicy.TMR, *args, inject=inject)
    st = DependabilityStats.to_host(st)
    assert st["faults_detected"] == st["faults_corrected"] == 1
    _eq(y, y_clean.numpy())
    _, st = t_dep_mm(TPolicy.DMR, *args, inject=inject)
    st = DependabilityStats.to_host(st)
    assert st["faults_detected"] == 1 and st["faults_corrected"] == 0


def test_stats_need_a_device_and_follow_the_operands():
    with pytest.raises(TypeError):
        DependabilityStats.zero()
    c = _mm_case(2, m=4, k=8, n=6)
    _, st = t_dep_acc(TPolicy.ABFT, _t(c["x_q"]), _t(c["w_q"]))
    assert {v.device for v in st.values()} == {torch.device("cpu")}


# ---------------------------------------------------------------------------
# The W8A8 quantizers (tests/test_w8a8.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,mag", [((24, 17), 0.01), ((3, 40, 9), 100.0),
                                       ((2, 64, 128), 1.0)])
def test_quantize_ffn_weight_matches_reference(shape, mag):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    w = (rng.standard_normal(shape) * mag).astype(np.float32)
    j_q, j_s = jtfm.quantize_ffn_weight(jnp.asarray(w))
    t_q, t_s = ttfm.quantize_ffn_weight(_t(w))
    _eq(t_q, j_q)
    _eq(t_s, j_s)
    deq = t_q.numpy().astype(np.float32) * t_s.numpy()[..., None, :]
    assert (np.abs(deq - w) <= 0.5 * t_s.numpy()[..., None, :] + 1e-6).all()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_act_matches_reference(dtype):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    x[0, 0] = 0.0                                 # the 1e-8 floor
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    j_q, j_s = jtfm._quantize_act(jx)
    t_q, t_s = ttfm._quantize_act(tx)
    _eq(t_q, j_q)
    _eq(t_s, j_s)
