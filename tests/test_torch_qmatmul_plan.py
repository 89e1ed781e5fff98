"""The launch plan of the accumulator kernels (``qmatmul_acc`` and
``qmatmul_acc_checksum`` in ``repro_torch.kernels.qmatmul.kernel``), and a
CPU emulation of the arithmetic that the plan gives the card: int32
partial sums over each cluster rank's K range (each rank's warps over
their share of its 32-deep K steps, chunk by chunk), added in rank order
mod 2^32.  The emulation is held bit-exact against the reference's Pallas
kernels in interpret mode and the port's plain versions, on the same numpy
inputs, including a check vector that wraps past 2^31."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import abft as jabft
from repro.kernels.qmatmul import kernel as jkernel
from repro_torch.core import abft as tabft
from repro_torch.core.abft import wrap_int32
from repro_torch.kernels.qmatmul import kernel as tkernel

# SmolLM-135M's W8A8 FFN at decode (capacity 8) and prefill (64 rows)
FFN_SHAPES = [(8, 576, 1536), (8, 1536, 576), (64, 576, 1536),
              (64, 1536, 576)]
# ... and a flash prefill's 256 and 1024 rows, with the ranks that fill a
# wave of 132 SMs: 192, 72, 768 and 288 tiles of 64 x 32
PREFILL_SHAPES = [(256, 576, 1536, 1), (256, 1536, 576, 2),
                  (1024, 576, 1536, 1), (1024, 1536, 576, 1)]
# the embedding-input models' W8A8 FFN (musicgen-large 2048 -> 8192 ->
# 2048, llava-next-34b 7168 -> 20480 -> 7168) at decode (1-8 rows) and at
# chip_smoke.py's prefills (1500 and 2880 positions)
EMBED_FFN = {"musicgen-large": ((2048, 8192), (8192, 2048), 1500),
             "llava-next-34b": ((7168, 20480), (20480, 7168), 2880)}
EMBED_SHAPES = [(m, k, n) for up, down, s in EMBED_FFN.values()
                for k, n in (up, down) for m in (1, 2, 5, 7, 8, s)]
# tests/test_torch_qmatmul.py's SHAPES
SHAPES = [(8, 16, 8), (128, 128, 128), (256, 512, 384), (1, 4096, 128),
          (130, 257, 129)]
_rng = np.random.default_rng(18)
RANDOM_SHAPES = [tuple(int(v) for v in (_rng.integers(1, 300),
                                        _rng.integers(1, 5000),
                                        _rng.integers(1, 2000)))
                 for _ in range(12)]


def _rank_ranges(p, k):
    return [(min(k, r * p.k_rank), min(k, (r + 1) * p.k_rank))
            for r in range(p.cluster)]


def _check_plan(m, k, n, ranks=None):
    """``plan``'s own plan, or its split over at most ``ranks`` ranks (its
    cap on the rows rank 0 sums then does not apply)."""
    capped = ranks is None
    p = tkernel.plan(m, k, n, ranks)
    # tiles: 32 columns by tile_m rows, tile_m a multiple of 8 up to 64
    assert p.tile_m % 8 == 0 and 8 <= p.tile_m <= tkernel.MAX_TILE_M
    assert p.tile_m >= min(m, tkernel.MAX_TILE_M)
    n_tiles = -(-n // tkernel.TILE_N)
    m_tiles = -(-m // p.tile_m)
    assert p.grid == p.cluster * n_tiles * m_tiles
    assert p.cluster * n_tiles <= 65535          # gridDim.y
    # every K row in exactly one rank, none empty
    assert 1 <= p.cluster <= tkernel.MAX_CLUSTER
    assert not capped or p.cluster * p.tile_m <= tkernel.MAX_SLOT_ROWS
    assert p.k_rank % tkernel.K_STEP == 0
    ranges = _rank_ranges(p, k)
    covered = np.zeros(k, np.int64)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert k == 0 or all(lo < hi for lo, hi in ranges)
    # staged chunks of whole steps; shared memory a block can take
    assert p.k_chunk % tkernel.K_STEP == 0
    assert p.k_chunk <= min(p.k_rank, tkernel.MAX_K_CHUNK)
    assert tkernel.smem_bytes(p.tile_m, p.k_chunk, p.cluster) \
        <= tkernel.MAX_SMEM
    return p


@pytest.mark.parametrize("m,k,n", FFN_SHAPES)
def test_plan_fills_the_card_at_the_ffn_shapes(m, k, n):
    """About one wave of the H100's 132 SMs at every FFN shape, with the
    K of a tile split over a cluster."""
    p = _check_plan(m, k, n)
    assert p.grid >= 100
    assert p.cluster > 1


@pytest.mark.parametrize("m,k,n", SHAPES + RANDOM_SHAPES)
def test_plan_covers_k_and_fits(m, k, n):
    _check_plan(m, k, n)


@pytest.mark.parametrize("m,k,n,ranks", PREFILL_SHAPES)
def test_plan_at_the_prefill_shapes(m, k, n, ranks):
    """Tiles of 64 rows, K split only as far as a wave needs, each rank
    staging its K range in chunks of 256 rows."""
    p = _check_plan(m, k, n)
    assert p.tile_m == 64 and p.cluster == ranks and p.grid >= tkernel.SMS
    assert p.k_chunk == tkernel.MAX_K_CHUNK < p.k_rank


@pytest.mark.parametrize("m,k,n", EMBED_SHAPES)
def test_plan_at_the_embedding_model_shapes(m, k, n):
    """K covered once, clusters of at most 8 ranks, shared memory within
    227 KB, and the decode rows in one tile, at both models' FFN shapes."""
    p = _check_plan(m, k, n)
    if m <= 8:
        assert p.tile_m == 8 and p.grid >= -(-n // tkernel.TILE_N)


@pytest.mark.parametrize("m,k,n", FFN_SHAPES)
@pytest.mark.parametrize("cluster", range(1, 9))
def test_every_cluster_size_covers_k_and_fits(m, k, n, cluster):
    """The plans the sweep (``kernels/qmatmul/sweep.py``) times: each
    cluster size's split."""
    p = _check_plan(m, k, n, cluster)
    assert p.cluster <= cluster


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 5000), st.integers(0, 20000), st.integers(1, 20000))
def test_plan_covers_k_and_fits_drawn(m, k, n):
    _check_plan(m, k, n)


def test_plan_is_cached():
    assert tkernel.plan(8, 576, 1536) is tkernel.plan(8, 576, 1536)


@pytest.mark.parametrize("m,k,n", FFN_SHAPES)
def test_default_plan_is_a_split(m, k, n):
    """``plan`` without ``ranks`` is its split over the ranks it picks."""
    p = tkernel.plan(m, k, n)
    assert tkernel.plan(m, k, n, p.cluster) == p


def _emulate(x, w, w_check, p):
    """(acc, want) as the plan has the card compute them: per rank, per
    staged chunk, warp kp of the ksplit that share a row group sums the
    steps kp, kp + ksplit, ...; each partial wraps to int32; the block adds
    its warps' partials and rank 0 adds the ranks' in rank order."""
    k = x.shape[1]
    x64, w64, c64 = (t.to(torch.int64) for t in (x, w, w_check))
    ksplit = 8 // (p.tile_m // 8)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64)
    want = torch.zeros((x.shape[0],), dtype=torch.int64)
    for lo, hi in _rank_ranges(p, k):
        block = torch.zeros_like(acc)
        for kp in range(ksplit):
            rows = [kk for kb in range(lo, hi, p.k_chunk)
                    for s in range(kp, -(-(min(hi, kb + p.k_chunk) - kb)
                                         // 32), ksplit)
                    for kk in range(kb + 32 * s,
                                    min(hi, kb + p.k_chunk, kb + 32 * s + 32))]
            part = x64[:, rows] @ w64[rows, :]
            block = wrap_int32(block + wrap_int32(part))
        acc = wrap_int32(acc + block)
        want = wrap_int32(want + wrap_int32(x64[:, lo:hi] @ c64[lo:hi]))
    return acc, want


def _inputs(seed, m, k, n, x_fill=None, w_fill=None):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    if x_fill is not None:
        x[:] = x_fill
    if w_fill is not None:
        w[:] = w_fill
    return x, w


@pytest.mark.parametrize("m,k,n,fill", [
    (8, 576, 1536, None), (8, 1536, 576, None), (64, 576, 192, None),
    (9, 600, 70, None), (17, 99, 41, None), (1, 4096, 40, None),
    (4, 1536, 160, (-128, 127)),           # want passes 2^31 and wraps
    (256, 576, 1536, None),                # one rank, three staged chunks
])
def test_emulated_plan_matches_pallas_and_plain(m, k, n, fill):
    x, w = _inputs(m * 131 + k + n, m, k, n, *(fill or (None, None)))
    j_x, j_w = jnp.asarray(x), jnp.asarray(w)
    j_check = jabft.checksum_vector(j_w)
    j_acc = jkernel.qmatmul_acc(j_x, j_w, interpret=True)
    j_acc2, j_want = jkernel.qmatmul_acc_checksum(j_x, j_w, j_check,
                                                  interpret=True)
    t_x, t_w = torch.from_numpy(x), torch.from_numpy(w)
    t_check = tabft.checksum_vector(t_w)
    np.testing.assert_array_equal(t_check.numpy(), np.asarray(j_check))
    acc, want = _emulate(t_x, t_w, t_check, tkernel.plan(m, k, n))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc2))
    np.testing.assert_array_equal(want.numpy(), np.asarray(j_want))
    plain_acc, plain_want = tkernel.qmatmul_acc_checksum(t_x, t_w, t_check)
    assert torch.equal(acc.to(torch.int32), plain_acc)
    assert torch.equal(want.to(torch.int32), plain_want)
    assert torch.equal(tkernel.qmatmul_acc(t_x, t_w), plain_acc)
    assert torch.equal(tabft.row_checksum(plain_acc), plain_want)
    if fill is not None:
        exact = x.astype(np.int64) @ t_check.numpy().astype(np.int64)
        assert np.abs(exact).max() > 2 ** 31


# ---------------------------------------------------------------------------
# the fused kernel (row 6): the same split-K sums, then rank 0's requant
# epilogue
# ---------------------------------------------------------------------------


def requant_np(v, scale, out_zp):
    """The kernel's epilogue on wrapped int32 sums ``v``: to float32 rounded
    to nearest, a float32 multiply, round half to even, + out_zp in
    float32, clip to int8."""
    y = v.astype(np.int32).astype(np.float32) * scale.astype(np.float32)
    y = np.rint(y) + np.float32(out_zp)
    return np.clip(y, -128, 127).astype(np.int8)


def _requant_inputs(seed, m, k, n, ties=False, wraps=False):
    """Row 6's inputs.  ``ties``: x in [-4, 4), w in [-1, 1], scale 0.5, so
    that every odd sum lands on .5 and the larger ones clamp at both ends;
    ``wraps``: biases within 1000 of ±2^31 and scales near 2^-25, so that
    the wrapped sums, not the exact ones, set the output."""
    rng = np.random.default_rng(seed)
    lo, hi = (-4, 4) if ties else (-128, 128)
    x = rng.integers(lo, hi, (m, k)).astype(np.int8)
    w = (rng.integers(-1, 2, (k, n)) if ties
         else rng.integers(-127, 128, (k, n))).astype(np.int8)
    zps = rng.integers(-10, 11, 2).astype(np.int32)
    if wraps:
        bias = np.where(np.arange(n) % 2 == 0,
                        2 ** 31 - 1 - rng.integers(0, 1000, n),
                        -2 ** 31 + rng.integers(0, 1000, n))
        scale = rng.uniform(2e-8, 4e-8, n)
    else:
        bias = rng.integers(-1000, 1000, n)
        scale = np.full(n, 0.5) if ties else rng.uniform(1e-4, 5e-3, n)
    colsum = w.astype(np.int64).sum(0).astype(np.int32)
    return (x, w, colsum, bias.astype(np.int32), scale.astype(np.float32),
            zps)


@pytest.mark.parametrize("m,k,n,extra", [
    (8, 576, 1536, {}), (8, 1536, 576, {}), (64, 576, 1536, {}),
    (64, 1536, 576, {}),                       # the FFN shapes
    (9, 600, 70, {}), (17, 99, 41, {}), (1, 4096, 40, {}),
    (8, 576, 96, {"ties": True}), (33, 130, 70, {"ties": True}),
    (8, 1536, 64, {"wraps": True}),
    (256, 576, 1536, {}),                      # one rank, three chunks
])
def test_emulated_requant_matches_pallas_and_plain(m, k, n, extra):
    x, w, colsum, bias, scale, zps = _requant_inputs(
        m * 131 + k + n + 6, m, k, n, **extra)
    t_x, t_w = torch.from_numpy(x), torch.from_numpy(w)
    # rank 0's whole sum, then + (bias - x_zp * colsum) mod 2^32
    acc, _ = _emulate(t_x, t_w, tabft.checksum_vector(t_w),
                      tkernel.plan(m, k, n))
    v = wrap_int32(acc - int(zps[0]) * torch.from_numpy(colsum).long()
                   + torch.from_numpy(bias).long()).numpy()
    got = requant_np(v, scale, int(zps[1]))
    j_out = jkernel.qmatmul(*(jnp.asarray(a) for a in
                              (x, w, colsum, bias, scale, zps)),
                            interpret=True)
    np.testing.assert_array_equal(got, np.asarray(j_out))
    plain = tkernel.qmatmul(t_x, t_w, *(torch.from_numpy(a) for a in
                                        (colsum, bias, scale, zps)))
    np.testing.assert_array_equal(got, plain.numpy())
    if extra.get("ties"):
        ties = (v % 2 != 0) & (np.abs(v) < 250)
        assert ties.sum() > 50
        assert (got == 127).any() and (got == -128).any()
        away = np.clip(np.trunc(v * 0.5 + np.sign(v) * 0.5) + int(zps[1]),
                       -128, 127)
        assert (got[ties] != away[ties]).any()
    if extra.get("wraps"):
        exact = x.astype(np.int64) @ w.astype(np.int64) \
            - int(zps[0]) * colsum.astype(np.int64) + bias.astype(np.int64)
        assert (np.abs(exact) >= 2 ** 31).any()
        assert (np.abs(got.astype(np.int64)) < 127).mean() > 0.5


@pytest.mark.parametrize("name", ["qmatmul_acc", "qmatmul_acc_checksum",
                                  "qmatmul"])
@pytest.mark.parametrize("m,k,n", FFN_SHAPES + [(1024, 1536, 576),
                                                (5, 100, 37)])
def test_wrappers_pass_the_plan_to_their_entry(monkeypatch, name, m, k, n):
    """Each wrapper on a card tensor hands its entry the shape and
    ``plan()``'s launch, as many arguments as the entry declares."""
    x, w, colsum, bias, scale, zps = (torch.from_numpy(a) for a in
                                      _requant_inputs(5, m, k, n))
    args = {"qmatmul_acc": (x, w),
            "qmatmul_acc_checksum": (x, w, tabft.checksum_vector(w)),
            "qmatmul": (x, w, colsum, bias, scale, zps)}[name]
    seen = []
    monkeypatch.setattr(tkernel, "_on_card", lambda *t: True)
    monkeypatch.setattr(tkernel, "_launch",
                        lambda entry, device, *a: seen.append((entry, a)))
    # the simulated launch counts; the count is restored at teardown, so
    # later tests in this process see only their own launches
    monkeypatch.setattr(getattr(tkernel, name), "launches",
                        getattr(tkernel, name).launches)
    before = getattr(tkernel, name).launches
    getattr(tkernel, name)(*args)
    (entry, passed), = seen
    assert entry == f"{name}_launch"
    assert len(passed) + 1 == len(tkernel._ENTRIES[entry])    # + the stream
    assert passed[-8:] == (m, k, n, *tkernel.plan(m, k, n))
    assert getattr(tkernel, name).launches == before + 1
