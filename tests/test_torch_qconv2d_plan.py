"""The launch plan of the int8 conv accumulator kernels (``qconv2d_acc`` and
``qconv2d_acc_checksum`` in ``repro_torch.kernels.qconv2d.kernel``), and a
CPU emulation of the arithmetic that the plan gives the card:

* the K walk: for each ky, the kw * Cin bytes that lie together in x, padded
  to 16, read as 16-byte runs at (window corner + table offset), the corner
  of each pixel found by the no-division pixel walk of a persistent grid;
* B in the same K order, staged over all of K or in pieces of ``MAX_BT_K``;
  int32 partial sums per piece, wrapped mod 2^32;
* the ``uint32`` zero-point epilogue acc - zp * colsum;
* the check channel from four signed byte digits of w_check, each digit's
  sum wrapped mod 2^32, want = sum_i 2^(8i) S_i - zp * sum(w_check).

The emulation is held bit-exact, on the same numpy inputs, against the
reference's Pallas kernels in interpret mode and the port's plain versions,
including a check that wraps past 2^31 with w_check over the whole int32
range."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.qconv2d import kernel as jkernel
from repro_torch.core.abft import conv_checksum_weight, wrap_int32
from repro_torch.kernels.qconv2d import kernel as tkernel
from repro_torch.kernels.qconv2d import ops as tops
from repro_torch.models import shipdet

BATCH = 4
SMS = 132                          # H100 SXM
SM_SMEM = 233472                   # shared memory of one SM, H100
SMEM_RESERVED = 1024               # per block, kept by the runtime
TILE_M, TILE_N = tkernel.TILE_M, tkernel.TILE_N


def forward_layers(specs, batch):
    """(name, n, oh, ow, cin, kh, kw, cout, stride) of each layer as the
    forward meets it: SAME, so a stride-2 layer halves the side rounding
    up."""
    out, side = [], specs[0].h
    for s in specs:
        o = -(-side // s.stride)
        out.append((s.name, batch, o, o, s.cin, s.kh, s.kw, s.cout,
                    s.stride))
        side = o
    return out


LAYERS = forward_layers(shipdet.network_specs(194), BATCH)


def _check_plan(n, oh, ow, cin, kh, kw, cout):
    """The plan the wrappers pass to the C entry, held to the checks that
    the entry makes before it launches (``launch_mma`` in qconv2d.cu)."""
    p = tkernel.plan(n, oh, ow, cin, kh, kw, cout)
    npix = n * oh * ow
    # every output pixel in exactly one pixel tile, every channel in one
    # Cout tile
    assert p.tiles == -(-npix // TILE_M) and p.grid_y == -(-cout // TILE_N)
    assert (p.tiles - 1) * TILE_M < npix <= p.tiles * TILE_M
    assert (p.grid_y - 1) * TILE_N < cout <= p.grid_y * TILE_N
    assert p.grid_y <= 65535 and p.tiles < 2 ** 31           # gridDim limits
    # B over all of K (rounded up to 64) where it fits, else in pieces
    kpad = tkernel.k_padded(kh, kw, cin)
    assert p.bt_k % tkernel.MACRO == 0 and p.bt_k >= tkernel.MACRO
    assert p.bt_k >= kpad or p.bt_k == tkernel.MAX_BT_K
    assert tkernel.smem_bytes(p.bt_k) <= tkernel.MAX_SMEM
    return p


@pytest.mark.parametrize("layer", LAYERS, ids=[lay[0] for lay in LAYERS])
def test_plan_at_the_ship_detector_layers(layer):
    """128 x 24 tiles, all of K's B resident in shared memory, and a wave
    of tiles for the 132 SMs at every layer but the det head, whose 76
    tiles the sweep measured faster than 151 narrower ones."""
    name, n, oh, ow, cin, kh, kw, cout, _ = layer
    p = _check_plan(n, oh, ow, cin, kh, kw, cout)
    assert p.bt_k >= tkernel.k_padded(kh, kw, cin)
    assert p.tiles * p.grid_y >= (76 if name == "det_head" else SMS)


def _side(h, k, s, padding):
    return -(-h // s) if padding == "SAME" else (h - k) // s + 1


# (label, n, h, w, cin, cout, kh, kw, stride, padding): the geometries
# that chip_smoke.py holds rows 1 and 2 against their plain versions at,
# beyond the ship detector's layers
CHIP_CASES = [(f"cin_{c}", 2, 15, 13, c, 24, 3, 3, (1, 1), "SAME")
              for c in (1, 3, 5)]
CHIP_CASES += [("x_offset", 2, 11, 12, 48, 48, 3, 3, (1, 1), "SAME"),
               ("cout_6", 2, 13, 13, 96, 6, 1, 1, (1, 1), "SAME"),
               ("cout_100", 2, 13, 13, 96, 100, 1, 1, (1, 1), "SAME"),
               ("ragged_cout", 2, 13, 11, 10, 70, 3, 3, (1, 1), "SAME"),
               ("stride_2x1", 2, 17, 19, 8, 16, 5, 3, (2, 1), "VALID"),
               ("k_5x5x600", 1, 9, 10, 600, 40, 5, 5, (1, 1), "SAME"),
               ("k_5x5x600_tiles", 2, 200, 200, 600, 24, 5, 5, (1, 1),
                "SAME")]
CHIP_CASES += [(f"pixels_{p}_cout_{c}", 1, 1, p, 24, c, 1, 1, (1, 1),
                "VALID") for p in (1, 63, 65, 127, 129, 200) for c in (24, 48)]


@pytest.mark.parametrize("case", CHIP_CASES, ids=[c[0] for c in CHIP_CASES])
def test_plan_at_the_chip_compare_cases(case):
    _, n, h, w, cin, cout, kh, kw, (sh, sw), padding = case
    oh, ow = _side(h, kh, sh, padding), _side(w, kw, sw, padding)
    p = _check_plan(n, oh, ow, cin, kh, kw, cout)
    resident = p.bt_k >= tkernel.k_padded(kh, kw, cin)
    assert resident == (cin != 600)


def test_large_k_case_walks_more_tiles_than_the_grid_holds():
    """chip_smoke.py's second 5x5x600 conv: B in pieces, and more pixel
    tiles than an H100's SMs hold blocks of that shared memory at once, so
    that each block restages B's pieces for several tiles."""
    p = _check_plan(2, 200, 200, 600, 5, 5, 24)
    per_sm = SM_SMEM // (tkernel.smem_bytes(p.bt_k) + SMEM_RESERVED)
    assert p.bt_k == tkernel.MAX_BT_K and p.tiles > per_sm * SMS


def test_plan_stages_large_k_in_pieces():
    """A 5x5x600 conv: K = 15,040 bytes, B staged 2048 bytes at a time."""
    p = _check_plan(1, 9, 10, 600, 5, 5, 40)
    assert p.bt_k == tkernel.MAX_BT_K < tkernel.k_padded(5, 5, 600)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 8), st.integers(1, 400), st.integers(1, 400),
       st.integers(1, 2048), st.integers(1, 7), st.integers(1, 7),
       st.integers(1, 2000))
def test_plan_covers_and_fits_drawn(n, oh, ow, cin, kh, kw, cout):
    _check_plan(n, oh, ow, cin, kh, kw, cout)


def test_plan_is_cached():
    assert tkernel.plan(4, 194, 194, 24, 3, 3, 24) \
        is tkernel.plan(4, 194, 194, 24, 3, 3, 24)


# ---------------------------------------------------------------------------
# the pixel walk: each block b of a grid of G walks tiles b, b + G, ...,
# moving its lanes' pixels on without division (Pixel in qconv2d.cu)
# ---------------------------------------------------------------------------


def _split(pix, oh, ow):
    img, rem = divmod(pix, oh * ow)
    return [img, rem // ow, rem % ow]


def _add(p, d, oh, ow):
    img, oy, ox = p[0] + d[0], p[1] + d[1], p[2] + d[2]
    if ox >= ow:
        ox, oy = ox - ow, oy + 1
    if oy >= oh:
        oy, img = oy - oh, img + 1
    return [img, oy, ox]


@pytest.mark.parametrize("n,oh,ow,grid", [
    (4, 194, 194, 264), (4, 97, 97, 396), (4, 49, 49, 76), (1, 7, 3, 2),
    (3, 1, 200, 5), (2, 5, 1, 1), (2, 13, 11, 3), (2, 200, 200, 396),
    (2, 200, 200, 132)])
def test_pixel_walk_visits_every_pixel_once(n, oh, ow, grid):
    npix = n * oh * ow
    tiles = -(-npix // TILE_M)
    grid = min(grid, tiles)
    step_grid, step8 = _split(grid * TILE_M, oh, ow), _split(8, oh, ow)
    seen = np.zeros(npix, np.int64)
    for b in range(grid):
        for lane_row in range(16 * 8 // 2):          # wm, gq: rows r, r + 8
            r = 16 * (lane_row // 8) + lane_row % 8
            p0 = b * TILE_M + r
            px0 = _split(p0, oh, ow)
            px8 = _add(px0, step8, oh, ow)
            for _ in range(b, tiles, grid):
                for p, px in ((p0, px0), (p0 + 8, px8)):
                    assert (px[0] < n) == (p < npix)
                    if p < npix:
                        assert px == _split(p, oh, ow)
                        seen[p] += 1
                p0 += grid * TILE_M
                px0 = _add(px0, step_grid, oh, ow)
                px8 = _add(px8, step_grid, oh, ow)
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the check channel's digits
# ---------------------------------------------------------------------------


def digits(w):
    """Four signed byte digits d_i of int32 ``w`` with w == sum_i 256^i d_i
    mod 2^32 (qconv2d.cu's split), as int64 (..., 4)."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    out = []
    for _ in range(4):
        d = ((u & 0xFF) ^ 0x80) - 0x80
        out.append(d)
        u = ((u - d) & 0xFFFFFFFF) >> 8
    return torch.stack(out, -1)


def test_digits_rebuild_every_int32():
    edge = torch.tensor([-2 ** 31, -2 ** 31 + 1, -129, -128, -1, 0, 1, 127,
                         128, 255, 256, 2 ** 31 - 1], dtype=torch.int32)
    rng = np.random.default_rng(19)
    drawn = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 20_000,
                                          dtype=np.int64).astype(np.int32))
    w = torch.cat([edge, drawn])
    d = digits(w)
    assert int(d.min()) >= -128 and int(d.max()) <= 127
    rebuilt = (d * torch.tensor([1, 256, 65536, 16777216])).sum(-1)
    assert torch.equal(wrap_int32(rebuilt), w)


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _walk_tables(hp, wp, cin, kh, kw, bt_k):
    """K as the kernel walks it (``stage_b``): per 16-byte run h, its offset
    in x from the window's corner and its real bytes; per K byte, the W row
    (ky * kw + kx) * cin + ci or -1 (padding)."""
    run = kw * cin
    row16 = 16 * -(-run // 16)
    kpad = kh * row16
    kpad64 = max(tkernel.MACRO, tkernel.MACRO * -(-kpad // tkernel.MACRO))
    k_all = -(-kpad64 // bt_k) * bt_k
    offs, lens = [], []
    for k in range(0, k_all, 16):
        ky, j = divmod(k, row16)
        nb = min(16, run - j) if k < kpad else 0
        offs.append(ky * wp * cin + j if nb > 0 else 0)
        lens.append(max(0, nb))
    w_rows = []
    for k in range(k_all):
        ky, j = divmod(k, row16)
        w_rows.append((ky * kw + j // cin) * cin + j % cin
                      if k < kpad and j < run else -1)
    return np.array(offs), np.array(lens), np.array(w_rows), k_all


def emulate(x_p, w_q, colsum, w_check, zp, stride):
    """(acc, want) as the plan has the card compute them."""
    n, hp, wp, cin = x_p.shape
    kh, kw, _, cout = w_q.shape
    sh, sw = stride
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    p = tkernel.plan(n, oh, ow, cin, kh, kw, cout)
    offs, lens, w_rows, k_all = _walk_tables(hp, wp, cin, kh, kw, p.bt_k)
    npix = n * oh * ow
    # each pixel's window corner in x (the walk that finds it is held
    # against division above)
    corner = np.empty(npix, np.int64)
    for pix in range(npix):
        img, oy, ox = _split(pix, oh, ow)
        corner[pix] = ((img * hp + oy * sh) * wp + ox * sw) * cin
    # byte b of run h at corner + offs[h] + b where b < lens[h], else 0
    byte = np.arange(16)
    at = (offs[:, None] + byte).reshape(-1)
    real = (byte < lens[:, None]).reshape(-1)
    x_flat = x_p.reshape(-1).to(torch.int64)
    a = x_flat[torch.from_numpy(np.where(real, corner[:, None] + at, 0))] \
        * torch.from_numpy(real)
    w_flat = w_q.reshape(-1, cout).to(torch.int64)
    live = torch.from_numpy(w_rows >= 0)
    bmat = torch.zeros((k_all, cout), dtype=torch.int64)
    bmat[live] = w_flat[torch.from_numpy(w_rows[w_rows >= 0])]
    c_flat = w_check.reshape(-1).to(torch.int64)
    dmat = torch.zeros((k_all, 4), dtype=torch.int64)
    dmat[live] = digits(c_flat[torch.from_numpy(w_rows[w_rows >= 0])])
    acc = torch.zeros((npix, cout), dtype=torch.int64)
    sums = torch.zeros((npix, 4), dtype=torch.int64)
    for kb in range(0, k_all, p.bt_k):                  # B's pieces
        ak = a[:, kb:kb + p.bt_k]
        acc = wrap_int32(acc + wrap_int32(ak @ bmat[kb:kb + p.bt_k]))
        sums = wrap_int32(sums + wrap_int32(ak @ dmat[kb:kb + p.bt_k]))
    zp64 = int(zp[0])
    acc = wrap_int32(acc.to(torch.int64) - zp64 * colsum.to(torch.int64))
    want = (sums.to(torch.int64) * torch.tensor([1, 256, 65536, 16777216])
            ).sum(-1) - zp64 * c_flat.sum()
    return (acc.reshape(n, oh, ow, cout),
            wrap_int32(want).reshape(n, oh, ow))


def _case(seed, n, h, w, cin, kh, kw, cout, stride, padding, x_zp=None,
          x_fill=None, w_fill=None, wide_check=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (kh, kw, cin, cout)).astype(np.int8)
    if x_fill is not None:
        x[:] = x_fill
    if w_fill is not None:
        wq[:] = w_fill
    zp = int(rng.integers(-10, 11)) if x_zp is None else x_zp
    t_x, t_w = torch.from_numpy(x), torch.from_numpy(wq)
    zp0 = torch.tensor(zp, dtype=torch.int32)
    pads = tops.resolve_pads(h, w, kh, kw, stride, padding)
    x_p = tops.pad_zp(t_x, zp0, pads)
    w_check = conv_checksum_weight(t_w)
    if wide_check:                 # any int32, as a deploy-time check may be
        w_check = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, tuple(w_check.shape),
            dtype=np.int64).astype(np.int32))
    return x_p, t_w, tops.weight_colsum(t_w), w_check, zp0.reshape(1)


# (label, n, h, w, cin, kh, kw, cout, stride, padding, extra)
CASES = [(f"reduced_{s.name}", 1, s.h, s.w, s.cin, s.kh, s.kw, s.cout,
          (s.stride, s.stride), "SAME", {})
         for s in shipdet.reduced_specs()]
CASES += [
    ("stem_cin3", 2, 20, 18, 3, 3, 3, 24, (2, 2), "SAME", {}),
    ("ragged", 2, 13, 11, 10, 3, 3, 70, (1, 1), "SAME", {}),
    ("cin_5_cout_6", 1, 9, 9, 5, 3, 3, 6, (1, 1), "SAME", {}),
    ("stride_2x1", 2, 17, 19, 8, 5, 3, 16, (2, 1), "VALID", {}),
    ("zp_-128", 1, 11, 10, 24, 3, 3, 40, (2, 2), "SAME", {"x_zp": -128}),
    ("zp_127", 1, 11, 10, 24, 3, 3, 40, (1, 1), "SAME", {"x_zp": 127}),
    ("check_wraps", 1, 6, 6, 96, 3, 3, 96, (1, 1), "VALID",
     {"x_zp": 127, "x_fill": -128, "w_fill": 127}),
    ("wide_w_check", 1, 8, 7, 20, 3, 3, 30, (1, 1), "SAME",
     {"wide_check": True}),
    ("k_5x5x600", 1, 5, 6, 600, 5, 5, 26, (1, 1), "SAME", {}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_plan_matches_pallas_and_plain(case):
    label, n, h, w, cin, kh, kw, cout, stride, padding, extra = case
    x_p, w_q, colsum, w_check, zp = _case(
        n * 1000 + cin * 10 + cout, n, h, w, cin, kh, kw, cout, stride,
        padding, **extra)
    acc, want = emulate(x_p, w_q, colsum, w_check, zp, stride)
    j_args = [jnp.asarray(t.numpy()) for t in (x_p, w_q, colsum)]
    j_acc = jkernel.qconv2d_acc(*j_args, jnp.asarray(zp.numpy()),
                                stride=stride, interpret=True)
    j_acc2, j_want = jkernel.qconv2d_acc_checksum(
        *j_args, jnp.asarray(w_check.numpy()), jnp.asarray(zp.numpy()),
        stride=stride, interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc2))
    np.testing.assert_array_equal(want.numpy(), np.asarray(j_want))
    plain_acc, plain_want = tkernel.qconv2d_acc_checksum(
        x_p, w_q, colsum, w_check, zp, stride=stride)
    assert torch.equal(acc, plain_acc) and torch.equal(want, plain_want)
    assert torch.equal(tkernel.qconv2d_acc(x_p, w_q, colsum, zp,
                                           stride=stride), plain_acc)
    if label == "check_wraps":
        exact = ((x_p[0, :kh, :kw].to(torch.int64) - int(zp[0]))
                 * w_check[..., 0]).sum()
        assert abs(int(exact)) > 2 ** 31
    if label == "k_5x5x600":
        assert tkernel.plan(n, *acc.shape[1:3], cin, kh, kw, cout).bt_k \
            < tkernel.k_padded(kh, kw, cin)


# ---------------------------------------------------------------------------
# the fused kernel (row 3): the same template and K walk, then the requant
# epilogue
# ---------------------------------------------------------------------------


def requant_np(v, scale, out_zp):
    """The kernel's epilogue on wrapped int32 sums ``v``: to float32 rounded
    to nearest, a float32 multiply, round half to even, + out_zp in
    float32, clip to int8."""
    y = v.astype(np.int32).astype(np.float32) * scale.astype(np.float32)
    y = np.rint(y) + np.float32(out_zp)
    return np.clip(y, -128, 127).astype(np.int8)


def emulate_requant(x_p, w_q, colsum, bias, scale, zps, stride):
    """Row 3 as the plan has the card compute it: the accumulator's K walk
    and pieces (``emulate``), + (bias - x_zp * colsum) mod 2^32, then the
    epilogue.  Returns the int8 output and the wrapped sums."""
    acc, _ = emulate(x_p, w_q, colsum, conv_checksum_weight(w_q), zps[:1],
                     stride)
    v = wrap_int32(acc.to(torch.int64) + bias.to(torch.int64)).numpy()
    return requant_np(v, scale.numpy(), int(zps[1])), v


def _requant_case(seed, n, h, w, cin, kh, kw, cout, stride, padding,
                  ties=False, wraps=False):
    """Row 3's inputs.  ``ties``: x in [-4, 4), w in [-1, 1], scale 0.5, so
    that every odd sum lands on .5 and the larger ones clamp at both ends;
    ``wraps``: biases within 1000 of ±2^31 and scales near 2^-25, so that
    the wrapped sums, not the exact ones, set the output."""
    rng = np.random.default_rng(seed)
    lo, hi = (-4, 4) if ties else (-128, 128)
    x = rng.integers(lo, hi, (n, h, w, cin)).astype(np.int8)
    wq = rng.integers(-1, 2, (kh, kw, cin, cout)) if ties else \
        rng.integers(-127, 128, (kh, kw, cin, cout))
    wq = wq.astype(np.int8)
    zps = rng.integers(-10, 11, 2)
    if wraps:
        bias = np.where(np.arange(cout) % 2 == 0,
                        2 ** 31 - 1 - rng.integers(0, 1000, cout),
                        -2 ** 31 + rng.integers(0, 1000, cout))
        scale = rng.uniform(2e-8, 4e-8, cout)
    else:
        bias = rng.integers(-1000, 1000, cout)
        scale = np.full(cout, 0.5) if ties else rng.uniform(1e-4, 5e-3, cout)
    t_x, t_w = torch.from_numpy(x), torch.from_numpy(wq)
    t_zps = torch.from_numpy(zps.astype(np.int32))
    pads = tops.resolve_pads(h, w, kh, kw, stride, padding)
    x_p = tops.pad_zp(t_x, t_zps[0], pads)
    return (x_p, t_w, tops.weight_colsum(t_w),
            torch.from_numpy(bias.astype(np.int32)),
            torch.from_numpy(scale.astype(np.float32)), t_zps)


# (label, n, h, w, cin, kh, kw, cout, stride, padding, extra)
REQUANT_CASES = [(f"reduced_{s.name}", 1, s.h, s.w, s.cin, s.kh, s.kw,
                  s.cout, (s.stride, s.stride), "SAME", {})
                 for s in shipdet.reduced_specs()]
REQUANT_CASES += [
    ("stem_cin3", 2, 20, 18, 3, 3, 3, 24, (2, 2), "SAME", {}),
    ("ragged", 2, 13, 11, 10, 3, 3, 70, (1, 1), "SAME", {}),
    ("cin_5_cout_6", 1, 9, 9, 5, 3, 3, 6, (1, 1), "SAME", {}),
    ("stride_2x1", 2, 17, 19, 8, 5, 3, 16, (2, 1), "VALID", {}),
    ("ties_and_clamps", 2, 9, 8, 24, 3, 3, 24, (1, 1), "SAME",
     {"ties": True}),
    ("ties_cout_70", 1, 7, 9, 40, 3, 3, 70, (2, 2), "SAME", {"ties": True}),
    ("wraps", 1, 7, 6, 16, 3, 3, 20, (1, 1), "SAME", {"wraps": True}),
    ("k_5x5x600", 1, 5, 6, 600, 5, 5, 26, (1, 1), "SAME", {}),
]


@pytest.mark.parametrize("case", REQUANT_CASES,
                         ids=[c[0] for c in REQUANT_CASES])
def test_emulated_requant_matches_pallas_and_plain(case):
    label, n, h, w, cin, kh, kw, cout, stride, padding, extra = case
    args = _requant_case(n * 1000 + cin * 10 + cout + 7, n, h, w, cin, kh,
                         kw, cout, stride, padding, **extra)
    got, v = emulate_requant(*args, stride)
    j_out = jkernel.qconv2d(*(jnp.asarray(t.numpy()) for t in args),
                            stride=stride, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(j_out))
    plain = tkernel.qconv2d(*args, stride=stride)
    np.testing.assert_array_equal(got, plain.numpy())
    if extra.get("ties"):
        ties = (v % 2 != 0) & (np.abs(v) < 250)
        assert ties.sum() > 100
        assert (got == 127).any() and (got == -128).any()
        # half to even: a tie rounds to the even neighbour, which half away
        # from zero would miss on every other tie
        away = np.clip(np.trunc(v * 0.5 + np.sign(v) * 0.5)
                       + int(args[5][1]), -128, 127)
        assert (got[ties] != away[ties]).any()
    if extra.get("wraps"):
        exact = emulate(args[0], args[1], args[2],
                        conv_checksum_weight(args[1]), args[5][:1],
                        stride)[0].to(torch.int64) + args[3].to(torch.int64)
        assert (exact.abs() >= 2 ** 31).any()
        assert (np.abs(got.astype(np.int64)) < 127).mean() > 0.5
    if label == "k_5x5x600":
        assert tkernel.plan(n, *got.shape[1:3], cin, kh, kw, cout).bt_k \
            < tkernel.k_padded(kh, kw, cin)


@pytest.mark.parametrize("name", ["qconv2d_acc", "qconv2d_acc_checksum",
                                  "qconv2d"])
@pytest.mark.parametrize("geometry", [(2, 15, 13, 3, 3, 3, 24),
                                      (1, 9, 10, 600, 5, 5, 40),
                                      (4, 49, 49, 96, 1, 1, 6)])
def test_wrappers_pass_the_plan_to_their_entry(monkeypatch, name, geometry):
    """Each wrapper on a card tensor hands its entry the geometry and
    ``plan()``'s launch, as many arguments as the entry declares."""
    n, h, w, cin, kh, kw, cout = geometry
    case = _requant_case(3, n, h, w, cin, kh, kw, cout, (1, 1), "VALID")
    x_p, w_q, colsum, bias, scale, zps = case
    args = {"qconv2d_acc": (x_p, w_q, colsum, zps[:1]),
            "qconv2d_acc_checksum": (x_p, w_q, colsum,
                                     conv_checksum_weight(w_q), zps[:1]),
            "qconv2d": case}[name]
    seen = []
    monkeypatch.setattr(tkernel, "_on_card", lambda *t: True)
    monkeypatch.setattr(tkernel, "_launch",
                        lambda entry, device, *a: seen.append((entry, a)))
    before = getattr(tkernel, name).launches
    getattr(tkernel, name)(*args, stride=(1, 1))
    (entry, passed), = seen
    oh, ow = h - kh + 1, w - kw + 1
    assert entry == f"{name}_launch"
    assert len(passed) + 1 == len(tkernel._ENTRIES[entry])    # + the stream
    assert passed[-14:] == (n, h, w, cin, kh, kw, cout, oh, ow, 1, 1,
                            *tkernel.plan(n, oh, ow, cin, kh, kw, cout))
    assert getattr(tkernel, name).launches == before + 1
