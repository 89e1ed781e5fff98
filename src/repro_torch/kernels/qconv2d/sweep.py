"""Device times of the int8 conv kernels at the ship detector's layers
against another commit's, outside the main path.

Rows 1, 2 and 3 (``qconv2d_acc``, ``qconv2d_acc_checksum``, ``qconv2d``)
at the eight layers of ``network_specs(194)``, batch 4, built from the
``qconv2d.cu`` of ``--parent DIR`` (a checkout of another commit) and from
this one's, on the same inputs, timed in the order parent, this, this,
parent, and checked bit-identical: a before/after free of the drift
between calls.

Device time per call is the mean of the kernel ops that the profiler saw
over 50 calls.  Needs a CUDA device:

    PYTHONPATH=src python -m repro_torch.kernels.qconv2d.sweep \\
        --parent DIR [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.abft import conv_checksum_weight
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import I as _I, P as _P
from repro_torch.kernels.qconv2d import kernel as K
from repro_torch.kernels.qconv2d import ops
from repro_torch.kernels.qmatmul.sweep import device_ms
from repro_torch.models import shipdet

BATCH = 4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
# the parent's entries: rows 1 and 2 take the plan as this tree's do, its
# row 3 (the dp4a kernel) takes none
_PARENT = {"qconv2d_acc_launch": K._ENTRIES["qconv2d_acc_launch"],
           "qconv2d_acc_checksum_launch":
               K._ENTRIES["qconv2d_acc_checksum_launch"],
           "qconv2d_launch": [_P] * 7 + [_I] * 11 + [_P]}
# each row's device op in the parent's source and in this one's
_OPS = {"acc": ("qconv2d_mma_kernel<0", "qconv2d_mma_kernel<0"),
        "checksum": ("qconv2d_mma_kernel<1", "qconv2d_mma_kernel<1"),
        "requant": ("qconv2d_requant_kernel", "qconv2d_mma_kernel<2")}
ROWS = {"acc": 1, "checksum": 2, "requant": 3}


class Layer(NamedTuple):
    name: str
    x_p: torch.Tensor
    w: torch.Tensor
    colsum: torch.Tensor
    w_check: torch.Tensor
    zp: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    zps: torch.Tensor
    stride: Tuple[int, int]


def layers(gen):
    """Each layer's inputs of rows 1-3, at the sides the forward meets
    (SAME, 388 → 194 → 97 → 49)."""
    out, side = [], None
    for s in shipdet.network_specs(194):
        side = s.h if side is None else side
        stride = (s.stride, s.stride)
        x = torch.randint(-128, 128, (BATCH, side, side, s.cin),
                          generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (s.kh, s.kw, s.cin, s.cout),
                          generator=gen, device="cuda", dtype=torch.int8)
        zp = torch.tensor([-3], dtype=torch.int32, device="cuda")
        pads = ops.resolve_pads(side, side, s.kh, s.kw, stride, "SAME")
        bias = torch.randint(-1000, 1000, (s.cout,), generator=gen,
                             device="cuda", dtype=torch.int32)
        scale = torch.empty(s.cout, device="cuda").uniform_(1e-4, 5e-3,
                                                            generator=gen)
        zps = torch.tensor([-3, 5], dtype=torch.int32, device="cuda")
        out.append(Layer(s.name, ops.pad_zp(x, zp.reshape(()), pads), w,
                         ops.weight_colsum(w), conv_checksum_weight(w), zp,
                         bias, scale, zps, stride))
        side = -(-side // s.stride)
    return out


def bound_ms(lay: Layer, row: str) -> float:
    """Each input read once, each output written once, over 3.35 TB/s."""
    n, hp, wp, cin = lay.x_p.shape
    kh, kw, _, cout = lay.w.shape
    sh, sw = lay.stride
    pix = n * ((hp - kh) // sh + 1) * ((wp - kw) // sw + 1)
    nbytes = lay.x_p.numel() + lay.w.numel() + 4 * cout + 4
    if row == "requant":
        nbytes += 8 * cout + 4 + pix * cout
    else:
        nbytes += 4 * pix * cout
    if row == "checksum":
        nbytes += 4 * kh * kw * cin + 4 * pix
    return 1e3 * nbytes / HBM_BYTES_PER_S


def _calls(lib, lay: Layer):
    """Per row, (the parent's call, this tree's call), each writing its
    own outputs; and a function that returns both trees' outputs."""
    x_p, w = lay.x_p, lay.w
    n, hp, wp, cin = x_p.shape
    kh, kw, _, cout = w.shape
    sh, sw = lay.stride
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    geo = (n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw)
    p = K.plan(n, oh, ow, cin, kh, kw, cout)
    acc = torch.empty((n, oh, ow, cout), dtype=torch.int32, device="cuda")
    want = torch.empty((n, oh, ow), dtype=torch.int32, device="cuda")
    q = torch.empty((n, oh, ow, cout), dtype=torch.int8, device="cuda")
    ptrs = {"acc": (x_p, w, lay.colsum, lay.zp, acc),
            "checksum": (x_p, w, lay.colsum, lay.w_check, lay.zp, acc,
                         want),
            "requant": (x_p, w, lay.colsum, lay.bias, lay.scale, lay.zps,
                        q)}
    entry = {"acc": "qconv2d_acc_launch",
             "checksum": "qconv2d_acc_checksum_launch",
             "requant": "qconv2d_launch"}
    mine = {"acc": lambda: K.qconv2d_acc(x_p, w, lay.colsum, lay.zp,
                                         stride=lay.stride),
            "checksum": lambda: K.qconv2d_acc_checksum(
                x_p, w, lay.colsum, lay.w_check, lay.zp, stride=lay.stride),
            "requant": lambda: K.qconv2d(x_p, w, lay.colsum, lay.bias,
                                         lay.scale, lay.zps,
                                         stride=lay.stride)}
    outs = {"acc": (acc,), "checksum": (acc, want), "requant": (q,)}
    calls = {}
    for row, name in entry.items():
        tail = geo if row == "requant" else (*geo, *p)

        def parent(row=row, name=name, tail=tail):
            cuda_lib.launch(lib, name, x_p.device,
                            *(t.data_ptr() for t in ptrs[row]), *tail)
        calls[row] = (parent, mine[row], outs[row])
    return calls


def parent_ab(cases, parent: pathlib.Path) -> list:
    """Rows 1, 2 and 3 of ``parent``'s source against this one's, parent
    first, on the same inputs; their outputs bit-identical."""
    src = parent / K.SOURCE.relative_to(K.SOURCE.parents[5])
    lib = cuda_lib.load(src, _PARENT)
    out = []
    for lay in cases:
        row = {"layer": lay.name}
        for key, (parent_fn, this_fn, parent_out) in _calls(lib, lay).items():
            parent_fn()
            got = this_fn()
            got = got if isinstance(got, tuple) else (got,)
            if not all(torch.equal(a, b) for a, b in zip(parent_out, got)):
                raise AssertionError(f"{lay.name}: row {ROWS[key]} differs "
                                     f"from the parent's")
            ms = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                ms[who].append(device_ms(
                    this_fn if who == "this" else parent_fn,
                    _OPS[key][who == "this"]))
            row[key] = {**ms, "bound_ms": bound_ms(lay, key)}
        out.append(row)
        print(f"  {lay.name:16s} " + " | ".join(
            f"row {ROWS[key]} parent "
            + " / ".join(f"{v:.4f}" for v in row[key]["parent"])
            + "  this " + " / ".join(f"{v:.4f}" for v in row[key]["this"])
            + f"  bound {row[key]['bound_ms']:.5f}" for key in ROWS)
            + " ms (bit-identical)", flush=True)
    for key in ROWS:
        tot = {who: sum(sum(r[key][who]) / 2 for r in out)
               for who in ("parent", "this")}
        print(f"  per forward, row {ROWS[key]}: parent {tot['parent']:.4f} "
              f"ms, this {tot['this']:.4f} ms "
              f"({tot['parent'] / tot['this']:.2f}x)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout of another commit whose rows 1-3 are "
                         "timed against this one's")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    cases = layers(torch.Generator(device="cuda").manual_seed(19))
    print("rows 1 / 2 / 3, device ms per call, the parent's source against "
          "this one's:")
    result = {"card": card, "parent": parent_ab(cases, args.parent)}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
