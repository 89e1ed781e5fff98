"""Device times of the int8 conv accumulator kernels at the ship detector's
layers against another commit's, outside the main path.

Rows 1 and 2 (``qconv2d_acc``, ``qconv2d_acc_checksum``) at the eight
layers of ``network_specs(194)``, batch 4, built from the ``qconv2d.cu`` of
``--parent DIR`` (a checkout of another commit) and from this one's, on the
same inputs, timed in the order parent, this, this, parent, and checked
bit-identical: a before/after free of the drift between calls.

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
# the entries of a source whose accumulator kernels take no plan
_PARENT = {"qconv2d_acc_launch": [_P] * 5 + [_I] * 11 + [_P],
           "qconv2d_acc_checksum_launch": [_P] * 7 + [_I] * 11 + [_P]}


def layers(gen):
    """Each layer's name and row-2 arguments (x_p, w_q, colsum, w_check,
    zp) and stride, at the sides the forward meets (SAME, 388 → 194 → 97
    → 49)."""
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
        x_p = ops.pad_zp(x, zp.reshape(()), pads)
        out.append((s.name, (x_p, w, ops.weight_colsum(w),
                             conv_checksum_weight(w), zp), stride))
        side = -(-side // s.stride)
    return out


def bound_ms(args, stride, check):
    """Each input read once, each output written once, over 3.35 TB/s."""
    x_p, w, _, _, _ = args
    n, hp, wp, cin = x_p.shape
    kh, kw, _, cout = w.shape
    pix = n * ((hp - kh) // stride[0] + 1) * ((wp - kw) // stride[1] + 1)
    nbytes = x_p.numel() + w.numel() + 4 * cout + 4 + 4 * pix * cout
    if check:
        nbytes += 4 * kh * kw * cin + 4 * pix
    return 1e3 * nbytes / HBM_BYTES_PER_S


def _geometry(args, stride):
    x_p, w = args[0], args[1]
    n, hp, wp, cin = x_p.shape
    kh, kw, _, cout = w.shape
    oh = (hp - kh) // stride[0] + 1
    ow = (wp - kw) // stride[1] + 1
    return n, hp, wp, cin, kh, kw, cout, oh, ow, *stride


def parent_ab(cases, parent: pathlib.Path) -> list:
    """Rows 1 and 2 of ``parent``'s source against this one's, parent
    first, on the same inputs; their outputs bit-identical."""
    src = parent / K.SOURCE.relative_to(K.SOURCE.parents[5])
    lib = cuda_lib.load(src, _PARENT)
    out = []
    for name, args, stride in cases:
        x_p, w, colsum, w_check, zp = args
        geo = _geometry(args, stride)
        n, oh, ow, cout = geo[0], geo[7], geo[8], geo[6]
        acc = torch.empty((n, oh, ow, cout), dtype=torch.int32, device="cuda")
        want = torch.empty((n, oh, ow), dtype=torch.int32, device="cuda")

        def parent_acc():
            cuda_lib.launch(lib, "qconv2d_acc_launch", x_p.device,
                            *(t.data_ptr() for t in (x_p, w, colsum, zp,
                                                     acc)), *geo)

        def parent_chk():
            cuda_lib.launch(lib, "qconv2d_acc_checksum_launch", x_p.device,
                            *(t.data_ptr() for t in (x_p, w, colsum, w_check,
                                                     zp, acc, want)), *geo)

        def this_acc():
            K.qconv2d_acc(x_p, w, colsum, zp, stride=stride)

        def this_chk():
            K.qconv2d_acc_checksum(*args, stride=stride)

        parent_chk()
        mine = K.qconv2d_acc_checksum(*args, stride=stride)
        if not (torch.equal(acc, mine[0]) and torch.equal(want, mine[1])):
            raise AssertionError(f"{name}: rows 1-2 differ from the "
                                 f"parent's")
        parent_acc()
        if not torch.equal(acc, K.qconv2d_acc(x_p, w, colsum, zp,
                                              stride=stride)):
            raise AssertionError(f"{name}: row 1 differs from the parent's")
        row = {"layer": name, "bound_ms": bound_ms(args, stride, False),
               "bound_checksum_ms": bound_ms(args, stride, True)}
        for key, fns, op in (("acc", (parent_acc, this_acc), "<0"),
                             ("checksum", (parent_chk, this_chk), "<1")):
            ms = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                fn = fns[who == "this"]
                kern = "qconv2d_kernel" if who == "parent" \
                    else "qconv2d_mma_kernel" + op
                ms[who].append(device_ms(fn, kern))
            row[key] = ms
        out.append(row)
        print(f"  {name:16s} row 1 parent "
              + " / ".join(f"{v:.4f}" for v in row["acc"]["parent"])
              + "  this " + " / ".join(f"{v:.4f}" for v in row["acc"]["this"])
              + f"  bound {row['bound_ms']:.5f} | row 2 parent "
              + " / ".join(f"{v:.4f}" for v in row["checksum"]["parent"])
              + "  this "
              + " / ".join(f"{v:.4f}" for v in row["checksum"]["this"])
              + f"  bound {row['bound_checksum_ms']:.5f} ms (bit-identical)",
              flush=True)
    for key in ("acc", "checksum"):
        tot = {who: sum(sum(r[key][who]) / 2 for r in out)
               for who in ("parent", "this")}
        print(f"  per forward, row {1 if key == 'acc' else 2}: parent "
              f"{tot['parent']:.4f} ms, this {tot['this']:.4f} ms "
              f"({tot['parent'] / tot['this']:.1f}x)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout of another commit whose rows 1 and 2 "
                         "are timed against this one's")
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
    print("rows 1 / 2, device ms per call, the parent's source against "
          "this one's:")
    result = {"card": card, "parent": parent_ab(cases, args.parent)}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
