"""Device times of the int8 matmul kernels outside the main path.

* Rows 4 and 5 (``qmatmul_acc``, ``qmatmul_acc_checksum``) at SmolLM-135M's
  FFN shapes for every split of K over 1 to 8 cluster ranks, beside the
  one ``plan`` picks: the measurement behind ``plan``'s limits.
* With ``--parent DIR`` (a checkout of another commit), row 6
  (``qmatmul``) built from that checkout's ``qmatmul.cu`` and from this
  one's, at the FFN shapes and the flash prefills' (M = 256, 1024), on
  the same inputs, timed in the order parent, this, this, parent, and
  checked bit-identical.

Device time per call is the mean of the kernel ops that the profiler saw
over 50 calls; each call must be one op of the expected kernel.  Needs a
CUDA device:

    PYTHONPATH=src python -m repro_torch.kernels.qmatmul.sweep \\
        [--parent DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
from unittest import mock

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import I as _I, P as _P
from repro_torch.kernels.qmatmul import kernel as MK

ROWS = (8, 64)                    # decode capacity, prefill padding
PREFILL_ROWS = (256, 1024)        # flash prefills' FFN rows
D_MODEL, D_FF = 576, 1536         # SmolLM-135M
REPS = 50
# the parent's row 6 (the dp4a kernel) takes no plan
_PARENT = {"qmatmul_launch": [_P] * 7 + [_I] * 3 + [_P]}


def device_ms(fn, kernel: str, reps: int = REPS, tries: int = 5) -> float:
    """Mean device ms of the ops the profiler saw over ``reps`` calls of
    ``fn``; raises unless every op is ``kernel`` and none is extra.  A
    window can lose a few records and, now and then, all of them: up to
    ``tries`` windows are taken until one sees 90 % of the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(ops) >= 0.9 * reps:
            break
    names = {e.name for e in ops}
    if not ops or len(ops) > reps or any(kernel not in n for n in names):
        raise AssertionError(f"{len(ops)} device ops in {reps} calls "
                             f"({sorted(names)}), want one {kernel} each")
    return sum(e.time_range.end - e.time_range.start for e in ops) \
        / len(ops) / 1e3


def _inputs(gen, m, k, n):
    from repro_torch.core.abft import checksum_vector
    x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    return x, w, checksum_vector(w)


def sweep(gen) -> list:
    """Rows 4 and 5 at each FFN shape for every distinct split."""
    out = []
    plan = MK.plan
    for m in ROWS:
        for k, n in ((D_MODEL, D_FF), (D_FF, D_MODEL)):
            x, w, w_check = _inputs(gen, m, k, n)
            chosen = plan(m, k, n)
            splits = {plan(m, k, n, r) for r in range(1, 9)}
            for p in sorted(splits, key=lambda p: p.cluster):
                with mock.patch.object(MK, "plan", lambda *_: p):
                    acc = device_ms(lambda: MK.qmatmul_acc(x, w),
                                    "qmatmul_mma_kernel<0>")
                    chk = device_ms(
                        lambda: MK.qmatmul_acc_checksum(x, w, w_check),
                        "qmatmul_mma_kernel<1>")
                out.append({"shape": (m, k, n), "cluster": p.cluster,
                            "blocks": p.grid, "chosen": p == chosen,
                            "acc_ms": acc, "checksum_ms": chk})
                print(f"  {str((m, k, n)):18s} ranks {p.cluster} "
                      f"({p.grid:4d} blocks){'*' if p == chosen else ' '} "
                      f"row 4 {acc:.4f} ms  row 5 {chk:.4f} ms", flush=True)
    return out


def requant_ab(gen, parent: pathlib.Path) -> list:
    """Row 6 of ``parent``'s source against this one's, parent first."""
    src = parent / MK.SOURCE.relative_to(MK.SOURCE.parents[5])
    lib = cuda_lib.load(src, _PARENT)
    out = []
    for m in ROWS + PREFILL_ROWS:
        for k, n in ((D_MODEL, D_FF), (D_FF, D_MODEL)):
            x, w, _ = _inputs(gen, m, k, n)
            colsum = w.to(torch.int32).sum(0).to(torch.int32)
            bias = torch.randint(-1000, 1000, (n,), generator=gen,
                                 device="cuda", dtype=torch.int32)
            scale = torch.empty(n, device="cuda").uniform_(1e-4, 5e-3,
                                                           generator=gen)
            zps = torch.tensor([-3, 5], dtype=torch.int32, device="cuda")
            y = torch.empty((m, n), dtype=torch.int8, device="cuda")

            def parent_fn():
                cuda_lib.launch(lib, "qmatmul_launch", x.device,
                                *(t.data_ptr() for t in
                                  (x, w, colsum, bias, scale, zps, y)),
                                m, k, n)

            def this_fn():
                return MK.qmatmul(x, w, colsum, bias, scale, zps)

            parent_fn()
            if not torch.equal(y, this_fn()):
                raise AssertionError(f"row 6 differs from the parent's at "
                                     f"{(m, k, n)}")
            ms = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                ms[who].append(device_ms(
                    this_fn if who == "this" else parent_fn,
                    "qmatmul_mma_kernel<2>" if who == "this"
                    else "qmatmul_requant_kernel"))
            out.append({"shape": (m, k, n), "plan": MK.plan(m, k, n), **ms})
            print(f"  {str((m, k, n)):18s} row 6 parent "
                  + " / ".join(f"{v:.4f}" for v in ms["parent"])
                  + " ms  this " + " / ".join(f"{v:.4f}" for v in ms["this"])
                  + " ms  (bit-identical)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of another commit whose row 6 is "
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
    gen = torch.Generator(device="cuda").manual_seed(18)
    print("rows 4 / 5, device ms per call by ranks per cluster "
          "(* the plan's):")
    result = {"card": card, "sweep": sweep(gen)}
    if args.parent is not None:
        print("row 6, device ms per call, parent's source against this "
              "one's:")
        result["requant"] = requant_ab(gen, args.parent)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
