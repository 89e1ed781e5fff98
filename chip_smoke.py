#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out measurements.json]

Phases, each of which raises on failure:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the qconv2d kernels from ``src/repro_torch/kernels/qconv2d/csrc``;
3. hold each kernel ``torch.equal`` to its plain version on the card, at
   all 8 ``network_specs(194)`` layer shapes (N = 2), a ragged Cout tail,
   a stride (2, 1) case, non-zero zero points, a check channel that
   wraps mod 2^32 and 48 seeded random geometries;
4. the slice: ``shipdet.forward`` at ``network_specs(194)`` on 4 frames
   under the fused NONE path and, on the ``cuda`` backend, NONE, ABFT, CKPT
   (deploy checks + golden weights), DMR and TMR; all bit-identical to each
   other and to the ``ref`` backend; ABFT heals a flipped accumulator bit,
   CKPT a flipped weight bit; within 4 output steps of ``float_forward``;
   every kernel's launch count above 0;
5. time each kernel per layer shape (N = 4) with CUDA events beside its
   plain version and its bound, the forward's frames/s per policy, and the
   forward's device busy time and idle share under torch.profiler.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that holds no checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import random
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
INT32_OPS_PER_S = 67e12            # CUDA-core rate, for the int32 check channel
BATCH = 4                          # frames per forward on the main path
RANDOM_CASES = 48                  # seeded random geometries in phase 3
FORWARD_ROUNDS = 5                 # timing rounds of 10 forwards per policy
DEVICE = "cuda"
KERNEL_SOURCE = "src/repro_torch/kernels/qconv2d/csrc/qconv2d.cu"
REPLACES = {
    "qconv2d_acc": "src/repro/kernels/qconv2d/kernel.py:128",
    "qconv2d_acc_checksum": "src/repro/kernels/qconv2d/kernel.py:163",
    "qconv2d": "src/repro/kernels/qconv2d/kernel.py:211",
}


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to drive")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def phase_build(K) -> float:
    t0 = time.perf_counter()
    lib, log = K.build()
    secs = time.perf_counter() - t0
    print(f"build: {lib.name} in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()}")
    return secs


class Case:
    """Random inputs of one kernel call, made on the card from a seed."""

    def __init__(self, gen, n, h, w, cin, cout, kh, kw, stride, padding,
                 x_zp=None, out_zp=None, x_fill=None, w_fill=None):
        from repro_torch.core.abft import conv_checksum_weight
        from repro_torch.kernels.qconv2d import ops
        dev = DEVICE

        def ints(lo, hi, shape, dtype):
            return torch.randint(lo, hi, shape, generator=gen, device=dev,
                                 dtype=dtype)

        self.stride = stride
        x_q = ints(-128, 128, (n, h, w, cin), torch.int8)
        w_q = ints(-127, 128, (kh, kw, cin, cout), torch.int8)
        if x_fill is not None:
            x_q.fill_(x_fill)
        if w_fill is not None:
            w_q.fill_(w_fill)
        x_zp = int(ints(-10, 11, (), torch.int32)) if x_zp is None else x_zp
        out_zp = int(ints(-10, 11, (), torch.int32)) if out_zp is None \
            else out_zp
        zp0 = torch.tensor(x_zp, dtype=torch.int32, device=dev)
        pads = ops.resolve_pads(h, w, kh, kw, stride, padding)
        self.x_p = ops.pad_zp(x_q, zp0, pads)
        self.w_q = w_q
        self.colsum = ops.weight_colsum(w_q)
        self.w_check = conv_checksum_weight(w_q)
        self.zp = zp0.reshape(1)
        self.bias = ints(-1000, 1000, (cout,), torch.int32)
        self.scale = torch.empty(cout, device=dev).uniform_(
            1e-4, 5e-3, generator=gen)
        self.zps = torch.tensor([x_zp, out_zp], dtype=torch.int32, device=dev)

    def args(self, name):
        if name == "qconv2d_acc":
            return (self.x_p, self.w_q, self.colsum, self.zp)
        if name == "qconv2d_acc_checksum":
            return (self.x_p, self.w_q, self.colsum, self.w_check, self.zp)
        return (self.x_p, self.w_q, self.colsum, self.bias, self.scale,
                self.zps)

    def bound_ms(self, name):
        """Least time on an H100 SXM: each input read once, each output
        written once, int8 MACs at the tensor-core rate."""
        n, hp, wp, cin = self.x_p.shape
        kh, kw, _, cout = self.w_q.shape
        sh, sw = self.stride
        pix = n * ((hp - kh) // sh + 1) * ((wp - kw) // sw + 1)
        taps = kh * kw * cin
        nbytes = self.x_p.numel() + self.w_q.numel() + 4 * cout + 4
        int8_ops, int32_ops = 2 * pix * cout * taps, 0
        if name == "qconv2d":
            nbytes += 8 * cout + 4 + pix * cout
        else:
            nbytes += 4 * pix * cout
        if name == "qconv2d_acc_checksum":
            nbytes += 4 * taps + 4 * pix
            int32_ops = 2 * pix * taps
        t_ops = int8_ops / INT8_OPS_PER_S + int32_ops / INT32_OPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), \
            ("bytes" if t_bytes >= t_ops else "operations")


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _max_err(got, want) -> int:
    errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            for g, w in zip(_outputs(got), _outputs(want))]
    if any(not torch.equal(g, w)
           for g, w in zip(_outputs(got), _outputs(want))):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max abs err {max(errs)})")
    return max(errs)


def _kernels():
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.kernels.qconv2d import ref as R
    return {"qconv2d_acc": (K.qconv2d_acc, R.qconv2d_acc_plain),
            "qconv2d_acc_checksum": (K.qconv2d_acc_checksum,
                                     R.qconv2d_acc_checksum_plain),
            "qconv2d": (K.qconv2d, R.qconv2d_plain)}


def main_path_sides(specs):
    """Each layer's input side as the forward meets it: SAME convs, so a
    stride-2 layer halves the map rounding up (388 → 194 → 97 → 49, where
    the specs' nominal sizes say 98 and 50)."""
    sides, side = [], specs[0].h
    for s in specs:
        sides.append(side)
        side = -(-side // s.stride)
    return sides, side


def _random_case(gen, seed) -> Case:
    """A seeded random geometry: any Cin/Cout (ragged tails, Cin not a
    multiple of 4), 1/3/5-wide kernels, mixed strides, SAME or VALID, zero
    points over the whole int8 range."""
    rng = random.Random(seed)
    kh, kw = rng.choice((1, 3, 5)), rng.choice((1, 3, 5))
    return Case(gen, rng.randint(1, 3), rng.randint(kh, 40),
                rng.randint(kw, 40), rng.randint(1, 100), rng.randint(1, 100),
                kh, kw, (rng.randint(1, 2), rng.randint(1, 2)),
                rng.choice(("SAME", "VALID")), x_zp=rng.randint(-128, 127),
                out_zp=rng.randint(-128, 127))


def phase_compare(specs, gen) -> dict:
    from repro_torch.core.abft import channel_checksum
    cases = [(s.name, Case(gen, 2, h, h, s.cin, s.cout, s.kh, s.kw,
                           (s.stride, s.stride), "SAME"))
             for s, h in zip(specs, main_path_sides(specs)[0])]
    cases += [
        ("ragged_cout", Case(gen, 2, 13, 11, 10, 70, 3, 3, (1, 1), "SAME")),
        ("stride_2x1", Case(gen, 2, 17, 19, 8, 16, 5, 3, (2, 1), "VALID")),
        ("zero_points", Case(gen, 1, 21, 21, 24, 40, 3, 3, (2, 2), "SAME",
                             x_zp=-77, out_zp=53)),
        ("check_wraps", Case(gen, 1, 6, 6, 96, 96, 3, 3, (1, 1), "VALID",
                             x_zp=127, out_zp=0, x_fill=-128, w_fill=127)),
    ]
    cases += [(f"random_{i}", _random_case(gen, i))
              for i in range(RANDOM_CASES)]
    max_err = {name: 0 for name in REPLACES}
    for label, case in cases:
        for name, (kern, plain) in _kernels().items():
            got = kern(*case.args(name), stride=case.stride)
            torch.cuda.synchronize()
            want = plain(*case.args(name), stride=case.stride)
            max_err[name] = max(max_err[name], _max_err(got, want))
            if name == "qconv2d_acc_checksum" and not torch.equal(
                    channel_checksum(got[0]), got[1]):
                raise AssertionError(f"{label}: check channel != Cout-sum")
    print(f"compare: {len(cases)} cases x 3 kernels torch.equal to the "
          f"plain versions on the card")
    return max_err


def phase_slice(specs, params, frames):
    from repro_torch.core.dependability import DependabilityStats, Policy
    from repro_torch.core.fault_injection import flip_bit_at_index
    from repro_torch.core.policy_map import PolicyMap
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.models import shipdet

    def run(p=params, **kw):
        y, st = shipdet.forward(specs, p, frames, **kw)
        torch.cuda.synchronize()
        return y, DependabilityStats.to_host(st)

    checks = shipdet.deploy_checks(params)
    golden = shipdet.golden_weights(params)
    mid = len(specs) // 2
    faulty = list(params)
    faulty[mid] = dict(params[mid])
    faulty[mid]["qconv"] = params[mid]["qconv"]._replace(
        w_q=flip_bit_at_index(params[mid]["qconv"].w_q,
                              params[mid]["qconv"].w_q.numel() // 3, 6))

    K.reset_launches()
    t0 = time.perf_counter()
    y, _ = run()
    outs = {
        "none_cuda": run(backend="cuda"),
        "abft": run(policy=Policy.ABFT),
        "ckpt": run(policy=Policy.CKPT, w_checks=checks, golden_wq=golden),
        "dmr": run(policy_map=PolicyMap.uniform(Policy.DMR)),
        "tmr": run(policy_map=PolicyMap.uniform(Policy.TMR)),
        "abft_struck": run(policy=Policy.ABFT, inject=lambda acc:
                           flip_bit_at_index(acc, acc.numel() // 3, 18)),
        "ckpt_struck": run(faulty, policy=Policy.CKPT, w_checks=checks,
                           golden_wq=golden),
    }
    launches = {k.__name__: k.launches for k in K.KERNELS}
    secs = time.perf_counter() - t0
    print(f"slice: 8 forwards of {tuple(frames.shape)} in {secs:.2f} s, "
          f"launches {launches}")

    side = main_path_sides(specs)[1]
    n_out = (frames.shape[0], side, side, specs[-1].cout)
    if tuple(y.shape) != n_out or not torch.isfinite(y).all():
        raise AssertionError(f"bad detection map {tuple(y.shape)}")
    for name, (y_p, st) in outs.items():
        if not torch.equal(y_p, y):
            raise AssertionError(f"{name} output differs from the fused path")
        print(f"  {name:12s} == fused  stats {st}")
    for name in ("none_cuda", "abft", "ckpt", "dmr", "tmr"):
        if outs[name][1]["faults_detected"] != 0:
            raise AssertionError(f"{name}: false alarm {outs[name][1]}")
    if outs["abft"][1]["checks_run"] != len(specs):
        raise AssertionError(f"abft checks {outs['abft'][1]}")
    st = outs["abft_struck"][1]
    if st["faults_detected"] < 1 or st["faults_corrected"] < 1:
        raise AssertionError(f"ABFT missed the accumulator flip: {st}")
    st = outs["ckpt_struck"][1]
    if st["faults_detected"] < 1 or st["faults_recovered"] < 1:
        raise AssertionError(f"CKPT missed the weight flip: {st}")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")

    y_ref, _ = run(backend="ref")
    if not torch.equal(y_ref, y):
        raise AssertionError("cuda forward differs from the ref backend")
    y_float = shipdet.float_forward(specs, params, frames)
    step = float(params[-1]["out_scale"])
    err = float((y - y_float).abs().max())
    print(f"  ref backend == fused; quantised vs float: max abs {err:.6f} "
          f"= {err / step:.3f} output steps")
    if not err < 4 * step:
        raise AssertionError("int8 pipeline diverged from the float oracle")
    return launches


def _time_ms(fn, reps, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps) -> float | None:
    """Mean device time of the kernels ``fn`` launches, from the profiler's
    CUPTI trace (None where the profiler sees no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "qconv2d_kernel" in e.name]
    return sum(spans) / reps / 1e3 if spans else None


def phase_time(specs, gen, max_err):
    """CUDA-event times per call at the main path's shapes.  Returns the
    per-layer rows, the per-kernel totals and the calls, which
    ``phase_profile`` times again on the device after every event timing
    is done (a profiler session slows what runs after it)."""
    rows, calls = [], []
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "t_bytes": 0.0, "t_ops": 0.0} for name in REPLACES}
    for s, h in zip(specs, main_path_sides(specs)[0]):
        case = Case(gen, BATCH, h, h, s.cin, s.cout, s.kh, s.kw,
                    (s.stride, s.stride), "SAME")
        for name, (kern, plain) in _kernels().items():
            args, st = case.args(name), case.stride
            max_err[name] = max(max_err[name], _max_err(
                kern(*args, stride=st), plain(*args, stride=st)))
            ms = _time_ms(lambda: kern(*args, stride=st), reps=50)
            plain_ms = _time_ms(lambda: plain(*args, stride=st), reps=3,
                                warmup=1)
            bound, by = case.bound_ms(name)
            rows.append({"layer": s.name, "kernel": name, "ms": ms,
                         "device_ms": None, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by})
            calls.append(functools.partial(kern, *args, stride=st))
            tot = totals[name]
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["t_" + ("bytes" if by == "bytes" else "ops")] += bound
    return rows, totals, calls


def phase_forward(specs, params, frames):
    from repro_torch.core.dependability import Policy
    from repro_torch.core.policy_map import PolicyMap
    from repro_torch.models import shipdet
    checks = shipdet.deploy_checks(params)
    golden = shipdet.golden_weights(params)
    variants = {
        "none_fused": {},
        "none_cuda": {"backend": "cuda"},
        "abft": {"policy": Policy.ABFT},
        "ckpt": {"policy": Policy.CKPT, "w_checks": checks,
                 "golden_wq": golden},
        "dmr": {"policy_map": PolicyMap.uniform(Policy.DMR)},
        "tmr": {"policy_map": PolicyMap.uniform(Policy.TMR)},
    }
    # the forward is host-bound and the host is shared: rounds interleave
    # the variants so that drift lands on all of them, and the median and
    # range of the rounds are reported
    rounds = {name: [] for name in variants}
    for _ in range(FORWARD_ROUNDS):
        for name, kw in variants.items():
            rounds[name].append(_time_ms(
                lambda: shipdet.forward(specs, params, frames, **kw),
                reps=10))
    out = {}
    for name, times in rounds.items():
        ms = statistics.median(times)
        out[name] = {"ms_per_batch": ms, "ms_rounds": times,
                     "frames_per_s": frames.shape[0] / (ms / 1e3)}
        print(f"forward {name:10s} {ms:9.3f} ms per batch of "
              f"{frames.shape[0]} (median of {len(times)} rounds, range "
              f"{min(times):.3f}-{max(times):.3f})  "
              f"{out[name]['frames_per_s']:9.1f} frames/s")
    return out


def phase_profile(specs, params, frames, rows, calls, reps=5):
    """Device busy time of the forward under torch.profiler (CUPTI): the
    union of kernel and copy intervals over the host wall time of the same
    window, and the kernels that take the most device time; then each
    kernel call's device time, filled into ``rows``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.dependability import Policy
    from repro_torch.models import shipdet
    out = {}
    for name, kw in (("none_fused", {}), ("abft", {"policy": Policy.ABFT})):
        shipdet.forward(specs, params, frames, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                shipdet.forward(specs, params, frames, **kw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not spans:
            print(f"profile {name}: the profiler saw no device time "
                  f"(not measured)")
            out[name] = None
            continue
        busy, end, by_name = 0.0, float("-inf"), {}
        for start, stop, kname in spans:
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
            by_name[kname] = by_name.get(kname, 0.0) + (stop - start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"wall_ms_per_forward": wall_us / reps / 1e3,
                     "device_busy_ms_per_forward": busy / reps / 1e3,
                     "idle_share": 1.0 - busy / wall_us,
                     "device_launches_per_forward": len(spans) / reps,
                     "top": [{"name": k[:90], "ms_per_forward": v / reps / 1e3}
                             for k, v in top]}
        o = out[name]
        print(f"profile {name}: wall {o['wall_ms_per_forward']:.3f} ms, "
              f"device busy {o['device_busy_ms_per_forward']:.3f} ms, idle "
              f"share {o['idle_share']:.3f}, "
              f"{o['device_launches_per_forward']:.0f} device ops/forward")
        for t in o["top"]:
            print(f"    {t['ms_per_forward']:8.4f} ms  {t['name']}")

    for row, call in zip(rows, calls):
        row["device_ms"] = _device_ms(call, reps=10)
    print(f"kernel times per layer, N = {BATCH} (CUDA events per call; "
          f"device time from the profiler):")
    for r in rows:
        dev = "n/m" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        print(f"  {r['layer']:16s} {r['kernel']:22s} {r['ms']:9.4f} ms  "
              f"device {dev:>7s} ms  plain {r['plain_ms']:9.3f} ms  "
              f"bound {r['bound_ms']:8.5f} ms ({r['bound_by']})")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args()

    card = phase_card()
    from repro_torch.kernels.qconv2d import kernel as K
    from repro_torch.models import shipdet
    build_s = phase_build(K)
    specs = shipdet.network_specs(194)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    max_err = phase_compare(specs, gen)

    params = shipdet.init_params(specs, torch.Generator().manual_seed(0),
                                 device=DEVICE)
    frames = torch.rand((BATCH, specs[0].h, specs[0].w, 3),
                        generator=torch.Generator().manual_seed(1)).to(DEVICE)
    launches = phase_slice(specs, params, frames)

    rows, totals, calls = phase_time(specs, gen, max_err)
    forward = phase_forward(specs, params, frames)
    profile = phase_profile(specs, params, frames, rows, calls)

    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": max_err[name], "ms": totals[name]["ms"],
        "plain_ms": totals[name]["plain_ms"],
        "bound_ms": totals[name]["bound_ms"],
        "bound_by": ("bytes" if totals[name]["t_bytes"]
                     >= totals[name]["t_ops"] else "operations"),
        "library_ms": None,
    } for name in REPLACES]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s,
                       "batch": BATCH, "kernels": kernels, "per_layer": rows,
                       "forward": forward, "profile": profile}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
