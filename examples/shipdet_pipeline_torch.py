"""The paper's full application on the port: Ship-Detection CNN, int8.

Satellite frames stream through the quantized CNN (OBPMark-ML Ship
Detection topology, the paper's Table-1 trunk) exactly as the HPDP system
runs it: every conv layer executes as int8 conv + fused requantization
(the ``qconv2d`` kernel on the card) with layer parameters streamed in —
and layer outputs chain directly into the next layer (the HPDP→HPDP path).
Float reference runs side by side as the validation (paper Fig. 4).

    PYTHONPATH=src python examples/shipdet_pipeline_torch.py --device cpu

The default is ``reduced_specs()`` on 2 frames; ``--full`` runs
``network_specs(194)`` (388 x 388 frames) on 4.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import shipdet


def run(device="cuda", *, full=False, specs=None, params=None,
        frames=None) -> dict:
    """The forward against the float reference, then the per-layer table;
    ``specs``, ``params`` and ``frames`` default to the reference script's
    draws (at full geometry with ``full``)."""
    dev = resolve_device(device)
    if specs is None:
        # same topology, CPU-sized maps unless full
        specs = shipdet.network_specs(194) if full else shipdet.reduced_specs()
    print(f"ship-detector: {len(specs)} conv layers "
          f"({sum(s.macs for s in specs)/1e6:.1f} M MACs "
          f"{'full' if full else 'reduced'} geometry)")
    if params is None:
        params = shipdet.init_params(specs, torch.Generator().manual_seed(0),
                                     device=dev)
    if frames is None:
        rng = np.random.default_rng(0)
        frames = torch.from_numpy(rng.standard_normal(
            (4 if full else 2, specs[0].h, specs[0].w, 3)).astype(
                np.float32)).to(dev)

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_out, _ = shipdet.forward(specs, params, frames)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    f_out = shipdet.float_forward(specs, params, frames)

    err = float((q_out - f_out).abs().max())
    step = float(params[-1]["out_scale"])
    print(f"detection head out {tuple(q_out.shape)}  (cls+box+obj per cell)")
    print(f"quantized-vs-float: max abs {err:.4f} "
          f"({err/step:.1f} quantization steps of {step})")
    assert err < 4 * step, "int8 pipeline diverged from float reference"

    # per-layer agreement (the unit-test methodology of paper Fig. 4)
    x, rels = frames, []
    print(f"\n{'layer':<12} {'out shape':<20} {'rel err':>8}")
    for s, p in zip(specs, params):
        xq = shipdet.layer_forward(s, p, x, quantized=True)
        xf = shipdet.layer_forward(s, p, x, quantized=False)
        rel = float(torch.linalg.norm(xq - xf)
                    / (torch.linalg.norm(xf) + 1e-9))
        rels.append(rel)
        print(f"{s.name:<12} {str(tuple(xq.shape)):<20} {rel:8.4f}")
        x = torch.relu(xq)       # chain the QUANTIZED stream (HPDP→HPDP)

    print(f"\nforward wall time (quantized, {dev.type.upper()}): "
          f"{t_q*1e3:.1f} ms")
    print("shipdet_pipeline OK")
    return {"q_out": q_out, "f_out": f_out, "err": err, "step": step,
            "layer_rel": rels, "forward_ms": t_q * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="network_specs(194) on 4 frames")
    args = ap.parse_args(argv)
    run(args.device, full=args.full)


if __name__ == "__main__":
    main()
