"""Precision witness for rwkv6: how far float32 logits stand from float64
logits of the same model, position by position.

    PYTHONPATH=src python -m repro_torch.models.witness [--cpu] \\
        [--out witness.json]

Draws the weights and tokens as ``chip_smoke.py``'s recurrent phase does
(weights from seed 0 on the host, tokens from a seed-13 generator on the
device), runs ``forward`` at 64 and 80 tokens in float32 and float64 and
``prefill`` + ``decode_step`` in float32 and bfloat16, and prints, for each
pair, the largest |difference| per position over the largest |logit| of
the float64 forward.  ``--cpu`` repeats the forwards on the host.  TF32 is
off throughout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import registry
from repro_torch.models import api

CHUNK = 32            # wkv_chunked's chunk: the profile is cut at its edges


def _profile(a, b, scale):
    """Per position max |a - b| / scale (a, b: (S, V), on any device)."""
    return (a.double().cpu() - b.double().cpu()).abs().amax(-1) / scale


def _summary(p, prompt):
    top = torch.argsort(p, descending=True)[:6]
    return {"max": float(p.max()), "argmax": int(p.argmax()),
            "top": [[int(i), float(p[i])] for i in top],
            "chunk_max": [float(p[c:c + CHUNK].max())
                          for c in range(0, len(p), CHUNK)],
            "median": float(p.median()),
            "decode_positions_max": float(p[prompt:].max())
            if len(p) > prompt else None}


def _forwards(cfg, params, toks, prompt):
    with torch.no_grad():
        full = api.forward(cfg, params, toks).logits[0]
        short = api.forward(cfg, params, toks[:, :prompt]).logits[0]
    return short, full


def _decode(cfg, params, toks, prompt):
    """prefill(prompt) logits, then one decode_step per remaining token."""
    n = toks.shape[1]
    with torch.no_grad():
        lg, cache = api.prefill(cfg, params, toks[:, :prompt], n)
        got = [lg[0]]
        for t in range(prompt, n):
            step, cache = api.decode_step(cfg, params, toks[:, t], cache)
            got.append(step)
    return torch.cat(got)


def witness(cfg, prompt: int = 64, steps: int = 16, cpu: bool = False,
            device="cuda") -> dict:
    """The per-position profiles of one rwkv config (see the module
    docstring), summarised.  Only rwkv6 runs wholly in float64 under a
    float64 compute dtype (griffin's attention stays in f32)."""
    if cfg.family != "rwkv":
        raise ValueError(f"no float64 path for family {cfg.family!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    gen = torch.Generator(device=device).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt + steps),
                         generator=gen, device=device)
    dt = {d: dataclasses.replace(cfg, compute_dtype=d)
          for d in ("float32", "float64", "bfloat16")}
    s32, f32 = _forwards(dt["float32"], params, toks, prompt)
    s64, f64 = _forwards(dt["float64"], params, toks, prompt)
    d32 = _decode(dt["float32"], params, toks, prompt)
    scale = float(f64.abs().max())
    pairs = {
        "f32 forward S vs S+steps": _profile(s32, f32[:prompt], scale),
        "f64 forward S vs S+steps": _profile(s64, f64[:prompt], scale),
        "f32 forward S vs f64": _profile(s32, s64, scale),
        "f32 forward S+steps vs f64": _profile(f32, f64, scale),
        "f32 prefill+decode vs f64": _profile(d32, f64, scale),
        "f32 prefill+decode vs f32 forward": _profile(d32, f32, scale),
        "bf16 prefill+decode vs f32 forward": _profile(
            _decode(dt["bfloat16"], params, toks, prompt), f32, scale),
    }
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "prompt": prompt,
           "steps": steps, "scale": scale,
           "device": torch.cuda.get_device_name()
           if torch.device(device).type == "cuda" else "cpu"}
    if cpu:
        t0 = time.perf_counter()
        host, htoks = _to_cpu(params), toks.cpu()
        c32 = _forwards(dt["float32"], host, htoks, prompt)
        c64 = _forwards(dt["float64"], host, htoks, prompt)
        pairs["cpu f32 forward S vs S+steps"] = _profile(
            c32[0], c32[1][:prompt], scale)
        pairs["cpu f64 forward S vs S+steps"] = _profile(
            c64[0], c64[1][:prompt], scale)
        pairs["cpu f32 forward S+steps vs card f32"] = _profile(
            c32[1], f32, scale)
        pairs["cpu f64 forward S+steps vs card f64"] = _profile(
            c64[1], f64, scale)
        pairs["cpu f32 forward S+steps vs cpu f64"] = _profile(
            c32[1], c64[1], scale)
        out["cpu_s"] = time.perf_counter() - t0
    out["pairs"] = {k: _summary(p, prompt) for k, p in pairs.items()}
    return out


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--cpu", action="store_true",
                    help="also run the two forwards on the host")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    doc = witness(registry.get(args.arch), cpu=args.cpu)
    print(f"witness: {args.arch} ({doc['n_layers']} layers) on "
          f"{doc['device']}, max |logit| {doc['scale']:.4f} (f64 forward), "
          f"per position max |diff| / max |logit|:")
    for k, v in doc["pairs"].items():
        print(f"  {k}: max {v['max']:.3e} at {v['argmax']}, median "
              f"{v['median']:.3e}, per chunk "
              + " ".join(f"{c:.2e}" for c in v["chunk_max"])
              + f", top {[(i, f'{e:.2e}') for i, e in v['top']]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
