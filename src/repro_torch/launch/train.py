"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 --ckpt-dir runs/train1 [--reduced]

The counterpart of ``repro.launch.train``: config registry → data pipeline
→ fault-tolerant training driver (checkpoint/restart, corruption
detection) → metrics log.  It runs on the card (``--device cuda``, the
default); ``--device cpu`` runs the kernels' plain versions, where
``--reduced`` (same family, small dims) keeps it small.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.models.config import ShapeConfig, reduced
from repro_torch.runtime import ft_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    ft = ft_loop.FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          seed=args.seed)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq} "
          f"device={where}")
    t0 = time.time()
    rep = ft_loop.run(cfg, shape, ft, n_steps=args.steps, lr=args.lr,
                      device=dev)
    dt = time.time() - t0

    toks = len(rep.losses) * args.batch * args.seq
    if not rep.losses:
        print(f"[train] {args.ckpt_dir} already holds step {args.steps}: "
              f"nothing to train")
        return rep
    print(f"[train] done in {dt:.1f}s  ({toks/dt:.0f} tok/s)  "
          f"loss {rep.losses[0]:.4f} → {rep.losses[-1]:.4f}  "
          f"recoveries={rep.recoveries}")
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps({
            "arch": cfg.name, "device": where, "losses": rep.losses,
            "wall_s": dt, "tokens_per_s": toks / dt,
            "recoveries": rep.recoveries}))
    return rep


if __name__ == "__main__":
    main()
