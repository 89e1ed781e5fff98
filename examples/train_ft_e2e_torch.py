"""End-to-end fault-tolerant training on the port.

Trains the smollm-135m family (by default reduced to CPU scale, as the
reference script does; ``--full`` trains SmolLM-135M in full, at 8 x 1,024
tokens per step with flash attention, through the same code path) with the
complete production loop:

    deterministic data pipeline → train step → atomic checkpoints
    → SEU injection mid-run → detection (loss spike) → restore+replay
    → final loss curve BIT-IDENTICAL to a fault-free run.

    PYTHONPATH=src python examples/train_ft_e2e_torch.py --device cpu

The SEU flips the top exponent bit of ``embed[0, 0]`` in the leaf's own
dtype (bit 30 of an f32 master weight).  The data stream is Zipfian, so
token 0 is read at every step and the flip meets the loss at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core import fault_injection as fi
from repro_torch.models.config import ShapeConfig, reduced
from repro_torch.runtime import ft_loop
from repro_torch.train import checkpoint as ckpt

ARCH = "smollm-135m"
# (steps, ckpt_every, batch, seq) of the default run and of --full
RUNS = {False: (300, 50, 8, 64), True: (12, 4, 8, 1024)}


def default_config(full=False):
    """The reference script's reduced 4-layer f32 config, or SmolLM-135M in
    full (f32 master weights, bf16 compute, flash attention)."""
    if full:
        return dataclasses.replace(registry.get(ARCH), attn_impl="flash")
    return dataclasses.replace(reduced(registry.get(ARCH)), n_layers=4,
                               d_model=128, d_ff=256,
                               compute_dtype="float32",
                               param_dtype="float32")


def top_exponent_bit(dtype: torch.dtype) -> int:
    """The highest exponent bit of a float dtype: 30 for f32, 14 for bf16
    and f16, 62 for f64."""
    return torch.finfo(dtype).bits - 2


def run(device="cuda", *, full=False, cfg=None, shape=None, steps=None,
        ckpt_every=None, init_state=None) -> dict:
    """A clean run, then one with the SEU at ``steps // 2``; returns both
    loss curves and the faulty run's recoveries.  ``init_state`` (a
    ``TrainState``) is saved as step 0 of both runs, which then resume from
    it; by default each draws its own from the loop's seed."""
    dev = resolve_device(device)
    d_steps, d_every, d_batch, d_seq = RUNS[full]
    steps = d_steps if steps is None else steps
    every = d_every if ckpt_every is None else ckpt_every
    cfg = default_config(full) if cfg is None else cfg
    if shape is None:
        shape = ShapeConfig("e2e", seq_len=d_seq, global_batch=d_batch,
                            kind="train")
    tokens = shape.global_batch * shape.seq_len
    print(f"arch family: {cfg.name}  params≈{cfg.param_count()/1e6:.2f}M  "
          f"steps={steps}  tokens/step={tokens}")

    root = Path(tempfile.mkdtemp(prefix="repro_torch_e2e_"))
    try:
        if init_state is not None:
            for name in ("clean", "faulty"):
                ckpt.save(root / name, 0, init_state)

        # ---- fault-free reference run
        t0 = time.time()
        ftc = ft_loop.FTConfig(ckpt_dir=str(root / "clean"),
                               ckpt_every=every)
        clean = ft_loop.run(cfg, shape, ftc, n_steps=steps, device=dev)
        dt = time.time() - t0
        print(f"[clean ] {steps} steps in {dt:.1f}s "
              f"({steps*tokens/dt:.0f} tok/s)  "
              f"loss {clean.losses[0]:.4f} → {clean.losses[-1]:.4f}")
        assert clean.losses[-1] < clean.losses[0], "model failed to learn"

        # ---- faulty run: SEU halfway
        fired = {"done": False, "bit": None}

        def seu(step, state):
            if step == steps // 2 and not fired["done"]:
                fired["done"] = True
                w = state.params["embed"]
                fired["bit"] = bit = top_exponent_bit(w.dtype)
                print(f"[faulty] injecting SEU (high-exponent bit flip in "
                      f"embed) at step {step}")
                # a new leaf: embed[0, 0] (flat index 0) with ``bit`` flipped
                corrupted = fi.flip_bit_at_index(w, 0, bit)
                return state._replace(
                    params=dict(state.params, embed=corrupted))
            return None

        ftc2 = ft_loop.FTConfig(ckpt_dir=str(root / "faulty"),
                                ckpt_every=every, loss_spike_factor=3.0)
        t0 = time.time()
        faulty = ft_loop.run(cfg, shape, ftc2, n_steps=steps,
                             fault_hook=seu, device=dev)
        dt_faulty = time.time() - t0
        print(f"[faulty] recoveries={faulty.recoveries} "
              f"steps_replayed={faulty.steps_replayed}")
        for e in faulty.events:
            print(f"[faulty] event: {e}")

        # ---- the dependability claim: recovery is exact
        same = None
        if faulty.recoveries:
            same = clean.losses == faulty.losses
            print(f"post-recovery loss curve bit-identical to fault-free "
                  f"run: {same}")
            assert same
        else:
            # flips landed in don't-care bits — still a pass for
            # dependability (benign faults must not trigger spurious
            # recovery)
            drift = max(abs(a - b)
                        for a, b in zip(clean.losses, faulty.losses))
            print(f"SEU was benign (max loss drift {drift:.2e}); no "
                  f"recovery needed")
    finally:
        shutil.rmtree(root)
    print("\ntrain_ft_e2e OK")
    return {"clean": clean.losses, "faulty": faulty.losses,
            "recoveries": faulty.recoveries,
            "steps_replayed": faulty.steps_replayed,
            "events": faulty.events, "same": same, "strike_bit": fired["bit"],
            "clean_s": dt, "faulty_s": dt_faulty,
            "executed": len(clean.losses) + len(faulty.losses)
            + faulty.steps_replayed + faulty.recoveries}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="SmolLM-135M in full, 12 steps of 8 x 1,024, a "
                         "checkpoint every 4")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args(argv)
    _, _, batch, seq = RUNS[args.full]
    shape = ShapeConfig("e2e", seq_len=args.seq or seq,
                        global_batch=args.batch or batch, kind="train")
    run(args.device, full=args.full, shape=shape, steps=args.steps)


if __name__ == "__main__":
    main()
