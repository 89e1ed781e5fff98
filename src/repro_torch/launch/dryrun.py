"""Multi-pod dry-run: every (arch × shape × mesh) cell as one rank of the
production mesh, on the meta device.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for 256 or 512 fake devices and reads the compiled
program.  The port compiles nothing: it runs its own steps
(``train.steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step``) as rank 0 of a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once), on meta tensors of this rank's shards, under the reference's
``ShardCtx`` rules (the ``layout == "dp"`` merge of the model axis into
dp; a replicated activation batch where it does not divide the dp axes;
the specs of ``train_state_specs`` / ``param_specs`` / the model's cache
layout), inside ``launch.op_analysis``.  No memory is used and nothing is
drawn (``train.steps.abstract_train_state``, ``input_specs``); the kernel
wrappers' meta path allocates what their launches would.

The record keeps the reference's keys where their meaning carries over,
with ``"op_analysis"`` in place of ``"hlo_analysis"`` (no HLO is made) and
``build_s`` / ``run_s`` in place of the lower and compile seconds; its
``memory_analysis`` holds live-storage peaks per rank (``op_analysis``).
Artifacts go to ``reports/dryrun_torch/<cell>.json``.

The default process group is global: each mesh's fake group lives in
``fake_process_group``, which refuses to start beside another group and
destroys its own at the end; a caller that holds a real group runs
``run_cells`` in a spawned child.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --jobs 6
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --mesh 2,4 --set quant=w8a8_ffn --set attn_impl=flash
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llava-next-34b \\
      --shape train_4k --mesh 1,1 --batch 1 --set n_layers=7 \\
      --set attn_impl=flash
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_analysis
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig, \
    valid_cells
from repro_torch.models.shard import ShardCtx, sharded
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P
from repro_torch.train import optim as optim_mod
from repro_torch.train import steps as steps_mod

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
PRODUCTION = {"pod16x16": ((16, 16), ("data", "model")),
              "2pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0):
    """A fake default process group of ``world`` ranks, this process rank
    ``rank``, for the block; destroyed at its end."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised: "
                           "run the dry-run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_ctx(cfg: ArchConfig, shape: ShapeConfig, mesh) -> ShardCtx:
    """The reference's ``build_cell`` rules: dp is the pod and data axes
    (and the model axis under ``layout == "dp"``); the activation batch
    shards over dp only where the global batch divides it."""
    dp = mesh_mod.dp_axes(mesh)
    if cfg.layout == "dp":
        if cfg.moe is not None:
            raise ValueError("layout=dp is for non-MoE archs")
        dp = dp + ("model",)
    bax = dp if shape.global_batch % mesh.size(dp) == 0 else ()
    return ShardCtx(mesh, dp, "model", batch=bax)


def _batch_specs(ctx: ShardCtx, batch):
    return {k: P(ctx.batch_axes, *([None] * (v.ndim - 1)))
            for k, v in batch.items()}


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               state: Any = None, params: Any = None, batch: Any = None,
               device=None) -> Tuple[Any, tuple]:
    """(step, args): the cell's step function and this rank's inputs.

    By default the inputs are abstract (meta tensors of this rank's
    shards).  ``state`` (train) or ``params`` (prefill, decode) and
    ``batch`` give real full trees instead (host or card tensors), cut
    into this rank's shards on ``device`` (the mesh's by default): the
    same step on real data, for holding a dry-run against a run."""
    device = mesh.device if device is None else torch.device(device)
    ctx = shard_ctx(cfg, shape, mesh)
    dp = ctx.dp
    batch = dict(steps_mod.input_specs(cfg, shape) if batch is None
                 else batch)
    cache = batch.pop("cache", None)

    def local_batch(b):
        return shd.shard_tree(b, _batch_specs(ctx, b), mesh, device=device)

    if shape.kind == "train":
        opt = optim_mod.make_optimizer(cfg.optimizer)
        if state is None:
            state = steps_mod.abstract_train_state(cfg, opt)
        specs = steps_mod.train_state_specs(cfg, state.params, dp, "model",
                                            cfg.optimizer, mesh=mesh)
        local = shd.shard_tree(state, specs, mesh, device=device)
        step = steps_mod.make_train_step(cfg, ctx, opt)
        return step, (local, local_batch(batch))
    if params is None:
        params = steps_mod.abstract_train_state(cfg).params
    local = shd.shard_tree(params, shd.param_specs(cfg, params, dp, "model",
                                                   mesh=mesh),
                           mesh, device=device)
    if shape.kind == "prefill":
        step = steps_mod.make_prefill_step(cfg, max_len=shape.seq_len,
                                           ctx=ctx)
        return step, (local, local_batch(batch))
    if shape.kind != "decode":
        raise ValueError(shape.kind)
    tok = local_batch({"token": batch["token"]})["token"]
    cache = shd.shard_tree(cache, sharded(cfg, ctx).local_cache_specs(),
                           mesh, device=device)
    return steps_mod.make_decode_step(cfg, ctx), (local, tok, cache)


def _mesh_label(shape: Sequence[int]) -> str:
    return "x".join(map(str, shape))


def run_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, mesh_label: str,
             out_dir: Optional[Path] = ARTIFACT_DIR, verbose: bool = True,
             tag: str = "") -> dict:
    """Build the cell on meta, run its step under ``op_analysis`` and
    write ``<out_dir>/<cell>.json`` (none when ``out_dir`` is None)."""
    cell = f"{cfg.name}__{shape.name}__{mesh_label}" + (f"__{tag}" if tag
                                                         else "")
    t0 = time.perf_counter()
    fn, args = build_cell(cfg, shape, mesh)
    t_build = time.perf_counter() - t0
    _, an = op_analysis.analyze(fn, *args)
    t_run = time.perf_counter() - t0 - t_build
    summary = an.summary()
    record = {
        "cell": cell, "arch": cfg.name, "shape": shape.name,
        "kind": shape.kind, "mesh": mesh_label, "tag": tag,
        "n_devices": dist.get_world_size(),
        "build_s": t_build, "run_s": t_run,
        "memory_analysis": an.memory_analysis(),
        "op_analysis": summary,
        "collective_bytes": summary["collective_bytes"],
        "collective_counts": summary["collective_counts"],
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell}.json").write_text(json.dumps(record, indent=1))
    if verbose:
        ma = record["memory_analysis"]
        print(f"[OK] {cell}: build {t_build:.1f}s run {t_run:.1f}s | args "
              f"{ma['argument_size_in_bytes'] / 2**30:.2f} GiB/dev peak "
              f"{ma['peak_bytes'] / 2**30:.2f} GiB/dev | flops/dev "
              f"{summary['flops']:.3e} | coll "
              f"{summary['total_collective_bytes'] / 2**30:.3f} GiB/dev")
        sys.stdout.flush()
    return record


def run_cell_fake(cfg: ArchConfig, shape: ShapeConfig,
                  mesh_shape: Sequence[int], axes: Sequence[str] = None,
                  label: Optional[str] = None, out_dir=None,
                  verbose: bool = False, tag: str = "") -> dict:
    """``run_cell`` on a mesh of ``mesh_shape`` as rank 0 of its own fake
    process group."""
    with fake_process_group(math.prod(mesh_shape)):
        mesh = mesh_mod.make_mesh(mesh_shape, axes, device="meta")
        return run_cell(cfg, shape, mesh, label or _mesh_label(mesh_shape),
                        out_dir, verbose, tag)


def run_cells(cells) -> list:
    """``run_cell_fake(*cell)`` for each cell: the records.  A caller that
    holds a process group runs this in a spawned child (a
    ``ProcessPoolExecutor`` with the "spawn" context), whose groups never
    meet its own."""
    return [run_cell_fake(*c) for c in cells]


def _overrides(cells, sets):
    fields = {f.name: f for f in dataclasses.fields(ArchConfig)}
    overrides = {}
    for kv in sets:
        k, v = kv.split("=", 1)
        fld = fields[k]
        if fld.type in ("bool", bool):
            v = v.lower() in ("1", "true", "yes")
        elif fld.type in ("int", int):
            v = int(v)
        elif fld.type in ("float", float):
            v = float(v)
        overrides[k] = v
    return [(dataclasses.replace(c, **overrides), s) for c, s in cells]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mesh", type=str, default=None,
                    help="another mesh shape, e.g. '2,4' or '2,2,2'")
    ap.add_argument("--out", type=str, default=str(ARTIFACT_DIR))
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VAL",
                    help="ArchConfig override, e.g. --set remat=none "
                         "--set quant=w8a8_ffn")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows of the global batch in place of the "
                         "shape's (the shape's name gets _b<rows>)")
    ap.add_argument("--tag", type=str, default="",
                    help="artifact suffix for variant runs")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a spawned child")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        meshes.append((shape, None, _mesh_label(shape)))
    else:
        if args.multi_pod in ("single", "both"):
            meshes.append((*PRODUCTION["pod16x16"], "pod16x16"))
        if args.multi_pod in ("multi", "both"):
            meshes.append((*PRODUCTION["2pod2x16x16"], "2pod2x16x16"))
    if args.all:
        cells = registry.all_cells()
    else:
        cfg = registry.get(args.arch)
        shapes = [SHAPES[args.shape]] if args.shape else valid_cells(cfg)
        cells = [(cfg, s) for s in shapes]
    if args.set:
        cells = _overrides(cells, args.set)
    if args.batch:
        cells = [(c, dataclasses.replace(s, name=f"{s.name}_b{args.batch}",
                                         global_batch=args.batch))
                 for c, s in cells]

    tasks = [(cfg, shape, mshape, axes, label, Path(args.out), True,
              args.tag) for mshape, axes, label in meshes
             for cfg, shape in cells]
    failures = []
    with (concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
          if args.jobs > 1 else contextlib.nullcontext()) as pool:
        runs = [pool.submit(run_cell_fake, *t) if pool else None
                for t in tasks]
        for task, fut in zip(tasks, runs):
            cfg, shape, _, _, label = task[:5]
            try:
                fut.result() if fut else run_cell_fake(*task)
            except Exception as e:  # noqa: BLE001 — report every cell
                failures.append((cfg.name, shape.name, label, repr(e)))
                print(f"[FAIL] {cfg.name}__{shape.name}__{label}: {e}")
                traceback.print_exc()
            sys.stdout.flush()
    print(f"\n{len(tasks) - len(failures)} passed, {len(failures)} failed")
    if failures:
        for f in failures:
            print("  FAIL:", *f)
        sys.exit(1)


if __name__ == "__main__":
    main()
