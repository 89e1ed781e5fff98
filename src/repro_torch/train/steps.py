"""Train / serve step builders, and the train state's sharding specs.

The counterpart of ``repro.train.steps``.  ``make_train_step(cfg, ctx)``
returns a (state, batch) → (state, metrics) function: ``torch.autograd.
grad`` of ``models.api.loss_fn`` takes the place of ``jax.value_and_grad``,
a Python loop over ``cfg.grad_accum`` microbatches the reference's
``lax.scan`` (gradients accumulated in f32), then the global-norm clip and
the optimizer update.  The step takes the state as the reference's jitted
step takes a donated one: it clips its gradients in place and writes the
new parameters and optimizer state into the given state's tensors
(``Optimizer.apply_``, bit for bit the functional ``Optimizer.update``),
so that no second copy of a state is ever held and a model whose
parameters, gradients and optimizer state fill most of the card trains on
one.  It returns a ``TrainState`` of those tensors and a new step counter.
A caller that keeps a state (to replay from it, or to compare two runs)
clones it first: ``tree.map(torch.clone, state)``.

Under a ``ShardCtx`` the state is this rank's shards (``train_state_specs``,
``parallel.sharding.shard_tree``) and the batch its slice
(``data.pipeline.shard_batch``).  Each rank's backward, seeded with
1 / world, gives the partial derivative of the loss with respect to its
own copy of every value (``parallel.collectives``): an FSDP dimension's
gradient comes back reduce-scattered to its shard through its gather, and
a leaf's gradient is then summed over the mesh axes its spec does not name
(the ranks that hold copies of it).  The f32 accumulators of
``grad_accum`` keep the parameters' layout (the reference's ``pin``); the
global norm counts each element once; the update runs on the local shards
in place, Adafactor's means over a sharded dim taken over the whole
parameter.

``input_specs`` and ``abstract_train_state`` give a cell's inputs and
train state as meta tensors of the reference's shapes and dtypes: no
memory, nothing drawn (``launch.dryrun`` runs the steps on them).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device, tree
from repro_torch.models import api as model_api
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.shard import ShardCtx
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P, entry_axes
from repro_torch.train import optim as optim_mod


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor          # () int32, on the parameters' device


def init_train_state(cfg: ArchConfig, gen: torch.Generator,
                     optimizer: Optional[optim_mod.Optimizer] = None, *,
                     device="cuda") -> TrainState:
    optimizer = optimizer or optim_mod.make_optimizer(cfg.optimizer)
    dev = resolve_device(device)
    params = model_api.init_params(cfg, gen, device=dev)
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Sharding derivation
# ---------------------------------------------------------------------------


def _opt_state_specs(pspecs, params, opt_name: str):
    """Optimizer state specs follow the parameter specs (Adafactor's
    factored moments drop a dim: ``vr`` the last, ``vc`` the one before),
    the factored/unfactored split decided from the parameter leaf as
    ``optim.adafactor`` decides it (``ndim >= 2``)."""
    if opt_name == "adamw":
        return {"m": pspecs, "v": pspecs}
    if opt_name == "sgdm":
        return {"m": pspecs}

    def fac(spec: P, p):
        parts = tuple(spec) + (None,) * (p.ndim - len(spec))
        if p.ndim >= 2:
            return {"vr": P(*parts[:-1]), "vc": P(*(parts[:-2] + parts[-1:]))}
        return {"v": P(*parts)}

    return tree.unflatten(tree.structure(params),
                          [fac(s, p) for s, p in zip(tree.leaves(pspecs),
                                                     tree.leaves(params))])


def train_state_specs(cfg: ArchConfig, params, dp, mdl, opt_name: str,
                      mesh=None):
    pspecs = shd.param_specs(cfg, params, dp, mdl, mesh=mesh)
    return TrainState(pspecs, _opt_state_specs(pspecs, params, opt_name),
                      P())


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def _grad_fn(cfg: ArchConfig, ctx: Optional[ShardCtx]):
    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        live = tree.unflatten(tree.structure(params), leaves)
        loss, metrics = model_api.loss_fn(cfg, live, batch, ctx)
        seed = None
        if ctx is not None:
            seed = torch.full_like(loss, 1.0 / ctx.mesh.size(
                ctx.mesh.axis_names))
        grads = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                    allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree.unflatten(tree.structure(params),
                                                      list(grads))
    return grad_fn


def _sum_copies(grads, specs, mesh):
    """Each leaf's gradient summed over the mesh axes its spec does not
    name: the ranks that hold copies of it, each with its own partial.
    The sums are taken in place (the gradients are the step's own)."""
    out = []
    for g, spec in zip(tree.leaves(grads), tree.leaves(specs)):
        named = {a for e in spec for a in entry_axes(e)}
        axes = tuple(a for a in mesh.axis_names if a not in named)
        out.append(C.all_reduce_(g.contiguous(), mesh, axes) if axes else g)
    return tree.unflatten(tree.structure(grads), out)


def make_train_step(cfg: ArchConfig, ctx: Optional[ShardCtx] = None,
                    optimizer: Optional[optim_mod.Optimizer] = None,
                    grad_clip: float = 1.0):
    optimizer = optimizer or optim_mod.make_optimizer(cfg.optimizer)
    n_micro = max(cfg.grad_accum, 1)
    grad_fn = _grad_fn(cfg, ctx)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if n_micro == 1:
            loss, metrics, grads = grad_fn(state.params, batch)
        else:
            # microbatched gradient accumulation: activation memory scales
            # with B/n_micro while the optimizer still sees the full-batch
            # gradient; gradients accumulate in f32 whatever the compute
            # dtype, in the parameters' (local) layout
            micro = {k: v.chunk(n_micro) for k, v in batch.items()}
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(n_micro):
                mb = {k: v[i] for k, v in micro.items()}
                l_i, metrics, g = grad_fn(state.params, mb)
                grads = tree.map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
                loss = loss + l_i
            grads = tree.map(lambda g: g / n_micro, grads)
            loss = loss / n_micro
        if ctx is None:
            gnorm = optim_mod.clip_by_global_norm_(grads, grad_clip)
            optimizer.apply_(grads, state.opt_state, state.params,
                             state.step)
        else:
            shard = (shd.param_specs(cfg, state.params, ctx.dp, ctx.model,
                                     mesh=ctx.mesh), ctx.mesh)
            grads = _sum_copies(grads, *shard)
            gnorm = optim_mod.clip_by_global_norm_(grads, grad_clip, shard)
            optimizer.apply_(grads, state.opt_state, state.params,
                             state.step, shard=shard)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(state.params, state.opt_state,
                          state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ArchConfig, ctx: Optional[ShardCtx] = None):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model_api.loss_fn(cfg, params, batch, ctx)
        return metrics
    return eval_step


def make_prefill_step(cfg: ArchConfig, max_len: int,
                      ctx: Optional[ShardCtx] = None):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache = model_api.prefill(
                cfg, params, batch.get("tokens"), max_len, ctx,
                embeds=batch.get("embeds"))
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx: Optional[ShardCtx] = None):
    def decode_step(params, token, cache):
        with torch.no_grad():
            logits, cache = model_api.decode_step(cfg, params, token, cache,
                                                  ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return decode_step


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors for the dry-run; no memory, nothing drawn)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta inputs of one (arch × shape) cell, the global batch.

    train/prefill: int32 tokens (B, S) (and labels for train); embedding-
    input archs also get f32 ``embeds`` (B, S, d) (their stub front end).
    decode: one int32 token per row and the cache at seq_len
    (``models.api.init_cache`` on meta)."""
    B, S = shape.global_batch, shape.seq_len

    def tok():
        return torch.empty((B, S), dtype=torch.int32, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": tok()}
        if shape.kind == "train":
            batch["labels"] = tok()
        if cfg.input_mode == "embeddings":
            batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                          dtype=torch.float32, device="meta")
        return batch
    if shape.kind == "decode":
        return {"token": torch.empty((B,), dtype=torch.int32, device="meta"),
                "cache": model_api.init_cache(cfg, B, S, device="meta")}
    raise ValueError(shape.kind)


def abstract_train_state(cfg: ArchConfig,
                         optimizer: Optional[optim_mod.Optimizer] = None
                         ) -> TrainState:
    """The train state of ``init_train_state`` as meta tensors: every leaf
    built shape-only (``models.common._normal`` with no generator), the
    W8A8 leaves quantized on meta, so a 1T-parameter state takes no
    memory."""
    optimizer = optimizer or optim_mod.make_optimizer(cfg.optimizer)
    with torch.device("meta"):
        return init_train_state(cfg, None, optimizer, device="meta")
