"""Train and eval step builders.

The counterpart of the single-device part of ``repro.train.steps``.
``make_train_step`` returns a (state, batch) → (state, metrics) function:
``torch.autograd.grad`` of ``models.api.loss_fn`` takes the place of
``jax.value_and_grad``, a Python loop over ``cfg.grad_accum`` microbatches
the reference's ``lax.scan`` (gradients accumulated in f32), then the
global-norm clip and the optimizer update.  The step takes the state as
the reference's jitted step takes a donated one: it clips its gradients in
place and writes the new parameters and optimizer state into the given
state's tensors (``Optimizer.apply_``, bit for bit the functional
``Optimizer.update``), so that no second copy of a state is ever held and a
model whose parameters, gradients and optimizer state fill most of the card
trains on one.  It returns a ``TrainState`` of those tensors and a new step
counter.  A caller that keeps a state (to replay from it, or to compare two
runs) clones it first: ``tree.map(torch.clone, state)``.  The sharding
specs, ``input_specs`` and ``abstract_train_state`` come with parallelism
(ROADMAP.md queue 1, item 17).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device, tree
from repro_torch.models import api as model_api
from repro_torch.models.config import ArchConfig
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


def _grad_fn(cfg: ArchConfig):
    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        live = tree.unflatten(tree.structure(params), leaves)
        loss, metrics = model_api.loss_fn(cfg, live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree.unflatten(tree.structure(params),
                                                      list(grads))
    return grad_fn


def make_train_step(cfg: ArchConfig,
                    optimizer: Optional[optim_mod.Optimizer] = None,
                    grad_clip: float = 1.0):
    optimizer = optimizer or optim_mod.make_optimizer(cfg.optimizer)
    n_micro = max(cfg.grad_accum, 1)
    grad_fn = _grad_fn(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if n_micro == 1:
            loss, metrics, grads = grad_fn(state.params, batch)
        else:
            # microbatched gradient accumulation: activation memory scales
            # with B/n_micro while the optimizer still sees the full-batch
            # gradient; gradients accumulate in f32 whatever the compute
            # dtype
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
        gnorm = optim_mod.clip_by_global_norm_(grads, grad_clip)
        optimizer.apply_(grads, state.opt_state, state.params, state.step)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(state.params, state.opt_state,
                          state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ArchConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model_api.loss_fn(cfg, params, batch)
        return metrics
    return eval_step
