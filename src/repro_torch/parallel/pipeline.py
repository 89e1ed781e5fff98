"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis.

The counterpart of ``repro.parallel.pipeline``: each rank of the
``"stage"`` axis owns one stage's parameters, activations hop from stage i
to stage i + 1 with ``parallel.collectives.ppermute`` (never through the
host), and microbatches keep every stage busy.

The schedule is the reference's fill/steady/drain loop, tick for tick:
``n_micro + n_stages - 1`` ticks; on each, stage 0 takes microbatch
``min(t, n_micro - 1)``, every stage runs ``stage_fn`` (bubble ticks
included, so that each rank does the reference's work), the last stage
keeps microbatch ``t - (n_stages - 1)`` once ``t >= n_stages - 1``, and
the live activation hops to the next stage.  The other stages' outputs are
zeros and the outputs are summed over the axis (the reference's ``where``
and ``psum``), so every rank returns them.

Backward.  The reference's autodiff transposes the whole SPMD program; here
each rank's autograd graph is its own, and a hop's backward is a send and
a receive that its neighbours must meet.  So every hop's output is tied to
the result (``_Tie``, whose backward gives those outputs zero gradient),
and every rank runs the backward of every hop, the last tick first: a
stage that discards what it receives (stage 0) still takes its gradient
back from the next stage.  Seed each rank's backward with 1 / world, as
``train.steps`` does: the sum's adjoint is a sum, so each stage's gradient
is then the sequential gradient, not n_stages times it.
``checkpoint_stages`` recomputes ``stage_fn`` in the backward
(``torch.utils.checkpoint``); the recompute issues no hop.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.parallel import collectives as C


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule: (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stack_stage_params(param_list: Sequence[Any]):
    """Stack per-stage parameter trees along a new leading stage dim."""
    return tree.map(lambda *xs: torch.stack(xs), *param_list)


class _Tie(torch.autograd.Function):
    """``out`` unchanged, made to depend on ``hops`` so that the backward
    reaches every hop (with a zero gradient from here)."""

    @staticmethod
    def forward(ctx, out, *hops):
        ctx.hops = [(h.shape, h.dtype, h.device) for h in hops]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.hops))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, mesh,
                   axis: str = "stage",
                   checkpoint_stages: bool = True) -> torch.Tensor:
    """Run ``microbatches`` (n_micro, mb, ...) through the stages of mesh
    axis ``axis``.

    stage_fn: (one stage's params, activation (mb, ...)) -> activation of
    the same shape.  stage_params: this rank's slice of the stacked tree,
    a leading stage dim of one (``parallel.sharding.shard_tree`` with
    ``P(axis)``, the reference's ``in_specs``).  microbatches: the same on
    every rank (stage 0 is the only consumer).  Returns the (n_micro, mb,
    ...) outputs on every rank.
    """
    n_stages = mesh.size(axis)
    n_micro = microbatches.shape[0]
    stage = mesh.axis_index(axis)
    params = tree.map(lambda x: x[0], stage_params)
    fn = stage_fn
    if checkpoint_stages:
        def fn(p, x):
            return torch.utils.checkpoint.checkpoint(stage_fn, p, x,
                                                     use_reentrant=False)
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    state = torch.zeros_like(microbatches[0])
    outs, hops = [], []
    for t in range(n_micro + n_stages - 1):
        if stage == 0:
            state = microbatches[min(t, n_micro - 1)]
        state = fn(params, state)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs.append(state)
        state = C.ppermute(state, mesh, axis, perm)
        hops.append(state)
    out = torch.stack(outs) if outs else torch.zeros_like(microbatches)
    out = _Tie.apply(out, *hops)
    return C.all_reduce(out, mesh, axis)


def pipeline_loss(stage_fn, stage_params, microbatches, targets_fn, mesh,
                  axis: str = "stage"):
    """``targets_fn`` of the pipeline's outputs (e.g. their mean loss),
    differentiable through the pipeline."""
    out = pipeline_apply(stage_fn, stage_params, microbatches, mesh, axis)
    return targets_fn(out)
