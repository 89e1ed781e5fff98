"""``ShardCtx``, and what the model families need to run on local shards.

The counterpart of ``repro.models.transformer.ShardCtx`` and of the GSPMD
partitioning that the reference leaves to XLA: the port is explicit SPMD.
Each rank holds its shards of the parameters as ``parallel.sharding.
param_specs`` lays them out (``shard_tree`` cuts them), its slice of the
batch over the activation-batch axes (``data.pipeline.shard_batch``), and
its slice of a decode cache as ``cache_specs`` says; the model code
gathers, slices and sums with the collectives of ``parallel.collectives``:

* a dimension sharded over dp axes (FSDP, ``cfg.fsdp_params``) is
  gathered just before its layer uses it and freed after (its backward
  reduce-scatters the gradient back to the shards);
* a dimension sharded over the model axis stays local where the layer runs
  tensor-parallel (heads, d_ff, experts, the vocabulary, the recurrent
  families' heads and widths), and is gathered where it runs replicated
  (attention whose heads the axis does not divide, an rwkv6 layer whose
  heads it does not divide, decode attention, and the head of the
  entries that return whole logits);
* the recurrent families run tensor-parallel where the model axis has
  more than one rank and divides the layer's heads or width
  (``Sharded.splits``): each rank runs its own heads (rwkv6) or its own
  channels of the recurrence (griffin) from its columns of the input
  projections, and the leaves the specs replicate but the local heads
  index (rwkv6's ``u``, ``ln_x``, ``w0`` and ``dec_B``'s output columns)
  are sliced after their gather (``Sharded.model_slice``), so that each
  gradient is a slice of the whole one, summed over the axis with the
  other replicated leaves';
* the vocabulary stays split over the model axis as the reference's specs
  lay it out (``embed: P(model, fsdp)``, ``lm_head: P(fsdp, model)``)
  wherever the axis is free for tensor parallelism and has more than one
  rank (``Sharded.vocab_split``): the embedding looks up the ids in this
  rank's rows, zero elsewhere, and sums over the axis (one nonzero term
  per position: exact); the loss's head is this rank's columns, and its
  cross-entropy (``cross_entropy``, ``common.vocab_parallel_cross_entropy``)
  makes the row max (MAX), the sum of exponentials and the gold logit
  (SUMs) global over the axis, so no rank holds a logit row whole;
* a row-parallel product (``wo``, ``wd``, the experts' combine, the shared
  experts' ``ws_o``, rwkv6's ``wo`` and ``cm_wv``, griffin's ``w_out``
  and ``mlp_o``) is summed over the model axis.  Under W8A8 the sum is
  exact: the per-row activation absmax is first made global (MAX), so that
  every rank quantizes with the unsharded scale, and the int32
  accumulators are summed (exact mod 2^32) before the rescale;
* under ``cfg.seq_shard`` a transformer's training ``forward`` keeps the
  stream between blocks on this rank's S/m rows, as the reference's
  ``seq_sp`` pins it (``Sharded.seq_split``): each block gathers its
  normed rows over the model axis before its column products and
  reduce-scatters its row-parallel sums back onto its rows
  (``Sharded.row_seq``), so that only S/m rows a rank are stored between
  blocks.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import _spec_for, entry_axes, rules_for


class ShardCtx(NamedTuple):
    """Mesh context threaded through model code.

    dp: tuple of data-parallel mesh axis names (("data",) or ("pod",
    "data")).  model: the tensor/expert-parallel axis name.  mesh: the
    ``launch.mesh.Mesh``.  batch: axes the *activation batch* shards over;
    None means ``dp``, ``()`` a batch replicated over dp (weights stay
    FSDP over ``dp``)."""
    mesh: Any
    dp: Tuple[str, ...] = ("data",)
    model: str = "model"
    batch: Any = None

    @property
    def batch_axes(self):
        """Activation-batch mesh axes; None (replicated) if empty."""
        b = self.dp if self.batch is None else self.batch
        return tuple(b) or None

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp)

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape[self.model])


def _mesh_order(mesh, axes) -> Tuple[str, ...]:
    axes = set(axes)
    return tuple(a for a in mesh.axis_names if a in axes)


class RowSum:
    """The sum of a row-parallel product over the model axis.  ``seq``: the
    sum is scattered over the sequence (dim 1 of a (B, S, N) product), so
    that each rank keeps its S/m rows of it (``Sharded.seq_split``'s
    layout), and ``rows`` slices a per-row factor to match."""

    def __init__(self, mesh, axis: str, seq: bool = False):
        self.mesh, self.axis, self.seq = mesh, axis, seq

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        return C.all_reduce(t, self.mesh, self.axis, op="max")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.seq:
            return C.reduce_scatter(t, self.mesh, self.axis, dim=1)
        return C.all_reduce(t, self.mesh, self.axis)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        if not self.seq:
            return t
        n = t.shape[1] // self.mesh.shape[self.axis]
        i = self.mesh.axis_index(self.axis)
        return t[:, i * n:(i + 1) * n]


class Sharded:
    """A model call's view of its ``ShardCtx``: the spec table of its
    parameters and the gathers and sums their layout needs."""

    def __init__(self, cfg, ctx: ShardCtx):
        self.cfg, self.ctx, self.mesh = cfg, ctx, ctx.mesh
        self.table = rules_for(cfg, ctx.dp, ctx.model, ctx.model_size)
        # the model axis is free for tensor parallelism (not folded into dp)
        self.tp = ctx.model not in ctx.dp
        self.msize = ctx.model_size if self.tp else 1
        self.row = RowSum(self.mesh, ctx.model) if self.tp else None
        # the same sums scattered over the sequence (``seq_split``)
        self.row_seq = RowSum(self.mesh, ctx.model, seq=True) \
            if self.tp else None
        # the vocabulary split over the model axis (its rows of the
        # embedding, its columns of the head and of the loss's logits)
        self.vocab_split = self.msize > 1 and \
            self.model_local("embed", 2) == 0

    # ---------------------------------------------------------- parameters
    def spec(self, name: str, ndim: int):
        return _spec_for(name, ndim, False, self.table)

    def gather(self, t: torch.Tensor, name: str,
               keep_model: bool = False) -> torch.Tensor:
        """The leaf ``name`` (one layer's) with each sharded dim gathered,
        but the one over the model axis when ``keep_model``."""
        for dim, e in enumerate(self.spec(name, t.dim())):
            axes = entry_axes(e)
            if axes and not (keep_model and axes == (self.ctx.model,)):
                t = C.all_gather(t, self.mesh, axes, dim=dim)
        return t

    def layer(self, bp: dict, keep_model: bool = False) -> dict:
        """One layer's leaves gathered whole for use, or with their model
        dims kept (``keep_model``: the layer runs tensor-parallel)."""
        return {k: self.gather(v, k, keep_model) for k, v in bp.items()}

    def splits(self, n: int) -> bool:
        """Whether the model axis runs tensor-parallel over more than one
        rank and divides ``n`` (a layer's heads or width)."""
        return self.msize > 1 and n % self.msize == 0

    def model_slice(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's 1/m of dim ``dim`` of a leaf that the specs
        replicate over the model axis (taken after its gather)."""
        n = t.shape[dim] // self.msize
        return t.narrow(dim, self.mesh.axis_index(self.ctx.model) * n, n)

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t``'s slices of dim ``dim`` gathered over the model axis."""
        return C.all_gather(t, self.mesh, self.ctx.model, dim=dim)

    def seq_split(self, S: int) -> bool:
        """Whether a training ``forward`` of S positions keeps the stream
        between blocks on this rank's S/m rows (``cfg.seq_shard``, the
        reference's ``seq_sp``): the model axis runs tensor-parallel over
        m > 1 ranks and m divides S."""
        return bool(self.cfg.seq_shard) and self.msize > 1 and \
            S % self.msize == 0

    def model_local(self, name: str, ndim: int) -> Optional[int]:
        """The dim of leaf ``name`` sharded over the model axis, if any."""
        for dim, e in enumerate(self.spec(name, ndim)):
            if self.tp and entry_axes(e) == (self.ctx.model,):
                return dim
        return None

    def vocab_lo(self, v_local: int) -> int:
        """The first vocabulary id of this rank's ``v_local`` rows."""
        return self.mesh.axis_index(self.ctx.model) * v_local

    def vocab_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The differentiable SUM of ``t`` over the vocabulary's shards."""
        return C.all_reduce(t, self.mesh, self.ctx.model)

    def vocab_max(self, t: torch.Tensor) -> torch.Tensor:
        """The MAX of ``t`` over the vocabulary's shards (no gradient)."""
        return C.all_reduce(t, self.mesh, self.ctx.model, op="max")

    # -------------------------------------------------------------- losses
    def pmean_all(self, t: torch.Tensor) -> torch.Tensor:
        """``pmean`` over dp + (model,), as the MoE's aux and z losses."""
        return C.all_mean(t, self.mesh, _mesh_order(
            self.mesh, self.ctx.dp + (self.ctx.model,)))

    # ------------------------------------------------------------- caches
    def cache_gather(self, t: torch.Tensor, spec) -> torch.Tensor:
        """A cache leaf with its non-batch dims gathered (the batch stays
        this rank's)."""
        for dim, e in enumerate(spec):
            axes = entry_axes(e)
            if axes and not set(axes) <= set(self.ctx.dp):
                t = C.all_gather(t, self.mesh, axes, dim=dim)
        return t

    def cache_slice(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's slice of the non-batch dims of a cache leaf computed
        whole (``cache_gather``'s inverse)."""
        for dim, e in enumerate(spec):
            axes = entry_axes(e)
            if axes and not set(axes) <= set(self.ctx.dp):
                n = t.shape[dim] // self.mesh.size(axes)
                i = self.mesh.index(axes)
                t = t.narrow(dim, i * n, n)
        return t

    def _cache_specs(self):
        from repro_torch.parallel.sharding import cache_specs
        return cache_specs(self.cfg, self.ctx.dp,
                           self.ctx.model if self.tp else None)

    def local_cache_specs(self):
        """The specs of the cache this rank holds: ``cache_specs``'s, with
        the batch entries over the activation batch's axes (None where the
        batch is replicated)."""
        from repro_torch.parallel.sharding import P
        dp = set(self.ctx.dp)
        return type(self._cache_specs())(*[
            None if spec is None else P(*[
                self.ctx.batch_axes if entry_axes(e) and
                set(entry_axes(e)) <= dp else e for e in spec])
            for spec in self._cache_specs()])

    def on_full_cache(self, cache, fn):
        """``fn(full)`` on the cache with its non-batch dims gathered,
        which returns (out, full) having updated ``full`` in place; this
        rank's slices of it are then written back into ``cache``.
        Returns (out, cache)."""
        specs = self._cache_specs()
        full = type(cache)(*[None if c is None else self.cache_gather(c, s)
                             for c, s in zip(cache, specs)])
        out, full = fn(full)
        for c, f, s in zip(cache, full, specs):
            if c is not None and f is not c:
                c.copy_(self.cache_slice(f, s))
        return out, cache

    def local_cache(self, cache):
        """This rank's slices of a cache computed whole for its batch."""
        return type(cache)(*[
            None if c is None else self.cache_slice(c, s).contiguous()
            for c, s in zip(cache, self._cache_specs())])


def cross_entropy(sh: Optional[Sharded], logits, labels, mask=None):
    """The batch's mean next-token CE (``common.cross_entropy_loss``);
    under ``sh`` the global batch's, from this rank's rows.  Where
    ``sh.vocab_split``, ``logits`` are this rank's columns of the
    vocabulary (the models' ``forward(..., vocab_local=True)``) and the
    loss is ``common.vocab_parallel_cross_entropy`` over the model axis:
    every model rank gets the same loss, and its logits' gradient is the
    softmax minus the one-hot of its own columns."""
    from repro_torch.models import common
    psum, n = None, 1
    if sh is not None and sh.ctx.batch_axes is not None:
        axes = sh.ctx.batch_axes
        psum, n = (lambda t: C.all_reduce(t, sh.mesh, axes)), \
            sh.mesh.size(axes)
    if sh is not None and sh.vocab_split:
        return common.vocab_parallel_cross_entropy(
            logits, labels, sh.vocab_lo(logits.shape[-1]), sh.vocab_max,
            sh.vocab_sum, mask, psum=psum, n_shards=n)
    return common.cross_entropy_loss(logits, labels, mask, psum=psum,
                                     n_shards=n)


def sharded(cfg, ctx: Optional[ShardCtx]) -> Optional[Sharded]:
    return None if ctx is None else Sharded(cfg, ctx)
