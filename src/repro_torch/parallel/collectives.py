"""Collectives over a mesh's process groups.

The counterpart of ``repro.parallel.collectives`` (``ring_all_gather``,
``reduce_scatter``, ``all_to_all_tokens``, ``grad_allreduce_bf16``) and the
primitives that the port's sharded code issues in place of the reference's
``psum``, ``pmax``, ``all_gather`` and ``psum_scatter``.  Every function
takes a ``launch.mesh.Mesh`` and a mesh axis name or a tuple of them; an
empty tuple (or ``None``) names no axis, and the tensor passes through
untouched.

``all_reduce`` (sum), ``all_gather`` and ``reduce_scatter`` are
differentiable, each backward the exact adjoint of its forward: the sum's
is a sum, the gather's a reduce-scatter, the reduce-scatter's a gather.
With that rule every rank's backward gives the partial derivative of the
loss with respect to its own copy of each value, so the train step
(``train.steps``) seeds each rank with 1 / world and sums a replicated
leaf's gradient over the axes its spec does not name (the reference's
shard_map transposes ``psum`` the same way).

``ppermute`` is JAX's ``lax.ppermute`` over one axis: each rank sends its
tensor to the ranks the permutation names and returns what it receives
(zeros where nothing comes); its backward is the reverse permutation.

Every call that reaches ``torch.distributed`` adds one to ``COUNTS[kind]``
(kinds ``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``,
``send_recv``) and its operand bytes (the tensor this rank puts in) to
``BYTES[kind]``, in a backward too: ``chip_smoke.py`` derives the count of
each kind from the code's rules and holds the run to it, and
``launch.op_analysis`` reads both.
"""
from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

from repro_torch import tree

COUNTS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "send_recv")


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()


def _count(kind: str, operand: torch.Tensor) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += operand.numel() * operand.element_size()


def counts() -> dict:
    return {k: COUNTS[k] for k in KINDS}


def byte_counts() -> dict:
    return {k: BYTES[k] for k in KINDS}


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


SETTLE_S = 10.0            # the longest _settle waits for gloo's worker


def _uses(t: torch.Tensor) -> int:
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


def _issue(fn, *tensors, **kw) -> None:
    """``fn(*tensors, **kw)``, one collective, given views of ``tensors``
    of its own; on the host (gloo) it returns only once the process
    group has let go of them.  Gloo's worker thread keeps a finished work
    item, and the operands in it, until it takes up the next one, a moment
    after ``wait`` has returned: an operand the caller drops at once would
    be freed whenever that thread gets to run, and a step's tracked peak
    (``launch.op_analysis``) would hang on the thread's scheduling."""
    if tensors[0].device.type != "cpu":
        fn(*tensors, **kw)
        return
    uses = [_uses(t) for t in tensors]
    fn(*[t.view(t.shape) for t in tensors], **kw)
    _settle(tensors, uses)


def _p2p(sends, recvs, group) -> None:
    """Each (tensor, global rank) of ``sends`` sent and of ``recvs``
    received, as one batch of point-to-point ops; on the host it returns
    once gloo has let go of the tensors, as ``_issue`` does."""
    tensors = [t for t, _ in sends + recvs]
    cpu = tensors[0].device.type == "cpu"
    uses = [_uses(t) for t in tensors] if cpu else None
    own = (lambda t: t.view(t.shape)) if cpu else (lambda t: t)
    ops = [dist.P2POp(dist.isend, own(t), r, group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, own(t), r, group) for t, r in recvs]
    reqs = dist.batch_isend_irecv(ops)
    for req in reqs:
        req.wait()
    del ops, reqs, req
    if cpu:
        _settle(tensors, uses)


def _settle(tensors, uses) -> None:
    """Wait until each of ``tensors``' storages is down to its use count
    in ``uses`` (at most SETTLE_S in all)."""
    end = time.monotonic() + SETTLE_S
    for t, n in zip(tensors, uses):
        while _uses(t) > n and time.monotonic() < end:
            time.sleep(1e-4)       # the worker needs the core, not a spin


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _all_reduce_raw(x: torch.Tensor, group, op: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out)
    _issue(dist.all_reduce, out, op=_OPS[op], group=group)
    return out


def _gather_raw(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """Concatenate the group's tensors along ``dim``, in group rank order,
    into a tensor with the default strides, as the unsharded tensor is: a
    strided operand can take another kernel (and another order of sums)
    than a dense one.  The shards are gathered stacked on a new leading
    dim and joined along ``dim`` by one copy (none for dim 0 or one rank),
    never by transposes."""
    src = x.contiguous()
    flat = src.new_empty(size * src.numel())     # rank-major, as gloo wants
    _count("all_gather", src)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    _issue(fn, flat, src.reshape(-1), group=group)
    out = flat.view((size,) + src.shape)
    if size == 1:
        return out[0]
    if dim == 0:
        return out.reshape((size * src.shape[0],) + src.shape[1:])
    return torch.cat(out.unbind(0), dim=dim)


def _scatter_raw(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """Sum over the group, each rank keeping its 1/size slice of ``dim``
    (default strides; the slices stacked by one copy unless dim is 0 or
    the group one rank)."""
    if x.shape[dim] % size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {size} ways")
    parts = x.chunk(size, dim=dim)
    src = x.contiguous() if dim == 0 or size == 1 else torch.stack(parts)
    out = x.new_empty(parts[0].shape)
    _count("reduce_scatter", src)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    _issue(fn, out.view(-1), src.reshape(-1), op=dist.ReduceOp.SUM,
           group=group)
    return out


def all_reduce_(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``all_reduce`` into ``x`` itself, outside autograd: no copy of ``x``
    is made (a train step's gradients, summed where they are replicated,
    would otherwise be held twice at the step's peak); returns ``x``."""
    axes = _axes(axes)
    if not axes:
        return x
    _count("all_reduce", x)
    _issue(dist.all_reduce, x, op=_OPS[op], group=mesh.group(axes))
    return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_raw(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group, "sum"), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.args = (group, size, dim)
        return _gather_raw(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_raw(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.args = (group, size, dim)
        return _scatter_raw(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, *ctx.args), None, None, None


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``psum`` (``op="sum"``, differentiable), ``pmax`` or ``pmin`` of
    ``x`` over ``axes``; a new tensor, ``x`` untouched."""
    axes = _axes(axes)
    if not axes:
        return x
    group = mesh.group(axes)
    if op == "sum":
        return _AllReduce.apply(x, group)
    return _all_reduce_raw(x.detach(), group, op)


def all_mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``pmean``: the sum over ``axes`` divided by their size (exact when
    the size is one)."""
    axes = _axes(axes)
    if not axes:
        return x
    return all_reduce(x, mesh, axes) / mesh.size(axes)


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Tiled ``all_gather``: the group's shards concatenated along ``dim``
    in mesh order (the first axis of a tuple major)."""
    axes = _axes(axes)
    if not axes:
        return x
    return _AllGather.apply(x, mesh.group(axes), mesh.size(axes), dim)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``psum_scatter(..., tiled=True)``: the sum over ``axes``, each rank
    keeping its slice of ``dim`` (bandwidth-optimal gradient reduction)."""
    axes = _axes(axes)
    if not axes:
        return x
    return _ReduceScatter.apply(x, mesh.group(axes), mesh.size(axes), dim)


def ring_all_gather(x: torch.Tensor, mesh, axes, dim: int = 0
                    ) -> torch.Tensor:
    """All-gather by N−1 neighbour hops (``batch_isend_irecv``), the chunks
    then put in source-rank order: the overlappable ring schedule.  Not
    differentiable."""
    axes = _axes(axes)
    n = mesh.size(axes)
    if n == 1:
        return x
    group = mesh.group(axes)
    ranks = dist.get_process_group_ranks(group)
    idx = dist.get_rank(group)
    nxt, prv = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    cur = x.detach().contiguous()
    chunks = [cur]
    for _ in range(n - 1):
        recv = torch.empty_like(cur)
        _count("send_recv", cur)
        _p2p([(cur, nxt)], [(recv, prv)], group)
        chunks.append(recv)
        cur = recv
    # chunk j came from group rank (idx − j) mod n
    ordered = [chunks[(idx - src) % n] for src in range(n)]
    return torch.cat(ordered, dim=dim)


def _ppermute_raw(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``x`` sent to every rank of ``axis`` that ``perm`` names as this
    rank's destination; what this rank receives, or zeros (default
    strides either way)."""
    me = mesh.axis_index(axis)
    dests = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if not dests and not srcs:
        return out
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    src = x.detach().contiguous()
    _count("send_recv", src)
    _p2p([(src, ranks[d]) for d in dests], [(out, ranks[s]) for s in srcs],
         group)
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _ppermute_raw(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        back = tuple((d, s) for s, d in perm)
        return _ppermute_raw(g, mesh, axis, back), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute`` over the mesh axis ``axis``: ``perm`` is a list of
    (source, destination) positions along the axis, each source and each
    destination at most once; a rank returns the tensor its source sent,
    or zeros where none is named.  Differentiable: the backward sends each
    gradient back along the reversed pairs.  Every rank of the axis must
    call it (and its backward) in the same order."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    n = mesh.size(axis)
    if len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm) or \
            any(not (0 <= i < n) for p in perm for i in p):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of {n} positions")
    return _Ppermute.apply(x, mesh, axis, perm)


def all_to_all_tokens(x: torch.Tensor, mesh, axes, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
    """Tiled ``all_to_all`` (MoE dispatch/combine): ``split_axis`` cut into
    one piece per rank, piece r sent to rank r, the received pieces
    concatenated along ``concat_axis`` in source order.  Not
    differentiable."""
    axes = _axes(axes)
    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    src = torch.stack(x.detach().chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(src)
    _count("all_to_all", src)
    _issue(dist.all_to_all_single, out, src, group=mesh.group(axes))
    return torch.cat(out.unbind(0), dim=concat_axis)


def grad_allreduce_bf16(grads, mesh, axes):
    """All-reduce every gradient leaf in bf16 (half the bytes of an f32
    reduction), each cast back to its own dtype."""
    def one(g):
        out = _all_reduce_raw(g.to(torch.bfloat16), mesh.group(_axes(axes)),
                              "sum")
        return out.to(g.dtype)
    if not _axes(axes):
        return grads
    return tree.map(one, grads)

