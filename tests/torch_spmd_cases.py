"""Rank bodies of the port's multi-rank CPU tests
(``test_torch_parallel.py``, ``test_torch_sharded_models.py``,
``test_torch_sharded_train.py``, ``test_torch_vocab_parallel.py``, ...).

``launch.mesh.SpmdPool`` runs each body on spawned gloo ranks, which import
this module by name: its imports are torch, numpy and the port, never jax
(the reference is computed in the test process and reaches the ranks as
numpy).  Each body takes the rank's ``Mesh`` first and returns a tree of
tensors, arrays and numbers.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core.redundancy import replicated_vote
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import SpmdPool
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.models.shard import ShardCtx, cross_entropy, sharded
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (gather_tree, local_slices,
                                           param_specs, shard_tree)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim, steps


class Pool:
    """A test file's ranks: an ``SpmdPool`` of ``n`` CPU ranks, spawned
    anew after a failed call killed the last one (so that one failing case
    does not fail the file's others)."""

    def __init__(self, n: int):
        self.n, self._pool = n, None

    def run(self, *args, **kw):
        if self._pool is None or self._pool.closed:
            self._pool = SpmdPool(self.n, "cpu")
        return self._pool.run(*args, **kw)

    def close(self):
        if self._pool is not None:
            self._pool.close()


def _native_gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _native_sum(x, group):
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def collectives(mesh):
    """The four collectives of ``parallel.collectives`` beside the native
    ``all_gather`` / ``all_reduce`` they must equal, per axis set, and the
    per-kind counts they add."""
    C.reset_counts()
    out = {}
    gen = torch.Generator().manual_seed(mesh.rank)
    x = torch.randn((4, 6), generator=gen)
    for axes in ("model", "data", ("data", "model")):
        key = "+".join((axes,) if isinstance(axes, str) else axes)
        n, i = mesh.size(axes), mesh.index(axes)
        g = mesh.group(axes)
        before = C.counts()
        ring = C.ring_all_gather(x, mesh, axes, dim=1)
        after = C.counts()
        out[f"ring/{key}"] = (ring, _native_gather(x, g, 1))
        out[f"ring_hops/{key}"] = after["send_recv"] - before["send_recv"]
        # integer values: every order of the sum is exact
        wide = torch.randint(-50, 50, (3, 4 * n), generator=gen).float()
        total = _native_sum(wide, g)
        out[f"rs/{key}"] = (C.reduce_scatter(wide, mesh, axes, dim=1),
                            total[:, 4 * i:4 * (i + 1)])
        # all_to_all: piece r of every rank's split dim goes to rank r
        tok = torch.randn((2 * n, 3), generator=gen)
        everyone = _native_gather(tok[None], g, 0)        # (n, 2n, 3)
        want = torch.cat([everyone[s, 2 * i:2 * i + 2] for s in range(n)],
                         dim=1)
        out[f"a2a/{key}"] = (C.all_to_all_tokens(tok, mesh, axes, 0, 1),
                             want)
        grads = {"w": torch.randn((5, 3), generator=gen),
                 "b": torch.randn((3,), generator=gen).double()}
        got = C.grad_allreduce_bf16(grads, mesh, axes)
        out[f"bf16/{key}"] = [
            (got[k], _native_sum(grads[k].to(torch.bfloat16),
                                 g).to(grads[k].dtype), str(got[k].dtype))
            for k in ("b", "w")]
    out["counts"] = C.counts()
    return out


def mesh_refusals(mesh):
    """The messages of three meshes this process group cannot hold, and
    what the given mesh says of itself."""
    from repro_torch.launch import mesh as M
    out = []
    for make in (lambda: M.Mesh((3,), ("x",)),
                 lambda: M.make_production_mesh(),
                 lambda: M.Mesh((2,), ("x", "y"))):
        try:
            make()
            out.append("built")
        except ValueError as e:
            out.append(str(e))
    return out + [mesh.size(("data", "model")), mesh.index("model"),
                  list(M.dp_axes(mesh))]


def rank_of(mesh):
    return mesh.rank


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    return mesh.rank


def hang_on_rank_one(mesh):
    import time
    if mesh.rank == 1:
        time.sleep(60)
    return mesh.rank


def shard_batch_case(mesh, batch, dp):
    return shard_batch(batch, mesh, dp)


def vote_case(mesh, arr, struck):
    """Every rank computes ``arr``; the ``struck`` rank's result has a bit
    flipped.  The voted result on every rank."""
    def f(a):
        y = torch.from_numpy(a.copy())
        if mesh.rank == struck:
            bits = y.view(torch.int32)
            bits[1, 2] ^= 1 << 30
        return {"y": y, "z": y[0] * 2}
    return replicated_vote(f, mesh, "replica")(arr)


def save_case(mesh, state, specs, path):
    local = shard_tree(state, specs, mesh, device="cpu")
    ckpt.save(path, 5, local, specs=specs, mesh=mesh)
    return local


def restore_case(mesh, specs, path):
    step, local = ckpt.restore(path, 5, device="cpu", mesh=mesh,
                               specs=specs)
    return {"step": step, "local": local,
            "full": gather_tree(local, specs, mesh)}


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def model_run(mesh, cfg, full, batch, steps_tok, max_len, dp,
              batch_axes=None, builders=False):
    """forward, loss, prefill and decode steps under a ShardCtx on this
    rank's shards and batch slice; with ``builders``, whether the prefill
    and decode step builders' next tokens are those logits' argmax, and
    the eval step's CE."""
    ctx = ShardCtx(mesh, dp, "model", batch_axes)
    params = shard_tree(full, param_specs(cfg, full, dp, "model", mesh),
                        mesh, device="cpu")
    bax = ctx.batch_axes or ()
    loc = shard_batch(batch, mesh, bax, device="cpu")
    out = {}
    before = C.counts()
    with torch.no_grad():
        fo = api.forward(cfg, params, loc["tokens"], ctx)
        out["logits"], out["aux"] = fo.logits, fo.aux_loss
        out["loss"] = api.loss_fn(cfg, params, loc, ctx)[0]
        lg, cache = api.prefill(cfg, params, loc["tokens"], max_len, ctx)
        out["prefill"] = lg
        st = shard_batch({"s": steps_tok}, mesh, bax, device="cpu")["s"]
        dec = []
        for i in range(st.shape[1]):
            lg, cache = api.decode_step(cfg, params, st[:, i], cache, ctx)
            dec.append(lg)
        out["decode"] = torch.stack(dec, 1)
    out["cache_shapes"] = [list(t.shape) for t in tree.leaves(cache)]
    out["issued"] = {k: C.counts()[k] - before[k] for k in before}
    if not builders:
        return out
    # the step builders' greedy tokens are the argmax of these logits
    tok, cache = steps.make_prefill_step(cfg, max_len, ctx)(
        params, {"tokens": loc["tokens"]})
    nxt, _ = steps.make_decode_step(cfg, ctx)(params, st[:, 0], cache)
    out["steps_agree"] = bool(
        torch.equal(tok, out["prefill"][:, -1].argmax(-1).to(torch.int32))
        and torch.equal(nxt, out["decode"][:, 0].argmax(-1).to(torch.int32)))
    out["eval_ce"] = steps.make_eval_step(cfg, ctx)(params, loc)["ce"]
    return out


def _layer_local(sh, bp):
    """One layer's full leaves cut to this rank's shards."""
    return {k: v[local_slices(sh.spec(k, v.dim()), v.shape, sh.mesh)]
            .clone() for k, v in bp.items()}


def ffn_case(mesh, cfg, full, x, dp, moe):
    """One layer's FFN (dense or MoE) on this rank's shards beside the
    unsharded FFN on the same input, both computed here."""
    ctx = ShardCtx(mesh, dp, "model")
    sh = sharded(cfg, ctx)
    blk = "moe_blocks" if moe else "dense_blocks"
    bp = {k: torch.from_numpy(v[-1]) for k, v in full[blk].items()}
    x = torch.from_numpy(x)
    with torch.no_grad():
        want = T._ffn(cfg, bp, x, moe)[0]
        got = T._ffn(cfg, _layer_local(sh, bp), x, moe, sh)[0]
    return {"got": got, "want": want, "equal": bool(torch.equal(got, want))}


def route_case(mesh, cfg, h, router, cap):
    """This model rank's ``_local_route`` maps in the EP layout, and the
    int32 accumulators of its experts' first product on the buffer."""
    m = cfg.moe
    E_loc = m.n_experts // mesh.shape["model"]
    e_lo = mesh.axis_index("model") * E_loc
    h = torch.from_numpy(h)
    r = T._local_route(h, torch.from_numpy(router), m, cap, e_lo, E_loc)
    return {"e_lo": e_lo, "E_loc": E_loc, "gather_idx": r.gather_idx,
            "filled": r.filled, "gates": r.gates, "tslot": r.tslot}


def expert_acc_case(mesh, w_q, buf):
    """This model rank's experts' int32 accumulators (the ``ref``
    backend's exact products) of the quantized buffer."""
    E_loc = w_q.shape[0] // mesh.shape["model"]
    e_lo = mesh.axis_index("model") * E_loc
    x_q, _ = T._quantize_act(torch.from_numpy(buf[e_lo:e_lo + E_loc]))
    w = torch.from_numpy(w_q[e_lo:e_lo + E_loc])
    return torch.stack([dispatch.matmul_acc(x_q[e], w[e], backend="ref")
                        for e in range(E_loc)])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_run(mesh, cfg, full_state, batches, dp, opt_name):
    """Train steps under a ShardCtx from the full state's shards: each
    step's loss and gradient norm, and the final state gathered."""
    ctx = ShardCtx(mesh, dp, "model")
    specs = steps.train_state_specs(cfg, full_state.params, dp, "model",
                                    opt_name, mesh)
    state = shard_tree(full_state, specs, mesh, device="cpu")
    state = steps.TrainState(state.params, state.opt_state,
                             torch.as_tensor(state.step).reshape(()))
    step = steps.make_train_step(cfg, ctx,
                                 optimizer=optim.make_optimizer(opt_name))
    losses, norms = [], []
    for b in batches:
        state, metrics = step(state, shard_batch(b, mesh, dp, device="cpu"))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    with torch.no_grad():
        full = gather_tree(state.params, specs.params, mesh)
        opt = gather_tree(state.opt_state, specs.opt_state, mesh)
    return {"losses": losses, "norms": norms, "params": full, "opt": opt,
            "step": int(state.step)}


def grads_case(mesh, cfg, full, batch, dp):
    """The loss and the gradients of a sharded state (summed over copies,
    gathered) beside the unsharded ones, both computed here."""
    ctx = ShardCtx(mesh, dp, "model")
    specs = param_specs(cfg, full, dp, "model", mesh)
    params = shard_tree(full, specs, mesh, device="cpu")
    loss, _, grads = steps._grad_fn(cfg, ctx)(
        params, shard_batch(batch, mesh, dp, device="cpu"))
    grads = steps._sum_copies(grads, specs, mesh)
    with torch.no_grad():
        grads = gather_tree(grads, specs, mesh)
    want_loss, _, want = steps._grad_fn(cfg, None)(
        tree.map(torch.from_numpy, full),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"loss": loss, "want_loss": want_loss, "grads": grads,
            "want": want}


def adafactor_apply_case(mesh, cfg, full_state, grads_seq, dp):
    """Adafactor's ``apply_`` over the gradients ``grads_seq`` (one step
    each) on this rank's shards of ``full_state`` (``shard=`` the state's
    specs) and, here too, on the whole state: both final states, the
    sharded one gathered."""
    specs = steps.train_state_specs(cfg, full_state.params, dp, "model",
                                    "adafactor", mesh)
    opt = optim.make_optimizer("adafactor")
    params = shard_tree(full_state.params, specs.params, mesh, device="cpu")
    state = shard_tree(full_state.opt_state, specs.opt_state, mesh,
                       device="cpu")
    want_p = tree.map(lambda a: torch.from_numpy(np.array(a)),
                      full_state.params)
    want_s = tree.map(lambda a: torch.from_numpy(np.array(a)),
                      full_state.opt_state)
    with torch.no_grad():
        for i, g in enumerate(grads_seq):
            step = torch.tensor(i, dtype=torch.int32)
            opt.apply_(shard_tree(g, specs.params, mesh, device="cpu"),
                       state, params, step, shard=(specs.params, mesh))
            opt.apply_(tree.map(torch.from_numpy, g), want_s, want_p, step)
        got_p = gather_tree(params, specs.params, mesh)
        got_s = gather_tree(state, specs.opt_state, mesh)
    return {"params": got_p, "opt": got_s, "want_params": want_p,
            "want_opt": want_s}


def collective_counts_case(mesh, cfg, seed, n_decode, shapes=False):
    """The collectives counted, by kind, in a 24-token prefill, then
    ``n_decode`` decode steps, then (for float parameters) one train step
    of the config's optimizer, each under a ShardCtx from the shards of a
    seeded state; with ``shapes``, the decoded cache's leaf shapes."""
    ctx = ShardCtx(mesh, ("data",), "model")
    gen = torch.Generator().manual_seed(seed)
    params = api.init_params(cfg, gen, device="cpu")
    specs = param_specs(cfg, params, ctx.dp, ctx.model, mesh)
    local = shard_tree(params, specs, mesh, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 24), generator=gen)
    out = {}
    C.reset_counts()
    with torch.no_grad():
        _, cache = api.prefill(cfg, local, toks, 24 + n_decode, ctx)
        out["prefill"] = C.counts()
        C.reset_counts()
        for i in range(n_decode):
            _, cache = api.decode_step(cfg, local, toks[:, i], cache, ctx)
        out["decode"] = C.counts()
    if shapes:
        out["cache_shapes"] = [list(t.shape) for t in tree.leaves(cache)]
    if cfg.quant == "none":
        opt = optim.make_optimizer(cfg.optimizer)
        state = steps.TrainState(local, opt.init(local),
                                 torch.zeros((), dtype=torch.int32))
        t = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen).numpy()
        batch = shard_batch({"tokens": t[:, :-1], "labels": t[:, 1:]},
                            mesh, ctx.dp, device="cpu")
        C.reset_counts()
        steps.make_train_step(cfg, ctx, optimizer=opt)(state, batch)
        out["train"] = C.counts()
    return out


def _unsharded_run(cfg, params, batch, steps_tok, max_len):
    out = {}
    with torch.no_grad():
        fo = api.forward(cfg, params, batch["tokens"])
        out["logits"], out["aux"] = fo.logits, fo.aux_loss
        out["loss"] = api.loss_fn(cfg, params, batch)[0]
        lg, cache = api.prefill(cfg, params, batch["tokens"], max_len)
        out["prefill"] = lg
        dec = []
        for i in range(steps_tok.shape[1]):
            lg, cache = api.decode_step(cfg, params, steps_tok[:, i], cache)
            dec.append(lg)
        out["decode"] = torch.stack(dec, 1)
    return out


def world_one(mesh, cfg, full, batch, steps_tok, max_len):
    """On a one-rank mesh the sharded path against the unsharded one, both
    computed here: which outputs are torch.equal."""
    got = model_run(mesh, cfg, full, batch, steps_tok, max_len, ("data",))
    want = _unsharded_run(cfg, tree.map(torch.from_numpy, full),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.from_numpy(steps_tok), max_len)
    return {k: bool(torch.equal(torch.as_tensor(got[k]), want[k]))
            for k in want}


def train_world_one(mesh, cfg, full_state, batches, opt_name):
    """On a one-rank mesh the sharded train step against the unsharded
    one from the same state, both run here: losses, norms and the final
    parameters and optimizer state, each torch.equal or not."""
    got = train_run(mesh, cfg, full_state, batches, ("data",), opt_name)
    state = tree.map(lambda a: torch.from_numpy(np.array(a)), full_state)
    state = steps.TrainState(state.params, state.opt_state,
                             state.step.reshape(()))
    step = steps.make_train_step(cfg, optimizer=optim.make_optimizer(
        opt_name))
    losses, norms = [], []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    same = all(torch.equal(torch.as_tensor(a), b) for a, b in zip(
        tree.leaves(got["params"]) + tree.leaves(got["opt"]),
        tree.leaves(state.params) + tree.leaves(state.opt_state)))
    return {"losses": got["losses"] == losses, "norms": got["norms"] == norms,
            "state": same}


# ---------------------------------------------------------------------------
# Pipeline parallelism, the sharded FT loop, the dry-run against a run
# ---------------------------------------------------------------------------


def tanh_stage(params, x):
    """``test_pipeline_parallel.py``'s stage: tanh(x @ w + b)."""
    return torch.tanh(x @ params["w"] + params["b"])


def _pipeline_grads(mesh, stage_list, x, checkpoint):
    from repro_torch.parallel import pipeline
    from repro_torch.parallel.sharding import P
    stacked = pipeline.stack_stage_params(
        [tree.map(torch.from_numpy, p) for p in stage_list])
    local = shard_tree(stacked, tree.map(lambda _: P("stage"), stacked),
                       mesh, device="cpu")
    leaves = [t.requires_grad_() for t in tree.leaves(local)]
    C.reset_counts()
    out = pipeline.pipeline_apply(tanh_stage, local, torch.from_numpy(x),
                                  mesh, checkpoint_stages=checkpoint)
    fwd = C.counts()
    loss = (out ** 2).mean()
    grads = torch.autograd.grad(loss, leaves, grad_outputs=torch.full_like(
        loss, 1.0 / mesh.size(mesh.axis_names)))
    total = C.counts()
    return out, loss, dict(zip(("b", "w"), (g[0] for g in grads))), fwd, \
        total


def pipeline_case(mesh, stage_list, x, checkpoint=True):
    """``pipeline_apply`` of the tanh stages over the "stage" axis and the
    gradient of mean(out²) wrt this rank's stage, each rank seeded with
    1 / world; the collectives issued forward and in all."""
    out, loss, grads, fwd, total = _pipeline_grads(mesh, stage_list, x,
                                                    checkpoint)
    return {"out": out.detach(), "loss": loss.detach(), "grads": grads,
            "fwd": fwd, "total": total}


def pipeline_world_one(mesh, stage_list, x):
    """At one stage, with ``checkpoint_stages`` on and off: the outputs
    and the gradient torch.equal to a plain loop over the microbatches."""
    p = tree.map(lambda a: torch.from_numpy(a).requires_grad_(),
                 stage_list[0])
    xs = torch.from_numpy(x)
    want = torch.stack([tanh_stage(p, xs[i]) for i in range(xs.shape[0])])
    want_g = torch.autograd.grad((want ** 2).mean(), [p["b"], p["w"]])
    out = {}
    for ck in (True, False):
        got, _, grads, _, _ = _pipeline_grads(mesh, stage_list, x, ck)
        out[ck] = (torch.equal(got, want)
                   and torch.equal(grads["b"], want_g[0])
                   and torch.equal(grads["w"], want_g[1]))
    return out


class NanHook:
    """A NaN in this rank's shard of ``embed`` at step ``at``, once."""

    def __init__(self, at):
        self.at, self.fired = at, False

    def __call__(self, step, state):
        if step == self.at and not self.fired:
            self.fired = True
            embed = state.params["embed"].clone()
            embed.view(-1)[0] = float("nan")
            return state._replace(params=dict(state.params, embed=embed))
        return None


class NodeLost:
    """``RuntimeError("node lost")`` at step ``at`` on rank ``rank`` only,
    once."""

    def __init__(self, at, rank):
        self.at, self.rank, self.fired = at, rank, False

    def __call__(self, step, state):
        if step == self.at and dist.get_rank() == self.rank \
                and not self.fired:
            self.fired = True
            raise RuntimeError("node lost")
        return None


def ft_run(mesh, cfg, shape, ckpt_dir, n_steps, hook=None, ckpt_every=4):
    """``ft_loop.run(mesh=)``: this rank's report."""
    from repro_torch.runtime import ft_loop
    ft = ft_loop.FTConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    rep = ft_loop.run(cfg, shape, ft, n_steps=n_steps, fault_hook=hook,
                      mesh=mesh)
    return {"losses": rep.losses, "recoveries": rep.recoveries,
            "replayed": rep.steps_replayed, "events": rep.events,
            "saves": rep.ckpt_stats["saves"]}


def ft_run_late(mesh, cfg, shape, ckpt_dir, n_steps, late, wait_s):
    """``ft_run`` with rank ``late`` starting late: before it calls the
    loop it waits, up to ``wait_s`` seconds, for a step-0 checkpoint to
    appear in ``ckpt_dir``, as a rank slowed by a loaded machine might
    find the one its peers are still saving."""
    if mesh.rank == late:
        end = time.monotonic() + wait_s
        while ckpt.latest_step(ckpt_dir) is None and time.monotonic() < end:
            time.sleep(0.05)
    return ft_run(mesh, cfg, shape, ckpt_dir, n_steps)


def analyzed_step(mesh, cfg, shape, full, batch):
    """``launch.dryrun.build_cell``'s step on this rank's shards of real
    (full, batch) and its op analysis: the dry-run's numbers, run."""
    from repro_torch.launch import dryrun, op_analysis
    kw = {"state": full} if shape.kind == "train" else {"params": full}
    fn, args = dryrun.build_cell(cfg, shape, mesh,
                                 batch=tree.map(torch.as_tensor, batch),
                                 device="cpu", **kw)
    _, an = op_analysis.analyze(fn, *args)
    return {"summary": an.summary(), "memory": an.memory_analysis()}


# ------------------------------------------------- the vocabulary split


def _seed(mesh, loss):
    """The train step's seed of a replicated loss: 1 / world."""
    return torch.full_like(loss, 1.0 / mesh.size(mesh.axis_names))


def vocab_ce_case(mesh, cfg, logits, labels, mask):
    """``shard.cross_entropy`` on this rank's rows (over "data") and
    columns (over "model") of the whole (B, S, V) ``logits``, the
    vocabulary split: the loss, and its gradient with respect to this
    rank's logits under the 1 / world seed."""
    sh = sharded(cfg, ShardCtx(mesh, ("data",), "model"))
    assert sh.vocab_split
    nb = logits.shape[0] // mesh.shape["data"]
    nv = logits.shape[-1] // mesh.shape["model"]
    rows = slice(mesh.axis_index("data") * nb,
                 (mesh.axis_index("data") + 1) * nb)
    cols = slice(sh.vocab_lo(nv), sh.vocab_lo(nv) + nv)
    x = torch.from_numpy(logits[rows, :, cols]).requires_grad_()
    m = None if mask is None else torch.from_numpy(mask[rows])
    loss = cross_entropy(sh, x, torch.from_numpy(labels[rows]), m)
    loss.backward(_seed(mesh, loss))
    return {"loss": loss.detach(), "grad": x.grad}


def vocab_embed_case(mesh, cfg, table, ids, w):
    """``transformer._embed`` of this rank's rows of ``ids`` (over "data")
    from its shard of ``table`` (``param_specs``: the vocabulary over
    "model", d over "data" under FSDP), and the gradient of the global
    Σ rows·w with respect to that shard under the 1 / world seed."""
    ctx = ShardCtx(mesh, ("data",), "model")
    sh = sharded(cfg, ctx)
    assert sh.vocab_split
    specs = param_specs(cfg, {"embed": table}, ctx.dp, ctx.model, mesh)
    local = shard_tree({"embed": torch.from_numpy(table)}, specs, mesh,
                       device="cpu")["embed"].requires_grad_()
    nb = ids.shape[0] // mesh.shape["data"]
    rows = slice(mesh.axis_index("data") * nb,
                 (mesh.axis_index("data") + 1) * nb)
    C.reset_counts()
    out = T._embed(cfg, {"embed": local}, torch.from_numpy(ids[rows]), sh)
    counts = C.counts()
    loss = C.all_reduce((out * torch.from_numpy(w[rows])).sum(), mesh,
                        "data")
    loss.backward(_seed(mesh, loss))
    return {"rows": out.detach(), "grad": local.grad, "counts": counts}


# ------------------------------------------------- sequence parallelism


def _record_routes():
    """Wrap ``transformer._local_route`` so that each call's tokens and
    maps are recorded: (the list, a function that restores it)."""
    real, seen = T._local_route, []

    def route(h, router_w, m, cap, e_lo=0, E_loc=None):
        r = real(h, router_w, m, cap, e_lo, E_loc)
        seen.append({"h": h.detach().clone(), "router": router_w.detach(),
                     "cap": cap, "e_lo": int(e_lo), "E_loc": E_loc or
                     m.n_experts, "gather_idx": r.gather_idx,
                     "filled": r.filled, "gates": r.gates.detach()})
        return r
    T._local_route = route

    def restore():
        T._local_route = real
    return seen, restore


def _loss_and_grads(mesh, cfg, params, specs, loc, ctx):
    """The train step's loss and gradients of this rank's shards
    (``steps._grad_fn``), the gradients summed over copies and gathered
    whole; the (shape, bytes) of each (B, s, d) tensor that autograd saves
    through the loss's graph (the parameters' own storages left out) and
    the collectives counted."""
    own = {t.untyped_storage().data_ptr() for t in tree.leaves(params)}
    saved = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in own and t.dim() == 3 \
                and t.shape[-1] == cfg.d_model:
            saved.append((list(t.shape), t.numel() * t.element_size()))
        return t
    C.reset_counts()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _, grads = steps._grad_fn(cfg, ctx)(params, loc)
    counts = C.counts()
    grads = steps._sum_copies(grads, specs, mesh)
    with torch.no_grad():
        grads = gather_tree(grads, specs, mesh)
    return {"loss": loss, "saved": saved, "grads": grads,
            "train_counts": counts}


def seq_case(mesh, cfg, full, batch, dp=("data",), prefill_len=None):
    """Under a ShardCtx on this rank's shards and batch slice: forward's
    logits, the loss and its gradients (summed over copies, gathered
    whole), each MoE layer's routed tokens and maps in the forward, the
    (B, s, d) activations autograd keeps through the loss's graph (the
    shapes and bytes packed by ``saved_tensors_hooks``, the parameters'
    own storages left out) and the collectives of each part; with
    ``prefill_len``, a prefill's logits and the next decode step's."""
    ctx = ShardCtx(mesh, dp, "model")
    specs = param_specs(cfg, full, dp, "model", mesh)
    params = shard_tree(full, specs, mesh, device="cpu")
    loc = shard_batch(batch, mesh, dp, device="cpu")
    out = {}
    seen, restore = _record_routes()
    try:
        C.reset_counts()
        with torch.no_grad():
            out["logits"] = api.forward(cfg, params, loc["tokens"], ctx).logits
        out["fwd_counts"] = C.counts()
    finally:
        restore()
    out["routes"] = seen
    if cfg.quant != "none":       # int8 leaves: the loss, no gradient
        with torch.no_grad():
            out["loss"] = api.loss_fn(cfg, params, loc, ctx)[0]
    else:
        out.update(_loss_and_grads(mesh, cfg, params, specs, loc, ctx))
    if prefill_len is not None:
        C.reset_counts()
        with torch.no_grad():
            lg, cache = api.prefill(cfg, params, loc["tokens"], prefill_len,
                                    ctx)
            out["prefill_counts"] = C.counts()
            out["prefill"] = lg
            out["decode"] = api.decode_step(cfg, params, loc["tokens"][:, 0],
                                            cache, ctx)[0]
    return out


def unsharded_case(mesh, cfg, full, batch, max_len):
    """``ctx=None`` on the whole batch: forward's logits, the loss and its
    gradients, a prefill's logits and the next decode step's."""
    params = tree.map(torch.from_numpy, full)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    with torch.no_grad():
        out["logits"] = api.forward(cfg, params, b["tokens"]).logits
        lg, cache = api.prefill(cfg, params, b["tokens"], max_len)
        out["prefill"] = lg
        out["decode"] = api.decode_step(cfg, params, b["tokens"][:, 0],
                                        cache)[0]
    out["loss"], _, out["grads"] = steps._grad_fn(cfg, None)(params, b)
    return out
