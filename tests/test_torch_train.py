"""The port's training stack held against the reference: optimizers, the
loss and its gradients under chunked and flash attention, train steps with
and without gradient accumulation, the data pipeline and the orchestrator.

Every comparison starts both packages from one state: the reference's,
fetched to numpy and converted with ``train_state_from_numpy``.

Tolerances.  The optimizers are elementwise f32 in the same order: their
updates and states are held to 1e-6.  The loss and its gradients sum f32
products in other orders on the two frameworks' CPU kernels (and, under
flash attention, in other tiles): 2e-4 relative and absolute, the
reference's own gradient tolerance; a train step's loss after three Adam
updates to 1e-4 relative.  Token batches are bit-identical.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.config import reduced as jreduced
from repro.runtime.orchestrator import Orchestrator as JOrchestrator
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.flashattn import kernel as FK
from repro_torch.kernels.flashattn import ops as FO
from repro_torch.models import api as tapi
from repro_torch.models.config import ShapeConfig
from repro_torch.models.config import reduced as treduced
from repro_torch.runtime.orchestrator import Orchestrator
from repro_torch.train import optim as toptim
from repro_torch.train import steps as tsteps

jax.config.update("jax_platform_name", "cpu")

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def configs(**kw):
    """reduced(smollm-135m) on both sides, f32 compute."""
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jreduced(jregistry.get("smollm-135m")), **kw),
            dataclasses.replace(treduced(tregistry.get("smollm-135m")), **kw))


def start_state(jcfg, seed=0):
    """The reference's initial train state, and the port's copy of it."""
    js = jsteps.init_train_state(jcfg, jax.random.key(seed))
    host = jax.device_get(js)
    return js, train_state_from_numpy(
        (host.params, host.opt_state, host.step), device="cpu")


def batch_of(cfg, B=2, S=24, seed=3):
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    b = tpipe.TokenStream(cfg, shape, seed=seed).batch_at(0)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_trees_close(port, ref, tol):
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = tree.leaves_with_paths(port)
    assert len(jl) == len(tl)
    for (jp, j), (tp, t) in zip(jl, tl):
        np.testing.assert_allclose(_np(t), _np(j), err_msg=tree.path_str(tp),
                                   **tol)


# ------------------------------------------------------------- optimizers


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": rng.standard_normal((2, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_updates_match_reference(name):
    """Each optimizer's updates and state over four steps on shared numpy
    grads."""
    jopt = joptim.make_optimizer(name, lr=1e-2)
    topt = toptim.make_optimizer(name, lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    tp = tree.map(torch.from_numpy, _opt_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    _assert_trees_close(ts, js, OPT_TOL)
    for step in range(4):
        g = _opt_tree(10 + step)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                             jnp.asarray(step, jnp.int32))
        tu, ts = topt.update(tree.map(torch.from_numpy, g), ts, tp,
                             torch.tensor(step, dtype=torch.int32))
        _assert_trees_close(tu, ju, OPT_TOL)
        _assert_trees_close(ts, js, OPT_TOL)
        jp = jax.tree_util.tree_map(jnp.add, jp, ju)
        tp = tree.map(torch.add, tp, tu)


def test_global_norm_and_clip_match_reference():
    g = _opt_tree(5)
    jg, tg = jax.tree_util.tree_map(jnp.asarray, g), tree.map(
        torch.from_numpy, g)
    np.testing.assert_allclose(float(toptim.global_norm(tg)),
                               float(joptim.global_norm(jg)), rtol=1e-6)
    for max_norm in (0.5, 1e3):
        tc, tn = toptim.clip_by_global_norm(tg, max_norm)
        jc, jn = joptim.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees_close(tc, jc, OPT_TOL)


def test_optimizer_update_changes_nothing_in_place():
    opt = toptim.make_optimizer("adamw")
    p = tree.map(torch.from_numpy, _opt_tree(1))
    before = tree.map(torch.clone, p)
    state = opt.init(p)
    opt.update(tree.map(torch.from_numpy, _opt_tree(2)), state, p,
               torch.tensor(0, dtype=torch.int32))
    for a, b in zip(tree.leaves(p), tree.leaves(before)):
        assert torch.equal(a, b)
    assert all(float(m.abs().max()) == 0 for m in tree.leaves(state))
    with pytest.raises(ValueError):
        toptim.make_optimizer("lion")


# ------------------------------------------------------- loss and gradients


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_loss_and_grads_match_reference(attn_impl):
    """``loss_fn`` value and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's, from one state."""
    jcfg, tcfg = configs(attn_impl=attn_impl)
    js, ts = start_state(jcfg)
    jb, tb = batch_of(tcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jb), has_aux=True)(js.params)
    leaves = [p.detach().requires_grad_() for p in tree.leaves(ts.params)]
    live = tree.unflatten(tree.structure(ts.params), leaves)
    tl, tm = tapi.loss_fn(tcfg, live, tb)
    tg = tree.unflatten(tree.structure(ts.params),
                        list(torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]),
                               rtol=2e-5)
    _assert_trees_close(tg, jg, GRAD_TOL)


def test_loss_mask_matches_reference():
    jcfg, tcfg = configs()
    js, ts = start_state(jcfg)
    jb, tb = batch_of(tcfg)
    mask = (np.random.default_rng(4).random(tb["labels"].shape) < 0.6
            ).astype(np.float32)
    jl, _ = japi.loss_fn(jcfg, js.params, dict(jb, mask=jnp.asarray(mask)))
    with torch.no_grad():
        tl, _ = tapi.loss_fn(tcfg, ts.params,
                             dict(tb, mask=torch.from_numpy(mask)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)


@pytest.mark.parametrize("remat", ["none", "save_dots", "full"])
def test_remat_changes_no_value_and_counts_recompute(remat, monkeypatch):
    """Block recompute is a memory choice: loss and gradients are equal to
    the last bit under every ``remat``; under flash attention a training
    step runs the forward kernel once per layer, twice when blocks are
    recomputed, and the backward once per layer."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = FK.flash_attention_fwd_lse, FK.flash_attention_bwd

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(FO.kernel, "flash_attention_fwd_lse",
                        spy("fwd", fwd))
    monkeypatch.setattr(FO.kernel, "flash_attention_bwd", spy("bwd", bwd))
    _, tcfg = configs(attn_impl="flash", remat=remat)
    _, base_cfg = configs(attn_impl="flash", remat="none")
    _, ts = start_state(configs()[0])
    _, tb = batch_of(tcfg)
    step = tsteps.make_train_step(tcfg)
    new, metrics = step(tree.map(torch.clone, ts), tb)
    L = tcfg.n_layers
    assert calls == {"fwd": (1 if remat == "none" else 2) * L, "bwd": L}
    ref_new, ref_metrics = tsteps.make_train_step(base_cfg)(ts, tb)
    assert torch.equal(metrics["loss"], ref_metrics["loss"])
    for a, b in zip(tree.leaves(new), tree.leaves(ref_new)):
        assert torch.equal(a, b)


# -------------------------------------------------------------- train steps


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_track_reference(grad_accum):
    """Three ``make_train_step`` steps (AdamW, clip) from one state on the
    same batches: losses within 1e-4 and the step counters equal."""
    jcfg, tcfg = configs(grad_accum=grad_accum)
    js, ts = start_state(jcfg)
    jstep = jax.jit(jsteps.make_train_step(jcfg))
    tstep = tsteps.make_train_step(tcfg)
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    stream = tpipe.TokenStream(tcfg, shape, seed=1)
    for i in range(3):
        b = stream.batch_at(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert int(ts.step) == int(js.step) == 3
    _assert_trees_close(ts.params, js.params, dict(rtol=1e-3, atol=1e-5))


def _functional(opt):
    """``opt`` with its ``apply_`` done by its functional ``update``: the
    new parameters p + u and the new state computed aside, then copied
    into the state's tensors."""
    def apply_(grads, state, params, step):
        ups, new = opt.update(grads, state, params, step)
        for p, u in zip(tree.leaves(params), tree.leaves(ups)):
            p.copy_(torch.add(p, u))
        for old, n in zip(tree.leaves(state), tree.leaves(new)):
            old.copy_(n)
    return opt._replace(apply_=apply_)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgdm"])
def test_in_place_step_equals_the_functional_update(opt, grad_accum,
                                                   monkeypatch):
    """Three train steps (gradients clipped in place, parameters and
    optimizer state written in place by ``Optimizer.apply_``, AdamW and SGD
    a stacked leaf one slice at a time, as a leaf past ``_BLOCK`` elements
    per slice runs) equal three steps whose update is the optimizer's
    functional ``update`` added to the parameters, bit for bit, and write
    into the given state's own tensors."""
    monkeypatch.setattr(toptim, "_BLOCK", 1)
    _, tcfg = configs(optimizer=opt, grad_accum=grad_accum,
                      param_dtype="bfloat16")
    ts = tsteps.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    aside = tree.map(torch.clone, ts)
    own = [t.data_ptr() for t in tree.leaves(ts)]
    rule = toptim.make_optimizer(opt)
    step = tsteps.make_train_step(tcfg, optimizer=rule)
    fstep = tsteps.make_train_step(tcfg, optimizer=_functional(rule))
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    stream = tpipe.TokenStream(tcfg, shape, seed=1)
    for i in range(3):
        b = {k: torch.from_numpy(v) for k, v in stream.batch_at(i).items()}
        ts, m = step(ts, b)
        aside, fm = fstep(aside, b)
        assert torch.equal(m["loss"], fm["loss"])
        assert torch.equal(m["grad_norm"], fm["grad_norm"])
    assert int(ts.step) == 3
    for a, b in zip(tree.leaves(ts), tree.leaves(aside)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in tree.leaves(ts)][:-1] == own[:-1]


def test_train_step_is_deterministic_and_pure():
    """Steps from two clones of one state on one batch give the same loss
    and state bit for bit, and the step writes into nothing but the state
    it is given: a third clone, kept aside, stays as it was."""
    _, tcfg = configs()
    _, ts = start_state(configs()[0])
    _, tb = batch_of(tcfg)
    before = [t.clone() for t in tree.leaves(ts)]
    step = tsteps.make_train_step(tcfg)
    a, ma = step(tree.map(torch.clone, ts), tb)
    b, mb = step(tree.map(torch.clone, ts), tb)
    assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
    for x, y in zip(tree.leaves(ts), before):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(tree.leaves(a.params),
                                                     tree.leaves(ts.params)))


def test_eval_step_matches_loss():
    jcfg, tcfg = configs()
    js, ts = start_state(jcfg)
    jb, tb = batch_of(tcfg)
    jm = jsteps.make_eval_step(jcfg)(js.params, jb)
    tm = tsteps.make_eval_step(tcfg)(ts.params, tb)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]),
                               rtol=2e-5)


def test_init_train_state_shapes_match_reference():
    jcfg, tcfg = configs(optimizer="adafactor")
    js = jax.eval_shape(lambda: jsteps.init_train_state(
        jcfg, jax.random.key(0)))
    ts = tsteps.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(js)
    tl = tree.leaves_with_paths(ts)
    assert [tree.path_str(p) for p, _ in tl] == [
        "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in p)
        for p, _ in jl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)


# --------------------------------------------------------------------- data

DATA_SHAPE = dict(seq_len=32, global_batch=8, kind="train")


def test_token_stream_bit_identical_to_reference():
    jcfg, tcfg = configs()
    for n_hosts, host in ((1, 0), (4, 3)):
        j = jpipe.TokenStream(jcfg, JShapeConfig("t", **DATA_SHAPE), seed=3,
                              n_hosts=n_hosts, host_id=host)
        t = tpipe.TokenStream(tcfg, ShapeConfig("t", **DATA_SHAPE), seed=3,
                              n_hosts=n_hosts, host_id=host)
        for step in (0, 17):
            jb, tb = j.batch_at(step), t.batch_at(step)
            assert set(jb) == set(tb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
                assert tb[k].dtype == jb[k].dtype
    with pytest.raises(ValueError):
        tpipe.TokenStream(tcfg, ShapeConfig("t", **DATA_SHAPE), n_hosts=3)
    it = iter(tpipe.TokenStream(tcfg, ShapeConfig("t", **DATA_SHAPE)))
    np.testing.assert_array_equal(next(it)["tokens"], tpipe.TokenStream(
        tcfg, ShapeConfig("t", **DATA_SHAPE)).batch_at(0)["tokens"])


def test_mmap_corpus_bit_identical_to_reference(tmp_path):
    data = np.arange(10_000, dtype=np.int32) % 97
    path = tmp_path / "corpus.bin"
    data.tofile(path)
    jcfg, tcfg = configs()
    j = jpipe.MmapCorpus(str(path), jcfg, JShapeConfig("t", **DATA_SHAPE),
                         seed=5)
    t = tpipe.MmapCorpus(str(path), tcfg, ShapeConfig("t", **DATA_SHAPE),
                         seed=5)
    for step in (0, 3):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(t.batch_at(step)[k],
                                          j.batch_at(step)[k])
    tiny = tmp_path / "tiny.bin"
    np.arange(8, dtype=np.int32).tofile(tiny)
    with pytest.raises(ValueError):
        tpipe.MmapCorpus(str(tiny), tcfg, ShapeConfig("t", **DATA_SHAPE))


# ------------------------------------------------------------- orchestrator


def _drive_orchestrators(fn):
    return fn(JOrchestrator), fn(Orchestrator)


def test_orchestrator_death_and_elastic_plan():
    def drive(cls):
        orch = cls(n_workers=8, heartbeat_timeout=5.0)
        for uid in range(8):
            orch.heartbeat(uid, step=10, step_time=1.0, now=100.0)
        for uid in range(6):
            orch.heartbeat(uid, step=11, step_time=1.0, now=108.0)
        dead = orch.check_health(now=109.0)
        plan = orch.elastic_plan(checkpointed_step=40, model_axis=2)
        return set(dead), dataclasses.astuple(plan), orch.events
    j, t = _drive_orchestrators(drive)
    assert t == j
    assert t[0] == {6, 7} and t[1][1][1] == 2 and t[1][2] == 40


def test_orchestrator_straggler_detection():
    def drive(cls):
        orch = cls(n_workers=4, straggler_factor=3.0, min_history=4)
        for step in range(4):
            for uid in range(4):
                dt = 20.0 if (uid == 2 and step == 3) else 1.0
                orch.heartbeat(uid, step=step, step_time=dt, now=float(step))
        return orch.detect_stragglers(), orch.progress()
    j, t = _drive_orchestrators(drive)
    assert t == j == ([2], {"min_step": 3, "max_step": 3, "alive": 4})
