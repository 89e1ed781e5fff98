"""The port's sharded train step held against the reference's
single-device step: ``make_train_step(cfg, ctx)`` on a (2, 2) mesh of gloo
ranks with AdamW, with SGD under ``grad_accum=2`` and with Adafactor under
``fsdp_params``, the meshed MoE on a (1, 4) mesh, and rwkv6 and griffin
run tensor-parallel inside their layers at (2, 2) (griffin also at (1,
4)), each from the reference's initial state on the reference's batches:
the losses, the gradient norms and the updated parameters and optimizer
state.  For the recurrent families the gradient moments of the leaves the
specs replicate but each rank slices to its heads (rwkv6's ``u``,
``ln_x``, ``w0``, ``dec_B``) are held by name.

Tolerances: the loss and the gradient norm 1e-4 relative
(``test_torch_train.py``); per leaf and normwise, the change the steps
made to each parameter within 1e-3 (the f32 rounding of p + Δ sets that
floor where Δ is small against p, as SGD's few hundred ulps of p: the
gradients themselves agree to ~1e-6) and each optimizer state leaf within
2e-5.  Adafactor's in-place update
on the shards against the same update on the whole state: the parameters'
change within 3e-5 and the state within 1e-6, where a mean or an RMS
taken over one shard instead of the whole parameter is off by percents.
The float64 witness: the sharded gradients against the port's unsharded
ones in float64 within 1e-12 (the optimizer's arithmetic is f32 by
design).  On a (1, 1) mesh the sharded step is the unsharded one bit for
bit.  The ranks are one pool of 4 spawned processes.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import RecurrentConfig as JRecurrentConfig
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro_torch import tree
from repro_torch.models import api as tapi
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.config import RecurrentConfig as TRecurrentConfig
from repro_torch.train import steps as tsteps

jax.config.update("jax_platform_name", "cpu")

AXES = ("data", "model")
B, S, N_STEPS = 4, 16, 2
# per leaf, normwise: the change the steps made to a parameter (its f32
# rounding of p + Δ bounds it), and an optimizer state leaf
STEP_TOL, STATE_TOL = 1e-3, 2e-5
# Adafactor's update on the shards against the whole state's
APPLY_STEP_TOL, APPLY_STATE_TOL = 3e-5, 1e-6


@pytest.fixture(scope="module")
def pool():
    p = cases.Pool(4)
    yield p
    p.close()


# the recurrent families as test_torch_sharded_models.py's configs
REC = {"rwkv": dict(family="rwkv", n_kv_heads=1, sub_quadratic=True,
                    recurrent=dict(kind="rwkv6", head_dim=8)),
       "griffin": dict(family="hybrid", n_layers=5, n_kv_heads=1,
                       sub_quadratic=True,
                       recurrent=dict(kind="rglru", attn_window=8,
                                      lru_width=32, d_conv=4))}
# the leaves replicated by the specs that a tensor-parallel layer slices
SLICED = ("u", "ln_x", "w0", "dec_B")


def _both(moe=None, rec=None, **kw):
    base = dict(name="t", family="transformer", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128, head_dim=8,
                compute_dtype="float32", remat="none")
    base.update(kw)
    if rec is not None:
        base.update(REC[rec])
        r = base.pop("recurrent")
        return (JArchConfig(recurrent=JRecurrentConfig(**r), **base),
                TArchConfig(recurrent=TRecurrentConfig(**r), **base))
    if moe is None:
        return JArchConfig(**base), TArchConfig(**base)
    m = dict(n_experts=4, top_k=2, d_expert=16, n_dense_layers=1,
             capacity_factor=8.0, n_shared_experts=1)
    return (JArchConfig(moe=JMoEConfig(**m), **base),
            TArchConfig(moe=TMoEConfig(**m), **base))


CONFIGS = {
    "adamw": (dict(optimizer="adamw"), (2, 2)),
    "sgdm_accum2": (dict(optimizer="sgdm", grad_accum=2), (2, 2)),
    "adafactor_fsdp": (dict(optimizer="adafactor", fsdp_params=True),
                       (2, 2)),
    "moe_adamw": (dict(optimizer="adamw", moe=True, remat="full"), (1, 4)),
    "rwkv_adamw": (dict(optimizer="adamw", rec="rwkv", remat="save_dots"),
                   (2, 2)),
    "griffin_adamw": (dict(optimizer="adamw", rec="griffin"), (2, 2)),
    "griffin_adamw_1x4": (dict(optimizer="adamw", rec="griffin",
                               remat="save_dots"), (1, 4)),
}


def _cfgs(name):
    kw, _ = CONFIGS[name]
    kw = dict(kw)
    moe = kw.pop("moe", None)
    return _both(moe=moe, **kw)


def _randomise_zeros(params, seed=7):
    """The recurrent families' zero-initialised leaves drawn instead (as
    ``test_torch_sharded_models.py`` draws them): at zero every rank's
    slice of ``u``, ``ln_x`` or ``dec_B`` reads the same values, so a slice
    taken at the wrong heads would not show, and ``ddl_B`` = 0 leaves
    ``ddl_A`` and ``mu_x`` no first-step gradient, whose second-step
    moments then rest on one AdamW step of ``ddl_B`` (sign-like where its
    gradient is tiny): the port's unsharded step is off the reference's
    there by 4e-5, against STATE_TOL."""
    rng = np.random.default_rng(seed)

    def f(a):
        if a.dtype.kind == "f" and not a.any():
            return (rng.normal(size=a.shape) * 0.3).astype(a.dtype)
        return a
    return tree.map(f, params)


def _batches(cfg, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _start(jcfg, tcfg):
    """One initial state for both packages: the port's draw (its tree is
    the reference's, ``test_torch_train.py``) with the reference's
    optimizer state, as the reference's TrainState and a port TrainState
    of numpy leaves."""
    params = tree.map(lambda t: t.numpy(), tapi.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    if tcfg.recurrent is not None:
        params = _randomise_zeros(params)
    opt = jax.device_get(joptim.make_optimizer(jcfg.optimizer).init(
        jax.tree_util.tree_map(jnp.asarray, params)))
    step = np.zeros((), np.int32)
    return (jsteps.TrainState(params, opt, step),
            tsteps.TrainState(params, opt, step))


def _ref_steps(jcfg, js, batches):
    step = jax.jit(jsteps.make_train_step(jcfg))
    state = jax.tree_util.tree_map(jnp.asarray, js)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.device_get(state)


def _rel_errs(port, ref, start=None):
    """Per leaf, ||port − ref|| / ||ref|| (both less ``start``'s leaf
    where given: the change a step made), in float64."""
    tl = tree.leaves_with_paths(port)
    rl = tree.leaves(ref)
    sl = tree.leaves(start) if start is not None else [0.0] * len(rl)
    assert len(tl) == len(rl) == len(sl)
    out = {}
    for (tp, t), r, s in zip(tl, rl, sl):
        s = np.asarray(s, np.float64)
        d = np.asarray(t, np.float64) - s
        w = np.asarray(r, np.float64) - s
        out[tree.path_str(tp)] = (np.linalg.norm(d - w)
                                  / max(np.linalg.norm(w), 1e-30))
    return out


def _assert_rel(errs, tol):
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])


def _sliced_moments(errs, ref_opt):
    """The optimizer state's errors (``_rel_errs``) of the leaves in
    SLICED, by path: AdamW's first moment after the steps is a sum of the
    steps' gradients, each of which a rank builds from its slice."""
    names = dict(zip(errs, (np.asarray(a) for a in tree.leaves(ref_opt))))
    out = {k: e for k, e in errs.items() if k.split("/")[-1] in SLICED}
    assert out and all(np.abs(names[k]).max() > 0 for k in out)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_train_step_matches_reference(pool, name):
    jcfg, tcfg = _cfgs(name)
    shape = CONFIGS[name][1]
    js, full = _start(jcfg, tcfg)
    batches = _batches(tcfg)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_ref_steps, jcfg, js, batches)  # while ranks run
        res = pool.run(cases.train_run, shape, AXES,
                       (tcfg, full, batches, ("data",), tcfg.optimizer))
        losses, norms, ref = fut.result()
    for r in res:                      # every rank: the global numbers
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-4)
        assert r["step"] == N_STEPS
        for k in ("params", "opt"):
            for a, b in zip(tree.leaves(r[k]), tree.leaves(res[0][k])):
                np.testing.assert_array_equal(a, b)
    _assert_rel(_rel_errs(res[0]["params"], ref.params, full.params),
                STEP_TOL)
    opt_errs = _rel_errs(res[0]["opt"], ref.opt_state)
    _assert_rel(opt_errs, STATE_TOL)
    if tcfg.family == "rwkv":
        for k, e in _sliced_moments(opt_errs, ref.opt_state).items():
            assert e <= STATE_TOL, (k, e)


@pytest.mark.parametrize("name,shape", [("adamw", (2, 2)),
                                        ("adafactor_fsdp", (2, 2)),
                                        ("moe_adamw", (1, 4))])
def test_float64_gradient_witness(pool, name, shape):
    """In float64 the sharded gradients (each rank's partials summed over
    the copies, FSDP dims reduce-scattered, then gathered) are the
    unsharded ones up to the order of their sums: within 1e-12."""
    jcfg, tcfg = _cfgs(name)
    tcfg = dataclasses.replace(tcfg, compute_dtype="float64",
                               param_dtype="float64")
    _, full = _start(jcfg, tcfg)
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                    full.params)
    res = pool.run(cases.grads_case, shape, AXES,
                   (tcfg, params, _batches(tcfg)[0], ("data",)))
    for r in res:
        np.testing.assert_allclose(r["loss"], r["want_loss"], rtol=1e-12)
        num = sum(float(np.sum((np.asarray(a) - np.asarray(b)) ** 2))
                  for a, b in zip(tree.leaves(r["grads"]),
                                  tree.leaves(r["want"])))
        den = sum(float(np.sum(np.asarray(b) ** 2))
                  for b in tree.leaves(r["want"]))
        assert np.sqrt(num / den) <= 1e-12


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_adafactor_apply_sharded_matches_unsharded(pool, shape):
    """Adafactor's in-place update under ``fsdp_params``, two steps of
    the same gradients on the shards (``shard=``) and on the whole state:
    its factored means and its update RMS are taken over the whole
    parameter, so the two differ only by the order of the means' f32
    sums."""
    jcfg, tcfg = _cfgs("adafactor_fsdp")
    _, full = _start(jcfg, tcfg)
    rng = np.random.default_rng(5)
    grads = [tree.map(lambda a: (1e-2 * rng.standard_normal(a.shape))
                      .astype(a.dtype), full.params) for _ in range(2)]
    res = pool.run(cases.adafactor_apply_case, shape, AXES,
                   (tcfg, full, grads, ("data",)))
    for r in res:
        _assert_rel(_rel_errs(r["params"], r["want_params"], full.params),
                    APPLY_STEP_TOL)
        _assert_rel(_rel_errs(r["opt"], r["want_opt"]), APPLY_STATE_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_rank_mesh_trains_as_the_unsharded_step(pool, name):
    """On a (1, 1) mesh the sharded step (seeded 1 / world = 1, every
    collective a copy, Adafactor's means taken over one shard) gives the
    unsharded step's losses, gradient norms, parameters and optimizer
    state bit for bit (what ``chip_smoke.py`` holds on the card)."""
    jcfg, tcfg = _cfgs(name)
    _, full = _start(jcfg, tcfg)
    res = pool.run(cases.train_world_one, (1, 1), AXES,
                   (tcfg, full, _batches(tcfg), tcfg.optimizer))
    assert res[0] == {"losses": True, "norms": True, "state": True}
