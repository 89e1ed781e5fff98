"""The port's sharded model paths held against the reference's
single-device path (the reference's own meshed test,
``test_transformer.py::test_moe_shardmap_matches_single``, is red on
jax 0.9.0): ``forward``, ``loss_fn``, ``prefill`` and decode steps under a
``ShardCtx`` on meshes (1, 2), (2, 2) and (1, 4) of gloo ranks, for dense
GQA (KV heads dividing the model axis and not, ``seq_shard``, W8A8), the
MoE in ``ep`` and ``etp`` (mixtral-style top-2, kimi-style top-8 with a
shared expert, a config that drops tokens), rwkv6 and griffin (tensor-
parallel inside their layers on a model axis of more than one rank, and
under ``layout="dp"``).

Where the reference's sharded semantics differ from its single path (MoE
capacity from the local token count, aux the mean of the shards' aux), the
port is held against the single path run per dp shard.  Tolerances, the
port's existing ones: dense logits within 1e-5 and MoE logits within 1e-4,
normwise (‖got − want‖ / ‖want‖); the recurrent families within 1e-4
elementwise as ``test_torch_rwkv_griffin.py``.  Exact: the W8A8 FFN under
tensor parallelism against the unsharded FFN, the top-2 MoE's combine in
f32, the routing maps and int8 expert accumulators against the
reference's per model rank.  The float64 witness: the sharded path
against the port's unsharded one in float64 (chunked attention) within
1e-12.  The ranks are one pool of 4 spawned processes.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro.models import api as japi
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import RecurrentConfig as JRecurrentConfig
from repro_torch import tree
from repro_torch.models import api as tapi
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.config import RecurrentConfig as TRecurrentConfig

jax.config.update("jax_platform_name", "cpu")

AXES = ("data", "model")
B, S, STEPS, MAX_LEN = 4, 16, 2, 20      # T = 20 splits 2 and 4 ways


@pytest.fixture(scope="module")
def pool():
    p = cases.Pool(4)
    yield p
    p.close()


def _both(family="transformer", moe=None, rec=None, **kw):
    base = dict(name="t", family=family, n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=128, head_dim=16,
                compute_dtype="float32")
    base.update(kw)
    j = dict(base)
    t = dict(base)
    if moe is not None:
        m = dict(n_experts=4, top_k=2, d_expert=16, n_dense_layers=1,
                 capacity_factor=8.0)
        m.update(moe)
        j["moe"], t["moe"] = JMoEConfig(**m), TMoEConfig(**m)
    if rec is not None:
        j["recurrent"], t["recurrent"] = JRecurrentConfig(**rec), \
            TRecurrentConfig(**rec)
    return JArchConfig(**j), TArchConfig(**t)


RWKV = dict(kind="rwkv6", head_dim=8)
GRIFFIN = dict(kind="rglru", attn_window=8, lru_width=32, d_conv=4)

CONFIGS = {
    "dense": lambda: _both(),
    "dense_seq": lambda: _both(seq_shard=True),
    "dense_layout_dp": lambda: _both(layout="dp", fsdp_params=True),
    "dense_int8kv": lambda: _both(quant_kv=True),
    # the port's flash path (row 9's plain version on the CPU) against the
    # reference's chunked attention
    "dense_flash": lambda: (_both()[0], _both(attn_impl="flash")[1]),
    "dense_w8a8_fsdp": lambda: _both(quant="w8a8_ffn", fsdp_params=True),
    "mixtral": lambda: _both(moe=dict(n_dense_layers=0), swa_window=8),
    "mixtral_w8a8": lambda: _both(moe=dict(n_dense_layers=0),
                                  quant="w8a8_ffn", fsdp_params=True),
    # five experts: expert-TP on a 2- and a 4-way model axis
    "etp": lambda: _both(moe=dict(n_experts=5)),
    "etp_w8a8": lambda: _both(moe=dict(n_experts=5), quant="w8a8_ffn"),
    "kimi": lambda: _both(moe=dict(n_experts=16, top_k=8,
                                   n_shared_experts=1)),
    # five experts (expert-TP on a 2-way model axis), a W8A8 dense layer
    # and a W8A8 MoE layer that drops tokens, FSDP
    "etp_drops_w8a8": lambda: _both(moe=dict(n_experts=5,
                                             capacity_factor=1.0),
                                    quant="w8a8_ffn", fsdp_params=True),
    "rwkv": lambda: _both("rwkv", rec=RWKV, n_kv_heads=1, head_dim=8,
                          sub_quadratic=True),
    "griffin": lambda: _both("hybrid", rec=GRIFFIN, n_layers=5, n_kv_heads=1,
                             head_dim=8, sub_quadratic=True),
    "rwkv_layout_dp": lambda: _both("rwkv", rec=RWKV, n_kv_heads=1,
                                    head_dim=8, sub_quadratic=True,
                                    layout="dp", fsdp_params=True),
    "griffin_layout_dp": lambda: _both("hybrid", rec=GRIFFIN, n_layers=5,
                                       n_kv_heads=1, head_dim=8,
                                       sub_quadratic=True, layout="dp",
                                       fsdp_params=True),
}

_CACHE = {}


def _randomise_zeros(t, seed):
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and not a.any():
            return (rng.normal(size=a.shape) * 0.3).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(f, t)


def setup(name):
    """(jcfg, tcfg, jparams, numpy params, batch, decode tokens)."""
    if name not in _CACHE:
        jcfg, tcfg = CONFIGS[name]()
        # the port's draw (its tree is the reference's: test_torch_moe,
        # test_torch_arch_smoke), shared by both packages as numpy
        drawn = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        full = _randomise_zeros(tree.map(lambda t: t.numpy(), drawn), seed=7)
        rng = np.random.default_rng(5)
        toks = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        steps = rng.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)
        _CACHE[name] = (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, full),
                        full, batch, steps)
    return _CACHE[name]


def _ref_all(jcfg, jparams, tokens, steps):
    """forward's logits, aux and z, and the decode logits after a prefill,
    of the reference's single path: one jitted function per config and
    shape (its prefill logits are its forward's)."""
    fo = japi.forward(jcfg, jparams, tokens)
    out = {"logits": fo.logits, "aux": fo.aux_loss, "z": fo.z_loss}
    _, cache = japi.prefill(jcfg, jparams, tokens, MAX_LEN)

    def step(cache, tok):
        lg, cache = japi.decode_step(jcfg, jparams, tok, cache)
        return cache, lg
    out["decode"] = jnp.moveaxis(jax.lax.scan(step, cache, steps.T)[1], 0, 1)
    return out


_REF_ALL = jax.jit(_ref_all, static_argnums=0)


def _loss(jcfg, out, labels):
    """The reference's ``loss_fn`` from its forward's outputs, in f64."""
    lg = np.asarray(out["logits"], np.float64)
    lz = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) \
        + lg.max(-1)
    gold = np.take_along_axis(lg, labels[..., None].astype(np.int64),
                              -1)[..., 0]
    loss = np.mean(lz - gold)
    if jcfg.moe is not None:
        loss += jcfg.moe.aux_loss * float(out["aux"]) \
            + jcfg.moe.router_z_loss * float(out["z"])
    return loss


def reference(jcfg, jparams, batch, steps, n_shards):
    """The reference's single path on each of ``n_shards`` row slices (the
    sharding hints, which the single path ignores, set to their defaults,
    so that configs differing only there share one compile)."""
    jcfg = dataclasses.replace(jcfg, seq_shard=False, fsdp_params=False,
                               layout="tp")
    outs = []
    for rows in np.array_split(np.arange(B), n_shards):
        out = jax.device_get(_REF_ALL(jcfg, jparams,
                                      jnp.asarray(batch["tokens"][rows]),
                                      jnp.asarray(steps[rows])))
        out["loss"] = _loss(jcfg, out, batch["labels"][rows])
        out["prefill"] = out["logits"]
        outs.append(out)
    return {k: (np.mean([o[k] for o in outs]) if k in ("loss", "aux", "z")
                else np.concatenate([o[k] for o in outs])) for k in outs[0]}


def _batch_index(rank, shape, axes, batch_axes):
    """The batch slice a rank holds: its position over ``batch_axes``."""
    coords = dict(zip(axes, np.unravel_index(rank, shape)))
    idx = 0
    for a in batch_axes:
        idx = idx * shape[axes.index(a)] + int(coords[a])
    return idx


def _rows(res, shape, axes, batch_axes):
    """The ranks' results in batch order (the first rank holding each
    slice); every rank holding a slice holds the same logits bit for
    bit."""
    first = {}
    for r, out in enumerate(res):
        i = _batch_index(r, shape, axes, batch_axes)
        if i not in first:
            first[i] = out
        for k in ("logits", "prefill", "decode", "loss"):
            np.testing.assert_array_equal(out[k], first[i][k])
    return {k: np.concatenate([first[i][k] for i in sorted(first)])
            for k in ("logits", "prefill", "decode")}, len(first)


def _normwise(got, want):
    return float(np.linalg.norm((np.asarray(got, np.float64)
                                 - np.asarray(want, np.float64)).ravel())
                 / np.linalg.norm(np.asarray(want, np.float64).ravel()))


TOLS = {"dense": 1e-5, "moe": 1e-4}

POD = ("pod", "data", "model")
CASES = {
    # name: (config, mesh shape, axes, dp axes, activation-batch axes)
    # (1, 4): q's 4 heads split over the axis, the 2 KV heads replicated
    "dense-1x2": ("dense", (1, 2), AXES, ("data",), None),
    "dense-2x2": ("dense", (2, 2), AXES, ("data",), None),
    "dense-1x4": ("dense", (1, 4), AXES, ("data",), None),
    "dense-2x1x2-pod": ("dense", (2, 1, 2), POD, ("pod", "data"), None),
    "dense-2x2-batch_replicated": ("dense", (2, 2), AXES, ("data",), ()),
    "dense_layout_dp-2x2": ("dense_layout_dp", (2, 2), AXES,
                            ("data", "model"), None),
    "dense_seq-1x2": ("dense_seq", (1, 2), AXES, ("data",), None),
    "dense_seq-1x4": ("dense_seq", (1, 4), AXES, ("data",), None),
    "dense_flash-1x2": ("dense_flash", (1, 2), AXES, ("data",), None),
    "mixtral-1x2": ("mixtral", (1, 2), AXES, ("data",), None),
    "kimi-2x2": ("kimi", (2, 2), AXES, ("data",), None),
    "etp_drops_w8a8-2x2": ("etp_drops_w8a8", (2, 2), AXES, ("data",), None),
    "rwkv-2x2": ("rwkv", (2, 2), AXES, ("data",), None),
    "rwkv-1x4": ("rwkv", (1, 4), AXES, ("data",), None),
    "griffin-2x2": ("griffin", (2, 2), AXES, ("data",), None),
    "griffin-1x2": ("griffin", (1, 2), AXES, ("data",), None),
    # (1, 4): griffin's 4 q heads, its width and d_ff split 4 ways
    "griffin-1x4": ("griffin", (1, 4), AXES, ("data",), None),
    "rwkv_layout_dp-2x2": ("rwkv_layout_dp", (2, 2), AXES,
                           ("data", "model"), None),
    "griffin_layout_dp-2x2": ("griffin_layout_dp", (2, 2), AXES,
                              ("data", "model"), None),
}


# the step builders (prefill, decode, eval) under a ctx, once per family
BUILDERS = {"dense-2x2", "mixtral-1x2", "rwkv-2x2"}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_paths_match_reference(pool, case):
    name, shape, axes, dp, batch_axes = CASES[case]
    jcfg, tcfg, jparams, full, batch, steps = setup(name)
    bax = dp if batch_axes is None else batch_axes
    n_shards = math.prod(shape[axes.index(a)] for a in bax)
    res = pool.run(cases.model_run, shape, axes,
                   (tcfg, full, batch, steps, MAX_LEN, dp, batch_axes,
                    case in BUILDERS))
    want = reference(jcfg, jparams, batch, steps,
                     n_shards if tcfg.moe is not None else 2)
    got, n = _rows(res, shape, axes, bax)
    assert n == n_shards
    if tcfg.family != "transformer":
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    else:
        tol = TOLS["moe" if tcfg.moe is not None else "dense"]
        for k in got:
            assert _normwise(got[k], want[k]) <= tol, k
    np.testing.assert_allclose(res[0]["loss"], want["loss"], rtol=2e-5)
    for r in res:
        if case in BUILDERS:
            assert r["steps_agree"]
            np.testing.assert_array_equal(r["eval_ce"], r["loss"])
    if tcfg.family == "transformer":
        # the KV cache's time dim over the model axis (unless it is folded
        # into dp), its batch this rank's
        T = min(MAX_LEN, tcfg.swa_window or MAX_LEN)
        t_split = 1 if "model" in dp else shape[-1]
        assert res[0]["cache_shapes"][0] == [
            tcfg.n_layers, B // n_shards, T // t_split, tcfg.n_kv_heads,
            tcfg.head_dim]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_int8_kv_cache_sharded_in_time(pool, shape):
    """The int8 KV cache's pages and scales split over the model axis in
    time, against the port's unsharded int8 cache (which
    ``test_torch_kv_int8.py`` holds against the reference on exact
    pages): the prefill and the first decode step, whose merge of the
    exact int8 q·k scores is the only new arithmetic, within 1e-5
    normwise.  A later step reads the rows the earlier steps quantized from
    float inputs that the sharded sums move by an ulp, and one int8 level
    of such a row may flip (a level is 1/127 of the row's scale): within
    1e-3."""
    _, tcfg, _, full, batch, steps = setup("dense_int8kv")
    res = pool.run(cases.model_run, shape, AXES,
                   (tcfg, full, batch, steps, MAX_LEN, ("data",)))
    got, _ = _rows(res, shape, AXES, ("data",))
    params = tree.map(lambda a: torch.from_numpy(np.array(a)), full)
    with torch.no_grad():
        lg, cache = tapi.prefill(tcfg, params,
                                 torch.from_numpy(batch["tokens"]), MAX_LEN)
        dec = []
        for i in range(STEPS):
            d, cache = tapi.decode_step(tcfg, params,
                                        torch.from_numpy(steps[:, i]), cache)
            dec.append(d.numpy())
    assert cache.k.dtype == torch.int8
    assert _normwise(got["prefill"], lg.numpy()) <= 1e-5
    assert _normwise(got["decode"][:, 0], dec[0]) <= 1e-5
    for i in range(1, STEPS):
        assert _normwise(got["decode"][:, i], dec[i]) <= 1e-3


WITNESS = [("dense", (2, 2)), ("kimi", (1, 4)), ("etp", (2, 2))]


@pytest.mark.parametrize("name,shape", WITNESS,
                         ids=[f"{n}-{a}x{b}" for n, (a, b) in WITNESS])
def test_float64_witness(pool, name, shape):
    """In float64 the sharded path is the unsharded one up to the order of
    its sums: within 1e-12 (chunked attention)."""
    _, tcfg, _, full, batch, steps = setup(name)
    tcfg = dataclasses.replace(tcfg, compute_dtype="float64",
                               param_dtype="float64")
    full = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype.kind == "f" else a, full)
    res = pool.run(cases.model_run, shape, AXES,
                   (tcfg, full, batch, steps, MAX_LEN, ("data",)))
    got = _rows(res, shape, AXES, ("data",))[0]
    params = tree.map(lambda a: torch.from_numpy(np.array(a)), full)
    for rows in np.array_split(np.arange(B), shape[0]):
        tok = torch.from_numpy(batch["tokens"][rows])
        with torch.no_grad():
            want = tapi.forward(tcfg, params, tok).logits.numpy()
            lg, cache = tapi.prefill(tcfg, params, tok, MAX_LEN)
            dec = []
            for i in range(STEPS):
                d, cache = tapi.decode_step(
                    tcfg, params, torch.from_numpy(steps[rows, i]), cache)
                dec.append(d)
        for k, w in (("logits", want), ("prefill", lg.numpy()),
                     ("decode", torch.stack(dec, 1).numpy())):
            assert _normwise(got[k][rows], w) <= 1e-12, k


FFN = [("dense_w8a8_fsdp", (1, 2), False, True),
       ("dense_w8a8_fsdp", (1, 4), False, True),
       ("dense", (1, 4), False, False),
       ("mixtral", (1, 2), True, True),
       ("mixtral_w8a8", (1, 4), True, True),
       ("etp_w8a8", (1, 4), True, True),
       ("kimi", (1, 4), True, False)]


@pytest.mark.parametrize("name,shape,moe,exact", FFN,
                         ids=[f"{n}-{a}x{b}" for n, (a, b), _, _ in FFN])
def test_ffn_under_tensor_parallelism(pool, name, shape, moe, exact):
    """One layer's FFN on the model axis's shards against the unsharded
    FFN on the same input: bit for bit under W8A8 (the absmax made global,
    the int32 sums exact) and for the f32 top-2 combine (at most two
    nonzero partials per token); within 1e-5 normwise where f32 sums are
    split (the dense FFN's rows, kimi's eight choices)."""
    _, tcfg, _, full, _, _ = setup(name)
    x = np.random.default_rng(9).standard_normal(
        (2, 8, tcfg.d_model)).astype(np.float32)
    res = pool.run(cases.ffn_case, shape, AXES,
                   (tcfg, full, x, ("data",), moe))
    for r in res:
        if exact:
            assert r["equal"]
        else:
            assert _normwise(r["got"], r["want"]) <= 1e-5
        np.testing.assert_array_equal(r["got"], res[0]["got"])


@pytest.mark.parametrize("name", ["dense", "dense_seq", "dense_flash",
                                  "dense_w8a8_fsdp", "dense_int8kv",
                                  "mixtral", "kimi", "etp_drops_w8a8", "rwkv",
                                  "griffin"])
def test_one_rank_mesh_is_the_unsharded_path_bit_for_bit(pool, name):
    """On a (1, 1) mesh every collective is a copy: forward, loss, prefill
    and decode logits torch.equal to ``ctx=None`` (what ``chip_smoke.py``
    holds on the card under NCCL)."""
    _, tcfg, _, full, batch, steps = setup(name)
    res = pool.run(cases.world_one, (1, 1), AXES,
                   (tcfg, full, batch, steps, MAX_LEN))
    assert res[0] == {k: True for k in res[0]}


# ------------------------------------- chip_smoke.py's derived collectives

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COUNT_CASES = {                     # registry name, changes to reduced()
    "mixtral-w8a8": ("mixtral-8x7b", dict(quant="w8a8_ffn")),
    "mixtral": ("mixtral-8x7b", dict()),
    "mixtral-remat-full": ("mixtral-8x7b", dict(remat="full")),
    "qwen3-w8a8": ("qwen3-0.6b", dict(quant="w8a8_ffn")),
    "qwen3": ("qwen3-0.6b", dict()),
    "kimi-adafactor": ("kimi-k2-1t-a32b", dict()),
    "command-r": ("command-r-plus-104b", dict()),
}


def _derived_and_counted(pool, case, model):
    import types
    from repro_torch.configs import registry
    from repro_torch.models.config import reduced
    from repro_torch.parallel.sharding import param_specs
    name, kw = COUNT_CASES[case]
    full = registry.get(name)
    cfg = dataclasses.replace(
        reduced(full), **{"fsdp_params": full.fsdp_params, "remat":
                          full.remat, "compute_dtype": "float32",
                          "n_layers": 2, **kw})
    mesh = types.SimpleNamespace(shape={"data": 1, "model": model})
    specs = param_specs(cfg, tapi.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"),
        ("data",), "model", mesh)
    smoke = _chip_smoke()
    steps = 3 if model == 1 else 4     # the cache's 24 + steps slots split
    got = pool.run(cases.collective_counts_case, (1, model), AXES,
                   (cfg, 0, steps))[0]
    want = {"prefill": smoke._shard_collectives(cfg, "prefill", specs,
                                                model=model),
            "decode": smoke._shard_collectives(cfg, "decode", specs,
                                               calls=steps, model=model)}
    if cfg.quant == "none":
        want["train"] = smoke._shard_collectives(cfg, "train", specs,
                                                 model=model)
    return got, want


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_chip_smoke_derives_the_collective_counts(pool, case):
    """``chip_smoke.py``'s phase_shard checks the collectives of each
    sharded path on a one-rank NCCL group against ``_shard_collectives``,
    derived from the spec table and the code's sums: the same derivation
    against the counts of a prefill, decode steps and a train step on a
    one-rank gloo group, for configs beside the smoke's own (remat, shared
    experts, Adafactor, biases, an untied head), with FSDP as each
    config's own."""
    got, want = _derived_and_counted(pool, case, 1)
    assert got == want


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_chip_smoke_derives_the_collective_counts_vocab_split(pool, case):
    """The same derivation on a (1, 4) mesh of gloo ranks, where the
    vocabulary is split over the model axis (the embedding's all-reduce,
    the loss's local head and its three CE sums with their adjoints), q
    heads are local and KV heads are not (4 and 2 heads), the experts are
    in ``ep`` and decode attention reduces over four time shards: the
    rule ``chip_smoke.py``'s fake (1, 16) qwen3-0.6b train cell is held
    to on the card."""
    got, want = _derived_and_counted(pool, case, 4)
    assert got == want
