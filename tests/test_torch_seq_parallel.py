"""Sequence parallelism under ``cfg.seq_shard``, as the reference's
``seq_sp`` lays it out (``repro.models.transformer.forward``): the stream
between transformer blocks stays on this rank's S/m rows of the model
axis in a training ``forward`` (``Sharded.seq_split``).

* (a) ``forward``, ``loss_fn`` and the gradients under ``seq_shard`` on
  meshes (1, 4) and (2, 2) of gloo ranks against the reference's single
  path on the same numpy inputs (per dp shard for the MoE, whose
  capacity the local token count sets): dense GQA (4 q, 2 KV heads:
  the q heads local and the KV heads not at (1, 4), both at (2, 2)), the
  W8A8 FFN (forward and loss) and mixtral-style top-2 ``ep`` MoE under
  FSDP (6 q heads, which the 4-way axis does not divide), kimi-style
  top-8 with a shared expert.  Tolerances, the port's existing ones:
  logits 1e-5 (dense) and 1e-4 (MoE) normwise, the loss 2e-5 relative,
  each gradient leaf within 2e-4 of ``jax.value_and_grad``'s
  (``test_torch_arch_smoke.py``); every MoE layer routes the B·S tokens of
  its dp shard, and the top-2 routing maps equal the reference's
  ``_local_route`` on those tokens exactly.
* (b) only S/m rows a rank are kept between blocks: every (B, s, d)
  activation that autograd saves through the loss's graph (counted with
  ``saved_tensors_hooks``: under remat, each block's input and the final
  norm's) has s = S/m, 1/m of the bytes that ``seq_shard`` off keeps.
* (c) the reduced command-r-plus-104b train cell (seq 128, batch 4; 2
  and 6 layers) keeps at most 0.30 of axis 1's per-layer temp bytes a
  rank at model axis 4 with ``seq_shard`` on (the port's dry-run on
  meta; the stream whole on every rank kept 0.886); the reference's own
  ratio, from its GSPMD compile on 4 host devices with ``Auto`` mesh axes
  in a subprocess, is printed beside it (``-s``).
* (d) ``prefill`` and a decode step under ``seq_shard`` keep the whole
  sequence (no reduce-scatter, as the reference's ``prefill`` has no
  ``seq_sp``) and match the reference within the same tolerances.
* (e) with ``seq_shard`` off, and with ``ctx=None`` (``seq_shard`` on or
  off), the logits, loss, gradients, prefill and decode logits are the
  implementation's before the layout bit for bit: their SHA-256 digests
  in ``tests/data/seq_parallel_parent.json``, written by ``python
  tests/test_torch_seq_parallel.py --write-parent`` on that
  implementation.

The ranks are one pool of 4 spawned processes.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro.models import api as japi
from repro.models import transformer as jtfm
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.models import api as tapi
from repro_torch.models.config import SHAPES, reduced
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.config import MoEConfig as TMoEConfig

jax.config.update("jax_platform_name", "cpu")

AXES = ("data", "model")
MESHES = [(1, 4), (2, 2)]
B, S, MAX_LEN = 4, 16, 20
TOLS = {"dense": 1e-5, "moe": 1e-4}
LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
RATIO_MAX = 0.30
RATIO_LAYERS = (6, 2)
PARENT = pathlib.Path(__file__).parent / "data" / "seq_parallel_parent.json"

_REFERENCE_RATIO = r"""
import json, os
os.environ["REPRO_XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, jax
from jax.sharding import AxisType
from repro.configs import registry
from repro.launch import dryrun
from repro.models.config import SHAPES, reduced
base = dataclasses.replace(reduced(registry.get("command-r-plus-104b")),
                           seq_shard=True)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=4)
temp = {}
for n in (6, 2):
    cfg = dataclasses.replace(base, n_layers=n)
    for m in (1, 4):
        mesh = jax.make_mesh((1, m), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:m])
        fn, args = dryrun.build_cell(cfg, shape, mesh)
        temp[f"{n},{m}"] = \
            fn.lower(*args).compile().memory_analysis().temp_size_in_bytes
print(json.dumps(temp))
"""


@pytest.fixture(scope="module")
def pool():
    p = cases.Pool(4)
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def reference_temp():
    """The reference's compiles in a subprocess, started first so that it
    runs beside the file's other tests."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_RATIO],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _both(moe=None, **kw):
    base = dict(name="t", family="transformer", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
                head_dim=16, compute_dtype="float32", remat="full")
    base.update(kw)
    j, t = dict(base), dict(base)
    if moe is not None:
        m = dict(n_experts=4, top_k=2, d_expert=16, n_dense_layers=1,
                 capacity_factor=8.0)
        m.update(moe)
        j["moe"], t["moe"] = JMoEConfig(**m), TMoEConfig(**m)
    return JArchConfig(**j), TArchConfig(**t)


CONFIGS = {
    "gqa": lambda: _both(),
    "w8a8": lambda: _both(quant="w8a8_ffn", fsdp_params=True),
    # six q heads: the 4-way model axis does not divide them, the 2-way
    # one does (and its 2 KV heads)
    "mixtral": lambda: _both(moe=dict(n_dense_layers=0), fsdp_params=True,
                             n_heads=6),
    "kimi": lambda: _both(moe=dict(n_experts=16, top_k=8,
                                   n_shared_experts=1)),
}
_SETUP = {}


def setup(name):
    """(jcfg, tcfg, jparams, numpy params, batch): the port's seeded draw
    (its tree is the reference's), the zero leaves drawn too."""
    if name not in _SETUP:
        jcfg, tcfg = CONFIGS[name]()
        drawn = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        rng = np.random.default_rng(7)

        def f(a):
            if a.dtype.kind == "f" and not a.any():
                return (rng.normal(size=a.shape) * 0.3).astype(a.dtype)
            return a
        full = tree.map(lambda t: f(t.numpy()), drawn)
        toks = np.random.default_rng(5).integers(
            0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        _SETUP[name] = (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, full),
                        full, batch)
    return _SETUP[name]


def _ref_one(jcfg, params, tokens, labels, grads):
    """The reference's single path on one row slice: logits (its
    prefill's, which are its forward's), loss (and its gradients), and the
    decode logits after the prefill."""
    def loss(p):
        out = japi.loss_fn(jcfg, p, {"tokens": tokens, "labels": labels})
        return out[0]
    out = {}
    if grads:
        out["loss"], out["grads"] = jax.value_and_grad(loss)(params)
    else:
        out["loss"] = loss(params)
    out["logits"], cache = japi.prefill(jcfg, params, tokens, MAX_LEN)
    out["decode"] = japi.decode_step(jcfg, params, tokens[:, 0], cache)[0]
    return out


_REF_ONE = jax.jit(_ref_one, static_argnums=(0, 4))


def reference(jcfg, jparams, batch, n_shards, grads):
    """``_ref_one`` per dp shard of the batch (the MoE's capacity is the
    local token count's), the loss and gradients the shards' mean."""
    jcfg = dataclasses.replace(jcfg, seq_shard=False)
    outs = [jax.device_get(_REF_ONE(jcfg, jparams,
                                    jnp.asarray(batch["tokens"][rows]),
                                    jnp.asarray(batch["labels"][rows]),
                                    grads))
            for rows in np.array_split(np.arange(len(batch["tokens"])),
                                       n_shards)]
    want = {k: np.concatenate([o[k] for o in outs])
            for k in ("logits", "decode")}
    want["loss"] = np.mean([o["loss"] for o in outs])
    if grads:
        want["grads"] = jax.tree_util.tree_map(
            lambda *g: np.mean(g, axis=0), *[o["grads"] for o in outs])
    return want


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm((got - want).ravel())
                 / np.linalg.norm(want.ravel()))


def _by_shard(res, shape, key):
    """``key`` of each dp shard's first rank, in batch order; every model
    rank of a shard holds the same value bit for bit."""
    nm = shape[1]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out[key], res[r - r % nm][key])
    return np.concatenate([res[d * nm][key] for d in range(shape[0])])


def _run(pool, name, shape, seq, prefill=True, batch=None):
    _, tcfg, _, full, drawn = setup(name)
    tcfg = dataclasses.replace(tcfg, seq_shard=seq)
    batch = drawn if batch is None else batch
    return pool.run(cases.seq_case, shape, AXES,
                    (tcfg, full, batch, ("data",),
                     MAX_LEN if prefill else None))


SEQ_CASES = [(n, s) for n in CONFIGS for s in MESHES]


@pytest.mark.parametrize("name,shape", SEQ_CASES,
                         ids=[f"{n}-{a}x{b}" for n, (a, b) in SEQ_CASES])
def test_seq_parallel_matches_reference(pool, name, shape):
    """(a) and (d): forward, loss, gradients, routes, prefill and decode
    under ``seq_shard`` against the reference's single path."""
    jcfg, tcfg, jparams, full, batch = setup(name)
    moe = tcfg.moe is not None
    grads = tcfg.quant == "none"
    if moe and shape[0] == 1:   # 2 rows a dp shard at either mesh: one
        batch = {k: v[:B // 2] for k, v in batch.items()}   # compile
    with concurrent.futures.ThreadPoolExecutor(1) as ex:  # beside the ranks
        ref = ex.submit(reference, jcfg, jparams, batch,
                        shape[0] if moe else 1, grads)
        res = _run(pool, name, shape, True, batch=batch)
        want = ref.result()
    tol = TOLS["moe" if moe else "dense"]
    for key, wkey in (("logits", "logits"), ("prefill", "logits"),
                      ("decode", "decode")):
        assert _normwise(_by_shard(res, shape, key), want[wkey]) <= tol, key
    for r in res:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
        # the forward kept the stream on the rows; the prefill did not
        assert r["fwd_counts"]["reduce_scatter"] > 0
        assert r["prefill_counts"]["reduce_scatter"] == 0
    if grads:
        wgrads = dict(tree.leaves_with_paths(want["grads"]))
        for path, g in tree.leaves_with_paths(res[0]["grads"]):
            np.testing.assert_allclose(g, np.asarray(wgrads.pop(path)),
                                       **GRAD_TOL, err_msg=str(path))
        assert not wgrads
    if moe:
        n_moe = tcfg.n_layers - tcfg.moe.n_dense_layers
        rows = len(batch["tokens"]) // shape[0] * S
        for r in res:
            assert len(r["routes"]) == n_moe
            for route in r["routes"]:
                assert route["h"].shape[0] == rows   # the whole sequence
                if tcfg.moe.top_k != 2:
                    continue
                jg, _, jfilled, _, _ = jtfm._local_route(
                    jnp.asarray(route["h"]), jnp.asarray(route["router"]),
                    jcfg.moe, route["e_lo"], route["E_loc"], route["cap"])
                np.testing.assert_array_equal(route["gather_idx"],
                                              np.asarray(jg))
                np.testing.assert_array_equal(route["filled"],
                                              np.asarray(jfilled))


def test_only_this_ranks_rows_are_kept_between_blocks(pool):
    """(b): the (B, s, d) activations the loss's graph keeps, by shape,
    with ``seq_shard`` on and off at (1, 4), for kimi-style blocks (a
    dense layer, then a MoE layer with a shared expert)."""
    _, tcfg, _, _, _ = setup("kimi")
    on = _run(pool, "kimi", (1, 4), True, prefill=False)
    off = _run(pool, "kimi", (1, 4), False, prefill=False)
    for r_on, r_off in zip(on, off):
        assert r_on["saved"] and r_off["saved"]
        assert {tuple(s) for s, _ in r_on["saved"]} == {(B, S // 4, 32)}
        assert {tuple(s) for s, _ in r_off["saved"]} == {(B, S, 32)}
        # each block's input (remat) and the final norm's, a quarter each
        assert len(r_on["saved"]) == len(r_off["saved"]) >= tcfg.n_layers
        assert 4 * sum(b for _, b in r_on["saved"]) == \
            sum(b for _, b in r_off["saved"])


def _layer_temp(n_layers, m):
    cfg = dataclasses.replace(reduced(registry.get("command-r-plus-104b")),
                              n_layers=n_layers, seq_shard=True)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128,
                                global_batch=4)
    return dryrun.run_cell_fake(cfg, shape, (1, m))[
        "memory_analysis"]["temp_size_in_bytes"]


def test_dry_run_keeps_a_quarter_of_the_stream(reference_temp):
    """(c): the per-layer temp bytes a rank of the reduced command-r cell
    at model axis 4 over axis 1 with ``seq_shard`` on, at most RATIO_MAX
    (the stream whole on every rank kept 0.886)."""
    hi, lo = RATIO_LAYERS
    t = {(n, m): _layer_temp(n, m) for n in RATIO_LAYERS for m in (1, 4)}
    ratio = (t[hi, 4] - t[lo, 4]) / (t[hi, 1] - t[lo, 1])
    out, err = reference_temp.communicate(timeout=300)
    assert reference_temp.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    ref_ratio = (ref[f"{hi},4"] - ref[f"{lo},4"]) / \
        (ref[f"{hi},1"] - ref[f"{lo},1"])
    print(f"per-layer temp kept per rank at model axis 4, seq_shard on: "
          f"port {ratio:.4f} ({t}), reference {ref_ratio:.4f} ({ref})")
    assert ratio <= RATIO_MAX, ratio


# ------------------------------------- chip_smoke.py's derived collectives


def _chip_smoke():
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COUNT_CASES = ["command-r-plus-104b", "mixtral-8x7b", "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("arch", COUNT_CASES)
def test_chip_smoke_derives_the_seq_parallel_collectives(pool, arch):
    """``chip_smoke._shard_collectives(..., model=4, seq_len=16)`` against
    the collectives counted in a prefill, decode steps and a train step of
    16 positions under ``seq_shard`` on a (1, 4) mesh (reduced configs at
    2 layers with each model's own FSDP, remat and optimizer): the rule
    the card's seq-parallel cell is held to."""
    import types
    from repro_torch.parallel.sharding import param_specs
    full = registry.get(arch)
    cfg = dataclasses.replace(
        reduced(full), fsdp_params=full.fsdp_params, remat=full.remat,
        compute_dtype="float32", n_layers=2, seq_shard=True)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 4})
    specs = param_specs(cfg, tapi.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"),
        ("data",), "model", mesh)
    smoke = _chip_smoke()
    got = pool.run(cases.collective_counts_case, (1, 4), AXES,
                   (cfg, 0, 4))[0]
    want = {"prefill": smoke._shard_collectives(cfg, "prefill", specs,
                                                model=4),
            "decode": smoke._shard_collectives(cfg, "decode", specs,
                                               calls=4, model=4),
            "train": smoke._shard_collectives(cfg, "train", specs,
                                              model=4, seq_len=16)}
    assert got == want
    assert got["train"]["reduce_scatter"] > 0


# ------------------------------------------ (e) the parent, bit for bit


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _digests(out) -> dict:
    return {tree.path_str(p): _digest(v) for p, v in
            tree.leaves_with_paths({k: out[k] for k in (
                "logits", "loss", "grads", "prefill", "decode")})}


PARENT_CASES = [("gqa", (1, 4)), ("gqa", (2, 2)), ("kimi", (2, 2))]


def _unsharded(pool, name, seq):
    """``ctx=None`` on one rank (one intra-op thread: the MoE's backward
    sums its scatters in a fixed order there)."""
    _, tcfg, _, full, batch = setup(name)
    tcfg = dataclasses.replace(tcfg, seq_shard=seq)
    return pool.run(cases.unsharded_case, (1, 1), AXES,
                    (tcfg, full, batch, MAX_LEN))[0]


def _parent_digests(pool):
    """The digests (e) holds: each case's ranks with ``seq_shard`` off,
    and ``ctx=None``."""
    got = {}
    for name, shape in PARENT_CASES:
        for r, out in enumerate(_run(pool, name, shape, False)):
            got[f"{name}-{shape[0]}x{shape[1]}/rank{r}"] = _digests(out)
    for name in ("gqa", "kimi"):
        got[f"{name}-ctx_none"] = _digests(_unsharded(pool, name, False))
    return got


def test_seq_shard_off_and_no_ctx_are_the_parent_bit_for_bit(pool):
    """(e)"""
    want = json.loads(PARENT.read_text())
    assert _parent_digests(pool) == want
    # no ctx: the layout does not apply
    assert _digests(_unsharded(pool, "gqa", True)) == want["gqa-ctx_none"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-parent"]:
        sys.exit("usage: python tests/test_torch_seq_parallel.py "
                 "--write-parent")
    p = cases.Pool(4)
    try:
        PARENT.write_text(json.dumps(_parent_digests(p), indent=1,
                                     sort_keys=True) + "\n")
    finally:
        p.close()
