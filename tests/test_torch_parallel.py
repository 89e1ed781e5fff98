"""The port's parallel layer held against the reference: the collectives
(``tests/test_collectives.py``) on 8 gloo ranks against the native
``all_gather`` / ``all_reduce``, the sharding specs as data
(``param_specs`` as ``test_w8a8.py::
test_w8a8_sharding_specs_cover_quant_params`` checks them, for every
registry name, ``cache_specs``, ``train_state_specs``), ``local_slices``
against ``NamedSharding.devices_indices_map`` on 8 fake jax devices,
``shard_batch``, ``replicated_vote`` and the elastic restore
(``test_checkpoint.py::test_elastic_restore_new_mesh``), and the SPMD
runner's refusals and deadlines.

The ranks are one pool of 8 spawned processes for the whole file
(``launch.mesh.SpmdPool``); their bodies live in ``torch_spmd_cases``,
which imports no jax.  Collectives move bits: their results are held
bit for bit, the bf16 reduction to the native bf16 reduction's bits.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro.configs import registry as jregistry
from repro.core import redundancy as jred
from repro.models import api as japi
from repro.models.config import reduced as jreduced
from repro.parallel import sharding as jshd
from repro.train import steps as jsteps
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.models.config import reduced as treduced
from repro_torch.parallel import sharding as tshd
from repro_torch.train import steps as tsteps

jax.config.update("jax_platform_name", "cpu")

NAMES = ("smollm-135m", "qwen3-0.6b", "command-r-plus-104b", "llama3-405b",
         "mixtral-8x7b", "kimi-k2-1t-a32b", "musicgen-large",
         "llava-next-34b", "rwkv6-1.6b", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def pool():
    p = cases.Pool(8)
    yield p
    p.close()


def test_registry_names_are_the_reference_ten():
    assert set(NAMES) == set(jregistry.names()) == set(tregistry.names())


# ------------------------------------------------------------- collectives


@pytest.fixture(scope="module")
def coll(pool):
    return pool.run(cases.collectives, (2, 4), ("data", "model"))


AXES = ("model", "data", "data+model")


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("kind", ["ring", "rs", "a2a"])
def test_collective_equals_native(coll, kind, axes):
    for rank, res in enumerate(coll):
        got, want = res[f"{kind}/{axes}"]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("axes", AXES)
def test_grad_allreduce_bf16_equals_native_bf16_sum(coll, axes):
    for res in coll:
        for got, want, dtype in res[f"bf16/{axes}"]:
            np.testing.assert_array_equal(got, want)
        assert [d for _, _, d in res[f"bf16/{axes}"]] == ["torch.float64",
                                                          "torch.float32"]


def test_collective_counts(coll):
    """The ring takes N − 1 hops per call; each kind is counted per call
    reaching torch.distributed."""
    sizes = {"model": 4, "data": 2, "data+model": 8}
    for res in coll:
        for axes, n in sizes.items():
            assert res[f"ring_hops/{axes}"] == n - 1
        assert res["counts"] == {"all_reduce": 6, "all_gather": 0,
                                 "reduce_scatter": 3, "all_to_all": 3,
                                 "send_recv": 3 + 1 + 7}


# ------------------------------------------------------------------ specs


_ABSTRACT = {}


def _abstract(jcfg):
    key = repr(jcfg)
    if key not in _ABSTRACT:
        _ABSTRACT[key] = jax.eval_shape(
            lambda: japi.init_params(jcfg, jax.random.key(0)))
    return _ABSTRACT[key]


def _cfgs(name, **kw):
    return (dataclasses.replace(jreduced(jregistry.get(name)), **kw),
            dataclasses.replace(treduced(tregistry.get(name)), **kw))


def _ref_flat(specs):
    flat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(p.key) for p in path): tuple(s) for path, s in flat}


def _port_flat(specs):
    return {tree.path_str(path): tuple(s)
            for path, s in tree.leaves_with_paths(specs)}


class _FakeMesh:
    """What ``param_specs`` reads of a mesh: the model axis's size."""

    def __init__(self, model):
        self.shape = {"data": 2, "model": model}


VARIANTS = {
    # (config overrides, dp axes, model-axis size): E = 4 experts at
    # reduced() are EP on a 2-way axis and expert-TP on a 3-way one
    "ep": ({}, ("data",), 2),
    "etp": ({}, ("data",), 3),
    "w8a8_multipod": ({"quant": "w8a8_ffn"}, ("pod", "data"), 2),
    "layout_dp": ({"layout": "dp"}, ("data", "model"), 2),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_reference(name, variant):
    kw, dp, msize = VARIANTS[variant]
    jcfg, tcfg = _cfgs(name, **kw)
    want = _ref_flat(jshd.param_specs(jcfg, _abstract(jcfg), dp, "model",
                                      mesh=_FakeMesh(msize)))
    tparams = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    got = _port_flat(tshd.param_specs(tcfg, tparams, dp, "model",
                                      mesh=_FakeMesh(msize)))
    assert got == want
    # the specs cover every leaf, the W8A8 ones included
    assert set(got) == {tree.path_str(p) for p, _ in
                        tree.leaves_with_paths(tparams)}


def _cache_fields(specs):
    return [None if s is None else tuple(s) for s in specs]


@pytest.mark.parametrize("dp", [("data",), ("pod", "data"), ()],
                         ids=["data", "pod_data", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_reference(name, dp):
    """Field by field; the port's GriffinCache.length is a (B,) vector
    (a difference by design), so its spec is the batch's."""
    jcfg, tcfg = _cfgs(name)
    want = _cache_fields(jshd.cache_specs(jcfg, dp, "model"))
    got = _cache_fields(tshd.cache_specs(tcfg, dp, "model"))
    if tcfg.family == "hybrid":
        assert want[-1] == () and got[-1] == tuple(tshd.P(dp or None))
        want, got = want[:-1], got[:-1]
    assert got == want


@pytest.mark.parametrize("dp", [("data",), ("pod", "data")])
def test_batch_specs_equal_reference(dp):
    assert tuple(tshd.batch_specs(dp)) == tuple(jshd.batch_specs(dp))


@pytest.mark.parametrize("name", ["smollm-135m", "mixtral-8x7b"])
def test_cache_specs_quant_kv_equal_reference(name):
    jcfg, tcfg = _cfgs(name, quant_kv=True)
    assert _cache_fields(tshd.cache_specs(tcfg, ("data",), "model")) == \
        _cache_fields(jshd.cache_specs(jcfg, ("data",), "model"))


@pytest.mark.parametrize("opt", ["adamw", "sgdm", "adafactor"])
@pytest.mark.parametrize("name", NAMES)
def test_train_state_specs_equal_reference(name, opt):
    jcfg, tcfg = _cfgs(name, fsdp_params=True)
    jspecs = jsteps.train_state_specs(jcfg, _abstract(jcfg), ("data",),
                                      "model", opt, mesh=_FakeMesh(2))
    tparams = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tspecs = tsteps.train_state_specs(tcfg, tparams, ("data",), "model", opt,
                                      mesh=_FakeMesh(2))
    assert tuple(tspecs.step) == tuple(jspecs.step) == ()
    for part in ("params", "opt_state"):
        assert _port_flat(getattr(tspecs, part)) == \
            _ref_flat(getattr(jspecs, part)), part


# ------------------------------------------------------------ placement


_SLICE_SCRIPT = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads(os.environ["SLICE_CASES"])
out = []
for shape, axes, spec, arr in cases:
    mesh = jax.make_mesh(tuple(shape), tuple(axes))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(arr))
    pos = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
    out.append([[list(pos[d.id]), [[s.start or 0, n if s.stop is None
                                    else s.stop] for s, n in zip(ix, arr)]]
                for d, ix in m.items()])
print(json.dumps(out))
"""

SLICE_CASES = [
    [(2, 2), ("data", "model"), ["data", "model"], (4, 6)],
    [(2, 2), ("data", "model"), [None, ["data", "model"]], (3, 8)],
    [(2, 2), ("data", "model"), ["model", None, "data"], (2, 5, 4)],
    [(1, 4), ("data", "model"), [None, "model"], (5, 8)],
    [(1, 4), ("data", "model"), [["data", "model"]], (12,)],
    [(1, 4), ("data", "model"), [], (3, 3)],
    [(2, 1, 2), ("pod", "data", "model"), [["pod", "data"], "model"], (6, 4)],
    [(2, 1, 2), ("pod", "data", "model"), ["model", None, "pod"], (2, 3, 8)],
    [(2, 1, 2), ("pod", "data", "model"), [["pod", "data", "model"]], (8,)],
]


@pytest.fixture(scope="module")
def jax_slices():
    env = dict(os.environ, SLICE_CASES=json.dumps(SLICE_CASES))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _SLICE_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(SLICE_CASES)))
def test_local_slices_equal_devices_indices_map(jax_slices, case):
    shape, axes, spec, arr = SLICE_CASES[case]
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)
    spec = tshd.P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    assert len(jax_slices[case]) == int(np.prod(shape))
    for pos, want in jax_slices[case]:
        rank = int(np.ravel_multi_index(pos, shape))
        got = tshd.local_slices(spec, arr, mesh, rank)
        assert [[s.start, s.stop] for s in got] == want, (pos, spec)


def test_shard_tree_refuses_an_undivided_dim():
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"), rank=0,
                                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match=r"blocks/wq.*model"):
        tshd.shard_tree({"blocks": {"wq": np.zeros((2, 8, 6))}},
                        {"blocks": {"wq": tshd.P(None, "data", "model")}},
                        mesh)


@pytest.mark.parametrize("shape,axes,dp", [
    ((2, 2), ("data", "model"), ("data",)),
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))])
def test_shard_batch_gives_each_rank_its_rows(pool, shape, axes, dp):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 99, (8, 5)).astype(np.int32),
             "embeds": rng.standard_normal((8, 5, 3)).astype(np.float32)}
    res = pool.run(cases.shard_batch_case, shape, axes, (batch, dp))
    n_dp = int(np.prod(shape[:-1]))
    for rank, got in enumerate(res):
        d = rank // shape[-1]              # position over the dp axes
        rows = slice(d * 8 // n_dp, (d + 1) * 8 // n_dp)
        for k in batch:
            np.testing.assert_array_equal(got[k], batch[k][rows])


def test_replicated_vote_outvotes_a_struck_rank(pool):
    arr = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    res = pool.run(cases.vote_case, (3,), ("replica",), (arr, 1))
    struck = arr.copy()
    struck.view(np.int32)[1, 2] ^= 1 << 30
    want = jred.vote([jnp.asarray(arr), jnp.asarray(struck),
                      jnp.asarray(arr)])
    for got in res:
        np.testing.assert_array_equal(got["y"], np.asarray(want))
        np.testing.assert_array_equal(got["y"], arr)
        np.testing.assert_array_equal(got["z"], arr[0] * 2)


def test_elastic_restore_new_mesh(pool, tmp_path):
    """Save under a (2, 1) mesh, restore onto (1, 2): every rank's shard is
    its slice of the saved leaf, and gathered the leaves are the saved
    ones bit for bit; the manifest holds the full shapes and the specs."""
    rng = np.random.default_rng(2)
    state = {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                        "b": rng.standard_normal((6,)).astype(np.float32)},
             "opt": {"m": rng.standard_normal((4, 6)).astype(np.float32)},
             "step": np.asarray(5, np.int32)}
    P = tshd.P
    specs = {"params": {"w": P("data", "model"), "b": P("model")},
             "opt": {"m": P("data", "model")}, "step": P()}
    axes = ("data", "model")
    pool.run(cases.save_case, (2, 1), axes, (state, specs, str(tmp_path)))
    manifest = json.loads(next(tmp_path.glob("step_*")).joinpath(
        "manifest.json").read_text())
    assert {e["path"]: (e["shape"], e["spec"]) for e in
            manifest["entries"]} == {
        "opt/m": ([4, 6], ["data", "model"]),
        "params/b": ([6], ["model"]), "params/w": ([4, 6], ["data", "model"]),
        "step": ([], [])}
    res = pool.run(cases.restore_case, (1, 2), axes, (specs, str(tmp_path)))
    flat = dict(tree.leaves_with_paths(state))
    for rank, r in enumerate(res):
        assert r["step"] == 5
        for path, leaf in tree.leaves_with_paths(r["full"]):
            np.testing.assert_array_equal(leaf, flat[path])
        w = r["local"]["params"]["w"]
        np.testing.assert_array_equal(
            w, state["params"]["w"][:, 3 * rank:3 * rank + 3])


# ------------------------------------------------------------- the runner


def test_mesh_refuses_a_shape_that_is_not_the_world(pool):
    res = pool.run(cases.mesh_refusals, (1, 2), ("data", "model"))
    for rank, r in enumerate(res):
        assert "holds 3 ranks, the process group 2" in r[0]
        assert "holds 256 ranks" in r[1]
        assert "differ in length" in r[2]
        assert r[3:] == [2, rank, ["data"]]


def test_spmd_refuses_nccl_without_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.spmd(cases.mesh_refusals, (2,), ("x",), device="cuda")


def test_spmd_raises_a_rank_error_with_its_traceback():
    with pytest.raises(RuntimeError, match=r"rank 1 failed:(.|\n)*"
                                           r"ValueError: rank one fails"):
        tmesh.spmd(cases.fail_on_rank_one, (2,), ("x",), device="cpu")


def test_spmd_kills_a_hung_rank_at_its_deadline():
    pool = tmesh.SpmdPool(2, "cpu", pg_timeout_s=5)
    procs = list(pool._procs)
    assert pool.run(cases.rank_of, (2,), ("x",)) == [0, 1]    # both started
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] gave no result"):
        pool.run(cases.hang_on_rank_one, (2,), ("x",), timeout_s=4)
    assert time.monotonic() - t0 < 30
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(cases.hang_on_rank_one, (2,), ("x",))


def test_sources_import_no_jax():
    """Nothing in the port's parallel layer, its models or the rank bodies
    imports jax or the reference."""
    root = Path(__file__).resolve().parents[1]
    files = list((root / "src" / "repro_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", Path(cases.__file__)]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import")), (f, s)


# ------------------------------------------------------- the meshed MoE


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_routing_and_expert_accumulators_match_reference(pool, shape):
    """Each model rank's ``_local_route`` maps over its experts (EP: the
    experts [e_lo, e_lo + E_loc)) and its experts' int32 accumulators equal
    the reference's for the same (e_lo, E_loc), bit for bit, on dyadic
    router inputs (exact logits), with capacity drops."""
    from repro.models import transformer as jtfm
    from repro.models.config import MoEConfig as JMoEConfig
    from repro_torch.models.config import ArchConfig as TArchConfig
    from repro_torch.models.config import MoEConfig as TMoEConfig
    moe = dict(n_experts=4, top_k=2, d_expert=16, capacity_factor=1.0)
    jm = JMoEConfig(**moe)
    tcfg = TArchConfig(name="t", family="transformer", n_layers=1,
                       d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab_size=128, moe=TMoEConfig(**moe))
    rng = np.random.default_rng(11)
    n, E, d = 24, moe["n_experts"], 32
    h = (rng.integers(-8, 9, (n, d)) / 4).astype(np.float32)
    router = (rng.integers(-16, 17, (d, E)) / 64).astype(np.float32)
    cap = max(int(jm.top_k * n * jm.capacity_factor / E), 4)
    res = pool.run(cases.route_case, shape, ("data", "model"),
                   (tcfg, h, router, cap))
    route = jax.jit(jtfm._local_route, static_argnums=(2, 4, 5))
    kept = 0
    for r in res:
        jg, jgates, jfilled, _, _ = route(jnp.asarray(h), jnp.asarray(router),
                                          jm, r["e_lo"], r["E_loc"], cap)
        np.testing.assert_array_equal(r["gather_idx"], np.asarray(jg))
        np.testing.assert_array_equal(r["filled"], np.asarray(jfilled))
        np.testing.assert_allclose(r["gates"], np.asarray(jgates),
                                   rtol=1e-6, atol=1e-6)
        kept += int(np.asarray(jfilled).sum())
    assert kept < n * jm.top_k                  # some assignments dropped
    # the whole layer's buffer, and the experts' first product on it
    jg, _, jfilled, _, _ = route(jnp.asarray(h), jnp.asarray(router), jm, 0,
                                 E, cap)
    buf = np.where(np.asarray(jfilled)[:, None], h[np.asarray(jg)], 0)
    buf = buf.reshape(E, cap, d).astype(np.float32)
    w_q = rng.integers(-127, 128, (E, d, 16)).astype(np.int8)
    accs = pool.run(cases.expert_acc_case, shape, ("data", "model"),
                    (w_q, buf))
    x_q, _ = jtfm._quantize_act(jnp.asarray(buf))
    want = np.asarray(jnp.einsum("ecd,edf->ecf", x_q, jnp.asarray(w_q),
                                 preferred_element_type=jnp.int32))
    E_loc = E // shape[1]
    for r, acc in enumerate(accs):
        np.testing.assert_array_equal(acc, want[r * E_loc:(r + 1) * E_loc])
