"""Tensor parallelism inside rwkv6 and griffin, as the reference's specs
lay the recurrent weights out over the model axis
(``src/repro/parallel/sharding.py``):

* the dry-run keeps at most RATIO_MAX of a reduced train cell's temp bytes
  per rank at model axis 4 against axis 1 (``launch.dryrun`` on meta, 4 ×
  128 tokens): recurrentgemma-2b at most 0.45, rwkv6-1.6b at most 0.85
  (0.821 and 0.975 when every recurrent layer ran replicated).  The
  reference's own ratios, from its GSPMD compile on 4 host devices with
  ``Auto`` mesh axes in a subprocess, are printed beside them (``-s``);
* ``chip_smoke._shard_collectives``, which the card's recurrentgemma-2b
  cell is held to, equals the collectives counted on gloo ranks at (1, 1)
  and (1, 4): a prefill, decode steps and a train step under remat and
  without, FSDP, heads the axis divides and not (rwkv6 with 2 heads,
  griffin with 2 q heads, whose attention is then gathered whole);
* the same derivation equals ``launch.op_analysis``'s counts of the
  dry-run's own train step (``dryrun.build_cell``) run on real tensors at
  (1, 4), the step the card's cell runs;
* the decode cache keeps ``cache_specs``' layout under tensor parallelism:
  rwkv6's WKV state whole on every rank, its shift states and griffin's
  ``conv`` and ``h`` this rank's slices of the width.

The ranks are one pool of 4 spawned processes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

import torch_spmd_cases as cases
from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import _KIND
from repro_torch.models import api as tapi
from repro_torch.models.config import SHAPES, reduced
from repro_torch.parallel.sharding import param_specs
from repro_torch.train import optim, steps

AXES = ("data", "model")
RATIO_MAX = {"recurrentgemma-2b": 0.45, "rwkv6-1.6b": 0.85}
SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=4)

_REFERENCE_RATIO = r"""
import json, os
os.environ["REPRO_XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, jax
from jax.sharding import AxisType
from repro.configs import registry
from repro.launch import dryrun
from repro.models.config import SHAPES, reduced
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=4)
temp = {}
for name in ("recurrentgemma-2b", "rwkv6-1.6b"):
    cfg = reduced(registry.get(name))
    for m in (1, 4):
        mesh = jax.make_mesh((1, m), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:m])
        fn, args = dryrun.build_cell(cfg, shape, mesh)
        temp[f"{name},{m}"] = \
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
    """The reference's compiles (~20 s), started at the file's first test
    so that they run beside the others, and read by the ratio tests."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_RATIO],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    out = {}

    def read():
        if not out:
            stdout, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            out.update(json.loads(stdout.strip().splitlines()[-1]))
        return out
    yield read
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COUNT_CASES = {                     # registry name, changes to reduced()
    "rwkv": ("rwkv6-1.6b", dict()),
    "rwkv-remat-none": ("rwkv6-1.6b", dict(remat="none")),
    "rwkv-2-heads": ("rwkv6-1.6b", dict(head_dim=32)),
    "griffin": ("recurrentgemma-2b", dict(n_layers=5)),
    "griffin-remat-none": ("recurrentgemma-2b", dict(n_layers=5,
                                                     remat="none")),
    "griffin-2-q-heads": ("recurrentgemma-2b", dict(n_layers=5, n_heads=2)),
    "griffin-fsdp": ("recurrentgemma-2b", dict(n_layers=4,
                                               fsdp_params=True)),
}


def _count_cfg(case):
    """The case's reduced config in f32; ``head_dim`` is rwkv6's
    recurrent head dim."""
    name, kw = COUNT_CASES[case]
    kw = dict(kw)
    cfg = reduced(registry.get(name))
    if "head_dim" in kw:
        cfg = dataclasses.replace(cfg, recurrent=dataclasses.replace(
            cfg.recurrent, head_dim=kw.pop("head_dim")))
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _specs(cfg, model):
    mesh = types.SimpleNamespace(shape={"data": 1, "model": model})
    return param_specs(cfg, tapi.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"),
        ("data",), "model", mesh)


@pytest.mark.parametrize("model", [1, 4])
@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_chip_smoke_derives_the_recurrent_collectives(pool, case, model):
    cfg = _count_cfg(case)
    specs, smoke = _specs(cfg, model), _smoke()
    n_dec = 3 if model == 1 else 4
    got = pool.run(cases.collective_counts_case, (1, model), AXES,
                   (cfg, 0, n_dec))[0]
    want = {"prefill": smoke._shard_collectives(cfg, "prefill", specs,
                                                model=model),
            "decode": smoke._shard_collectives(cfg, "decode", specs,
                                               calls=n_dec, model=model),
            "train": smoke._shard_collectives(cfg, "train", specs,
                                              model=model)}
    assert got == want


@pytest.mark.parametrize("name", list(RATIO_MAX))
def test_op_analysis_of_the_dry_run_step_counts_as_derived(pool, name):
    """The card's recurrentgemma-2b cell holds ``launch.op_analysis``'s
    collective counts of ``dryrun.build_cell``'s train step against
    ``_shard_collectives``: the same here on 4 gloo ranks at (1, 4), a
    reduced config at 4 × 32 tokens."""
    cfg = dataclasses.replace(reduced(registry.get(name)),
                              compute_dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=5)
    shape = dataclasses.replace(SHAPE, seq_len=32)
    state = tapi.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    full = steps.TrainState(state, optim.make_optimizer(
        cfg.optimizer).init(state), torch.zeros((), dtype=torch.int32))
    batch = TokenStream(cfg, shape).batch_at(0)
    res = pool.run(cases.analyzed_step, (1, 4), AXES,
                   (cfg, shape, full, batch))
    want = _smoke()._shard_collectives(cfg, "train", _specs(cfg, 4),
                                       model=4)
    want = {_KIND[k]: v for k, v in want.items()}
    for r in res:
        assert r["summary"]["collective_counts"] == want


@pytest.mark.parametrize("case", ["rwkv", "griffin"])
def test_decode_cache_keeps_the_reference_layout(pool, case):
    """Under tensor parallelism at (1, 4) the cache a prefill returns and
    the decode steps carry has ``cache_specs``' per-rank shapes."""
    cfg = _count_cfg(case)
    got = pool.run(cases.collective_counts_case, (1, 4), AXES,
                   (cfg, 0, 4, True))
    d, L = cfg.d_model, cfg.n_layers
    if cfg.family == "rwkv":
        H, hd = d // cfg.recurrent.head_dim, cfg.recurrent.head_dim
        want = [[L, 1, d // 4], [L, 1, H, hd, hd], [L, 1, d // 4], []]
    else:
        n_rec = L - L // 3
        W, K = cfg.recurrent.lru_width, cfg.recurrent.d_conv
        kv = [L // 3, 1, cfg.recurrent.attn_window, cfg.n_kv_heads,
              cfg.resolved_head_dim]
        want = [[n_rec, 1, K - 1, W // 4], [n_rec, 1, W // 4], kv, kv, [1]]
    for r in got:
        assert r["cache_shapes"] == want


@pytest.mark.parametrize("name", list(RATIO_MAX))
def test_dry_run_keeps_the_local_share_of_the_recurrent_temp(
        reference_temp, name):
    cfg = reduced(registry.get(name))
    temp = {m: dryrun.run_cell_fake(cfg, SHAPE, (1, m))["memory_analysis"]
            ["temp_size_in_bytes"] for m in (1, 4)}
    ratio = temp[4] / temp[1]
    ref = reference_temp()
    ref_ratio = ref[f"{name},4"] / ref[f"{name},1"]
    print(f"{name}: temp bytes per rank at model axis 4 / axis 1: port "
          f"{ratio:.4f} ({temp}), reference {ref_ratio:.4f}")
    assert ratio <= RATIO_MAX[name], ratio
