"""The port's dry-run (``launch.dryrun``, ``launch.op_analysis``,
``train.steps.input_specs`` / ``abstract_train_state``) held against the
reference's (``tests/test_dryrun_integration.py``, whose 8-device
subprocess fails on jax 0.9's mesh axes, and ``repro.launch.hlo_analysis``
on one CPU device):

* ``input_specs``: the reference's shapes, dtypes and cache leaf paths for
  every registry name × ``valid_cells`` (the port's one departure by
  design: recurrentgemma's cache ``length`` is per row, (B,));
* ``abstract_train_state``: ``jax.eval_shape(init_train_state)`` leaf by
  leaf for every registry name at full width, all on meta, the test
  process's peak RSS growing by less than 2 GB (1T parameters drawn on the
  host would take terabytes);
* ``run_cell`` on every registry name's ``reduced()`` config × train /
  prefill / decode at a fake (2, 4) mesh: FLOPs > 0, and a W8A8 + flash
  prefill and decode whose kernel rows are counted under their dtypes;
* on a (2, 2) mesh the dry-run's collective counts and bytes per kind, its
  argument bytes, FLOPs and (but for a prefill, which moves host-made
  cache indices to its device: a copy on meta, none on the CPU) its
  tracked peak equal those of the same step run on 4 gloo ranks on real
  tensors (one pool of 4 spawned ranks);
* at a (1, 1) mesh with ``remat="none"``, the FLOPs of reduced dense, MoE
  and recurrent train cells within 5 % of the reference's
  ``hlo_analysis.analyze`` of the same cell compiled on one CPU device
  (both packages' chunked attention recomputes each query chunk in the
  backward, so the counts include the same recompute);
* one production-mesh decode cell (pod16x16, 256 fake ranks) in at most
  10 s;
* ``--batch`` sets a cell's rows (one more row adds that row's inputs to
  the arguments and nothing else);
* at a (1, 1) mesh a train cell's peak beyond its arguments is the
  unsharded step's on real CPU tensors, the step the card trains with.
"""
from __future__ import annotations

import dataclasses
import json
import resource
import time

import jax
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro.configs import registry as jregistry
from repro.launch import hlo_analysis
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import reduced as jreduced
from repro.models.config import valid_cells as jvalid_cells
from repro.train import steps as jsteps
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import dryrun, op_analysis
from repro_torch.models.config import SHAPES, reduced, valid_cells
from repro_torch.train import optim as toptim
from repro_torch.train import steps

jax.config.update("jax_platform_name", "cpu")

SMALL = dict(seq_len=64, global_batch=8)
RSS_LIMIT = 2 << 30
FLOP_RTOL = 0.05
PROD_DECODE_S = 10.0


@pytest.fixture(scope="module")
def pool():
    p = cases.Pool(4)
    yield p
    p.close()


def _jpath(path):
    return tuple(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))
                 for k in path)


def _jleaves(t):
    return [(_jpath(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(t)[0]]


def _tleaves(t):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree.leaves_with_paths(t)]


def _small(shape):
    return dataclasses.replace(shape, **SMALL)


@pytest.mark.parametrize("name", registry.names())
def test_input_specs_match_reference(name):
    cfg, jcfg = registry.get(name), jregistry.get(name)
    assert [s.name for s in valid_cells(cfg)] == \
        [s.name for s in jvalid_cells(jcfg)]
    for shape in valid_cells(cfg):
        got = steps.input_specs(cfg, shape)
        want = jsteps.input_specs(jcfg, JSHAPES[shape.name])
        assert all(t.device.type == "meta" for t in tree.leaves(got))
        got_l, want_l = _tleaves(got), _jleaves(want)
        if cfg.family == "hybrid" and shape.kind == "decode":
            # the per-row (B,) length against the reference's scalar
            i = [p for p, _, _ in want_l].index(("cache", "length"))
            (gp, gs, gd), (wp, ws, wd) = got_l.pop(i), want_l.pop(i)
            assert gp == wp and gd == wd
            assert ws == () and gs == (shape.global_batch,)
        assert got_l == want_l, (name, shape.name)


def test_abstract_train_state_matches_eval_shape():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    for name in registry.names():
        got = steps.abstract_train_state(registry.get(name))
        assert all(t.device.type == "meta" for t in tree.leaves(got))
        want = jax.eval_shape(lambda: jsteps.init_train_state(
            jregistry.get(name), jax.random.key(0)))
        assert _tleaves(got) == _jleaves(want), name
        del got
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    assert grown < RSS_LIMIT, grown


@pytest.mark.parametrize("name", registry.names())
def test_run_cell_every_family_small_mesh(name):
    cfg = reduced(registry.get(name))
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell_fake(cfg, _small(SHAPES[kind]), (2, 4))
        assert rec["op_analysis"]["flops"] > 0, (name, kind)
        assert rec["n_devices"] == 8
        assert rec["memory_analysis"]["peak_bytes"] > \
            rec["memory_analysis"]["argument_size_in_bytes"] > 0


def test_w8a8_flash_variant_counts_kernel_rows():
    """The kernel wrappers' meta path: rows 4 and 9 counted under int32
    and the compute dtype instead of raising."""
    cfg = dataclasses.replace(reduced(registry.get("qwen3-0.6b")),
                              quant="w8a8_ffn", attn_impl="flash")
    pre = dryrun.run_cell_fake(cfg, _small(SHAPES["prefill_32k"]), (2, 4))
    calls = pre["op_analysis"]["kernel_calls"]
    assert calls["qmatmul_acc"] == 3 * cfg.n_layers
    assert calls["flash_attention_fwd_lse"] == cfg.n_layers
    assert pre["op_analysis"]["flops_by_dtype"]["s32"] > 0
    dec = dryrun.run_cell_fake(cfg, _small(SHAPES["decode_32k"]), (2, 4))
    assert dec["op_analysis"]["kernel_calls"]["qmatmul_acc"] == \
        3 * cfg.n_layers


REAL = {"smollm_train": ("smollm-135m", "train_4k", {}),
        "mixtral_train": ("mixtral-8x7b", "train_4k", {}),
        "smollm_decode": ("smollm-135m", "decode_32k", {}),
        "llama3_fsdp_prefill": ("llama3-405b", "prefill_32k", {}),
        "rwkv_train": ("rwkv6-1.6b", "train_4k", {}),
        "griffin_train": ("recurrentgemma-2b", "train_4k",
                          dict(n_layers=5))}


@pytest.mark.parametrize("case", list(REAL))
def test_dry_run_equals_gloo_run(pool, case):
    name, kind, kw = REAL[case]
    cfg = dataclasses.replace(reduced(registry.get(name)), **kw)
    shape = _small(SHAPES[kind])
    dry = dryrun.run_cell_fake(cfg, shape, (2, 2))
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    full = state if shape.kind == "train" else state.params
    rng = np.random.default_rng(1)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        from repro_torch.models import api
        batch = {"token": rng.integers(0, cfg.vocab_size, B).astype(np.int32),
                 "cache": api.init_cache(cfg, B, S, device="cpu")}
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1]}
        if shape.kind == "train":
            batch["labels"] = toks[:, 1:]
    res = pool.run(cases.analyzed_step, (2, 2), ("data", "model"),
                   (cfg, shape, full, batch))
    got = res[0]
    for key in ("collective_counts", "collective_bytes", "flops_by_dtype"):
        assert got["summary"][key] == dry["op_analysis"][key], key
    assert got["memory"]["argument_size_in_bytes"] == \
        dry["memory_analysis"]["argument_size_in_bytes"]
    if shape.kind != "prefill":
        # a prefill moves host-made cache indices to the step's device: a
        # copy on meta (and on the card), none on the CPU
        assert got["memory"]["peak_bytes"] == \
            dry["memory_analysis"]["peak_bytes"]


# recurrentgemma at 5 layers: a (rec, rec, attn) super-block and the tail
FLOP_CHANGES = {"recurrentgemma-2b": dict(n_layers=5)}


def _reference_flops(name, shape):
    jcfg = dataclasses.replace(jreduced(jregistry.get(name)), remat="none",
                               **FLOP_CHANGES.get(name, {}))
    jshape = dataclasses.replace(JSHAPES[shape.name], seq_len=shape.seq_len,
                                 global_batch=shape.global_batch)
    hlo = jax.jit(jsteps.make_train_step(jcfg)).lower(
        jsteps.abstract_train_state(jcfg),
        jsteps.input_specs(jcfg, jshape)).compile().as_text()
    return hlo_analysis.analyze(hlo)["flops"]


@pytest.mark.parametrize("name", ["smollm-135m", "mixtral-8x7b",
                                  "rwkv6-1.6b", "recurrentgemma-2b"])
def test_flops_match_reference_hlo(name):
    cfg = dataclasses.replace(reduced(registry.get(name)), remat="none",
                              **FLOP_CHANGES.get(name, {}))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=4)
    got = dryrun.run_cell_fake(cfg, shape, (1, 1))["op_analysis"]["flops"]
    want = _reference_flops(name, shape)
    assert abs(got - want) <= FLOP_RTOL * want, (got, want)


def test_production_decode_cell_is_quick():
    t0 = time.perf_counter()
    rec = dryrun.run_cell_fake(registry.get("smollm-135m"),
                               SHAPES["decode_32k"], (16, 16),
                               label="pod16x16")
    assert time.perf_counter() - t0 <= PROD_DECODE_S
    assert rec["n_devices"] == 256 and rec["op_analysis"]["flops"] > 0


def test_cli_batch_sets_the_rows(tmp_path):
    """``--batch`` runs the shape at that many rows (the name gets
    ``_b<rows>``): one more row of an embedding-input train cell adds its
    int32 tokens and labels and its f32 ``embeds`` to the arguments, and
    nothing else."""
    args = []
    for rows in (1, 2):
        dryrun.main(["--arch", "musicgen-large", "--shape", "train_4k",
                     "--mesh", "1,1", "--batch", str(rows), "--set",
                     "n_layers=1", "--out", str(tmp_path)])
        rec = json.loads((tmp_path / f"musicgen-large__train_4k_b{rows}__"
                                      f"1x1.json").read_text())
        args.append(rec["memory_analysis"]["argument_size_in_bytes"])
    S, d = SHAPES["train_4k"].seq_len, registry.get("musicgen-large").d_model
    assert args[1] - args[0] == 2 * S * 4 + S * d * 4


@pytest.mark.parametrize("name", ["musicgen-large", "smollm-135m"])
def test_one_rank_train_cell_holds_what_the_plain_step_holds(name,
                                                             monkeypatch):
    """At a (1, 1) mesh the dry-run's train step (under a ``ShardCtx``)
    holds, beyond its arguments, the same bytes at its peak as the
    unsharded ``make_train_step`` on real CPU tensors, the step the card
    trains with: the gradients of replicated leaves are summed in place
    (an out-of-place sum held every such gradient twice).  Eight layers,
    one row of 16 tokens and AdamW run in blocks of one layer, so that the
    gradients, not the activations or the optimizer's temporaries, make
    the peak, as at full width."""
    monkeypatch.setattr(toptim, "_BLOCK", 1)
    cfg = dataclasses.replace(reduced(registry.get(name)), n_layers=8)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=1)
    dry = dryrun.run_cell_fake(cfg, shape, (1, 1))["memory_analysis"]
    opt = toptim.make_optimizer(cfg.optimizer)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   opt, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: (torch.randn(v.shape, generator=gen) if v.is_floating_point()
                 else torch.zeros(v.shape, dtype=v.dtype))
             for k, v in steps.input_specs(cfg, shape).items()}
    _, an = op_analysis.analyze(steps.make_train_step(cfg, optimizer=opt),
                                state, batch)
    plain = an.memory_analysis()
    assert dry["argument_size_in_bytes"] == plain["argument_size_in_bytes"]
    assert dry["temp_size_in_bytes"] == plain["temp_size_in_bytes"]
