"""The vocabulary split over the model axis, as the reference's specs lay
it out (``embed: P(model, fsdp)``, ``lm_head: P(fsdp, model)``):

* ``shard.cross_entropy`` where ``Sharded.vocab_split`` (the
  vocab-parallel CE, ``common.vocab_parallel_cross_entropy``) on 4 gloo
  ranks at (1, 4) and (2, 2), with and without a mask, labels on the first
  and last column of every shard, against the reference's
  ``common.cross_entropy_loss`` and ``jax.grad`` of it on the whole
  logits: the loss within 1e-5 relative on every rank, d(logits) within
  1e-5 normwise;
* the vocab-parallel embedding (``transformer._embed``) ``torch.equal``
  to the reference's gather, negative and out-of-range ids included, and
  its gradient rows equal to ``jax.grad``'s of the gather of the rows
  read (dyadic upstream gradients, whose sums over copies and rows are
  exact in any order: JAX's gradient of the raw ids drops an out-of-range
  id's term, the port's adds it to the row read, as its unsharded path
  does); one all-reduce over the model axis beside the FSDP gather;
* the port's dry-run keeps at most 0.30 of the vocabulary-dependent temp
  bytes per rank at model axis 4 (temp(V = 8,192) − temp(V = 256) of a
  reduced smollm-135m train cell, 1 layer, 4 × 128 tokens, against the
  same at axis 1); the reference's own ratio, from its GSPMD compile on 4
  host devices with ``Auto`` mesh axes in a subprocess, is printed beside
  it.

The ranks are one pool of 4 spawned processes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spmd_cases as cases
from repro.models import common as jcommon
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES, reduced

jax.config.update("jax_platform_name", "cpu")

AXES = ("data", "model")
MESHES = [(1, 4), (2, 2)]
B, S, V, D = 4, 6, 64, 32
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
RATIO_MAX = 0.30
RATIO_VOCABS = (8192, 256)

_REFERENCE_RATIO = r"""
import json, os
os.environ["REPRO_XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, jax
from jax.sharding import AxisType
from repro.configs import registry
from repro.launch import dryrun
from repro.models.config import SHAPES, reduced
base = reduced(registry.get("smollm-135m"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=4)
temp = {}
for v in (8192, 256):
    cfg = dataclasses.replace(base, n_layers=1, vocab_size=v)
    for m in (1, 4):
        mesh = jax.make_mesh((1, m), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:m])
        fn, args = dryrun.build_cell(cfg, shape, mesh)
        temp[f"{v},{m}"] = \
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
    """The reference's compile, started first so that it runs beside the
    file's other tests."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_RATIO],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _cfg(fsdp=False, vocab=V):
    return dataclasses.replace(reduced(registry.get("smollm-135m")),
                               vocab_size=vocab, d_model=D,
                               fsdp_params=fsdp, compute_dtype="float32")


def _ranks(shape):
    """(data, model) position of each rank, in rank order."""
    return [np.unravel_index(r, shape) for r in range(int(np.prod(shape)))]


def _edge_labels(rng, nm):
    """Drawn labels with the first and the last column of each of ``nm``
    shards put at the start of every row (each row's set rolled by one)."""
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    w = V // nm
    edges = np.array([c for i in range(nm) for c in (i * w, (i + 1) * w - 1)])
    k = min(S, len(edges))
    for b in range(B):
        lab[b, :k] = np.roll(edges, -b)[:k]
    return lab


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_vocab_parallel_ce_matches_reference(pool, shape, masked):
    rng = np.random.default_rng([*shape, masked])
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    labels = _edge_labels(rng, shape[1])
    mask = None
    if masked:
        mask = (rng.random((B, S)) < 0.6).astype(np.float32)
        mask[0, 0] = mask[-1, -1] = 1.0
    jmask = None if mask is None else jnp.asarray(mask)
    want_loss, want_grad = jax.value_and_grad(
        lambda x: jcommon.cross_entropy_loss(x, jnp.asarray(labels),
                                             jmask))(jnp.asarray(logits))
    want_loss, want_grad = float(want_loss), np.asarray(want_grad)
    res = pool.run(cases.vocab_ce_case, shape, AXES,
                   (_cfg(), logits, labels, mask))
    got = np.zeros_like(want_grad)
    nb, nv = B // shape[0], V // shape[1]
    for (di, mi), r in zip(_ranks(shape), res):
        assert abs(float(r["loss"]) - want_loss) <= \
            LOSS_RTOL * abs(want_loss), (di, mi, float(r["loss"]), want_loss)
        got[di * nb:(di + 1) * nb, :, mi * nv:(mi + 1) * nv] = r["grad"]
    err = np.linalg.norm(got - want_grad) / np.linalg.norm(want_grad)
    assert err <= GRAD_RTOL, err


@pytest.mark.parametrize("shape,fsdp", [((1, 4), False), ((2, 2), True)])
def test_vocab_parallel_embedding_equals_reference_gather(pool, shape, fsdp):
    rng = np.random.default_rng(7)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    ids[0, :4] = [-1, -V, -V - 3, V]           # from the end, clamped
    ids[1, :4] = [V + 5, 2**30, -2**30, V - 1]
    ids[2, :2] = [0, V // shape[1]]             # the first row of shards
    w = (rng.integers(-8, 9, (B, S, D)) / 8).astype(np.float32)
    want_rows = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    # the row JAX's gather reads; the port's gradient, sharded or not,
    # goes to it (JAX's own scatter drops an out-of-range id's term)
    read = np.clip(np.where(ids < 0, ids + V, ids), 0, V - 1)
    assert np.array_equal(want_rows, table[read])
    want_grad = np.asarray(jax.grad(
        lambda t: jnp.sum(t[jnp.asarray(read)] * w))(jnp.asarray(table)))
    res = pool.run(cases.vocab_embed_case, shape, AXES,
                   (_cfg(fsdp), table, ids, w))
    nb, nv, nd = B // shape[0], V // shape[1], D // (shape[0] if fsdp else 1)
    for (di, mi), r in zip(_ranks(shape), res):
        assert np.array_equal(r["rows"], want_rows[di * nb:(di + 1) * nb])
        dj = di if fsdp else 0
        assert np.array_equal(r["grad"], want_grad[
            mi * nv:(mi + 1) * nv, dj * nd:(dj + 1) * nd]), (di, mi)
        assert r["counts"]["all_reduce"] == 1
        assert r["counts"]["all_gather"] == int(fsdp)


def test_dry_run_keeps_a_quarter_of_the_vocab_temp(reference_temp):
    """The vocabulary-dependent part of a train cell's temp bytes per rank
    at model axis 4 against axis 1: at most RATIO_MAX (the port gathered
    the whole tables on every rank before the split, 1.03)."""
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128,
                                global_batch=4)
    temp = {}
    for v in RATIO_VOCABS:
        cfg = dataclasses.replace(reduced(registry.get("smollm-135m")),
                                  n_layers=1, vocab_size=v)
        for m in (1, 4):
            temp[v, m] = dryrun.run_cell_fake(cfg, shape, (1, m))[
                "memory_analysis"]["temp_size_in_bytes"]
    hi, lo = RATIO_VOCABS
    ratio = (temp[hi, 4] - temp[lo, 4]) / (temp[hi, 1] - temp[lo, 1])
    out, err = reference_temp.communicate(timeout=300)
    assert reference_temp.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    ref_ratio = (ref[f"{hi},4"] - ref[f"{lo},4"]) / \
        (ref[f"{hi},1"] - ref[f"{lo},1"])
    print(f"vocab-dependent temp kept per rank at model axis 4: port "
          f"{ratio:.4f} ({temp}), reference {ref_ratio:.4f} ({ref})")
    assert ratio <= RATIO_MAX, ratio
