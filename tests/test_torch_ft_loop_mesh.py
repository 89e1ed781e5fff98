"""The port's sharded fault-tolerant training loop, ``ft_loop.run(mesh=)``,
on a (2, 2) ("data", "model") mesh of gloo ranks over
``test_torch_ft_loop.py``'s tiny smollm-135m config (reduced, 1 layer,
f32): a clean run; a NaN drill whose losses are ``==`` the clean sharded
run's (the replay contract); ``RuntimeError("node lost")`` raised on one
rank only, from which every rank recovers within the call's deadline
(the ranks agree on the fault before the step, so none waits in a
collective); a resume from a sharded checkpoint; a rank that starts
late, after rank 0 could have saved step 0, taking its peers' branch (the
ranks agree on the step they start from before rank 0 writes: a late rank
that took the resume branch alone left its peers in the save's gathers
until the deadline killed the pool); and the clean curve
against the reference's unsharded ``ft_loop.run`` from the reference's
initial state within rtol 1e-4 (``test_torch_ft_loop.py``: the two
frameworks' f32 sums differ in their last bits).  One pool of 4 spawned
ranks; each call's deadline is the pool's 120 s.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import torch_spmd_cases as cases
from repro.configs import registry as jregistry
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.config import reduced as jreduced
from repro.runtime import ft_loop as jft
from repro.train import steps as jsteps
from repro_torch.configs import registry
from repro_torch.convert import train_state_from_numpy
from repro_torch.models.config import ShapeConfig, reduced
from repro_torch.train import checkpoint as ckpt

jax.config.update("jax_platform_name", "cpu")

MESH, AXES = (2, 2), ("data", "model")
SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
TINY = dict(n_layers=1, d_model=32, d_ff=64, vocab_size=64,
            compute_dtype="float32", param_dtype="float32")
N_STEPS = 12
LATE_RANK, LATE_WAIT_S = 3, 8.0   # outside rank 0's "model" pair


@pytest.fixture(scope="module")
def pool():
    p = cases.Pool(4)
    yield p
    p.close()


def _cfg():
    return dataclasses.replace(reduced(registry.get("smollm-135m")), **TINY)


def _run(pool, path, n_steps=N_STEPS, hook=None):
    return pool.run(cases.ft_run, MESH, AXES,
                    (_cfg(), SHAPE, str(path), n_steps, hook))


@pytest.fixture(scope="module")
def clean(pool, tmp_path_factory):
    return _run(pool, tmp_path_factory.mktemp("clean"))


def _same_on_every_rank(res):
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        assert r["recoveries"] == res[0]["recoveries"]


def test_clean_run_trains(clean):
    _same_on_every_rank(clean)
    losses = clean[0]["losses"]
    assert len(losses) == N_STEPS and clean[0]["recoveries"] == 0
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert clean[0]["saves"] == 4             # rank 0 writes steps 0, 4, 8, 12
    assert all(r["saves"] == 0 for r in clean[1:])


def test_nan_drill_replays_bit_identical(pool, clean, tmp_path):
    res = _run(pool, tmp_path / "nan", hook=cases.NanHook(9))
    _same_on_every_rank(res)
    assert res[0]["recoveries"] == 1 and res[0]["replayed"] == 1
    assert res[0]["losses"] == clean[0]["losses"]


def test_node_lost_on_one_rank(pool, clean, tmp_path):
    res = _run(pool, tmp_path / "lost", hook=cases.NodeLost(6, rank=1))
    _same_on_every_rank(res)
    assert res[0]["recoveries"] == 1 and res[0]["replayed"] == 2
    assert "node lost" in res[1]["events"][0]
    assert "a peer rank failed" in res[0]["events"][0]
    assert res[0]["losses"] == clean[0]["losses"]


def test_resume_from_sharded_checkpoint(pool, clean, tmp_path):
    first = _run(pool, tmp_path / "resume", n_steps=8)
    rest = _run(pool, tmp_path / "resume")
    _same_on_every_rank(rest)
    assert first[0]["losses"] + rest[0]["losses"] == clean[0]["losses"]


def test_late_rank_starts_with_its_peers(pool, clean, tmp_path):
    """Rank LATE_RANK waits up to LATE_WAIT_S for a step-0 checkpoint
    before it enters the loop.  Ranks 0 and 1 need no gather with it to
    save step 0, so without the agreement rank 0 wrote the checkpoint, the
    late rank resumed from it and its partner waited in the save's gathers
    until the call's deadline.  Agreed, every rank starts afresh and the
    run is the clean one."""
    res = pool.run(cases.ft_run_late, MESH, AXES,
                   (_cfg(), SHAPE, str(tmp_path / "late"), N_STEPS,
                    LATE_RANK, LATE_WAIT_S))
    _same_on_every_rank(res)
    assert res[0]["recoveries"] == 0 and res[0]["saves"] == 4
    assert res[0]["losses"] == clean[0]["losses"]


def test_clean_curve_tracks_reference(pool, tmp_path):
    """From the reference's initial state (saved unsharded as the port's
    step-0 checkpoint, restored onto the mesh) the sharded loop follows
    the reference's unsharded clean curve."""
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")), **TINY)
    jshape = JShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
    ref = jft.run(jcfg, jshape, jft.FTConfig(ckpt_dir=str(tmp_path / "ref"),
                                             ckpt_every=4), n_steps=N_STEPS)
    host = jax.device_get(jsteps.init_train_state(jcfg, jax.random.key(0)))
    ckpt.save(tmp_path / "port", 0, train_state_from_numpy(
        (host.params, host.opt_state, host.step), device="cpu"))
    res = _run(pool, tmp_path / "port")
    _same_on_every_rank(res)
    np.testing.assert_allclose(res[0]["losses"], ref.losses, rtol=1e-4)
