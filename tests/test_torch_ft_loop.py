"""The port's fault-tolerant training loop: inject → detect → restore →
bit-identical replay.

Mirrors tests/test_ft_loop.py (the orchestrator cases are in
tests/test_torch_train.py; the mesh-shrink restart waits for parallelism),
on the same 1-layer tiny config.  The port is held bit-identical to
itself: recovery and resume reproduce its clean loss curve exactly.  Its
clean curve is held against the reference's: the port's loop is started
from the reference's initial state (saved as the port's step-0 checkpoint,
so the port's loop resumes from it) and its losses stay within 1e-4
(relative) of the reference's over 12 AdamW steps — the f32 sums of the two
frameworks' CPU kernels differ in their last bits.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.config import reduced as jreduced
from repro.runtime import ft_loop as jft
from repro.train import steps as jsteps
from repro_torch.configs import registry
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import fault_injection as fi
from repro_torch.kernels.flashattn import kernel as FK
from repro_torch.kernels.flashattn import ops as FO
from repro_torch.models.config import ShapeConfig, reduced
from repro_torch.runtime import ft_loop
from repro_torch.train import checkpoint as ckpt

jax.config.update("jax_platform_name", "cpu")

SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
TINY = dict(n_layers=1, d_model=32, d_ff=64, vocab_size=64,
            compute_dtype="float32", param_dtype="float32")


def tiny_cfg(**kw):
    return dataclasses.replace(reduced(registry.get("smollm-135m")),
                               **{**TINY, **kw})


def run(tmp_path, name, n_steps=12, cfg=None, **kw):
    ft = ft_loop.FTConfig(ckpt_dir=str(tmp_path / name),
                          **{"ckpt_every": 4, **kw.pop("ft", {})})
    return ft_loop.run(cfg or tiny_cfg(), SHAPE, ft, n_steps=n_steps,
                       device="cpu", **kw)


def nan_hook(at=9):
    fired = {"done": False}

    def hook(step, state):
        if step == at and not fired["done"]:
            fired["done"] = True
            embed = state.params["embed"].clone()
            embed[0, 0] = float("nan")
            return state._replace(params=dict(state.params, embed=embed))
        return None
    return hook


def test_clean_run_trains(tmp_path):
    rep = run(tmp_path, "clean")
    assert len(rep.losses) == 12
    assert rep.recoveries == 0
    assert all(np.isfinite(l) for l in rep.losses)
    assert np.mean(rep.losses[-4:]) < np.mean(rep.losses[:4])
    assert rep.ckpt_stats["saves"] == 4             # steps 0, 4, 8, 12


def test_clean_curve_tracks_reference(tmp_path):
    """The port's loop from the reference's initial state follows the
    reference's clean loss curve (its ``run_clean``)."""
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")), **TINY)
    jshape = JShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
    ref = jft.run(jcfg, jshape, jft.FTConfig(ckpt_dir=str(tmp_path / "ref"),
                                             ckpt_every=4), n_steps=12)
    host = jax.device_get(jsteps.init_train_state(jcfg, jax.random.key(0)))
    ckpt.save(tmp_path / "port", 0, train_state_from_numpy(
        (host.params, host.opt_state, host.step), device="cpu"))
    rep = run(tmp_path, "port")
    np.testing.assert_allclose(rep.losses, ref.losses, rtol=1e-4)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_nan_injection_recovers_bit_identical(tmp_path, attn_impl):
    cfg = tiny_cfg(attn_impl=attn_impl)
    clean = run(tmp_path, "clean", cfg=cfg)
    rep = run(tmp_path, "faulty", cfg=cfg, fault_hook=nan_hook())
    assert rep.recoveries == 1
    assert rep.steps_replayed > 0
    np.testing.assert_array_equal(np.asarray(rep.losses),
                                  np.asarray(clean.losses))


def test_bitflip_injection_detected_or_survived(tmp_path):
    """Random bit flips either spike the loss (→ recovery) or are benign;
    either way training completes with finite losses."""
    def hook(step, state):
        if step == 6:
            params = fi.inject_into_pytree(
                state.params, torch.Generator().manual_seed(9), n_flips=3)
            return state._replace(params=params)
        return None

    rep = run(tmp_path, "flip", n_steps=10, fault_hook=hook,
              ft={"ckpt_every": 3})
    assert len(rep.losses) == 10
    assert all(np.isfinite(l) for l in rep.losses)


def test_resume_from_existing_checkpoint(tmp_path):
    """Kill after 8 steps, relaunch: the losses equal the uninterrupted
    run's."""
    run(tmp_path, "resume", n_steps=8)                     # "crash" at 8
    rep2 = run(tmp_path, "resume", n_steps=12)             # relaunch
    clean = run(tmp_path, "clean")
    np.testing.assert_array_equal(np.asarray(rep2.losses),
                                  np.asarray(clean.losses[8:]))


def test_incremental_checkpointer_restart_bit_identity(tmp_path):
    d = tmp_path / "inc"
    rep1 = run(tmp_path, "inc", n_steps=8, ft={"ckpt_full_every": 2})
    assert rep1.ckpt_stats["saves"] >= 2
    assert rep1.ckpt_stats["chunks_written"] > 0
    manifests = sorted(d.glob("step_*/manifest.json"))
    assert manifests
    assert all(json.loads(m.read_text())["format"] == 2 for m in manifests)
    rep2 = run(tmp_path, "inc", n_steps=12, ft={"ckpt_full_every": 2})
    clean = run(tmp_path, "clean")
    np.testing.assert_array_equal(np.asarray(rep2.losses),
                                  np.asarray(clean.losses[8:]))


def test_incremental_recovery_waits_for_async_writer(tmp_path):
    clean = run(tmp_path, "clean")
    rep = run(tmp_path, "inc-faulty", fault_hook=nan_hook(),
              ft={"ckpt_full_every": 2})
    assert rep.recoveries == 1
    np.testing.assert_array_equal(np.asarray(rep.losses),
                                  np.asarray(clean.losses))


def test_launches_follow_the_steps_executed(tmp_path, monkeypatch):
    """Under flash attention with block recompute, every step call —
    replays and the faulted step included — runs the forward kernel twice
    per layer and the backward once: the count chip_smoke.py derives."""
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
    cfg = tiny_cfg(attn_impl="flash", n_layers=2)
    rep = run(tmp_path, "count", cfg=cfg, fault_hook=nan_hook())
    executed = len(rep.losses) + rep.steps_replayed + rep.recoveries
    assert executed == 14                    # 12 + step 8 again + faulted 9
    assert calls == {"fwd": 2 * 2 * executed, "bwd": 2 * executed}


def test_entry_points_default_to_the_card():
    """Training runs on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft_loop.run(tiny_cfg(), SHAPE, ft_loop.FTConfig(ckpt_dir="unused"),
                    n_steps=1)
