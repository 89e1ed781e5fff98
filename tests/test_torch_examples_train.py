"""The port's fault-tolerant training walkthrough against the reference.

``examples/train_ft_e2e_torch.py`` is imported by file path and run on the
CPU at the reference script's config (smollm-135m reduced to 4 layers, d
128, f32), cut to 16 steps with a checkpoint every 4 so the SEU lands at
step 8, once the loss-spike detector holds 8 losses.  As in
``test_torch_ft_loop.py``, the port starts from the reference's initial
state (saved as step 0 of both of its runs): its clean losses stay within
1e-4 (relative) of the reference loop's clean run, and its faulty run
recovers once onto exactly its clean curve.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.config import reduced as jreduced
from repro.runtime import ft_loop as jft
from repro.train import steps as jsteps
from repro_torch.convert import train_state_from_numpy
from repro_torch.models.config import ShapeConfig
from test_torch_examples import load_example

jax.config.update("jax_platform_name", "cpu")

STEPS, EVERY, BATCH, SEQ = 16, 4, 8, 64


def test_train_ft_e2e_tracks_reference_and_recovers(tmp_path):
    ex = load_example("train_ft_e2e")
    jcfg = dataclasses.replace(jreduced(jregistry.get("smollm-135m")),
                               n_layers=4, d_model=128, d_ff=256,
                               compute_dtype="float32",
                               param_dtype="float32")
    cfg = ex.default_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ref = jft.run(jcfg, JShapeConfig("e2e", seq_len=SEQ, global_batch=BATCH,
                                     kind="train"),
                  jft.FTConfig(ckpt_dir=str(tmp_path / "ref"),
                               ckpt_every=EVERY), n_steps=STEPS)
    host = jax.device_get(jsteps.init_train_state(jcfg, jax.random.key(0)))
    init = train_state_from_numpy((host.params, host.opt_state, host.step),
                                  device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = ex.run("cpu", cfg=cfg,
                     shape=ShapeConfig("e2e", seq_len=SEQ,
                                       global_batch=BATCH, kind="train"),
                     steps=STEPS, ckpt_every=EVERY, init_state=init)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(got["clean"], ref.losses, rtol=1e-4)
    assert got["strike_bit"] == 30
    assert got["recoveries"] == 1 and len(got["events"]) == 1
    assert got["faulty"] == got["clean"] and got["same"]


@pytest.mark.parametrize("dtype, bit, exp_bits", [(torch.float32, 30, 8),
                                                  (torch.bfloat16, 14, 8),
                                                  (torch.float16, 14, 5)])
def test_strike_flips_the_top_exponent_bit_of_the_leaf_dtype(dtype, bit,
                                                             exp_bits):
    """The SEU's bit follows the leaf's own dtype: flipping it in a weight
    below 1 multiplies it by 2^(2^(exponent bits - 1)) and nothing else."""
    from repro_torch.core import fault_injection as fi
    ex = load_example("train_ft_e2e")
    assert ex.top_exponent_bit(dtype) == bit
    w = torch.full((2, 3), 0.02, dtype=dtype)
    hit = fi.flip_bit_at_index(w, 0, bit)
    assert float(hit[0, 0]) == float(w[0, 0]) * 2.0 ** (2 ** (exp_bits - 1))
    assert torch.equal(hit.reshape(-1)[1:], w.reshape(-1)[1:])
