"""The port's serving walkthroughs against the reference's ``Engine``.

``examples/dependable_serving_torch.py`` and
``examples/fleet_quickstart_torch.py`` are imported by file path and run on
the CPU over the reference's parameters (converted with
``repro_torch.convert``) at the reference scripts' sizes, with f32
compute in both packages so that the greedy streams are comparable: the
clean stream and the one rolled back after the token-buffer strike equal
the reference ``Engine``'s over ``reduced(qwen3-0.6b)``; the fleet's golden
stream, and the streams after a kill, an ABFT weight strike with its reload
and a DMR token strike, equal the reference ``Engine``'s over
``reduced(smollm-135m)``.
"""
from __future__ import annotations

import dataclasses

import jax
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models.config import reduced as jreduced
from repro.runtime.serving import Engine as JEngine
from repro.runtime.serving import Request as JRequest
from repro_torch.configs import registry
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models.config import reduced
from test_torch_examples import load_example

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
F32 = dict(compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(arch):
    """(reference cfg, its params, the port's cfg, the params converted)
    of ``reduced(arch)`` with f32 compute."""
    jcfg = dataclasses.replace(jreduced(jregistry.get(arch)), **F32)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    cfg = dataclasses.replace(reduced(registry.get(arch)), **F32)
    params = transformer_params_from_numpy(jax.device_get(jparams),
                                           device=CPU)
    return jcfg, jparams, cfg, params


def _reference_streams(jcfg, jparams, prompts, **kw):
    eng = JEngine(jcfg, jparams, capacity=3, max_len=96, prefill_pad=8, **kw)
    reqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.output) for r in reqs]


def test_dependable_serving_streams_equal_reference():
    jcfg, jparams, cfg, params = _both("qwen3-0.6b")
    got = load_example("dependable_serving").run(CPU, cfg=cfg, params=params)
    want = _reference_streams(jcfg, jparams, got["prompts"],
                              snapshot_every=2)
    assert all(len(o) == 6 for o in want)
    assert got["clean"] == want
    assert got["faulty"] == want
    assert got["rolled_back"] >= 1 and got["replays"] >= 1
    assert got["replica_differs"] and got["voted"]


def test_fleet_quickstart_streams_equal_reference():
    jcfg, jparams, cfg, params = _both("smollm-135m")
    got = load_example("fleet_quickstart").run(CPU, cfg=cfg, params=params)
    want = _reference_streams(jcfg, jparams, got["prompts"])
    assert all(len(o) == 6 for o in want)
    for act in ("golden", "kill", "abft", "dmr"):
        assert got[act] == want, act
    assert got["abft_recoveries"] == 1
    assert got["dmr_detections"] >= 1
