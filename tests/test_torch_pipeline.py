"""The port's pipeline parallelism (``parallel.pipeline``) held against the
reference's: ``tests/test_pipeline_parallel.py``'s stages (tanh(x·w + b),
parameters drawn by ``jax.random`` and passed as numpy) on 2 and 4 gloo
ranks of a "stage" axis, the outputs against the reference's ``sequential``
within rtol = atol = 1e-5 and each stage's gradient of mean(out²) (every
rank seeded with 1 / world) against ``jax.grad`` of its ``seq_loss`` within
rtol 1e-4, atol 1e-5, every stage's gradient nonzero; the hops issued as
the schedule derives; at one stage, with ``checkpoint_stages`` on and off,
the outputs and gradient equal to a plain loop over the microbatches bit
for bit.  The reference's own multi-device tests skip here (one jax
device), and its 8-device subprocess test fails on jax 0.9's mesh axes:
the reference's single-device ``sequential`` is the oracle.  One pool of
4 spawned ranks.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spmd_cases as cases
from repro.parallel import pipeline as jpp
from repro_torch.parallel import pipeline as pp

jax.config.update("jax_platform_name", "cpu")

AXES = ("stage",)
MB, D = 2, 8


@pytest.fixture(scope="module")
def pool():
    p = cases.Pool(4)
    yield p
    p.close()


def make_stage_params(key, n_stages, d):
    ks = jax.random.split(key, n_stages)
    return [{"w": jax.random.normal(k, (d, d)) * 0.3,
             "b": jnp.zeros((d,))} for k in ks]


def stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def sequential(param_list, mb):
    out = mb
    for p in param_list:
        out = jax.vmap(lambda m: stage_fn(p, m))(out)
    return out


def _inputs(n_stages, n_micro):
    plist = make_stage_params(jax.random.key(0), n_stages, D)
    x = jax.random.normal(jax.random.key(1), (n_micro, MB, D))
    return plist, x, [{k: np.asarray(v) for k, v in p.items()}
                      for p in plist], np.asarray(x)


def test_bubble_fraction():
    for s, m in ((4, 4), (2, 30), (8, 8), (8, 64), (1, 5)):
        assert pp.bubble_fraction(s, m) == pytest.approx(
            jpp.bubble_fraction(s, m))
    fr = [pp.bubble_fraction(8, m) for m in (8, 16, 32, 64)]
    assert fr == sorted(fr, reverse=True)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_matches_sequential(pool, n_stages):
    plist, x, nplist, nx = _inputs(n_stages, 6)
    want = np.asarray(sequential(plist, x))
    res = pool.run(cases.pipeline_case, (n_stages,), AXES, (nplist, nx))
    for r in res:                      # every rank returns the outputs
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_grads_match_sequential(pool, n_stages):
    """Every stage's gradient agrees with ``jax.grad`` of the sequential
    loss (not n_stages times it) and is nonzero."""
    plist, x, nplist, nx = _inputs(n_stages, 4)

    def seq_loss(pl):
        return jnp.mean(sequential(pl, x) ** 2)

    g_seq = jax.grad(seq_loss)(plist)
    res = pool.run(cases.pipeline_case, (n_stages,), AXES, (nplist, nx))
    for stage, r in enumerate(res):
        np.testing.assert_allclose(r["loss"], float(seq_loss(plist)),
                                   rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k],
                                       np.asarray(g_seq[stage][k]),
                                       rtol=1e-4, atol=1e-5)
            assert np.abs(r["grads"][k]).sum() > 0, (stage, k)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 3), (4, 4)])
def test_hops_as_the_schedule_derives(pool, n_stages, n_micro):
    """One send/receive per tick on every rank (each stage sends, receives
    or both) forward, as many in the backward, and one sum each way."""
    _, _, nplist, nx = _inputs(n_stages, n_micro)
    res = pool.run(cases.pipeline_case, (n_stages,), AXES, (nplist, nx))
    ticks = n_micro + n_stages - 1
    for r in res:
        assert r["fwd"] == dict(all_reduce=1, all_gather=0, reduce_scatter=0,
                                all_to_all=0, send_recv=ticks)
        assert r["total"] == dict(all_reduce=2, all_gather=0,
                                  reduce_scatter=0, all_to_all=0,
                                  send_recv=2 * ticks)


def test_one_stage_is_the_plain_loop(pool):
    _, _, nplist, nx = _inputs(1, 5)
    (res,) = pool.run(cases.pipeline_world_one, (1,), AXES, (nplist, nx))
    assert res == {True: True, False: True}
