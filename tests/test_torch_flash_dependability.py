"""``dependable_attention`` and the attention entries of the backend
registry, held against the reference.

Mirrors the attention cases of tests/test_dependability.py and
tests/test_backend.py: the same numpy inputs and the same (element, bit)
strike on both sides; the reference runs its Pallas kernels in interpret
mode (``backend="pallas"``), the port its ``cuda`` backend, whose kernel
wrappers run their plain versions on CPU tensors.  Outputs are float and
held to 1e-5; ``DependabilityStats`` are held exactly; within the port,
every policy's output on clean input, and every healed output, is bit for
bit the unprotected one.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dependability import Policy as JPolicy
from repro.core.dependability import dependable_attention as j_dep_attn
from repro.kernels import dispatch as jdispatch
from repro_torch.core import abft as tabft
from repro_torch.core import backend as tbackend
from repro_torch.core.dependability import DependabilityStats
from repro_torch.core.dependability import Policy as TPolicy
from repro_torch.core.dependability import dependable_attention as t_dep_attn
from repro_torch.core.fault_injection import flip_bit_at_index
from repro_torch.kernels import dispatch as tdispatch

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
POLICIES = ["none", "abft", "dmr", "tmr", "ckpt"]
IDX = (0, 1, 5, 4)


def _inputs(seed=0, B=1, H=2, S=24, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, hd)).astype(np.float32)
            for _ in range(3)]


def _j_flip(bit, idx=IDX):
    def inj(out):
        bits = jax.lax.bitcast_convert_type(out, jnp.uint32)
        bits = bits.at[idx].set(bits[idx] ^ jnp.uint32(1 << bit))
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    return inj


def _t_flip(bit, idx=IDX):
    def inj(out):
        return flip_bit_at_index(out, int(np.ravel_multi_index(idx,
                                                               out.shape)),
                                 bit)
    return inj


def _both(policy, arrs, bit=None, j_backend="pallas", t_backend="cuda"):
    """One dependable attention on each side; returns (port out, port
    stats, reference out, reference stats) with the stats as ints."""
    j_out, j_st = j_dep_attn(JPolicy(policy), *map(jnp.asarray, arrs),
                             backend=j_backend,
                             inject=None if bit is None else _j_flip(bit))
    t_out, t_st = t_dep_attn(TPolicy(policy), *map(torch.from_numpy, arrs),
                             backend=t_backend,
                             inject=None if bit is None else _t_flip(bit))
    return (t_out, DependabilityStats.to_host(t_st), np.asarray(j_out),
            {k: int(v) for k, v in j_st.items()})


@pytest.mark.parametrize("policy", POLICIES)
def test_attention_policies_agree_on_clean_input(policy):
    arrs = _inputs()
    base, _ = t_dep_attn(TPolicy.NONE, *map(torch.from_numpy, arrs))
    out, st, j_out, j_st = _both(policy, arrs)
    assert torch.equal(out, base)
    assert st == j_st and st["faults_detected"] == 0
    np.testing.assert_allclose(out.numpy(), j_out, **TOL)


@pytest.mark.parametrize("bit", [0, 1, 22, 23, 30, 31])
def test_attention_abft_detects_and_heals_every_output_bit(bit):
    """High bits trip the float tolerance, low-mantissa bits slip under it
    and the exact output checksum catches them; row recovery restores the
    clean output bit for bit either way."""
    arrs = _inputs(1)
    clean, _ = t_dep_attn(TPolicy.NONE, *map(torch.from_numpy, arrs))
    out, st, j_out, j_st = _both("abft", arrs, bit)
    assert st == j_st
    assert st["faults_detected"] == 1 and st["faults_corrected"] == 1
    assert torch.equal(out, clean)
    np.testing.assert_allclose(out.numpy(), j_out, **TOL)


def test_attention_ckpt_rolls_back_whole_op():
    arrs = _inputs(2)
    clean, _ = t_dep_attn(TPolicy.NONE, *map(torch.from_numpy, arrs))
    out, st, _, j_st = _both("ckpt", arrs, 0)
    assert st == j_st
    assert st["faults_detected"] == 1 and st["faults_recovered"] == 1
    assert st["faults_corrected"] == 0          # rollback, not in-place
    assert torch.equal(out, clean)


def test_attention_dmr_detects_but_ships_replica0():
    arrs = _inputs(3)
    clean, _ = t_dep_attn(TPolicy.NONE, *map(torch.from_numpy, arrs))
    out, st, j_out, j_st = _both("dmr", arrs, 0)
    assert st == j_st
    assert st["faults_detected"] == 1 and st["faults_corrected"] == 0
    assert not torch.equal(out, clean)          # faulted replica shipped
    assert torch.equal(out, _t_flip(0)(clean))


def test_attention_tmr_outvotes_corrupted_replica():
    arrs = _inputs(4)
    clean, _ = t_dep_attn(TPolicy.NONE, *map(torch.from_numpy, arrs))
    out, st, _, j_st = _both("tmr", arrs, 30)
    assert st == j_st
    assert st["faults_detected"] == 1 and st["faults_corrected"] == 1
    assert torch.equal(out, clean)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_attention_abft_heals_on_every_backend(backend):
    arrs = _inputs(5)
    clean, _ = t_dep_attn(TPolicy.NONE, *map(torch.from_numpy, arrs),
                          backend=backend)
    out, st, j_out, j_st = _both("abft", arrs, 1, j_backend="ref",
                                 t_backend=backend)
    assert st == j_st
    assert st["faults_detected"] == 1 and st["faults_corrected"] == 1
    assert torch.equal(out, clean)
    np.testing.assert_allclose(out.numpy(), j_out, **TOL)


@pytest.mark.parametrize("bit", [0, 7, 15])
def test_attention_abft_bf16_no_false_alarm_and_heals(bit):
    """bf16 output: the float tier allows for the rounding of each element
    to bf16 (which the f32 check column does not see), so a clean run
    raises no alarm; a flip of the lowest mantissa bit, the lowest exponent
    bit or the sign is caught by the exact tier and healed."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(6, B=1, H=4, S=128, hd=64))
    k, v = k[:, :2], v[:, :2]                   # GQA 2:1
    clean, st = t_dep_attn(TPolicy.ABFT, q, k, v)
    assert DependabilityStats.to_host(st)["faults_detected"] == 0
    plain, _ = t_dep_attn(TPolicy.NONE, q, k, v)
    assert torch.equal(clean, plain)
    inj = lambda o: flip_bit_at_index(o, 12345, bit)       # noqa: E731
    for policy, healed in (("abft", "faults_corrected"),
                           ("ckpt", "faults_recovered")):
        out, st = t_dep_attn(TPolicy(policy), q, k, v, inject=inj)
        st = DependabilityStats.to_host(st)
        assert st["faults_detected"] == 1 and st[healed] == 1, (policy, st)
        assert torch.equal(out, plain)


def test_attention_requires_registered_backend():
    bare = tbackend.Backend(name="bare", conv_acc=None,
                            conv_acc_checksum=None)
    q, k, v = map(torch.from_numpy, _inputs(7))
    with pytest.raises(ValueError, match="does not register attention"):
        t_dep_attn(TPolicy.ABFT, q, k, v, backend=bare)


# ---------------------------------------------------------------------------
# attention registry entries (tests/test_backend.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_attn_registry_close_across_backends(backend):
    """Float attention agrees with the reference's jnp backend within
    tolerance; within one backend the checked entry's output is the plain
    entry's bit for bit."""
    arrs = _inputs(21, S=48)
    q, k, v = map(torch.from_numpy, arrs)
    out = tdispatch.attn(q, k, v, backend=backend)
    want = jdispatch.attn(*map(jnp.asarray, arrs), backend="jnp")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    out2, check, csum = tdispatch.attn_checksum(q, k, v, backend=backend)
    assert torch.equal(out, out2)
    np.testing.assert_allclose(out2.sum(dim=-1).numpy(), check.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(tabft.output_row_checksums(out2), csum)


def test_attn_entries_registered_on_all_builtins():
    for name in tbackend.available_backends():
        be = tbackend.get_backend(name)
        assert be.attn is not None and be.attn_checksum is not None, name
