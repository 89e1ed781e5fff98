"""The port's walkthroughs in ``examples/*_torch.py`` against the reference.

Each example is imported by file path and its ``run(device="cpu")`` called
at the reference script's own small size; the reference's same
computation runs here on the same numpy inputs (the reference's scripts
run at import, so their steps are repeated, not imported).  Integer
results are held bit for bit: the quickstart's int8 conv and qlinear
outputs (the reference on its oracle path), its flagged rows and recovered
accumulator; the ship detector's ``q_out`` on ``reduced_specs()`` over the
reference's converted parameters; the recovery quickstart's op-level
outputs under an addressed weight flip given to both packages, and its
checkpointer's chunk counts.  The campaign quickstart is held to the
reference grid's verdicts at 20 trials per configuration (the trials
themselves are held against the reference's one by one in
``test_torch_campaign_parity.py``).  Then the failing case (``--device
cuda`` without a card raises), the examples' import hygiene (no ``jax``,
no ``repro``, read with ``ast``) and the kernel package's public names.
The serving examples are in ``test_torch_examples_serving.py``, training
in ``test_torch_examples_train.py``.
"""
from __future__ import annotations

import ast
import importlib.util
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
import repro_torch.kernels as tkernels
from repro.campaign import CampaignSpec as JCampaignSpec
from repro.campaign import build_case as jbuild_case
from repro.campaign import resolve_fault_model as jresolve_fault_model
from repro.campaign import trial_keys as jtrial_keys
from repro.core import abft as jabft
from repro.core import quant as jquant
from repro.core.dependability import Policy as JPolicy
from repro.core.dependability import dependable_qmatmul as jdependable_qmatmul
from repro.models import shipdet as jshipdet
from repro.train import checkpoint as jckpt
from repro_torch.convert import shipdet_params_from_numpy
from repro_torch.models import shipdet as tshipdet

jax.config.update("jax_platform_name", "cpu")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("quickstart", "shipdet_pipeline", "campaign_quickstart",
         "dependable_serving", "fleet_quickstart", "recovery_quickstart",
         "train_ft_e2e")
CPU = "cpu"


def load_example(name):
    """``examples/<name>_torch.py`` as a module (examples/ is no package)."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- quickstart


@pytest.mark.parametrize("full", [False, True])
def test_quickstart_matches_reference(full):
    """The three acts on the reference's draws: the int8 conv (both
    layers) and the qlinear bit for bit against the reference's oracle
    path under the same qparams, which equal the reference's own; the
    flagged rows; the recovered accumulator equal to the exact product."""
    ex = load_example("quickstart")
    got = ex.run(CPU, full=full)
    side, (m, k, n), (am, ak, an) = ex.SIZES[full]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((1, side, side, 24)),
                    jnp.float32) * 0.5
    w = jnp.asarray(rng.standard_normal((3, 3, 24, 24)), jnp.float32) * 0.2
    b = jnp.asarray(rng.standard_normal((24,)), jnp.float32) * 0.1
    y_float = jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    x_scale, x_zp = jquant.affine_qparams(float(x.min()), float(x.max()))
    out_scale, out_zp = jquant.affine_qparams(float(y_float.min()),
                                              float(y_float.max()))
    conv_args, conv2_args = got["calls"]["qconv_act"]
    for t, j in zip(conv_args[2:], (x_scale, x_zp, out_scale, out_zp)):
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    np.testing.assert_array_equal(_np(conv_args[0]), np.asarray(x))
    w2 = jnp.asarray(rng.standard_normal((3, 3, 24, 24)), jnp.float32) * 0.3
    for wt_, key in ((w, "conv"), (w2, "conv2")):
        y = jkernels.qconv_act(x, jkernels.make_qconv_params(wt_, b),
                               x_scale, x_zp, out_scale, out_zp,
                               use_kernel=False)
        np.testing.assert_array_equal(_np(got[key]), np.asarray(y))

    xt = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    wt = jnp.asarray(rng.standard_normal((k, n)), jnp.float32) \
        * (0.8 / np.sqrt(k))
    xs, xzp = jquant.affine_qparams(float(xt.min()), float(xt.max()))
    os_, ozp = jquant.affine_qparams(-8.0, 8.0)
    lin_args = got["calls"]["qlinear_act"][0]
    np.testing.assert_array_equal(_np(lin_args[0]), np.asarray(xt))
    for t, j in zip(lin_args[2:], (xs, xzp, os_, ozp)):
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    yt = jkernels.qlinear_act(xt, jkernels.make_qlinear_params(wt), xs, xzp,
                              os_, ozp, use_kernel=False)
    np.testing.assert_array_equal(_np(got["qlinear"]), np.asarray(yt))

    x_q = jnp.asarray(rng.integers(-128, 128, (am, ak)), jnp.int8)
    w_q = jnp.asarray(rng.integers(-127, 128, (ak, an)), jnp.int8)
    acc = jnp.einsum("mk,kn->mn", x_q.astype(jnp.int32),
                     w_q.astype(jnp.int32))
    flipped = acc.at[3, 7].add(1 << 12)
    clean = jabft.verify_rows(x_q, flipped, jabft.checksum_vector(w_q))
    assert got["flagged"] == np.flatnonzero(~np.asarray(clean)).tolist() \
        == [3]
    np.testing.assert_array_equal(_np(got["acc"]), np.asarray(acc))
    np.testing.assert_array_equal(_np(got["recovered"]), np.asarray(acc))


# ------------------------------------------------------------------- shipdet


def test_shipdet_pipeline_matches_reference():
    """``q_out`` on ``reduced_specs()`` bit for bit against the reference's
    forward (its oracle path) over the reference's parameters; the
    per-layer table covers every layer."""
    ex = load_example("shipdet_pipeline")
    specs = jshipdet.reduced_specs()
    jparams = jax.jit(lambda key: jshipdet.init_params(specs, key))(
        jax.random.key(0))
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, specs[0].h, specs[0].w, 3)).astype(
        np.float32)
    want, _ = jshipdet.forward(specs, jparams, jnp.asarray(frames),
                               use_kernel=False)
    got = ex.run(CPU, specs=tshipdet.reduced_specs(),
                 params=shipdet_params_from_numpy(jax.device_get(jparams),
                                                  device=CPU),
                 frames=torch.from_numpy(frames))
    np.testing.assert_array_equal(_np(got["q_out"]), np.asarray(want))
    assert len(got["layer_rel"]) == len(specs)
    assert got["err"] < 4 * got["step"]


# ------------------------------------------------------------------ campaign


def test_campaign_quickstart_verdicts(tmp_path):
    """The grid at 20 trials per configuration: ABFT and TMR without SDC,
    ABFT detecting every single bit flip, NONE with SDC under single bit
    flips (the verdicts of the reference's grid); the drills (20 trials
    each, the third on ``ref``) detect every fault and leave no corrupted
    output, as the reference's drill does on its own fault stream."""
    ex = load_example("campaign_quickstart")
    got = ex.run(CPU, trials=20, drill_trials=20, kernel_trials=20,
                 kernel_backend="ref", out_dir=tmp_path)
    assert (tmp_path / "campaign.json").exists()
    assert len(got["results"]) == 24
    for r in got["results"]:
        assert r.trials == 20
        if r.policy in ("abft", "tmr"):
            assert r.sdc == 0, r
        if r.fault_model == "single_bitflip" and r.policy == "abft":
            assert r.detected_corrected + r.detected_uncorrected == 20, r
        if r.fault_model == "single_bitflip" and r.policy == "none":
            assert r.sdc > 0, r
    spec = JCampaignSpec("qmatmul", JPolicy.ABFT, "accumulator",
                         "single_bitflip", trials=20, seed=42)
    det_j, mis_j = jbuild_case(spec.workload, spec.seed).run_trials(
        spec.policy, spec.site, jresolve_fault_model(spec.fault_model).apply,
        jtrial_keys(spec))
    for det, mis in (got["drill"], got["kernel_drill"], (det_j, mis_j)):
        assert len(det) == 20 and np.all(det) and not np.any(mis)


# ------------------------------------------------------------------ recovery


def test_recovery_quickstart_matches_reference():
    """Act 1 under one addressed weight flip given to both packages: the
    golden, ABFT and CKPT outputs and the detection counts bit for bit;
    act 2's saves and chunk counts equal the reference checkpointer's; acts
    3 and 4 heal (the script's own asserts)."""
    ex = load_example("recovery_quickstart")
    index, bit = 37 * 32 + 5, 6                  # w_q[37, 5], bit 6
    got = ex.run(CPU, w_flip=(index, bit))
    rng = np.random.default_rng(0)
    x_q = jnp.asarray(rng.integers(-128, 128, (16, 64)), jnp.int8)
    w_q = jnp.asarray(rng.integers(-127, 128, (64, 32)), jnp.int8)
    bias = jnp.zeros((32,), jnp.int32)
    scale = jnp.full((32,), 1e-3, jnp.float32)
    w_check = jabft.checksum_vector(w_q)
    flat = np.asarray(w_q).reshape(-1).copy()
    flat[index] = np.int8(np.uint8(flat[index].view(np.uint8) ^ (1 << bit))
                          .view(np.int8))
    w_bad = jnp.asarray(flat.reshape(64, 32))
    zero = jnp.int32(0)
    golden, _ = jdependable_qmatmul(JPolicy.NONE, x_q, zero, w_q, bias,
                                    scale, zero)
    y_ab, st_ab = jdependable_qmatmul(JPolicy.ABFT, x_q, zero, w_bad, bias,
                                      scale, zero, w_check=w_check)
    y_ck, st_ck = jdependable_qmatmul(JPolicy.CKPT, x_q, zero, w_bad, bias,
                                      scale, zero, w_check=w_check,
                                      ckpt=(x_q, w_q))
    for key, want in (("op_golden", golden), ("op_abft", y_ab),
                      ("op_ckpt", y_ck)):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want))
    assert got["op_abft_detected"] == int(st_ab["faults_detected"]) > 0
    assert got["op_ckpt_detected"] == int(st_ck["faults_detected"]) == 1
    assert got["op_ckpt_recovered"] == int(st_ck["faults_recovered"]) == 1

    state = {"w": jnp.asarray(rng.standard_normal((256, 256)), jnp.float32),
             "step": jnp.asarray(0, jnp.int32)}
    with tempfile.TemporaryDirectory() as d:
        with jckpt.IncrementalCheckpointer(d, chunk_bytes=16 * 1024) as c:
            c.save(1, state)
            c.save(2, {"w": state["w"].at[5, 5].set(9.0),
                       "step": jnp.asarray(2, jnp.int32)})
            c.wait()
            want = dict(c.stats)
    for key in ("saves", "chunks_written", "chunks_total"):
        assert got["ckpt_stats"][key] == want[key], key
    assert got["scrub_events"][0]["recovered"]
    assert got["incremental_restores"] == 1


# ------------------------------------------------- failing case and hygiene


@pytest.mark.parametrize("name", NAMES)
def test_example_cuda_without_card_raises(name):
    """The default ``--device cuda`` raises where there is no card; nothing
    drops to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would run")
    ex = load_example(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main([])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_repro(name):
    mods = list(_imports(EXAMPLES / f"{name}_torch.py"))
    assert any(m.startswith("repro_torch") for m in mods)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_kernels_export_the_reference_names():
    """Every name of ``repro.kernels.__all__`` is exported by
    ``repro_torch.kernels`` and bound to the port's own object."""
    missing = sorted(set(jkernels.__all__) - set(tkernels.__all__))
    assert not missing, missing
    for name in jkernels.__all__:
        obj = getattr(tkernels, name)
        mod = getattr(obj, "__module__", None) or obj.__name__
        assert mod.startswith("repro_torch."), (name, mod)
    assert tkernels.dispatch.matmul_acc is tkernels.matmul_acc
