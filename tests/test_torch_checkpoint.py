"""The port's checkpoint protocol: atomicity, integrity, retention,
incremental chains and the async writer.

Mirrors tests/test_checkpoint.py (the mesh case waits for parallelism, and
the hypothesis property case becomes seeded examples), and adds what the
port's torch leaves need: bf16 tensors and a ``TrainState`` round trip, and
a checkpoint the reference wrote and the port wrote holding the same bytes
under the same paths.  Every comparison is exact.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch import tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import TrainState

jax.config.update("jax_platform_name", "cpu")


def small_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g),
                       "b": torch.zeros((16,))},
            "opt": {"m": torch.ones((8, 16)) * 0.5},
            "step": torch.tensor(7, dtype=torch.int32)}


def assert_same(a, b):
    la, lb = tree.leaves_with_paths(a), tree.leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), tree.path_str(p)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), tree.path_str(p)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _mutate(state, r=-1.0):
    w = state["params"]["w"].clone()
    w[0, 0] = r
    return tree.replace(state, ("params", "w"), w)


def test_save_restore_roundtrip(tmp_path):
    state = small_state()
    ckpt.save(tmp_path, 7, state)
    step, restored = ckpt.restore(tmp_path)
    assert step == 7
    assert_same(state, restored)


def test_bf16_and_train_state_roundtrip(tmp_path):
    """bf16 leaves keep their bits; a NamedTuple comes back as itself."""
    s = small_state()
    st = TrainState({"w": s["params"]["w"].to(torch.bfloat16),
                     "b": s["params"]["b"]},
                    {"m": {"w": s["opt"]["m"], "b": s["params"]["b"]}},
                    s["step"])
    ckpt.save(tmp_path / "full", 3, st)
    _, r = ckpt.restore(tmp_path / "full")
    assert isinstance(r, TrainState)
    assert_same(st, r)
    with ckpt.IncrementalCheckpointer(tmp_path / "inc",
                                      async_write=False) as c:
        c.save(3, st)
    _, r2 = ckpt.restore(tmp_path / "inc")
    assert_same(st, r2)
    man = json.loads((tmp_path / "inc" / "step_0000000003" /
                      "manifest.json").read_text())
    assert {leaf["path"]: leaf["dtype"] for leaf in man["leaves"]}[
        "params/w"] == "bfloat16"


def test_latest_step_and_retention(tmp_path):
    state = small_state()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, state, keep_n=2)
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(d.name for d in Path(tmp_path).iterdir())
    assert kept == ["step_0000000004", "step_0000000005"]
    assert ckpt.latest_step(tmp_path / "none") is None


def test_atomicity_orphan_tmp_ignored(tmp_path):
    """A crashed writer leaves step_N.tmp; restore must ignore it."""
    state = small_state()
    ckpt.save(tmp_path, 3, state)
    orphan = Path(tmp_path) / "step_0000000004.tmp"
    orphan.mkdir()
    (orphan / "garbage").write_text("crash")
    assert ckpt.latest_step(tmp_path) == 3
    step, _ = ckpt.restore(tmp_path)
    assert step == 3


def test_crc_detects_corruption(tmp_path):
    """The SEU-in-storage threat model: a flipped bit must be caught."""
    d = ckpt.save(tmp_path, 1, small_state())
    shards = d / "shards.npz"
    raw = bytearray(shards.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    shards.write_bytes(bytes(raw))
    with pytest.raises((IOError, ValueError, Exception)):
        ckpt.restore(tmp_path, 1)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "nope")


@pytest.mark.parametrize("seed", range(6))
def test_checkpoint_roundtrip_nested_trees(seed, tmp_path):
    """Seeded nested pytrees of any shape and dtype (numpy and torch
    leaves, lists and tuples) survive save → restore bit-exactly, in both
    formats."""
    rng = np.random.default_rng(seed)

    def make(d):
        if d == 0:
            shape = tuple(int(x) for x in rng.integers(1, 5,
                                                       rng.integers(0, 3)))
            arr = np.asarray(rng.standard_normal(shape) * 10).astype(
                rng.choice([np.float32, np.int32, np.float64]))
            return torch.from_numpy(arr) if rng.random() < 0.5 else arr
        kids = [make(d - 1) for _ in range(int(rng.integers(1, 4)))]
        kind = rng.integers(0, 3)
        if kind == 0:
            return {f"k{i}": c for i, c in enumerate(kids)}
        return kids if kind == 1 else tuple(kids)

    state = {"tree": make(seed % 3 + 1), "step": np.int64(seed)}
    ckpt.save(tmp_path / "full", 1, state)
    assert_same(state | {"step": np.asarray(state["step"])},
                ckpt.restore(tmp_path / "full")[1])
    with ckpt.IncrementalCheckpointer(tmp_path / "inc", async_write=False,
                                      chunk_bytes=16) as c:
        c.save(1, state)
    assert_same(state | {"step": np.asarray(state["step"])},
                ckpt.restore(tmp_path / "inc")[1])


def test_manifest_paths_and_bytes_match_reference(tmp_path):
    """The port and the reference write the same state under the same
    leaf paths and the same bytes (crc32)."""
    state = small_state()
    jstate = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), state)
    ckpt.save(tmp_path / "port", 7, state)
    jckpt.save(tmp_path / "ref", 7, jstate)
    assert ckpt.manifest_paths(tmp_path / "port") == \
        jckpt.manifest_paths(tmp_path / "ref")
    crcs = [[(e["path"], e["crc32"], e["shape"]) for e in json.loads(
        (tmp_path / d / "step_0000000007" / "manifest.json").read_text())[
            "entries"]] for d in ("port", "ref")]
    assert crcs[0] == crcs[1]


# ------------------- incremental + async checkpointing ----------------------


def test_incremental_restore_bit_identical_to_full(tmp_path):
    state = small_state()
    state2 = _mutate(state)
    inc_dir, full_dir = tmp_path / "inc", tmp_path / "full"
    with ckpt.IncrementalCheckpointer(inc_dir, async_write=False) as c:
        c.save(1, state)
        c.save(2, state2)
    ckpt.save(full_dir, 2, state2)
    s_inc, r_inc = ckpt.restore(inc_dir)
    s_full, r_full = ckpt.restore(full_dir)
    assert s_inc == s_full == 2
    assert_same(r_inc, r_full)


def test_incremental_writes_only_dirty_chunks(tmp_path):
    state = small_state()
    with ckpt.IncrementalCheckpointer(tmp_path, async_write=False,
                                      chunk_bytes=128) as c:
        c.save(1, state)
        first = c.stats["chunks_written"]
        c.save(2, _mutate(state))              # one element changed
        assert c.stats["chunks_written"] == first + 1
        c.save(3, _mutate(state))              # nothing changed since step 2
        assert c.stats["chunks_written"] == first + 1
        assert c.dirty_fraction() < 1.0


def test_async_writer_bounded_staleness_and_durability(tmp_path):
    state = small_state()
    with ckpt.IncrementalCheckpointer(tmp_path, async_write=True,
                                      max_pending=2) as c:
        for s in range(1, 6):
            c.save(s, _mutate(state, float(s)))
        c.wait()
        assert ckpt.latest_step(tmp_path) == 5
    _, restored = ckpt.restore(tmp_path)
    assert float(restored["params"]["w"][0, 0]) == 5.0


def test_crash_mid_write_restores_last_durable_manifest(tmp_path,
                                                        monkeypatch):
    """Kill the writer between the data write and the manifest publish: the
    half-written step must be invisible and the previous chain bit-exact."""
    state = small_state()
    state2 = _mutate(state)
    c = ckpt.IncrementalCheckpointer(tmp_path, async_write=False)
    c.save(1, state)
    real_rename = os.rename

    def crash_rename(src, dst):
        raise OSError("simulated power loss before publish")

    monkeypatch.setattr(os, "rename", crash_rename)
    with pytest.raises(OSError):
        c.save(2, state2)
    monkeypatch.setattr(os, "rename", real_rename)
    assert ckpt.latest_step(tmp_path) == 1
    step, restored = ckpt.restore(tmp_path)
    assert step == 1
    assert_same(state, restored)
    c.save(2, state2)
    assert ckpt.latest_step(tmp_path) == 2
    assert not list(Path(tmp_path).glob("*.tmp"))
    assert_same(state2, ckpt.restore(tmp_path)[1])


def test_restore_leaves_partial_matches_full(tmp_path):
    state = small_state()
    ckpt.save(tmp_path / "full", 1, state)              # format 1
    with ckpt.IncrementalCheckpointer(tmp_path / "inc",
                                      async_write=False) as c:
        c.save(1, state)
        c.save(2, _mutate(state))                       # format 2, chained
    for d, ref in ((tmp_path / "full", state),
                   (tmp_path / "inc", _mutate(state))):
        leaves = ckpt.restore_leaves(d, ["params/w", "opt/m"])
        assert set(leaves) == {"params/w", "opt/m"}
        assert torch.equal(leaves["params/w"], ref["params"]["w"])
        assert torch.equal(leaves["opt/m"], ref["opt"]["m"])
    assert ckpt.restore_leaves(tmp_path / "inc", ["no/such"]) == {}


def test_incremental_chunk_crc_detects_storage_seu(tmp_path):
    with ckpt.IncrementalCheckpointer(tmp_path, async_write=False) as c:
        c.save(1, small_state())
    shards = Path(tmp_path) / "step_0000000001" / "chunks.npz"
    raw = bytearray(shards.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    shards.write_bytes(bytes(raw))
    with pytest.raises((IOError, ValueError, Exception)):
        ckpt.restore(tmp_path, 1)


def test_retention_keeps_chain_referenced_dirs(tmp_path):
    state = small_state()
    with ckpt.IncrementalCheckpointer(tmp_path, async_write=False,
                                      keep_n=2) as c:
        for s in range(1, 7):
            c.save(s, _mutate(state, float(s)))
    names = sorted(d.name for d in Path(tmp_path).iterdir())
    assert "step_0000000006" in names and "step_0000000005" in names
    assert "step_0000000001" in names
    _, restored = ckpt.restore(tmp_path)
    assert float(restored["params"]["w"][0, 0]) == 6.0


def test_async_save_snapshots_before_caller_mutates(tmp_path):
    """save() captures the state at call time: a tensor the caller changes
    in place after save() returns does not leak into the durable bytes."""
    w = torch.zeros((64, 64))
    a = np.zeros((8,), np.float32)
    with ckpt.IncrementalCheckpointer(tmp_path, async_write=True) as c:
        c.save(1, {"w": w, "a": a})
        w.fill_(7.0)
        a[:] = 7.0
        c.wait()
    _, restored = ckpt.restore(tmp_path)
    assert torch.equal(restored["w"], torch.zeros((64, 64)))
    np.testing.assert_array_equal(restored["a"], np.zeros((8,), np.float32))


def test_failed_write_does_not_corrupt_stats_or_rebase(tmp_path,
                                                       monkeypatch):
    state = small_state()
    c = ckpt.IncrementalCheckpointer(tmp_path, async_write=False,
                                     full_every=2)
    c.save(1, state)
    before = dict(c.stats)
    real_rename = os.rename
    monkeypatch.setattr(os, "rename",
                        lambda s, d: (_ for _ in ()).throw(OSError("torn")))
    with pytest.raises(OSError):
        c.save(2, _mutate(state))
    monkeypatch.setattr(os, "rename", real_rename)
    assert c.stats == before
    c.save(2, _mutate(state))
    assert c.stats["saves"] == 2
    man = json.loads((Path(tmp_path) / "step_0000000002" /
                      "manifest.json").read_text())
    assert man["rebase"] is True


def test_async_writer_error_is_reraised(tmp_path, monkeypatch):
    """A checkpointer that cannot persist does not fail silently: the
    writer thread's error comes back on the next wait()."""
    c = ckpt.IncrementalCheckpointer(tmp_path, async_write=True)
    c.save(1, small_state())
    c.wait()

    def full_disk(*a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(ckpt.np, "savez", full_disk)
    c.save(2, _mutate(small_state()))
    with pytest.raises(OSError, match="no space"):
        c.wait()
    monkeypatch.undo()
    c.close()
    assert ckpt.latest_step(tmp_path) == 1
