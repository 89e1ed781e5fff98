"""Fault-tolerant checkpointing.

The counterpart of ``repro.train.checkpoint`` on one host, with the same
protocol and on-disk layout (npz shards + a JSON manifest):

  * **Atomic**: write to ``step_<n>.tmp/``, fsync, then ``rename``; a crash
    mid-write never corrupts the latest valid checkpoint.
  * **Integrity**: every array (or chunk) carries a crc32; restore verifies
    and refuses silently corrupted data.
  * **Retention**: the ``keep_n`` newest checkpoints are kept (and any step
    a kept incremental manifest still references), pruned only after the
    new write is durable.
  * **Incremental + async** (``IncrementalCheckpointer``): dirty-chunk
    tracking against mod-2^32 storage checksums, clean chunks referenced
    from the step that last wrote them, a background writer with bounded
    staleness, format-2 manifests published behind the same barrier;
    ``restore`` reassembles a chain bit for bit, ``restore_leaves`` reads
    single leaves.

Differences from the reference.  Leaves are flattened by their pytree
paths (``repro_torch.tree``: nested dicts, NamedTuples, lists, tuples) and
the tree's containers are stored as JSON (a NamedTuple by its import
path), not as a pickled treedef; nothing is pickled.  A torch leaf is
copied to host numpy when ``save`` is called, before the caller can change
it (bf16 as its 16-bit pattern, named "bfloat16" in the manifest), and
comes back from ``restore`` as a torch tensor on ``device`` (default the
card, as every entry of the port; a CPU caller says so); any other leaf
comes back as a numpy array, as in the reference.  There are no sharding
specs: the elastic restore onto a new mesh comes with parallelism
(ROADMAP.md queue 1, item 17).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tree

MANIFEST = "manifest.json"


def _to_host(leaf) -> Tuple[np.ndarray, str, str]:
    """(a host numpy copy, logical dtype, "torch" or "numpy")."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16", "torch"
        return t.numpy(), str(t.dtype).replace("torch.", ""), "torch"
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype), "numpy"


def _from_host(arr: np.ndarray, dtype: str, kind: str, device):
    if kind != "torch":
        return arr.astype(np.dtype(dtype), copy=False)
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _snapshot(state) -> List[Tuple[str, np.ndarray, str, str]]:
    return [(tree.path_str(path), *_to_host(leaf))
            for path, leaf in tree.leaves_with_paths(state)]


def _publish(tmp: Path, final: Path, manifest: dict) -> None:
    """Write the manifest, fsync it, then rename the step dir into place."""
    (tmp / MANIFEST).write_text(json.dumps(manifest))
    with open(tmp / MANIFEST, "rb") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)


def _fresh_tmp(ckpt_dir: Path, step: int) -> Path:
    tmp = ckpt_dir / f"step_{step:010d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    return tmp


def save(ckpt_dir: str | Path, step: int, state: Any,
         keep_n: int = 3) -> Path:
    """Atomically persist ``state`` (a pytree of tensors / arrays)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = _fresh_tmp(ckpt_dir, step)
    entries, arrays = [], {}
    for i, (path, arr, dtype, kind) in enumerate(_snapshot(state)):
        name = f"a{i:05d}"
        arrays[name] = arr
        entries.append({"name": name, "path": path, "shape": list(arr.shape),
                        "dtype": dtype, "kind": kind,
                        "crc32": zlib.crc32(arr.tobytes())})
    np.savez(tmp / "shards.npz", **arrays)
    final = _step_dir(ckpt_dir, step)
    _publish(tmp, final, {"step": step, "format": 1,
                          "structure": tree.structure(state),
                          "entries": entries, "n_processes": 1})
    _prune(ckpt_dir, keep_n)
    return final


def _step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:010d}"


def _prune(ckpt_dir: Path, keep_n: int):
    steps = sorted(d for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and not d.name.endswith(".tmp"))
    kept = steps[-keep_n:] if keep_n > 0 else steps
    # incremental (format-2) manifests reference chunks in earlier step
    # dirs: anything a kept manifest points at must survive the prune
    referenced = set()
    for d in kept:
        mf = d / MANIFEST
        if not mf.exists():
            continue
        manifest = json.loads(mf.read_text())
        if manifest.get("format", 1) >= 2:
            for leaf in manifest["leaves"]:
                for c in leaf["chunks"]:
                    referenced.add(_step_dir(ckpt_dir, c["step"]).name)
    for d in steps:
        if d not in kept and d.name not in referenced:
            shutil.rmtree(d)
    # clear any orphaned tmp dirs from crashed writers
    for d in ckpt_dir.glob("step_*.tmp"):
        shutil.rmtree(d)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.is_dir() and d.name.startswith("step_")
             and not d.name.endswith(".tmp") and (d / MANIFEST).exists()]
    return max(steps) if steps else None


def _resolve_step(ckpt_dir: Path, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return step


def _checked(arr: np.ndarray, crc: int, verify: bool, what: str):
    if verify and zlib.crc32(arr.tobytes()) != crc:
        raise IOError(f"checkpoint {what} failed crc32: corrupted data "
                      f"(SEU in storage path); refusing to restore")
    return arr


def restore(ckpt_dir: str | Path, step: Optional[int] = None,
            verify: bool = True, device="cuda") -> Tuple[int, Any]:
    """Load a checkpoint (the newest, or ``step``): (step, state), torch
    leaves on ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step = _resolve_step(ckpt_dir, step)
    d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / MANIFEST).read_text())
    if manifest.get("format", 1) >= 2:
        leaves = _assemble_incremental(ckpt_dir, manifest, verify, device)
    else:
        data = np.load(d / "shards.npz")
        leaves = [_from_host(_checked(data[e["name"]], e["crc32"], verify,
                                      f"shard {e['path']}"),
                             e["dtype"], e["kind"], device)
                  for e in manifest["entries"]]
    return step, tree.unflatten(manifest["structure"], leaves)


# ---------------------------------------------------------------------------
# Incremental + async checkpointing (format 2)
#
# Layout: every save publishes one step_<n>/ dir holding
#   chunks.npz       only the chunks whose mod-2^32 checksum changed
#   manifest.json    format=2: the tree's structure + per-leaf chunk table,
#                    each chunk tagged with the step whose chunks.npz holds
#                    its bytes (this step for dirty chunks, an earlier step
#                    for clean ones)
# so any manifest alone reconstructs the whole state, and the tmp→fsync→
# rename barrier makes each manifest all-or-nothing.
# ---------------------------------------------------------------------------


def u32_checksum(arr: np.ndarray) -> int:
    """Mod-2^32 sum over the array's raw bytes: a flipped bit changes the
    sum by ±2^b ≠ 0 (mod 2^32), whatever the dtype."""
    b = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
    return int(b.sum(dtype=np.uint64) & 0xFFFFFFFF)


def path_str(path) -> str:
    """The manifest's encoding of a pytree path."""
    return tree.path_str(path)


def _chunk_slices(n_elems: int, chunk_elems: int) -> List[Tuple[int, int]]:
    if n_elems == 0:
        return [(0, 0)]
    return [(i, min(i + chunk_elems, n_elems))
            for i in range(0, n_elems, chunk_elems)]


def _assemble_leaf(ckpt_dir: Path, leaf: dict, npz_cache: Dict[int, Any],
                   verify: bool, device):
    """Reassemble one leaf from its (possibly cross-step) chunk table."""
    parts = []
    for c in leaf["chunks"]:
        src = c["step"]
        if src not in npz_cache:
            npz_cache[src] = np.load(_step_dir(ckpt_dir, src) / "chunks.npz")
        parts.append(_checked(npz_cache[src][c["key"]], c["crc32"], verify,
                              f"chunk {leaf['path']}[{c['key']}] (stored in "
                              f"step {src})"))
    flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return _from_host(flat.reshape(leaf["shape"]), leaf["dtype"],
                      leaf["kind"], device)


def _assemble_incremental(ckpt_dir: Path, manifest: dict, verify: bool,
                          device) -> List[Any]:
    npz_cache: Dict[int, Any] = {}
    return [_assemble_leaf(ckpt_dir, leaf, npz_cache, verify, device)
            for leaf in manifest["leaves"]]


def restore_leaves(ckpt_dir: str | Path, paths: Sequence[str],
                   step: Optional[int] = None, verify: bool = True,
                   device="cuda") -> Dict[str, Any]:
    """Partial restore: only the named leaves (manifest ``path`` keys, e.g.
    ``"params/w"``) of the newest (or given) checkpoint, either format,
    every byte crc32-verified, torch leaves on ``device``.  Unknown paths
    are absent from the result (the caller decides whether to fall back to
    a full reload)."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    d = _step_dir(ckpt_dir, _resolve_step(ckpt_dir, step))
    manifest = json.loads((d / MANIFEST).read_text())
    want = set(paths)
    out: Dict[str, Any] = {}
    if manifest.get("format", 1) >= 2:
        npz_cache: Dict[int, Any] = {}
        for leaf in manifest["leaves"]:
            if leaf["path"] in want:
                out[leaf["path"]] = _assemble_leaf(ckpt_dir, leaf, npz_cache,
                                                   verify, device)
    else:
        data = np.load(d / "shards.npz")
        for e in manifest["entries"]:
            if e["path"] in want:
                arr = _checked(data[e["name"]], e["crc32"], verify,
                               f"shard {e['path']}")
                out[e["path"]] = _from_host(arr, e["dtype"], e["kind"],
                                            device)
    return out


def manifest_paths(ckpt_dir: str | Path,
                   step: Optional[int] = None) -> List[str]:
    """Every leaf path addressable in the newest (or given) checkpoint, in
    manifest order."""
    ckpt_dir = Path(ckpt_dir)
    step = _resolve_step(ckpt_dir, step)
    manifest = json.loads((_step_dir(ckpt_dir, step) / MANIFEST).read_text())
    key = "leaves" if manifest.get("format", 1) >= 2 else "entries"
    return [e["path"] for e in manifest[key]]


class IncrementalCheckpointer:
    """Async, incremental, crash-consistent checkpointer.

    ``save(step, state)`` copies the state to host memory at once (so the
    caller may go on changing its tensors) and returns; a background thread
    diffs per-chunk mod-2^32 checksums against the last durable checkpoint
    and writes only dirty chunks.  At most ``max_pending`` snapshots may be
    in flight before ``save`` blocks.  ``full_every=k`` forces every k-th
    save to rewrite all chunks (a rebase).  Writer errors are re-raised on
    the next ``save``/``wait``/``close``.
    """

    def __init__(self, ckpt_dir: str | Path, *, keep_n: int = 3,
                 chunk_bytes: int = 1 << 20, async_write: bool = True,
                 max_pending: int = 2, full_every: int = 0):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.chunk_bytes = int(chunk_bytes)
        self.full_every = int(full_every)
        self.async_write = async_write
        # path -> the chunk table of the last durable checkpoint, the
        # dirty-diff baseline
        self._baseline: Dict[str, List[dict]] = {}
        self.stats = {"saves": 0, "chunks_total": 0, "chunks_written": 0,
                      "bytes_written": 0}
        self._err: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_pending)))
        self._thread: Optional[threading.Thread] = None
        if async_write:
            self._thread = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- frontend
    def save(self, step: int, state: Any) -> None:
        """Snapshot ``state`` to host and schedule (or perform) the write."""
        self._raise_pending()
        item = (step, _snapshot(state), tree.structure(state))
        if self._thread is not None:
            self._q.put(item)                        # blocks at max_pending
        else:
            self._write(*item)

    def wait(self) -> None:
        """Block until every scheduled write is durable; re-raise errors."""
        if self._thread is not None:
            self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self.wait()
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    # -------------------------------------------------------------- backend
    def _writer_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except BaseException as e:               # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, snap, structure):
        # the rebase cadence counts durable saves, so a torn write retried
        # later lands the rebase on the same durable save it would have
        rebase = self.full_every > 0 and (
            (self.stats["saves"] + 1) % self.full_every == 0)
        tmp = _fresh_tmp(self.ckpt_dir, step)
        leaves_meta, arrays = [], {}
        new_baseline: Dict[str, List[dict]] = {}
        n_chunks = n_written = bytes_written = 0
        for i, (pstr, arr, dtype, kind) in enumerate(snap):
            flat = np.ascontiguousarray(arr).reshape(-1)
            chunk_elems = max(1, self.chunk_bytes // max(arr.dtype.itemsize,
                                                         1))
            old = self._baseline.get(pstr)
            chunks = []
            for ci, (lo, hi) in enumerate(_chunk_slices(flat.size,
                                                        chunk_elems)):
                piece = flat[lo:hi]
                csum = u32_checksum(piece)
                key = f"a{i:05d}_c{ci:04d}"
                prev = old[ci] if old is not None and ci < len(old) else None
                n_chunks += 1
                if (not rebase and prev is not None
                        and prev["checksum"] == csum
                        and prev["shape"] == [int(hi - lo)]):
                    # clean chunk: reference the step that last wrote it
                    chunks.append(dict(prev))
                else:
                    arrays[key] = piece
                    chunks.append({"key": key, "step": step,
                                   "crc32": zlib.crc32(piece.tobytes()),
                                   "checksum": csum, "shape": [int(hi - lo)]})
                    n_written += 1
                    bytes_written += int(piece.nbytes)
            leaves_meta.append({
                "path": pstr, "shape": list(arr.shape), "dtype": dtype,
                "kind": kind, "chunk_elems": int(chunk_elems),
                "chunks": chunks,
            })
            new_baseline[pstr] = chunks

        np.savez(tmp / "chunks.npz", **arrays)
        _publish(tmp, _step_dir(self.ckpt_dir, step),
                 {"step": step, "format": 2, "rebase": bool(rebase),
                  "structure": structure, "leaves": leaves_meta,
                  "n_processes": 1})
        # only now, after the rename barrier, do the baseline and the
        # accounting reflect this save; a crash before this point leaves the
        # previous chain, stats and rebase cadence intact
        self._baseline = new_baseline
        self.stats["saves"] += 1
        self.stats["chunks_total"] += n_chunks
        self.stats["chunks_written"] += n_written
        self.stats["bytes_written"] += bytes_written
        _prune(self.ckpt_dir, self.keep_n)

    # ------------------------------------------------------------- utility
    def dirty_fraction(self) -> float:
        """Fraction of chunks actually rewritten over the checkpointer's
        lifetime (1.0: every save was a full write)."""
        return self.stats["chunks_written"] / max(self.stats["chunks_total"],
                                                  1)
