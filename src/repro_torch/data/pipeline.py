"""Deterministic token streams for training.

The counterpart of the single-host part of ``repro.data.pipeline``, numpy
only: batch ``i`` is a pure function of (seed, i, host) drawn from numpy's
Philox with the reference's key and counter, so the port's batches are bit
for bit the reference's and a restore from a checkpoint continues on the
same data with no loader state to persist.  ``n_hosts``/``host_id``
default to one host.  ``prefetch`` streams batches through a bounded
``Channel`` from a producer thread, as the dataflow executor's stages
do.  ``shard_batch`` gives each rank of a mesh its slice of a host
batch.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ArchConfig, ShapeConfig


class TokenStream:
    """Deterministic synthetic LM token stream (zipf-flavoured marginals,
    so losses are non-degenerate)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                 n_hosts: int = 1, host_id: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id
        if shape.global_batch % self.n_hosts:
            raise ValueError(
                f"global_batch {shape.global_batch} not divisible by "
                f"{self.n_hosts} hosts")
        self.host_batch = shape.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host): int32 ``tokens`` and
        ``labels`` (B, S), the labels shifted by one."""
        B, S, V = self.host_batch, self.shape.seq_len, self.cfg.vocab_size
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, step, self.host_id]))
        z = rng.zipf(1.3, size=(B, S + 1))
        tokens = np.minimum(z - 1, V - 1).astype(np.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.cfg.input_mode == "embeddings":
            batch["embeds"] = rng.standard_normal(
                (B, S, self.cfg.d_model), dtype=np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MmapCorpus:
    """Token-id corpus on disk (np.memmap of int32), deterministic strided
    reads."""

    def __init__(self, path: str, cfg: ArchConfig, shape: ShapeConfig,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.n_hosts, self.host_id = n_hosts, host_id
        self.host_batch = shape.global_batch // n_hosts
        self.n_windows = (len(self.data) - 1) // shape.seq_len
        if self.n_windows < 1:
            raise ValueError("corpus shorter than one sequence")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.host_batch, self.shape.seq_len
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 1, step, self.host_id]))
        idx = rng.integers(0, self.n_windows, size=B)
        rows = np.stack([self.data[i * S:i * S + S + 1] for i in idx])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}


def prefetch(source, start_step: int = 0, depth: int = 2):
    """Double-buffered prefetch: synthesize batch i+1 while i is consumed.

    One ``SourceStage`` producing ``(step, source.batch_at(step))`` runs
    under the threaded driver, blocking on a bounded ``Channel`` of depth
    ``depth``.  The consumer side is an iterator; ``close()`` closes the
    channel, which unblocks and joins the producer.
    """
    from repro_torch.runtime.dataflow import (Channel, Closed, SourceStage,
                                              ThreadedSource)
    ch = Channel(depth, name="prefetch")
    stage = SourceStage(lambda step: (step, source.batch_at(step)),
                        ch, start=start_step)
    driver = ThreadedSource(stage).start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            try:
                return ch.get()
            except Closed:
                raise StopIteration from None

        def close(self):
            driver.close()

    return _Iter()


def shard_batch(batch: Dict[str, np.ndarray], mesh, dp_axes,
                device=None) -> Dict[str, "torch.Tensor"]:
    """This rank's slice of a host batch, the batch dim over ``dp_axes``
    (the reference's ``NamedSharding(mesh, P(dp_axes, None, ...))``), as
    torch tensors on ``device`` (by default the mesh's)."""
    import torch
    from repro_torch.parallel.sharding import P, local_slices
    device = mesh.device if device is None else torch.device(device)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        sl = local_slices(P(dp_axes), v.shape, mesh, name=f"batch[{k!r}]")
        out[k] = torch.from_numpy(np.ascontiguousarray(v[sl])).to(device)
    return out
