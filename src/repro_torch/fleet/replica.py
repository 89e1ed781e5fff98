"""One supervised serving replica: an Engine plus its dependability lifecycle.

The counterpart of ``repro.fleet.replica``.  The replica is the fleet's
unit of failure.  Its state machine is the recovery loop (quarantine →
reload → re-verify → readmit), driven by the supervisor:

    HEALTHY ──scrub fail / heartbeat loss──▶ QUARANTINED
    QUARANTINED ──checkpoint reload──▶ RECOVERING
    RECOVERING ──re-verify ok──▶ HEALTHY   (readmitted, recoveries += 1)
    RECOVERING ──re-verify fail──▶ DEAD
    any ──kill──▶ DEAD

Weight integrity is judged against deploy-time storage checksums
(``core.abft.storage_checksums``): computed once from the known-good params,
carried by every replica, exact mod 2^32.

Where torch differs from JAX: a replica lives on one device (that of its
params), and every leaf it reloads or patches is put on that device with
the leaf's own dtype and shape; a scrub reads its per-leaf verdicts back in
one host sync.  In-process replicas share parameter tensors, so nothing
here writes into a leaf: a reload or patch builds new leaves and new
containers, and the leaves it does not name stay shared.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

import torch

from repro_torch import tree
from repro_torch.core import abft
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.serving import Engine, Request
from repro_torch.train import checkpoint as ckpt_mod


class ReplicaState(str, enum.Enum):
    HEALTHY = "healthy"
    QUARANTINED = "quarantined"
    RECOVERING = "recovering"
    DEAD = "dead"


def bad_paths(params, golden) -> List[str]:
    """Manifest paths (``train/checkpoint.path_str``) of the leaves of
    ``params`` whose storage checksums differ from ``golden``, in leaf
    order; one host readback."""
    flags = tree.leaves_with_paths(abft.verify_storage(params, golden))
    if not flags:
        return []
    ok = torch.stack([f for _, f in flags]).cpu().numpy()
    return [ckpt_mod.path_str(path)
            for (path, _), good in zip(flags, ok) if not good]


def as_leaf(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``value`` on ``like``'s device with its dtype: a tensor already so
    placed is returned as it is (leaves are never written in place, so
    sharing one is safe).  A leaf of another shape is refused."""
    if value.shape != like.shape:
        raise ValueError(f"leaf of shape {tuple(value.shape)} where the "
                         f"live leaf is {tuple(like.shape)}")
    return value.to(device=like.device, dtype=like.dtype)


def _patched(params, leaves: Dict[str, torch.Tensor]):
    """A new tree: the named leaves replaced (on the replica's device), the
    others shared."""
    flat = tree.leaves_with_paths(params)
    out = []
    for path, leaf in flat:
        p = ckpt_mod.path_str(path)
        out.append(as_leaf(leaves[p], leaf) if p in leaves else leaf)
    return tree.unflatten(tree.structure(params), out)


class Replica:
    """An ``Engine`` wrapped with identity, health state, and scrub support."""

    def __init__(self, rid: int, cfg: ArchConfig, params, *,
                 capacity: int = 4, max_len: int = 128, prefill_pad: int = 8,
                 snapshot_every: int = 16, eos_id: int = -1,
                 golden=None, compiled=None, backend: Optional[str] = None,
                 state_scrub: str = "off"):
        self.rid = rid
        self.engine = Engine(cfg, params, capacity=capacity, max_len=max_len,
                             prefill_pad=prefill_pad,
                             snapshot_every=snapshot_every, eos_id=eos_id,
                             compiled=compiled, backend=backend,
                             state_scrub=state_scrub)
        self.state = ReplicaState.HEALTHY
        self.paused = False          # test hook: stop heartbeating (looks dead)
        self.routable = True         # False while a rolling deploy swaps us
        self.golden = golden if golden is not None \
            else abft.storage_checksums(params)
        self.uncertified: List[Request] = []   # finished, awaiting clean scrub
        self.recoveries = 0
        self.last_clean_scrub_tick = 0
        self.last_scrub_bad: List[str] = []    # verdict of the newest scrub

    @property
    def device(self) -> torch.device:
        """The device the replica's engine, params and restores live on."""
        return self.engine.executor.device

    def install_certifier(self, gate) -> None:
        """Wire the fleet's release gate into this replica's certify stage:
        every request the engine finishes passes through
        ``gate(replica, req)`` before it may release."""
        self.engine.certify = lambda req: gate(self, req)

    # --------------------------------------------------------------- status
    @property
    def healthy(self) -> bool:
        return self.state is ReplicaState.HEALTHY and not self.paused

    def load(self) -> int:
        """Requests this replica's pipeline currently owns — router's cost."""
        return self.engine.executor.pending_count()

    def in_flight(self) -> List[Request]:
        """Every request in the replica's pipeline, in deterministic
        stage-then-slot order (the order failover drains replay in)."""
        return self.engine.executor.in_flight()

    # ---------------------------------------------------------------- scrub
    def scrub(self) -> List[str]:
        """Verify live weights against deploy-time checksums; returns the
        manifest paths of corrupted leaves ([] == clean), directly a
        ``restore_leaves`` read-list."""
        self.last_scrub_bad = bad_paths(self.engine.params, self.golden)
        return self.last_scrub_bad

    # ------------------------------------------------------------- recovery
    def reload(self, params):
        """Replace params with a known-good copy (each leaf on the
        replica's device) and clear all run state."""
        live = self.engine.params
        self.engine.reset(params=tree.map(as_leaf, params, live))
        self.uncertified = []

    def reload_leaves(self, leaves: Dict[str, torch.Tensor]):
        """Incremental reload: patch only the named leaves (checkpoint-
        manifest paths → golden values) into new params, then clear run
        state."""
        self.engine.reset(params=_patched(self.engine.params, leaves))
        self.uncertified = []

    def patch_leaves(self, leaves: Dict[str, torch.Tensor], golden=None):
        """Live weight swap for zero-drain rolling deploys: the named leaves
        replaced *without* resetting the pipeline, so in-flight decodes see
        the new weights on their next step.  ``golden`` (the new deploy's
        storage checksums, computed from the checkpoint store) replaces the
        scrub baseline."""
        self.engine.params = _patched(self.engine.params, leaves)
        if golden is not None:
            self.golden = golden

    def reset(self, params=None):
        """Full revival for a new trial/run: fresh engine state, HEALTHY."""
        if params is not None:
            params = tree.map(as_leaf, params, self.engine.params)
        self.engine.reset(params=params)
        self.uncertified = []
        self.state = ReplicaState.HEALTHY
        self.paused = False
        self.last_clean_scrub_tick = 0
        self.last_scrub_bad = []
