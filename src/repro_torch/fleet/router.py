"""Deterministic request dispatch with admission control.

A copy of ``repro.fleet.router`` (pure Python).  The router is the
fleet's front door: every request is either assigned to exactly one healthy
replica or rejected outright (admission control), and the decision is a
pure function of (request uid, replica states, loads) — no wall clock, no
randomness — so a campaign trial replays bit-exactly and a failover replay
lands deterministically.

Two dispatch policies:

  hash          crc32(uid) over the healthy replicas — stable assignment,
                cache-friendly (a retried uid lands on the same replica
                while the fleet composition is unchanged)
  least_loaded  fewest owned requests wins, ties to the lowest rid —
                classic shortest-queue dispatch
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

from repro_torch.fleet.replica import Replica

POLICIES = ("least_loaded", "hash")


class Router:
    def __init__(self, policy: str = "least_loaded",
                 admit_limit: Optional[int] = None):
        """``admit_limit``: max owned requests per replica before the fleet
        refuses new work (None == unbounded)."""
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"known: {POLICIES}")
        self.policy = policy
        self.admit_limit = admit_limit

    def _room(self, r: Replica) -> bool:
        return self.admit_limit is None or r.load() < self.admit_limit

    def pick(self, uid: int, replicas: Sequence[Replica],
             exclude: Sequence[int] = ()) -> Optional[Replica]:
        """Choose the serving replica for a request, or None to reject.

        ``exclude``: rids to avoid (DMR shadow placement, failover away from
        the replica that just lost the request).

        A replica mid-swap in a rolling deploy advertises ``routable=False``
        — healthy (it keeps decoding what it owns) but closed to new work
        until it re-verifies against the new checksums.
        """
        healthy: List[Replica] = [
            r for r in replicas
            if r.healthy and getattr(r, "routable", True)
            and r.rid not in exclude]
        if not healthy:
            return None
        if self.policy == "hash":
            r = healthy[zlib.crc32(str(uid).encode()) % len(healthy)]
            return r if self._room(r) else None
        # least_loaded with room; ties broken by lowest rid (list order)
        candidates = [r for r in healthy if self._room(r)]
        if not candidates:
            return None
        return min(candidates, key=lambda r: (r.load(), r.rid))
