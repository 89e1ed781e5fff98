"""Dependable serving fleet: N supervised Engine replicas behind a
deterministic router, with ABFT weight scrubbing, checkpoint-reload
recovery, DMR pair-serving, and bit-exact failover.

See docs/fleet.md for the architecture and the recovery state machine, and
``python -m repro_torch.fleet.cli --help`` for the drill runner.
"""
from repro_torch.fleet.fleet import FLEET_POLICIES, TRANSPORTS, Fleet
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.replica import Replica, ReplicaState
from repro_torch.fleet.router import Router
from repro_torch.fleet.supervisor import Supervisor
from repro_torch.fleet.transport import ProcReplica, TransportDead, WorkerHandle

__all__ = [
    "FLEET_POLICIES", "TRANSPORTS", "Fleet", "FleetMetrics", "ProcReplica",
    "Replica", "ReplicaState", "Router", "Supervisor", "TransportDead",
    "WorkerHandle",
]
