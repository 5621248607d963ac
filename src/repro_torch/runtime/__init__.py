"""Service runtime: heartbeats and stragglers, elastic mesh plans, the
training supervisor, service snapshots and the supervised service restart."""

from repro_torch.runtime.elastic import plan_mesh, plan_mesh_slots, shrink_plan
from repro_torch.runtime.heartbeat import HeartbeatRegistry, StragglerDetector
from repro_torch.runtime.resilience import (
    ServiceCheckpointer,
    ServiceSupervisor,
    kill_shard_once,
    replan_spec,
)
from repro_torch.runtime.supervisor import SimulatedFailure, Supervisor

__all__ = [
    "HeartbeatRegistry",
    "StragglerDetector",
    "plan_mesh",
    "plan_mesh_slots",
    "shrink_plan",
    "Supervisor",
    "SimulatedFailure",
    "ServiceCheckpointer",
    "ServiceSupervisor",
    "kill_shard_once",
    "replan_spec",
]
