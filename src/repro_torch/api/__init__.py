"""repro_torch.api: the plan/compile/run surface of the port (``repro/api``).

    from repro_torch import api

    plan = api.compile_plan(api.RecoverySpec(state_dim=2, fused=True, block_b="auto"))
    params, metrics = plan.run_offline(yw, norm=norm)
    theta = plan.readout(params, yw, norm=norm, n_active=4)

    plan = api.compile_plan(api.RecoverySpec(state_dim=3, mode="stream",
                                             tick=api.TickSpec(tick_kernel="banked")))
    service = plan.make_service()
"""

from repro_torch.api.plan import Lowering, RecoveryPlan, compile_plan
from repro_torch.api.spec import MODES, PRECISIONS, RecoverySpec, TickSpec
from repro_torch.core.engine import history_from_metrics
from repro_torch.core.merinda import prune_theta

__all__ = [
    "MODES",
    "PRECISIONS",
    "Lowering",
    "RecoveryPlan",
    "RecoverySpec",
    "TickSpec",
    "compile_plan",
    "history_from_metrics",
    "prune_theta",
]
