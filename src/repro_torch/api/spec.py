"""RecoverySpec: one declarative record of what to recover and how to run it.

Counterpart of ``repro/api/spec.py``, offline fields only, QAT included.
``mode="batch"``, ``mode="stream"`` and ``precision="int8_pwl"`` are not yet
ported and raise when the spec is built.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.merinda import MRConfig
from repro_torch.core.quant import QuantConfig

MODES = ("offline", "batch", "stream")
PRECISIONS = ("fp32", "int8_pwl")
PORTED_MODES = ("offline",)
PORTED_PRECISIONS = ("fp32",)


@dataclasses.dataclass(frozen=True)
class RecoverySpec:
    # -- model / library shape ---------------------------------------------
    state_dim: int  # n = |Y|
    input_dim: int = 0  # m = |U|
    order: int = 2  # library polynomial order
    hidden: int = 32  # encoder width V
    dense_hidden: int | None = None  # head width (None = 2 * hidden)
    n_shifts: int = 0  # q input-shift outputs
    dt: float = 0.05
    solver: str = "rk4"
    ltc_substeps: int = 6  # solver substeps per input step of the ltc/node encoders
    lambda_sparse: float = 1e-3
    recon_weight: float = 1.0

    # -- numerics / lowering -----------------------------------------------
    encoder: str = "gru_flow"  # any name registered in core/encoders.py
    precision: str = "fp32"  # serving readout
    qat: QuantConfig | None = None  # fixed-point fake-quant during training
    fused: bool = False  # stage-fused per-window step (kernels/mr_step)
    block_b: int | str | None = None  # fused batch tile: int, None, or "auto"
    # shared memory the "auto" tile fits into; None = one block's 227 KB
    smem_budget_bytes: int | None = None

    # -- execution ----------------------------------------------------------
    mode: str = "offline"
    steps: int = 500  # optimizer steps
    lr: float = 3e-3
    batch_size: int | None = None  # windows per optimizer step (None = all)
    seed: int = 0
    n_active: int | None = None  # magnitude-prune readout to this many terms

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.mode not in PORTED_MODES:
            raise ValueError(f"mode={self.mode!r} is not yet ported to repro_torch")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")
        if self.precision not in PORTED_PRECISIONS:
            raise ValueError(f"precision={self.precision!r} is not yet ported to repro_torch")
        if self.state_dim < 1 or self.input_dim < 0 or self.order < 1:
            raise ValueError(
                f"bad library shape: state_dim={self.state_dim} "
                f"input_dim={self.input_dim} order={self.order}"
            )
        if isinstance(self.block_b, str):
            if self.block_b != "auto":
                raise ValueError(f'block_b must be an int, None or "auto", got {self.block_b!r}')
        elif self.block_b is not None and self.block_b < 1:
            raise ValueError(f"block_b must be >= 1, got {self.block_b}")
        if self.smem_budget_bytes is not None and self.block_b != "auto":
            raise ValueError(
                'smem_budget_bytes requires block_b="auto" (a fixed tile ignores the budget)'
            )

    def to_mr_config(self, block_b: int | None = None) -> MRConfig:
        """The MRConfig this spec lowers to; ``block_b`` is the resolved tile."""
        if block_b is None and isinstance(self.block_b, int):
            block_b = self.block_b
        return MRConfig(
            state_dim=self.state_dim,
            input_dim=self.input_dim,
            order=self.order,
            hidden=self.hidden,
            dense_hidden=self.dense_hidden or 2 * self.hidden,
            encoder=self.encoder,
            n_shifts=self.n_shifts,
            dt=self.dt,
            solver=self.solver,
            ltc_substeps=self.ltc_substeps,
            lambda_sparse=self.lambda_sparse,
            recon_weight=self.recon_weight,
            quant=self.qat,
            fused=self.fused,
            block_b=block_b,
        )
