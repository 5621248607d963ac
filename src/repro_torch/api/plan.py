"""compile_plan: lower a RecoverySpec into a RecoveryPlan (``repro/api/plan.py``).

Every execution decision (encoder backend, fusion, QAT, the ``block_b`` tile,
where the kernels run) is resolved once, into one :class:`Lowering` record.
Plans run on the card: ``compile_plan(spec)`` resolves the device to
``"cuda"`` and raises when no card is visible. ``device="cpu"`` runs every
kernel's plain version on the CPU, as the tests do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.spec import RecoverySpec
from repro_torch.core import encoders, engine
from repro_torch.core.library import denormalize_theta
from repro_torch.core.merinda import MRConfig, init_mr, mr_forward, prune_theta
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.mr_step import tiling
from repro_torch.optim import adamw_init


@dataclasses.dataclass(frozen=True)
class Lowering:
    """Every resolved execution decision, in one record.

    ``dispatch`` is ``"cuda"`` when the recovery stage runs through a
    hand-written kernel on the card, ``"reference"`` when it runs the plain
    PyTorch version (on the CPU, or an encoder that routes through no kernel).
    """

    encoder: str
    fused: bool
    kernel: bool  # encoder row routes through the gru_scan kernel
    qat: bool  # fixed-point fake-quant during training (spec.qat)
    dispatch: str  # "cuda" | "reference"
    block_b: int | None  # resolved fused-stage batch tile (None = fitted per call)
    smem_bytes: int | None  # the row family's fused kernel's shared memory per block
    smem_budget_bytes: int | None  # the budget the "auto" tile fit into
    device: str


class RecoveryPlan:
    """A compiled recovery: spec + lowering; ``run_offline`` then ``readout``."""

    def __init__(self, spec: RecoverySpec, cfg: MRConfig, lowering: Lowering):
        self.spec = spec
        self.cfg = cfg
        self.lowering = lowering
        self.device = torch.device(lowering.device)

    def _tensor(self, x) -> torch.Tensor | None:
        if x is None:
            return None
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def run_offline(self, ys, us=None, norm: dict | None = None) -> tuple:
        """Train one system's recovery model: ys [N, T, n] -> (params, metrics).

        Initial weights and minibatches come from one ``torch.Generator`` on
        the plan's device, seeded with ``spec.seed``; ``norm`` applies the L1
        penalty in physical units.
        """
        ys, us = self._tensor(ys), self._tensor(us)
        generator = torch.Generator(device=self.device).manual_seed(self.spec.seed)
        params = init_mr(generator, self.cfg, self.device)
        opt_state = adamw_init(params)
        phys = engine.make_phys(self.cfg, norm, self.device)
        params, _, metrics = engine.run_epoch(
            params,
            opt_state,
            ys,
            us,
            generator,
            self.spec.lr,
            phys,
            cfg=self.cfg,
            steps=self.spec.steps,
            batch_size=self.spec.batch_size,
        )
        return params, metrics

    @torch.no_grad()
    def readout(
        self, params, yw, uw=None, norm: dict | None = None, n_active: int | None = None
    ) -> np.ndarray:
        """Theta [n_terms, n] in fp32: the mean of ``mr_forward``'s Theta over
        windows, then denormalized (``norm``), then pruned (``n_active``, by
        default the spec's)."""
        theta, _ = mr_forward(params, self.cfg, self._tensor(yw), self._tensor(uw))
        theta = theta.mean(dim=0).cpu().numpy()
        if norm is not None:
            theta = denormalize_theta(
                theta,
                norm["mean"],
                norm["scale"],
                n_vars=self.cfg.state_dim + self.cfg.input_dim,
                order=self.cfg.order,
                n_state=self.cfg.state_dim,
            )
        n_active = self.spec.n_active if n_active is None else n_active
        if n_active is not None:
            theta = prune_theta(theta, n_active)
        return theta


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "compile_plan: no CUDA device is visible; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def compile_plan(spec: RecoverySpec, device: str | torch.device | None = None) -> RecoveryPlan:
    """Validate and lower a RecoverySpec; see the module docstring."""
    device = _resolve_device(device)
    row = encoders.validate_config(spec.to_mr_config())  # unknown name, unfusable row
    if spec.qat is not None and row.flow is None:
        raise ValueError(
            f"qat (fixed-point fake-quant) is implemented for the GRU families, "
            f"got encoder={spec.encoder!r}"
        )
    rt.pin_fp32_matmul()
    block_b, smem, budget = None, None, None
    if spec.fused:
        batch = spec.batch_size
        if spec.block_b == "auto":
            budget = spec.smem_budget_bytes or tiling.SMEM_BUDGET_BYTES
            block_b = tiling.auto_block_b(spec.to_mr_config(), row.family, batch, budget)
        elif isinstance(spec.block_b, int):
            if batch is not None and batch % spec.block_b:
                raise ValueError(
                    f"block_b={spec.block_b} does not divide the compile-time batch ({batch})"
                )
            block_b = spec.block_b
        if block_b is not None:
            smem = tiling.config_smem_bytes(spec.to_mr_config(), row.family, block_b)
    routes_kernel = spec.fused or row.kernel
    lowering = Lowering(
        encoder=spec.encoder,
        fused=spec.fused,
        kernel=row.kernel,
        qat=spec.qat is not None,
        dispatch="cuda" if routes_kernel and device.type == "cuda" else "reference",
        block_b=block_b,
        smem_bytes=smem,
        smem_budget_bytes=budget,
        device=str(device),
    )
    return RecoveryPlan(spec, spec.to_mr_config(block_b), lowering)
