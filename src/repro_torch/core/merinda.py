"""MERINDA: GRU-NN based model recovery (counterpart of ``repro/core/merinda.py``).

The encoder is any row of ``core/encoders.py``: MERINDA's GRU flow, the
standard GRU, or the paper's LTC and NODE baselines. Per batch of trajectory
windows:

    [Y, U] --encoder--> hidden state --dense head--> (Theta_est, shifts)
    Y_est = SOLVE(Y(0), Theta_est, U)          (RK4, core/ode.py)
    loss  = MSE(Y, Y_est) + lambda * ||Theta||_1

``MRConfig.fused=True`` runs encode -> RMS-norm -> dense head as one fused
per-window stage (``kernels/mr_step``): one CUDA kernel launch on the card,
the same math as the stage sequence. ``MRConfig.quant`` trains with
fixed-point fake quantization (``core/quant.py``): the windows, the head's
normalized input and the weights go through the Qm.n grid.

``force_reference`` (threaded from ``mr_train_step`` down to the kernel
wrappers) runs the plain version of every kernel on a CUDA tensor too; it is
how a kernel step is held against the plain step on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import encoders, ode
from repro_torch.core.library import n_library_terms, polynomial_features
from repro_torch.core.quant import QuantConfig, act_bits, fake_quant_ste, qat_act
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

RMS_EPS = 1e-6  # head RMS-normalization epsilon (shared with the mr_step kernel)


@dataclasses.dataclass(frozen=True)
class MRConfig:
    state_dim: int  # n = |Y|
    input_dim: int = 0  # m = |U|
    order: int = 2  # M (library polynomial order)
    hidden: int = 64  # V (encoder nodes)
    dense_hidden: int = 128
    encoder: str = "gru_flow"  # any name registered in core/encoders.py
    n_shifts: int = 0  # q input-shift values
    dt: float = 0.05
    solver: str = "rk4"
    ltc_substeps: int = 6  # solver substeps per input step of the ltc/node cells
    lambda_sparse: float = 1e-3
    recon_weight: float = 1.0
    quant: QuantConfig | None = None  # fixed-point QAT when set
    fused: bool = False  # stage-fused per-window step (kernels/mr_step)
    block_b: int | None = None  # fused-stage batch tile (None = fitted per call)
    # the LTC and NODE kernels' substep-loop unroll (kernels/mr_step/tiling.py
    # SUBSTEP_UNROLLS): no value depends on it, the plain versions ignore it
    substep_unroll: int = 1

    @property
    def n_terms(self) -> int:
        # library over [Y, U] jointly (SINDYc-style) so inputs can enter terms
        return n_library_terms(self.state_dim + self.input_dim, self.order)

    @property
    def n_coef(self) -> int:
        return self.n_terms * self.state_dim


class MRParams(NamedTuple):
    encoder: Any  # GRUParams | LTCParams | NodeEncoderParams
    head_w1: torch.Tensor  # [hidden, dense_hidden]
    head_b1: torch.Tensor  # [dense_hidden]
    head_w2: torch.Tensor  # [dense_hidden, n_coef + n_shifts]
    head_b2: torch.Tensor  # [n_coef + n_shifts]


def init_mr(
    generator: torch.Generator,
    cfg: MRConfig,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> MRParams:
    """Random initial parameters, drawn from ``generator`` (encoder first)."""
    d_in = cfg.state_dim + cfg.input_dim
    enc = encoders.get_encoder(cfg.encoder).init(generator, d_in, cfg.hidden, device, dtype)
    out_dim = cfg.n_coef + cfg.n_shifts
    s1 = 1.0 / cfg.hidden**0.5
    s2 = 1.0 / cfg.dense_hidden**0.5
    w1 = torch.randn(cfg.hidden, cfg.dense_hidden, generator=generator, device=device) * s1
    w2 = torch.randn(cfg.dense_hidden, out_dim, generator=generator, device=device) * s2 * 0.1
    return MRParams(
        encoder=enc,
        head_w1=w1.to(dtype),
        head_b1=torch.zeros(cfg.dense_hidden, dtype=dtype, device=device),
        head_w2=w2.to(dtype),
        head_b2=torch.zeros(out_dim, dtype=dtype, device=device),
    )


def head_math(
    h: torch.Tensor,  # [B, V] encoder summary state
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    act_bits: tuple[int, int] | None = None,  # (int_bits, frac_bits) QAT
) -> torch.Tensor:
    """Dense head: RMS-norm -> optional activation fake-quant -> ReLU MLP.

    The one source of the head stage: ``head_from_hidden`` and every fused
    stage's plain version call it (``csrc/warp_cell.cuh`` ``warp_head`` is its
    CUDA twin).
    """
    h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + RMS_EPS)
    if act_bits is not None:
        h = fake_quant_ste(h, *act_bits)
    z = torch.relu(h @ w1 + b1)
    return z @ w2 + b2


def head_from_hidden(params: MRParams, cfg: MRConfig, h: torch.Tensor):
    """Encoder summary state [B, V] -> (theta [B, n_terms, n], shifts [B, q])."""
    from repro_torch.kernels.mr_step.ops import head_weights, split_out

    out = head_math(h, *head_weights(params, cfg), act_bits=act_bits(cfg.quant))
    return split_out(out, cfg)


def mr_forward(
    params: MRParams,
    cfg: MRConfig,
    ys: torch.Tensor,
    us: torch.Tensor | None,
    force_reference: bool = False,
):
    """Returns (theta [B, n_terms, n_state], shifts [B, q])."""
    xs = ys if us is None or us.shape[-1] == 0 else torch.cat([ys, us], dim=-1)
    xs = qat_act(xs, cfg.quant)
    if cfg.fused:
        from repro_torch.kernels.mr_step.ops import mr_step

        return mr_step(params, cfg, xs, block_b=cfg.block_b, force_reference=force_reference)
    row = encoders.get_encoder(cfg.encoder)
    h = row.encode(params.encoder, cfg, xs, force_reference=force_reference)
    return head_from_hidden(params, cfg, h)


def _recovered_dynamics(cfg: MRConfig):
    """f(y, u, t, theta): dy/dt = library([y, u]) @ theta, per window."""

    def f(y, u, t, theta):
        z = y if cfg.input_dim == 0 else torch.cat([y, u], dim=-1)
        feats = polynomial_features(z, cfg.state_dim + cfg.input_dim, cfg.order)
        # bounded derivative (repro/core/merinda.py:187): keeps RK4 finite for
        # the transient bad Theta early in training
        return torch.clamp((feats.unsqueeze(1) @ theta).squeeze(1), -100.0, 100.0)

    return f


def reconstruct(
    params: MRParams,
    cfg: MRConfig,
    ys: torch.Tensor,
    us: torch.Tensor | None,
    force_reference: bool = False,
):
    """SOLVE(Y(0), Theta_est, U) per window. ys: [B, T, n] -> (Y_est [B, T, n], theta)."""
    theta, _ = mr_forward(params, cfg, ys, us, force_reference)
    T = ys.shape[1]
    ts = torch.arange(T, dtype=ys.dtype, device=ys.device) * cfg.dt
    u_seq = us.transpose(0, 1) if us is not None and cfg.input_dim else None  # [T, B, m]
    y_est = ode.odeint(
        _recovered_dynamics(cfg), ys[:, 0], ts, us=u_seq, args=theta, method=cfg.solver
    )
    return y_est.transpose(0, 1), theta


def mr_loss(
    params: MRParams,
    cfg: MRConfig,
    ys: torch.Tensor,
    us: torch.Tensor | None,
    phys: tuple | None = None,
    force_reference: bool = False,
):
    """phys=(T_transpose, out_scale): when windows are z-scored, penalize
    sparsity of the physical-unit coefficients (T^T theta) * scale."""
    y_est, theta = reconstruct(params, cfg, ys, us, force_reference)
    recon = ((y_est - ys) ** 2).mean()
    if phys is not None:
        Tt, out_scale = phys
        theta_phys = torch.einsum("kt,btn->bkn", Tt, theta) * out_scale
        sparse = theta_phys.abs().mean()
    else:
        sparse = theta.abs().mean()
    loss = cfg.recon_weight * recon + cfg.lambda_sparse * sparse
    return loss, {"recon_mse": recon, "sparsity_l1": sparse}


def mr_train_step(
    params: MRParams,
    opt_state,
    cfg: MRConfig,
    ys: torch.Tensor,
    us: torch.Tensor | None,
    lr: float,
    phys: tuple | None = None,
    force_reference: bool = False,
):
    """value-and-grad of ``mr_loss``, clip at 1.0, AdamW with weight decay 1e-4.

    A leaf the loss does not reach (the standard GRU never reads
    ``time_scale``) gets a zero gradient, as under ``jax.grad``. Returns
    (params, opt_state, metrics); the metrics are device tensors.
    """
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = mr_loss(leaves, cfg, ys, us, phys, force_reference)
    grads = torch.autograd.grad(
        loss, tree_leaves(leaves), allow_unused=True, materialize_grads=True
    )
    grads, gnorm = clip_by_global_norm(tree_unflatten(params, list(grads)), 1.0)
    params, opt_state = adamw_update(grads, opt_state, params, lr=lr, weight_decay=1e-4)
    metrics = {k: v.detach() for k, v in aux.items()}
    return params, opt_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)


@torch.no_grad()
def recover_coefficients(
    params: MRParams,
    cfg: MRConfig,
    ys: torch.Tensor,
    us: torch.Tensor | None,
    n_active: int | None = None,
) -> torch.Tensor:
    """Mean of the per-window Theta estimates, magnitude-pruned to n_active."""
    theta, _ = mr_forward(params, cfg, ys, us)
    theta = theta.mean(dim=0)  # [n_terms, n_state]
    return theta if n_active is None else prune_stacked(theta[None], n_active)[0]


def prune_stacked(theta: torch.Tensor, n_active: int) -> torch.Tensor:
    """Magnitude-prune each system's theta [S, ...] to its ``n_active`` largest terms."""
    flat = theta.abs().flatten(1)
    k = min(n_active, flat.shape[1])
    thresh = torch.sort(flat, dim=1).values[:, -k]
    keep = theta.abs() >= thresh.reshape((-1,) + (1,) * (theta.ndim - 1))
    return torch.where(keep, theta, torch.zeros_like(theta))


def prune_theta(theta: np.ndarray, n_active: int) -> np.ndarray:
    """Magnitude-prune a host-side theta to its ``n_active`` largest terms."""
    flat = np.abs(theta).ravel()
    k = min(n_active, flat.size)
    thresh = np.sort(flat)[-k]
    return np.where(np.abs(theta) >= thresh, theta, 0.0)
