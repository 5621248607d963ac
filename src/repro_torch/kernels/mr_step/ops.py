"""Stage-fused MR per-window step: the CUDA kernel, its wrapper and its gradient.

Counterpart of the GRU branch of ``repro/kernels/mr_step/ops.py``
(``:159-203, 206-314``). ``mr_step`` dispatches through
``kernels/runtime.resolve_dispatch``: a CUDA tensor launches the hand-written
kernel (``csrc/mr_step.cu``, which replaces
``repro/kernels/mr_step/kernel.py:129 mr_step_pallas``), a CPU tensor or
``force_reference`` takes the plain version (``ref.py``). The gradient
recomputes the plain version under ``torch.enable_grad()``, as ``_mr_bwd``
does (``repro/kernels/mr_step/ops.py:60-62``).
"""

from __future__ import annotations

import torch

from repro_torch.core import encoders
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ref import mr_step_reference


def mr_step_cuda(xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, *, flow: bool, block_b: int):
    """Launch the fused CUDA stage on the current stream: returns out [B, K].

    Counts its launches in ``mr_step_cuda.launches``.
    """
    B, T, D = xs.shape
    H = h0.shape[-1]
    Dh, K = w2.shape
    rt.check_operands(
        "mr_step",
        xs.device,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        wx=(wx, (D, 3 * H)),
        wh=(wh, (H, 3 * H)),
        b=(b, (3 * H,)),
        time_scale=(time_scale, (H,)),
        dts=(dts, (T,)),
        w1=(w1, (H, Dh)),
        b1=(b1, (Dh,)),
        w2=(w2, (Dh, K)),
        b2=(b2, (K,)),
    )
    if T < 1 or block_b < 1 or B % block_b:
        raise ValueError(f"mr_step: T={T} and block_b={block_b} must be >= 1, B={B} a multiple")
    smem = tiling.smem_bytes(D, H, Dh, K, block_b)
    if smem > tiling.SMEM_BUDGET_BYTES:
        raise ValueError(f"mr_step: {smem} bytes of shared memory exceed one block's budget")
    out = torch.empty((B, K), dtype=torch.float32, device=xs.device)
    err = rt.load_library().mr_step_launch(
        *(t.data_ptr() for t in (xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out)),
        B,
        T,
        D,
        H,
        Dh,
        K,
        block_b,
        int(flow),
        rt.current_stream(xs.device),
    )
    rt.check_launch("mr_step", err)
    mr_step_cuda.launches += 1
    return out


mr_step_cuda.launches = 0


class _MRStepFn(torch.autograd.Function):
    """The CUDA forward; the backward recomputes the plain version."""

    @staticmethod
    def forward(ctx, xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, flow, block_b):
        ctx.flow = flow
        ctx.save_for_backward(xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2)
        return mr_step_cuda(
            xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, flow=flow, block_b=block_b
        )

    @staticmethod
    def backward(ctx, grad_out):
        grads = rt.reference_vjp(
            lambda *a: mr_step_reference(*a, flow=ctx.flow),
            ctx.saved_tensors,
            ctx.needs_input_grad[:11],
            grad_out,
        )
        return (*grads, None, None)


def split_out(out: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Head output [B, K] -> (theta [B, n_terms, n], shifts [B, q])."""
    theta = out[..., : cfg.n_coef].reshape(out.shape[0], cfg.n_terms, cfg.state_dim)
    return theta, out[..., cfg.n_coef :]


def mr_step(
    params,  # merinda.MRParams of a GRU-family encoder
    cfg,  # merinda.MRConfig
    xs: torch.Tensor,  # [B, T, n + m] normalized windows
    dts: torch.Tensor | None = None,
    block_b: int | None = None,
    force_reference: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-window recovery stage: (theta [B, n_terms, n], shifts [B, q]).

    The flow gate sees ``dts = ones(T)``, not ``cfg.dt``, as in the JAX
    package (``repro/kernels/mr_step/ops.py:277-278``).
    """
    spec = encoders.get_encoder(cfg.encoder)
    B, T, D = xs.shape
    if dts is None:
        dts = torch.ones(T, dtype=xs.dtype, device=xs.device)
    h0 = torch.zeros(B, cfg.hidden, dtype=xs.dtype, device=xs.device)
    enc = params.encoder
    args = (
        xs,
        h0,
        enc.w[:D],
        enc.w[D:],
        enc.b,
        enc.time_scale,
        dts,
        params.head_w1,
        params.head_b1,
        params.head_w2,
        params.head_b2,
    )
    if rt.resolve_dispatch(xs, force_reference) is rt.Dispatch.REFERENCE:
        out = mr_step_reference(*args, flow=spec.flow)
    else:
        bb = tiling.legal_block_b(block_b, B) or tiling.auto_block_b(cfg, B)
        out = _MRStepFn.apply(xs.contiguous(), *args[1:], spec.flow, bb)
    return split_out(out, cfg)
