"""Stage-fused MR per-window step: the CUDA kernels, their wrappers and gradients.

Counterpart of ``repro/kernels/mr_step/ops.py`` (``:34-314``, fp32). ``mr_step``
dispatches on the encoder row's ``family``, as the JAX wrapper does:

    "gru"   csrc/mr_step.cu       replaces kernel.py:129 mr_step_pallas
    "ltc"   csrc/mr_step_ltc.cu   replaces kernel.py:404 mr_step_ltc_pallas
    "node"  csrc/mr_step_node.cu  replaces kernel.py:541 mr_step_node_pallas

and then through ``kernels/runtime.resolve_dispatch``: a CUDA tensor launches
the hand-written kernel, a CPU tensor or ``force_reference`` takes the plain
version (``ref.py``). Each kernel sits in a ``torch.autograd.Function`` whose
backward recomputes the plain version under ``torch.enable_grad()``, as
``_mr_bwd``, ``_ltc_bwd`` and ``_node_bwd`` do (``ops.py:60-62, 100-107,
146-153``): the JAX package has no backward kernel, and neither has the port.

QAT (``cfg.quant``): the head weights get ``qat_weight`` on every family, the
encoder weights on the GRU families only, and the kernels' head quantizes its
RMS-normalized input (``act_bits``). The straight-through weight treatment
runs before the autograd Function, so its gradient is the identity.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoders
from repro_torch.core.ltc import ltc_sub_dt
from repro_torch.core.node_mr import node_sub_dt
from repro_torch.core.quant import act_bits as quant_act_bits
from repro_torch.core.quant import qat_weight
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ref import (
    mr_step_ltc_reference,
    mr_step_node_reference,
    mr_step_reference,
)

NO_ACT_BITS = (0, -1)  # (int_bits, frac_bits) the launchers read as "no activation step"


def _check_tile(kernel: str, B: int, T: int, block_b: int, smem: int) -> None:
    if T < 1 or block_b < 1 or B % block_b:
        raise ValueError(f"{kernel}: T={T} and block_b={block_b} must be >= 1, B={B} a multiple")
    if smem > tiling.SMEM_BUDGET_BYTES:
        raise ValueError(f"{kernel}: {smem} bytes of shared memory exceed one block's budget")


def _head_operands(H: int, w1, b1, w2, b2) -> dict:
    Dh, K = w2.shape
    return dict(w1=(w1, (H, Dh)), b1=(b1, (Dh,)), w2=(w2, (Dh, K)), b2=(b2, (K,)))


def mr_step_cuda(
    xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, *, flow: bool, block_b: int,
    act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch the fused GRU(-flow) stage on the current stream: out [B, K].

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
        **_head_operands(H, w1, b1, w2, b2),
    )
    _check_tile("mr_step", B, T, block_b, tiling.smem_bytes(D, H, Dh, K, block_b))
    out = torch.empty((B, K), dtype=torch.float32, device=xs.device)
    err = rt.load_library().mr_step_launch(
        *(t.data_ptr() for t in (xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out)),
        B, T, D, H, Dh, K, block_b, int(flow), *(act_bits or NO_ACT_BITS),
        rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch("mr_step", err)
    mr_step_cuda.launches += 1
    return out


def mr_step_ltc_cuda(
    xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, *, sub_dt: float,
    n_substeps: int, block_b: int, act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch the fused LTC stage on the current stream: out [B, K].

    ``sub_dt`` is ``dt / n_substeps`` in float32 (``core.ltc.ltc_sub_dt``).
    Counts its launches in ``mr_step_ltc_cuda.launches``.
    """
    B, T, D = xs.shape
    H = h0.shape[-1]
    Dh, K = w2.shape
    rt.check_operands(
        "mr_step_ltc",
        xs.device,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        w_in=(w_in, (D, H)),
        w_rec=(w_rec, (H, H)),
        bias=(bias, (H,)),
        a=(a, (H,)),
        inv_tau=(inv_tau, (H,)),
        **_head_operands(H, w1, b1, w2, b2),
    )
    _check_tile("mr_step_ltc", B, T, block_b, tiling.ltc_smem_bytes(D, H, Dh, K, block_b))
    if block_b * H > tiling.MAX_THREADS or n_substeps < 1:
        raise ValueError(
            f"mr_step_ltc: block_b * H = {block_b * H} must be <= {tiling.MAX_THREADS} "
            f"(one thread a window and unit) and n_substeps={n_substeps} >= 1"
        )
    out = torch.empty((B, K), dtype=torch.float32, device=xs.device)
    err = rt.load_library().mr_step_ltc_launch(
        *(t.data_ptr() for t in (xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, out)),
        B, T, D, H, Dh, K, block_b, n_substeps, *(act_bits or NO_ACT_BITS), sub_dt,
        rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch("mr_step_ltc", err)
    mr_step_ltc_cuda.launches += 1
    return out


def mr_step_node_cuda(
    xs, h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2, *, sub_dt: float,
    n_substeps: int, block_b: int, act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch the fused NODE stage on the current stream: out [B, K].

    ``sub_dt`` is the Euler substep (``core.node_mr.node_sub_dt``). Counts its
    launches in ``mr_step_node_cuda.launches``.
    """
    B, T, D = xs.shape
    H = h0.shape[-1]
    Dh, K = w2.shape
    rt.check_operands(
        "mr_step_node",
        xs.device,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        w_f1=(w_f1, (H, H)),
        b_f1=(b_f1, (H,)),
        w_f2=(w_f2, (H, H)),
        b_f2=(b_f2, (H,)),
        w_in=(w_in, (D, H)),
        b_in=(b_in, (H,)),
        **_head_operands(H, w1, b1, w2, b2),
    )
    _check_tile("mr_step_node", B, T, block_b, tiling.node_smem_bytes(D, H, Dh, K, block_b))
    if n_substeps < 1:
        raise ValueError(f"mr_step_node: n_substeps={n_substeps} must be >= 1")
    out = torch.empty((B, K), dtype=torch.float32, device=xs.device)
    tensors = (xs, h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2, out)
    err = rt.load_library().mr_step_node_launch(
        *(t.data_ptr() for t in tensors),
        B, T, D, H, Dh, K, block_b, n_substeps, *(act_bits or NO_ACT_BITS), sub_dt,
        rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch("mr_step_node", err)
    mr_step_node_cuda.launches += 1
    return out


mr_step_cuda.launches = 0
mr_step_ltc_cuda.launches = 0
mr_step_node_cuda.launches = 0


def _fused_fn(name: str, kernel, reference) -> type:
    """An autograd Function: ``kernel`` forward, backward through ``reference``.

    ``apply(kernel_kw, ref_kw, *tensors)``: the keyword arguments each side
    takes besides the tensors.
    """

    def forward(ctx, kernel_kw, ref_kw, *tensors):
        ctx.ref_kw = ref_kw
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **kernel_kw)

    def backward(ctx, grad_out):
        grads = rt.reference_vjp(
            lambda *a: reference(*a, **ctx.ref_kw),
            ctx.saved_tensors,
            ctx.needs_input_grad[2:],
            grad_out,
        )
        return (None, None, *grads)

    attrs = dict(forward=staticmethod(forward), backward=staticmethod(backward))
    return type(name, (torch.autograd.Function,), attrs)


_MRStepFn = _fused_fn("_MRStepFn", mr_step_cuda, mr_step_reference)
_MRStepLTCFn = _fused_fn("_MRStepLTCFn", mr_step_ltc_cuda, mr_step_ltc_reference)
_MRStepNodeFn = _fused_fn("_MRStepNodeFn", mr_step_node_cuda, mr_step_node_reference)


def _split_gru(params, cfg) -> tuple:
    """(wx, wh, b, time_scale) with the QAT weight fake-quant applied."""
    enc = encoders.quantized_gru_params(params.encoder, cfg)
    d_in = cfg.state_dim + cfg.input_dim
    return enc.w[:d_in], enc.w[d_in:], enc.b, enc.time_scale


def head_weights(params, cfg) -> tuple:
    """(w1, b1, w2, b2) with the QAT weight treatment applied: the head of
    every family, fused or not (``merinda.head_from_hidden``)."""
    w1 = qat_weight(params.head_w1, cfg.quant)
    w2 = qat_weight(params.head_w2, cfg.quant)
    return w1, params.head_b1, w2, params.head_b2


def _fusable_spec(cfg) -> encoders.EncoderSpec:
    spec = encoders.get_encoder(cfg.encoder)
    if not spec.fusable:
        raise ValueError(
            f"fused mr_step has no stage for encoder {cfg.encoder!r} "
            f"(fusable: {encoders.fusable_names()})"
        )
    return spec


def split_out(out: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Head output [B, K] -> (theta [B, n_terms, n], shifts [B, q])."""
    theta = out[..., : cfg.n_coef].reshape(out.shape[0], cfg.n_terms, cfg.state_dim)
    return theta, out[..., cfg.n_coef :]


def mr_step(
    params,  # merinda.MRParams of any fusable encoder
    cfg,  # merinda.MRConfig
    xs: torch.Tensor,  # [B, T, n + m] normalized (and activation-quantized) windows
    dts: torch.Tensor | None = None,
    block_b: int | None = None,
    force_reference: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-window recovery stage: (theta [B, n_terms, n], shifts [B, q]).

    The LTC and NODE families integrate on ``cfg.dt`` with
    ``cfg.ltc_substeps`` substeps; the GRU families' flow gate sees
    ``dts = ones(T)``, as in the JAX package (``ops.py:238-278``).
    """
    spec = _fusable_spec(cfg)
    B, T, _ = xs.shape
    h0 = torch.zeros(B, cfg.hidden, dtype=xs.dtype, device=xs.device)
    head = head_weights(params, cfg)
    enc = params.encoder
    ab = quant_act_bits(cfg.quant)
    if spec.family in ("ltc", "node"):
        K = cfg.ltc_substeps
        ref_kw = dict(dt=cfg.dt, n_substeps=K, act_bits=ab)
        if spec.family == "ltc":
            fn, reference = _MRStepLTCFn, mr_step_ltc_reference
            tensors = (xs, h0, enc.w_in, enc.w_rec, enc.bias, enc.a, enc.inv_tau, *head)
            kernel_kw = dict(sub_dt=ltc_sub_dt(cfg.dt, K), n_substeps=K, act_bits=ab)
        else:
            fn, reference = _MRStepNodeFn, mr_step_node_reference
            tensors = (xs, h0, enc.w_f1, enc.b_f1, enc.w_f2, enc.b_f2, enc.w_in, enc.b_in, *head)
            kernel_kw = dict(sub_dt=node_sub_dt(cfg.dt, K), n_substeps=K, act_bits=ab)
    else:
        fn, reference = _MRStepFn, mr_step_reference
        if dts is None:
            dts = torch.ones(T, dtype=xs.dtype, device=xs.device)
        tensors = (xs, h0, *_split_gru(params, cfg), dts, *head)
        ref_kw = kernel_kw = dict(flow=spec.flow, act_bits=ab)
    if rt.resolve_dispatch(xs, force_reference) is rt.Dispatch.REFERENCE:
        return split_out(reference(*tensors, **ref_kw), cfg)
    bb = tiling.legal_block_b(block_b, B) or tiling.auto_block_b(cfg, spec.family, B)
    out = fn.apply(dict(kernel_kw, block_b=bb), ref_kw, xs.contiguous(), *tensors[1:])
    return split_out(out, cfg)
