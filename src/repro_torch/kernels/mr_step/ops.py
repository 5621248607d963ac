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

Batch and stream mode run the stage under ``torch.func.vmap`` (the stacked
train step and readout, where JAX maps the Pallas stages with ``jax.vmap``).
There each Function's vmap rule (``runtime.kernel_function``) launches the
slot-axis form once for all slots: ``mr_step_slots_cuda``,
``mr_step_ltc_slots_cuda`` and ``mr_step_node_slots_cuda``. Each source has
one kernel, which takes a slot axis (grid (B / block_b, S); one call is
S = 1), so each slot is bit for bit the per-call wrapper on its slice. The
slot wrappers count their launches apart from the per-call wrappers', so a
path shows which form it ran.

QAT (``cfg.quant``): the head weights get ``qat_weight`` on every family, the
encoder weights on the GRU families only, and the kernels' head quantizes its
RMS-normalized input (``act_bits``). The straight-through weight treatment
runs before the autograd Function, so its gradient is the identity.

``mr_step_int8`` is the fixed-point serving stage (``ops.py:317-465``):
int8 cell and head weights with one float scale per output channel, PWL
activations, dispatched on ``family`` as well:

    "gru"   csrc/mr_step_int8.cu      replaces kernel.py:251 mr_step_pallas_int8
    "ltc"   csrc/mr_step_ltc_int8.cu  replaces kernel.py:695 mr_step_ltc_pallas_int8

It quantizes the RAW weights on every call (no ``qat_weight`` first, as the
JAX wrapper), keeps the biases, ``a`` and ``inv_tau`` in float, and is
serve-only: no autograd Function. The flow rows and NODE have no int8 stage.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoders
from repro_torch.core.ltc import ltc_sub_dt
from repro_torch.core.node_mr import node_sub_dt
from repro_torch.core.quant import act_bits as quant_act_bits
from repro_torch.core.quant import (
    N_SEG,
    PWL_FLOATS,
    qat_weight,
    quantize_int8,
    serving_packs,
    serving_tables,
)
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ref import (
    mr_step_int8_reference,
    mr_step_ltc_int8_reference,
    mr_step_ltc_reference,
    mr_step_node_reference,
    mr_step_reference,
)

NO_ACT_BITS = (0, -1)  # (int_bits, frac_bits) the launchers read as "no activation step"


def _check_tile(kernel: str, B: int, T: int, block_b: int, carve: str, *dims: int) -> None:
    """Raise on a tile the batch does not take, or whose launch would request
    more shared memory than a block has: the bytes of ``carve``'s exported
    layout (``runtime.kernel_smem_bytes``) at ``dims`` and ``block_b``, what
    the launcher really requests."""
    if T < 1 or block_b < 1 or B % block_b:
        raise ValueError(f"{kernel}: T={T} and block_b={block_b} must be >= 1, B={B} a multiple")
    rt.check_smem(kernel, rt.kernel_smem_bytes(carve, *dims[:4], block_b, *dims[4:]))


def _check_substeps(kernel: str, n_substeps: int, unroll: int, family: str) -> None:
    if n_substeps < 1:
        raise ValueError(f"{kernel}: n_substeps={n_substeps} must be >= 1")
    tiling.check_unroll(unroll, family)


def _head_operands(H: int, w1, b1, w2, b2) -> dict:
    Dh, K = w2.shape[-2:]  # a slot's, under a slot axis
    return dict(w1=(w1, (H, Dh)), b1=(b1, (Dh,)), w2=(w2, (Dh, K)), b2=(b2, (K,)))


def _one_call(n_operands: int) -> tuple:
    """``in_dims`` of one call through a slot-axis launcher: xs given a slot
    axis of 1, every other operand shared."""
    return (0,) + (None,) * (n_operands - 1)


def _launch_mr_step(
    name, xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, *, in_dims, flow: bool,
    block_b: int | None, act_bits: tuple[int, int] | None,
):  # fmt: skip
    """One launch of ``csrc/mr_step.cu``: out [S, B, K] (see ``mr_step_slots_cuda``)."""
    B, T, D = xs.shape[-3:]
    H = h0.shape[-1]
    Dh, K = w2.shape[-2:]
    S, strides = rt.slot_strides(
        name,
        xs.device,
        in_dims,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        wx=(wx, (D, 3 * H)),
        wh=(wh, (H, 3 * H)),
        b=(b, (3 * H,)),
        time_scale=(time_scale, (H,)),
        dts=(dts, (T,)),
        **_head_operands(H, w1, b1, w2, b2),
    )
    block_b = block_b or tiling.fit_block_b("gru", B, D, H, Dh, K, slots=S)
    _check_tile(name, B, T, block_b, "mr_step", D, H, Dh, K)
    out = torch.empty((S, B, K), dtype=torch.float32, device=xs.device)
    err = rt.load_library().mr_step_launch(
        *(t.data_ptr() for t in (xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out)),
        *strides, S, B, T, D, H, Dh, K, block_b, int(flow), *(act_bits or NO_ACT_BITS),
        rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch(name, err)
    return out


def _launch_ltc(
    name, xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, *, in_dims, sub_dt: float,
    n_substeps: int, unroll: int, block_b: int | None, act_bits: tuple[int, int] | None,
):  # fmt: skip
    """One launch of ``csrc/mr_step_ltc.cu``: out [S, B, K]."""
    B, T, D = xs.shape[-3:]
    H = h0.shape[-1]
    Dh, K = w2.shape[-2:]
    S, strides = rt.slot_strides(
        name,
        xs.device,
        in_dims,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        w_in=(w_in, (D, H)),
        w_rec=(w_rec, (H, H)),
        bias=(bias, (H,)),
        a=(a, (H,)),
        inv_tau=(inv_tau, (H,)),
        **_head_operands(H, w1, b1, w2, b2),
    )
    block_b = block_b or tiling.fit_block_b("ltc", B, D, H, Dh, K, slots=S)
    _check_tile(name, B, T, block_b, "mr_step_ltc", D, H, Dh, K)
    _check_substeps(name, n_substeps, unroll, "ltc")
    out = torch.empty((S, B, K), dtype=torch.float32, device=xs.device)
    err = rt.load_library().mr_step_ltc_launch(
        *(t.data_ptr() for t in (xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, out)),
        *strides, S, B, T, D, H, Dh, K, block_b, n_substeps, unroll, *(act_bits or NO_ACT_BITS),
        sub_dt, rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch(name, err)
    return out


def _launch_node(
    name, xs, h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2, *, in_dims,
    sub_dt: float, n_substeps: int, unroll: int, block_b: int | None,
    act_bits: tuple[int, int] | None,
):  # fmt: skip
    """One launch of ``csrc/mr_step_node.cu``: out [S, B, K]."""
    B, T, D = xs.shape[-3:]
    H = h0.shape[-1]
    Dh, K = w2.shape[-2:]
    S, strides = rt.slot_strides(
        name,
        xs.device,
        in_dims,
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
    block_b = block_b or tiling.fit_block_b("node", B, D, H, Dh, K, slots=S)
    _check_tile(name, B, T, block_b, "mr_step_node", D, H, Dh, K)
    _check_substeps(name, n_substeps, unroll, "node")
    out = torch.empty((S, B, K), dtype=torch.float32, device=xs.device)
    tensors = (xs, h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2, out)
    err = rt.load_library().mr_step_node_launch(
        *(t.data_ptr() for t in tensors),
        *strides, S, B, T, D, H, Dh, K, block_b, n_substeps, unroll, *(act_bits or NO_ACT_BITS),
        sub_dt, rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch(name, err)
    return out


def mr_step_cuda(
    xs, *ops, flow: bool, block_b: int | None = None, act_bits: tuple[int, int] | None = None
):
    """Launch the fused GRU(-flow) stage on the current stream: out [B, K].

    ``ops`` are h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2; one slot of
    ``csrc/mr_step.cu``. ``block_b=None`` fits the tile to B
    (``tiling.fit_block_b``). Counts its launches in ``mr_step_cuda.launches``.
    """
    out = _launch_mr_step("mr_step", xs[None], *ops, in_dims=_one_call(1 + len(ops)), flow=flow,
                          block_b=block_b, act_bits=act_bits)[0]  # fmt: skip
    mr_step_cuda.launches += 1
    return out


def mr_step_ltc_cuda(
    xs, *ops, sub_dt: float, n_substeps: int, unroll: int = 1, block_b: int | None = None,
    act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch the fused LTC stage on the current stream: out [B, K].

    ``ops`` are h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2; ``sub_dt``
    is ``dt / n_substeps`` in float32 (``core.ltc.ltc_sub_dt``); ``unroll``
    the substep loop's unroll factor (``tiling.SUBSTEP_UNROLLS``; no bit of
    the result depends on it); ``block_b=None`` fits the tile to B. Counts
    its launches in ``mr_step_ltc_cuda.launches``.
    """
    out = _launch_ltc("mr_step_ltc", xs[None], *ops, in_dims=_one_call(1 + len(ops)),
                      sub_dt=sub_dt, n_substeps=n_substeps, unroll=unroll, block_b=block_b,
                      act_bits=act_bits)[0]  # fmt: skip
    mr_step_ltc_cuda.launches += 1
    return out


def mr_step_node_cuda(
    xs, *ops, sub_dt: float, n_substeps: int, unroll: int = 1, block_b: int | None = None,
    act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch the fused NODE stage on the current stream: out [B, K].

    ``ops`` are h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2;
    ``sub_dt`` is the Euler substep (``core.node_mr.node_sub_dt``); ``unroll``
    as ``mr_step_ltc_cuda``'s; ``block_b=None`` fits the tile to B. Counts its
    launches in ``mr_step_node_cuda.launches``.
    """
    out = _launch_node("mr_step_node", xs[None], *ops, in_dims=_one_call(1 + len(ops)),
                       sub_dt=sub_dt, n_substeps=n_substeps, unroll=unroll, block_b=block_b,
                       act_bits=act_bits)[0]  # fmt: skip
    mr_step_node_cuda.launches += 1
    return out


def mr_step_slots_cuda(
    *ops, in_dims, flow: bool, block_b: int | None = None,
    act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch S fused GRU(-flow) stages as one kernel on the current stream:
    out [S, B, K], slot s equal bit for bit to ``mr_step_cuda`` on slot s's
    operands (the operands of ``mr_step_cuda``).

    Operand i is [S, ...] (``in_dims[i] == 0``) or one operand shared by every
    slot (``None``: slot stride 0). ``block_b=None`` fits the tile to the S * B
    windows (``tiling.fit_block_b(..., slots=S)``). Counts its launches in
    ``mr_step_slots_cuda.launches``.
    """
    out = _launch_mr_step("mr_step_slots", *ops, in_dims=in_dims, flow=flow, block_b=block_b,
                          act_bits=act_bits)  # fmt: skip
    mr_step_slots_cuda.launches += 1
    return out


def mr_step_ltc_slots_cuda(
    *ops, in_dims, sub_dt: float, n_substeps: int, unroll: int = 1, block_b: int | None = None,
    act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch S fused LTC stages as one kernel: out [S, B, K], each slot
    ``mr_step_ltc_cuda``'s bits on its operands; the slot operands as in
    ``mr_step_slots_cuda``. Counts its launches in
    ``mr_step_ltc_slots_cuda.launches``."""
    out = _launch_ltc("mr_step_ltc_slots", *ops, in_dims=in_dims, sub_dt=sub_dt,
                      n_substeps=n_substeps, unroll=unroll, block_b=block_b,
                      act_bits=act_bits)  # fmt: skip
    mr_step_ltc_slots_cuda.launches += 1
    return out


def mr_step_node_slots_cuda(
    *ops, in_dims, sub_dt: float, n_substeps: int, unroll: int = 1, block_b: int | None = None,
    act_bits: tuple[int, int] | None = None,
):  # fmt: skip
    """Launch S fused NODE stages as one kernel: out [S, B, K], each slot
    ``mr_step_node_cuda``'s bits on its operands; the slot operands as in
    ``mr_step_slots_cuda``. Counts its launches in
    ``mr_step_node_slots_cuda.launches``."""
    out = _launch_node("mr_step_node_slots", *ops, in_dims=in_dims, sub_dt=sub_dt,
                       n_substeps=n_substeps, unroll=unroll, block_b=block_b,
                       act_bits=act_bits)  # fmt: skip
    mr_step_node_slots_cuda.launches += 1
    return out


def _int8_head_operands(H: int, w1q, s1, b1, w2q, s2, b2) -> dict:
    Dh, K = w2q.shape
    return dict(w1q=(w1q, (H, Dh), torch.int8), s1=(s1, (Dh,)), b1=(b1, (Dh,)),
                w2q=(w2q, (Dh, K), torch.int8), s2=(s2, (K,)), b2=(b2, (K,)))  # fmt: skip


def mr_step_int8_cuda(
    xs, h0, wxq, whq, wx_scale, wh_scale, b, sig, tanh, w1q, s1, b1, w2q, s2, b2, *,
    block_b: int,
):  # fmt: skip
    """Launch the fused int8/PWL standard-GRU stage on the current stream:
    out [B, K]. Weights int8 with float32 scales per output channel; ``sig``
    and ``tanh`` packed tables (``core.quant.serving_packs``). Counts its launches
    in ``mr_step_int8_cuda.launches``."""
    B, T, D = xs.shape
    H = h0.shape[-1]
    Dh, K = w2q.shape
    rt.check_operands(
        "mr_step_int8",
        xs.device,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        wxq=(wxq, (D, 3 * H), torch.int8),
        whq=(whq, (H, 3 * H), torch.int8),
        wx_scale=(wx_scale, (3 * H,)),
        wh_scale=(wh_scale, (3 * H,)),
        b=(b, (3 * H,)),
        sig=(sig, (PWL_FLOATS,)),
        tanh=(tanh, (PWL_FLOATS,)),
        **_int8_head_operands(H, w1q, s1, b1, w2q, s2, b2),
    )
    _check_tile("mr_step_int8", B, T, block_b, "mr_step_int8", D, H, Dh, K, N_SEG)
    out = torch.empty((B, K), dtype=torch.float32, device=xs.device)
    tensors = (xs, h0, wxq, whq, wx_scale, wh_scale, b, sig, tanh, w1q, s1, b1, w2q, s2, b2, out)
    err = rt.load_library().mr_step_int8_launch(
        *(t.data_ptr() for t in tensors),
        B, T, D, H, Dh, K, block_b, N_SEG, rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch("mr_step_int8", err)
    mr_step_int8_cuda.launches += 1
    return out


def mr_step_ltc_int8_cuda(
    xs, h0, w_inq, w_in_scale, w_recq, w_rec_scale, bias, a, inv_tau, sig, w1q, s1, b1, w2q,
    s2, b2, *, sub_dt: float, n_substeps: int, block_b: int,
):  # fmt: skip
    """Launch the fused int8/PWL LTC stage on the current stream: out [B, K].

    ``sub_dt`` is ``dt / n_substeps`` in float32 (``core.ltc.ltc_sub_dt``).
    Counts its launches in ``mr_step_ltc_int8_cuda.launches``.
    """
    B, T, D = xs.shape
    H = h0.shape[-1]
    Dh, K = w2q.shape
    rt.check_operands(
        "mr_step_ltc_int8",
        xs.device,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        w_inq=(w_inq, (D, H), torch.int8),
        w_in_scale=(w_in_scale, (H,)),
        w_recq=(w_recq, (H, H), torch.int8),
        w_rec_scale=(w_rec_scale, (H,)),
        bias=(bias, (H,)),
        a=(a, (H,)),
        inv_tau=(inv_tau, (H,)),
        sig=(sig, (PWL_FLOATS,)),
        **_int8_head_operands(H, w1q, s1, b1, w2q, s2, b2),
    )
    _check_tile("mr_step_ltc_int8", B, T, block_b, "mr_step_ltc_int8", D, H, Dh, K, N_SEG)
    if n_substeps < 1:
        raise ValueError(f"mr_step_ltc_int8: n_substeps={n_substeps} must be >= 1")
    out = torch.empty((B, K), dtype=torch.float32, device=xs.device)
    tensors = (xs, h0, w_inq, w_in_scale, w_recq, w_rec_scale, bias, a, inv_tau, sig, w1q, s1,
               b1, w2q, s2, b2, out)  # fmt: skip
    err = rt.load_library().mr_step_ltc_int8_launch(
        *(t.data_ptr() for t in tensors),
        B, T, D, H, Dh, K, block_b, n_substeps, N_SEG, sub_dt, rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch("mr_step_ltc_int8", err)
    mr_step_ltc_int8_cuda.launches += 1
    return out


mr_step_cuda.launches = 0
mr_step_ltc_cuda.launches = 0
mr_step_node_cuda.launches = 0
mr_step_slots_cuda.launches = 0
mr_step_ltc_slots_cuda.launches = 0
mr_step_node_slots_cuda.launches = 0
mr_step_int8_cuda.launches = 0
mr_step_ltc_int8_cuda.launches = 0

# apply(kernel_kw, ref_kw, *tensors): one launch a call, one slot-axis launch a
# call under torch.func.vmap (runtime.kernel_function)
_MRStepFn = rt.kernel_function("_MRStepFn", mr_step_cuda, mr_step_slots_cuda, mr_step_reference)
_MRStepLTCFn = rt.kernel_function(
    "_MRStepLTCFn", mr_step_ltc_cuda, mr_step_ltc_slots_cuda, mr_step_ltc_reference
)
_MRStepNodeFn = rt.kernel_function(
    "_MRStepNodeFn", mr_step_node_cuda, mr_step_node_slots_cuda, mr_step_node_reference
)


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
    ``cfg.ltc_substeps`` substeps, their kernels' substep loop unrolled
    ``cfg.substep_unroll`` times; the GRU families' flow gate sees
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
        ref_kw = dict(dt=cfg.dt, n_substeps=K, act_bits=ab)  # the plain versions: no unroll
        kernel_kw = dict(n_substeps=K, unroll=cfg.substep_unroll, act_bits=ab)
        if spec.family == "ltc":
            fn, reference = _MRStepLTCFn, mr_step_ltc_reference
            tensors = (xs, h0, enc.w_in, enc.w_rec, enc.bias, enc.a, enc.inv_tau, *head)
            kernel_kw["sub_dt"] = ltc_sub_dt(cfg.dt, K)
        else:
            fn, reference = _MRStepNodeFn, mr_step_node_reference
            tensors = (xs, h0, enc.w_f1, enc.b_f1, enc.w_f2, enc.b_f2, enc.w_in, enc.b_in, *head)
            kernel_kw["sub_dt"] = node_sub_dt(cfg.dt, K)
    else:
        fn, reference = _MRStepFn, mr_step_reference
        if dts is None:
            dts = torch.ones(T, dtype=xs.dtype, device=xs.device)
        tensors = (xs, h0, *_split_gru(params, cfg), dts, *head)
        ref_kw = kernel_kw = dict(flow=spec.flow, act_bits=ab)
    if rt.resolve_dispatch(xs, force_reference) is rt.Dispatch.REFERENCE:
        return split_out(reference(*tensors, **ref_kw), cfg)
    # a tile the batch does not take is dropped: the launch then fits its own
    # (to B, or to S * B under vmap)
    kernel_kw = dict(kernel_kw, block_b=tiling.legal_block_b(block_b, B))
    out = fn.apply(kernel_kw, ref_kw, xs.contiguous(), *tensors[1:])
    return split_out(out, cfg)


def _int8_spec(cfg) -> encoders.EncoderSpec:
    spec = _fusable_spec(cfg)
    if not spec.int8:
        raise ValueError(
            f"int8 mr_step implements the fixed-point cells with a PWL activation mapping: "
            f"encoder='gru' (standard cell, paper Eq. 12-15) or encoder='ltc' (sigmoid-only "
            f"substep); got {cfg.encoder!r} (int8-capable: {encoders.int8_names()})"
        )
    return spec


def int8_weights(params, cfg, batch_dims: int = 0) -> tuple:
    """The raw cell and head weights quantized per output channel, as
    ``Int8Quantized`` pairs: (wx, wh, w1, w2) for the GRU rows, (w_in, w_rec,
    w1, w2) for ``ltc``. ``batch_dims=1`` quantizes each slot of a
    slot-stacked tree on its own."""
    enc = params.encoder
    if encoders.get_encoder(cfg.encoder).family == "ltc":
        cell = (enc.w_in, enc.w_rec)
    else:
        d_in = cfg.state_dim + cfg.input_dim
        cell = (enc.w[..., :d_in, :], enc.w[..., d_in:, :])
    return tuple(quantize_int8(w, batch_dims=batch_dims)
                 for w in (*cell, params.head_w1, params.head_w2))  # fmt: skip


@torch.no_grad()
def mr_step_int8(
    params,  # merinda.MRParams of an int8-capable encoder (gru, gru_kernel, ltc)
    cfg,  # merinda.MRConfig
    xs: torch.Tensor,  # [B, T, n + m] normalized windows
    dts: torch.Tensor | None = None,
    block_b: int | None = None,
    force_reference: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-point serving stage: (theta [B, n_terms, n], shifts [B, q]).

    ``dts`` and ``time_scale`` are unread (the standard cell); the LTC twin
    integrates on ``cfg.dt`` with ``cfg.ltc_substeps`` substeps.
    """
    spec = _int8_spec(cfg)
    B, T, D = xs.shape
    H = cfg.hidden
    h0 = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
    cell_a, cell_b, w1q, w2q = int8_weights(params, cfg)
    enc = params.encoder
    ltc = spec.family == "ltc"
    if rt.resolve_dispatch(xs, force_reference) is rt.Dispatch.REFERENCE:
        # the plan auditor's rule R4 sees the weights this path hands the kernel
        names = ("w_inq", "w_recq") if ltc else ("wxq", "whq")
        rt.observe_operands("mr_step_ltc_int8" if ltc else "mr_step_int8",
                            dict(zip((*names, "w1q", "w2q"),
                                     (q.values for q in (cell_a, cell_b, w1q, w2q)))))  # fmt: skip
        sig_t, tanh_t = serving_tables()
        if ltc:
            out = mr_step_ltc_int8_reference(
                xs, h0, cell_a.values, cell_a.scale, cell_b.values, cell_b.scale, enc.bias,
                enc.a, enc.inv_tau, w1q.values, w1q.scale, params.head_b1, w2q.values,
                w2q.scale, params.head_b2, sig_t, dt=cfg.dt, n_substeps=cfg.ltc_substeps,
            )  # fmt: skip
        else:
            if dts is None:
                dts = torch.ones(T, dtype=torch.float32, device=xs.device)
            out = mr_step_int8_reference(
                xs, h0, cell_a.values, cell_b.values, cell_a.scale, cell_b.scale, enc.b, dts,
                w1q.values, w1q.scale, params.head_b1, w2q.values, w2q.scale, params.head_b2,
                sig_t, tanh_t,
            )  # fmt: skip
        return split_out(out, cfg)
    Dh, K = cfg.dense_hidden, cfg.n_coef + cfg.n_shifts
    bb = tiling.legal_block_b(block_b, B) or tiling.fit_block_b(
        spec.family, B, D, H, Dh, K, int8=True
    )
    f32 = lambda t: t.to(torch.float32).contiguous()
    flat = lambda q: q.scale.reshape(-1)
    sig, tanh = serving_packs(xs.device)
    head = (w1q.values, flat(w1q), f32(params.head_b1), w2q.values, flat(w2q), f32(params.head_b2))
    if ltc:
        out = mr_step_ltc_int8_cuda(
            f32(xs), h0, cell_a.values, flat(cell_a), cell_b.values, flat(cell_b), f32(enc.bias),
            f32(enc.a), f32(enc.inv_tau), sig, *head, sub_dt=ltc_sub_dt(cfg.dt, cfg.ltc_substeps),
            n_substeps=cfg.ltc_substeps, block_b=bb,
        )  # fmt: skip
    else:
        out = mr_step_int8_cuda(
            f32(xs), h0, cell_a.values, cell_b.values, flat(cell_a), flat(cell_b), f32(enc.b),
            sig, tanh, *head, block_b=bb,
        )  # fmt: skip
    return split_out(out, cfg)
