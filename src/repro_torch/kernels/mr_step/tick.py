"""Banked service tick: the ``mr_tick`` kernel, its wrapper and its dispatch.

Counterpart of ``repro/kernels/mr_step/tick.py`` (``:69-84, 406-560``, fp32).
The composite service tick (``core/stream.tick``) reads its coefficients out
as a sequence of plain PyTorch ops: window gather, normalization, the
per-window encoder scan, the head, the EMA and the delta, hundreds of launches
a tick. ``mr_tick`` does the whole serving segment (ring ingest, window scan,
head, EMA readout and delta) for every slot in one launch of
``csrc/mr_tick.cu``, which replaces ``tick.py:148 mr_tick_pallas``.

``mr_tick(..., quant=True)`` serves through the int8/PWL twin
(``csrc/mr_tick_int8.cu``, which replaces ``tick.py:313 mr_tick_pallas_int8``):
the standard GRU cell with int8 gate and head weights, quantized per slot
and per output channel from the RAW weights (no QAT treatment first, as
``tick.py:450-453``), and the PWL sigmoid and tanh. Both kernels run a
slot's windows a warp each over a thread-block cluster (``csrc/warp_cell.cuh``,
the fp32 and the int8 policy of one cell).

``mr_tick`` takes the kernel for CUDA tensors and the plain version
(``ref.mr_tick_reference``, ``ref.mr_tick_int8_reference``) for CPU tensors;
``force_reference`` wins. The tick is serve-only: the K optimizer steps of a
training tick stay in the stacked train step (``core/stream.tick_banked``),
so there is no backward.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoders
from repro_torch.data.windows import n_buffer_windows, roll_buffer
from repro_torch.kernels import runtime as rt
from repro_torch.core.quant import N_SEG, PWL_FLOATS, serving_packs, serving_tables
from repro_torch.kernels.mr_step.ops import head_weights, int8_weights
from repro_torch.kernels.mr_step.ref import mr_tick_int8_reference, mr_tick_reference


def tick_supported(cfg, *, int8: bool = False) -> bool:
    """True when the banked tick implements ``cfg``'s encoder cell: the GRU
    families (one gated update a window step); ``ltc`` and ``node`` stay on
    the composite tick. The int8 twin needs the standard GRU cell."""
    spec = encoders.get_encoder(cfg.encoder)
    return spec.family == "gru" and (spec.int8 or not int8)


def _check_tick(kernel: str, S, C, L, Kc, Ko, slots_per_bank, *carve_dims) -> None:
    """Raise on a bank or chunk the tick does not take, or a launch that would
    request more shared memory than a block has: ``kernel``'s exported carve
    at ``carve_dims`` (``runtime.kernel_smem_bytes``), what it really requests."""
    if slots_per_bank < 1 or S % slots_per_bank or not 1 <= C <= L or Kc > Ko:
        raise ValueError(
            f"{kernel}: slots_per_bank={slots_per_bank} must divide S={S}, chunk C={C} lie "
            f"in [1, L={L}], Kc={Kc} <= Ko={Ko}"
        )
    rt.check_smem(kernel, rt.kernel_smem_bytes(kernel, *carve_dims))


def mr_tick_cuda(
    buf_y, new_y, mean, scale, theta0, seed, active, wx, wh, b, time_scale, w1, b1, w2, b2,
    buf_u=None, new_u=None, *, flow: bool, window: int, stride: int, ema: float,
    slots_per_bank: int = 1,
):  # fmt: skip
    """Launch the banked tick on the current stream.

    Operands as ``mr_tick_reference``'s, with seed and active as float32 [S]
    (1.0 = true). Returns (buf_y, theta [S, Kc], delta [S][, buf_u]). Counts
    its launches in ``mr_tick_cuda.launches``.
    """
    S, L, n = buf_y.shape
    C = new_y.shape[1]
    H = wh.shape[1]
    D = wx.shape[1]
    Dh, Ko = w2.shape[1:]
    Kc = theta0.shape[1]
    m = D - n
    N = n_buffer_windows(L, window, stride)
    dev = buf_y.device
    operands = dict(
        buf_y=(buf_y, (S, L, n)),
        new_y=(new_y, (S, C, n)),
        mean=(mean, (S, n)),
        scale=(scale, (S, n)),
        theta0=(theta0, (S, Kc)),
        seed=(seed, (S,)),
        active=(active, (S,)),
        wx=(wx, (S, D, 3 * H)),
        wh=(wh, (S, H, 3 * H)),
        b=(b, (S, 3 * H)),
        time_scale=(time_scale, (S, H)),
        w1=(w1, (S, H, Dh)),
        b1=(b1, (S, Dh)),
        w2=(w2, (S, Dh, Ko)),
        b2=(b2, (S, Ko)),
    )
    if m > 0:
        operands.update(buf_u=(buf_u, (S, L, m)), new_u=(new_u, (S, C, m)))
    rt.check_operands("mr_tick", dev, **operands)
    _check_tick("mr_tick", S, C, L, Kc, Ko, slots_per_bank, D, H, Dh, Ko, window, N)
    h0 = torch.zeros(N, H, dtype=torch.float32, device=dev)
    buf_y_out = torch.empty_like(buf_y)
    theta = torch.empty((S, Kc), dtype=torch.float32, device=dev)
    delta = torch.empty((S,), dtype=torch.float32, device=dev)
    buf_u_out = torch.empty_like(buf_u) if m > 0 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    tensors = (buf_y, new_y, mean, scale, theta0, seed, active, wx, wh, b, time_scale,
               w1, b1, w2, b2, h0, buf_u if m > 0 else None, new_u if m > 0 else None,
               buf_y_out, theta, delta, buf_u_out)  # fmt: skip
    err = rt.load_library().mr_tick_launch(
        *(ptr(t) for t in tensors),
        S, L, n, m, C, window, stride, H, Dh, Ko, Kc, slots_per_bank, int(flow),
        ema, 1.0 - ema, rt.current_stream(dev),
    )  # fmt: skip
    rt.check_launch("mr_tick", err)
    mr_tick_cuda.launches += 1
    return (buf_y_out, theta, delta, buf_u_out) if m > 0 else (buf_y_out, theta, delta)


def mr_tick_int8_cuda(
    buf_y, new_y, mean, scale, theta0, seed, active, wxq, whq, wx_scale, wh_scale, b, sig,
    tanh, w1q, w1_scale, b1, w2q, w2_scale, b2, buf_u=None, new_u=None, *, window: int,
    stride: int, ema: float, slots_per_bank: int = 1,
):  # fmt: skip
    """Launch the int8/PWL banked tick on the current stream.

    Operands as ``mr_tick_int8_reference``'s, with the scales flattened per
    slot ([S, 3H], [S, Dh], [S, Ko]), seed and active as float32 [S] and the
    tables packed (``core.quant.serving_packs``). Returns (buf_y, theta [S, Kc],
    delta [S][, buf_u]). Counts its launches in ``mr_tick_int8_cuda.launches``.
    """
    S, L, n = buf_y.shape
    C = new_y.shape[1]
    H = whq.shape[1]
    D = wxq.shape[1]
    Dh, Ko = w2q.shape[1:]
    Kc = theta0.shape[1]
    m = D - n
    N = n_buffer_windows(L, window, stride)
    dev = buf_y.device
    i8 = torch.int8
    operands = dict(
        buf_y=(buf_y, (S, L, n)),
        new_y=(new_y, (S, C, n)),
        mean=(mean, (S, n)),
        scale=(scale, (S, n)),
        theta0=(theta0, (S, Kc)),
        seed=(seed, (S,)),
        active=(active, (S,)),
        wxq=(wxq, (S, D, 3 * H), i8),
        whq=(whq, (S, H, 3 * H), i8),
        wx_scale=(wx_scale, (S, 3 * H)),
        wh_scale=(wh_scale, (S, 3 * H)),
        b=(b, (S, 3 * H)),
        sig=(sig, (PWL_FLOATS,)),
        tanh=(tanh, (PWL_FLOATS,)),
        w1q=(w1q, (S, H, Dh), i8),
        w1_scale=(w1_scale, (S, Dh)),
        b1=(b1, (S, Dh)),
        w2q=(w2q, (S, Dh, Ko), i8),
        w2_scale=(w2_scale, (S, Ko)),
        b2=(b2, (S, Ko)),
    )
    if m > 0:
        operands.update(buf_u=(buf_u, (S, L, m)), new_u=(new_u, (S, C, m)))
    rt.check_operands("mr_tick_int8", dev, **operands)
    _check_tick("mr_tick_int8", S, C, L, Kc, Ko, slots_per_bank, D, H, Dh, Ko, window, N,
                N_SEG)
    h0 = torch.zeros(N, H, dtype=torch.float32, device=dev)
    buf_y_out = torch.empty_like(buf_y)
    theta = torch.empty((S, Kc), dtype=torch.float32, device=dev)
    delta = torch.empty((S,), dtype=torch.float32, device=dev)
    buf_u_out = torch.empty_like(buf_u) if m > 0 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    tensors = (buf_y, new_y, mean, scale, theta0, seed, active, wxq, whq, wx_scale, wh_scale, b,
               sig, tanh, w1q, w1_scale, b1, w2q, w2_scale, b2, h0, buf_u if m > 0 else None,
               new_u if m > 0 else None, buf_y_out, theta, delta, buf_u_out)  # fmt: skip
    err = rt.load_library().mr_tick_int8_launch(
        *(ptr(t) for t in tensors),
        S, L, n, m, C, window, stride, H, Dh, Ko, Kc, slots_per_bank, N_SEG,
        ema, 1.0 - ema, rt.current_stream(dev),
    )  # fmt: skip
    rt.check_launch("mr_tick_int8", err)
    mr_tick_int8_cuda.launches += 1
    return (buf_y_out, theta, delta, buf_u_out) if m > 0 else (buf_y_out, theta, delta)


mr_tick_cuda.launches = 0
mr_tick_int8_cuda.launches = 0


def tick_weights(params, cfg) -> tuple:
    """A slot-stacked MRParams as the tick's weight operands (wx, wh, b,
    time_scale, w1, b1, w2, b2), the QAT weight treatment applied."""
    enc = encoders.quantized_gru_params(params.encoder, cfg)
    d_in = cfg.state_dim + cfg.input_dim
    return (enc.w[:, :d_in], enc.w[:, d_in:], enc.b, enc.time_scale, *head_weights(params, cfg))


@torch.no_grad()
def mr_tick(
    params,  # slot-stacked merinda.MRParams (every leaf has leading axis S)
    cfg,  # merinda.MRConfig of a GRU-family encoder
    scfg,  # stream.StreamConfig: window, stride, chunk, ema
    buf_y: torch.Tensor,  # [S, L, n] pre-roll buffers
    buf_u: torch.Tensor,  # [S, L, m] (m may be 0)
    new_y: torch.Tensor,  # [S, C, n]
    new_u: torch.Tensor,  # [S, C, m]
    mean: torch.Tensor,  # [S, n]
    scale: torch.Tensor,  # [S, n]
    theta_prev: torch.Tensor,  # [S, n_terms, n] previous EMA readout
    seed: torch.Tensor,  # [S] bool: seed the EMA this tick
    active: torch.Tensor,  # [S] bool
    *,
    quant: bool = False,
    slots_per_bank: int = 1,
    force_reference: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-launch serve tick: (buf_y, buf_u, theta [S, n_terms, n], delta [S]).

    fp32: the QAT weight treatment (``quantized_gru_params``,
    ``head_weights``) is applied to the weights before the launch, as in the
    JAX wrapper. ``quant=True``: the int8/PWL twin on the raw weights.
    """
    if not tick_supported(cfg, int8=quant):
        raise ValueError(
            f"mr_tick banks the GRU families only (int8 twin: the standard 'gru' cell); "
            f"got encoder={cfg.encoder!r} quant={quant} — use the composite tick"
        )
    S = buf_y.shape[0]
    has_u = cfg.input_dim > 0
    theta0 = theta_prev.reshape(S, cfg.n_coef)
    u_args = (buf_u, new_u) if has_u else (None, None)
    kw = dict(window=scfg.window, stride=scfg.stride, ema=scfg.ema)
    reference = rt.resolve_dispatch(buf_y, force_reference) is rt.Dispatch.REFERENCE
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    if quant:
        wxq, whq, w1q, w2q = int8_weights(params, cfg, batch_dims=1)
        if reference:  # the plan auditor's rule R4 sees the weights handed to the kernel
            rt.observe_operands("mr_tick_int8", dict(wxq=wxq.values, whq=whq.values,
                                                     w1q=w1q.values, w2q=w2q.values))  # fmt: skip
            out = mr_tick_int8_reference(
                buf_y, new_y, mean, scale, theta0, seed, active, wxq.values, whq.values,
                wxq.scale, whq.scale, params.encoder.b, w1q.values, w1q.scale, params.head_b1,
                w2q.values, w2q.scale, params.head_b2, *serving_tables(), *u_args, **kw,
            )  # fmt: skip
        else:
            flat = lambda q: q.scale.reshape(S, -1)
            out = mr_tick_int8_cuda(
                *map(f32, (buf_y, new_y, mean, scale, theta0, seed, active)), wxq.values,
                whq.values, flat(wxq), flat(whq), f32(params.encoder.b),
                *serving_packs(buf_y.device), w1q.values, flat(w1q), f32(params.head_b1),
                w2q.values, flat(w2q), f32(params.head_b2), *map(f32, u_args),
                slots_per_bank=slots_per_bank, **kw,
            )  # fmt: skip
    else:
        tensors = (buf_y, new_y, mean, scale, theta0, seed, active, *tick_weights(params, cfg),
                   *u_args)  # fmt: skip
        kw["flow"] = encoders.get_encoder(cfg.encoder).flow
        if reference:
            out = mr_tick_reference(*tensors, **kw)
        else:
            out = mr_tick_cuda(*map(f32, tensors), slots_per_bank=slots_per_bank, **kw)
    buf_y2, theta_flat, delta = out[:3]
    buf_u2 = out[3] if has_u else roll_buffer(buf_u, new_u)
    return buf_y2, buf_u2, theta_flat.reshape(S, cfg.n_terms, cfg.state_dim), delta
