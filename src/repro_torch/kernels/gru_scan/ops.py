"""GRU(-flow) sequence scan: the CUDA kernels, their wrappers and the gradient.

Counterpart of ``repro/kernels/gru_scan/ops.py``. ``gru_scan`` dispatches
through ``kernels/runtime.resolve_dispatch``: a CUDA tensor launches the
hand-written kernel (``csrc/gru_scan.cu``, which replaces
``repro/kernels/gru_scan/kernel.py:107 gru_scan_pallas``), a CPU tensor or
``force_reference`` takes the plain version (``ref.py``). The gradient
recomputes the plain version, as ``repro/kernels/gru_scan/ops.py:39-53``
does: the JAX package has no backward kernel, and neither has the port.
Under ``torch.func.vmap`` (the ``*_kernel`` rows in batch and stream mode)
the Function's vmap rule (``runtime.kernel_function``) launches the
slot-axis form ``gru_scan_slots_cuda`` once for all slots. The source has one
kernel, which takes a slot axis (grid (B / block_b, S); one call is S = 1),
so each slot is bit for bit the per-call wrapper on its slice; the two
wrappers count their launches apart.

Past the warp cell's width (H > ``tiling.MAX_HIDDEN`` = 256; the merinda-gru
LM's H = 512) ``gru_scan`` launches the wide form ``gru_scan_wide_cuda``
(``csrc/gru_scan_wide.cu``: a GEMM for x.Wx + b, then the recurrence on a
thread-block cluster a batch row, up to H = 512). Each width has its kernel
and both share the plain version; a shape neither takes raises (the warp
cell's carve check refuses a (D, H) whose wx and wh do not fit a block), and
so does a failed build or launch. The wide form has no slot axis (no path vmaps it), and
its gradient is the same recomputed plain version.

``gru_scan_int8`` is the serving scan (``ops.py:92-136``): the standard GRU
with int8 weights quantized on the fly per output channel and PWL
activations, through ``csrc/gru_scan_int8.cu`` (which replaces
``kernel.py:246 gru_scan_pallas_int8``; ``gru_scan``'s warp cell on the int8
policy). It is serve-only: no gradient.
"""

from __future__ import annotations

import torch

from repro_torch.core.neural_flow import GRUParams
from repro_torch.core.quant import N_SEG, PWL_FLOATS, quantize_int8, serving_packs, serving_tables
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.gru_scan.ref import gru_scan_int8_reference, gru_scan_reference
from repro_torch.kernels.mr_step import tiling


def _launch_gru_scan(name, xs, h0, wx, wh, b, time_scale, dts, *, in_dims, flow: bool,
                     block_b: int | None):  # fmt: skip
    """One launch of ``csrc/gru_scan.cu``: hs [S, B, T, H] (see ``gru_scan_slots_cuda``)."""
    B, T, D = xs.shape[-3:]
    H = h0.shape[-1]
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
    )
    block_b = block_b or tiling.fit_block_b("gru_scan", B, D, H, slots=S)
    if T < 1 or block_b < 1 or B % block_b:
        raise ValueError(f"{name}: T={T} and block_b={block_b} must be >= 1, B={B} a multiple")
    # the bytes the launch requests (the library's own layout), against the budget
    rt.check_smem(name, rt.kernel_smem_bytes("gru_scan", D, H, block_b))
    hs = torch.empty((S, B, T, H), dtype=torch.float32, device=xs.device)
    err = rt.load_library().gru_scan_launch(
        *(t.data_ptr() for t in (xs, h0, wx, wh, b, time_scale, dts, hs)),
        *strides, S, B, T, D, H, block_b, int(flow), rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch(name, err)
    return hs


def gru_scan_cuda(xs, h0, wx, wh, b, time_scale, dts, *, flow: bool, block_b: int | None = None):
    """Launch the CUDA scan on the current stream: returns hs [B, T, H].

    One slot of ``csrc/gru_scan.cu``. ``block_b=None`` fits the tile to B.
    Counts its launches in ``gru_scan_cuda.launches``.
    """
    hs = _launch_gru_scan("gru_scan", xs[None], h0, wx, wh, b, time_scale, dts,
                          in_dims=(0,) + (None,) * 6, flow=flow, block_b=block_b)[0]  # fmt: skip
    gru_scan_cuda.launches += 1
    return hs


def gru_scan_slots_cuda(
    xs, h0, wx, wh, b, time_scale, dts, *, in_dims, flow: bool, block_b: int | None = None
):
    """Launch S scans as one kernel on the current stream: hs [S, B, T, H],
    slot s equal bit for bit to ``gru_scan_cuda`` on slot s's operands.

    Operand i is [S, ...] (``in_dims[i] == 0``) or one operand shared by every
    slot (``None``: slot stride 0). ``block_b=None`` fits the tile to the
    S * B windows. Counts its launches in ``gru_scan_slots_cuda.launches``.
    """
    hs = _launch_gru_scan("gru_scan_slots", xs, h0, wx, wh, b, time_scale, dts, in_dims=in_dims,
                          flow=flow, block_b=block_b)  # fmt: skip
    gru_scan_slots_cuda.launches += 1
    return hs


def gru_scan_wide_cuda(xs, h0, wx, wh, b, time_scale, dts, *, flow: bool):
    """Launch the wide scan on the current stream: returns hs [B, T, H].

    ``csrc/gru_scan_wide.cu`` for 1 <= H <= 512: ``gru_wide_gx_kernel`` (x.Wx + b
    for every step into a [B, T, 3H] scratch; ``gru_wide_gx_skinny_kernel`` at
    B * T <= ``tiling.WIDE_SKINNY_ROWS``), then ``gru_wide_kernel`` (the
    recurrence, a cluster of 16 blocks a batch row, its weights in registers).
    Counts its calls (two kernels each) in ``gru_scan_wide_cuda.launches``.
    """
    B, T, D = xs.shape
    H = h0.shape[-1]
    rt.check_operands(
        "gru_scan_wide",
        xs.device,
        xs=(xs, (B, T, D)),
        h0=(h0, (B, H)),
        wx=(wx, (D, 3 * H)),
        wh=(wh, (H, 3 * H)),
        b=(b, (3 * H,)),
        time_scale=(time_scale, (H,)),
        dts=(dts, (T,)),
    )
    if T < 1 or not 1 <= H <= tiling.WIDE_MAX_HIDDEN:
        raise ValueError(f"gru_scan_wide: T={T} and H={H} (at most {tiling.WIDE_MAX_HIDDEN}) "
                         "out of range")  # fmt: skip
    rt.check_smem("gru_scan_wide", rt.kernel_smem_bytes("gru_scan_wide", H))
    gx = torch.empty((B, T, 3 * H), dtype=torch.float32, device=xs.device)
    hs = torch.empty((B, T, H), dtype=torch.float32, device=xs.device)
    err = rt.load_library().gru_scan_wide_launch(
        *(t.data_ptr() for t in (xs, h0, wx, wh, b, time_scale, dts, gx, hs)),
        B, T, D, H, int(flow), rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch("gru_scan_wide", err)
    gru_scan_wide_cuda.launches += 1
    return hs


def _no_slot_axis(*args, **kwargs):
    raise ValueError("gru_scan_wide: the wide form has no slot axis (nothing vmaps it)")


gru_scan_cuda.launches = 0
gru_scan_slots_cuda.launches = 0
gru_scan_wide_cuda.launches = 0

# apply(kernel_kw, ref_kw, xs, h0, wx, wh, b, time_scale, dts): one launch a
# call, one slot-axis launch a call under torch.func.vmap
_GRUScanFn = rt.kernel_function(
    "_GRUScanFn", gru_scan_cuda, gru_scan_slots_cuda, gru_scan_reference
)
_GRUScanWideFn = rt.kernel_function(
    "_GRUScanWideFn", gru_scan_wide_cuda, _no_slot_axis, gru_scan_reference
)


def gru_scan(
    params: GRUParams,
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    dts: torch.Tensor | None = None,
    flow: bool = True,
    block_b: int | None = None,
    force_reference: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused GRU(-flow) scan. Returns (h_final [B, H], hs [B, T, H]).

    On the card the warp cell (``gru_scan_cuda``) at H <= ``tiling.MAX_HIDDEN``,
    the wide form (``gru_scan_wide_cuda``, a batch row a cluster, ``block_b``
    unread) past it."""
    B, T, D = xs.shape
    H = params.hidden
    if dts is None:
        dts = torch.ones(T, dtype=xs.dtype, device=xs.device)
    wx, wh = params.w[:D], params.w[D:]
    if rt.resolve_dispatch(xs, force_reference) is rt.Dispatch.REFERENCE:
        hs = gru_scan_reference(xs, h0, wx, wh, params.b, params.time_scale, dts, flow=flow)
    elif H > tiling.MAX_HIDDEN:
        hs = _GRUScanWideFn.apply(dict(flow=flow), dict(flow=flow), xs.contiguous(),
                                  h0.contiguous(), wx, wh, params.b, params.time_scale, dts)  # fmt: skip
    else:  # an illegal tile is dropped: the launch fits its own (to B, or S * B under vmap)
        kernel_kw = dict(flow=flow, block_b=tiling.legal_block_b(block_b, B))
        hs = _GRUScanFn.apply(kernel_kw, dict(flow=flow), xs.contiguous(), h0.contiguous(), wx,
                              wh, params.b, params.time_scale, dts)  # fmt: skip
    return hs[:, -1, :], hs


def gru_scan_int8_cuda(xs, h0, wxq, whq, wx_scale, wh_scale, b, sig, tanh, *, block_b: int):
    """Launch the int8/PWL scan on the current stream: returns hs [B, T, H].

    ``wxq`` [D, 3H] and ``whq`` [H, 3H] are int8, their scales float32 [3H];
    ``sig`` and ``tanh`` are packed tables (``core.quant.serving_packs``). Counts
    its launches in ``gru_scan_int8_cuda.launches``.
    """
    B, T, D = xs.shape
    H = h0.shape[-1]
    rt.check_operands(
        "gru_scan_int8",
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
    )
    if T < 1 or block_b < 1 or B % block_b:
        raise ValueError(f"gru_scan_int8: T={T} and block_b={block_b} must be >= 1, B={B} a multiple")
    if H > tiling.MAX_HIDDEN:
        raise ValueError(f"gru_scan_int8: H={H} exceeds the warp cell's {tiling.MAX_HIDDEN} units")
    rt.check_smem("gru_scan_int8", rt.kernel_smem_bytes("gru_scan_int8", D, H, block_b, N_SEG))
    hs = torch.empty((B, T, H), dtype=torch.float32, device=xs.device)
    err = rt.load_library().gru_scan_int8_launch(
        *(t.data_ptr() for t in (xs, h0, wxq, whq, wx_scale, wh_scale, b, sig, tanh, hs)),
        B, T, D, H, block_b, N_SEG, rt.current_stream(xs.device),
    )  # fmt: skip
    rt.check_launch("gru_scan_int8", err)
    gru_scan_int8_cuda.launches += 1
    return hs


gru_scan_int8_cuda.launches = 0


@torch.no_grad()
def gru_scan_int8(
    params: GRUParams,
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    dts: torch.Tensor | None = None,
    block_b: int | None = None,
    force_reference: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Serving scan: int8 weights and PWL activations, the standard GRU.
    Returns (h_final [B, H], hs [B, T, H]).

    Quantizes the float weights on every call, as the JAX wrapper does.
    ``dts`` and ``time_scale`` are unread: the standard cell has no time gate.
    """
    B, T, D = xs.shape
    H = params.hidden
    if dts is None:
        dts = torch.ones(T, dtype=torch.float32, device=xs.device)
    wxq = quantize_int8(params.w[:D])
    whq = quantize_int8(params.w[D:])
    if rt.resolve_dispatch(xs, force_reference) is rt.Dispatch.REFERENCE:
        hs = gru_scan_int8_reference(xs, h0, wxq.values, whq.values, wxq.scale, whq.scale,
                                     params.b, dts, *serving_tables())  # fmt: skip
    else:
        bb = tiling.legal_block_b(block_b, B) or tiling.fit_block_b("gru_scan", B, D, H, int8=True)
        f32 = lambda t: t.to(torch.float32).contiguous()
        hs = gru_scan_int8_cuda(
            f32(xs), f32(h0), wxq.values, whq.values, wxq.scale.reshape(-1),
            whq.scale.reshape(-1), f32(params.b), *serving_packs(xs.device),
            block_b=bb,
        )  # fmt: skip
    return hs[:, -1, :], hs
