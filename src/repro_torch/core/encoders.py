"""Encoder registry (counterpart of ``repro/core/encoders.py``).

One table maps encoder names to init/encode backends. The GRU rows:

    "gru_flow"         MERINDA GRU neural flow (plain PyTorch scan)
    "gru"              standard GRU, paper Eq. 12-15 (plain PyTorch scan)
    "gru_flow_kernel"  gru_flow through the gru_scan kernel
    "gru_kernel"       gru through the gru_scan kernel

The ``*_kernel`` rows resolve their backend through
``kernels/runtime.resolve_dispatch``: the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor. Every row also has the fused stage
(``kernels/mr_step``, ``MRConfig.fused``).
The ``ltc`` and ``node`` baselines are not yet ported and raise.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.neural_flow import GRUParams, gru_scan_ref, init_gru

NOT_YET_PORTED = ("ltc", "node")


class EncoderSpec(NamedTuple):
    name: str
    init: Callable[..., Any]  # (generator, d_in, hidden, device, dtype) -> params
    encode: Callable[..., torch.Tensor]  # (params, cfg, xs, force_reference) -> h_T [B, H]
    flow: bool  # time-gated flow update
    kernel: bool  # encode routes through the gru_scan kernel


def _encode_gru(
    params: GRUParams, cfg, xs: torch.Tensor, force_reference: bool, *, flow: bool, kernel: bool
):
    h0 = torch.zeros(xs.shape[0], cfg.hidden, dtype=xs.dtype, device=xs.device)
    if kernel:
        from repro_torch.kernels.gru_scan.ops import gru_scan

        h_T, _ = gru_scan(params, xs, h0, flow=flow, force_reference=force_reference)
    else:
        h_T, _ = gru_scan_ref(params, xs, h0, flow=flow)
    return h_T


def _gru_row(name: str, *, flow: bool, kernel: bool) -> EncoderSpec:
    def encode(params, cfg, xs, force_reference=False):
        return _encode_gru(params, cfg, xs, force_reference, flow=flow, kernel=kernel)

    return EncoderSpec(name, init_gru, encode, flow=flow, kernel=kernel)


_REGISTRY: dict[str, EncoderSpec] = {
    row.name: row
    for row in (
        _gru_row("gru_flow", flow=True, kernel=False),
        _gru_row("gru", flow=False, kernel=False),
        _gru_row("gru_flow_kernel", flow=True, kernel=True),
        _gru_row("gru_kernel", flow=False, kernel=True),
    )
}


def get_encoder(name: str) -> EncoderSpec:
    if name in NOT_YET_PORTED:
        raise ValueError(f"encoder {name!r} is not yet ported to repro_torch")
    if name not in _REGISTRY:
        raise ValueError(f"unknown encoder {name!r}; registered: {encoder_names()}")
    return _REGISTRY[name]


def encoder_names() -> list[str]:
    return sorted(_REGISTRY)
