"""Encoder registry (counterpart of ``repro/core/encoders.py``).

One table maps encoder names to init/encode backends:

    "gru_flow"         MERINDA GRU neural flow (plain PyTorch scan)
    "gru"              standard GRU, paper Eq. 12-15 (plain PyTorch scan)
    "ltc"              Liquid Time-Constant baseline (K semi-implicit substeps)
    "node"             ODE-RNN / NODE baseline (K Euler substeps)
    "gru_flow_kernel"  gru_flow through the gru_scan kernel
    "gru_kernel"       gru through the gru_scan kernel

The ``*_kernel`` rows resolve their backend through
``kernels/runtime.resolve_dispatch``: the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor. A row's fields:

    flow      time-gated flow update (None for the non-GRU families)
    fusable   the fused stage (``kernels/mr_step``, ``MRConfig.fused``)
              implements this encoder
    kernel    encode routes through the gru_scan kernel
    int8      the fixed-point fused serving stage (int8 weights and PWL
              activations, ``kernels/mr_step/ops.mr_step_int8``) implements
              this encoder: the standard GRU cell and the LTC substep
    family    which fused kernel a row lowers to: "gru", "ltc" or "node"

``encode`` owns the GRU families' QAT weight treatment
(``quantized_gru_params``), so callers never touch family internals.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.ltc import init_ltc, ltc_scan
from repro_torch.core.neural_flow import GRUParams, gru_scan_ref, init_gru
from repro_torch.core.node_mr import init_node_encoder, node_encode
from repro_torch.core.quant import qat_weight


class EncoderSpec(NamedTuple):
    name: str
    init: Callable[..., Any]  # (generator, d_in, hidden, device, dtype) -> params
    encode: Callable[..., torch.Tensor]  # (params, cfg, xs, force_reference) -> h_T [B, H]
    flow: bool | None  # GRU families: time-gated flow update?
    fusable: bool  # kernels/mr_step implements this encoder
    kernel: bool  # encode routes through the gru_scan kernel
    int8: bool = False  # the int8/PWL fused serving stage implements it
    family: str = "gru"  # fused kernel: "gru" | "ltc" | "node"


def quantized_gru_params(params: GRUParams, cfg) -> GRUParams:
    """The QAT weight treatment of every GRU-family encode path."""
    if cfg.quant is None:
        return params
    return params._replace(w=qat_weight(params.w, cfg.quant))


def _encode_gru(
    params: GRUParams, cfg, xs: torch.Tensor, force_reference: bool, *, flow: bool, kernel: bool
):
    params = quantized_gru_params(params, cfg)
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

    return EncoderSpec(
        name, init_gru, encode, flow=flow, fusable=True, kernel=kernel, int8=not flow
    )


def _encode_ltc(params, cfg, xs: torch.Tensor, force_reference: bool = False):
    h0 = torch.zeros(xs.shape[0], cfg.hidden, dtype=xs.dtype, device=xs.device)
    h_T, _ = ltc_scan(params, xs, h0, dt=cfg.dt, n_substeps=cfg.ltc_substeps)
    return h_T


def _encode_node(params, cfg, xs: torch.Tensor, force_reference: bool = False):
    return node_encode(params, xs, cfg)


_REGISTRY: dict[str, EncoderSpec] = {
    row.name: row
    for row in (
        _gru_row("gru_flow", flow=True, kernel=False),
        _gru_row("gru", flow=False, kernel=False),
        _gru_row("gru_flow_kernel", flow=True, kernel=True),
        _gru_row("gru_kernel", flow=False, kernel=True),
        EncoderSpec(
            "ltc", init_ltc, _encode_ltc, flow=None, fusable=True, kernel=False,
            int8=True, family="ltc",
        ),
        EncoderSpec(
            "node", init_node_encoder, _encode_node, flow=None, fusable=True, kernel=False,
            family="node",
        ),
    )
}  # fmt: skip


def get_encoder(name: str) -> EncoderSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown encoder {name!r}; registered: {encoder_names()}")
    return _REGISTRY[name]


def encoder_names() -> list[str]:
    return sorted(_REGISTRY)


def fusable_names() -> list[str]:
    return [n for n in encoder_names() if _REGISTRY[n].fusable]


def int8_names() -> list[str]:
    """Encoders with a fixed-point (int8 and PWL) fused serving stage."""
    return [n for n in encoder_names() if _REGISTRY[n].int8]


def validate_config(cfg) -> EncoderSpec:
    """The encoder row of an MRConfig; raises for an unknown name and for
    ``fused=True`` on a row without a fused stage."""
    spec = get_encoder(cfg.encoder)
    if cfg.fused and not spec.fusable:
        raise ValueError(
            f"MRConfig(fused=True) requires a fusable encoder, got {cfg.encoder!r} "
            f"(no fused mr_step stage exists for this family; fusable: {fusable_names()})"
        )
    return spec
