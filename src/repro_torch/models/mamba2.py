"""Mamba2 (SSD) layer: projections, depthwise conv, chunked SSD scan
(``repro/models/mamba2.py``).

The scan runs through ``kernels/ssd_scan``: the hand-written CUDA kernel on
the card, ``ssd_chunked`` on the CPU. Decode keeps (conv window, SSD state)
as the constant-size cache and runs ``ssd_decode_step`` as plain PyTorch, as
the JAX package does (no Pallas kernel on that path). The projections stay
``torch.einsum``, as the JAX package leaves them to XLA.

As in the JAX package, the short causal conv is applied to the x stream only
(not B/C), and z-gating uses silu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step
from repro_torch.models.params import ParamSpec


def mamba_specs(cfg: ModelConfig, dtype: str) -> dict:
    s = cfg.ssm
    d, H, P, G, N = cfg.d_model, cfg.ssm_heads, s.head_dim, s.num_groups, s.state_dim
    si = 1.0 / (d**0.5)
    return {
        "wz": ParamSpec((d, H, P), ("embed", "ssm_heads", "head_dim"), dtype=dtype, scale=si),
        "wx": ParamSpec((d, H, P), ("embed", "ssm_heads", "head_dim"), dtype=dtype, scale=si),
        "wb": ParamSpec((d, G, N), ("embed", "ssm_groups", "ssm_state"), dtype=dtype, scale=si),
        "wc": ParamSpec((d, G, N), ("embed", "ssm_groups", "ssm_state"), dtype=dtype, scale=si),
        "wdt": ParamSpec((d, H), ("embed", "ssm_heads"), dtype=dtype, scale=si),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), dtype="float32", init="const", scale=-2.0),
        "a_log": ParamSpec((H,), ("ssm_heads",), dtype="float32", init="zeros"),
        "d_skip": ParamSpec((H,), ("ssm_heads",), dtype="float32", init="ones"),
        "conv": ParamSpec(
            (s.conv_width, H, P), ("conv", "ssm_heads", "head_dim"), dtype=dtype, scale=0.5
        ),
        "norm": ParamSpec((H, P), ("ssm_heads", "head_dim"), dtype=dtype, init="ones"),
        "out": ParamSpec((H, P, d), ("ssm_heads", "head_dim", "embed"), dtype=dtype, scale=si),
    }


def _proj(params, x):
    z = torch.einsum("bsd,dhp->bshp", x, params["wz"])
    xin = torch.einsum("bsd,dhp->bshp", x, params["wx"])
    bm = torch.einsum("bsd,dgn->bsgn", x, params["wb"])
    cm = torch.einsum("bsd,dgn->bsgn", x, params["wc"])
    dt = F.softplus(
        torch.einsum("bsd,dh->bsh", x, params["wdt"]).to(torch.float32) + params["dt_bias"]
    )
    return z, xin, bm, cm, dt


def _causal_conv(xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. xin: [B,S,H,P], w: [cw,H,P]."""
    cw, S = w.shape[0], xin.shape[1]
    pad = F.pad(xin, (0, 0, 0, 0, cw - 1, 0))
    out = torch.zeros(xin.shape, dtype=torch.float32, device=xin.device)
    for i in range(cw):
        out = out + pad[:, i : i + S].to(torch.float32) * w[i].to(torch.float32)
    return F.silu(out).to(xin.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    y = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = y.square().mean(-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(z.dtype)


def _out(params, y):
    return torch.einsum("bshp,hpd->bsd", y, params["out"])


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig, force_reference: bool = False):
    """Full-sequence SSD mixer. x: [B, S, D] -> [B, S, D]."""
    return mamba_prefill(params, x, cfg, force_reference)[0]


def mamba_prefill(params, x: torch.Tensor, cfg: ModelConfig, force_reference: bool = False):
    """Forward + cache {conv: [B,cw-1,H,P] (pre-activation tail), state: [B,H,N,P]}."""
    s = cfg.ssm
    z, xin, bm, cm, dt = _proj(params, x)
    conv_tail = xin[:, -(s.conv_width - 1) :]  # raw (pre-conv) inputs
    xc = _causal_conv(xin, params["conv"])
    A = -torch.exp(params["a_log"])
    y, state = ssd_scan(xc, dt, A, bm, cm, params["d_skip"], chunk=s.chunk,
                        force_reference=force_reference)  # fmt: skip
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    return _out(params, y), {"conv": conv_tail, "state": state.to(torch.float32)}


def mamba_decode(params, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """Single-token step. x: [B, 1, D]."""
    s = cfg.ssm
    z, xin, bm, cm, dt = _proj(params, x)  # seq dim = 1
    hist = torch.cat([cache["conv"], xin], dim=1)  # [B, cw, H, P]
    w = params["conv"]
    xc = sum(hist[:, i].to(torch.float32) * w[i].to(torch.float32) for i in range(s.conv_width))
    xc = F.silu(xc).to(x.dtype)
    A = -torch.exp(params["a_log"])
    y, state = ssd_decode_step(
        xc, dt[:, 0], A, bm[:, 0], cm[:, 0], params["d_skip"], cache["state"]
    )
    y = _gated_norm(y[:, None], z, params["norm"], cfg.norm_eps)
    return _out(params, y), {"conv": hist[:, 1:], "state": state}


def mamba_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    s = cfg.ssm
    H, P, N = cfg.ssm_heads, s.head_dim, s.state_dim
    return {
        "conv": ((batch, s.conv_width - 1, H, P), cfg.dtype, ("batch", None, "ssm_heads", None)),
        "state": ((batch, H, N, P), "float32", ("batch", "ssm_heads", None, None)),
    }
