"""Shared building blocks: RMSNorm, embedding, LM head, cross-entropy, the
SwiGLU MLP (``repro/models/layers.py``).

The JAX package's sharding hints (``parallel/rules.constraint``,
``sp_gather``) are identities on one card, and the port drops them.
"""

from __future__ import annotations

import torch

from repro_torch.models.params import ParamSpec


def rmsnorm_specs(d: int, dtype: str):
    return {"scale": ParamSpec((d,), (None,), dtype=dtype, init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def embed_specs(vocab_padded: int, d: int, dtype: str):
    return {"tokens": ParamSpec((vocab_padded, d), ("vocab", "embed"), dtype=dtype, scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tokens"][tokens]


def lm_head_specs(d: int, vocab_padded: int, dtype: str):
    return {"w": ParamSpec((d, vocab_padded), ("embed", "vocab"), dtype=dtype, scale=0.02)}


def lm_head(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def cross_entropy(
    logits: torch.Tensor,  # [B, S, Vp]
    labels: torch.Tensor,  # [B, S] integer; -1 = ignore
    vocab_size: int,
    chunk: int = 0,
) -> torch.Tensor:
    """Mean CE over the positions whose label is >= 0, in float32; the padded
    vocabulary tail (columns >= ``vocab_size``) is set to -1e30 before the
    logsumexp.

    ``chunk`` > 0 that divides a longer sequence sums the loss over segments
    of ``chunk`` positions (the JAX package's ``lax.map``: it bounds the
    float32 working set of a long sequence), then divides once.
    """

    def ce(lg, lb):
        lg = lg.to(torch.float32)
        vp = lg.shape[-1]
        if vp > vocab_size:
            keep = torch.arange(vp, device=lg.device) < vocab_size
            lg = torch.where(keep, lg, torch.tensor(-1e30, device=lg.device))
        lse = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, lb.clamp(min=0).long()[..., None])[..., 0]
        valid = (lb >= 0).to(torch.float32)
        return ((lse - gold) * valid).sum(), valid.sum()

    S = logits.shape[1]
    if chunk and S > chunk and S % chunk == 0:
        parts = [ce(lg, lb) for lg, lb in zip(logits.split(chunk, 1), labels.split(chunk, 1))]
        tot, cnt = (torch.stack(p).sum() for p in zip(*parts))
    else:
        tot, cnt = ce(logits, labels)
    return tot / torch.clamp(cnt, min=1.0)


def mlp_specs(d: int, f: int, dtype: str):
    si, sf = 1.0 / (d**0.5), 1.0 / (f**0.5)
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp"), dtype=dtype, scale=si),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), dtype=dtype, scale=si),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), dtype=dtype, scale=sf),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x.w_gate) * (x.w_up), then .w_down. Plain products, as the
    JAX package leaves them to XLA."""
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
