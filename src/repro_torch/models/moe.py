"""Mixture-of-Experts FFN: a top-k router and two dispatches (``repro/models/moe.py``).

Tokens are routed in groups of ``group_size`` (the token count padded with
zero rows to a group multiple; the padded rows enter the load-balancing loss
and are sliced off the output). ``moe_ffn`` has the JAX package's two
branches:

- ``dropless=True``, the inference path (prefill and decode): every
  (token, expert choice) is honoured, so a token's output depends on that
  token alone. As in the JAX package the form is dense: every expert runs on
  every token, and the routing weights combine them (E / top_k times the
  routed products). The products are batched over the experts
  (``torch.matmul`` of the tokens against the [E, D, F] weights), so each
  expert's weights are read once and never copied.
- the capacity-bounded dispatch (training): each expert takes at most
  ``expert_capacity`` tokens of a group, in token order; the rest are
  dropped. The one-hot dispatch and combine tensors are [groups, group_size,
  E, C].

The router runs in float32 and the combine weights are cast to x's dtype, as
in the JAX package. Top-k takes the larger probability first and, between
equal ones, the lower expert (``jax.lax.top_k``'s order, which sets the queue
positions of the capacity branch; a padded row's probabilities are all
equal). The JAX package's sharding hints (``sp_gather``, ``constraint``) are
identities on one card and are dropped. No Pallas kernel is on this path:
the expert products are einsums in the JAX package, and plain products here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.params import ParamSpec


def moe_specs(m: MoEConfig, d: int, f: int, dtype: str) -> dict:
    si, sf = 1.0 / (d**0.5), 1.0 / (f**0.5)
    return {
        "router": ParamSpec((d, m.num_experts), ("embed", "expert"), dtype="float32", scale=si),
        "w_gate": ParamSpec(
            (m.num_experts, d, f), ("expert", "embed", "mlp"), dtype=dtype, scale=si
        ),
        "w_up": ParamSpec((m.num_experts, d, f), ("expert", "embed", "mlp"), dtype=dtype, scale=si),
        "w_down": ParamSpec(
            (m.num_experts, f, d), ("expert", "mlp", "embed"), dtype=dtype, scale=sf
        ),
    }


def expert_capacity(m: MoEConfig, group_size: int) -> int:
    c = math.ceil(group_size * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, min(c, group_size))


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, larger first, the lower index first among equals."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return probs.gather(-1, order), order


def moe_ffn(params, x: torch.Tensor, m: MoEConfig, dropless: bool = False):
    """x: [B, S, D] -> (out [B, S, D] in x's dtype, aux_loss float32 scalar).

    aux_loss is the load-balancing loss: E times the mean over groups of
    sum_e (fraction of the group's choices routed to e) x (mean router
    probability of e).
    """
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    g = min(m.group_size, B * S)
    tokens = x.reshape(-1, D)
    n_tok = tokens.shape[0]
    pad = (-n_tok) % g  # pad to a group multiple; padded rows sliced off below
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    ng = tokens.shape[0] // g
    C = expert_capacity(m, g)

    xt = tokens.reshape(ng, g, D)
    logits = xt.to(torch.float32) @ params["router"]  # [ng, g, E]; the router is float32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, K)  # [ng, g, K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # one_hot(top_e, E) as a comparison: F.one_hot reads its indices' range back to the host
    onehot = (top_e[..., None] == torch.arange(E, device=x.device)).to(torch.float32)  # [ng, g, K, E]

    # load-balance auxiliary loss (the same for both dispatch modes)
    frac_tokens = onehot.sum(2).mean(1)  # [ng, E] fraction routed
    frac_prob = probs.mean(1)  # [ng, E]
    aux = E * (frac_tokens * frac_prob).sum(-1).mean()

    if dropless:
        comb_e = torch.einsum("ngk,ngke->nge", top_p, onehot).reshape(-1, E)[:n_tok]
        xs = tokens[:n_tok]
        h = F.silu(torch.matmul(xs, params["w_gate"])) * torch.matmul(xs, params["w_up"])  # [E, T, F]
        out_e = torch.matmul(h, params["w_down"])  # [E, T, D]
        out = torch.einsum("te,etd->td", comb_e.to(x.dtype), out_e)
        return out.reshape(B, S, D), aux

    # the position of each (token, choice) in its expert's queue, in token order
    flat = onehot.reshape(ng, g * K, E)
    pos = torch.cumsum(flat, dim=1) - 1.0  # [ng, g*K, E]
    pos = (pos * flat).reshape(ng, g, K, E).sum(-1)  # [ng, g, K] queue slot
    keep = pos < C
    # one_hot(pos, C): a dropped choice (pos >= C) has no slot
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).to(torch.float32)
    pos_oh = pos_oh * keep[..., None]
    disp = torch.einsum("ngke,ngkc->ngec", onehot, pos_oh)  # {0, 1}
    comb = torch.einsum("ngk,ngke,ngkc->ngec", top_p, onehot, pos_oh)

    expert_in = torch.einsum("ngec,ngd->necd", disp.to(x.dtype), xt.to(x.dtype))  # [ng, E, C, D]
    h = F.silu(torch.einsum("necd,edf->necf", expert_in, params["w_gate"]))
    h = h * torch.einsum("necd,edf->necf", expert_in, params["w_up"])
    expert_out = torch.einsum("necf,efd->necd", h, params["w_down"])  # [ng, E, C, D]
    out = torch.einsum("ngec,necd->ngd", comb.to(x.dtype), expert_out)
    out = out.reshape(-1, D)[:n_tok]
    return out.reshape(B, S, D), aux
