"""Model zoo public API, the ``ssm`` family (``repro/models/model.py``).

Entry points (functional; params is a nested dict of tensors):

    param_specs(cfg)                          -> tree of ParamSpec (no allocation)
    init_params(generator, cfg, device)       -> tree of tensors
    cache_specs(cfg, batch, cache_len)        -> tree of ParamSpec
    prefill(params, batch, cfg, cache_len)    -> (logits_last [B, Vp], cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits [B, Vp], cache)

The JAX package scans one traced layer body over the stacked ``[L, ...]``
parameters (``lax.scan``); here a Python loop walks the same stacked
tensors. Every other family raises: it waits for its slice of the port
(``train_loss`` for the training slice).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import PORTED_FAMILIES, ModelConfig
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.layers import (
    embed,
    embed_specs,
    lm_head,
    lm_head_specs,
    rmsnorm,
    rmsnorm_specs,
)
from repro_torch.models.params import ParamSpec, materialize, stack_layer, tree_map_specs


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not yet ported; the port runs "
            f"{', '.join(sorted(PORTED_FAMILIES))}"
        )


def param_specs(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    d, dt = cfg.d_model, cfg.dtype
    specs: dict[str, Any] = {
        "embed": embed_specs(cfg.vocab_padded, d, dt),
        "final_norm": rmsnorm_specs(d, dt),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = lm_head_specs(d, cfg.vocab_padded, dt)
    layer = {"ln": rmsnorm_specs(d, dt), "mamba": mamba_mod.mamba_specs(cfg, dt)}
    specs["layers"] = tree_map_specs(lambda s: stack_layer(s, cfg.num_layers), layer)
    return specs


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None):
    return materialize(generator, param_specs(cfg), device)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Abstract cache tree: the conv tail and SSD state of every layer
    (``cache_len`` is unread by the ``ssm`` family: its cache has constant size)."""
    _require_ported(cfg)
    L = cfg.num_layers
    sh = mamba_mod.mamba_cache_shapes(cfg, batch)
    return {
        "layers": {
            name: ParamSpec((L, *shape), ("layers", *axes), dtype=dt, init="zeros")
            for name, (shape, dt, axes) in sh.items()
        }
    }


def _layer(stacked: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def _logits(params, x, cfg: ModelConfig):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tokens"].T
    return lm_head(params["lm_head"], x)


def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int, force_reference: bool = False):
    """Process the prompt ``batch["tokens"]`` [B, S]; returns (last-token
    logits [B, Vp], cache). ``force_reference`` runs the scan's plain version."""
    _require_ported(cfg)
    x = embed(params["embed"], batch["tokens"])
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h, c = mamba_mod.mamba_prefill(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
                                       force_reference)  # fmt: skip
        x = x + h
        caches.append(c)
    cache = {"layers": {k: torch.stack([c[k] for c in caches]) for k in caches[0]}}
    return _logits(params, x[:, -1:, :], cfg)[:, 0], cache


def decode_step(params, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig):
    """One token [B, 1] through the stack with caches; ``pos`` is unread by
    the ``ssm`` family (kept for the JAX signature)."""
    _require_ported(cfg)
    x = embed(params["embed"], tokens)
    new = []
    for i in range(cfg.num_layers):
        lp, c = _layer(params["layers"], i), _layer(cache["layers"], i)
        h, c = mamba_mod.mamba_decode(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps), c, cfg)
        x = x + h
        new.append(c)
    cache = dict(cache, layers={k: torch.stack([c[k] for c in new]) for k in new[0]})
    return _logits(params, x, cfg)[:, 0], cache
