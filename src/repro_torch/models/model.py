"""Model zoo public API: the ``ssm``, ``gru``, ``hybrid`` and ``dense``
families (``repro/models/model.py``).

Entry points (functional; params is a nested dict of tensors):

    param_specs(cfg)                          -> tree of ParamSpec (no allocation)
    init_params(generator, cfg, device)       -> tree of tensors
    cache_specs(cfg, batch, cache_len)        -> tree of ParamSpec
    prefill(params, batch, cfg, cache_len)    -> (logits_last [B, Vp], cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits [B, Vp], cache)

The JAX package scans one traced layer body over the stacked ``[L, ...]``
parameters (``lax.scan``); here a Python loop walks the same stacked
tensors. ``ssm`` layers are Mamba2 blocks (``models/mamba2.py``, the scan
through ``ssd_scan``); ``gru`` layers (merinda-gru) are the paper's GRU-flow
cell as a sequence mixer, then a SwiGLU MLP, the scan through
``kernels/gru_scan`` ``gru_scan`` in prefill and in decode (one step from the
cached state, dt = 1). ``hybrid`` (zamba2) is a Mamba2 stack with ONE
weight-shared attention + SwiGLU block applied after every ``attn_period``
layers (``_segment_bounds``); ``dense`` layers are attention + SwiGLU. Their
prefill attention runs ``kernels/flash_attention`` (``models/attention.py``),
their decode attention a plain softmax over the KV cache, which ``pos``
indexes (RoPE and the cache write). ``moe``, ``vlm`` and ``audio`` raise: they
wait for their slices of the port (``train_loss`` for the training slice).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import PORTED_FAMILIES, ModelConfig
from repro_torch.core.neural_flow import GRUParams
from repro_torch.kernels.gru_scan.ops import gru_scan
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.layers import (
    embed,
    embed_specs,
    lm_head,
    lm_head_specs,
    mlp,
    mlp_specs,
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


def _decoder_layer_specs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    return {
        "ln1": rmsnorm_specs(d, dt),
        "ln2": rmsnorm_specs(d, dt),
        "attn": attn_mod.attn_specs(cfg.attn, d, dt),
        "mlp": mlp_specs(d, cfg.d_ff, dt),
    }


def _gru_layer_specs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    h = cfg.gru_hidden or d
    s = 1.0 / ((d + h) ** 0.5)
    return {
        "ln1": rmsnorm_specs(d, dt),
        "ln2": rmsnorm_specs(d, dt),
        "gru": {
            "w": ParamSpec((d + h, 3 * h), ("embed", "mlp"), dtype=dt, scale=s),
            "b": ParamSpec((3 * h,), (None,), dtype="float32", init="zeros"),
            "time_scale": ParamSpec((h,), (None,), dtype="float32", init="zeros"),
            "out": ParamSpec((h, d), ("mlp", "embed"), dtype=dt, scale=1.0 / (h**0.5)),
        },
        "mlp": mlp_specs(d, cfg.d_ff, dt),
    }


def param_specs(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    d, dt = cfg.d_model, cfg.dtype
    specs: dict[str, Any] = {
        "embed": embed_specs(cfg.vocab_padded, d, dt),
        "final_norm": rmsnorm_specs(d, dt),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = lm_head_specs(d, cfg.vocab_padded, dt)
    if cfg.family == "gru":
        layer = _gru_layer_specs(cfg)
    elif cfg.family == "dense":
        layer = _decoder_layer_specs(cfg)
    else:
        layer = {"ln": rmsnorm_specs(d, dt), "mamba": mamba_mod.mamba_specs(cfg, dt)}
    specs["layers"] = tree_map_specs(lambda s: stack_layer(s, cfg.num_layers), layer)
    if cfg.family == "hybrid":  # ONE weight-shared transformer block (zamba2)
        specs["shared_attn"] = _decoder_layer_specs(cfg)
    return specs


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None):
    return materialize(generator, param_specs(cfg), device)


def _segment_bounds(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """Hybrid (zamba2) scheduling: [(lo, hi, shared_attn_after), ...]."""
    k = cfg.attn_period
    out = []
    lo = 0
    while lo < cfg.num_layers:
        hi = min(lo + k, cfg.num_layers)
        out.append((lo, hi, hi - lo == k))
        lo = hi
    return out


def shared_applications(cfg: ModelConfig) -> int:
    """How many times a ``hybrid`` model applies its shared block (6 at zamba2-1.2b)."""
    return sum(1 for *_, with_attn in _segment_bounds(cfg) if with_attn)


def _kv_specs(cfg: ModelConfig, n: int, batch: int, cache_len: int) -> dict:
    shape = attn_mod.cache_shape(cfg.attn, batch, cache_len)
    axes = ("layers", "batch", "cache_seq", "kv_heads", None)
    kv = ParamSpec((n, *shape), axes, dtype=cfg.dtype, init="zeros")
    return {"k": kv, "v": kv}


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Abstract cache tree: the conv tail and SSD state of every layer
    (``ssm``, ``hybrid``), its GRU state (``gru``: float32 [L, batch,
    gru_hidden]), its keys and values (``dense``: [L, batch, C, KH, Dh]), and
    the shared block's keys and values of each application (``hybrid``:
    ``shared_attn``, [n_app, batch, C, KH, Dh]); ``cache_len`` sets C."""
    _require_ported(cfg)
    L = cfg.num_layers
    if cfg.family == "gru":
        h = cfg.gru_hidden or cfg.d_model
        state = ParamSpec((L, batch, h), ("layers", "batch", None), dtype="float32", init="zeros")
        return {"layers": {"state": state}}
    if cfg.family == "dense":
        return {"layers": _kv_specs(cfg, L, batch, cache_len)}
    sh = mamba_mod.mamba_cache_shapes(cfg, batch)
    specs = {
        "layers": {
            name: ParamSpec((L, *shape), ("layers", *axes), dtype=dt, init="zeros")
            for name, (shape, dt, axes) in sh.items()
        }
    }
    if cfg.family == "hybrid":
        specs["shared_attn"] = _kv_specs(cfg, shared_applications(cfg), batch, cache_len)
    return specs


def _layer(stacked: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def _logits(params, x, cfg: ModelConfig):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tokens"].T
    return lm_head(params["lm_head"], x)


def _gru_layer(lp: dict, x: torch.Tensor, h0: torch.Tensor, cfg: ModelConfig,
               force_reference: bool):  # fmt: skip
    """One ``gru`` layer over x [B, T, d] from the state h0 [B, h] (float32),
    dt = 1 a step: (x after the mixer and the MLP, the state after the last
    step). The scan computes in float32 on the float32 copy of ``w``."""
    g = lp["gru"]
    gp = GRUParams(w=g["w"].to(torch.float32), b=g["b"], time_scale=g["time_scale"])
    xin = rmsnorm(lp["ln1"], x, cfg.norm_eps).to(torch.float32)
    h_T, hs = gru_scan(gp, xin, h0, flow=True, force_reference=force_reference)
    x = x + hs.to(x.dtype) @ g["out"]
    x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x, h_T


def _attn_block(bp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                cache_len: int, force_reference: bool):  # fmt: skip
    """An attention + SwiGLU block (a ``dense`` layer, the ``hybrid``'s shared
    block) over the prompt: (x after it, its {"k", "v"} cache). The attention
    runs ``flash_attention`` (``force_reference``: its oracle)."""
    h, kv = attn_mod.prefill_attention(bp["attn"], rmsnorm(bp["ln1"], x, cfg.norm_eps), positions,
                                       cfg.attn, cache_len, force_reference)  # fmt: skip
    x = x + h
    return x + mlp(bp["mlp"], rmsnorm(bp["ln2"], x, cfg.norm_eps)), kv


def _attn_block_decode(bp: dict, x: torch.Tensor, pos: int, kv: dict, cfg: ModelConfig):
    """The same block on one token against its cache, written in place."""
    h, _ = attn_mod.decode_attention(bp["attn"], rmsnorm(bp["ln1"], x, cfg.norm_eps), pos, kv,
                                     cfg.attn)  # fmt: skip
    x = x + h
    return x + mlp(bp["mlp"], rmsnorm(bp["ln2"], x, cfg.norm_eps))


def _stack(caches: list[dict]) -> dict:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _mamba_segments(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """The Mamba2 layers in segments, each followed by the shared block or not."""
    return _segment_bounds(cfg) if cfg.family == "hybrid" else [(0, cfg.num_layers, False)]


def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int, force_reference: bool = False):
    """Process the prompt ``batch["tokens"]`` [B, S]; returns (last-token
    logits [B, Vp], cache). ``force_reference`` runs every kernel's plain
    version (the scans, the attention)."""
    _require_ported(cfg)
    x = embed(params["embed"], batch["tokens"])
    if cfg.family == "gru":
        h0 = torch.zeros(x.shape[0], cfg.gru_hidden or cfg.d_model, device=x.device)
        states = []
        for i in range(cfg.num_layers):
            x, h_T = _gru_layer(_layer(params["layers"], i), x, h0, cfg, force_reference)
            states.append(h_T)
        return _logits(params, x[:, -1:, :], cfg)[:, 0], {"layers": {"state": torch.stack(states)}}
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "dense":
        kvs = []
        for i in range(cfg.num_layers):
            x, kv = _attn_block(_layer(params["layers"], i), x, positions, cfg, cache_len,
                                force_reference)  # fmt: skip
            kvs.append(kv)
        return _logits(params, x[:, -1:, :], cfg)[:, 0], {"layers": _stack(kvs)}
    caches, kvs = [], []
    for lo, hi, with_attn in _mamba_segments(cfg):
        for i in range(lo, hi):
            lp = _layer(params["layers"], i)
            h, c = mamba_mod.mamba_prefill(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
                                           force_reference)  # fmt: skip
            x = x + h
            caches.append(c)
        if with_attn:
            x, kv = _attn_block(params["shared_attn"], x, positions, cfg, cache_len,
                                force_reference)  # fmt: skip
            kvs.append(kv)
    cache = {"layers": _stack(caches)}
    if cfg.family == "hybrid":
        cache["shared_attn"] = _stack(kvs)
    return _logits(params, x[:, -1:, :], cfg)[:, 0], cache


def decode_step(params, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                force_reference: bool = False):  # fmt: skip
    """One token [B, 1] at position ``pos`` through the stack with caches. A
    ``gru`` layer takes one step of the scan from its cached state
    (``force_reference``: its plain version); the Mamba2 and attention decode
    steps are plain. ``pos`` sets the attention's RoPE position and cache
    slot (``dense``, ``hybrid``); the ``ssm`` and ``gru`` families do not read
    it. The attention's keys and values are written into ``cache``'s tensors
    in place (``attention.decode_attention``)."""
    _require_ported(cfg)
    x = embed(params["embed"], tokens)
    if cfg.family == "gru":
        states = []
        for i in range(cfg.num_layers):
            h0 = cache["layers"]["state"][i]
            x, h = _gru_layer(_layer(params["layers"], i), x, h0, cfg, force_reference)
            states.append(h)
        return _logits(params, x, cfg)[:, 0], dict(cache, layers={"state": torch.stack(states)})
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x = _attn_block_decode(_layer(params["layers"], i), x, pos,
                                   _layer(cache["layers"], i), cfg)  # fmt: skip
        return _logits(params, x, cfg)[:, 0], cache
    new, app = [], 0
    for lo, hi, with_attn in _mamba_segments(cfg):
        for i in range(lo, hi):
            lp, c = _layer(params["layers"], i), _layer(cache["layers"], i)
            h, c = mamba_mod.mamba_decode(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps), c, cfg)
            x = x + h
            new.append(c)
        if with_attn:
            x = _attn_block_decode(params["shared_attn"], x, pos,
                                   _layer(cache["shared_attn"], app), cfg)  # fmt: skip
            app += 1
    return _logits(params, x, cfg)[:, 0], dict(cache, layers=_stack(new))
