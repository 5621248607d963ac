"""Model zoo public API: every family of the JAX package's zoo, ``dense``,
``moe``, ``vlm``, ``ssm``, ``hybrid``, ``audio`` and ``gru``
(``repro/models/model.py``).

Entry points (functional; params is a nested dict of tensors):

    param_specs(cfg)                          -> tree of ParamSpec (no allocation)
    init_params(generator, cfg, device)       -> tree of tensors
    train_loss(params, batch, cfg)            -> (loss, metrics)
    cache_specs(cfg, batch, cache_len)        -> tree of ParamSpec
    prefill(params, batch, cfg, cache_len)    -> (logits_last [B, Vp], cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits [B, Vp], cache)
    input_specs(cfg, shape)                   -> dict of ParamSpec (a step's inputs)

The JAX package scans one traced layer body over the stacked ``[L, ...]``
parameters (``lax.scan``); here a Python loop walks the same stacked
tensors. ``ssm`` layers are Mamba2 blocks (``models/mamba2.py``, the scan
through ``ssd_scan``); ``gru`` layers (merinda-gru) are the paper's GRU-flow
cell as a sequence mixer, then a SwiGLU MLP, the scan through
``kernels/gru_scan`` ``gru_scan`` in training, in prefill and in decode (one
step from the cached state, dt = 1). ``hybrid`` (zamba2) is a Mamba2 stack
with ONE weight-shared attention + SwiGLU block applied after every
``attn_period`` layers (``_segment_bounds``). ``dense``, ``moe`` and ``vlm``
layers are attention + an FFN: SwiGLU, or for ``moe`` the mixture of experts
(``models/moe.py``: the dropless form in inference, as the JAX package
serves it, the capacity dispatch and its load-balancing loss in training);
``vlm`` prepends ``batch["patches"]`` [B, num_patches, d_model] to the token
embeddings. ``audio`` (seamless-m4t) is an encoder-decoder:
``batch["frames"]`` [B, ``AUDIO_SRC_LEN``, ``AUDIO_FEAT``] through a linear
frontend and a non-causal encoder stack, then decoder layers of causal
self-attention, cross-attention to the encoder output and SwiGLU; its cache
holds each decoder layer's cross keys and values too. Every full-sequence
attention, self or cross, in training and in prefill, runs
``kernels/flash_attention`` (``models/attention.py``; the JAX package's
training and prefill attention is its blockwise jnp loop), and so does every
decode step's cross-attention; decode self-attention is a plain softmax over
the KV cache, which ``pos`` indexes (RoPE and the cache write).

Training (``train_loss``: teacher-forced cross-entropy, plus 0.01 times the
MoE layers' summed load-balancing loss) walks each stack under
``cfg.remat``, as the JAX package's ``_scan_stack``: ``"full"``
checkpoints each layer step (its forward runs again in the backward, so a
layer's kernel is launched twice a step), ``"dots"`` keeps the products of
two matrices (``aten.mm``) and recomputes the rest, ``"none"`` keeps every
activation. The hybrid's shared block runs outside the checkpoint, as in
the JAX package. Each kernel's gradient is its plain version's
(``kernels/runtime.reference_vjp``), as the JAX package differentiates its
references.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.neural_flow import GRUParams
from repro_torch.kernels.gru_scan.ops import gru_scan
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    cross_entropy,
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

AUDIO_SRC_LEN = 4096  # encoder frame count for the audio enc-dec family
AUDIO_FEAT = 80  # fbank feature dim supplied by the (stub) frontend
ATTN_FAMILIES = ("dense", "moe", "vlm")  # attention + FFN decoder layers
FAMILIES = (*ATTN_FAMILIES, "ssm", "hybrid", "audio", "gru")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def _decoder_layer_specs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    specs = {
        "ln1": rmsnorm_specs(d, dt),
        "ln2": rmsnorm_specs(d, dt),
        "attn": attn_mod.attn_specs(cfg.attn, d, dt),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_mod.moe_specs(cfg.moe, d, cfg.d_ff, dt)
    else:
        specs["mlp"] = mlp_specs(d, cfg.d_ff, dt)
    return specs


def _audio_specs(cfg: ModelConfig) -> dict:
    """The frontend, the encoder stack and its norm, and the decoder layers
    (self-attention, cross-attention, SwiGLU under ln1, ln2, ln3)."""
    d, dt = cfg.d_model, cfg.dtype
    stack = lambda layer, n: tree_map_specs(lambda s: stack_layer(s, n), layer)
    enc_layer = {
        "ln1": rmsnorm_specs(d, dt),
        "ln2": rmsnorm_specs(d, dt),
        "attn": attn_mod.attn_specs(cfg.attn, d, dt),
        "mlp": mlp_specs(d, cfg.d_ff, dt),
    }
    dec_layer = dict(enc_layer, ln3=rmsnorm_specs(d, dt),
                     cross=attn_mod.cross_attn_specs(cfg.attn, d, dt))  # fmt: skip
    w = ParamSpec((AUDIO_FEAT, d), ("frontend", "embed"), dtype=dt, scale=AUDIO_FEAT**-0.5)
    return {
        "frontend": {"w": w},
        "enc_layers": stack(enc_layer, cfg.encoder_layers),
        "enc_norm": rmsnorm_specs(d, dt),
        "layers": stack(dec_layer, cfg.num_layers),
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
    _check_family(cfg)
    d, dt = cfg.d_model, cfg.dtype
    specs: dict[str, Any] = {
        "embed": embed_specs(cfg.vocab_padded, d, dt),
        "final_norm": rmsnorm_specs(d, dt),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = lm_head_specs(d, cfg.vocab_padded, dt)
    if cfg.family == "audio":
        return dict(specs, **_audio_specs(cfg))
    if cfg.family == "gru":
        layer = _gru_layer_specs(cfg)
    elif cfg.family in ATTN_FAMILIES:
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
    gru_hidden]), its keys and values (``dense``, ``moe``, ``vlm``, ``audio``:
    [L, batch, C, KH, Dh]; C = the window under SWA), the shared block's keys
    and values of each application (``hybrid``: ``shared_attn``, [n_app,
    batch, C, KH, Dh]), and the encoder output's cross keys and values
    (``audio``: ``cross_k``, ``cross_v``, [L, batch, AUDIO_SRC_LEN, KH, Dh]);
    ``cache_len`` sets C."""
    _check_family(cfg)
    L = cfg.num_layers
    if cfg.family == "gru":
        h = cfg.gru_hidden or cfg.d_model
        state = ParamSpec((L, batch, h), ("layers", "batch", None), dtype="float32", init="zeros")
        return {"layers": {"state": state}}
    if cfg.family in ATTN_FAMILIES:
        return {"layers": _kv_specs(cfg, L, batch, cache_len)}
    if cfg.family == "audio":
        a = cfg.attn
        shape = (L, batch, AUDIO_SRC_LEN, a.num_kv_heads, a.head_dim)
        axes = ("layers", "batch", "cache_seq", "kv_heads", None)
        ckv = ParamSpec(shape, axes, dtype=cfg.dtype, init="zeros")
        return {"layers": dict(_kv_specs(cfg, L, batch, cache_len), cross_k=ckv, cross_v=ckv)}
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


def _ffn(bp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A block's FFN under ``ln2``: SwiGLU, or the dropless MoE (``moe``: every
    token routed as a decode step routes it, ``moe.moe_ffn``)."""
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        return moe_mod.moe_ffn(bp["moe"], h, cfg.moe, dropless=True)[0]
    return mlp(bp["mlp"], h)


def _attn_block(bp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                cache_len: int, force_reference: bool):  # fmt: skip
    """An attention + FFN block (a ``dense``, ``moe`` or ``vlm`` layer, the
    ``hybrid``'s shared block) over the prompt: (x after it, its {"k", "v"}
    cache). The attention runs ``flash_attention`` (``force_reference``: its
    oracle)."""
    h, kv = attn_mod.prefill_attention(bp["attn"], rmsnorm(bp["ln1"], x, cfg.norm_eps), positions,
                                       cfg.attn, cache_len, force_reference)  # fmt: skip
    x = x + h
    return x + _ffn(bp, x, cfg), kv


def _attn_block_decode(bp: dict, x: torch.Tensor, pos: int, kv: dict, cfg: ModelConfig):
    """The same block on one token against its cache, written in place."""
    h, _ = attn_mod.decode_attention(bp["attn"], rmsnorm(bp["ln1"], x, cfg.norm_eps), pos, kv,
                                     cfg.attn)  # fmt: skip
    x = x + h
    return x + _ffn(bp, x, cfg)


def _encode_audio(params, frames: torch.Tensor, cfg: ModelConfig, force_reference: bool,
                  train: bool = False):  # fmt: skip
    """frames [B, Sk, AUDIO_FEAT] -> the encoder output [B, Sk, d_model]: the
    frontend's projection, then non-causal attention + SwiGLU layers (each
    under ``cfg.remat`` when ``train``) and ``enc_norm``."""
    x = frames.to(params["frontend"]["w"].dtype) @ params["frontend"]["w"]
    positions = torch.arange(frames.shape[1], device=x.device)

    def body(lp, x):
        x = x + attn_mod.attention(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
                                   cfg.attn, causal=False, force_reference=force_reference)  # fmt: skip
        return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps)), None

    x, _ = _scan_stack(_unstack(params["enc_layers"]), x, body, cfg, train)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_block(lp: dict, x: torch.Tensor, ckv: dict, cfg: ModelConfig, force_reference: bool):
    """An ``audio`` decoder layer's cross-attention (under ``ln2``) and SwiGLU
    (under ``ln3``), after its self-attention."""
    x = x + attn_mod.cross_attention(lp["cross"], rmsnorm(lp["ln2"], x, cfg.norm_eps), ckv,
                                     cfg.attn, force_reference)  # fmt: skip
    return x + mlp(lp["mlp"], rmsnorm(lp["ln3"], x, cfg.norm_eps))


def _assemble_inputs(params, batch: dict, cfg: ModelConfig):
    """The family's input embedding: (x [B, S, D], positions [S]); ``vlm``
    prepends ``batch["patches"]``."""
    x = embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def _stack(caches: list[dict]) -> dict:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _mamba_segments(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """The Mamba2 layers in segments, each followed by the shared block or not."""
    return _segment_bounds(cfg) if cfg.family == "hybrid" else [(0, cfg.num_layers, False)]


_DOTS = (torch.ops.aten.mm.default,)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy (JAX's ``checkpoint_dots_with_no_batch_dims``):
    keep every product of two matrices, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: ``"full"`` recomputes its forward in the
    backward, ``"dots"`` keeps its matrix products, ``"none"`` keeps it all."""
    if cfg.remat == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)  # the layers draw no random numbers
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}: full | dots | none")
    return lambda *args: checkpoint(fn, *args, **kw)


def _unstack(stacked: dict) -> list[dict]:
    """Each layer's parameters of a stacked tree, every leaf unbound once.

    Under autograd one ``unbind`` a leaf has one backward, a ``stack`` of the
    layers' gradients; indexing the leaf a layer (``_layer``) would give every
    layer's backward a zero-filled copy of the whole leaf (38 copies of
    zamba2's 0.64 GB bf16 ``wx`` a step)."""
    parts = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0) for k, v in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _scan_stack(layers: list[dict], x: torch.Tensor, body, cfg: ModelConfig, remat: bool = True):
    """Run x through each layer's parameters, ``body(lp, x) -> (x, aux)`` a
    layer step (aux None where the layer has none), under ``cfg.remat``
    (``remat=False``: as it is); returns (x, the auxes' sum or None)."""
    step = _remat(body, cfg) if remat else body
    total = None
    for lp in layers:
        x, aux = step(lp, x)
        if aux is not None:
            total = aux if total is None else total + aux
    return x, total


def _dense_layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                     force_reference: bool):  # fmt: skip
    """An attention + FFN layer over the whole sequence (the ``hybrid``'s shared
    block too): (x after it, the MoE load-balancing loss or None). The attention
    runs ``flash_attention`` (``force_reference``: its oracle); the ``moe``
    FFN is the capacity dispatch (``dropless=False``), as the JAX package
    trains it."""
    x = x + attn_mod.attention(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
                               cfg.attn, force_reference=force_reference)  # fmt: skip
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        h, aux = moe_mod.moe_ffn(lp["moe"], h, cfg.moe, dropless=False)
        return x + h, aux
    return x + mlp(lp["mlp"], h), None


def _ssm_layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig, force_reference: bool):
    h = mamba_mod.mamba_forward(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
                                force_reference)  # fmt: skip
    return x + h


def _gru_layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig, force_reference: bool):
    """A ``gru`` layer from h0 = 0: its scan through ``gru_scan`` (the JAX
    package calls ``gru_scan_ref`` here; the port's counterpart is the op)."""
    h0 = torch.zeros(x.shape[0], cfg.gru_hidden or cfg.d_model, device=x.device)
    return _gru_layer(lp, x, h0, cfg, force_reference)[0]


def _backbone(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
              force_reference: bool):  # fmt: skip
    """Token (and patch) embeddings -> the final hidden states: (x, moe_aux or
    None)."""
    layers = _unstack(params["layers"])
    if cfg.family in ATTN_FAMILIES:
        body = lambda lp, x: _dense_layer_fwd(lp, x, positions, cfg, force_reference)
        return _scan_stack(layers, x, body, cfg)
    if cfg.family == "gru":
        body = lambda lp, x: (_gru_layer_fwd(lp, x, cfg, force_reference), None)
        return _scan_stack(layers, x, body, cfg)
    body = lambda lp, x: (_ssm_layer_fwd(lp, x, cfg, force_reference), None)
    for lo, hi, with_attn in _mamba_segments(cfg):
        x, _ = _scan_stack(layers[lo:hi], x, body, cfg)
        if with_attn:  # the shared block runs outside the checkpoint, as in the JAX package
            x, _ = _dense_layer_fwd(params["shared_attn"], x, positions, cfg, force_reference)
    return x, None


def _decoder_audio(params, x: torch.Tensor, enc_out: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, force_reference: bool) -> torch.Tensor:  # fmt: skip
    """The ``audio`` decoder stack over the whole sequence: each layer's
    self-attention, cross-attention to ``enc_out`` and SwiGLU under one
    checkpoint."""

    def body(lp, x):
        x = x + attn_mod.attention(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
                                   cfg.attn, force_reference=force_reference)  # fmt: skip
        ckv = attn_mod.cross_kv(lp["cross"], enc_out, cfg.attn)
        return _cross_block(lp, x, ckv, cfg, force_reference), None

    return _scan_stack(_unstack(params["layers"]), x, body, cfg)[0]


def train_loss(params, batch: dict, cfg: ModelConfig, force_reference: bool = False):
    """Teacher-forced CE (+ 0.01 x the MoE load-balancing loss). ``batch``:
    ``tokens`` and ``labels`` [B, S] (-1: no label), ``patches`` (``vlm``,
    whose positions get label -1) or ``frames`` (``audio``). Returns (loss,
    {"ce", "moe_aux"}), float32 scalars. ``force_reference`` runs every
    kernel's plain version."""
    _check_family(cfg)
    x, positions = _assemble_inputs(params, batch, cfg)
    if cfg.family == "audio":
        enc_out = _encode_audio(params, batch["frames"], cfg, force_reference, train=True)
        x, moe_aux = _decoder_audio(params, x, enc_out, positions, cfg, force_reference), None
    else:
        x, moe_aux = _backbone(params, x, positions, cfg, force_reference)
    if moe_aux is None:
        moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    logits = _logits(params, x, cfg)
    labels = batch["labels"]
    if cfg.family == "vlm":  # patch positions carry no labels
        pad = torch.full((labels.shape[0], cfg.num_patches), -1, dtype=labels.dtype,
                         device=labels.device)  # fmt: skip
        labels = torch.cat([pad, labels], dim=1)
    ce = cross_entropy(logits, labels, cfg.vocab_size, chunk=cfg.logit_chunk)
    return ce + 0.01 * moe_aux, {"ce": ce, "moe_aux": moe_aux}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Shape stand-ins (ParamSpec) for every input of a step of ``shape.mode``."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda b, s: ParamSpec((b, s), ("batch", "seq"), dtype="int32", init="zeros")
    if shape.mode == "decode":
        return {"tokens": tok(B, 1), "pos": ParamSpec((), (), dtype="int32", init="zeros"),
                "cache": cache_specs(cfg, B, S)}  # fmt: skip
    labels = shape.mode == "train"
    text = S - cfg.num_patches if cfg.family == "vlm" else S
    specs = {"tokens": tok(B, text)}
    if labels:
        specs["labels"] = tok(B, text)
    if cfg.family == "vlm":
        specs["patches"] = ParamSpec((B, cfg.num_patches, cfg.d_model),
                                     ("batch", None, "act_embed"), dtype=cfg.dtype)  # fmt: skip
    elif cfg.family == "audio":
        specs["frames"] = ParamSpec((B, AUDIO_SRC_LEN, AUDIO_FEAT), ("batch", None, None),
                                    dtype="float32")  # fmt: skip
    return specs


def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int, force_reference: bool = False):
    """Process the prompt ``batch["tokens"]`` [B, S] (``vlm``: after
    ``batch["patches"]``; ``audio``: against ``batch["frames"]``); returns
    (last-token logits [B, Vp], cache). ``force_reference`` runs every
    kernel's plain version (the scans, the attention)."""
    _check_family(cfg)
    x, positions = _assemble_inputs(params, batch, cfg)
    if cfg.family == "gru":
        h0 = torch.zeros(x.shape[0], cfg.gru_hidden or cfg.d_model, device=x.device)
        states = []
        for i in range(cfg.num_layers):
            x, h_T = _gru_layer(_layer(params["layers"], i), x, h0, cfg, force_reference)
            states.append(h_T)
        return _logits(params, x[:, -1:, :], cfg)[:, 0], {"layers": {"state": torch.stack(states)}}
    if cfg.family in ATTN_FAMILIES:
        kvs = []
        for i in range(cfg.num_layers):
            x, kv = _attn_block(_layer(params["layers"], i), x, positions, cfg, cache_len,
                                force_reference)  # fmt: skip
            kvs.append(kv)
        return _logits(params, x[:, -1:, :], cfg)[:, 0], {"layers": _stack(kvs)}
    if cfg.family == "audio":
        enc_out = _encode_audio(params, batch["frames"], cfg, force_reference)
        kvs = []
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h, kv = attn_mod.prefill_attention(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                                               positions, cfg.attn, cache_len, force_reference)  # fmt: skip
            ckv = attn_mod.cross_kv(lp["cross"], enc_out, cfg.attn)
            x = _cross_block(lp, x + h, ckv, cfg, force_reference)
            kvs.append(dict(kv, cross_k=ckv["k"], cross_v=ckv["v"]))
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
    (``force_reference``: its plain version), an ``audio`` layer's
    cross-attention one query through ``flash_attention`` (the same); the
    Mamba2 and self-attention decode steps are plain. ``pos`` sets the
    attention's RoPE position and cache slot (every family with attention);
    the ``ssm`` and ``gru`` families do not read it. The attention's keys and
    values are written into ``cache``'s tensors in place
    (``attention.decode_attention``)."""
    _check_family(cfg)
    x = embed(params["embed"], tokens)
    if cfg.family == "gru":
        states = []
        for i in range(cfg.num_layers):
            h0 = cache["layers"]["state"][i]
            x, h = _gru_layer(_layer(params["layers"], i), x, h0, cfg, force_reference)
            states.append(h)
        return _logits(params, x, cfg)[:, 0], dict(cache, layers={"state": torch.stack(states)})
    if cfg.family in ATTN_FAMILIES:
        for i in range(cfg.num_layers):
            x = _attn_block_decode(_layer(params["layers"], i), x, pos,
                                   _layer(cache["layers"], i), cfg)  # fmt: skip
        return _logits(params, x, cfg)[:, 0], cache
    if cfg.family == "audio":
        for i in range(cfg.num_layers):
            lp, c = _layer(params["layers"], i), _layer(cache["layers"], i)
            h, _ = attn_mod.decode_attention(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), pos,
                                             {"k": c["k"], "v": c["v"]}, cfg.attn)  # fmt: skip
            x = _cross_block(lp, x + h, {"k": c["cross_k"], "v": c["cross_v"]}, cfg,
                             force_reference)  # fmt: skip
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
