"""GQA attention: training and prefill through the flash-attention kernel,
decode caches (``repro/models/attention.py``).

The JAX package's training and prefill attention is a blockwise online
softmax in pure jnp (``_blockwise_attn``), "the same algorithm as
kernels/flash_attention" (its docstring). Here that function is
``kernels/flash_attention`` ``flash_attention`` in the model layout
[B, S, H, Dh], its gradient the oracle's: the hand-written kernel
(``csrc/flash_attention.cu``) on a CUDA tensor, its dense oracle on a CPU
tensor or with ``force_reference``. The kernel's logical blocks divide S
(``prefill_block``); they set only which key blocks a query block skips, and every
legal block gives the same result, so every prompt length reaches the kernel.
JAX's ``attn_chunk`` sets only JAX's summation order and is not read here.

Decode is a softmax over the cache in float32, plain PyTorch, as in the JAX
package (no Pallas kernel on that path). Two cache layouts:
- standard: cache length = cache_len, the new key written at ``pos`` (at
  ``C - 1`` once ``pos >= C``: ``jax.lax.dynamic_update_slice`` clamps its
  start there);
- rolling: cache length = window (SWA) with modular writes.
Keys are stored post-RoPE (rotated at their global position).

Cross-attention (the audio family's decoder against its encoder's output)
has no mask and no RoPE: ``flash_attention(causal=False)`` with each length
at its own block (``prefill_block`` of the queries' and of the keys'), in
prefill and, at one query, in every decode step, as the JAX package runs its
blockwise function in both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.params import ParamSpec
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
BLOCK = 128  # the logical block of a prefill's attention when it divides S


def attn_specs(a: AttentionConfig, d: int, dtype: str) -> dict:
    s = 1.0 / (d**0.5)
    so = 1.0 / ((a.num_heads * a.head_dim) ** 0.5)
    specs = {
        "wq": ParamSpec(
            (d, a.num_heads, a.head_dim), ("embed", "heads", "head_dim"), dtype=dtype, scale=s
        ),
        "wk": ParamSpec(
            (d, a.num_kv_heads, a.head_dim), ("embed", "kv_heads", "head_dim"), dtype=dtype, scale=s
        ),
        "wv": ParamSpec(
            (d, a.num_kv_heads, a.head_dim), ("embed", "kv_heads", "head_dim"), dtype=dtype, scale=s
        ),
        "wo": ParamSpec(
            (a.num_heads, a.head_dim, d), ("heads", "head_dim", "embed"), dtype=dtype, scale=so
        ),
    }
    if a.qkv_bias:
        specs["bq"] = ParamSpec(
            (a.num_heads, a.head_dim), ("heads", "head_dim"), dtype=dtype, init="zeros"
        )
        specs["bk"] = ParamSpec(
            (a.num_kv_heads, a.head_dim), ("kv_heads", "head_dim"), dtype=dtype, init="zeros"
        )
        specs["bv"] = ParamSpec(
            (a.num_kv_heads, a.head_dim), ("kv_heads", "head_dim"), dtype=dtype, init="zeros"
        )
    return specs


def _qkv(params, x: torch.Tensor, a: AttentionConfig, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if a.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return apply_rope(q, positions, a.rope_theta), apply_rope(k, positions, a.rope_theta), v


def prefill_block(S: int) -> int:
    """The logical block of an S-token prefill: ``BLOCK`` when it divides S,
    else the largest divisor of S that divides ``BLOCK``."""
    return math.gcd(S, BLOCK)


def _attend(q, k, v, causal: bool, window: int | None, force_reference: bool) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, window=window, block_q=prefill_block(q.shape[1]),
                           block_k=prefill_block(k.shape[1]), force_reference=force_reference)  # fmt: skip


def _out(params, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


def attention(params, x: torch.Tensor, positions: torch.Tensor, a: AttentionConfig,
              causal: bool = True, force_reference: bool = False) -> torch.Tensor:  # fmt: skip
    """Full-sequence attention (train / prefill). x: [B, S, D]; positions: [S] or [B, S]."""
    q, k, v = _qkv(params, x, a, positions)
    return _out(params, _attend(q, k, v, causal, a.window, force_reference))


def cache_shape(a: AttentionConfig, batch: int, seq_len: int) -> tuple[int, ...]:
    eff = min(seq_len, a.window) if a.window else seq_len
    return (batch, eff, a.num_kv_heads, a.head_dim)


def prefill_attention(params, x: torch.Tensor, positions: torch.Tensor, a: AttentionConfig,
                      cache_len: int, force_reference: bool = False):  # fmt: skip
    """Attention + cache construction. Returns (out [B, S, D], {"k", "v"}
    [B, C, KH, Dh] with C = cache_len, or the window's length for SWA)."""
    S = x.shape[1]
    q, k, v = _qkv(params, x, a, positions)
    out = _attend(q, k, v, True, a.window, force_reference)
    eff = min(cache_len, a.window) if a.window else cache_len
    if a.window and S >= eff:
        # rolling cache: keep the last `eff` keys, laid out so slot i holds
        # the key whose global position == i (mod eff)
        roll = (S - eff) % eff
        ck = torch.roll(k[:, S - eff :], shifts=roll, dims=1)
        cv = torch.roll(v[:, S - eff :], shifts=roll, dims=1)
    else:
        pad = eff - S
        if pad < 0:
            raise ValueError(f"cache_len {eff} < prefill len {S}")
        ck = F.pad(k, (0, 0, 0, 0, 0, pad))
        cv = F.pad(v, (0, 0, 0, 0, 0, pad))
    return _out(params, out), {"k": ck, "v": cv}


def decode_attention(params, x: torch.Tensor, pos: int, cache: dict, a: AttentionConfig):
    """Single-token decode against the cache (standard or rolling). x: [B, 1, D];
    ``pos``: the position of this token; cache {"k", "v"}: [B, C, KH, Dh].

    The new key and value are written into ``cache`` in place, and the returned
    cache holds the same tensors: a caller that needs the cache as it was
    before the step must copy it first.
    """
    B, C = x.shape[0], cache["k"].shape[1]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _qkv(params, x, a, positions)
    slot = pos % C if a.window else min(pos, C - 1)
    ck, cv = cache["k"], cache["v"]
    ck[:, slot] = k_new[:, 0]
    cv[:, slot] = v_new[:, 0]

    KH, Dh = a.num_kv_heads, a.head_dim
    G = a.num_heads // KH
    qg = q.reshape(B, KH, G, Dh).to(torch.float32) / (Dh**0.5)
    s = torch.einsum("bhgd,bchd->bhgc", qg, ck.to(torch.float32))
    idx = torch.arange(C, device=x.device)
    if a.window:
        # slot i holds global position p_i = pos - ((pos - i) mod C); valid if p_i >= 0
        valid = pos - torch.remainder(pos - idx, C) >= 0
    else:
        valid = idx <= pos
    s = torch.where(valid[None, None, None], s, torch.tensor(NEG_INF, device=x.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgc,bchd->bhgd", p, cv.to(torch.float32))
    out = out.reshape(B, 1, a.num_heads, Dh).to(x.dtype)
    return _out(params, out), {"k": ck, "v": cv}


# --- cross-attention (encoder-decoder) --------------------------------------
def cross_attn_specs(a: AttentionConfig, d: int, dtype: str) -> dict:
    return attn_specs(a, d, dtype)


def cross_kv(params, enc_out: torch.Tensor, a: AttentionConfig) -> dict:
    """The encoder output's keys and values [B, Sk, KH, Dh] (no bias, no RoPE)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"])
    return {"k": k, "v": v}


def cross_attention(params, x: torch.Tensor, kv: dict, a: AttentionConfig,
                    force_reference: bool = False) -> torch.Tensor:  # fmt: skip
    """Decoder-side cross-attention, x [B, Sq, D] against kv [B, Sk, KH, Dh]:
    no mask, no RoPE."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if a.qkv_bias:
        q = q + params["bq"]
    return _out(params, _attend(q, kv["k"], kv["v"], False, None, force_reference))
