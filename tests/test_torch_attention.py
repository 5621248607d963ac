"""repro_torch's RoPE and GQA attention against the JAX package's (``repro/models/{rope,attention}.py``).

The port's prefill attention is ``kernels/flash_attention`` ``flash_attention``
(its dense oracle on the CPU); JAX's is its blockwise online softmax over
``attn_chunk`` keys in pure jnp. Decode is a float32 softmax over the cache
in both. Parameters and inputs are drawn with numpy from a seed and cross as
numpy arrays (bf16 through float32, which holds them exactly).

Tolerances: float32 within 1e-4; bf16 within 0.12 (``tests/test_models.py:99``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.models import attention as jattention
from repro.models.rope import apply_rope as japply_rope
from repro_torch.configs.base import AttentionConfig
from repro_torch.models import attention
from repro_torch.models.rope import apply_rope

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.12, rtol=0.12)
DTYPES = [("float32", F32_TOL), ("bfloat16", BF16_TOL)]
D = 64  # model width of every case
# JAX's functions compiled once a shape (the configs and lengths static)
j_attention = jax.jit(jattention.attention, static_argnames=("a", "causal", "chunk"))
j_prefill = jax.jit(jattention.prefill_attention, static_argnames=("a", "cache_len", "chunk"))
j_decode = jax.jit(jattention.decode_attention, static_argnames=("a",))

# (label, AttentionConfig kwargs): GQA with the QKV bias (qwen's layout), MHA
# (zamba2's shared block), a sliding window
CASES = {
    "gqa_bias": dict(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True),
    "mha": dict(num_heads=4, num_kv_heads=4, head_dim=16),
    "window": dict(num_heads=4, num_kv_heads=2, head_dim=16, window=8),
}


def _rounded(a: np.ndarray, dtype: str) -> tuple[torch.Tensor, jnp.ndarray]:
    """``a`` in ``dtype`` for both frameworks, the same values in each."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))


def _params(case: str, dtype: str, seed: int = 0):
    """(port cfg, JAX cfg, port params, JAX params); the biases non-zero."""
    kw = CASES[case]
    a, ja = AttentionConfig(**kw), JAttentionConfig(**kw)
    rng = np.random.default_rng(seed)
    params, jparams = {}, {}
    for name, spec in attention.attn_specs(a, D, dtype).items():
        scale = spec.scale if spec.init == "normal" else 0.5
        params[name], jparams[name] = _rounded(
            (rng.standard_normal(spec.shape) * scale).astype(np.float32), dtype
        )
    return a, ja, params, jparams


def _x(B, S, dtype, seed):
    return _rounded(np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32), dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def test_specs_match_jax():
    """Shapes, axes, dtypes, init and scale of every attention parameter."""
    for case, kw in CASES.items():
        ours = attention.attn_specs(AttentionConfig(**kw), D, "bfloat16")
        theirs = jattention.attn_specs(JAttentionConfig(**kw), D, "bfloat16")
        assert sorted(ours) == sorted(theirs), case
        for name, s in ours.items():
            t = theirs[name]
            assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale)
        assert attention.cache_shape(AttentionConfig(**kw), 3, 20) == jattention.cache_shape(
            JAttentionConfig(**kw), 3, 20
        )


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("batched", [False, True], ids=["positions[S]", "positions[B,S]"])
def test_rope_matches_jax(dtype, tol, batched):
    """float32 angles, the rotate-half convention, one cast back to x's dtype;
    positions up to 1,100 (the served prompts' length and past it)."""
    rng = np.random.default_rng(3)
    x, jx = _rounded(rng.standard_normal((2, 6, 3, 16)).astype(np.float32), dtype)
    pos = rng.integers(0, 1100, size=(2, 6) if batched else (6,))
    for theta in (1e6, 1e4):
        got = apply_rope(x, torch.from_numpy(pos), theta)
        want = japply_rope(jx, jnp.asarray(pos), theta)
        assert got.dtype == x.dtype
        _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_attention_matches_jax(case, dtype, tol):
    """Full-sequence attention, causal and not, at S = 40 against JAX's chunk
    of 32 (S not a multiple of ``attn_chunk``: JAX pads its last chunk)."""
    a, ja, params, jparams = _params(case, dtype, seed=1)
    x, jx = _x(2, 40, dtype, seed=2)
    pos = np.arange(40)
    for causal in (True, False):
        got = attention.attention(params, x, torch.from_numpy(pos), a, causal=causal)
        want = j_attention(jparams, jx, jnp.asarray(pos), a=ja, causal=causal, chunk=32)
        assert got.shape == (2, 40, D) and got.dtype == x.dtype
        _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case,S,cache_len", [("gqa_bias", 40, 48), ("mha", 100, 104),
                                              ("window", 12, 20), ("window", 6, 20)])  # fmt: skip
def test_prefill_then_decode_matches_jax(case, S, cache_len, dtype, tol):
    """prefill_attention's output and cache, then decode steps, each from its own
    framework's cache: the standard cache (S = 100: the block is 4, JAX's chunk
    32), the rolling window cache (S >= window: the last 8 keys rolled; S <
    window: padded) and its modular writes."""
    a, ja, params, jparams = _params(case, dtype, seed=4)
    x, jx = _x(2, S, dtype, seed=5)
    pos = np.arange(S)
    out, cache = attention.prefill_attention(params, x, torch.from_numpy(pos), a, cache_len)
    jout, jcache = j_prefill(jparams, jx, jnp.asarray(pos), a=ja, cache_len=cache_len, chunk=32)
    _close(out, jout, tol)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name], tol)
    for t in range(S, S + 6):
        xt, jxt = _x(2, 1, dtype, seed=10 + t)
        out, cache = attention.decode_attention(params, xt, t, cache, a)
        jout, jcache = j_decode(jparams, jxt, jnp.asarray(t), jcache, a=ja)
        _close(out, jout, tol)
        for name in ("k", "v"):
            _close(cache[name], jcache[name], tol)


def test_decode_clamps_its_write_past_the_cache():
    """At pos >= C JAX's ``dynamic_update_slice`` clamps the write to slot C - 1
    and every slot is valid: the port does the same (and writes in place)."""
    a, ja, params, jparams = _params("gqa_bias", "float32", seed=6)
    x, jx = _x(2, 8, "float32", seed=7)
    pos = np.arange(8)
    _, cache = attention.prefill_attention(params, x, torch.from_numpy(pos), a, 8)
    _, jcache = j_prefill(jparams, jx, jnp.asarray(pos), a=ja, cache_len=8, chunk=32)
    for t in (8, 11):
        xt, jxt = _x(2, 1, "float32", seed=20 + t)
        k_before = cache["k"].clone()
        k_tensor = cache["k"]
        out, cache = attention.decode_attention(params, xt, t, cache, a)
        jout, jcache = j_decode(jparams, jxt, jnp.asarray(t), jcache, a=ja)
        _close(out, jout, F32_TOL)
        _close(cache["k"], jcache["k"], F32_TOL)
        _close(cache["v"], jcache["v"], F32_TOL)
        assert cache["k"] is k_tensor  # in place
        assert torch.equal(cache["k"][:, :7], k_before[:, :7])
        assert not torch.equal(cache["k"][:, 7], k_before[:, 7])


def test_prefill_block_divides_the_prompt_and_a_long_prompt_raises():
    """The flash op's logical block divides S (128 where it does, else the
    gcd), so every prompt length reaches it; a prompt longer than the cache
    raises, as JAX asserts."""
    for S in (1, 7, 40, 64, 100, 128, 1000, 1024, 1025, 4096):
        b = attention.prefill_block(S)
        assert S % b == 0 and 128 % b == 0 and (b == 128) == (S % 128 == 0)
    assert attention.prefill_block(1000) == 8
    a, _, params, _ = _params("mha", "float32")
    x, _ = _x(1, 12, "float32", seed=8)
    with pytest.raises(ValueError, match="cache_len 8 < prefill len 12"):
        attention.prefill_attention(params, x, torch.arange(12), a, 8)
