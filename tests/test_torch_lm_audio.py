"""repro_torch's encoder-decoder (seamless-m4t-medium: 80-d fbank frames
through a linear frontend and a non-causal encoder; decoder layers of causal
self-attention, cross-attention to the encoder output and SwiGLU) against
the JAX package's.

The JAX package builds the parameters (``init_params``) and they cross to the
port through ``repro_torch.convert.lm_params_from_numpy`` (bf16 leaves as
float32, which holds them exactly); tokens and frames [B, 4,096, 80] are
numpy draws from a seed. A prefill takes ``{"tokens", "frames"}``; its cache
holds each decoder layer's self keys and values and the encoder output's
cross keys and values [L, B, 4,096, KH, Dh], which decode reads and never
writes. On the CPU every attention of the port takes the flash op's dense
oracle ([B, H, 4,096, 4,096] float32 scores at the encoder: these tests keep
B at 1-2); JAX's runs its blockwise attention over ``attn_chunk`` keys. JAX's
calls are compiled once a shape (``jax.jit``).

Tolerances: float32 (``dataclasses.replace(cfg, dtype="float32")``) within
1e-4 relative; bf16 within 0.12 (``tests/test_models.py:99``). On the card
every encoder layer, decoder self-attention and cross-attention of a prefill
launches ``flash_attention_cuda``, and every cross-attention of a decode
step, at one query (``tests/test_torch_cuda.py``); here that dispatch is held
with a plain function in the kernel's place.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, count_params

ARCH = "seamless-m4t-medium"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.12, rtol=0.12)
DTYPES = [("float32", F32_TOL), ("bfloat16", BF16_TOL)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _fields(cfg) -> dict:
    plain = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return {f.name: plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


@functools.lru_cache(maxsize=None)
def _jax_fns(dtype: str, cache_len: int):
    """JAX's SMOKE config in ``dtype`` and its jitted prefill and decode step."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    prefill = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, cache_len=cache_len))
    decode = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, jcfg))
    return jcfg, prefill, decode


def _models(dtype: str, seed: int = 0):
    """(port cfg, JAX params, port params) of the SMOKE model in ``dtype``."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jparams = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), jcfg))
    return cfg, jparams, lm_params_from_numpy(jparams)


def _batch(cfg, B, S, seed):
    """Tokens [B, S] and float32 frames [B, AUDIO_SRC_LEN, AUDIO_FEAT] from a
    seed: the port's batch and JAX's."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = rng.standard_normal((B, M.AUDIO_SRC_LEN, M.AUDIO_FEAT)).astype(np.float32)
    ours = {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(frames)}
    return ours, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def _close_tree(got: dict, want: dict, tol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        _close(leaf, want[path], tol)


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
def test_config_and_specs_match_jax(smoke):
    """The config's fields (``encoder_layers``), every parameter's shape,
    dtype, init, scale and axes (frontend, encoder stack, ``enc_norm``, the
    decoder's ``ln3`` and ``cross``), the cache's (``cross_k``, ``cross_v`` [L,
    B, 4,096, KH, Dh]) and the parameter count, as in the JAX package, and
    the frontend's sizes as JAX's ``AUDIO_SRC_LEN`` and ``AUDIO_FEAT``."""
    cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    assert cfg.family == "audio" and cfg.encoder_layers == cfg.num_layers
    assert (M.AUDIO_SRC_LEN, M.AUDIO_FEAT) == (JM.AUDIO_SRC_LEN, JM.AUDIO_FEAT) == (4096, 80)
    assert _fields(cfg) == {k: v for k, v in _fields(jcfg).items() if k in _fields(cfg)}
    ours, theirs = _flat(M.param_specs(cfg)), _flat(JM.param_specs(jcfg))
    assert sorted(ours) == sorted(theirs)
    assert "/frontend/w" in ours and "/layers/cross/wq" in ours and "/enc_layers/attn/wq" in ours
    for path, s in ours.items():
        t = theirs[path]
        assert isinstance(s, ParamSpec)
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale), path
    assert count_params(cfg) == jcfg.n_params()
    cache = _flat(M.cache_specs(cfg, 2, 260))
    jcache = _flat(JM.cache_specs(jcfg, 2, 260))
    assert {k: (v.shape, v.axes, v.dtype) for k, v in cache.items()} == {
        k: (v.shape, v.axes, v.dtype) for k, v in jcache.items()
    }
    a = cfg.attn
    assert cache["/layers/cross_k"].shape == (cfg.num_layers, 2, 4096, a.num_kv_heads, a.head_dim)
    if not smoke:
        assert count_params(cfg) == 977_942_528


@pytest.mark.parametrize("dtype,tol,B", [(*DTYPES[0], 2), (*DTYPES[1], 1)])
def test_prefill_and_decode_match_jax(dtype, tol, B):
    """seamless-m4t SMOKE: 4,096 frames and 24 tokens through prefill
    (last-token logits; every layer's self and cross keys and values), then 3
    decode steps in each framework from its own cache."""
    cfg, jparams, params = _models(dtype, seed=2)
    _, jprefill, jdecode = _jax_fns(dtype, 32)
    batch, jbatch = _batch(cfg, B, 24, seed=3)
    logits, cache = M.prefill(params, batch, cfg, cache_len=32)
    jlogits, jcache = jprefill(jparams, jbatch)
    assert logits.shape == (B, cfg.vocab_padded) and str(logits.dtype).endswith(dtype)
    _close(logits, jlogits, tol)
    _close_tree(cache, jcache, tol)
    cross = cache["layers"]["cross_k"].clone()
    rng = np.random.default_rng(4)
    for t in range(3):
        nxt = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        logits, cache = M.decode_step(params, cache, torch.from_numpy(nxt).long(), 24 + t, cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(24 + t))
        _close(logits, jlogits, tol)
        _close_tree(cache, jcache, tol)
    assert torch.equal(cache["layers"]["cross_k"], cross)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_teacher_forcing_prefill_decode_parity(dtype, tol):
    """prefill(frames, prompt) + decode steps == prefills of the longer prompts
    against the same frames (``tests/test_models.py:71``), in the port alone:
    the self-attention cache and the cached cross keys and values at once."""
    cfg, _, params = _models(dtype, seed=0)
    S_p, N_dec = 12, 4
    batch, _ = _batch(cfg, 1, S_p + N_dec, seed=7)
    toks, CL = batch["tokens"], S_p + N_dec
    ref = [M.prefill(params, dict(batch, tokens=toks[:, :t]), cfg, CL)[0] for t in range(S_p, S_p + N_dec)]
    lg, cache = M.prefill(params, dict(batch, tokens=toks[:, :S_p]), cfg, CL)
    got = [lg]
    for t in range(S_p, S_p + N_dec - 1):
        lg, cache = M.decode_step(params, cache, toks[:, t : t + 1], t, cfg)
        got.append(lg)
    for a, b in zip(got, ref):
        _close(a, b.float().numpy(), tol)


def test_serve_refuses_audio():
    """The serve loop feeds a prefill only the prompt's tokens, as the JAX
    launcher does (its prefill would read ``batch["frames"]``): it refuses
    seamless-m4t and says why."""
    with pytest.raises(ValueError, match=r"needs batch\['frames'\] beside the tokens"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--slots", "2"])


def test_launches_flash_attention_at_every_attention(monkeypatch):
    """With the dispatch sent to the kernel and a plain function in its place:
    a prefill makes ``encoder_layers`` non-causal calls over the 4,096 frames
    (block 128), then a causal self-attention call (19 tokens: block 1) and a
    cross-attention call (19 queries against 4,096 keys: blocks 1 and 128) a
    decoder layer; a decode step one cross-attention call a layer, at one
    query; the logits are the plain path's."""
    monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.KERNEL)
    calls = []

    def flash(q, k, v, *, causal, window, q_offset, block_q, block_k):
        assert q.shape[1] % block_q == 0 and k.shape[1] % block_k == 0
        calls.append((q.shape[1], k.shape[1], block_q, block_k, causal))
        return fa_ops._reference(q, k, v, causal, window, q_offset)

    monkeypatch.setattr(fa_ops, "flash_attention_cuda", flash)
    cfg, _, params = _models("float32", seed=8)
    batch, _ = _batch(cfg, 1, 20, seed=9)
    first = dict(batch, tokens=batch["tokens"][:, :19])
    L, F = cfg.num_layers, M.AUDIO_SRC_LEN
    with torch.no_grad():
        logits, cache = M.prefill(params, first, cfg, 24)
        encoder = [(F, F, 128, 128, False)] * cfg.encoder_layers
        assert calls == encoder + [(19, 19, 1, 1, True), (19, F, 1, 128, False)] * L
        calls.clear()
        lg2, _ = M.decode_step(params, cache, batch["tokens"][:, 19:], 19, cfg)
        assert calls == [(1, F, 1, 128, False)] * L
        monkeypatch.undo()
        want, want_cache = M.prefill(params, first, cfg, 24)
        want2, _ = M.decode_step(params, want_cache, batch["tokens"][:, 19:], 19, cfg)
    _close(logits, want.numpy(), dict(atol=0, rtol=0))
    _close(lg2, want2.numpy(), dict(atol=0, rtol=0))
