"""repro_torch's vision-language model (phi-3-vision-4.2b: the phi3-mini
backbone, 256 precomputed patch embeddings prepended to the text) against the
JAX package's.

The JAX package builds the parameters (``init_params``) and they cross to the
port through ``repro_torch.convert.lm_params_from_numpy`` (bf16 leaves as
float32, which holds them exactly); tokens and patches are numpy draws from
a seed. A prefill takes ``{"tokens", "patches"}``; decode positions count the
patches. On the CPU the port's prefill attention takes the flash op's dense
oracle; JAX's runs its blockwise attention over ``attn_chunk`` keys. JAX's
calls are compiled once a shape (``jax.jit``).

Tolerances: float32 (``dataclasses.replace(cfg, dtype="float32")``) within
1e-4 relative; bf16 within 0.12 (``tests/test_models.py:99``). On the card
every layer's prefill launches ``flash_attention_cuda`` (at the published
head width of 96, padded to 128 inside the kernel; ``tests/test_torch_cuda.py``);
here that dispatch is held with a plain function in the kernel's place.
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

ARCH = "phi-3-vision-4.2b"
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
    """Tokens [B, S] and patches [B, num_patches, d_model] (scale 0.5) from a
    seed: the port's batch (patches in the model's dtype) and JAX's."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    patches = (0.5 * rng.standard_normal((B, cfg.num_patches, cfg.d_model))).astype(np.float32)
    dt = getattr(torch, cfg.dtype)
    ours = {"tokens": torch.from_numpy(toks).long(), "patches": torch.from_numpy(patches).to(dt)}
    theirs = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches).astype(jnp.dtype(cfg.dtype))}
    return ours, theirs


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
    """The config's fields (``num_patches``), every parameter's shape, dtype,
    init, scale and axes, the KV cache's, and the parameter count, as in the
    JAX package, counted without allocating anything."""
    cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    assert cfg.family == "vlm" and cfg.num_patches == (8 if smoke else 256)
    assert _fields(cfg) == {k: v for k, v in _fields(jcfg).items() if k in _fields(cfg)}
    ours, theirs = _flat(M.param_specs(cfg)), _flat(JM.param_specs(jcfg))
    assert sorted(ours) == sorted(theirs)
    for path, s in ours.items():
        t = theirs[path]
        assert isinstance(s, ParamSpec)
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale), path
    assert count_params(cfg) == jcfg.n_params() == count_params(cfg, active_only=True)
    cache = _flat(M.cache_specs(cfg, 2, 1027))
    jcache = _flat(JM.cache_specs(jcfg, 2, 1027))
    assert {k: (v.shape, v.axes, v.dtype) for k, v in cache.items()} == {
        k: (v.shape, v.axes, v.dtype) for k, v in jcache.items()
    }
    if not smoke:
        assert count_params(cfg) == 3_822_259_200 and cfg.attn.head_dim == 96


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prefill_and_decode_match_jax(dtype, tol):
    """phi-3-vision SMOKE: 8 patches and 32 tokens through prefill (last-token
    logits, every layer's keys and values), then 3 decode steps at positions
    40-42 in each framework from its own cache."""
    cfg, jparams, params = _models(dtype, seed=2)
    _, jprefill, jdecode = _jax_fns(dtype, 48)
    batch, jbatch = _batch(cfg, 2, 32, seed=3)
    logits, cache = M.prefill(params, batch, cfg, cache_len=48)
    jlogits, jcache = jprefill(jparams, jbatch)
    assert logits.shape == (2, cfg.vocab_padded) and str(logits.dtype).endswith(dtype)
    _close(logits, jlogits, tol)
    _close_tree(cache, jcache, tol)
    rng = np.random.default_rng(4)
    for t in range(3):
        nxt = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = cfg.num_patches + 32 + t
        logits, cache = M.decode_step(params, cache, torch.from_numpy(nxt).long(), pos, cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        _close(logits, jlogits, tol)
        _close_tree(cache, jcache, tol)


def test_patches_reach_the_logits():
    """The patches are part of the prompt: other patches give other logits,
    and the patch rows fill the cache's first ``num_patches`` positions."""
    cfg, _, params = _models("float32", seed=5)
    batch, _ = _batch(cfg, 1, 12, seed=6)
    lg, cache = M.prefill(params, batch, cfg, cache_len=24)
    lg2, cache2 = M.prefill(params, dict(batch, patches=-batch["patches"]), cfg, cache_len=24)
    assert (lg - lg2).abs().max() > 1e-3
    k, k2 = cache["layers"]["k"], cache2["layers"]["k"]
    n = cfg.num_patches
    assert (k[:, :, :n] - k2[:, :, :n]).abs().max() > 1e-3
    assert torch.all(k[:, :, n + 12 :] == 0)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_teacher_forcing_prefill_decode_parity(dtype, tol):
    """prefill(patches + prompt) + decode steps == prefills of the longer
    prompts (``tests/test_models.py:71``), in the port alone: the decode
    positions run on past the patches."""
    cfg, _, params = _models(dtype, seed=0)
    S_p, N_dec = 16, 4
    batch, _ = _batch(cfg, 2, S_p + N_dec, seed=7)
    toks, n, CL = batch["tokens"], cfg.num_patches, cfg.num_patches + S_p + N_dec
    ref = [M.prefill(params, dict(batch, tokens=toks[:, :t]), cfg, CL)[0] for t in range(S_p, S_p + N_dec)]
    lg, cache = M.prefill(params, dict(batch, tokens=toks[:, :S_p]), cfg, CL)
    got = [lg]
    for t in range(S_p, S_p + N_dec - 1):
        lg, cache = M.decode_step(params, cache, toks[:, t : t + 1], n + t, cfg)
        got.append(lg)
    for a, b in zip(got, ref):
        _close(a, b.float().numpy(), tol)


def test_serve_refuses_vlm():
    """The serve loop feeds a prefill only the prompt's tokens, as the JAX
    launcher does (its prefill would read ``batch["patches"]``): it refuses
    phi-3-vision and says why, before it draws any weights."""
    with pytest.raises(ValueError, match=r"needs batch\['patches'\] beside the tokens"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--slots", "2"])
    cfg, _, params = _models("float32")
    prompts = serve.make_prompts(cfg, 2, 8, 0)
    with pytest.raises(ValueError, match="serve loop passes only the tokens"):
        serve.serve_lm(cfg, params, prompts, slots=2, max_new=2, cache_len=32, eos=0)


def test_prefill_launches_one_flash_attention_a_layer(monkeypatch):
    """With the dispatch sent to the kernel and a plain function in its place:
    a prefill makes one causal ``flash_attention`` call a layer over the
    patches and the tokens (8 + 29 = 37 positions -> block 1), a decode step
    none; the logits are the plain path's."""
    monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.KERNEL)
    calls = []

    def flash(q, k, v, *, causal, window, q_offset, block_q, block_k):
        calls.append((q.shape[1:], k.shape[1:3], block_q, block_k, causal, window))
        return fa_ops._reference(q, k, v, causal, window, q_offset)

    monkeypatch.setattr(fa_ops, "flash_attention_cuda", flash)
    cfg, _, params = _models("float32", seed=8)
    a = cfg.attn
    batch, _ = _batch(cfg, 2, 30, seed=9)
    first = dict(batch, tokens=batch["tokens"][:, :29])
    with torch.no_grad():
        logits, cache = M.prefill(params, first, cfg, 48)
        want_call = ((37, a.num_heads, a.head_dim), (37, a.num_kv_heads), 1, 1, True, None)
        assert calls == [want_call] * cfg.num_layers
        calls.clear()
        lg2, _ = M.decode_step(params, cache, batch["tokens"][:, 29:], 37, cfg)
        assert calls == []
        monkeypatch.undo()
        want, want_cache = M.prefill(params, first, cfg, 48)
        want2, _ = M.decode_step(params, want_cache, batch["tokens"][:, 29:], 37, cfg)
    _close(logits, want.numpy(), dict(atol=0, rtol=0))
    _close(lg2, want2.numpy(), dict(atol=0, rtol=0))
