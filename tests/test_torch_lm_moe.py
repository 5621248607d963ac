"""repro_torch's MoE language models (moonshot-v1-16b-a3b: 64 experts, top 6;
mixtral-8x22b: 8 experts, top 2, a sliding window of 4,096) against the JAX
package's.

The JAX package builds the parameters (``init_params``) and they cross to the
port through ``repro_torch.convert.lm_params_from_numpy`` (bf16 leaves as
float32, which holds them exactly); prompts are numpy integers from a seed.
Both frameworks serve the MoE FFN in its dropless form (``moe_ffn(...,
dropless=True)``). On the CPU the port's prefill attention takes the flash
op's dense oracle; JAX's runs its blockwise attention over ``attn_chunk``
keys. JAX's calls are compiled once a shape (``jax.jit``).

mixtral's SMOKE window is 16 keys, so a prompt of 32 or 40 tokens builds the
rolling cache (``models/attention.py`` ``prefill_attention``, S >= window)
and every decode step writes it at ``pos % 16``.

Tolerances: float32 (``dataclasses.replace(cfg, dtype="float32")``) within
1e-4 relative; bf16 within 0.12 (``tests/test_models.py:99``). On the card
every layer's prefill launches ``flash_attention_cuda``
(``tests/test_torch_cuda.py``); here that dispatch is held with a plain
function in the kernel's place.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as jconfigs
from repro.configs.base import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.configs.base import PORTED
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, count_params

ARCH = "moonshot-v1-16b-a3b"
SWA = "mixtral-8x22b"
MOE = [ARCH, SWA]
# total and active (top_k of num_experts of every expert-axis leaf) parameters
COUNTS = {ARCH: (28_057_995_264, 3_968_600_064), SWA: (140_630_071_296, 39_159_404_544)}
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
    """A config's fields, its attention and MoE configs as dicts."""
    plain = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return {f.name: plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


@functools.lru_cache(maxsize=None)
def _jax_fns(arch: str, dtype: str, cache_len: int):
    """JAX's SMOKE config in ``dtype`` and its jitted prefill and decode step."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype)
    prefill = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, cache_len=cache_len))
    decode = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, jcfg))
    return jcfg, prefill, decode


def _models(dtype: str, seed: int = 0, arch: str = ARCH):
    """(JAX cfg, port cfg, JAX params, port params) of the SMOKE model in ``dtype``."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jparams = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), jcfg))
    return jcfg, cfg, jparams, lm_params_from_numpy(jparams)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


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
@pytest.mark.parametrize("arch", MOE)
def test_config_and_specs_match_jax(arch, smoke):
    """The config's fields, every parameter's shape, dtype, init, scale and
    axes (the ``moe`` FFN in each layer's ``mlp`` place), and the KV cache's
    (mixtral's holds the window, 4,096 of 4,164 positions), as in the JAX
    package, counted without allocating anything."""
    cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert cfg.family == "moe" and PORTED[arch] == "moe"
    assert _fields(cfg) == {k: v for k, v in _fields(jcfg).items() if k in _fields(cfg)}
    ours, theirs = _flat(M.param_specs(cfg)), _flat(JM.param_specs(jcfg))
    assert sorted(ours) == sorted(theirs)
    assert "/layers/moe/w_gate" in ours and not any("/mlp/" in k for k in ours)
    for path, s in ours.items():
        t = theirs[path]
        assert isinstance(s, ParamSpec)
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale), path
    cache = _flat(M.cache_specs(cfg, 2, 4164))
    jcache = _flat(JM.cache_specs(jcfg, 2, 4164))
    assert {k: (v.shape, v.axes, v.dtype) for k, v in cache.items()} == {
        k: (v.shape, v.axes, v.dtype) for k, v in jcache.items()
    }
    a = cfg.attn
    C = min(4164, a.window) if a.window else 4164
    assert cache["/layers/k"].shape == (cfg.num_layers, 2, C, a.num_kv_heads, a.head_dim)


@pytest.mark.parametrize("arch", MOE)
def test_count_params_total_and_active_match_jax(arch):
    """``count_params`` and its active share (top_k / num_experts of every
    leaf with an ``"expert"`` axis: the router and the experts' weights), as
    the JAX package's ``n_params`` and ``n_active_params``."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    total, active = COUNTS[arch]
    assert count_params(cfg) == jcfg.n_params() == total
    assert count_params(cfg, active_only=True) == jcfg.n_active_params() == active
    smoke, jsmoke = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    assert count_params(smoke, active_only=True) == jsmoke.n_active_params() < count_params(smoke)
    dense = get_config("qwen2.5-3b")
    assert count_params(dense, active_only=True) == count_params(dense)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prefill_and_decode_match_jax(dtype, tol):
    """moonshot-v1-16b-a3b SMOKE (8 experts, top 3): prefill's last-token logits
    and every layer's keys and values, then 3 decode steps in each framework
    from its own cache. The prompt's 80 tokens route in two groups of 64, the
    second padded with 48 zero rows."""
    _, cfg, jparams, params = _models(dtype, seed=2)
    _, jprefill, jdecode = _jax_fns(ARCH, dtype, 48)
    toks = _tokens(cfg, 2, 40, seed=3)
    logits, cache = M.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg, cache_len=48)
    jlogits, jcache = jprefill(jparams, jnp.asarray(toks))
    assert logits.shape == (2, cfg.vocab_padded) and str(logits.dtype).endswith(dtype)
    _close(logits, jlogits, tol)
    _close_tree(cache, jcache, tol)
    for t in range(3):
        nxt = _tokens(cfg, 2, 1, seed=10 + t)
        logits, cache = M.decode_step(params, cache, torch.from_numpy(nxt).long(), 40 + t, cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(40 + t))
        _close(logits, jlogits, tol)
        _close_tree(cache, jcache, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_swa_prefill_and_decode_match_jax(dtype, tol):
    """mixtral-8x22b SMOKE (window 16): a prompt of 40 tokens builds the rolling
    cache (the last 16 keys, slot i the position = i mod 16), then 3 decode
    steps write it at ``pos % 16``; logits and caches as JAX's."""
    _, cfg, jparams, params = _models(dtype, seed=4, arch=SWA)
    _, jprefill, jdecode = _jax_fns(SWA, dtype, 64)
    toks = _tokens(cfg, 2, 43, seed=5)
    logits, cache = M.prefill(params, {"tokens": torch.from_numpy(toks[:, :40]).long()}, cfg, 64)
    jlogits, jcache = jprefill(jparams, jnp.asarray(toks[:, :40]))
    assert cache["layers"]["k"].shape[2] == cfg.attn.window == 16
    _close(logits, jlogits, tol)
    _close_tree(cache, jcache, tol)
    for t in range(40, 43):
        logits, cache = M.decode_step(params, cache, torch.from_numpy(toks[:, t : t + 1]).long(), t, cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.asarray(t))
        _close(logits, jlogits, tol)
        _close_tree(cache, jcache, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_rolling_cache_matches_full_window(dtype):
    """``tests/test_models.py:103`` in the port: mixtral SMOKE, a prompt of 40
    (longer than the window of 16) and 5 decode steps against the prefills of
    the longer prompts, whose windowed attention sees the same 16 keys. float32
    within 1e-4; bf16 at that test's own bounds (94% within 0.12, all within
    0.35 + 0.1 relative)."""
    _, cfg, _, params = _models(dtype, seed=1, arch=SWA)
    B, S_p, N_dec = 1, 40, 6
    S = S_p + N_dec
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2)).long()
    ref = [M.prefill(params, {"tokens": toks[:, :t]}, cfg, cache_len=S)[0] for t in range(S_p, S)]
    lg, cache = M.prefill(params, {"tokens": toks[:, :S_p]}, cfg, cache_len=S)
    got = [lg]
    for t in range(S_p, S - 1):
        lg, cache = M.decode_step(params, cache, toks[:, t : t + 1], t, cfg)
        got.append(lg)
    for a, b in zip(got, ref):
        a, b = a.float().numpy(), b.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(a, b, **F32_TOL)
        else:
            assert np.mean(np.abs(a - b) < 0.12) > 0.94
            np.testing.assert_allclose(a, b, atol=0.35, rtol=0.1)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_teacher_forcing_prefill_decode_parity(dtype, tol):
    """moonshot SMOKE: prefill(prompt) + decode steps == prefills of the longer
    prompts (``tests/test_models.py:71``), in the port alone: the dropless MoE
    routes a decoded token as the prefill routes it."""
    _, cfg, _, params = _models(dtype, seed=0)
    B, S_p, N_dec = 2, 16, 4
    toks = torch.from_numpy(_tokens(cfg, B, S_p + N_dec, seed=6)).long()
    ref = [M.prefill(params, {"tokens": toks[:, :t]}, cfg, cache_len=S_p + N_dec)[0]
           for t in range(S_p, S_p + N_dec)]  # fmt: skip
    lg, cache = M.prefill(params, {"tokens": toks[:, :S_p]}, cfg, cache_len=S_p + N_dec)
    got = [lg]
    for t in range(S_p, S_p + N_dec - 1):
        lg, cache = M.decode_step(params, cache, toks[:, t : t + 1], t, cfg)
        got.append(lg)
    for a, b in zip(got, ref):
        _close(a, b.float().numpy(), tol)


def _jax_serve_lines(monkeypatch, capsys, jcfg, jparams, argv):
    """JAX's launch/serve.main on our config and weights: its printed lines and
    every decode step's greedy tokens of every slot (its one ``np.asarray``)."""
    steps = []

    class RecordingNumpy:
        def __getattr__(self, name):
            return getattr(np, name)

        def asarray(self, a):
            steps.append(np.asarray(a).tolist())
            return np.asarray(a)

    monkeypatch.setattr(jconfigs, "get_config", lambda name, smoke=False: jcfg)
    monkeypatch.setattr(JM, "init_params", lambda key, cfg: jparams)
    monkeypatch.setattr(jserve, "np", RecordingNumpy())
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    assert jserve.main() == 0
    return capsys.readouterr().out, steps


def test_serve_loop_generates_the_jax_tokens(monkeypatch, capsys):
    """mixtral SMOKE in float32: the port's serve loop and JAX's
    ``launch/serve.main`` on the same weights and prompts emit the same greedy
    tokens every decode step, with the same admissions. Prompts of 32 tokens
    overrun the window of 16, so every prefill, the admissions' too, rolls
    its cache, and every slot decodes at the common position's ``pos % 16``."""
    jcfg, cfg, jparams, params = _models("float32", seed=5, arch=SWA)
    argv = ["--arch", SWA, "--requests", "5", "--slots", "3", "--prompt-len", "32", "--max-new",
            "8", "--seed", "3"]  # fmt: skip
    text, jsteps = _jax_serve_lines(monkeypatch, capsys, jcfg, jparams, argv)
    steps = []
    decode = M.decode_step

    def recording(params, cache, tokens, pos, cfg, force_reference=False):
        logits, cache = decode(params, cache, tokens, pos, cfg, force_reference)
        steps.append(serve._greedy(logits, cfg).tolist())
        return logits, cache

    monkeypatch.setattr(M, "decode_step", recording)
    args = serve.build_parser().parse_args([*argv, "--device", "cpu"])
    prompts = serve.make_prompts(cfg, args.requests, args.prompt_len, args.seed)
    out = serve.serve_lm(cfg, params, prompts, slots=3, max_new=8, cache_len=args.cache_len,
                         eos=args.eos)  # fmt: skip
    assert out["steps"] == int(re.search(r"decode_steps=(\d+)", text).group(1))
    assert sum(len(v) for v in out["outputs"].values()) == int(re.search(r"new_tokens=(\d+)", text).group(1))
    jtoks = {int(r): [int(t) for t in toks.split(",")]
             for r, toks in re.findall(r"req(\d+): \[([\d, ]+)\]", text)}  # fmt: skip
    for r, toks in jtoks.items():
        assert out["outputs"][r] == toks, r
    assert len(out["admit_ms"]) == 2 and steps == jsteps


def test_serve_cli_runs_the_moe_archs(capsys):
    """``--arch moonshot-v1-16b-a3b`` and ``--arch mixtral-8x22b`` serve on the CPU
    (SMOKE, the plain versions) and print JAX's summary."""
    for arch in MOE:
        argv = ["--arch", arch, "--device", "cpu", "--requests", "3", "--slots", "2",
                "--prompt-len", "20", "--max-new", "4"]  # fmt: skip
        assert serve.main(argv) == 0
        text = capsys.readouterr().out
        assert f"arch={arch}" in text and "new_tokens=12" in text and "req0: [" in text


@pytest.mark.parametrize("arch", MOE)
def test_prefill_launches_one_flash_attention_a_layer(monkeypatch, arch):
    """With the dispatch sent to the kernel and a plain function in its place
    (the op's autograd Function around it as on the card): a prefill makes one
    ``flash_attention`` call a layer (causal, mixtral's windowed at 16, blocks
    dividing the prompt: 37 -> 1), a decode step none; the logits are the plain
    path's."""
    monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.KERNEL)
    calls = []

    def flash(q, k, v, *, causal, window, q_offset, block_q, block_k):
        assert q.shape[1] % block_q == 0 and k.shape[1] % block_k == 0
        calls.append((q.shape[1:3], k.shape[1:3], block_q, block_k, causal, window))
        return fa_ops._reference(q, k, v, causal, window, q_offset)

    monkeypatch.setattr(fa_ops, "flash_attention_cuda", flash)
    _, cfg, _, params = _models("float32", seed=8, arch=arch)
    a = cfg.attn
    toks = torch.from_numpy(_tokens(cfg, 2, 38, seed=9)).long()
    with torch.no_grad():
        logits, cache = M.prefill(params, {"tokens": toks[:, :37]}, cfg, 48)
        want_call = ((37, a.num_heads), (37, a.num_kv_heads), 1, 1, True, a.window)
        assert calls == [want_call] * cfg.num_layers
        calls.clear()
        lg2, _ = M.decode_step(params, cache, toks[:, 37:], 37, cfg)
        assert calls == []
        monkeypatch.undo()
        want, want_cache = M.prefill(params, {"tokens": toks[:, :37]}, cfg, 48)
        want2, _ = M.decode_step(params, want_cache, toks[:, 37:], 37, cfg)
    _close(logits, want.numpy(), dict(atol=0, rtol=0))
    _close(lg2, want2.numpy(), dict(atol=0, rtol=0))
