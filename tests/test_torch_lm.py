"""repro_torch's Mamba2 language model and LM serve loop against the JAX package's.

The JAX package builds the parameters (``init_params``) and they cross to the
port through ``repro_torch.convert.lm_params_from_numpy`` (bf16 leaves as
float32, which holds them exactly), so both frameworks compute from the same
weights; prompts are numpy integers. The port's scan takes its plain version
(``ssd_chunked``) on the CPU, and so does the JAX package's off the TPU.

Tolerances: float32 (``dataclasses.replace(cfg, dtype="float32")``) within
1e-4 relative; bf16 within 0.12 (``tests/test_models.py:99``: bf16
parameters, O(1-10) logits, the two frameworks round their bf16 products at
other places).
"""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as jconfigs
from repro.configs.base import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import mamba2 as jmamba
from repro.models import model as JM
from repro_torch.configs import get_config, ported_archs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import mamba2
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, count_params, spec_bytes

ARCH = "mamba2-130m"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.12, rtol=0.12)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _models(dtype: str, seed: int = 0):
    """(JAX cfg, port cfg, JAX params, port params) of the SMOKE model in ``dtype``."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    return jcfg, cfg, jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def test_full_config_specs_match_jax():
    """The published Mamba2-130m: every parameter's shape, dtype, init and
    axes as in the JAX package, counted without allocating anything."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert (cfg.vocab_padded, cfg.ssm_heads, cfg.d_inner) == (50432, 24, 1536)
    assert (cfg.vocab_padded, cfg.ssm_heads, cfg.d_inner) == (jcfg.vocab_padded, jcfg.ssm_heads, jcfg.d_inner)
    ours, theirs = _flat(M.param_specs(cfg)), _flat(JM.param_specs(jcfg))
    assert sorted(ours) == sorted(theirs)
    for path, s in ours.items():
        t = theirs[path]
        assert isinstance(s, ParamSpec)
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale), path
    assert count_params(cfg) == jcfg.n_params()
    assert 160e6 < count_params(cfg) < 170e6
    assert 0.3e9 < spec_bytes(M.param_specs(cfg)) < 0.35e9
    cache = _flat(M.cache_specs(cfg, 4, 128))
    jcache = _flat(JM.cache_specs(jcfg, 4, 128))
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {k: (v.shape, v.dtype) for k, v in jcache.items()}


def test_unported_families_raise():
    """Every architecture of the JAX package's zoo resolves; what still raises
    is an architecture outside it and a family no model has (as JAX's
    ``ValueError``)."""
    assert sorted(ported_archs()) == sorted(jconfigs.ARCH_IDS)
    for arch in jconfigs.ARCH_IDS:
        assert get_config(arch).family == jget_config(arch).family
    with pytest.raises(ValueError, match="unknown architecture 'gpt-5'.*mamba2-130m"):
        get_config("gpt-5")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), family="diffusion")
    for call in (M.param_specs, lambda c: M.cache_specs(c, 1, 8),
                 lambda c: M.prefill({}, {"tokens": torch.zeros(1, 2, dtype=torch.long)}, c, 8)):  # fmt: skip
        with pytest.raises(ValueError, match="unknown family diffusion"):
            call(cfg)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_mamba_forward_matches_jax(dtype, tol):
    jcfg, cfg, jparams, params = _models(dtype)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 40, cfg.d_model)) * 0.5).astype(np.float32)
    lp = {k: v[0] for k, v in params["layers"]["mamba"].items()}
    jlp = {k: v[0] for k, v in jparams["layers"]["mamba"].items()}
    jdt = jnp.dtype(dtype)
    got = mamba2.mamba_forward(lp, torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    want = jmamba.mamba_forward(jlp, jnp.asarray(x).astype(jdt), jcfg)
    assert str(got.dtype).endswith(dtype)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_prefill_and_decode_match_jax(dtype, tol):
    """prefill's last-token logits and cache, then two decode steps from the
    JAX cache carried across, against the JAX package's."""
    jcfg, cfg, jparams, params = _models(dtype, seed=2)
    toks = _tokens(cfg, 2, 40, seed=3)
    logits, cache = M.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg, cache_len=64)
    jlogits, jcache = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, cache_len=64)
    assert logits.shape == (2, cfg.vocab_padded)
    _close(logits, jlogits, tol)
    for name in ("conv", "state"):
        _close(cache["layers"][name], jcache["layers"][name], tol)
    cache = lm_params_from_numpy(jax.tree.map(np.asarray, jcache))
    for t in range(2):
        nxt = _tokens(cfg, 2, 1, seed=10 + t)
        logits, cache = M.decode_step(params, cache, torch.from_numpy(nxt).long(), 40 + t, cfg)
        jlogits, jcache = JM.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(40 + t), jcfg)
        _close(logits, jlogits, tol)
        for name in ("conv", "state"):
            _close(cache["layers"][name], jcache["layers"][name], tol)
    back = lm_params_to_numpy(params)
    assert all(np.array_equal(back_leaf, np.asarray(jleaf, np.float32))
               for back_leaf, jleaf in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)))  # fmt: skip


def test_teacher_forcing_prefill_decode_parity():
    """prefill(prompt) + decode steps == prefills of the longer prompts
    (``tests/test_models.py:71``), in the port alone, bf16."""
    _, cfg, _, params = _models("bfloat16", seed=0)
    B, S_p, N_dec = 2, 16, 4
    toks = torch.from_numpy(_tokens(cfg, B, S_p + N_dec, seed=4)).long()
    ref = [M.prefill(params, {"tokens": toks[:, :t]}, cfg, cache_len=S_p + N_dec)[0]
           for t in range(S_p, S_p + N_dec)]  # fmt: skip
    lg, cache = M.prefill(params, {"tokens": toks[:, :S_p]}, cfg, cache_len=S_p + N_dec)
    got = [lg]
    for t in range(S_p, S_p + N_dec - 1):
        lg, cache = M.decode_step(params, cache, toks[:, t : t + 1], t, cfg)
        got.append(lg)
    for a, b in zip(got, ref):
        _close(a, b.float().numpy(), BF16_TOL)


def _jax_serve_lines(monkeypatch, capsys, jcfg, jparams, argv):
    """JAX's launch/serve.main on our config and weights; its printed lines."""
    monkeypatch.setattr(jconfigs, "get_config", lambda name, smoke=False: jcfg)
    monkeypatch.setattr(JM, "init_params", lambda key, cfg: jparams)
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    assert jserve.main() == 0
    return capsys.readouterr().out


def test_serve_loop_generates_the_jax_tokens(monkeypatch, capsys):
    """The fp32 smoke model: the port's serve loop and JAX's ``launch/serve.main``
    on the same weights and prompts emit the same greedy tokens, with the same
    decode steps and admissions (6 requests through 3 slots)."""
    jcfg, cfg, jparams, params = _models("float32", seed=5)
    argv = ["--arch", ARCH, "--requests", "6", "--slots", "3", "--prompt-len", "24",
            "--max-new", "10", "--seed", "3"]  # fmt: skip
    text = _jax_serve_lines(monkeypatch, capsys, jcfg, jparams, argv)
    args = serve.build_parser().parse_args([*argv, "--device", "cpu"])
    prompts = serve.make_prompts(cfg, args.requests, args.prompt_len, args.seed)
    out = serve.serve_lm(cfg, params, prompts, slots=3, max_new=10, cache_len=args.cache_len,
                         eos=args.eos)  # fmt: skip
    steps = int(re.search(r"decode_steps=(\d+)", text).group(1))
    new = int(re.search(r"new_tokens=(\d+)", text).group(1))
    assert out["steps"] == steps
    assert sum(len(v) for v in out["outputs"].values()) == new
    jtoks = {int(r): [int(t) for t in toks.split(",")]
             for r, toks in re.findall(r"req(\d+): \[([\d, ]+)\]", text)}  # fmt: skip
    assert sorted(jtoks) == [0, 1, 2]
    for r, toks in jtoks.items():
        assert out["outputs"][r] == toks, r
    assert len(out["admit_ms"]) == 3 and len(out["decode_ms"]) == steps


def test_serve_cli(monkeypatch, capsys):
    """The launcher's defaults: the card unless --device cpu; an unknown arch
    raises and names the ported ones, an audio one says why it cannot be
    served; the smoke run prints JAX's summary."""
    args = serve.build_parser().parse_args([])
    assert (args.device, args.arch) == ("cuda", "qwen2.5-3b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(args)
    with pytest.raises(ValueError, match="unknown architecture.*mamba2-130m"):
        serve.main(["--arch", "mixtral-8x22b-smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="serve loop passes only the tokens"):
        serve.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "3", "--slots", "2", "--prompt-len",
            "20", "--max-new", "4"]  # fmt: skip
    assert serve.main(argv) == 0
    text = capsys.readouterr().out
    assert "decode_steps=" in text and "req0: [" in text
