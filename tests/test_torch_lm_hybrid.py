"""repro_torch's hybrid language model (zamba2-1.2b: Mamba2 layers and one
weight-shared attention block) against the JAX package's.

The JAX package builds the parameters (``init_params``) and they cross to the
port through ``repro_torch.convert.lm_params_from_numpy`` (bf16 leaves as
float32, which holds them exactly), so both frameworks compute from the same
weights; prompts are numpy integers from a seed. On the CPU the port's scan
takes ``ssd_chunked`` and its prefill attention the flash op's dense oracle;
JAX's runs its plain SSD reference and its blockwise attention. JAX's calls
are compiled once a shape (``jax.jit``).

Tolerances: float32 (``dataclasses.replace(cfg, dtype="float32")``) within
1e-4 relative; bf16 within 0.12 (``tests/test_models.py:99``). On the card
every Mamba2 prefill launches ``ssd_scan_cuda`` and every shared-block
prefill ``flash_attention_cuda`` (``tests/test_torch_cuda.py``); here that
dispatch is held with plain functions in the kernels' place.
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
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, count_params, spec_bytes

ARCH = "zamba2-1.2b"
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


@functools.lru_cache(maxsize=None)
def _jax_fns(dtype: str, cache_len: int):
    """JAX's SMOKE config in ``dtype`` and its jitted prefill and decode step."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    prefill = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, cache_len=cache_len))
    decode = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, jcfg))
    return jcfg, prefill, decode


def _models(dtype: str, seed: int = 0):
    """(JAX cfg, port cfg, JAX params, port params) of the SMOKE model in ``dtype``."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    return jcfg, cfg, jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _fields(cfg) -> dict:
    """A config's fields, its attention and SSM configs as dicts."""
    plain = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return {f.name: plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


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
    """The config's fields, every parameter's shape, dtype, init, scale and
    axes, and the cache's, as in the JAX package, counted without allocating
    anything; the shared block's segments."""
    cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    assert _fields(cfg) == {k: v for k, v in _fields(jcfg).items() if k in _fields(cfg)}
    ours, theirs = _flat(M.param_specs(cfg)), _flat(JM.param_specs(jcfg))
    assert sorted(ours) == sorted(theirs)
    for path, s in ours.items():
        t = theirs[path]
        assert isinstance(s, ParamSpec)
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale), path
    assert count_params(cfg) == jcfg.n_params()
    assert M._segment_bounds(cfg) == JM._segment_bounds(jcfg)
    cache = _flat(M.cache_specs(cfg, 4, 1088))
    jcache = _flat(JM.cache_specs(jcfg, 4, 1088))
    assert {k: (v.shape, v.axes, v.dtype) for k, v in cache.items()} == {
        k: (v.shape, v.axes, v.dtype) for k, v in jcache.items()
    }
    if not smoke:
        assert count_params(cfg) == 1_170_293_888
        assert 2.3e9 < spec_bytes(M.param_specs(cfg)) < 2.4e9
        assert (cfg.ssm_heads, cfg.ssm.state_dim, cfg.d_inner) == (64, 64, 4096)
        assert M._segment_bounds(cfg) == [(6 * i, 6 * i + 6, True) for i in range(6)] + [(36, 38, False)]
        assert M.shared_applications(cfg) == 6
        assert cache["/shared_attn/k"].shape == (6, 4, 1088, 32, 64)
        assert cache["/layers/state"].shape == (38, 4, 64, 64, 64)


def test_converted_tree_keeps_its_dtypes_and_round_trips():
    """The stacked layers, the shared block and both cache groups cross as they
    are: bf16 leaves exactly, the float32 ones (dt_bias, a_log, d_skip, the SSD
    state) in float32; ``lm_params_to_numpy`` gives the JAX leaves back."""
    _, cfg, jparams, params = _models("bfloat16", seed=7)
    _, jcache = _jax_fns("bfloat16", 48)[1](jparams, jnp.asarray(_tokens(cfg, 2, 40)))
    for jtree, tree in ((jparams, params), (jcache, lm_params_from_numpy(jax.tree.map(np.asarray, jcache)))):
        jflat, flat = _flat(jax.tree.map(np.asarray, jtree)), _flat(tree)
        assert sorted(flat) == sorted(jflat)
        for path, leaf in flat.items():
            assert str(leaf.dtype).endswith(str(jflat[path].dtype)), path
        back = _flat(lm_params_to_numpy(tree))
        for path, leaf in back.items():
            assert np.array_equal(leaf, np.asarray(jflat[path], np.float32)), path
    assert {"shared_attn", "layers"} == set(params) - {"embed", "final_norm", "lm_head"}


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prefill_and_decode_match_jax(dtype, tol):
    """prefill's last-token logits and every cache leaf (the Mamba2 layers' conv
    tails and SSD states, the shared block's keys and values of each
    application), then 3 decode steps in each framework from its own cache."""
    _, cfg, jparams, params = _models(dtype, seed=2)
    jcfg, jprefill, jdecode = _jax_fns(dtype, 48)
    toks = _tokens(cfg, 2, 40, seed=3)
    logits, cache = M.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg, cache_len=48)
    jlogits, jcache = jprefill(jparams, jnp.asarray(toks))
    assert logits.shape == (2, cfg.vocab_padded) and str(logits.dtype).endswith(dtype)
    assert cache["shared_attn"]["k"].shape == (2, 2, 48, 4, 16)  # 2 applications at SMOKE
    _close(logits, jlogits, tol)
    _close_tree(cache, jcache, tol)
    for t in range(3):
        nxt = _tokens(cfg, 2, 1, seed=10 + t)
        logits, cache = M.decode_step(params, cache, torch.from_numpy(nxt).long(), 40 + t, cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(40 + t))
        _close(logits, jlogits, tol)
        _close_tree(cache, jcache, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_teacher_forcing_prefill_decode_parity(dtype, tol):
    """prefill(prompt) + decode steps == prefills of the longer prompts
    (``tests/test_models.py:71``), in the port alone: the SSD state handoff and
    the shared block's cache at once."""
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


def _record_decode_steps(monkeypatch) -> tuple[list, list]:
    """The port's decode steps' greedy tokens of every slot, and their ``pos``."""
    steps, positions = [], []
    decode = M.decode_step

    def recording(params, cache, tokens, pos, cfg, force_reference=False):
        logits, cache = decode(params, cache, tokens, pos, cfg, force_reference)
        steps.append(serve._greedy(logits, cfg).tolist())
        positions.append(pos)
        return logits, cache

    monkeypatch.setattr(M, "decode_step", recording)
    return steps, positions


def test_serve_loop_generates_the_jax_tokens(monkeypatch, capsys):
    """The fp32 smoke model: the port's serve loop and JAX's ``launch/serve.main``
    on the same weights and prompts emit the same greedy tokens, with the same
    decode steps and admissions. 5 requests through 3 slots: the third slot
    goes idle after the first wave and its position runs on, so the admitted
    requests decode at the common position past their prompts (the cache rows
    between are zeros, valid to both frameworks)."""
    jcfg, cfg, jparams, params = _models("float32", seed=5)
    argv = ["--arch", ARCH, "--requests", "5", "--slots", "3", "--prompt-len", "20",
            "--max-new", "8", "--seed", "3"]  # fmt: skip
    text, jsteps = _jax_serve_lines(monkeypatch, capsys, jcfg, jparams, argv)
    steps, positions = _record_decode_steps(monkeypatch)
    args = serve.build_parser().parse_args([*argv, "--device", "cpu"])
    prompts = serve.make_prompts(cfg, args.requests, args.prompt_len, args.seed)
    out = serve.serve_lm(cfg, params, prompts, slots=3, max_new=8, cache_len=args.cache_len,
                         eos=args.eos)  # fmt: skip
    n_steps = int(re.search(r"decode_steps=(\d+)", text).group(1))
    new = int(re.search(r"new_tokens=(\d+)", text).group(1))
    assert out["steps"] == n_steps
    assert sum(len(v) for v in out["outputs"].values()) == new
    jtoks = {int(r): [int(t) for t in toks.split(",")]
             for r, toks in re.findall(r"req(\d+): \[([\d, ]+)\]", text)}  # fmt: skip
    assert sorted(jtoks) == [0, 1, 2]
    for r, toks in jtoks.items():
        assert out["outputs"][r] == toks, r
    assert len(out["admit_ms"]) == 2 and len(out["decode_ms"]) == len(steps) == out["steps"]
    assert steps == jsteps  # every slot's tokens, the admitted requests' too
    assert positions == list(range(20, 20 + out["steps"]))  # the idle slot's runs on


def test_serve_cli_runs_zamba2(capsys):
    """``--arch zamba2-1.2b`` through the launcher on the CPU (SMOKE, the plain
    versions): JAX's summary line and the first requests' tokens."""
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "3", "--slots", "2",
            "--prompt-len", "12", "--max-new", "4"]  # fmt: skip
    assert serve.main(argv) == 0
    text = capsys.readouterr().out
    assert f"arch={ARCH}" in text and "new_tokens=12" in text and "req0: [" in text


def test_prefill_launches_one_flash_attention_a_shared_block_application(monkeypatch):
    """With the dispatch sent to the kernels and plain functions in their place
    (the ops' autograd Functions around them as on the card): a prefill makes
    one ``ssd_scan`` call a Mamba2 layer and one ``flash_attention`` call a
    shared-block application (causal, blocks dividing the prompt: 40 -> 8);
    a decode step makes none; the logits are the plain path's."""
    monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.KERNEL)
    calls = []

    def flash(q, k, v, *, causal, window, q_offset, block_q, block_k):
        assert q.shape[1] % block_q == 0 and k.shape[1] % block_k == 0
        calls.append(("flash_attention", q.shape[1], block_q, causal))
        return fa_ops._reference(q, k, v, causal, window, q_offset)

    def ssd(x, dt, A, bm, cm, D, initial_state=None, *, chunk):
        calls.append(("ssd_scan", x.shape[1]))
        return ssd_ops.ssd_chunked(x, dt, A, bm, cm, D, chunk=chunk, initial_state=initial_state)

    monkeypatch.setattr(fa_ops, "flash_attention_cuda", flash)
    monkeypatch.setattr(ssd_ops, "ssd_scan_cuda", ssd)
    _, cfg, _, params = _models("float32", seed=8)
    toks = torch.from_numpy(_tokens(cfg, 2, 41, seed=9)).long()
    with torch.no_grad():
        logits, cache = M.prefill(params, {"tokens": toks[:, :40]}, cfg, 48)
        n_app = M.shared_applications(cfg)
        assert n_app == 2
        assert calls.count(("flash_attention", 40, 8, True)) == n_app
        assert sum(c[0] == "ssd_scan" for c in calls) == cfg.num_layers and len(calls) == n_app + cfg.num_layers
        calls.clear()
        lg2, _ = M.decode_step(params, cache, toks[:, 40:], 40, cfg)
        assert calls == []
        monkeypatch.undo()
        want, want_cache = M.prefill(params, {"tokens": toks[:, :40]}, cfg, 48)
        want2, _ = M.decode_step(params, want_cache, toks[:, 40:], 40, cfg)
    _close(logits, want.numpy(), dict(atol=0, rtol=0))
    _close(lg2, want2.numpy(), dict(atol=0, rtol=0))
