"""repro_torch's merinda-gru language model (the ``gru`` family) against the JAX package's.

merinda-gru is the paper's own GRU-flow cell used as an LM sequence mixer, each
layer followed by a SwiGLU MLP (``repro/configs/merinda_gru.py``). The JAX
package builds the parameters (``init_params``) and they cross to the port
through ``repro_torch.convert.lm_params_from_numpy`` (bf16 leaves as float32,
which holds them exactly), so both frameworks compute from the same weights;
prompts are numpy integers from a seed. The port's scan takes its plain
version (``gru_scan_reference``) on the CPU; JAX's layer runs its plain
``gru_scan_ref`` (it reaches no Pallas kernel).

Tolerances: float32 (``dataclasses.replace(cfg, dtype="float32")``) within
1e-4 relative; bf16 within 0.12 (``tests/test_models.py:99``: bf16
parameters, O(1-10) logits, the two frameworks round their bf16 products at
other places). On the card the scan launches ``gru_scan_cuda`` at H <= 256 and
the wide form ``gru_scan_wide_cuda`` above (``tests/test_torch_cuda.py``); here
the dispatch is held with plain Functions in the kernels' place.
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
from repro.kernels.gru_scan.ref import gru_scan_reference as jgru_scan_reference
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core.neural_flow import GRUParams
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.gru_scan import ops as gru_ops
from repro_torch.kernels.gru_scan.ref import gru_scan_reference
from repro_torch.kernels.mr_step import tiling
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, count_params, spec_bytes

ARCH = "merinda-gru"
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


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
def test_specs_match_jax(smoke):
    """Every parameter's shape, dtype, init, scale and axes, and the cache's,
    as in the JAX package, counted without allocating anything."""
    cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    fields = ("num_layers", "d_model", "d_ff", "vocab_size", "gru_hidden", "vocab_padded", "family")
    assert [getattr(cfg, f) for f in fields] == [getattr(jcfg, f) for f in fields]
    want = (2, 64, 128, 512, 64) if smoke else (8, 512, 1536, 32000, 512)
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.gru_hidden) == want
    ours, theirs = _flat(M.param_specs(cfg)), _flat(JM.param_specs(jcfg))
    assert sorted(ours) == sorted(theirs)
    for path, s in ours.items():
        t = theirs[path]
        assert isinstance(s, ParamSpec)
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale), path
    assert count_params(cfg) == jcfg.n_params()
    if not smoke:  # 2 x 32,000 x 512 embeddings + 8 x (1,024 x 1,536 + 512 x 512 + 3 x 512 x 1,536)
        assert 66e6 < count_params(cfg) < 67e6
        assert 0.13e9 < spec_bytes(M.param_specs(cfg)) < 0.14e9
    cache = _flat(M.cache_specs(cfg, 4, 128))
    jcache = _flat(JM.cache_specs(jcfg, 4, 128))
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {k: (v.shape, v.dtype) for k, v in jcache.items()}
    assert cache["/layers/state"].shape == (cfg.num_layers, 4, cfg.gru_hidden)


def test_converted_tree_keeps_its_dtypes_and_round_trips():
    """bf16 leaves cross exactly; the cell's ``b`` and ``time_scale`` stay
    float32; ``lm_params_to_numpy`` gives the JAX leaves back."""
    _, _, jparams, params = _models("bfloat16", seed=7)
    flat = _flat(params)
    for path, leaf in flat.items():
        want = torch.float32 if path.endswith(("/gru/b", "/gru/time_scale")) else torch.bfloat16
        assert leaf.dtype == want, path
    back = _flat(lm_params_to_numpy(params))
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    assert sorted(back) == sorted(jflat)
    for path, leaf in back.items():
        assert leaf.dtype == np.float32
        assert np.array_equal(leaf, np.asarray(jflat[path], np.float32)), path


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prefill_matches_jax(dtype, tol):
    """prefill's last-token logits and the cached GRU state of every layer."""
    jcfg, cfg, jparams, params = _models(dtype, seed=2)
    toks = _tokens(cfg, 2, 24, seed=3)
    logits, cache = M.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg, cache_len=64)
    jlogits, jcache = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, cache_len=64)
    assert logits.shape == (2, cfg.vocab_padded) and str(logits.dtype).endswith(dtype)
    assert cache["layers"]["state"].dtype == torch.float32
    _close(logits, jlogits, tol)
    _close(cache["layers"]["state"], jcache["layers"]["state"], tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prefill_and_three_decode_steps_match_jax(dtype, tol):
    """A prefill, then 3 decode steps in each framework from its own cache:
    each step's logits and state against JAX's."""
    jcfg, cfg, jparams, params = _models(dtype, seed=4)
    toks = _tokens(cfg, 2, 16, seed=5)
    _, cache = M.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg, cache_len=32)
    _, jcache = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, cache_len=32)
    for t in range(3):
        nxt = _tokens(cfg, 2, 1, seed=10 + t)
        logits, cache = M.decode_step(params, cache, torch.from_numpy(nxt).long(), 16 + t, cfg)
        jlogits, jcache = JM.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(16 + t), jcfg)
        _close(logits, jlogits, tol)
        _close(cache["layers"]["state"], jcache["layers"]["state"], tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_teacher_forcing_prefill_decode_parity(dtype, tol):
    """prefill(prompt) + decode steps == prefills of the longer prompts
    (``tests/test_models.py:71``), in the port alone."""
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
    argv = ["--arch", ARCH, "--requests", "6", "--slots", "3", "--prompt-len", "20",
            "--max-new", "8", "--seed", "3"]  # fmt: skip
    text = _jax_serve_lines(monkeypatch, capsys, jcfg, jparams, argv)
    args = serve.build_parser().parse_args([*argv, "--device", "cpu"])
    prompts = serve.make_prompts(cfg, args.requests, args.prompt_len, args.seed)
    out = serve.serve_lm(cfg, params, prompts, slots=3, max_new=8, cache_len=args.cache_len,
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


def test_serve_cli_runs_merinda_gru(capsys):
    """``--arch merinda-gru`` through the launcher on the CPU (SMOKE, the plain
    versions): JAX's summary line and the first requests' tokens."""
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "3", "--slots", "2",
            "--prompt-len", "12", "--max-new", "4"]  # fmt: skip
    assert serve.main(argv) == 0
    text = capsys.readouterr().out
    assert f"arch={ARCH}" in text and "decode_steps=" in text and "req0: [" in text
    assert "new_tokens=12" in text


@pytest.mark.parametrize("flow", [True, False])
def test_gru_scan_at_the_full_width_matches_jax(flow):
    """The scan at merinda-gru's CONFIG width (D = H = 512; B = 2, T = 3), from
    a non-zero h0 and per-step dts: the port's ``gru_scan`` (its plain version
    here) against JAX's ``gru_scan_reference``, within 1e-4."""
    B, T, D, H = 2, 3, 512, 512
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    w = (rng.standard_normal((D + H, 3 * H)) / np.sqrt(D + H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    ts = (0.3 * rng.standard_normal(H)).astype(np.float32)
    dts = np.array([1.0, 0.5, 2.0], np.float32)
    params = GRUParams(*map(torch.from_numpy, (w, b, ts)))
    h_T, hs = gru_ops.gru_scan(params, torch.from_numpy(xs), torch.from_numpy(h0),
                               dts=torch.from_numpy(dts), flow=flow)  # fmt: skip
    want = jgru_scan_reference(*map(jnp.asarray, (xs, h0, w[:D], w[D:], b, ts, dts)), flow=flow)
    assert hs.shape == (B, T, H)
    _close(hs, want, F32_TOL)
    _close(h_T, np.asarray(want)[:, -1], F32_TOL)


def test_the_scan_dispatches_on_the_width(monkeypatch):
    """On the card ``gru_scan`` launches the warp cell at H <= 256 (whose carve
    check refuses what does not fit a block) and the wide form past it (held
    here with the plain version in each kernel's place: the Functions' calls
    are counted); the wide wrapper refuses a CPU tensor, and the wide form's
    carve fits a block at the published H = 512."""
    monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.KERNEL)
    calls = []

    def plain(name):
        def kernel(*args, flow, block_b=None):
            calls.append(name)
            return gru_scan_reference(*args, flow=flow)

        return rt.kernel_function(name, kernel, None, gru_scan_reference)

    monkeypatch.setattr(gru_ops, "_GRUScanFn", plain("warp cell"))
    monkeypatch.setattr(gru_ops, "_GRUScanWideFn", plain("wide"))
    rng = np.random.default_rng(12)
    for H, want in ((64, "warp cell"), (121, "warp cell"), (256, "warp cell"), (257, "wide"),
                    (512, "wide")):  # fmt: skip
        D = 8
        p = GRUParams(torch.from_numpy(rng.standard_normal((D + H, 3 * H)).astype(np.float32)),
                      torch.zeros(3 * H), torch.zeros(H))  # fmt: skip
        xs = torch.from_numpy(rng.standard_normal((3, 2, D)).astype(np.float32))
        _, hs = gru_ops.gru_scan(p, xs, torch.zeros(3, H), block_b=4)
        assert calls[-1] == want and hs.shape == (3, 2, H)
        _close(hs, gru_scan_reference(xs, torch.zeros(3, H), p.w[:D], p.w[D:], p.b, p.time_scale,
                                      torch.ones(2)), dict(atol=0, rtol=0))  # fmt: skip
    monkeypatch.undo()
    with pytest.raises(ValueError, match="gru_scan_wide: xs must be on"):
        gru_ops.gru_scan_wide_cuda(xs, torch.zeros(3, 512), p.w[:8], p.w[8:], p.b, p.time_scale,
                                   torch.ones(2), flow=True)  # fmt: skip
    assert tiling.gru_scan_wide_smem_bytes(512) == 8_224 <= tiling.SMEM_BUDGET_BYTES


def test_merinda_gru_is_ported_and_dense_still_raises():
    assert "merinda-gru" in serve.build_parser().parse_args(["--arch", ARCH]).arch
    assert get_config(ARCH).family == "gru"
    with pytest.raises(ValueError, match="unknown architecture.*mamba2-130m, merinda-gru"):
        get_config("merinda-lstm")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), family="lstm")
    with pytest.raises(ValueError, match="unknown family lstm"):
        M.param_specs(cfg)
    with pytest.raises(ValueError, match="unknown family lstm"):
        M.prefill({}, {"tokens": torch.zeros(1, 2, dtype=torch.long)}, cfg, 8)
    with pytest.raises(ValueError, match=r"phi-3-vision-4.2b-smoke \(vlm\) needs batch\['patches'\]"):
        serve.main(["--arch", "phi-3-vision-4.2b", "--device", "cpu"])
