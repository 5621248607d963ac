"""Mamba2-130m's depth (24 layers) at the SMOKE widths: why the LM path is held
end to end in float32 and only printed in bf16.

With random weights each layer amplifies a difference in the last bits of its
input. Two correct computations of the same logits, here the JAX package's own
prefill at chunk 16 and at chunk 32 (the same sums in another order), agree
within ``tests/test_models.py:99``'s 0.12 at the SMOKE depth of 2 layers but
not at 24 in bf16, where every layer rounds its output to 8 bits. In float32
the same 24 layers keep them within 1e-3 of the largest logit, the bound
``chip_smoke.py`` holds the full-width kernel path to against the plain scan.
The port's float32 model at that depth is held to the JAX package's within the
same bound, prefill and teacher forcing alike.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import model as M

ARCH = "mamba2-130m"
DEPTH = get_config(ARCH).num_layers  # 24, the published depth
LM_TOL = 0.12  # bf16 logits, tests/test_models.py:99
F32_REL = 1e-3  # float32 logits, relative to the largest: chip_smoke.py's end-to-end bound
S_P, N_DEC = 64, 4  # four chunks of 16, then teacher forcing over 4 tokens


def _cfg(get, dtype, layers, chunk=16):
    cfg = get(ARCH, smoke=True)
    return dataclasses.replace(cfg, dtype=dtype, num_layers=layers,
                               ssm=dataclasses.replace(cfg.ssm, chunk=chunk))  # fmt: skip


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(2, S_P + N_DEC)).astype(np.int32)


def _jax_reorder_gap(dtype, layers):
    """JAX prefill logits at chunk 16 against chunk 32: (max abs gap, max |logit|)."""
    cfg16, cfg32 = _cfg(jget_config, dtype, layers), _cfg(jget_config, dtype, layers, chunk=32)
    params = JM.init_params(jax.random.key(0), cfg16)
    toks = {"tokens": jnp.asarray(_tokens(cfg16.vocab_size)[:, :S_P])}
    a = np.asarray(JM.prefill(params, toks, cfg16, S_P + N_DEC)[0], np.float32)
    b = np.asarray(JM.prefill(params, toks, cfg32, S_P + N_DEC)[0], np.float32)
    return float(np.abs(a - b).max()), float(np.abs(a).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_depth_amplifies_a_reordered_sum_in_the_jax_package(dtype):
    shallow, _ = _jax_reorder_gap(dtype, 2)
    deep, scale = _jax_reorder_gap(dtype, DEPTH)
    assert deep > 10 * shallow  # the depth, not the reordering, makes the gap
    if dtype == "bfloat16":
        assert shallow <= LM_TOL < deep
    else:
        assert deep <= F32_REL * scale


def test_float32_port_at_depth_matches_jax():
    """24 float32 layers from the JAX package's weights: the port's prefill
    logits against JAX's, and the port's prefill of 64 tokens plus 4 decode
    steps against its prefills of the longer prompts, within 1e-3 of the
    largest logit."""
    jcfg, cfg = _cfg(jget_config, "float32", DEPTH), _cfg(get_config, "float32", DEPTH)
    jparams = JM.init_params(jax.random.key(0), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    toks_np = _tokens(cfg.vocab_size)
    toks = torch.from_numpy(toks_np).long()
    cache_len = S_P + N_DEC
    logits, cache = M.prefill(params, {"tokens": toks[:, :S_P]}, cfg, cache_len)
    jlogits, _ = JM.prefill(jparams, {"tokens": jnp.asarray(toks_np[:, :S_P])}, jcfg, cache_len)
    jlogits = torch.from_numpy(np.array(jlogits, np.float32))
    scale = jlogits.abs().max().item()
    assert (logits - jlogits).abs().max().item() <= F32_REL * scale
    ref = [M.prefill(params, {"tokens": toks[:, :t]}, cfg, cache_len)[0]
           for t in range(S_P, S_P + N_DEC)]  # fmt: skip
    got = [logits]
    for t in range(S_P, S_P + N_DEC - 1):
        lg, cache = M.decode_step(params, cache, toks[:, t : t + 1], t, cfg)
        got.append(lg)
    assert max((a - b).abs().max().item() for a, b in zip(got, ref)) <= F32_REL * scale
