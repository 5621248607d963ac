"""repro_torch's LM training forward against the JAX package's for the
``dense`` family at SMOKE (qwen2.5-3b with its QKV bias, yi-6b, minitron-8b,
internlm2-20b: GQA attention and SwiGLU), and the cross-entropy
(``models/layers.py`` ``cross_entropy``) against JAX's: chunked and
unchunked, over a padded vocabulary, with -1 labels.

The helpers and tolerances are ``test_torch_train_lm.py``'s: float32 loss,
metrics and gradients within 1e-4 absolute plus 1e-4 relative, the bf16 loss
within 0.12. The port's attention on the CPU is the flash op's dense oracle,
JAX's its blockwise loop over ``attn_chunk`` keys.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import cross_entropy as jcross_entropy
from repro_torch.models import model as M
from repro_torch.models.layers import cross_entropy
from test_torch_train_lm import (
    F32_TOL,
    check_against_jax,
    check_bf16_loss,
    close,
    jax_loss,
    make_batch,
    models,
    torch_batch,
)

ARCHS = ["qwen2.5-3b", "yi-6b", "minitron-8b", "internlm2-20b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    check_against_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_loss_matches_jax(arch):
    check_bf16_loss(arch)


@pytest.mark.parametrize("vp,chunk", [(300, 0), (300, 16), (260, 16), (300, 24), (300, 64)])
def test_cross_entropy_matches_jax(vp, chunk):
    """Logits [2, 64, vp] over a vocabulary of 260 (the tail from column 260
    padded), labels with -1 entries: the mean CE and its gradient against
    JAX's. ``chunk`` 16 splits the sequence into 4 segments; 24 does not
    divide 64 and 64 is not shorter than it, so both take the unchunked
    form, as in the JAX package."""
    rng = np.random.default_rng(vp + chunk)
    logits = (rng.standard_normal((2, 64, vp)) * 3).astype(np.float32)
    labels = rng.integers(0, 260, (2, 64)).astype(np.int32)
    labels[0, ::5] = -1
    labels[1, :7] = -1
    want, jgrad = jax.value_and_grad(lambda lg: jcross_entropy(lg, jnp.asarray(labels), 260, chunk))(
        jnp.asarray(logits))  # fmt: skip
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(lg, torch.from_numpy(labels).long(), 260, chunk)
    (grad,) = torch.autograd.grad(got, lg)
    close(got, want, dict(atol=1e-6, rtol=1e-6))
    close(grad, jgrad, dict(atol=1e-7, rtol=1e-5))
    assert got.dtype == torch.float32
    assert torch.all(grad[..., 260:] == 0)


def test_cross_entropy_of_bf16_logits_runs_in_float32():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 8, 256)) * 3).astype(np.float32)
    labels = rng.integers(0, 256, (2, 8)).astype(np.int32)
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    want = jcross_entropy(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16), jnp.asarray(labels), 256)
    got = cross_entropy(bf, torch.from_numpy(labels).long(), 256)
    assert got.dtype == torch.float32
    close(got, want, dict(atol=1e-6, rtol=1e-6))


def test_cross_entropy_without_labels_is_zero():
    """Every label -1: the loss is 0 (the count is clamped to 1), as in JAX."""
    logits = torch.randn(1, 4, 256)
    labels = torch.full((1, 4), -1)
    assert cross_entropy(logits, labels, 256).item() == 0.0


def test_logit_chunk_gives_the_jax_loss():
    """qwen2.5-3b SMOKE with ``logit_chunk=8`` over 32 positions (4 segments)
    against JAX's at the same setting, and against the unchunked loss."""
    _, cfg, jparams, params = models("qwen2.5-3b", "float32", logit_chunk=8)
    batch = make_batch(cfg, 2, 32, seed=5)
    want, _ = jax_loss("qwen2.5-3b", "float32", logit_chunk=8)(jparams, batch)
    with torch.no_grad():
        got, _ = M.train_loss(params, torch_batch(batch), cfg)
        plain, _ = M.train_loss(params, torch_batch(batch), dataclasses.replace(cfg, logit_chunk=0))
    close(got, want, F32_TOL)
    close(got, plain.numpy(), dict(atol=1e-6, rtol=1e-6))
