"""repro_torch's flash attention (``kernels/flash_attention``) against the JAX package's.

The port's plain version (the dense oracle) runs on the CPU here and is held
against the JAX op run as the JAX package's own tests run it: the Pallas
kernel body under the interpreter (``interpret=True``) and the jnp oracle
(``force_reference=True``), at every case of ``tests/test_kernels_flash.py``.
Inputs are made with numpy from a seed. Tolerances are that file's: 2e-5 in
float32, 3e-2 in bf16, 5e-4 for gradients.

One difference is pinned, not hidden: a query row with no unmasked key (a
``q_offset`` tail reaching past the keys by at least ``window``) is NaN in
both oracles (a softmax over -inf) but finite in the Pallas kernel (0, or
the mean of v over the masked keys of the tiles it did not skip). The port's
plain version follows the oracle and its CUDA kernel the Pallas kernel
(``test_torch_cuda.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_cuda

CASES = [  # B, S, QH, KH, Dh, causal, window: tests/test_kernels_flash.py:11-19
    (1, 128, 1, 1, 32, True, None),
    (2, 256, 4, 2, 64, True, None),
    (2, 256, 8, 1, 64, True, None),  # MQA
    (1, 256, 4, 4, 128, False, None),  # bidirectional (encoder)
    (2, 256, 4, 2, 64, True, 128),  # sliding window
    (1, 384, 2, 2, 64, True, 64),  # window smaller than block
]
TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, B, Sq, Sk, QH, KH, Dh):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, QH, Dh), f(B, Sk, KH, Dh), f(B, Sk, KH, Dh)


def _port(qkv, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in qkv)
    return flash_attention(q, k, v, **kw)


def _jax(qkv, dtype=jnp.float32, **kw):
    return jflash(*(jnp.asarray(a).astype(dtype) for a in qkv), **kw)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("B,S,QH,KH,Dh,causal,window", CASES)
def test_plain_matches_jax_kernel_and_oracle(B, S, QH, KH, Dh, causal, window):
    qkv = _qkv(S + QH, B, S, S, QH, KH, Dh)
    o = _port(qkv, causal=causal, window=window)
    assert o.shape == (B, S, QH, Dh) and o.dtype == torch.float32
    for kw in (dict(interpret=True), dict(force_reference=True)):
        _close(o, _jax(qkv, causal=causal, window=window, **kw), TOL)


def test_q_offset_tail():
    """A 128-query suffix at q_offset = S - 128 equals the tail of the full result."""
    qkv = _qkv(9, 1, 256, 256, 2, 2, 64)
    full = _port(qkv)
    tail_qkv = (qkv[0][:, -128:], qkv[1], qkv[2])
    tail = _port(tail_qkv, q_offset=128)
    _close(tail, full[:, -128:], TOL)
    _close(tail, _jax(tail_qkv, q_offset=128, interpret=True), TOL)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 256)])
def test_block_shapes_leave_the_result(block_q, block_k):
    qkv = _qkv(4, 1, 256, 256, 2, 2, 64)
    o = _port(qkv, block_q=block_q, block_k=block_k)
    _close(o, _jax(qkv, block_q=block_q, block_k=block_k, interpret=True), TOL)


def test_bf16():
    qkv = _qkv(3, 1, 128, 128, 2, 2, 64)
    o = _port(qkv, torch.bfloat16)
    assert o.dtype == torch.bfloat16
    _close(o.float(), _jax(qkv, jnp.bfloat16, interpret=True), BF16_TOL)
    _close(o.float(), _jax(qkv, jnp.bfloat16, force_reference=True), BF16_TOL)


def test_fully_masked_rows_follow_the_oracle():
    """q_offset + Sq > Sk with a window: rows whose every key is masked. The
    oracles give NaN there, the Pallas kernel a finite value; elsewhere all
    three agree. The port's plain version is the oracle."""
    qkv = _qkv(5, 1, 64, 64, 2, 1, 32)
    kw = dict(causal=True, window=16, q_offset=40, block_q=32, block_k=32)
    o = _port(qkv, **kw).numpy()
    ref = np.asarray(_jax(qkv, force_reference=True, **kw))
    ker = np.asarray(_jax(qkv, interpret=True, **kw))
    dead = np.isnan(ref).any(axis=(0, 2, 3))  # query rows with no unmasked key
    assert dead.sum() == 25 and np.array_equal(np.isnan(o).any(axis=(0, 2, 3)), dead)
    assert np.isfinite(ker).all()
    _close(o[:, ~dead], ref[:, ~dead], TOL)
    _close(o[:, ~dead], ker[:, ~dead], TOL)


def test_op_gradient_matches_jax_grad(monkeypatch):
    """The autograd Function the card runs: its backward recomputes the oracle
    and matches ``jax.grad`` through the JAX kernel path (the forward is routed
    to the plain version, the only one that runs here)."""
    monkeypatch.setattr(
        fa_ops,
        "flash_attention_cuda",
        lambda q, k, v, causal, window, q_offset, block_q, block_k: fa_ops._reference(
            q, k, v, causal, window, q_offset
        ),
    )
    qkv = _qkv(8, 1, 128, 128, 2, 1, 32)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in qkv)
    o = fa_ops._FlashFn.apply(q, k, v, True, None, 0, 128, 128)
    grads = torch.autograd.grad((o**2).sum(), (q, k, v))
    jgrads = jax.grad(
        lambda q, k, v: jnp.sum(jflash(q, k, v, interpret=True) ** 2), argnums=(0, 1, 2)
    )(*(jnp.asarray(a) for a in qkv))
    for g, jg in zip(grads, jgrads):
        _close(g, jg, dict(atol=5e-4, rtol=5e-4))


def test_wrapper_refuses_cpu_tensors_and_ragged_blocks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 128, 128, 2, 2, 32))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="must be on"):
        flash_attention_cuda(q, k, v, causal=True, window=None, q_offset=0, block_q=128,
                             block_k=128)  # fmt: skip
    assert flash_attention_cuda.launches == before
    assert fa_ops._scale(128) == float(np.float32(1.0) / np.sqrt(np.float32(128)))


def _emulate_bf16_kernel(q, k, v, causal, split, tile=64):
    """The bf16 CUDA kernel's arithmetic in plain torch (float32 on the CPU):
    bf16 q, k, v; QKᵀ with exact products and a float32 sum, the scale after
    the product, the causal mask at -1e30, the online softmax over key tiles of
    ``tile`` in float32; P against bf16 V either split into hi + lo bf16 halves
    (``split``, what the kernel does) or rounded to bf16 once; o rounded to
    bf16 once. Layout [B, S, H, Dh]."""
    QH, KH, Dh = q.shape[2], k.shape[2], q.shape[3]
    hm = lambda t, rep: t.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    qf, kf, vf = hm(q, 1), hm(k, QH // KH), hm(v, QH // KH)
    Sq, Sk = qf.shape[2], kf.shape[2]
    m = torch.full(qf.shape[:3], -1e30)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, Sk, tile):
        s = (qf @ kf[:, :, k0 : k0 + tile].transpose(-1, -2)) * fa_ops._scale(Dh)
        if causal:
            keys = torch.arange(k0, min(k0 + tile, Sk))
            s = torch.where(keys[None, :] > torch.arange(Sq)[:, None], torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0 : k0 + tile]
        pv = hi @ vt + (p - hi).to(torch.bfloat16).float() @ vt if split else hi @ vt
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("split", [True, False], ids=["split", "rounded_once"])
def test_bf16_kernel_precision_design(split):
    """Why the bf16 kernel splits P: with P as hi + lo bf16 against bf16 V,
    every output lies within ``chip_smoke.py``'s bf16 bound (one bf16 rounding,
    2^-8 of the value, plus 1e-4) of the float32 oracle on the same values;
    with P rounded to bf16 once, outputs fall outside it (a causal GQA case)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(21, 1, 512, 512, 4, 2, 64))
    o = _emulate_bf16_kernel(q, k, v, causal=True, split=split)
    want = flash_attention(q.float(), k.float(), v.float(), causal=True)
    outside = int(((o.float() - want).abs() > want.abs() * 2.0**-8 + 1e-4).sum())
    assert outside == 0 if split else outside > 100
