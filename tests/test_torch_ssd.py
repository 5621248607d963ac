"""repro_torch's SSD scan (``kernels/ssd_scan``) against the JAX package's.

The port's plain versions run on the CPU here and are held against the JAX
functions as the JAX package's own tests run them on the CPU: the Pallas
kernel body under the interpreter (``interpret=True``) and the jnp oracles.
Inputs are made with numpy from a seed and reach both frameworks as the
same float32 values.

Tolerances are the JAX package's (``tests/test_kernels_ssd.py``): 5e-5
between two implementations of the chunked algorithm, 2e-4 between the
chunked and the recurrent formulation (they sum in different orders over the
whole sequence). bf16 inputs: the port's ``ssd_chunked`` keeps the JAX
reference's dtypes (its ``C·Bᵀ`` product rounds to bf16), within 2e-2, a few
bf16 rounding steps of the O(1-10) outputs.

The CUDA kernel against its plain version is in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as JR
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as R
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cuda

SHAPES = [  # B, S, H, P, N, G: tests/test_kernels_ssd.py:25-29
    (1, 64, 1, 8, 4, 1),
    (2, 128, 2, 16, 8, 1),
    (2, 96, 4, 32, 16, 2),  # grouped B/C, S not a chunk multiple
]
KERNEL_TOL = dict(atol=5e-5, rtol=5e-5)
SCAN_TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(seed, B, S, H, P, N, G=1):
    """(x, dt, A, bm, cm, D) as numpy float32, scaled as the JAX tests scale them."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(B, S, H, P, scale=0.5)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)  # softplus: positive
    A = -np.exp(f(H, scale=0.5))
    return x, dt, A, f(B, S, G, N, scale=0.5), f(B, S, G, N, scale=0.5), f(H)


def _t(args, dtype=torch.float32):
    """Torch copies: x, bm and cm in ``dtype``; dt, A and D float32."""
    x, dt, A, bm, cm, D = (torch.from_numpy(a.copy()) for a in args)
    return x.to(dtype), dt, A, bm.to(dtype), cm.to(dtype), D


def _j(args, dtype=jnp.float32):
    x, dt, A, bm, cm, D = (jnp.asarray(a) for a in args)
    return x.astype(dtype), dt, A, bm.astype(dtype), cm.astype(dtype), D


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("B,S,H,P,N,G", SHAPES)
@pytest.mark.parametrize("chunk", [32, 64])
def test_plain_scan_matches_jax_kernel_and_references(B, S, H, P, N, G, chunk):
    """The port's op (plain on the CPU, padded to the chunk) against the Pallas
    body, the JAX chunked oracle and both recurrent formulations."""
    args = _inputs(S + chunk, B, S, H, P, N, G)
    y, s = ssd_scan(*_t(args), chunk=chunk)
    assert y.shape == (B, S, H, P) and s.shape == (B, H, N, P)
    for kw in (dict(interpret=True), dict(force_reference=True)):
        jy, js = jssd_scan(*_j(args), chunk=chunk, **kw)
        _close(y, jy, KERNEL_TOL)
        _close(s, js, KERNEL_TOL)
    ry, rs = R.ssd_recurrent(*_t(args))
    jry, jrs = JR.ssd_recurrent(*_j(args))
    _close(ry, jry, KERNEL_TOL)
    _close(rs, jrs, KERNEL_TOL)
    _close(y, ry, SCAN_TOL)
    _close(s, rs, SCAN_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_ssd_chunked_matches_jax_chunked(chunk):
    """Same algorithm, same chunk: the chunks the repo uses, 128 included."""
    args = _inputs(chunk, 1, 256, 2, 16, 8, 1)
    y, s = R.ssd_chunked(*_t(args), chunk=chunk)
    jy, js = JR.ssd_chunked(*_j(args), chunk=chunk)
    _close(y, jy, KERNEL_TOL)
    _close(s, js, KERNEL_TOL)


def test_bf16_follows_the_jax_reference_dtypes():
    """bf16 x, B and C: y comes back bf16 and the state float32, as in JAX;
    the port's plain scan stays within a few bf16 steps of JAX's, and both
    sit a bf16 rounding away from the float32 computation the Pallas kernel
    does on the same values."""
    args = _inputs(5, 2, 128, 4, 16, 16, 2)
    y, s = R.ssd_chunked(*_t(args, torch.bfloat16), chunk=32)
    jy, js = JR.ssd_chunked(*_j(args, jnp.bfloat16), chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert jy.dtype == jnp.bfloat16 and js.dtype == jnp.float32
    bf16_tol = dict(atol=2e-2, rtol=2e-2)
    _close(y.float(), jy, bf16_tol)
    _close(s, js, bf16_tol)
    # the Pallas body computes in float32 on the bf16 values
    ky, _ = jssd_scan(*_j(args, jnp.bfloat16), chunk=32, interpret=True)
    f32_args = [a.float() for a in _t(args, torch.bfloat16)]
    fy, _ = R.ssd_chunked(*f32_args, chunk=32)
    _close(ky, fy.to(torch.bfloat16).float(), bf16_tol)
    assert float((fy - y.float()).abs().max()) > 0  # the bf16 product moves the result


def test_padding_carries_the_state_exactly():
    """S=96 at chunk 64 pads 32 steps of dt = 0: the state and y[:96] equal an
    unpadded scan's at chunk 32 (the padding neither decays nor injects)."""
    args = _inputs(1, 2, 96, 2, 8, 4, 1)
    y, s = ssd_scan(*_t(args), chunk=64)
    y32, s32 = ssd_scan(*_t(args), chunk=32)
    _close(y, y32, KERNEL_TOL)
    _close(s, s32, KERNEL_TOL)


def test_initial_state_carry():
    """scan(x[:64]) then scan(x[64:], initial_state) == scan(x), and the JAX
    package's carry gives the same."""
    args = _inputs(2, 1, 128, 2, 8, 8, 1)
    full_y, full_s = ssd_scan(*_t(args), chunk=32)
    head = [a[:, :64] if a.ndim > 1 else a for a in args]
    tail = [a[:, 64:] if a.ndim > 1 else a for a in args]
    _, s1 = ssd_scan(*_t(head), chunk=32)
    y2, s2 = ssd_scan(*_t(tail), chunk=32, initial_state=s1)
    _close(y2, full_y[:, 64:], SCAN_TOL)
    _close(s2, full_s, SCAN_TOL)
    jy2, js2 = jssd_scan(*_j(tail), chunk=32, initial_state=jnp.asarray(s1.numpy()))
    _close(y2, jy2, KERNEL_TOL)
    _close(s2, js2, KERNEL_TOL)


def test_decode_steps_match_the_scan_and_jax():
    """T decode steps == one recurrent scan (the state handoff), step for
    step equal to the JAX decode step."""
    B, S, H, P, N = 2, 24, 2, 8, 4
    args = _inputs(0, B, S, H, P, N)
    x, dt, A, bm, cm, D = _t(args)
    jx, jdt, jA, jbm, jcm, jD = _j(args)
    s = torch.zeros(B, H, N, P)
    js = jnp.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        y_t, s = R.ssd_decode_step(x[:, t], dt[:, t], A, bm[:, t], cm[:, t], D, s)
        jy_t, js = JR.ssd_decode_step(jx[:, t], jdt[:, t], jA, jbm[:, t], jcm[:, t], jD, js)
        _close(y_t, jy_t, KERNEL_TOL)
        ys.append(y_t)
    y_full, s_full = R.ssd_recurrent(x, dt, A, bm, cm, D)
    _close(torch.stack(ys, 1), y_full, SCAN_TOL)
    _close(s, s_full, SCAN_TOL)
    _close(s, js, KERNEL_TOL)


def test_op_gradient_matches_jax_grad(monkeypatch):
    """The autograd Function the card runs: its backward recomputes the plain
    ``ssd_chunked`` and matches ``jax.grad`` through the JAX kernel path (the
    forward is routed to the plain version, the only one that runs here)."""
    monkeypatch.setattr(ssd_ops, "ssd_scan_cuda", lambda *a, chunk: R.ssd_chunked(*a, chunk=chunk))
    B, S, H, P, N = 2, 64, 2, 8, 4
    args = _inputs(4, B, S, H, P, N)
    ops = [t.requires_grad_(True) for t in _t(args)]
    y, _ = ssd_ops._SSDScanFn.apply(*ops, 32)
    grads = torch.autograd.grad((y**2).sum(), [ops[0], ops[3], ops[1], ops[2], ops[5]])
    x, dt, A, bm, cm, D = _j(args)
    jgrads = jax.grad(
        lambda x, bm, dt, A, D: jnp.sum(jssd_scan(x, dt, A, bm, cm, D, chunk=32, interpret=True)[0] ** 2),
        argnums=(0, 1, 2, 3, 4),
    )(x, bm, dt, A, D)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, dict(atol=5e-4, rtol=5e-4))


def test_wrapper_refuses_cpu_tensors_and_bad_chunks():
    """The CUDA wrapper takes CUDA tensors only and counts nothing it did not launch."""
    args = _t(_inputs(0, 1, 64, 1, 8, 4))
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="must be on"):
        ssd_scan_cuda(*args, chunk=32)
    assert ssd_scan_cuda.launches == before
    assert ssd_ops.score_rows(128, 128, 64) == 64  # the model's float32 carve
    assert ssd_ops.smem_bytes(128, 128, 64, 64) <= ssd_ops.SMEM_BUDGET_BYTES
    assert all(ssd_ops.score_rows(L, 16, 16) == min(L, ssd_ops.MAX_ROWS) for L in ssd_ops.CHUNKS)


def _emulate_bf16_kernels(x, dt, A, bm, cm, D, chunk, split):
    """The bf16 CUDA kernels' arithmetic in plain torch (float32 on the CPU):
    bf16 x, B and C; products with exact float32 results and float32 sums;
    the three float32 factors (w ⊙ x in each chunk's state, the decayed
    scores in scores · x, the entering state in C · S_enter) split into hi +
    lo bf16 halves (``split``, what the kernels do) or rounded to bf16 once;
    y rounded to bf16 once. Returns (y, final state)."""
    B, T, H, P = x.shape
    N, nc = bm.shape[-1], T // chunk
    hi = lambda f: f.to(torch.bfloat16).float()
    r = (lambda f: hi(f) + hi(f - hi(f))) if split else hi
    xc = x.float().reshape(B, nc, chunk, H, P)
    bc = R._expand_groups(bm.float(), H).reshape(B, nc, chunk, H, N)
    cc = R._expand_groups(cm.float(), H).reshape(B, nc, chunk, H, N)
    dtc = dt.reshape(B, nc, chunk, H)
    cum = torch.cumsum(dtc * A, dim=2)
    total = cum[:, :, -1:]
    w = torch.exp(total - cum) * dtc
    S_c = torch.einsum("bclhn,bclhp->bchnp", bc, r(w[..., None] * xc))
    S, S_enter = torch.zeros(B, H, N, P), []
    for c in range(nc):
        S_enter.append(S)
        S = torch.exp(total[:, c, 0])[..., None, None] * S + S_c[:, c]
    S_enter = torch.stack(S_enter, dim=1)
    y = torch.exp(cum)[..., None] * torch.einsum("bclhn,bchnp->bclhp", cc, r(S_enter))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[None, None, :, :, None]
    seg = torch.where(tri, cum[:, :, :, None] - cum[:, :, None], torch.tensor(-torch.inf))
    scores = torch.einsum("bclhn,bcmhn->bclmh", cc, bc) * torch.exp(seg) * dtc[:, :, None]
    y = y + torch.einsum("bclmh,bcmhp->bclhp", r(scores), xc)
    y = y.reshape(B, T, H, P) + D[None, None, :, None] * x.float()
    return y.to(torch.bfloat16), S


@pytest.mark.parametrize("split", [True, False], ids=["split", "rounded_once"])
def test_bf16_kernel_precision_design(split):
    """Why the bf16 kernels split their float32 factors: split, y lies within
    ``chip_smoke.py``'s bf16 bound (one bf16 rounding, 2^-8 of the value, plus
    1e-4) of ``ssd_chunked`` on float32 copies and the state within 1e-4 of its
    largest value; rounded to bf16 once, both bounds break."""
    args = _t(_inputs(31, 2, 256, 2, 32, 64, 1), torch.bfloat16)
    y, s = _emulate_bf16_kernels(*args, chunk=64, split=split)
    want_y, want_s = R.ssd_chunked(*(a.float() for a in args), chunk=64)
    outside = int(((y.float() - want_y).abs() > want_y.abs() * 2.0**-8 + 1e-4).sum())
    state_err = float((s - want_s).abs().max() / want_s.abs().max())
    if split:
        assert outside == 0 and state_err <= 1e-4
    else:
        assert outside > 100 and state_err > 1e-4
