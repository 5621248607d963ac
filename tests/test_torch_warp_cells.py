"""The warp-cell kernels' arithmetic (``csrc/warp_cell.cuh``), emulated on the CPU.

``csrc/mr_step.cu`` and ``csrc/mr_step_node.cu`` run one warp a window and
sum in another order than the plain versions: each matvec output in four
partial sums over k mod 4, combined as (p0 + p1) + (p2 + p3); x_t . Wx + b
(GRU) and x_t . W_in + b_in (NODE) computed ahead of the chain, x.W summed
over d first and the bias added after; the flow gate's phi(t) * alpha
computed ahead as well; the head's RMS sum and layer 2 summed per lane
(units j = lane + 32u) and reduced over the lanes by a shuffle butterfly.
The emulation below follows that order in float32, an FMA being a float64
product and sum rounded once to float32, and is held against the JAX
package's fused stage run as its own tests run it on the CPU
(``repro.kernels.mr_step.ops.mr_step(..., interpret=True)``,
``tests/test_kernels_mr_step.py:49``), within 1e-4: the bound the card tests
hold the kernels to. Inputs are made with numpy from a seed.

The carve functions of ``kernels/mr_step/tiling.py`` are held against the
regions the header's layouts take, read from the header itself.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.merinda import MRConfig as JMRConfig
from repro.core.merinda import init_mr as jinit_mr
from repro.kernels.mr_step.ops import mr_step as jmr_step
from repro_torch.convert import params_from_numpy
from repro_torch.core.merinda import RMS_EPS, MRConfig
from repro_torch.core.neural_flow import INV_LIPSCHITZ_ALPHA, softplus
from repro_torch.core.node_mr import node_sub_dt
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ops import head_weights, split_out

TOL = dict(atol=1e-4, rtol=1e-4)
HEADER = Path(tiling.__file__).resolve().parents[1] / "csrc" / "warp_cell.cuh"

# (label, B, T, state_dim, input_dim, H, Dh): the quickstart (D=2) and
# bench_cycles (D=8, H=64, T=200) shapes, at fewer windows for the latter
SHAPES = [
    ("quickstart", 64, 32, 2, 0, 32, 64),
    ("bench_cycles", 8, 200, 2, 6, 64, 128),
]


def _fma(a, b, c):
    """fmaf: the exact product and sum, rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _matvec4(v, w):
    """v [B, n] . w [n, m] as the kernels sum it: partial sum i over k = i mod
    4 in increasing k, then (p0 + p1) + (p2 + p3)."""
    n = v.shape[1]
    p = torch.zeros(4, v.shape[0], w.shape[1])
    for k in range(n):
        p[k % 4] = _fma(v[:, k : k + 1], w[k], p[k % 4])
    return (p[0] + p[1]) + (p[2] + p[3])


def _xw(x, w):
    """x [B, d] . w [d, m] summed over d in order from 0 (the hoisted terms)."""
    acc = torch.zeros(x.shape[0], w.shape[1])
    for d in range(x.shape[1]):
        acc = _fma(x[:, d : d + 1], w[d], acc)
    return acc


def _butterfly(v):
    """Lane 0 of __shfl_xor_sync's butterfly over the last axis (32 lanes)."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _head(h, w1, b1, w2, b2):
    """warp_cell.cuh warp_head: RMS-norm, layer 1, layer 2 (no activation step)."""
    H = h.shape[1]
    ss = torch.zeros(h.shape[0], 32)
    for j in range(H):
        ss[:, j % 32] = _fma(h[:, j], h[:, j], ss[:, j % 32])
    hn = h * torch.rsqrt(_butterfly(ss)[:, None] / H + RMS_EPS)
    hid = torch.relu(_matvec4(hn, w1) + b1)
    s = torch.zeros(h.shape[0], 32, w2.shape[1])
    for i in range(hid.shape[1]):
        s[:, i % 32] = _fma(hid[:, i : i + 1], w2[i], s[:, i % 32])
    return _butterfly(s.movedim(1, -1)) + b2


def _gru_cell_emulation(xs, wx, wh, b, time_scale, dts, w1, b1, w2, b2, flow):
    B, T, _ = xs.shape
    H = wh.shape[0]
    sp = softplus(time_scale)
    h = torch.zeros(B, H)
    for t in range(T):
        gx = _xw(xs[:, t], wx) + b  # ahead of the chain
        pa = torch.tanh(sp * dts[t]) * INV_LIPSCHITZ_ALPHA
        a = _matvec4(h, wh[:, : 2 * H])
        r = torch.sigmoid(gx[:, :H] + a[:, :H])
        z = torch.sigmoid(gx[:, H : 2 * H] + a[:, H:])
        c = torch.tanh(gx[:, 2 * H :] + _matvec4(r * h, wh[:, 2 * H :]))
        h = h + pa * (1.0 - z) * (c - h) if flow else (1.0 - z) * c + z * h
    return _head(h, w1, b1, w2, b2)


def _node_cell_emulation(xs, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2, sub_dt, n_sub):
    B, T, _ = xs.shape
    h = torch.zeros(B, w_f1.shape[0])
    for t in range(T):
        xb = _xw(xs[:, t], w_in) + b_in  # ahead of the chain
        for _ in range(n_sub):
            z = torch.tanh(_matvec4(h, w_f1) + b_f1)
            h = h + sub_dt * (_matvec4(z, w_f2) + b_f2)
        h = h + xb
    return _head(h, w1, b1, w2, b2)


def _setup(B, T, n, m, H, Dh, encoder, seed, **kw):
    common = dict(state_dim=n, input_dim=m, order=2, hidden=H, dense_hidden=Dh, dt=0.05,
                  encoder=encoder, **kw)  # fmt: skip
    jcfg, cfg = JMRConfig(**common), MRConfig(**common)
    jparams = jinit_mr(jax.random.key(seed), jcfg)
    # a non-zero flow-gate rate and biases, so phi and the hoisted bias terms matter
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(np.asarray, jparams)
    enc = jparams.encoder
    if hasattr(enc, "time_scale"):
        enc = enc._replace(time_scale=(0.5 * rng.standard_normal(H)).astype(np.float32),
                           b=(0.1 * rng.standard_normal(3 * H)).astype(np.float32))  # fmt: skip
    else:
        enc = enc._replace(b_in=(0.1 * rng.standard_normal(H)).astype(np.float32))
    jparams = jparams._replace(encoder=enc)
    xs = rng.standard_normal((B, T, n + m)).astype(np.float32)
    return jcfg, cfg, jparams, params_from_numpy(jparams), xs


def _check(jcfg, cfg, jparams, out, xs):
    theta, shifts = split_out(out, cfg)
    jt, js = jmr_step(jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(xs), interpret=True)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(shifts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("encoder", ["gru_flow", "gru"])
@pytest.mark.parametrize("label,B,T,n,m,H,Dh", SHAPES, ids=[s[0] for s in SHAPES])
def test_gru_cell_order_matches_jax_kernel(label, B, T, n, m, H, Dh, encoder):
    jcfg, cfg, jparams, params, xs = _setup(B, T, n, m, H, Dh, encoder, seed=7)
    d_in = n + m
    enc = params.encoder
    with torch.no_grad():
        out = _gru_cell_emulation(
            torch.from_numpy(xs), enc.w[:d_in], enc.w[d_in:], enc.b, enc.time_scale,
            torch.ones(T), *head_weights(params, cfg), flow=encoder == "gru_flow",
        )  # fmt: skip
    _check(jcfg, cfg, jparams, out, xs)


@pytest.mark.parametrize("n_sub", [1, 2, 6])
@pytest.mark.parametrize("label,B,T,n,m,H,Dh", SHAPES, ids=[s[0] for s in SHAPES])
def test_node_cell_order_matches_jax_kernel(label, B, T, n, m, H, Dh, n_sub):
    jcfg, cfg, jparams, params, xs = _setup(B, T, n, m, H, Dh, "node", seed=8, ltc_substeps=n_sub)
    enc = params.encoder
    with torch.no_grad():
        out = _node_cell_emulation(
            torch.from_numpy(xs), *enc, *head_weights(params, cfg),
            sub_dt=node_sub_dt(cfg.dt, n_sub), n_sub=n_sub,
        )  # fmt: skip
    _check(jcfg, cfg, jparams, out, xs)


def _header_carve(layout: str, D, H, Dh, K, bb) -> int:
    """Bytes that ``warp_cell.cuh``'s ``layout`` carves, evaluating each of
    its ``take(...)`` regions (and the head's) as the header writes them."""
    text = HEADER.read_text()
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", text).group(1))
    warps_max = int(re.search(r"constexpr int kWarps = (\d+);", text).group(1))

    def regions(name):
        body = re.search(rf"struct {name} \{{(.*?)\n\}};", text, re.S).group(1)
        return re.findall(r"(\w+(?:\[\d\])?) = (\w)\.take\((.*?)\);", body), body

    env = dict(D=D, H=H, Dh=Dh, K=K, kChunk=chunk, nu=-(-H // 32), R=max(H, Dh),
               S=tiling.col_stride(H))  # fmt: skip
    pad4 = lambda n: (n + 3) // 4 * 4

    def size(expr):
        return pad4(eval(re.sub(r"\(size_t\)", "", expr), {}, env))

    head, _ = regions("HeadLayout")
    takes, body = regions(layout)
    assert "head.carve(c, H, Dh, K);" in body
    block = sum(size(e) for _, c, e in takes if c == "c") + sum(size(e) for _, _, e in head)
    warp = sum(size(e) for _, c, e in takes if c == "w")
    return 4 * (block + min(bb, warps_max) * warp)


@pytest.mark.parametrize("bb", [1, 2, 4, 9])
@pytest.mark.parametrize(
    "D,H,Dh,K", [(2, 32, 64, 12), (8, 64, 128, 12), (3, 48, 40, 7), (2, 8, 16, 13), (1, 5, 3, 2)]
)
def test_cell_carves_match_the_header(D, H, Dh, K, bb):
    assert tiling.mr_step_smem_bytes(D, H, Dh, K, bb) == _header_carve("GruLayout", D, H, Dh, K, bb)
    assert tiling.node_smem_bytes(D, H, Dh, K, bb) == _header_carve("NodeLayout", D, H, Dh, K, bb)
    assert tiling.family_smem_bytes("gru", D, H, Dh, K, bb) == tiling.mr_step_smem_bytes(
        D, H, Dh, K, bb
    )
    assert tiling.cell_warps(bb) == min(bb, 8)
    S = tiling.col_stride(H)  # whole float4s, 4 mod 8: conflict-free float4 reads
    assert S % 4 == 0 and S % 8 == 4 and S >= H
    assert math.gcd(tiling.mr_step_smem_bytes(D, H, Dh, K, bb), 16) == 16  # whole float4s
