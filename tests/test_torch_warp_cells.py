"""The warp-cell kernels' arithmetic (``csrc/warp_cell.cuh``), emulated on the CPU.

``csrc/mr_step.cu``, ``mr_step_ltc.cu``, ``mr_step_node.cu``, the bare scan
``gru_scan.cu``, the int8/PWL stages ``mr_step_int8.cu`` and
``mr_step_ltc_int8.cu``, the int8/PWL scan ``gru_scan_int8.cu`` and the
banked ticks ``mr_tick.cu`` and ``mr_tick_int8.cu`` run one warp a window and
sum in another order than the plain versions: each matvec output in four
partial sums over k mod 4,
combined as (p0 + p1) + (p2 + p3); x_t . Wx + b (GRU), the drive
x_t . W_in + bias (LTC) and x_t . W_in + b_in (NODE) computed ahead of the
chain, x.W summed over d first and the bias added after; the flow gate's
phi(t) * alpha computed ahead as well; the LTC update's numerator and
denominator each one FMA, then the division; the head's RMS sum and layer 2
summed per lane (units j = lane + 32u) and reduced over the lanes by a
shuffle butterfly; the tick's readout summing the windows' outputs in
window order. The int8/PWL cell of ``mr_tick_int8.cu``, ``mr_step_int8.cu``
and ``gru_scan_int8.cu`` dequantizes each weight once (``float(q) * scale``),
keeps x.Wx alone ahead of the chain and adds the bias after the matvec,
``(x.Wx + h.Wh) + b``, and evaluates the PWL tables with a true division; the
int8/PWL LTC substep of ``mr_step_ltc_int8.cu`` rounds every operation apart:
the drive ``x.W_in + bias`` ahead, ``pwl(drive + h.W_rec)``, then
``(h + (sub_dt * f) * a) / (1 + sub_dt * (inv_tau + f))``. The emulation below follows that order in
float32, an FMA being a float64 product and sum rounded once to float32, and
is held against the JAX package's fused stage, scan and ticks run as its own
tests run them on the CPU (``repro.kernels.mr_step.ops.mr_step(...,
interpret=True)``, ``tests/test_kernels_mr_step.py:49``;
``repro.kernels.gru_scan.ops.gru_scan(..., interpret=True)``,
``tests/test_kernels_gru.py:31``, every step's h; ``repro.kernels.mr_step.tick.mr_tick(...,
interpret=True)``, ``tests/test_tick.py:79``), within 1e-4: the bound the
card tests hold the fused kernels to; the int8 tick and stages within the
JAX int8 tick tests' 1e-5 (``tests/test_tick.py:111``), against JAX's int8
oracles and, on tables saturating where they do, its int8 Pallas kernels
(``repro.kernels.mr_step.ops.mr_step_int8(..., interpret=True)``,
``repro.kernels.gru_scan.ops.gru_scan_int8(..., interpret=True)``). Inputs
are made with numpy from a seed.

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
from repro.core.neural_flow import GRUParams as JGRUParams
from repro.kernels.gru_scan.ops import gru_scan as jgru_scan
from repro.kernels.gru_scan.ops import gru_scan_int8 as jgru_scan_int8
from repro.kernels.mr_step.ops import mr_step as jmr_step
from repro.kernels.mr_step.ops import mr_step_int8 as jmr_step_int8
from repro.kernels.mr_step.tick import mr_tick as jmr_tick
from repro_torch.convert import params_from_numpy
from repro_torch.core.ltc import ltc_sub_dt
from repro_torch.core.merinda import RMS_EPS, MRConfig
from repro_torch.core.neural_flow import INV_LIPSCHITZ_ALPHA, softplus
from repro_torch.core.node_mr import node_sub_dt
from repro_torch.core.quant import PWL_FLOATS, pwl_width, quantize_int8, serving_tables
from repro_torch.core.stream import StreamConfig
from repro_torch.data.windows import window_views
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ops import head_weights, int8_weights, split_out
from repro_torch.kernels.mr_step.tick import tick_weights

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


def _gru_scan_emulation(xs, h0, wx, wh, b, time_scale, dts, flow):
    """gru_scan.cu (and mr_step's scan): every step's h [B, T, H]."""
    H = wh.shape[0]
    sp = softplus(time_scale)
    h, hs = h0, []
    for t in range(xs.shape[1]):
        gx = _xw(xs[:, t], wx) + b  # ahead of the chain
        pa = torch.tanh(sp * dts[t]) * INV_LIPSCHITZ_ALPHA
        a = _matvec4(h, wh[:, : 2 * H])
        r = torch.sigmoid(gx[:, :H] + a[:, :H])
        z = torch.sigmoid(gx[:, H : 2 * H] + a[:, H:])
        c = torch.tanh(gx[:, 2 * H :] + _matvec4(r * h, wh[:, 2 * H :]))
        h = h + pa * (1.0 - z) * (c - h) if flow else (1.0 - z) * c + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def _gru_cell_emulation(xs, wx, wh, b, time_scale, dts, w1, b1, w2, b2, flow):
    h0 = torch.zeros(xs.shape[0], wh.shape[0])
    hs = _gru_scan_emulation(xs, h0, wx, wh, b, time_scale, dts, flow)
    return _head(hs[:, -1], w1, b1, w2, b2)


def _pwl(table, x):
    """pwl.cuh pwl_eval: the segment is the truncated TRUE quotient
    (x - x_min) / width (a tensor divisor: PyTorch may divide by a Python
    scalar as a product with its reciprocal), clamped; then slope * x +
    intercept rounded apart, and the end values outside [x_min, x_max]."""
    n = table.slopes.shape[0]
    width = torch.tensor(pwl_width(table), dtype=torch.float32)
    idx = torch.clamp(((x - table.x_min) / width).to(torch.int32), 0, n - 1).long()
    y = table.slopes[idx] * x + table.intercepts[idx]
    y = torch.where(x < table.x_min, torch.full_like(y, table.left), y)
    return torch.where(x > table.x_max, torch.full_like(y, table.right), y)


def _gru_q_scan_emulation(xs, h0, wx, wh, b, tables):
    """warp_cell.cuh's Int8Cell on dequantized weights (each float(q) *
    scale, one rounding), gru_scan_int8.cu's every step's h [B, T, H]: x.Wx
    ahead of the chain without the bias, (x.Wx + h.Wh) + b, PWL sigmoid and
    tanh, the update's products rounded apart."""
    sig, tanh = tables
    H = wh.shape[0]
    h, hs = h0, []
    for t in range(xs.shape[1]):
        gx = _xw(xs[:, t], wx)  # ahead of the chain: x.Wx alone
        a = _matvec4(h, wh[:, : 2 * H])
        r = _pwl(sig, (gx[:, :H] + a[:, :H]) + b[:H])
        z = _pwl(sig, (gx[:, H : 2 * H] + a[:, H:]) + b[H : 2 * H])
        c = _pwl(tanh, (gx[:, 2 * H :] + _matvec4(r * h, wh[:, 2 * H :])) + b[2 * H :])
        h = (1.0 - z) * c + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def _gru_q_cell_emulation(xs, wx, wh, b, w1, b1, w2, b2, tables):
    """The int8 scan from h0 = 0, then Int8Head: the head's biases after
    each layer's sum."""
    h0 = torch.zeros(xs.shape[0], wh.shape[0])
    hs = _gru_q_scan_emulation(xs, h0, wx, wh, b, tables)
    return _head(hs[:, -1], w1, b1, w2, b2)


def _ltc_q_cell_emulation(xs, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, sub_dt, n_sub, sig):
    """warp_cell.cuh's Int8Ltc and Int8Head on dequantized weights: the drive
    x.W_in + bias ahead of the chain, the PWL sigmoid of drive + h.W_rec, and
    every operation of the update rounded apart (no FMA)."""
    B, T, _ = xs.shape
    h = torch.zeros(B, w_rec.shape[0])
    sdt, one = torch.tensor(sub_dt), torch.tensor(1.0)
    for t in range(T):
        drive = _xw(xs[:, t], w_in) + bias  # ahead of the chain
        for _ in range(n_sub):
            f = _pwl(sig, drive + _matvec4(h, w_rec))
            h = (h + (sdt * f) * a) / (one + sdt * (inv_tau + f))
    return _head(h, w1, b1, w2, b2)


def _ltc_cell_emulation(xs, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, sub_dt, n_sub):
    B, T, _ = xs.shape
    h = torch.zeros(B, w_rec.shape[0])
    sdt, one = torch.tensor(sub_dt), torch.tensor(1.0)
    for t in range(T):
        drive = _xw(xs[:, t], w_in) + bias  # ahead of the chain
        for _ in range(n_sub):
            f = torch.sigmoid(drive + _matvec4(h, w_rec))
            num = _fma(sdt * f, a, h)  # h + (sub_dt * f) * a, one FMA
            den = _fma(sdt, inv_tau + f, one)  # 1 + sub_dt * (inv_tau + f), one FMA
            h = num / den
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
    elif hasattr(enc, "w_rec"):  # LTC
        enc = enc._replace(bias=(0.1 * rng.standard_normal(H)).astype(np.float32))
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


@pytest.mark.parametrize("n_sub", [1, 2, 6])
@pytest.mark.parametrize("label,B,T,n,m,H,Dh", SHAPES, ids=[s[0] for s in SHAPES])
def test_ltc_cell_order_matches_jax_kernel(label, B, T, n, m, H, Dh, n_sub):
    jcfg, cfg, jparams, params, xs = _setup(B, T, n, m, H, Dh, "ltc", seed=9, ltc_substeps=n_sub)
    with torch.no_grad():
        out = _ltc_cell_emulation(
            torch.from_numpy(xs), *params.encoder, *head_weights(params, cfg),
            sub_dt=ltc_sub_dt(cfg.dt, n_sub), n_sub=n_sub,
        )  # fmt: skip
    _check(jcfg, cfg, jparams, out, xs)


# the JAX tick tests' geometry and width (tests/test_tick.py TCFG, BASE), and
# serve_mr's (StreamConfig defaults: N=17 windows of T=32; H=32, m=1)
TICK_TEST = dict(buf_len=16, window=8, stride=4, chunk=4, steps_per_tick=0, min_steps=10**9,
                 max_steps=10**9)  # fmt: skip
TICK_CASES = [  # (encoder, m, geometry, hidden, dense_hidden)
    ("gru", 0, TICK_TEST, 8, 16), ("gru", 2, TICK_TEST, 8, 16), ("gru_flow", 0, TICK_TEST, 8, 16),
    ("gru_flow", 2, TICK_TEST, 8, 16), ("gru_flow", 1, {}, 32, 64),
]  # fmt: skip


def _tick_emulation(params, cfg, scfg, buf_y, buf_u, new_y, new_u, mean, scale, theta_prev, seed,
                    active, flow=False, tables=None):  # fmt: skip
    """mr_tick.cu (``tables``: mr_tick_int8.cu on the raw weights quantized
    per slot, with these PWL tables): the rolled buffers, each window's GRU
    scan and head in its own warp, then the leader's readout (tick.cuh
    tick_readout): the windows' first Kc outputs summed in window order and
    divided by N, the EMA's two products rounded apart, the delta."""
    S, C = buf_y.shape[0], new_y.shape[1]
    roll = lambda buf, new: torch.cat([buf[:, C:], new], dim=1)
    buf_y, buf_u = roll(buf_y, new_y), roll(buf_u, new_u)
    Kc, T = cfg.n_coef, scfg.window
    if tables is None:
        wx, wh, b, ts, w1, b1, w2, b2 = tick_weights(params, cfg)
        cell = lambda s, xs: _gru_cell_emulation(xs, wx[s], wh[s], b[s], ts[s], torch.ones(T),
                                                 w1[s], b1[s], w2[s], b2[s], flow=flow)  # fmt: skip
    else:
        wx, wh, w1, w2 = (q.values.float() * q.scale for q in int8_weights(params, cfg, 1))
        b, b1, b2 = params.encoder.b, params.head_b1, params.head_b2
        cell = lambda s, xs: _gru_q_cell_emulation(xs, wx[s], wh[s], b[s], w1[s], b1[s], w2[s],
                                                   b2[s], tables)  # fmt: skip
    one_minus_ema = torch.tensor(1.0 - scfg.ema)
    thetas, deltas = [], []
    for s in range(S):
        xs = window_views((buf_y[s] - mean[s]) / scale[s], T, scfg.stride)
        if cfg.input_dim:
            xs = torch.cat([xs, window_views(buf_u[s], T, scfg.stride)], dim=-1)
        out = cell(s, xs)
        acc = torch.zeros(Kc)
        for w in range(out.shape[0]):
            acc = acc + out[w, :Kc]
        raw = acc / out.shape[0]
        prev = theta_prev[s].reshape(-1)
        th = raw if seed[s] else scfg.ema * prev + one_minus_ema * raw
        delta = (th - prev).abs().max() / (th.abs().max() + 1e-3)
        thetas.append(th)
        deltas.append(delta if active[s] else torch.tensor(float("inf")))
    theta = torch.stack(thetas).reshape(S, cfg.n_terms, cfg.state_dim)
    return buf_y, buf_u, theta, torch.stack(deltas)


@pytest.mark.parametrize("encoder,m,geometry,H,Dh", TICK_CASES,
                         ids=[f"{c[0]}-m{c[1]}-H{c[3]}" for c in TICK_CASES])  # fmt: skip
def test_tick_order_matches_jax_kernel(encoder, m, geometry, H, Dh):
    common = dict(state_dim=3, input_dim=m, order=2, hidden=H, dense_hidden=Dh, dt=0.01,
                  encoder=encoder)  # fmt: skip
    jcfg, cfg = JMRConfig(**common), MRConfig(**common)
    scfg = StreamConfig(**geometry)
    S, n, L, C = 4, 3, scfg.buf_len, scfg.chunk
    rng = np.random.default_rng(11 + m)
    jparams = jax.vmap(lambda k: jinit_mr(k, jcfg))(jax.random.split(jax.random.key(5), S))
    jparams = jax.tree.map(np.asarray, jparams)
    if encoder == "gru_flow":  # a non-zero flow-gate rate, so phi matters
        enc = jparams.encoder._replace(
            time_scale=(0.5 * rng.standard_normal((S, H))).astype(np.float32))
        jparams = jparams._replace(encoder=enc)
    mk = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    ops = [mk(S, L, n), mk(S, L, m), mk(S, C, n), mk(S, C, m), mk(S, n, scale=0.1),
           rng.uniform(0.5, 1.5, (S, n)).astype(np.float32), mk(S, cfg.n_terms, n, scale=0.3),
           np.array([True, False] * (S // 2)), np.array([True] * (S - 1) + [False])]  # fmt: skip
    want = jmr_tick(jax.tree.map(jnp.asarray, jparams), jcfg, scfg, *map(jnp.asarray, ops),
                    interpret=True)  # fmt: skip
    with torch.no_grad():
        got = _tick_emulation(params_from_numpy(jparams), cfg, scfg,
                              *map(torch.from_numpy, ops), flow=encoder == "gru_flow")  # fmt: skip
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # rolled buffers
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)  # theta
    assert np.isinf(got[3][-1].item()) and np.isinf(np.asarray(want[3])[-1])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)  # delta


def _gru_operands(B, T, D, H, seed):
    """GRU weights at initialization scale, a non-zero flow-gate rate and
    bias, xs, a non-zero h0 and variable dts (zeros among them: phi(0) = 0)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    w, b, ts = mk(D + H, 3 * H, scale=(D + H) ** -0.5), mk(3 * H, scale=0.1), mk(H, scale=0.5)
    dts = rng.uniform(0.0, 2.0, T).astype(np.float32)
    dts[::5] = 0.0
    return (w, b, ts), mk(B, T, D), mk(B, H, scale=0.1), dts


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("label,B,T,n,m,H,Dh", SHAPES, ids=[s[0] for s in SHAPES])
def test_gru_scan_order_matches_jax_kernel(label, B, T, n, m, H, Dh, flow):
    """gru_scan.cu's hs at every step, from a non-zero h0 at variable dts."""
    D = n + m
    (w, b, ts), xs, h0, dts = _gru_operands(B, T, D, H, seed=12)
    _, want = jgru_scan(JGRUParams(*map(jnp.asarray, (w, b, ts))), jnp.asarray(xs),
                        jnp.asarray(h0), dts=jnp.asarray(dts), flow=flow, interpret=True)  # fmt: skip
    w, b, ts, xs, h0, dts = map(torch.from_numpy, (w, b, ts, xs, h0, dts))
    with torch.no_grad():
        got = _gru_scan_emulation(xs, h0, w[:D], w[D:], b, ts, dts, flow)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _asymptote_tables():
    """The serving tables with JAX's Pallas kernels' saturation values (0 and
    1, -1 and 1), where the plain versions take the function's values at the
    tables' ends (``tests/test_torch_int8.py`` ``_asymptote_tables``)."""
    sig, tanh = serving_tables()
    return sig._replace(left=0.0, right=1.0), tanh._replace(left=-1.0, right=1.0)


@pytest.mark.parametrize("dispatch", ["reference", "interpret"])
@pytest.mark.parametrize("label,B,T,n,m,H,Dh", SHAPES, ids=[s[0] for s in SHAPES])
def test_int8_scan_order_matches_jax_kernel(label, B, T, n, m, H, Dh, dispatch):
    """gru_scan_int8.cu's hs at every step, from a non-zero h0, against JAX's
    int8 scan: its oracle (``force_reference``) on the serving tables, its
    Pallas kernel (``interpret``) on the tables saturating where that kernel
    does; within 1e-5."""
    D = n + m
    (w, b, ts), xs, h0, _ = _gru_operands(B, T, D, H, seed=14)
    kw = dict(force_reference=True) if dispatch == "reference" else dict(interpret=True)
    _, want = jgru_scan_int8(JGRUParams(*map(jnp.asarray, (w, b, ts))), jnp.asarray(xs),
                             jnp.asarray(h0), **kw)  # fmt: skip
    tables = serving_tables() if dispatch == "reference" else _asymptote_tables()
    w, b, xs, h0 = map(torch.from_numpy, (w, b, xs, h0))
    wx, wh = (q.values.float() * q.scale for q in (quantize_int8(w[:D]), quantize_int8(w[D:])))
    with torch.no_grad():
        got = _gru_q_scan_emulation(xs, h0, wx, wh, b, tables)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# tests/test_torch_int8.py's sweep (m, slots a bank) at the JAX tick tests'
# geometry and width, and serve_mr's geometry (N=17 windows of T=32, H=32, m=1)
INT8_TICK_CASES = [(0, 1, TICK_TEST, 8, 16), (2, 2, TICK_TEST, 8, 16), (1, 1, {}, 32, 64)]


@pytest.mark.parametrize("dispatch", ["reference", "interpret"])
@pytest.mark.parametrize("m,spb,geometry,H,Dh", INT8_TICK_CASES,
                         ids=[f"m{c[0]}-spb{c[1]}-H{c[3]}" for c in INT8_TICK_CASES])  # fmt: skip
def test_int8_tick_order_matches_jax_kernel(m, spb, geometry, H, Dh, dispatch):
    """mr_tick_int8.cu's order against JAX's int8 tick: its oracle
    (``force_reference``) on the serving tables, its Pallas kernel
    (``interpret``) on the tables saturating where that kernel does. Buffers
    exact, theta and delta within 1e-5."""
    common = dict(state_dim=3, input_dim=m, order=2, hidden=H, dense_hidden=Dh, dt=0.01,
                  encoder="gru")  # fmt: skip
    jcfg, cfg = JMRConfig(**common), MRConfig(**common)
    scfg = StreamConfig(**geometry)
    S, n, L, C = 4, 3, scfg.buf_len, scfg.chunk
    rng = np.random.default_rng(21 + m)
    jparams = jax.vmap(lambda k: jinit_mr(k, jcfg))(jax.random.split(jax.random.key(6), S))
    jparams = jax.tree.map(np.asarray, jparams)
    mk = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    ops = [mk(S, L, n), mk(S, L, m), mk(S, C, n), mk(S, C, m), mk(S, n, scale=0.1),
           rng.uniform(0.5, 1.5, (S, n)).astype(np.float32), mk(S, cfg.n_terms, n, scale=0.3),
           np.array([True, False] * (S // 2)), np.array([True] * (S - 1) + [False])]  # fmt: skip
    kw = dict(force_reference=True) if dispatch == "reference" else dict(interpret=True)
    want = jmr_tick(jax.tree.map(jnp.asarray, jparams), jcfg, scfg, *map(jnp.asarray, ops),
                    quant=True, slots_per_bank=spb, **kw)  # fmt: skip
    tables = serving_tables() if dispatch == "reference" else _asymptote_tables()
    with torch.no_grad():
        got = _tick_emulation(params_from_numpy(jparams), cfg, scfg, *map(torch.from_numpy, ops),
                              tables=tables)  # fmt: skip
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # rolled buffers
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5, rtol=0)  # theta
    assert np.isinf(got[3][-1].item()) and np.isinf(np.asarray(want[3])[-1])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=0)  # delta


# (encoder, substeps): the int8 GRU has none
INT8_CELLS = [("gru", 1), ("ltc", 1), ("ltc", 2), ("ltc", 6)]


@pytest.mark.parametrize("dispatch", ["reference", "interpret"])
@pytest.mark.parametrize("encoder,n_sub", INT8_CELLS, ids=[f"{e}-{n}" for e, n in INT8_CELLS])
@pytest.mark.parametrize("label,B,T,n,m,H,Dh", SHAPES, ids=[s[0] for s in SHAPES])
def test_int8_cell_order_matches_jax_kernel(label, B, T, n, m, H, Dh, encoder, n_sub, dispatch):
    """mr_step_int8.cu's and mr_step_ltc_int8.cu's order against JAX's int8
    stage: its oracle (``force_reference``) on the serving tables, its Pallas
    kernel (``interpret``) on the tables saturating where that kernel does;
    within 1e-5."""
    jcfg, cfg, jparams, params, xs = _setup(B, T, n, m, H, Dh, encoder, seed=13,
                                            ltc_substeps=n_sub)  # fmt: skip
    kw = dict(force_reference=True) if dispatch == "reference" else dict(interpret=True)
    jt, js = jmr_step_int8(jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(xs), **kw)
    tables = serving_tables() if dispatch == "reference" else _asymptote_tables()
    cell_a, cell_b, w1, w2 = (q.values.float() * q.scale for q in int8_weights(params, cfg))
    head = (w1, params.head_b1, w2, params.head_b2)
    enc = params.encoder
    with torch.no_grad():
        if encoder == "ltc":
            out = _ltc_q_cell_emulation(
                torch.from_numpy(xs), cell_a, cell_b, enc.bias, enc.a, enc.inv_tau, *head,
                sub_dt=ltc_sub_dt(cfg.dt, n_sub), n_sub=n_sub, sig=tables[0],
            )  # fmt: skip
        else:
            out = _gru_q_cell_emulation(torch.from_numpy(xs), cell_a, cell_b, enc.b, *head, tables)
    theta, shifts = split_out(out, cfg)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jt), atol=1e-5, rtol=0)
    np.testing.assert_allclose(shifts.numpy(), np.asarray(js), atol=1e-5, rtol=0)


def _header_carve(layout: str, D, H, Dh, K, bb, T=0, N=0) -> int:
    """Bytes that ``warp_cell.cuh``'s ``layout`` carves, evaluating each of
    its ``take(...)`` regions (and its head's, ``HeadLayout`` or
    ``HeadQLayout``) as the header writes them, for ``bb`` windows a block
    (the ticks: ``tiling.tick_warps(N)`` warps); int8 regions take whole
    floats (``q_floats``), a PWL table ``PWL_FLOATS``."""
    text = HEADER.read_text()
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", text).group(1))
    warps_max = int(re.search(r"constexpr int kWarps = (\d+);", text).group(1))

    def regions(name):
        body = re.search(rf"struct {name} \{{(.*?)\n\}};", text, re.S).group(1)
        return re.findall(r"(\w+(?:\[\d\])?) = (\w)\.take\((.*?)\);", body), body

    env = dict(D=D, H=H, Dh=Dh, K=K, kChunk=chunk, nu=-(-H // 32), R=max(H, Dh),
               S=tiling.col_stride(H), T=T, N=N, Tc=-(-T // chunk) * chunk, P=PWL_FLOATS,
               q_floats=tiling.q_floats)  # fmt: skip
    pad4 = lambda n: (n + 3) // 4 * 4

    def size(expr):
        return pad4(eval(re.sub(r"\(size_t\)", "", expr), {}, env))

    takes, body = regions(layout)
    assert "head.carve(c, H, Dh, K);" in body
    head, _ = regions(re.search(r"(Head\w*Layout) head;", body).group(1))
    block = sum(size(e) for _, c, e in takes if c == "c") + sum(size(e) for _, _, e in head)
    warp = sum(size(e) for _, c, e in takes if c == "w")
    warps = tiling.tick_warps(N) if layout.startswith("Tick") else min(bb, warps_max)
    return 4 * (block + warps * warp)


@pytest.mark.parametrize("bb", [1, 2, 4, 9])
@pytest.mark.parametrize(
    "D,H,Dh,K", [(2, 32, 64, 12), (8, 64, 128, 12), (3, 48, 40, 7), (2, 8, 16, 13), (1, 5, 3, 2)]
)
def test_cell_carves_match_the_header(D, H, Dh, K, bb):
    assert tiling.mr_step_smem_bytes(D, H, Dh, K, bb) == _header_carve("GruLayout", D, H, Dh, K, bb)
    # gru_scan carves mr_step's layout with no head
    assert tiling.gru_scan_smem_bytes(D, H, bb) == _header_carve("GruLayout", D, H, 0, 0, bb)
    assert tiling.family_smem_bytes("gru_scan", D, H, Dh, K, bb) == tiling.gru_scan_smem_bytes(
        D, H, bb
    )
    assert tiling.node_smem_bytes(D, H, Dh, K, bb) == _header_carve("NodeLayout", D, H, Dh, K, bb)
    assert tiling.ltc_smem_bytes(D, H, Dh, K, bb) == _header_carve("LtcLayout", D, H, Dh, K, bb)
    assert tiling.family_smem_bytes("ltc", D, H, Dh, K, bb) == tiling.ltc_smem_bytes(
        D, H, Dh, K, bb
    )
    assert tiling.family_smem_bytes("gru", D, H, Dh, K, bb) == tiling.mr_step_smem_bytes(
        D, H, Dh, K, bb
    )
    # the int8/PWL stages: int8 weights beside their scales, the PWL tables, the int8 head
    q = tiling.int8_smem_bytes(D, H, Dh, K, bb)
    assert q == _header_carve("GruQLayout", D, H, Dh, K, bb)
    assert q == tiling.family_smem_bytes("gru", D, H, Dh, K, bb, int8=True)
    q = tiling.ltc_int8_smem_bytes(D, H, Dh, K, bb)
    assert q == _header_carve("LtcQLayout", D, H, Dh, K, bb)
    assert q == tiling.family_smem_bytes("ltc", D, H, Dh, K, bb, int8=True)
    # gru_scan_int8 carves mr_step_int8's layout with no head
    q = tiling.gru_scan_int8_smem_bytes(D, H, bb)
    assert q == _header_carve("GruQLayout", D, H, 0, 0, bb)
    assert q == tiling.family_smem_bytes("gru_scan", D, H, Dh, K, bb, int8=True)
    text = HEADER.read_text()
    assert int(re.search(r"constexpr int kMaxUnits = (\d+);", text).group(1)) == tiling.CELL_MAX_UNITS
    assert tiling.cell_warps(bb) == min(bb, 8)
    S = tiling.col_stride(H)  # whole float4s, 4 mod 8: conflict-free float4 reads
    assert S % 4 == 0 and S % 8 == 4 and S >= H
    assert math.gcd(tiling.mr_step_smem_bytes(D, H, Dh, K, bb), 16) == 16  # whole float4s


@pytest.mark.parametrize("N", [1, 3, 8, 9, 17, 64, 65, 72])
@pytest.mark.parametrize("D,H,Dh,Ko,T", [(4, 32, 64, 45, 32), (3, 8, 16, 27, 8), (5, 48, 40, 7, 20),
                                         (8, 64, 128, 45, 33)])  # fmt: skip
def test_tick_carve_matches_the_header(D, H, Dh, Ko, T, N):
    """tick_smem_bytes is one block of a slot's cluster: ceil(N / 8) blocks, at
    most the portable 8, the windows spread evenly over them (past 64 the
    warps take the windows in turn); the int8 tick's block (``TickQLayout``)
    the same, with int8 weights beside their scales, the PWL tables and the
    int8 head."""
    assert tiling.tick_smem_bytes(D, H, Dh, Ko, N, T) == _header_carve(
        "TickLayout", D, H, Dh, Ko, 0, T=T, N=N
    )
    q = tiling.tick_smem_bytes(D, H, Dh, Ko, N, T, int8=True)
    assert q == _header_carve("TickQLayout", D, H, Dh, Ko, 0, T=T, N=N)
    assert 0 < q < tiling.tick_smem_bytes(D, H, Dh, Ko, N, T) and math.gcd(q, 16) == 16
    text = HEADER.read_text()
    assert int(re.search(r"constexpr int kMaxCluster = (\d+);", text).group(1)) == tiling.MAX_CLUSTER
    cs, wpb = tiling.tick_cluster(N), tiling.tick_warps(N)
    assert cs == min(-(-N // 8), 8) and wpb <= 8
    assert cs * wpb >= min(N, 64) and (cs - 1) * wpb < N  # every block holds a window
    assert math.gcd(tiling.tick_smem_bytes(D, H, Dh, Ko, N, T), 16) == 16
