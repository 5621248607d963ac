"""The wide GRU-flow scan's design (``csrc/gru_scan_wide.cu``), checked on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it to its
plain version there). Here, without a card:

- its arithmetic order is emulated in float32, an FMA being a float64 product
  and sum rounded once to float32, and held against the JAX package's scan as
  its own tests run it on the CPU (``repro.kernels.gru_scan.ops.gru_scan(...,
  interpret=True)``, ``tests/test_kernels_gru.py:31``) within 1e-4, at
  merinda-gru's width (D = H = 512), flow on and off, from a non-zero h0: x.Wx + b
  through the skinny GEMM's order (B * T <= ``kSkinnyRows``: warp w sums
  k = w, w + 8, ... and the warps' sums are added in warp order) or the tiled
  GEMM's (k in order); each lane's 16 k (k = 128 p + 4 lane + e) of a column in
  increasing k, the warp's sums finished by the halving ``reduce_scatter``, a
  warp owning 4 consecutive units;
- its exchange protocol is run by a simulation of 16 blocks of 8 warps in a
  seeded random interleaving that obeys only the mbarriers (arrive.expect_tx,
  complete_tx on each push's landing, try_wait.parity) and the kernel's re-arm
  order, the pushes landing at random later times: every read of h and of r*h
  must see the step it should, no push may land in a buffer a warp of the
  block has yet to finish reading, and nothing may deadlock. Two broken
  protocols (one buffer in place of two by parity; never re-armed) must fail;
- ``tiling.gru_scan_wide_smem_bytes`` and ``tiling.py``'s mirrored constants
  against the source's ``wide::Layout`` and ``constexpr``s, read from the file.

Inputs are made with numpy from a seed.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.neural_flow import GRUParams as JGRUParams
from repro.kernels.gru_scan.ops import gru_scan as jgru_scan
from repro_torch.core.neural_flow import INV_LIPSCHITZ_ALPHA, softplus
from repro_torch.kernels.mr_step import tiling

TOL = dict(atol=1e-4, rtol=1e-4)
SOURCE = Path(tiling.__file__).resolve().parents[1] / "csrc" / "gru_scan_wide.cu"


def _constants() -> dict:
    """The source's ``wide::`` integer and boolean ``constexpr``s."""
    env = {}
    for decl in re.findall(r"constexpr (?:int|bool) ([^;]+);", SOURCE.read_text()):
        for name, expr in (d.split(" = ", 1) for d in re.split(r",\s*(?=\w+ = )", decl)):
            expr = re.sub(r"(\w+) \? (\w+) : (.+)", r"(\2 if \1 else \3)", expr)
            expr = expr.replace("true", "True").replace("false", "False").replace("/", "//")
            env[name] = eval(expr, {}, dict(env))
    return env


WIDE = _constants()
LANES, PASS, PASSES = 32, WIDE["kPass"], WIDE["kPasses"]
WARPS, UNITS, CLUSTER = WIDE["kWarps"], WIDE["kUnits"], WIDE["kCluster"]


def _fma(a, b, c):
    """fmaf: the exact product and sum, rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _gx(x2d, wx, b):
    """gx [M, N] = x2d . wx + b in the order of the kernel B * T picks."""
    M, K = x2d.shape
    if M <= WIDE["kSkinnyRows"]:  # gru_wide_gx_skinny_kernel
        parts = []
        for w in range(WARPS):
            acc = torch.zeros(M, wx.shape[1])
            for k in range(w, K, WARPS):
                acc = _fma(x2d[:, k : k + 1], wx[k], acc)
            parts.append(acc)
        s = parts[0]
        for part in parts[1:]:
            s = s + part
        return s + b
    acc = torch.zeros(M, wx.shape[1])  # gru_wide_gx_kernel
    for k in range(K):
        acc = _fma(x2d[:, k : k + 1], wx[k], acc)
    return acc + b


def _reduce_scatter(v):
    """``wide::reduce_scatter`` over the lane axis of v [..., 32, NV]: the total
    of sum i (the value lane i returns)."""
    nv = v.shape[-1]
    lanes = torch.arange(LANES)
    off = 16
    while off >= nv:
        v = v + v[..., lanes ^ off, :]
        off //= 2
    off = nv // 2
    while off >= 1:
        upper = ((lanes & off) != 0)[:, None]
        send = torch.where(upper, v[..., :off], v[..., off : 2 * off])
        keep = torch.where(upper, v[..., off : 2 * off], v[..., :off])
        v = keep + send[..., lanes ^ off, :]
        off //= 2
    return v[..., torch.arange(nv), 0]


def _products(rows, w, cols):
    """Each warp's sums of ``cols`` (per warp: [warps, NV] column indices of w)
    against rows [B, Hmax]: the lanes' partial sums in increasing k, then the
    warp's reduce_scatter; [B, warps, NV]."""
    k_of = torch.tensor([[p * PASS + 4 * lane + e for p in range(PASSES) for e in range(4)]
                         for lane in range(LANES)])  # fmt: skip
    acc = torch.zeros(rows.shape[0], cols.shape[0], LANES, cols.shape[1])
    for i in range(4 * PASSES):
        wk = w[k_of[:, i]][:, cols]  # [32 lanes, warps, NV]
        hk = rows[:, k_of[:, i]]  # [B, 32 lanes]
        acc = _fma(wk.permute(1, 0, 2)[None], hk[:, None, :, None], acc)
    return _reduce_scatter(acc)


def _wide_emulation(xs, h0, wx, wh, b, time_scale, dts, flow):
    """gru_scan_wide.cu at kRows = 1: every step's h [B, T, H]."""
    B, T, D = xs.shape
    H = wh.shape[0]
    hmax = CLUSTER * UNITS
    wp = torch.zeros(hmax, 3 * hmax)  # wh with rows and columns padded to the cluster's width
    for g in range(3):
        wp[:H, g * hmax : g * hmax + H] = wh[:, g * H : (g + 1) * H]
    gx = _gx(xs.reshape(B * T, D), wx, b).reshape(B, T, 3, H)
    gx = torch.nn.functional.pad(gx, (0, hmax - H))  # [B, T, 3, hmax]
    unit0 = torch.arange(0, hmax, UNITS // WARPS)  # every warp's first unit
    units = unit0[:, None] + torch.arange(UNITS // WARPS)  # [warps, 4]
    rz_cols = torch.cat([units, hmax + units], dim=1)  # r of 4 units, then z
    c_cols = 2 * hmax + units
    sp = torch.nn.functional.pad(softplus(time_scale), (0, hmax - H))
    h = torch.nn.functional.pad(h0, (0, hmax - H))
    hs = []
    for t in range(T):
        pa = torch.tanh(sp * dts[t]) * INV_LIPSCHITZ_ALPHA
        s = _products(h, wp, rz_cols)  # [B, warps, 8]
        gates = 1.0 / (1.0 + torch.exp(-(gx[:, t, :2].reshape(B, 2, -1, 4).permute(0, 2, 1, 3)
                                          .reshape(B, -1, 8) + s)))  # fmt: skip
        r, z = gates[..., :4].reshape(B, hmax), gates[..., 4:].reshape(B, hmax)
        rh = r * h
        cand = torch.tanh(gx[:, t, 2] + _products(rh, wp, c_cols).reshape(B, hmax))
        if flow:
            h = _fma(pa * (1.0 - z), cand - h, h)
        else:
            h = (1.0 - z) * cand + z * h
        h[:, H:] = 0.0
        hs.append(h[:, :H])
    return torch.stack(hs, 1)


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("T", [4, 12], ids=["skinny gx", "tiled gx"])
def test_wide_order_matches_jax_kernel(T, flow):
    """D = H = 512, B = 2: at T = 4 (B * T = 8) x.Wx + b in the skinny GEMM's
    order, at T = 12 (24) in the tiled GEMM's; every step's h within 1e-4."""
    B, D, H = 2, 512, 512
    assert (B * 4 <= WIDE["kSkinnyRows"]) and (B * 12 > WIDE["kSkinnyRows"])
    rng = np.random.default_rng(27 + T)
    mk = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    w, b, ts = mk(D + H, 3 * H, scale=(D + H) ** -0.5), mk(3 * H, scale=0.1), mk(H, scale=0.3)
    xs, h0 = mk(B, T, D), mk(B, H, scale=0.5)
    dts = rng.uniform(0.25, 2.0, T).astype(np.float32)
    _, want = jgru_scan(JGRUParams(*map(jnp.asarray, (w, b, ts))), jnp.asarray(xs),
                        jnp.asarray(h0), dts=jnp.asarray(dts), flow=flow, interpret=True)  # fmt: skip
    w, b, ts, xs, h0, dts = map(torch.from_numpy, (w, b, ts, xs, h0, dts))
    with torch.no_grad():
        got = _wide_emulation(xs, h0, w[:D], w[D:], b, ts, dts, flow)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reduce_scatter_emulation_sums_every_vector():
    """The emulated ``reduce_scatter`` leaves sum i's total in lane i (against a
    float64 sum), at the three widths the kernel uses (kRows = 1, 2, 4)."""
    rng = np.random.default_rng(3)
    for nv in (4, 8, 16, 32):
        v = torch.from_numpy(rng.standard_normal((5, LANES, nv)).astype(np.float32))
        np.testing.assert_allclose(_reduce_scatter(v).numpy(), v.double().sum(1).numpy(),
                                   rtol=1e-5, atol=1e-5)  # fmt: skip


class _Barrier:
    """An mbarrier at an arrival count of 1: its phase, pending arrivals and tx."""

    def __init__(self, on_complete):
        self.phase, self.pending, self.tx = 0, 1, 0
        self.on_complete = on_complete

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase, self.pending = self.phase + 1, 1
            self.on_complete()

    def arrive_expect_tx(self, n):
        self.tx += n
        self.pending -= 1
        assert self.pending >= 0, "an arrival on a phase that had its one"
        self._complete()

    def complete_tx(self, n):
        self.tx -= n
        self._complete()

    def passed(self, parity):
        """try_wait.parity: the phase of that parity has completed."""
        return (self.phase & 1) != parity


PROTOCOLS = {  # buffer and barrier of h_t and of r*h_t, the parity a wait passes on, re-armed
    "as built": dict(h=lambda t: t % 2, h_par=lambda t: ((t - 1) >> 1) & 1,
                     rh=lambda t: t % 2, rh_par=lambda t: (t >> 1) & 1, rearm=True),
    "one buffer": dict(h=lambda t: 0, h_par=lambda t: (t - 1) & 1,
                       rh=lambda t: 0, rh_par=lambda t: t & 1, rearm=True),
    "never re-armed": dict(h=lambda t: t % 2, h_par=lambda t: ((t - 1) >> 1) & 1,
                           rh=lambda t: t % 2, rh_par=lambda t: (t >> 1) & 1, rearm=False),
}  # fmt: skip


def _run_protocol(proto, T, seed):
    """The exchange of ``gru_wide_kernel`` (kRows = 1) in a random interleaving.
    Each warp of each block runs the kernel's sequence a step: wait for h_t
    (t > 0; thread 0 re-arms), read h_t, push r*h_t to every block, wait for
    r*h_t (thread 0 re-arms), read r*h_t and its own units of h_t, push h_{t+1}
    (t + 1 < T). A push lands in a random later turn. Raises AssertionError on a
    stale read, a push into a buffer still being read, or a deadlock."""
    rng = np.random.default_rng(seed)
    nb, nw, slots = CLUSTER, WARPS, CLUSTER * WARPS
    # buf[kind][block][buffer][slot] = the step whose values the slot holds (-1: none)
    buf = {kind: np.full((nb, 2, slots), -1) for kind in ("h", "rh")}
    buf["h"][:, proto["h"](0)] = 0  # h_0, staged by each block
    waiting = set()  # warps whose barrier has not passed since they last looked
    bars = {(kind, blk, i): _Barrier(waiting.clear)
            for kind in ("h", "rh") for blk in range(nb) for i in (0, 1)}  # fmt: skip
    for b in bars.values():  # armed before the first cluster.sync()
        b.arrive_expect_tx(slots)
    done_reading = {kind: np.full((nb, nw), -1) for kind in ("h", "rh")}  # the last step read
    in_flight = []  # (kind, dest block, buffer, slot, step)

    def read(kind, blk, w, i, t, own=False):
        got = buf[kind][blk, i, blk * nw + w] if own else buf[kind][blk, i]
        assert (got == t).all(), f"block {blk} warp {w} read {kind} of steps {set(got)} at {t}"

    def program(blk, w):
        for t in range(T):
            if t > 0:
                i = proto["h"](t)
                bar = bars["h", blk, i]
                while not bar.passed(proto["h_par"](t)):
                    yield "wait"
                if w == 0 and proto["rearm"]:
                    bar.arrive_expect_tx(slots)
            read("h", blk, w, proto["h"](t), t)
            yield "read"
            i = proto["rh"](t)
            in_flight.extend(("rh", d, i, blk * nw + w, t) for d in range(nb))
            yield "push"
            bar = bars["rh", blk, i]
            while not bar.passed(proto["rh_par"](t)):
                yield "wait"
            if w == 0 and proto["rearm"]:
                bar.arrive_expect_tx(slots)
            read("rh", blk, w, i, t)
            read("h", blk, w, proto["h"](t), t, own=True)
            done_reading["h"][blk, w] = done_reading["rh"][blk, w] = t
            yield "read"
            if t + 1 < T:
                i = proto["h"](t + 1)
                in_flight.extend(("h", d, i, blk * nw + w, t + 1) for d in range(nb))
                yield "push"

    agents = {(blk, w): program(blk, w) for blk in range(nb) for w in range(nw)}
    while agents or in_flight:
        runnable = [a for a in agents if a not in waiting]
        if in_flight and (not runnable or rng.random() < 0.5):
            kind, d, i, slot, t = in_flight.pop(int(rng.integers(len(in_flight))))
            old = buf[kind][d, i, slot]
            assert (done_reading[kind][d] >= old).all(), (
                f"{kind}_{t} landed in block {d}'s buffer {i} while a warp still reads "
                f"{kind}_{old}")
            buf[kind][d, i, slot] = t
            bars[kind, d, i].complete_tx(1)
            continue
        assert runnable, f"deadlock: {len(agents)} warps wait and no push is in flight"
        a = runnable[int(rng.integers(len(runnable)))]
        op = next(agents[a], None)
        if op is None:
            del agents[a]
        elif op == "wait":
            waiting.add(a)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exchange_protocol_keeps_every_step_apart(seed):
    """Over T = 8 steps, in a seeded random interleaving of 16 blocks of 8 warps:
    every read sees its step and no push lands in a buffer still being read."""
    _run_protocol(PROTOCOLS["as built"], T=8, seed=seed)


@pytest.mark.parametrize("broken", ["one buffer", "never re-armed"])
def test_the_protocol_check_catches_a_broken_exchange(broken):
    """One buffer for h and one for r*h lets a push overwrite values a slower
    warp has yet to read; a barrier never re-armed deadlocks at its second
    phase: the simulation fails both, in at least one of four interleavings."""
    failures = 0
    for seed in range(4):
        try:
            _run_protocol(PROTOCOLS[broken], T=8, seed=seed)
        except AssertionError:
            failures += 1
    assert failures > 0


def test_carve_matches_the_source_layout():
    """``tiling.gru_scan_wide_smem_bytes`` equals ``wide::Layout``'s total,
    evaluated from the source's expressions, at every width."""
    body = re.search(r"struct Layout \{(.*?)\n\};", SOURCE.read_text(), re.S).group(1)
    env = dict(WIDE)
    for name, expr in re.findall(r"^\s+(\w+) = ([^;]+);$", body, re.M):
        env[name] = eval(expr, {}, env)
    for H in (257, 300, 512):
        assert tiling.gru_scan_wide_smem_bytes(H) == 4 * env["total"]
    assert env["bar"] * 4 % 8 == 0 and env["rh"] * 4 % 16 == 0  # mbarriers, float4 rows


def test_tiling_mirrors_the_source_constants():
    assert tiling.WIDE_CLUSTER == WIDE["kCluster"] and tiling.WIDE_UNITS == WIDE["kUnits"]
    assert tiling.WIDE_MAX_HIDDEN == WIDE["kMaxHidden"] == 512
    assert tiling.WIDE_SKINNY_ROWS == WIDE["kSkinnyRows"]
    assert WIDE["kRows"] == 1 and WIDE["kWarpUnits"] == 4  # a warp's units: one float4
