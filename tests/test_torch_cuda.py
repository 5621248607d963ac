"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is False: a hand-written CUDA kernel has no CPU mode. The file imports no JAX,
so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The banked service tick (``mr_tick``) is held to its plain version as the
JAX tick tests hold theirs: rolled buffers bit for bit, theta and delta
within 1e-5, and a banked service in lockstep with a composite one.

The device-resident control plane runs the banked tick's kernels on a new
path: its ticks between snapshots (an arrival's enqueue, evictions and
refills included) run under ``torch.cuda.set_sync_debug_mode("error")``, so
any wait for the card fails them; its outcomes equal the host plane's, and a
service snapshot restores into a fresh service on the card bit for bit. The
SR baselines (SINDy, PINN-SR) on the card agree with the CPU port. A slot
mesh of 2 (the card listed twice) equals mesh 1 on both planes, launches the
tick kernel once a shard a tick (a fused int8_pwl service: the slot-axis
``mr_step`` once a shard a step, ``mr_step_int8`` once an eviction), and its
ticks between snapshots never wait for the card; the ``ServiceSupervisor`` drill restores onto the mesh of 1 and
frees the lost shard's memory, and a same-mesh restore replays bit for bit.

The ``gru`` LM family's wide GRU-flow scan (``csrc/gru_scan_wide.cu``, H > 256)
against ``gru_scan_reference`` within 1e-4 at the merinda-gru serve path's
shapes, T = 1 and 37, flow on and off, from a non-zero h0, decode steps on both
sides of the skinny x.Wx + b's threshold, and its builds at 2
and 4 rows a cluster (``launch/kernel_phases.py``'s patches) within 1e-6 of
the one it is built at; ``gru_scan`` launches the form its width takes (read
from both counters) and refuses a width neither takes; merinda-gru's prefill
and decode launch the scan once a layer, within 1e-4 of ``force_reference``.

The LM zoo's kernels: ``ssd_scan`` against ``ssd_chunked`` within 5e-5 in
float32 (``tests/test_kernels_ssd.py:48``), and on bf16 inputs against
``ssd_chunked`` on float32 copies (what the Pallas kernel computes) within one
bf16 rounding, at every chunk and from a carried state; ``flash_attention``
against the oracle within 2e-5 in float32
(``tests/test_kernels_flash.py``), in bf16 against the oracle on float32 copies
within one bf16 rounding (2^-8 of the value plus 1e-4), and on rows with no
unmasked key against the Pallas kernel's values (0, or the mean of v over
the masked keys of the tiles it does not skip). Both at the attention LM
paths' shapes (zamba2's H = 64, N = 64 scan; its MHA Dh = 64 and qwen2.5-3b's
GQA 16/2 Dh = 128 attention, S = 1,024 and 1,000), and zamba2's and
qwen2.5-3b's SMOKE prefill and decode on the card within 1e-4 of
``force_reference`` in float32, with their launch counts; at those widths the
float32 ``ssd_scan`` within 1e-6 of the largest magnitude of ``ssd_chunked``'s
(the same prefix-sum order). ``flash_attention``
also at the layouts of the MoE, VLM and audio paths (mixtral's window of
4,096 over a 4,160-token prompt at block 64, phi-3-vision's Dh = 96,
seamless-m4t's non-causal encoder over 4,096 frames and its cross-attention
of 256 and of 1 query against them), and those four families' SMOKE models
through the kernels within 1e-4 of ``force_reference``, with their launch
counts.

LM training (``models/model.py`` ``train_loss`` under ``remat="full"``): every
architecture's SMOKE model in float32, one forward and backward through the
kernels against ``force_reference``: the loss within 1e-5 of itself and every
gradient leaf within 1e-3 of its largest magnitude, with the kernels' op calls
of the step exactly (a checkpointed layer's kernel twice: forward and
recompute; the hybrid's shared block once an application).

Plan analysis: ``mr_step_ltc`` and ``mr_step_node`` built with their substep
loop unrolled 2 and 6 times (``launch/kernel_phases.py``'s patches) equal the
loop at 1 bit for bit, and the kernels, built for 1 only, refuse another
factor; every kernel's exported carve equals ``tiling.py``'s model;
service plans audit clean on the card (R2 against the carve, R3 under
sync-debug mode "error" on the host and device planes); a measured tune
times every candidate and a warm one times nothing.

The int8/PWL serving kernels (``gru_scan_int8``, ``mr_step_int8``,
``mr_step_ltc_int8``, ``mr_tick_int8``) are held to their plain versions
within 1e-5 (the tick's buffers bit for bit, the warp-cell stages' tiles bit
for bit), and each must differ from its fp32 twin by at least 1e-4, so a
kernel that skipped the quantization fails.

Tolerance: <= 1e-4 in float32, the JAX package's bound for its fused kernels;
the kernel sums the gate products in another order than the plain version.
The head's activation step is checked at the coarse format Q2.3, which moves
the output by ~1e-2 (at the QAT run's Q4.10 the whole step is within the
tolerance). There a window whose normalized summary lies within 1e-5 of a
rounding threshold may round the other way in the kernel; such windows are
left out of that comparison, and at least three quarters must remain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import merinda
from repro_torch.core.stream import StreamConfig
from repro_torch.core.ltc import LTCParams, ltc_scan, ltc_sub_dt
from repro_torch.core.neural_flow import GRUParams
from repro_torch.core.node_mr import NodeEncoderParams, node_scan, node_sub_dt
from repro_torch.core.quant import QuantConfig, quantize_int8, serving_packs, serving_tables
from repro_torch.kernels import runtime as rt
from repro_torch.core import engine
from repro_torch.kernels.gru_scan.ops import (
    gru_scan,
    gru_scan_cuda,
    gru_scan_int8,
    gru_scan_int8_cuda,
    gru_scan_slots_cuda,
    gru_scan_wide_cuda,
)
from repro_torch.kernels.gru_scan.ref import gru_scan_int8_reference, gru_scan_reference
from repro_torch.kernels.mr_step.ops import (
    mr_step,
    mr_step_cuda,
    mr_step_int8,
    mr_step_int8_cuda,
    mr_step_ltc_cuda,
    mr_step_ltc_int8_cuda,
    mr_step_ltc_slots_cuda,
    mr_step_node_cuda,
    mr_step_node_slots_cuda,
    mr_step_slots_cuda,
)
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ref import (
    mr_step_ltc_reference,
    mr_step_node_reference,
    mr_step_reference,
)
from repro_torch.kernels.mr_step.tick import mr_tick, mr_tick_cuda, mr_tick_int8_cuda
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_stack, tree_unflatten
from repro_torch.configs import get_config
from repro_torch.configs.base import ported_archs as lm_archs
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_cuda
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models import model as lm
from repro_torch.models.attention import prefill_block

TOL = dict(atol=1e-4, rtol=1e-4)
COARSE_BITS = (2, 3)
MARGIN = 1e-5
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    rt.pin_fp32_matmul()
    return torch.device("cuda")


def _settled(h, act_bits=COARSE_BITS):
    """Windows [B] whose RMS-normed summary h lies at least MARGIN from every
    rounding threshold inside the Qm.n grid's range."""
    i, f = act_bits
    h = h.double()
    y = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + merinda.RMS_EPS) * 2.0**f
    lo, hi = -(2.0 ** (i + f - 1)), 2.0 ** (i + f - 1) - 1
    near = ((y - y.floor() - 0.5).abs() < MARGIN * 2.0**f) & (y > lo) & (y < hi)
    return ~near.any(dim=-1)


def _assert_act_step(out_q, out, want_q, h):
    """The kernel's Qm.n step moves its output, and matches the plain one."""
    assert (out_q - out).abs().max().item() >= 10 * TOL["atol"]
    keep = _settled(h)
    assert 4 * int(keep.sum()) >= 3 * len(keep)
    torch.testing.assert_close(out_q[keep], want_q[keep], **TOL)


def _operands(B, T, D, H, Dh, K, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(device)
    return (
        mk(B, T, D),
        mk(B, H, scale=0.1),
        mk(D, 3 * H, scale=(D + H) ** -0.5),
        mk(H, 3 * H, scale=(D + H) ** -0.5),
        mk(3 * H, scale=0.1),
        mk(H, scale=0.5),
        torch.ones(T, device=device),
        mk(H, Dh, scale=H**-0.5),
        mk(Dh, scale=0.1),
        mk(Dh, K, scale=0.1 * Dh**-0.5),
        mk(K, scale=0.1),
    )


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize(
    "B,T,D,H,Dh,block_b",
    [(64, 32, 2, 32, 64, 1), (193, 32, 2, 32, 64, 1), (8, 33, 3, 64, 128, 2), (6, 5, 2, 8, 16, 3),
     (8, 20, 3, 48, 64, 4), (16, 33, 2, 32, 64, 4)],
)  # fmt: skip
def test_kernels_match_plain(dev, flow, B, T, D, H, Dh, block_b):
    """H=48 takes the warp-cell kernels' generic (runtime-H) instantiation;
    block_b=4 puts four windows' warps in one block."""
    ops = _operands(B, T, D, H, Dh, 12, dev)
    before = (mr_step_cuda.launches, gru_scan_cuda.launches)
    out = mr_step_cuda(*ops, flow=flow, block_b=block_b)
    out_q = mr_step_cuda(*ops, flow=flow, block_b=block_b, act_bits=COARSE_BITS)
    hs = gru_scan_cuda(*ops[:7], flow=flow, block_b=block_b)
    torch.cuda.synchronize()
    assert (mr_step_cuda.launches, gru_scan_cuda.launches) == (before[0] + 2, before[1] + 1)
    torch.testing.assert_close(out, mr_step_reference(*ops, flow=flow), **TOL)
    want_hs = gru_scan_reference(*ops[:7], flow=flow)
    torch.testing.assert_close(hs, want_hs, **TOL)
    want_q = mr_step_reference(*ops, flow=flow, act_bits=COARSE_BITS)
    _assert_act_step(out_q, out, want_q, want_hs[:, -1])


def _substep_operands(family, B, T, D, H, Dh, K, device, seed=0):
    """The LTC or NODE stage's operands at initialization scale."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(device)
    head = (mk(H, Dh, scale=H**-0.5), mk(Dh, scale=0.1), mk(Dh, K, scale=0.1 * Dh**-0.5),
            mk(K, scale=0.1))  # fmt: skip
    xs, h0 = mk(B, T, D), mk(B, H, scale=0.1)
    if family == "ltc":
        cell = (mk(D, H, scale=D**-0.5), mk(H, H, scale=H**-0.5), mk(H, scale=0.1),
                mk(H, scale=0.5), 0.5 + mk(H, scale=0.1).abs())  # fmt: skip
    else:
        cell = (mk(H, H, scale=H**-0.5), mk(H, scale=0.1), mk(H, H, scale=0.1 * H**-0.5),
                mk(H, scale=0.1), mk(D, H, scale=D**-0.5), mk(H, scale=0.1))  # fmt: skip
    return (xs, h0, *cell, *head)


SUBSTEP = {
    "ltc": (mr_step_ltc_cuda, mr_step_ltc_reference, ltc_sub_dt),
    "node": (mr_step_node_cuda, mr_step_node_reference, node_sub_dt),
}


@pytest.mark.parametrize("act_bits", [None, COARSE_BITS], ids=["fp32", "act_bits"])
@pytest.mark.parametrize("n_substeps", [1, 2, 6])
@pytest.mark.parametrize(
    "B,T,D,H,Dh,block_b",
    [(64, 32, 2, 32, 64, 1), (8, 9, 3, 64, 128, 2), (8, 20, 3, 48, 64, 4), (16, 33, 2, 32, 64, 4)],
)
@pytest.mark.parametrize("family", ["ltc", "node"])
def test_substep_kernels_match_plain(dev, family, B, T, D, H, Dh, block_b, n_substeps, act_bits):
    """The last two shapes: the generic instantiation (H=48) and four windows
    a block, of both warp-cell kernels."""
    kernel, reference, sub_dt = SUBSTEP[family]
    ops = _substep_operands(family, B, T, D, H, Dh, 12, dev)
    kw = dict(sub_dt=sub_dt(0.05, n_substeps), n_substeps=n_substeps, block_b=block_b)
    before = kernel.launches
    out = kernel(*ops, **kw, act_bits=act_bits)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = reference(*ops, dt=0.05, n_substeps=n_substeps, act_bits=act_bits)
    if act_bits is None:
        torch.testing.assert_close(out, want, **TOL)
        return
    cell = LTCParams(*ops[2:7]) if family == "ltc" else NodeEncoderParams(*ops[2:8])
    scan = ltc_scan if family == "ltc" else node_scan
    h, _ = scan(cell, ops[0], ops[1], dt=0.05, n_substeps=n_substeps)
    _assert_act_step(out, kernel(*ops, **kw), want, h)


@pytest.mark.parametrize("H", [8, 32, 48, 64])
def test_warp_cells_do_not_depend_on_the_tile(dev, H):
    """mr_step, mr_step_ltc and mr_step_node give every window the same output
    whatever its block holds: one warp a window, no data shared between
    windows (a tile of 9 runs its windows on 8 warps, the ninth after the
    first). The LTC is held bit for bit."""
    B, T, D, Dh, K = 36, 21, 3, 40, 7
    ops = _operands(B, T, D, H, Dh, K, dev, seed=4)
    node = _substep_operands("node", B, T, D, H, Dh, K, dev, seed=5)
    ltc = _substep_operands("ltc", B, T, D, H, Dh, K, dev, seed=6)
    kw = dict(sub_dt=node_sub_dt(0.05, 6), n_substeps=6)
    ltc_kw = dict(sub_dt=ltc_sub_dt(0.05, 6), n_substeps=6)
    outs = {bb: (mr_step_cuda(*ops, flow=True, block_b=bb), mr_step_node_cuda(*node, **kw, block_b=bb),
                 mr_step_ltc_cuda(*ltc, **ltc_kw, block_b=bb))
            for bb in (1, 2, 3, 4, 9)}  # fmt: skip
    torch.cuda.synchronize()
    for bb, (out, out_node, out_ltc) in outs.items():
        torch.testing.assert_close(out, outs[1][0], atol=1e-6, rtol=0, msg=f"mr_step block_b={bb}")
        torch.testing.assert_close(out_node, outs[1][1], atol=1e-6, rtol=0,
                                   msg=f"mr_step_node block_b={bb}")  # fmt: skip
        torch.testing.assert_close(out_ltc, outs[1][2], atol=0, rtol=0,
                                   msg=f"mr_step_ltc block_b={bb}")  # fmt: skip
    torch.testing.assert_close(outs[1][0], mr_step_reference(*ops, flow=True), **TOL)
    want = mr_step_node_reference(*node, dt=0.05, n_substeps=6)
    torch.testing.assert_close(outs[1][1], want, **TOL)
    want = mr_step_ltc_reference(*ltc, dt=0.05, n_substeps=6)
    torch.testing.assert_close(outs[1][2], want, **TOL)


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("H", [8, 32, 48, 64])
def test_gru_scan_does_not_depend_on_the_tile(dev, H, flow):
    """gru_scan runs mr_step's warp cell without the head: every window's hs
    is the same bit for bit whatever its block holds (a tile of 9 runs its
    windows on 8 warps, the ninth after the first), from a non-zero h0, and
    within 1e-4 of the plain version; H=48 is the generic instantiation."""
    B, T, D = 36, 21, 3
    ops = _operands(B, T, D, H, 16, 4, dev, seed=9)[:7]
    before = gru_scan_cuda.launches
    outs = {bb: gru_scan_cuda(*ops, flow=flow, block_b=bb) for bb in (1, 2, 3, 4, 9)}
    torch.cuda.synchronize()
    assert gru_scan_cuda.launches == before + 5
    for bb, hs in outs.items():
        torch.testing.assert_close(hs, outs[1], atol=0, rtol=0, msg=f"gru_scan block_b={bb}")
    torch.testing.assert_close(outs[1], gru_scan_reference(*ops, flow=flow), **TOL)


def test_ltc_takes_a_tile_past_a_thousand_threads(dev):
    """The warp cell gives a window a warp, not a thread a unit: 32 windows of
    H = 64 (2,048 (window, unit) pairs) in one block of 8 warps, each equal bit
    for bit to its one-window block and within 1e-4 of the plain version."""
    B, T, D, H, Dh, K = 64, 12, 2, 64, 128, 12
    ops = _substep_operands("ltc", B, T, D, H, Dh, K, dev, seed=7)
    kw = dict(sub_dt=ltc_sub_dt(0.05, 6), n_substeps=6)
    out = mr_step_ltc_cuda(*ops, **kw, block_b=32)
    one = mr_step_ltc_cuda(*ops, **kw, block_b=1)
    torch.cuda.synchronize()
    assert 32 * H > 1024
    torch.testing.assert_close(out, one, atol=0, rtol=0)
    torch.testing.assert_close(out, mr_step_ltc_reference(*ops, dt=0.05, n_substeps=6), **TOL)


def test_variable_dts_match_plain(dev):
    ops = list(_operands(4, 6, 2, 16, 32, 12, dev))
    ops[6] = torch.tensor([1.0, 0.0, 0.5, 2.0, 0.0, 1.0], device=dev)
    hs = gru_scan_cuda(*ops[:7], flow=True, block_b=1)
    torch.testing.assert_close(hs, gru_scan_reference(*ops[:7], flow=True), **TOL)
    out = mr_step_cuda(*ops, flow=True, block_b=2)  # phi(t) computed ahead of the chain
    torch.testing.assert_close(out, mr_step_reference(*ops, flow=True), **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ops = list(_operands(4, 5, 2, 8, 16, 12, dev))
    bad = {
        "dtype": ops[0].double(),
        "contiguity": ops[0].transpose(0, 1).contiguous().transpose(0, 1),
        "shape": ops[0][:, :, :1],
    }
    for what, xs in bad.items():
        with pytest.raises(ValueError):
            mr_step_cuda(xs, *ops[1:], flow=True, block_b=1)
    with pytest.raises(ValueError, match="block_b"):
        mr_step_cuda(*ops, flow=True, block_b=3)  # does not divide B=4


@pytest.mark.parametrize(
    "encoder,fused,quant",
    [
        ("gru_flow", True, None),
        ("gru_flow_kernel", False, None),
        ("gru", True, None),
        ("gru_kernel", False, None),
        ("gru_flow", True, QuantConfig(4, 10, 2, 12)),
        ("ltc", True, None),
        ("node", True, None),
        ("ltc", True, QuantConfig(4, 10, 2, 12)),
    ],
)
def test_gradients_through_the_kernels_match_plain(dev, encoder, fused, quant):
    """The autograd Functions' backward (plain recompute) against plain autograd.
    The standard GRU never reads ``time_scale``: its gradient is 0 on both sides."""
    cfg = merinda.MRConfig(
        state_dim=2, hidden=32, dense_hidden=64, encoder=encoder, fused=fused, quant=quant
    )
    params = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    ys = torch.randn(16, 12, 2, generator=torch.Generator().manual_seed(1)).to(dev)
    results = []
    for force in (False, True):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss, _ = merinda.mr_loss(p, cfg, ys, None, force_reference=force)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        results.append([loss, *grads])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, **TOL)


def test_dispatch_launches_the_kernel_on_a_cuda_tensor(dev):
    cfg = merinda.MRConfig(state_dim=2, hidden=16, dense_hidden=32, fused=True)
    params = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    xs = torch.randn(8, 10, 2, device=dev)
    assert rt.resolve_dispatch(xs) is rt.Dispatch.KERNEL
    before = (mr_step_cuda.launches, gru_scan_cuda.launches)
    with torch.no_grad():
        mr_step(params, cfg, xs)
        gru_scan(params.encoder, xs, torch.zeros(8, 16, device=dev))
        mr_step(params, cfg, xs, force_reference=True)
    assert (mr_step_cuda.launches, gru_scan_cuda.launches) == (before[0] + 1, before[1] + 1)
    for encoder, kernel in (("ltc", mr_step_ltc_cuda), ("node", mr_step_node_cuda)):
        sub = merinda.MRConfig(state_dim=2, hidden=16, dense_hidden=32, fused=True, encoder=encoder)
        sub_params = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), sub, dev)
        before = kernel.launches
        with torch.no_grad():
            mr_step(sub_params, sub, xs)
            mr_step(sub_params, sub, xs, force_reference=True)
        assert kernel.launches == before + 1


# ---------------------------------------------------------------------------
# the slot-axis forms: S calls in one launch (batch and stream mode)
# ---------------------------------------------------------------------------
SLOT_DT, SLOT_SUBSTEPS = 0.05, 6
# form -> (slot kernel, per-call kernel, plain version, kernel kw, plain kw, the
# operands shared by every slot in the "shared" case besides h0 (and dts))
SLOT_FORMS = {
    "mr_step": (mr_step_slots_cuda, mr_step_cuda, mr_step_reference, dict(flow=True),
                dict(flow=True), (1, 6, 10)),  # h0, dts, b2
    "gru_scan": (gru_scan_slots_cuda, gru_scan_cuda, gru_scan_reference, dict(flow=False),
                 dict(flow=False), (1, 6, 2)),  # h0, dts, wx
    "mr_step_ltc": (mr_step_ltc_slots_cuda, mr_step_ltc_cuda, mr_step_ltc_reference,
                    dict(sub_dt=ltc_sub_dt(SLOT_DT, SLOT_SUBSTEPS), n_substeps=SLOT_SUBSTEPS),
                    dict(dt=SLOT_DT, n_substeps=SLOT_SUBSTEPS), (1, 5)),  # h0, a
    "mr_step_node": (mr_step_node_slots_cuda, mr_step_node_cuda, mr_step_node_reference,
                     dict(sub_dt=node_sub_dt(SLOT_DT, SLOT_SUBSTEPS), n_substeps=SLOT_SUBSTEPS),
                     dict(dt=SLOT_DT, n_substeps=SLOT_SUBSTEPS), (1, 6)),  # h0, w_in
}  # fmt: skip
SLOT_FAMILY = {"mr_step": "gru", "gru_scan": "gru_scan", "mr_step_ltc": "ltc", "mr_step_node": "node"}


def _slot_operands(form, S, B, T, D, H, Dh, K, dev, shared):
    """Each slot's operands from its own seed; the ``shared`` indices once for
    all slots (slot 0's). Returns (operands, in_dims, slot s's operands)."""
    if form in ("mr_step", "gru_scan"):
        per = [_operands(B, T, D, H, Dh, K, dev, seed=20 + s) for s in range(S)]
        if form == "gru_scan":
            per = [ops[:7] for ops in per]
    else:
        family = form.removeprefix("mr_step_")
        per = [_substep_operands(family, B, T, D, H, Dh, K, dev, seed=20 + s) for s in range(S)]
    in_dims = tuple(None if i in shared else 0 for i in range(len(per[0])))
    ops = tuple(per[0][i] if d is None else torch.stack([p[i] for p in per])
                for i, d in enumerate(in_dims))  # fmt: skip
    slot = lambda s: tuple(per[0][i] if d is None else per[s][i] for i, d in enumerate(in_dims))
    return ops, in_dims, slot


@pytest.mark.parametrize("shared", ["per_slot", "shared"])
@pytest.mark.parametrize("H", [8, 32, 48, 64])
@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("form", list(SLOT_FORMS))
def test_slot_forms_match_the_per_call_kernel_bit_for_bit(dev, form, S, H, shared):
    """Each slot of one slot-axis launch equals the per-call kernel on its
    slice bit for bit (two windows a block, and the tile the slot form fits
    for S * B windows), and the vmapped plain version within 1e-4. "per_slot":
    every operand has its slot (h0 non-zero and its own); "shared": h0, a
    weight (and gru's dts) given once, slot stride 0. H=48 is the generic
    instantiation."""
    slot_kernel, kernel, reference, kw, ref_kw, shared_ix = SLOT_FORMS[form]
    B, T, D, Dh, K = 8, 13, 3, 40, 7
    ops, in_dims, slot = _slot_operands(form, S, B, T, D, H, Dh, K, dev,
                                        shared_ix if shared == "shared" else ())  # fmt: skip
    for bb in (2, None):
        before = (slot_kernel.launches, kernel.launches)
        out = slot_kernel(*ops, in_dims=in_dims, **kw, block_b=bb)
        assert (slot_kernel.launches, kernel.launches) == (before[0] + 1, before[1])
        fitted = bb or tiling.fit_block_b(SLOT_FAMILY[form], B, D, H, Dh, K, slots=S)
        for s in range(S):
            one = kernel(*slot(s), **kw, block_b=fitted)
            assert torch.equal(out[s], one), f"{form} slot {s} of {S}, block_b={bb}"
    want = rt.over_slots(reference, in_dims, **ref_kw)(*ops)
    torch.testing.assert_close(out, want, **TOL)


def test_slot_forms_take_batched_operands_at_any_dim(dev):
    """The vmap rule moves a batched operand's slot dim to 0 (here xs batched
    along its window dim, the weights along dim 0): the same launch."""
    B, T, D, H, Dh, K, S = 8, 13, 3, 32, 40, 7, 3
    ops, in_dims, _ = _slot_operands("mr_step", S, B, T, D, H, Dh, K, dev, (1, 6))
    cfg_kw = dict(flow=True, act_bits=None)
    reference = lambda *t: mr_step_reference(*t, **cfg_kw)
    fn = rt.kernel_function("_T", mr_step_cuda, mr_step_slots_cuda, mr_step_reference)
    xs_t = ops[0].transpose(0, 1)  # [B, S, T, D]: slots along dim 1
    run = lambda x, *w: fn.apply(dict(cfg_kw, block_b=None), cfg_kw, x, *w)
    dims = (1, *in_dims[1:])
    before = (mr_step_slots_cuda.launches, mr_step_cuda.launches)
    out = torch.func.vmap(run, in_dims=dims)(xs_t, *ops[1:])
    assert (mr_step_slots_cuda.launches, mr_step_cuda.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(out, torch.func.vmap(reference, in_dims=dims)(xs_t, *ops[1:]), **TOL)
    with pytest.raises(ValueError, match="nested"):
        torch.func.vmap(torch.func.vmap(run, in_dims=dims), in_dims=(0,) + (None,) * 10)(
            xs_t[None], *ops[1:]
        )


SLOT_ROWS = [  # encoder, fused, quant, the slot kernel it must launch
    ("gru_flow", True, None, mr_step_slots_cuda),
    ("gru", True, None, mr_step_slots_cuda),
    ("gru_flow", True, QuantConfig(4, 10, 2, 12), mr_step_slots_cuda),
    ("ltc", True, None, mr_step_ltc_slots_cuda),
    ("node", True, None, mr_step_node_slots_cuda),
    ("gru_kernel", False, None, gru_scan_slots_cuda),
    ("gru_flow_kernel", False, None, gru_scan_slots_cuda),
]
PER_CALL = (mr_step_cuda, mr_step_ltc_cuda, mr_step_node_cuda, gru_scan_cuda)
SLOT_KERNELS = (mr_step_slots_cuda, mr_step_ltc_slots_cuda, mr_step_node_slots_cuda,
                gru_scan_slots_cuda)  # fmt: skip


@pytest.mark.parametrize("encoder,fused,quant,slot_kernel", SLOT_ROWS,
                         ids=[f"{r[0]}{'+qat' if r[2] else ''}" for r in SLOT_ROWS])  # fmt: skip
def test_stacked_step_launches_the_slot_form_once(dev, encoder, fused, quant, slot_kernel):
    """One stacked train step of three slots: one launch of the row's slot
    form and none of any per-call kernel; its loss and gradients (the stacked
    plain recompute) within 1e-4 of the same step with ``force_reference``."""
    cfg = merinda.MRConfig(state_dim=3, input_dim=1, order=2, hidden=32, dense_hidden=64,
                           dt=0.01, encoder=encoder, fused=fused, quant=quant)  # fmt: skip
    per = [merinda.init_mr(torch.Generator(device=dev).manual_seed(s), cfg, dev) for s in range(3)]
    params = tree_stack(per)
    g = torch.Generator().manual_seed(2)
    ys, us = torch.randn(3, 16, 12, 3, generator=g).to(dev), torch.randn(3, 16, 12, 1, generator=g).to(dev)
    results = []
    for force in (False, True):
        counts = [k.launches for k in (*SLOT_KERNELS, *PER_CALL)]
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss, _ = torch.func.vmap(
            lambda p, y, u: merinda.mr_loss(p, cfg, y, u, force_reference=force)
        )(p, ys, us)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        moved = [k.launches - c for k, c in zip((*SLOT_KERNELS, *PER_CALL), counts)]
        want = [int(not force and k is slot_kernel) for k in (*SLOT_KERNELS, *PER_CALL)]
        assert moved == want, (force, moved)
        results.append([loss, *grads])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, **TOL)
    before = slot_kernel.launches
    opt = tree_stack([adamw_init(q) for q in per])
    engine.stacked_train_step(params, opt, cfg, ys, us, torch.tensor([1e-3, 2e-3, 3e-3], device=dev))
    engine.stacked_theta(params, cfg, ys, us)
    assert slot_kernel.launches == before + 2


def test_fused_batch_plan_runs_the_slot_form(dev, monkeypatch):
    """run_batch of a fused plan on the card: steps + 1 slot launches (the
    readout too), no per-call launch, each system's Theta within 1e-3 of the
    same run through the plain versions on the card (the same generators).
    The warmup keeps 5 steps' moves under 1e-3 even where a gradient near 0
    flips its sign between the two summation orders."""
    ys = torch.randn(3, 16, 12, 3, generator=torch.Generator().manual_seed(3))
    spec = api.RecoverySpec(state_dim=3, order=2, hidden=32, dense_hidden=64, dt=0.01,
                            encoder="ltc", fused=True, mode="batch", steps=5, seed=1)  # fmt: skip
    plan = api.compile_plan(spec)
    assert plan.lowering.fused and plan.lowering.dispatch == "cuda"
    counts = [k.launches for k in (*SLOT_KERNELS, *PER_CALL)]
    theta = plan.run_batch(ys.numpy())
    torch.cuda.synchronize()
    moved = [k.launches - c for k, c in zip((*SLOT_KERNELS, *PER_CALL), counts)]
    assert moved == [0, 6, 0, 0, 0, 0, 0, 0]
    monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.REFERENCE)
    torch.testing.assert_close(theta, plan.run_batch(ys.numpy()), atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# the banked service tick
# ---------------------------------------------------------------------------
TICK_BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
TCFG = StreamConfig(
    buf_len=16, window=8, stride=4, chunk=4, steps_per_tick=0, min_steps=10**9, max_steps=10**9
)
SERVE = dict(state_dim=3, input_dim=1, order=2, hidden=32, dense_hidden=64, dt=0.01)


def _tick_operands(cfg, scfg, S, device, seed=0):
    """Slot-stacked params and random tick operands; slot S-1 is inactive and
    every other slot seeds its EMA."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(device)
    params = tree_stack(
        [merinda.init_mr(torch.Generator().manual_seed(seed + i), cfg, "cpu") for i in range(S)]
    )
    params = tree_unflatten(params, [t.to(device) for t in tree_leaves(params)])
    n, m, L, C = cfg.state_dim, cfg.input_dim, scfg.buf_len, scfg.chunk
    return (
        params, mk(S, L, n), mk(S, L, m), mk(S, C, n), mk(S, C, m), mk(S, n, scale=0.1),
        0.5 + torch.rand(S, n, generator=g).to(device), mk(S, cfg.n_terms, n, scale=0.3),
        torch.tensor([True, False] * (S // 2), device=device),
        torch.tensor([True] * (S - 1) + [False], device=device),
    )  # fmt: skip


# past 64 windows a slot (here N = 72) the cluster's 64 warps take the windows in turn
WIDE = StreamConfig(buf_len=600, window=32, stride=8, chunk=8)
TICK_SWEEP = [  # (encoder, m, slots_per_bank, geometry)
    ("gru", 0, 1, "test"), ("gru", 2, 2, "test"), ("gru", 0, 4, "test"),
    ("gru_flow", 0, 2, "test"), ("gru_flow", 2, 1, "test"),
    ("gru", 1, 1, "serve"), ("gru_flow", 1, 2, "serve"), ("gru_flow", 1, 4, "serve"),
    ("gru", 1, 1, "wide"), ("gru_flow", 1, 2, "wide"), ("gru_flow", 1, 4, "wide"),
]  # fmt: skip


def _tick_geometry(geometry, encoder, m):
    if geometry == "test":
        return merinda.MRConfig(input_dim=m, encoder=encoder, **TICK_BASE), TCFG
    cfg = merinda.MRConfig(encoder=encoder, **SERVE)
    return cfg, StreamConfig() if geometry == "serve" else WIDE


@pytest.mark.parametrize("encoder,m,spb,geometry", TICK_SWEEP)
def test_mr_tick_matches_plain(dev, encoder, m, spb, geometry):
    """The serve geometry spreads a slot's 17 windows over a cluster of 3
    blocks; the wide one's 72 over 8 blocks of 8 warps, in turn."""
    cfg, scfg = _tick_geometry(geometry, encoder, m)
    ops = _tick_operands(cfg, scfg, 4, dev)
    before = mr_tick_cuda.launches
    out = mr_tick(ops[0], cfg, scfg, *ops[1:], slots_per_bank=spb)
    torch.cuda.synchronize()
    assert mr_tick_cuda.launches == before + 1
    want = mr_tick(ops[0], cfg, scfg, *ops[1:], force_reference=True)
    assert mr_tick_cuda.launches == before + 1
    torch.testing.assert_close(out[0], want[0], atol=0, rtol=0)  # rolled buffers
    torch.testing.assert_close(out[1], want[1], atol=0, rtol=0)
    torch.testing.assert_close(out[2], want[2], atol=1e-5, rtol=0)  # theta
    assert torch.isinf(out[3][-1]) and torch.isfinite(out[3][:-1]).all()
    torch.testing.assert_close(out[3], want[3], atol=1e-5, rtol=0)  # delta


def test_mr_tick_does_not_depend_on_the_bank(dev):
    cfg = merinda.MRConfig(encoder="gru_flow", **SERVE)
    for scfg in (StreamConfig(), WIDE):
        ops = _tick_operands(cfg, scfg, 4, dev, seed=3)
        outs = [mr_tick(ops[0], cfg, scfg, *ops[1:], slots_per_bank=b) for b in (1, 2, 4)]
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("geometry", ["test", "serve", "wide"])
@pytest.mark.parametrize("encoder", ["gru", "gru_flow"])
def test_mr_tick_windows_are_mr_step_windows(dev, encoder, geometry):
    """A window's result does not depend on where it runs: a seeding slot's
    theta is, bit for bit, mr_step's outputs on the same normalized windows
    (one window a block) summed in window order and divided by N, whatever
    cluster the tick spreads them over."""
    from repro_torch.data.windows import roll_buffer, window_views
    from repro_torch.kernels.mr_step.tick import tick_weights

    cfg, scfg = _tick_geometry(geometry, encoder, 1)
    params, buf_y, buf_u, new_y, new_u, mean, scale, theta_prev, seed, active = _tick_operands(
        cfg, scfg, 4, dev, seed=8
    )
    theta = mr_tick(params, cfg, scfg, buf_y, buf_u, new_y, new_u, mean, scale, theta_prev, seed,
                    active)[2].reshape(4, -1)  # fmt: skip
    wx, wh, b, ts, w1, b1, w2, b2 = (t.contiguous() for t in tick_weights(params, cfg))
    ys, us = roll_buffer(buf_y, new_y), roll_buffer(buf_u, new_u)
    T, Kc = scfg.window, cfg.n_coef
    for s in torch.nonzero(seed).flatten().tolist():
        xs = window_views((ys[s] - mean[s]) / scale[s], T, scfg.stride)
        if cfg.input_dim:
            xs = torch.cat([xs, window_views(us[s], T, scfg.stride)], dim=-1)
        N, H = xs.shape[0], wh.shape[1]
        out = mr_step_cuda(xs.contiguous(), torch.zeros(N, H, device=dev), wx[s], wh[s], b[s],
                           ts[s], torch.ones(T, device=dev), w1[s], b1[s], w2[s], b2[s],
                           flow=encoder == "gru_flow", block_b=1)  # fmt: skip
        acc = out[0, :Kc]
        for w in range(1, N):
            acc = acc + out[w, :Kc]
        # a tensor divisor: PyTorch divides by a Python scalar as a product with its reciprocal
        torch.testing.assert_close(theta[s], acc / torch.full_like(acc, N), atol=0, rtol=0,
                                   msg=lambda m, s=s: f"slot {s}: {m}")  # fmt: skip


LOCKSTEP = StreamConfig(
    buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=2, min_steps=10**9, max_steps=10**9
)


def _lockstep_services(tick_kernel_names, dev, encoder="gru_flow"):
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.standard_normal((64, 3)).astype(np.float32) * 0.1, axis=0)
    services = {}
    for kernel in tick_kernel_names:
        spec = api.RecoverySpec(
            mode="stream", n_slots=2, stream=LOCKSTEP, encoder=encoder, seed=0, **TICK_BASE,
            tick=api.TickSpec(steps_per_tick=LOCKSTEP.steps_per_tick, tick_kernel=kernel),
        )  # fmt: skip
        svc = api.compile_plan(spec, device=dev).make_service()
        for sid in range(2):
            svc.submit(sid, data[sid : sid + LOCKSTEP.buf_len])
        svc.fill_slots()
        services[kernel] = svc
    chunks = [np.repeat(data[32 + 8 * t : 40 + 8 * t][None], 2, axis=0) for t in range(3)]
    return services, chunks


def test_banked_service_launches_mr_tick_once_a_tick(dev):
    services, chunks = _lockstep_services(["banked"], dev)
    before = (mr_tick_cuda.launches, mr_step_cuda.launches, gru_scan_cuda.launches)
    services["banked"].tick_once(chunks[0])
    after = (mr_tick_cuda.launches, mr_step_cuda.launches, gru_scan_cuda.launches)
    assert after == (before[0] + 1, before[1], before[2])


def test_banked_matches_composite_service_on_the_card(dev):
    services, chunks = _lockstep_services(["banked", "composite"], dev)
    for chunk in chunks:
        info_b = services["banked"].tick_once(chunk)
        info_c = services["composite"].tick_once(chunk)
        np.testing.assert_allclose(info_b["delta"], info_c["delta"], atol=1e-5)
    sb, sc = services["banked"].state, services["composite"].state
    for a, b in zip(tree_leaves(sb.params), tree_leaves(sc.params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(sb.theta, sc.theta, atol=1e-5, rtol=0)
    assert torch.equal(sb.steps, sc.steps)


# ---------------------------------------------------------------------------
# the int8/PWL serving kernels
# ---------------------------------------------------------------------------
INT8_TOL = dict(atol=1e-5, rtol=0)
QUANT_GAP = 1e-4  # the least an int8 output must differ from its fp32 twin's
INT8_SHAPES = [  # (B, T, D, H, Dh): the JAX tests', the quickstart's, wider cells
    (4, 20, 3, 32, 64), (64, 32, 2, 32, 64), (193, 32, 2, 32, 64), (8, 9, 3, 64, 128),
    (36, 21, 3, 8, 40), (36, 21, 3, 48, 40), (36, 21, 3, 64, 40),
]  # fmt: skip


@pytest.mark.parametrize("B,T,D,H,Dh", INT8_SHAPES)
@pytest.mark.parametrize("encoder", ["gru", "ltc"])
def test_int8_stages_match_plain(dev, encoder, B, T, D, H, Dh):
    """At the fitted tile within 1e-5 of the plain version; H=8, 32 and 64
    take their instantiations, H=48 the generic one. Every tile of 1, 2, 3, 4
    and 9 windows that divides B gives the fitted tile's bits: a warp a window
    (a tile of 9 runs its windows on 8 warps, the ninth after the first)."""
    cfg = merinda.MRConfig(state_dim=D, hidden=H, dense_hidden=Dh, encoder=encoder, dt=0.05)
    params = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    xs = torch.randn(B, T, D, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    kernel = mr_step_int8_cuda if encoder == "gru" else mr_step_ltc_int8_cuda
    before = kernel.launches
    theta, shifts = mr_step_int8(params, cfg, xs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = mr_step_int8(params, cfg, xs, force_reference=True)
    assert kernel.launches == before + 1
    torch.testing.assert_close(theta, want[0], **INT8_TOL)
    torch.testing.assert_close(shifts, want[1], **INT8_TOL)
    tiles = [bb for bb in (1, 2, 3, 4, 9) if B % bb == 0]
    for bb in tiles:
        t_bb, s_bb = mr_step_int8(params, cfg, xs, block_b=bb)
        torch.testing.assert_close(t_bb, theta, atol=0, rtol=0, msg=f"{encoder} block_b={bb}")
        torch.testing.assert_close(s_bb, shifts, atol=0, rtol=0, msg=f"{encoder} block_b={bb}")
    assert kernel.launches == before + 1 + len(tiles)
    with torch.no_grad():
        theta_fp, _ = mr_step(params, cfg, xs)
    assert (theta - theta_fp).abs().max().item() >= QUANT_GAP


def test_ltc_int8_takes_a_tile_past_a_thousand_threads(dev):
    """The int8 LTC runs a warp a window, as the fp32 one: 32 windows of H = 64
    (2,048 (window, unit) pairs) in one block of 8 warps, each equal bit for
    bit to its one-window block and within 1e-5 of the plain version."""
    B, T, D, H, Dh = 64, 12, 2, 64, 128
    cfg = merinda.MRConfig(state_dim=D, hidden=H, dense_hidden=Dh, encoder="ltc", dt=0.05)
    params = merinda.init_mr(torch.Generator(device=dev).manual_seed(3), cfg, dev)
    xs = torch.randn(B, T, D, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    before = mr_step_ltc_int8_cuda.launches
    out = mr_step_int8(params, cfg, xs, block_b=32)
    one = mr_step_int8(params, cfg, xs, block_b=1)
    torch.cuda.synchronize()
    assert 32 * H > 1024 and mr_step_ltc_int8_cuda.launches == before + 2
    want = mr_step_int8(params, cfg, xs, force_reference=True)
    for got, ref1, w in zip(out, one, want):
        torch.testing.assert_close(got, ref1, atol=0, rtol=0)
        torch.testing.assert_close(got, w, **INT8_TOL)


@pytest.mark.parametrize(
    "B,T,D,H", [(4, 20, 8, 32), (64, 32, 2, 32), (193, 32, 2, 32), (64, 200, 8, 64)]
)
def test_gru_scan_int8_matches_plain(dev, B, T, D, H):
    g = torch.Generator(device=dev).manual_seed(2)
    params = GRUParams(
        torch.randn(D + H, 3 * H, device=dev, generator=g) * (D + H) ** -0.5,
        torch.randn(3 * H, device=dev, generator=g) * 0.1,
        torch.randn(H, device=dev, generator=g),
    )
    xs = torch.randn(B, T, D, device=dev, generator=g)
    h0 = torch.randn(B, H, device=dev, generator=g) * 0.1
    before = gru_scan_int8_cuda.launches
    _, hs = gru_scan_int8(params, xs, h0)
    torch.cuda.synchronize()
    assert gru_scan_int8_cuda.launches == before + 1
    _, want = gru_scan_int8(params, xs, h0, force_reference=True)
    torch.testing.assert_close(hs, want, **INT8_TOL)
    with torch.no_grad():
        _, hs_fp = gru_scan(params, xs, h0, flow=False)
    assert (hs - hs_fp).abs().max().item() >= QUANT_GAP


def _gru_int8_operands(ops):
    """gru_scan_int8_cuda's operands of gru_scan's (xs, h0, wx, wh, b, ...):
    the weights quantized per column, their scales, the serving PWL tables."""
    xs, h0, wx, wh, b = ops[:5]
    qx, qh = quantize_int8(wx), quantize_int8(wh)
    return (xs, h0, qx.values, qh.values, qx.scale.reshape(-1), qh.scale.reshape(-1), b,
            *serving_packs(xs.device))  # fmt: skip


@pytest.mark.parametrize("H", [8, 32, 48, 64])
def test_gru_scan_int8_does_not_depend_on_the_tile(dev, H):
    """gru_scan_int8 runs gru_scan's warp cell on the int8/PWL policy: every
    window's hs is the same bit for bit whatever its block holds (a tile of 9
    runs its windows on 8 warps, the ninth after the first), from a non-zero
    h0, within 1e-5 of the plain version and at least 1e-4 from the fp32 twin;
    H=48 is the generic instantiation."""
    B, T, D = 36, 21, 3
    ops = _operands(B, T, D, H, 16, 4, dev, seed=10)[:7]
    q_ops = _gru_int8_operands(ops)
    before = gru_scan_int8_cuda.launches
    outs = {bb: gru_scan_int8_cuda(*q_ops, block_b=bb) for bb in (1, 2, 3, 4, 9)}
    torch.cuda.synchronize()
    assert gru_scan_int8_cuda.launches == before + 5
    for bb, hs in outs.items():
        torch.testing.assert_close(hs, outs[1], atol=0, rtol=0, msg=f"gru_scan_int8 block_b={bb}")
    want = gru_scan_int8_reference(*q_ops[:7], ops[6], *serving_tables())
    torch.testing.assert_close(outs[1], want, **INT8_TOL)
    hs_fp = gru_scan_cuda(*ops, flow=False, block_b=1)
    assert (outs[1] - hs_fp).abs().max().item() >= QUANT_GAP


def test_gru_scan_int8_refuses_a_width_past_the_warp_cell(dev):
    """A lane holds at most 8 units, so H = 264 is refused before any launch."""
    ops = _gru_int8_operands(_operands(2, 3, 2, 264, 16, 4, dev)[:7])
    before = gru_scan_int8_cuda.launches
    with pytest.raises(ValueError, match="H=264"):
        gru_scan_int8_cuda(*ops, block_b=1)
    assert gru_scan_int8_cuda.launches == before


# the serve geometry spreads a slot's 17 windows over a cluster of 3 blocks, the
# wide one's 72 over 8 blocks of 8 warps, in turn; H=48 (the generic
# instantiation) and H=64 read the int8 recurrent columns from shared memory
INT8_TICK_SWEEP = [(0, 1, "test"), (2, 2, "test"), (1, 1, "serve"), (1, 2, "serve"), (1, 4, "serve"),
                   (1, 1, "wide"), (1, 2, "wide"), (1, 4, "wide"), (2, 2, "test-H48"),
                   (0, 1, "test-H64")]  # fmt: skip


def _int8_tick_geometry(geometry, m):
    if geometry in ("serve", "wide"):
        cfg = merinda.MRConfig(encoder="gru", **SERVE)
        return cfg, StreamConfig() if geometry == "serve" else WIDE
    # "test": the JAX tests' width; "test-H48", "test-H64": wider cells, Dh = 40
    H = geometry.partition("-H")[2]
    width = dict(TICK_BASE, hidden=int(H), dense_hidden=40) if H else TICK_BASE
    return merinda.MRConfig(input_dim=m, encoder="gru", **width), TCFG


@pytest.mark.parametrize("m,spb,geometry", INT8_TICK_SWEEP)
def test_mr_tick_int8_matches_plain(dev, m, spb, geometry):
    cfg, scfg = _int8_tick_geometry(geometry, m)
    ops = _tick_operands(cfg, scfg, 4, dev, seed=5)
    before = (mr_tick_int8_cuda.launches, mr_tick_cuda.launches)
    out = mr_tick(ops[0], cfg, scfg, *ops[1:], quant=True, slots_per_bank=spb)
    torch.cuda.synchronize()
    assert (mr_tick_int8_cuda.launches, mr_tick_cuda.launches) == (before[0] + 1, before[1])
    want = mr_tick(ops[0], cfg, scfg, *ops[1:], quant=True, force_reference=True)
    torch.testing.assert_close(out[0], want[0], atol=0, rtol=0)  # rolled buffers
    torch.testing.assert_close(out[1], want[1], atol=0, rtol=0)
    torch.testing.assert_close(out[2], want[2], **INT8_TOL)  # theta
    assert torch.isinf(out[3][-1]) and torch.isfinite(out[3][:-1]).all()
    torch.testing.assert_close(out[3], want[3], **INT8_TOL)  # delta
    theta_fp = mr_tick(ops[0], cfg, scfg, *ops[1:], slots_per_bank=spb)[2]
    assert (out[2] - theta_fp).abs().max().item() >= QUANT_GAP


def test_mr_tick_int8_does_not_depend_on_the_bank(dev):
    """A window's result and the slot's readout are the same bit for bit at
    1, 2 and 4 slots a bank (a cluster walks its bank's slots in turn)."""
    cfg = merinda.MRConfig(encoder="gru", **SERVE)
    for scfg in (StreamConfig(), WIDE):
        ops = _tick_operands(cfg, scfg, 4, dev, seed=6)
        outs = [mr_tick(ops[0], cfg, scfg, *ops[1:], quant=True, slots_per_bank=b)
                for b in (1, 2, 4)]  # fmt: skip
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_int8_monitor_launches_mr_tick_int8_once_a_tick(dev):
    """A K=0 banked int8_pwl plan: each tick is one mr_tick_int8 launch and
    no other kernel; the service reads an eviction out through mr_step_int8."""
    scfg = StreamConfig(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=0,
                        min_steps=10**9, max_steps=10**9)  # fmt: skip
    spec = api.RecoverySpec(
        mode="stream", n_slots=2, stream=scfg, encoder="gru", seed=0, precision="int8_pwl",
        tick=api.TickSpec(steps_per_tick=0, tick_kernel="banked"), **TICK_BASE,
    )  # fmt: skip
    plan = api.compile_plan(spec, device=dev)
    assert plan.lowering.quant_serving and plan.lowering.dispatch == "cuda"
    svc = plan.make_service()
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.standard_normal((64, 3)).astype(np.float32) * 0.1, axis=0)
    for sid in range(2):
        svc.submit(sid, data[sid : sid + 32])
    svc.fill_slots()
    kernels = (mr_tick_int8_cuda, mr_tick_cuda, mr_step_int8_cuda, mr_step_cuda, gru_scan_cuda)
    before = [k.launches for k in kernels]
    for t in range(3):
        svc.tick_once(np.repeat(data[32 + 8 * t : 40 + 8 * t][None], 2, axis=0))
    assert [k.launches - b for k, b in zip(kernels, before)] == [3, 0, 0, 0, 0]
    before = mr_step_int8_cuda.launches
    svc._evict(0, "budget")
    assert mr_step_int8_cuda.launches == before + 1


# ---------------------------------------------------------------------------
# the LM zoo: ssd_scan and flash_attention
# ---------------------------------------------------------------------------
SSD_SWEEP = [  # B, S, H, P, N, G, chunk: the JAX tests' shapes, then SMOKE's chunk
    (1, 64, 1, 8, 4, 1, 32),
    (2, 128, 2, 16, 8, 1, 32),
    (2, 96, 4, 32, 16, 2, 32),
    (2, 96, 4, 32, 16, 2, 64),
    (1, 48, 4, 16, 16, 1, 16),
]


def _ssd_inputs(B, S, H, P, N, G, dev, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=g) * scale
    x = mk(B, S, H, P, scale=0.5)
    dt = torch.nn.functional.softplus(mk(B, S, H))
    A = -torch.exp(mk(H, scale=0.5))
    bm, cm = mk(B, S, G, N, scale=0.5), mk(B, S, G, N, scale=0.5)
    return x.to(dtype), dt, A, bm.to(dtype), cm.to(dtype), mk(H)


@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SSD_SWEEP)
def test_ssd_scan_matches_plain(dev, B, S, H, P, N, G, chunk):
    args = _ssd_inputs(B, S, H, P, N, G, dev, seed=S + chunk)
    before = ssd_scan_cuda.launches
    y, s = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    want_y, want_s = ssd_scan(*args, chunk=chunk, force_reference=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(s, want_s, atol=5e-5, rtol=5e-5)


def test_ssd_scan_float32_at_the_model_width(dev):
    """N = 128, P = 64, chunk 128: each output sums ~256 products, so the two
    summation orders part by more than at the JAX tests' widths; the bound is
    1e-5 of the largest magnitude (~80 float32 roundings of it)."""
    args = _ssd_inputs(2, 256, 24, 64, 128, 1, dev, seed=7)
    y, s = ssd_scan(*args, chunk=128)
    want_y, want_s = ssd_scan(*args, chunk=128, force_reference=True)
    assert (y - want_y).abs().max() <= 1e-5 * want_y.abs().max()
    assert (s - want_s).abs().max() <= 1e-5 * want_s.abs().max()


def test_ssd_scan_bf16_is_the_float32_scan_rounded_once(dev):
    """bf16 x, B, C at the model's widths: y within one bf16 rounding (2^-8
    relative, plus the float32 scan's own 1e-4) of ssd_chunked on float32
    copies; the state (float32) within 1e-4 of its largest magnitude."""
    args = _ssd_inputs(2, 512, 24, 64, 128, 1, dev, torch.bfloat16, seed=3)
    y, s = ssd_scan(*args, chunk=128)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_y, want_s = ssd_chunked(*(a.float() for a in args), chunk=128)
    assert ((y.float() - want_y).abs() <= want_y.abs() * 2.0**-8 + 1e-4).all()
    assert (s - want_s).abs().max() <= 1e-4 * want_s.abs().max()


def _assert_bf16_rounded(got, want32):
    """bf16 ``got`` within one bf16 rounding (2^-8 of the value) plus 1e-4 of
    the float32 result on the same values."""
    assert got.dtype == torch.bfloat16
    assert ((got.float() - want32).abs() <= want32.abs() * 2.0**-8 + 1e-4).all()


def _assert_ssd_matches(y, s, want_y, want_s, dtype, N):
    """float32: the JAX bound (5e-5) at its widths, 1e-5 of the largest
    magnitude at wider states; bf16: y one rounding from the float32 scan,
    the state within 1e-4 of its largest magnitude."""
    if dtype == torch.bfloat16:
        _assert_bf16_rounded(y, want_y)
        assert (s - want_s).abs().max() <= 1e-4 * want_s.abs().max()
    elif N <= 16:
        torch.testing.assert_close(y, want_y, atol=5e-5, rtol=5e-5)
        torch.testing.assert_close(s, want_s, atol=5e-5, rtol=5e-5)
    else:
        assert (y - want_y).abs().max() <= 1e-5 * want_y.abs().max()
        assert (s - want_s).abs().max() <= 1e-5 * want_s.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ssd_scan_carries_a_state_on_the_card(dev, dtype):
    """A prefill from a carried ``initial_state`` launches the kernels (the
    state pass starts from it) and matches ``ssd_chunked`` from that state on
    float32 copies; the two halves carry the whole scan's state."""
    args = _ssd_inputs(2, 128, 2, 16, 8, 1, dev, dtype, seed=5)
    head = [a[:, :64] if a.dim() > 1 else a for a in args]
    tail = [a[:, 64:] if a.dim() > 1 else a for a in args]
    _, s1 = ssd_scan(*head, chunk=32)
    before = ssd_scan_cuda.launches
    y2, s2 = ssd_scan(*tail, chunk=32, initial_state=s1)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    want_y, want_s = ssd_chunked(*(a.float() for a in tail), chunk=32, initial_state=s1)
    _assert_ssd_matches(y2, s2, want_y, want_s, dtype, N=8)
    _, s = ssd_scan(*args, chunk=32)
    assert (s2 - s).abs().max() <= 1e-4 * s.abs().max()


SSD_DTYPE_SWEEP = [  # B, S, H, P, N, G, chunk
    (1, 64, 1, 8, 4, 1, 16),  # a JAX test shape (N, P < 16), B = 1, SMOKE's chunk
    (2, 128, 2, 16, 8, 1, 32),
    (2, 96, 4, 32, 16, 2, 64),  # G > 1, S padded to the chunk
    (1, 256, 4, 64, 128, 2, 128),  # the model's widths, G > 1, B = 1
    (2, 160, 3, 20, 12, 1, 32),  # N, P not multiples of 8: staged element by element
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SSD_DTYPE_SWEEP)
def test_ssd_scan_both_dtypes_at_every_chunk(dev, B, S, H, P, N, G, chunk, dtype):
    args = _ssd_inputs(B, S, H, P, N, G, dev, dtype, seed=S + chunk + N)
    y, s = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    want_y, want_s = ssd_scan(*(a.float() for a in args), chunk=chunk, force_reference=True)
    _assert_ssd_matches(y, s, want_y, want_s, dtype, N)


def test_ssd_scan_gradient_recomputes_the_plain_scan(dev):
    args = [a.requires_grad_(True) for a in _ssd_inputs(2, 64, 2, 8, 4, 1, dev, seed=4)]
    y, _ = ssd_scan(*args, chunk=32)
    grads = torch.autograd.grad((y**2).sum(), args)
    y_r, _ = ssd_scan(*args, chunk=32, force_reference=True)
    want = torch.autograd.grad((y_r**2).sum(), args)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


def test_mamba_prefill_launches_ssd_scan_once_a_layer(dev):
    cfg = get_config("mamba2-130m", smoke=True)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(1, cfg.vocab_size, (2, 40), device=dev)
    before = (ssd_scan_cuda.launches, flash_attention_cuda.launches)
    logits, cache = lm.prefill(params, {"tokens": toks}, cfg, cache_len=64)
    torch.cuda.synchronize()
    assert (ssd_scan_cuda.launches, flash_attention_cuda.launches) == (before[0] + cfg.num_layers, before[1])
    want, want_cache = lm.prefill(params, {"tokens": toks}, cfg, cache_len=64, force_reference=True)
    torch.testing.assert_close(logits.float(), want.float(), atol=0.12, rtol=0.12)
    torch.testing.assert_close(cache["layers"]["state"], want_cache["layers"]["state"], atol=0.12, rtol=0.12)


# the wide GRU-flow scan (csrc/gru_scan_wide.cu): (B, T, D, H), the merinda-gru serve
# path's bootstrap and admission prefills and its decode step, T = 37, odd B and D, a
# width that is not a whole number of passes of 128, and decode steps at B * T =
# tiling.WIDE_SKINNY_ROWS (the skinny x.Wx + b) and one past it (the tiled GEMM)
WIDE_CASES = [
    (4, 1024, 512, 512), (1, 1024, 512, 512), (4, 1, 512, 512), (3, 37, 512, 512),
    (5, 37, 64, 512), (2, 1, 512, 512), (3, 37, 24, 300),
    (tiling.WIDE_SKINNY_ROWS, 1, 512, 512), (tiling.WIDE_SKINNY_ROWS + 1, 1, 512, 512),
]  # fmt: skip


def _wide_operands(B, T, D, H, dev, seed=0):
    """xs, a non-zero h0, wx, wh, b, time_scale and per-step dts at the LM's scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=g) * scale
    w = (D + H) ** -0.5
    dts = 0.25 + 1.75 * torch.rand(T, device=dev, generator=g)
    return (mk(B, T, D), mk(B, H, scale=0.5), mk(D, 3 * H, scale=w), mk(H, 3 * H, scale=w),
            mk(3 * H, scale=0.1), mk(H, scale=0.3), dts)  # fmt: skip


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("B,T,D,H", WIDE_CASES)
def test_gru_scan_wide_matches_plain(dev, B, T, D, H, flow):
    ops = _wide_operands(B, T, D, H, dev, seed=B * T + H)
    before = gru_scan_wide_cuda.launches
    hs = gru_scan_wide_cuda(*ops, flow=flow)
    torch.cuda.synchronize()
    assert gru_scan_wide_cuda.launches == before + 1
    torch.testing.assert_close(hs, gru_scan_reference(*ops, flow=flow), **TOL)


@pytest.mark.parametrize("B", [tiling.WIDE_SKINNY_ROWS, tiling.WIDE_SKINNY_ROWS + 1])
def test_gru_scan_wide_takes_the_skinny_gemm_up_to_its_threshold(dev, B):
    """A decode step's x.Wx + b runs ``gru_wide_gx_skinny_kernel`` at B * T <=
    ``tiling.WIDE_SKINNY_ROWS`` (the source's ``kSkinnyRows``) and the tiled
    ``gru_wide_gx_kernel`` past it, read from the profiler's kernel names."""
    ops = _wide_operands(B, 1, 512, 512, dev, seed=B)
    gru_scan_wide_cuda(*ops, flow=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gru_scan_wide_cuda(*ops, flow=True)
        torch.cuda.synchronize()
    names = " ".join(e.name for e in prof.events())
    skinny = B <= tiling.WIDE_SKINNY_ROWS
    assert ("gru_wide_gx_skinny_kernel" in names) == skinny
    assert ("gru_wide_gx_kernel" in names) == (not skinny)
    assert "gru_wide_kernel" in names


def test_gru_scan_wide_refuses_what_it_does_not_take(dev):
    ops = _wide_operands(2, 3, 8, 513, dev)
    with pytest.raises(ValueError, match="H=513"):
        gru_scan_wide_cuda(*ops, flow=True)


def test_gru_scan_wide_rows_a_cluster_change_no_row(dev, tmp_path):
    """The wide scan built at 2 and 4 batch rows a cluster (kernel_phases'
    ``WIDE_ROWS`` patches; it is built at 1) gives every row's hs within 1e-6
    of the 1-row build, also where the rows do not divide B."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import kernel_phases as kp

    with ThreadPoolExecutor(max_workers=len(kp.WIDE_ROWS)) as pool:
        futures = {tag: pool.submit(kp.build, rt.CSRC, tmp_path, tag.replace(" ", "_"), patches,
                                    kp.WIDE_SOURCES) for tag, patches in kp.WIDE_ROWS.items()}  # fmt: skip
        libs = {tag: f.result()[0] for tag, f in futures.items()}
    B, T, D, H = 5, 64, 512, 512
    ops = _wide_operands(B, T, D, H, dev, seed=5)

    def run(lib):
        gx, hs = torch.empty(B, T, 3 * H, device=dev), torch.empty(B, T, H, device=dev)
        err = lib.gru_scan_wide_launch(*(t.data_ptr() for t in (*ops, gx, hs)), B, T, D, H, 1,
                                       torch.cuda.current_stream().cuda_stream)  # fmt: skip
        rt.check_launch("gru_scan_wide", err)
        return hs

    base = run(libs["wide rows 1"])
    torch.testing.assert_close(base, gru_scan_reference(*ops, flow=True), **TOL)
    for tag in kp.WIDE_ROWS:
        torch.testing.assert_close(run(libs[tag]), base, atol=1e-6, rtol=0)


@pytest.mark.parametrize("D,H,wide", [(16, 64, False), (8, 120, False), (16, 257, True),
                                      (16, 300, True), (512, 512, True)])  # fmt: skip
def test_gru_scan_launches_the_form_its_width_takes(dev, D, H, wide):
    """The op launches the warp cell at H <= 256 and the wide form past it,
    read from both launch counters, within 1e-4 of the plain version."""
    xs, h0, wx, wh, b, ts, dts = _wide_operands(3, 9, D, H, dev, seed=H)
    before = (gru_scan_cuda.launches, gru_scan_wide_cuda.launches)
    h_T, hs = gru_scan(GRUParams(torch.cat([wx, wh]), b, ts), xs, h0, dts=dts)
    torch.cuda.synchronize()
    assert (gru_scan_cuda.launches - before[0], gru_scan_wide_cuda.launches - before[1]) == (
        (0, 1) if wide else (1, 0))  # fmt: skip
    torch.testing.assert_close(hs, gru_scan_reference(xs, h0, wx, wh, b, ts, dts), **TOL)


@pytest.mark.parametrize("D,H", [(8, 121), (16, 256)])
def test_gru_scan_refuses_a_width_neither_form_takes(dev, D, H):
    """At H <= 256 the op takes the warp cell alone, whose carve of wx and wh
    does not fit a block here: the launch raises, and nothing is launched."""
    xs, h0, wx, wh, b, ts, dts = _wide_operands(3, 9, D, H, dev, seed=H)
    before = (gru_scan_cuda.launches, gru_scan_wide_cuda.launches)
    with pytest.raises(ValueError, match="shared memory"):
        gru_scan(GRUParams(torch.cat([wx, wh]), b, ts), xs, h0, dts=dts)
    assert (gru_scan_cuda.launches, gru_scan_wide_cuda.launches) == before


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "CONFIG"])
def test_merinda_gru_prefill_and_decode_go_through_the_scan(dev, smoke):
    """merinda-gru's prefill and decode on the card launch the scan once a layer
    (SMOKE, H = 64: the warp cell; CONFIG at 2 of its 8 layers, H = 512: the
    wide form) and nothing else, in float32 within 1e-4 of the largest logit
    of ``force_reference``'s; the state within 1e-4."""
    import dataclasses

    cfg = dataclasses.replace(get_config("merinda-gru", smoke=smoke), dtype="float32",
                              num_layers=2)  # fmt: skip
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(1, cfg.vocab_size, (2, 40), device=dev)
    kernel = gru_scan_cuda if smoke else gru_scan_wide_cuda
    counters = (gru_scan_cuda, gru_scan_wide_cuda, ssd_scan_cuda, flash_attention_cuda)
    before = [k.launches for k in counters]
    logits, cache = lm.prefill(params, {"tokens": toks}, cfg, cache_len=64)
    nxt = torch.randint(1, cfg.vocab_size, (2, 1), device=dev)
    step, cache = lm.decode_step(params, cache, nxt, 40, cfg)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(counters, before)] == [
        2 * cfg.num_layers if k is kernel else 0 for k in counters]  # fmt: skip
    want, want_cache = lm.prefill(params, {"tokens": toks}, cfg, cache_len=64, force_reference=True)
    want_step, want_cache = lm.decode_step(params, want_cache, nxt, 40, cfg, force_reference=True)
    for got, ref in ((logits, want), (step, want_step)):
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    torch.testing.assert_close(cache["layers"]["state"], want_cache["layers"]["state"], **TOL)


FLASH_CASES = [  # B, S, QH, KH, Dh, causal, window: tests/test_kernels_flash.py:11-19
    (1, 128, 1, 1, 32, True, None),
    (2, 256, 4, 2, 64, True, None),
    (2, 256, 8, 1, 64, True, None),
    (1, 256, 4, 4, 128, False, None),
    (2, 256, 4, 2, 64, True, 128),
    (1, 384, 2, 2, 64, True, 64),
]


def _qkv(B, Sq, Sk, QH, KH, Dh, dev, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(dtype)
    return mk(B, Sq, QH, Dh), mk(B, Sk, KH, Dh), mk(B, Sk, KH, Dh)


@pytest.mark.parametrize("B,S,QH,KH,Dh,causal,window", FLASH_CASES)
def test_flash_attention_matches_plain(dev, B, S, QH, KH, Dh, causal, window):
    q, k, v = _qkv(B, S, S, QH, KH, Dh, dev, seed=S + QH)
    before = flash_attention_cuda.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention(q, k, v, causal=causal, window=window, force_reference=True)
    torch.testing.assert_close(o, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 256), (32, 128), (256, 32)])
def test_flash_attention_blocks_leave_the_result(dev, block_q, block_k):
    q, k, v = _qkv(1, 256, 256, 2, 2, 64, dev, seed=4)
    o = flash_attention(q, k, v, block_q=block_q, block_k=block_k)
    torch.testing.assert_close(o, flash_attention(q, k, v, force_reference=True), atol=2e-5, rtol=2e-5)


def test_flash_attention_q_offset_tail_and_bf16(dev):
    q, k, v = _qkv(1, 256, 256, 2, 2, 64, dev, seed=9)
    full = flash_attention(q, k, v)
    tail = flash_attention(q[:, -128:], k, v, q_offset=128)
    torch.testing.assert_close(tail, full[:, -128:], atol=2e-5, rtol=2e-5)
    qb, kb, vb = _qkv(1, 128, 128, 2, 2, 64, dev, torch.bfloat16, seed=3)
    o = flash_attention(qb, kb, vb)
    assert o.dtype == torch.bfloat16
    want = flash_attention(qb.float(), kb.float(), vb.float(), force_reference=True)
    assert ((o.float() - want).abs() <= want.abs() * 2.0**-8 + 1e-4).all()


def test_flash_attention_rows_without_keys_follow_the_pallas_kernel(dev):
    """q_offset + Sq > Sk with a window: the oracle's NaN rows come out as the
    Pallas kernel leaves them: 0 where its block skipped every key tile,
    else the mean of v over the masked keys of the tiles it did not skip."""
    Sq, Sk, window, off, bq, bk = 64, 64, 16, 40, 32, 32
    q, k, v = _qkv(1, Sq, Sk, 2, 1, 32, dev, seed=5)
    o = flash_attention(q, k, v, window=window, q_offset=off, block_q=bq, block_k=bk)
    want = flash_attention(q, k, v, window=window, q_offset=off, force_reference=True)
    dead = torch.isnan(want).any(dim=-1).any(dim=-1)[0]
    assert int(dead.sum()) == 25 and torch.isfinite(o).all()
    torch.testing.assert_close(o[:, ~dead], want[:, ~dead], atol=2e-5, rtol=2e-5)
    for i in torch.nonzero(dead).flatten().tolist():
        q_start = (i // bq) * bq + off
        tiles = [s for s in range(0, Sk, bk) if s <= q_start + bq - 1 and s + bk - 1 > q_start - window]
        keys = [j for s in tiles for j in range(s, s + bk)]
        expect = v[0, keys, 0].mean(0) if keys else torch.zeros_like(v[0, 0, 0])
        torch.testing.assert_close(o[0, i], expect.expand(2, -1), atol=2e-5, rtol=2e-5)


FLASH_BF16_CASES = [  # B, Sq, Sk, QH, KH, Dh, causal, window, q_offset, block
    (1, 256, 256, 2, 2, 32, True, None, 0, 128),
    (2, 256, 256, 4, 2, 64, True, None, 0, 128),  # GQA
    (2, 256, 256, 8, 1, 128, True, None, 0, 128),  # MQA
    (1, 200, 200, 2, 1, 33, True, None, 0, 40),  # odd Dh, Sq not a multiple of the tiles
    (1, 384, 384, 2, 2, 64, True, 64, 0, 64),  # a window
    (1, 72, 200, 2, 2, 48, True, None, 128, 8),  # a q_offset tail
    (2, 256, 256, 4, 4, 128, False, None, 0, 128),  # bidirectional
]


@pytest.mark.parametrize("B,Sq,Sk,QH,KH,Dh,causal,window,q_offset,block", FLASH_BF16_CASES)
def test_flash_attention_bf16_on_the_tensor_cores(dev, B, Sq, Sk, QH, KH, Dh, causal, window,
                                                  q_offset, block):  # fmt: skip
    """bf16 against the oracle on float32 copies within one bf16 rounding,
    every row: the early causal rows (a few keys, outputs that cancel) too."""
    q, k, v = _qkv(B, Sq, Sk, QH, KH, Dh, dev, torch.bfloat16, seed=Sq + Dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention_cuda.launches
    o = flash_attention(q, k, v, block_q=block, block_k=block, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention(q.float(), k.float(), v.float(), force_reference=True, **kw)
    _assert_bf16_rounded(o, want)


def test_flash_attention_bf16_rows_without_keys_follow_the_pallas_kernel(dev):
    """The float32 test's rows without an unmasked key, in bf16: 0, or the mean
    of v over the masked keys of the tiles the Pallas kernel does not skip."""
    Sq, Sk, window, off, bq, bk = 64, 64, 16, 40, 32, 32
    q, k, v = _qkv(1, Sq, Sk, 2, 1, 32, dev, torch.bfloat16, seed=5)
    o = flash_attention(q, k, v, window=window, q_offset=off, block_q=bq, block_k=bk)
    want = flash_attention(q.float(), k.float(), v.float(), window=window, q_offset=off,
                           force_reference=True)  # fmt: skip
    dead = torch.isnan(want).any(dim=-1).any(dim=-1)[0]
    assert int(dead.sum()) == 25 and torch.isfinite(o.float()).all()
    _assert_bf16_rounded(o[:, ~dead], want[:, ~dead])
    for i in torch.nonzero(dead).flatten().tolist():
        q_start = (i // bq) * bq + off
        tiles = [s for s in range(0, Sk, bk) if s <= q_start + bq - 1 and s + bk - 1 > q_start - window]
        keys = [j for s in tiles for j in range(s, s + bk)]
        expect = v[0, keys, 0].float().mean(0) if keys else torch.zeros(32, device=dev)
        _assert_bf16_rounded(o[0, i], expect.expand(2, -1))


def test_flash_attention_gradient_recomputes_the_oracle(dev):
    q, k, v = (t.requires_grad_(True) for t in _qkv(1, 128, 128, 2, 1, 32, dev, seed=8))
    grads = torch.autograd.grad((flash_attention(q, k, v) ** 2).sum(), (q, k, v))
    want = torch.autograd.grad((flash_attention(q, k, v, force_reference=True) ** 2).sum(), (q, k, v))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


# the served LM paths' attention layouts (B, S, QH, KH, Dh): zamba2's shared block
# (MHA, Dh = 64) and qwen2.5-3b's layers (GQA 16/2, Dh = 128), at the bootstrap and
# admission prefills, and at S = 1,000 through the attention layer's block (8)
LM_FLASH = [(4, 1024, 32, 32, 64), (1, 1024, 32, 32, 64), (4, 1024, 16, 2, 128),
            (1, 1024, 16, 2, 128), (1, 1000, 32, 32, 64), (1, 1000, 16, 2, 128)]  # fmt: skip


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,QH,KH,Dh", LM_FLASH)
def test_flash_attention_at_the_served_layouts(dev, B, S, QH, KH, Dh, dtype):
    """Causal, the block the model's prefill attention picks: float32 within
    2e-5 of the oracle, bf16 within one bf16 rounding of it on float32 copies."""
    q, k, v = _qkv(B, S, S, QH, KH, Dh, dev, dtype, seed=S + QH + B)
    before = flash_attention_cuda.launches
    o = flash_attention(q, k, v, block_q=prefill_block(S), block_k=prefill_block(S))
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention(q.float(), k.float(), v.float(), force_reference=True)
    if dtype == torch.bfloat16:
        _assert_bf16_rounded(o, want)
    else:
        torch.testing.assert_close(o, want, atol=2e-5, rtol=2e-5)


# the MoE, VLM and audio paths' attention layouts (B, Sq, Sk, QH, KH, Dh, causal,
# window): mixtral-8x22b's windowed prefill of 4,160 tokens, phi-3-vision's 256 patches
# + 768 tokens at Dh = 96, seamless-m4t's encoder over 4,096 frames and its
# cross-attention from a 256-token prompt and from a decode step's one query
NEW_FLASH = {
    "mixtral prefill": (2, 4160, 4160, 48, 8, 128, True, 4096),
    "phi-3-vision prefill": (2, 1024, 1024, 32, 32, 96, True, None),
    "seamless encoder": (2, 4096, 4096, 16, 16, 64, False, None),
    "seamless cross-attention": (2, 256, 4096, 16, 16, 64, False, None),
    "seamless decode cross-attention": (2, 1, 4096, 16, 16, 64, False, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", list(NEW_FLASH))
def test_flash_attention_at_the_new_layouts(dev, layout, dtype):
    """Each length at the block the model's attention picks for it (4,160 ->
    64, 1 -> 1, 4,096 -> 128): float32 within 2e-5 of the oracle, bf16 within
    one bf16 rounding of it on float32 copies."""
    B, Sq, Sk, QH, KH, Dh, causal, window = NEW_FLASH[layout]
    q, k, v = _qkv(B, Sq, Sk, QH, KH, Dh, dev, dtype, seed=Sq + Sk + Dh)
    before = flash_attention_cuda.launches
    o = flash_attention(q, k, v, causal=causal, window=window, block_q=prefill_block(Sq),
                        block_k=prefill_block(Sk))  # fmt: skip
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention(q.float(), k.float(), v.float(), causal=causal, window=window,
                           force_reference=True)  # fmt: skip
    if dtype == torch.bfloat16:
        _assert_bf16_rounded(o, want)
    else:
        torch.testing.assert_close(o, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium"])  # fmt: skip
def test_moe_vlm_audio_smoke_on_the_card(dev, arch):
    """The MoE, VLM and audio SMOKE models in float32: a prefill of 40 tokens
    (mixtral's past its window of 16; phi-3-vision's after 8 patches;
    seamless-m4t's against 4,096 frames) and two decode steps through the
    kernels, against force_reference within 1e-4. A prefill launches
    flash_attention once a layer (seamless-m4t: once an encoder layer, twice
    a decoder layer), a decode step never (seamless-m4t: its cross-attention,
    once a decoder layer)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (2, 42), device=dev, generator=g)
    batch = {"tokens": toks[:, :40]}
    if cfg.family == "vlm":
        batch["patches"] = 0.5 * torch.randn(2, cfg.num_patches, cfg.d_model, device=dev, generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, lm.AUDIO_SRC_LEN, lm.AUDIO_FEAT, device=dev, generator=g)
    audio = cfg.family == "audio"
    n_prefill = cfg.encoder_layers + 2 * cfg.num_layers if audio else cfg.num_layers
    before = flash_attention_cuda.launches
    logits, cache = lm.prefill(params, batch, cfg, cache_len=48)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches - before == n_prefill
    want, want_cache = lm.prefill(params, batch, cfg, cache_len=48, force_reference=True)
    got, wants = [logits], [want]
    offset = cfg.num_patches
    for t in (40, 41):
        before = flash_attention_cuda.launches
        lg, cache = lm.decode_step(params, cache, toks[:, t : t + 1], offset + t, cfg)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches - before == (cfg.num_layers if audio else 0)
        lg_r, want_cache = lm.decode_step(params, want_cache, toks[:, t : t + 1], offset + t, cfg,
                                          force_reference=True)  # fmt: skip
        got.append(lg)
        wants.append(lg_r)
    for a, b in zip(got, wants):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for name in cache["layers"]:
        torch.testing.assert_close(cache["layers"][name], want_cache["layers"][name], atol=1e-4,
                                   rtol=1e-4)  # fmt: skip


@pytest.mark.parametrize("B,S", [(1, 256), (4, 1024)])
def test_ssd_scan_at_zamba2_widths(dev, B, S):
    """zamba2-1.2b's scan: H = 64 heads of P = 64, state N = 64 (the Mamba2-130m
    path has H = 24, N = 128), chunk 128, bf16 x, B and C, against ssd_chunked on
    float32 copies: y one bf16 rounding from it, the state within 1e-4 of its
    largest magnitude. (The float32 kernel at this width is printed by
    ``chip_smoke.py`` beside the float32 plain version, both against float64:
    neither float32 bound of the narrower shapes holds at both of these.)"""
    args = _ssd_inputs(B, S, 64, 64, 64, 1, dev, torch.bfloat16, seed=B + S)
    y, s = ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()
    want_y, want_s = ssd_chunked(*(a.float() for a in args), chunk=128)
    _assert_ssd_matches(y, s, want_y, want_s, torch.bfloat16, N=64)


@pytest.mark.parametrize("B,S,H,N", [(1, 256, 64, 64), (4, 1024, 64, 64), (4, 1024, 24, 128)])
def test_ssd_scan_float32_follows_the_plain_order(dev, B, S, H, N):
    """At zamba2's and Mamba2-130m's widths in float32 the kernel sums dt*A in
    ``ssd_chunked``'s order (torch.cumsum's sequential sum) and adds the
    intra-chunk term to the inter-chunk one as it does: y within 1e-6 of the
    largest |y| of the plain version's and the final state within 1e-6 of its
    largest value (a blocked prefix sum of dt*A does not: it parts from
    ``ssd_chunked``'s cum by a few ulps, which every output carries)."""
    args = _ssd_inputs(B, S, H, 64, N, 1, dev, seed=B + S + N)
    y, s = ssd_scan(*args, chunk=128)
    want_y, want_s = ssd_chunked(*args, chunk=128)
    assert (y - want_y).abs().max() <= 1e-6 * want_y.abs().max()
    assert (s - want_s).abs().max() <= 1e-6 * want_s.abs().max()


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2.5-3b"])
def test_attention_lm_smoke_on_the_card(dev, arch):
    """zamba2 and qwen2.5-3b SMOKE in float32: a prefill of 40 tokens (the block
    8) and two decode steps through the kernels, against force_reference within
    1e-4; a prefill launches flash_attention once a shared-block application or
    dense layer and ssd_scan once a Mamba2 layer, a decode step neither."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    toks = torch.randint(1, cfg.vocab_size, (2, 42), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))  # fmt: skip
    n_attn = (lm.shared_applications(cfg) if cfg.family == "hybrid"
              else cfg.num_layers)  # fmt: skip
    n_ssd = cfg.num_layers if cfg.family == "hybrid" else 0
    before = (flash_attention_cuda.launches, ssd_scan_cuda.launches)
    logits, cache = lm.prefill(params, {"tokens": toks[:, :40]}, cfg, cache_len=48)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches - before[0], ssd_scan_cuda.launches - before[1]) == (n_attn, n_ssd)
    want, want_cache = lm.prefill(params, {"tokens": toks[:, :40]}, cfg, cache_len=48,
                                  force_reference=True)  # fmt: skip
    got, wants = [logits], [want]
    for t in (40, 41):
        before = (flash_attention_cuda.launches, ssd_scan_cuda.launches)
        lg, cache = lm.decode_step(params, cache, toks[:, t : t + 1], t, cfg)
        assert (flash_attention_cuda.launches, ssd_scan_cuda.launches) == before
        lg_r, want_cache = lm.decode_step(params, want_cache, toks[:, t : t + 1], t, cfg,
                                          force_reference=True)  # fmt: skip
        got.append(lg)
        wants.append(lg_r)
    for a, b in zip(got, wants):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for group in cache:
        for name in cache[group]:
            torch.testing.assert_close(cache[group][name], want_cache[group][name], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the device control plane, service snapshots and the SR baselines on the card
# ---------------------------------------------------------------------------
PLANE_SCFG = StreamConfig(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=2, min_steps=4,
                          max_steps=4, delta_tol=0.0)  # fmt: skip


def _plane_spec(control, steps_per_tick=2, precision="fp32", mesh_slots=1, **tick_kw):
    scfg = StreamConfig(**{**PLANE_SCFG.__dict__, "steps_per_tick": steps_per_tick})
    return api.RecoverySpec(
        mode="stream", n_slots=2, stream=scfg, encoder="gru", seed=0, precision=precision,
        mesh_slots=mesh_slots,
        tick=api.TickSpec(steps_per_tick=steps_per_tick, tick_kernel="banked", control=control,
                          **tick_kw),
        **TICK_BASE,
    )  # fmt: skip


def _plane_service(dev, control, steps_per_tick=2, precision="fp32", mesh_slots=1, **tick_kw):
    spec = _plane_spec(control, steps_per_tick, precision, mesh_slots, **tick_kw)
    return api.compile_plan(spec, device=dev, devices=[dev] * mesh_slots).make_service()


def _plane_data(n=7):
    rng = np.random.default_rng(3)
    return np.cumsum(rng.standard_normal((n, 200, 3)).astype(np.float32) * 0.1, axis=1)


@pytest.mark.parametrize("steps_per_tick,precision,kernel",
                         [(2, "fp32", mr_tick_cuda), (0, "int8_pwl", mr_tick_int8_cuda)])  # fmt: skip
def test_device_plane_ticks_between_snapshots_never_wait_for_the_card(dev, steps_per_tick,
                                                                     precision, kernel):
    """Snapshot every 4 ticks; after a first tick, every tick but the
    snapshot ticks, and an arrival during one, under sync-debug mode "error":
    no readback, and the tick kernel once a tick (K = 0 with int8_pwl: the
    int8 monitor's ``mr_tick_int8``)."""
    data = _plane_data()
    svc = _plane_service(dev, "device", steps_per_tick, precision, snapshot_period=4)
    for sid in range(4):
        svc.submit(sid, data[sid, :32])
    svc.fill_slots()
    # the first tick makes the once-a-device constants (the library's exponent
    # table, the window index) on the card; the JAX test skips it too
    svc.tick_once(np.stack([data[s, 32:40] for s in (0, 1)]))
    before, quiet = kernel.launches, []
    for t in range(1, 13):
        snapshot = svc._ticks_since_snapshot + 1 >= 4
        chunk = np.stack([data[max(s, 0), 32 + 8 * t : 40 + 8 * t] for s in svc.slot_streams()])
        torch.cuda.set_sync_debug_mode(0 if snapshot else "error")
        try:
            if t == 2:
                assert svc.submit(6, data[6, :32]).accepted
            svc.tick_once(chunk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not snapshot:
            quiet.append(svc.sync_log[-1])
    assert len(quiet) == 9 and not any(quiet)
    assert svc.sync_log[3::4] == [2, 2, 2]
    assert kernel.launches - before == 12
    if steps_per_tick:  # 2 ticks a stream: all 5 recovered
        assert set(svc.results) == {0, 1, 2, 3, 6}


def _arrivals_trace(svc, data):
    """Six streams arriving over the first ticks: the slot maps and eviction
    records of every tick."""
    arrivals = {0: [0, 1, 2], 2: [3], 3: [4], 5: [5]}
    cursors, trace = dict.fromkeys(range(6), 32), []
    svc.fill_slots()
    t = 0
    while (not svc.done or t in arrivals) and t < 30:
        for sid in arrivals.get(t, ()):
            svc.submit(sid, data[sid, :32])
            svc.fill_slots()
        chunk = np.zeros((2, 8, 3), np.float32)
        for s, sid in enumerate(svc.slot_streams()):
            if sid >= 0:
                chunk[s] = data[sid, cursors[sid] : cursors[sid] + 8]
                cursors[sid] += 8
        info = svc.tick_once(chunk)
        trace.append((tuple(svc.slot_streams()), [(r.stream_id, r.steps) for r in info["evicted"]]))
        t += 1
    return trace


def test_device_plane_matches_the_host_plane_on_the_card(dev):
    """Six streams arriving over the first ticks into 2 slots: slot maps and
    eviction records equal, theta within 1e-5."""
    data = _plane_data()
    traces, services = {}, {}
    for control in ("host", "device"):
        svc = _plane_service(dev, control)
        traces[control], services[control] = _arrivals_trace(svc, data), svc
    assert traces["device"] == traces["host"]
    for sid in range(6):
        np.testing.assert_allclose(services["device"].results[sid].theta,
                                   services["host"].results[sid].theta, atol=1e-5, rtol=0)  # fmt: skip


def test_service_snapshot_restores_bit_for_bit_on_the_card(dev, tmp_path):
    data = _plane_data()
    kw = dict(snapshot_period=1, checkpoint_period=2, checkpoint_dir=str(tmp_path))
    svc = _plane_service(dev, "device", **kw)
    for sid in range(4):
        svc.submit(sid, data[sid, :32])
    svc.fill_slots()
    chunks = [np.stack([data[s, 32 + 8 * t : 40 + 8 * t] for s in (0, 1)]) for t in range(4)]
    for t in range(2):
        svc.tick_once(chunks[t])
    svc.checkpointer.wait()
    svc.checkpointer.period = 0
    fresh = _plane_service(dev, "device", **kw)
    info = fresh.checkpointer.restore_into(fresh)
    assert info["step"] == 2 and fresh.state.buf_y.is_cuda and fresh.control.q_ids.is_cuda
    for t in range(2, 4):
        for a, b in zip(tree_leaves((svc.state, svc.control)), tree_leaves((fresh.state, fresh.control))):
            assert torch.equal(a, b)
        svc.tick_once(chunks[t])
        fresh.tick_once(chunks[t])


@pytest.mark.parametrize("control", ["host", "device"])
def test_slot_mesh_of_2_matches_mesh_1_on_the_card(dev, control):
    """The arrivals above at mesh 2 (one slot a shard, the card listed
    twice) and mesh 1: every stream's result equal (steps and reason; theta
    within 1e-5), ``mr_tick`` once a shard a tick. The host plane's slot
    maps and eviction records equal mesh 1's; the device plane's equal the
    same mesh-2 service's on the CPU: an arrival joins the least-loaded
    shard's queue, so at mesh 2 it may take another slot a tick earlier
    than at mesh 1, as in the JAX package (``tests/test_torch_mesh.py``)."""
    data = _plane_data()
    svc1 = _plane_service(dev, control)
    trace1 = _arrivals_trace(svc1, data)
    svc2 = _plane_service(dev, control, mesh_slots=2)
    before = mr_tick_cuda.launches
    trace2 = _arrivals_trace(svc2, data)
    assert mr_tick_cuda.launches - before == 2 * svc2.ticks
    if control == "host":
        assert trace2 == trace1
    else:
        cpu = api.compile_plan(_plane_spec(control, mesh_slots=2), devices=["cpu", "cpu"])
        assert trace2 == _arrivals_trace(cpu.make_service(), data)
    assert [st.active.shape[0] for st in svc2.shards] == [1, 1] and svc2.state.theta.is_cuda
    for sid in range(6):
        r1, r2 = svc1.results[sid], svc2.results[sid]
        assert (r2.steps, r2.reason) == (r1.steps, r1.reason)
        np.testing.assert_allclose(r2.theta, r1.theta, atol=1e-5, rtol=0)


def test_slot_mesh_launches_the_fused_step_and_the_int8_readout_a_shard(dev):
    """A fused int8_pwl host-plane service (composite tick, K = 2) on the
    arrivals above: the slot-axis ``mr_step`` launches once a shard for each
    step and for the tick's Theta, M x (K + 1) a tick, and no ``mr_tick``;
    every eviction is one ``mr_step_int8`` launch on its shard's row. Mesh 2's
    results equal mesh 1's (steps and reason; Theta within 1e-5)."""
    data = _plane_data()
    services = {}
    kernels = (mr_step_slots_cuda, mr_step_int8_cuda, mr_tick_cuda, mr_step_cuda)
    for mesh_slots in (1, 2):
        spec = api.RecoverySpec(mode="stream", n_slots=2, stream=PLANE_SCFG, encoder="gru", seed=0,
                                precision="int8_pwl", fused=True, block_b="auto",
                                mesh_slots=mesh_slots,
                                tick=api.TickSpec(steps_per_tick=2, tick_kernel="composite"),
                                **TICK_BASE)  # fmt: skip
        svc = api.compile_plan(spec, device=dev, devices=[dev] * mesh_slots).make_service()
        before = [k.launches for k in kernels]
        _arrivals_trace(svc, data)
        moved = [k.launches - b for k, b in zip(kernels, before)]
        assert moved == [mesh_slots * 3 * svc.ticks, len(svc.results), 0, 0], (mesh_slots, moved)
        services[mesh_slots] = svc
    assert set(services[2].results) == set(services[1].results) == set(range(6))
    for sid, r1 in services[1].results.items():
        r2 = services[2].results[sid]
        assert (r2.steps, r2.reason) == (r1.steps, r1.reason)
        np.testing.assert_allclose(r2.theta, r1.theta, atol=1e-5, rtol=0)


def test_slot_mesh_ticks_between_snapshots_never_wait_for_the_card(dev):
    """Mesh 2 on the device plane, snapshot every 4 ticks: every tick but
    the snapshot ticks under sync-debug mode "error" after a first tick;
    each snapshot reads every shard's status and events back once each."""
    data = _plane_data()
    svc = _plane_service(dev, "device", mesh_slots=2, snapshot_period=4)
    for sid in range(4):
        svc.submit(sid, data[sid, :32])
    svc.fill_slots()
    svc.tick_once(np.stack([data[s, 32:40] for s in (0, 1)]))
    quiet = []
    for t in range(1, 9):
        snapshot = svc._ticks_since_snapshot + 1 >= 4
        chunk = np.stack([data[max(s, 0), 32 + 8 * t : 40 + 8 * t] for s in svc.slot_streams()])
        torch.cuda.set_sync_debug_mode(0 if snapshot else "error")
        try:
            svc.tick_once(chunk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not snapshot:
            quiet.append(svc.sync_log[-1])
    assert len(quiet) == 6 and not any(quiet) and svc.sync_log[3::4] == [2, 2]


def _supervised(dev, tmp_path, chaos):
    from repro_torch.runtime import ServiceSupervisor

    sup = ServiceSupervisor(_plane_spec("device", mesh_slots=2), str(tmp_path), checkpoint_period=2,
                            chaos=chaos, devices=[dev, dev])  # fmt: skip
    return sup, sup.serve(_plane_data(6), max_ticks=30)


def test_service_supervisor_drill_on_the_card(dev, tmp_path):
    """A shard lost at tick 3 of a mesh-2 device-plane service: one restart,
    the mesh of 1, every stream recovered, and the failed incarnation's
    memory freed (dropping it gives the card's allocator back at least its
    shards' and control rows' bytes)."""
    from repro_torch.runtime import kill_shard_once

    sup, out = _supervised(dev, tmp_path, kill_shard_once(3))
    assert out["restarts"] == 1 and out["final_mesh"] == (1,)
    assert out["recovered_streams_fraction"] == 1.0 and len(out["results"]) == 6
    first, last = sup.history
    assert first["mesh_shape"] == (2,) and last["mesh_shape"] == (1,)
    assert first["device_bytes_freed"] >= first["service_bytes"] > 0


def test_same_mesh_restore_replays_bit_for_bit_on_the_card(dev, tmp_path):
    from repro_torch.runtime import kill_shard_once

    _, plain = _supervised(dev, tmp_path / "plain", None)
    _, out = _supervised(dev, tmp_path / "chaos", kill_shard_once(3, n_lost=0))
    assert out["restarts"] == 1 and out["final_mesh"] == (2,) and plain["results"].keys() == out["results"].keys()
    for sid, res in plain["results"].items():
        np.testing.assert_array_equal(out["results"][sid].theta, res.theta)


def test_sr_baselines_on_the_card_match_the_cpu(dev):
    """SINDy on Lorenz and (in float64, as ``recover_aid`` fits it) on AID:
    the same active set, coefficients within 1e-4 of the fit's scale; 50
    PINN-SR steps from one initial parameter set: Xi within 1e-4."""
    from repro_torch.core import pinn_sr, sindy
    from repro_torch.data.dynamics import generate_trajectory
    from repro_torch.launch import recover_aid
    from repro_torch.tree import tree_map

    (card, _, _), (host, _, _) = (recover_aid.fit_aid_sindy(d) for d in (dev, "cpu"))
    assert torch.equal(card.mask.cpu(), host.mask)
    assert (card.coef.cpu() - host.coef).abs().max() <= 1e-4 * max(1.0, host.coef.abs().max().item())

    ts, ys, _ = generate_trajectory("lorenz")
    fits = {d: sindy.fit_sindy(torch.as_tensor(ys).to(d), dt=0.01, order=2, threshold=0.1)
            for d in (dev, "cpu")}  # fmt: skip
    assert torch.equal(fits[dev].mask.cpu(), fits["cpu"].mask)
    coef = fits["cpu"].coef
    assert (fits[dev].coef.cpu() - coef).abs().max() <= 1e-4 * max(1.0, coef.abs().max().item())
    cfg = pinn_sr.PinnSRConfig(state_dim=3, width=32, fourier_k=8)
    start = pinn_sr.init_pinn_sr(torch.Generator().manual_seed(0), cfg, "cpu")
    z = ((ys - ys.mean(0)) / ys.std(0)).astype(np.float32)
    xi = {}
    for d in (dev, "cpu"):
        p, _ = pinn_sr.train_pinn_sr(cfg, torch.as_tensor(ts).to(d), torch.as_tensor(z).to(d),
                                     steps=50, lr=1e-3, params=tree_map(lambda t: t.to(d), start))  # fmt: skip
        xi[str(d)] = pinn_sr.recovered_xi(p).cpu()
    assert (xi[str(dev)] - xi["cpu"]).abs().max() <= 1e-4


# -- plan analysis: the substep unroll, the exported carves, the audit and the tuner
@pytest.fixture(scope="module")
def unrolled_libs(tmp_path_factory):
    """mr_step_ltc.cu and mr_step_node.cu built as they are and with their
    substep loop unrolled 2 and 6 times (launch/kernel_phases.py's patches:
    the kernels instantiate an unroll of 1 only), tag -> library."""
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():  # a module fixture runs before dev()
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")

    from repro_torch.launch import kernel_phases as kp

    work = tmp_path_factory.mktemp("unroll")
    jobs = {"unroll 1": (), **kp.UNROLLS}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {tag: pool.submit(kp.build, rt.CSRC, work, tag.replace(" ", "_"), patches,
                                    kp.UNROLL_SOURCES) for tag, patches in jobs.items()}  # fmt: skip
        return {tag: f.result()[0] for tag, f in futures.items()}


@pytest.mark.parametrize("n_substeps", [1, 5, 6, 7])
@pytest.mark.parametrize("H", [8, 32, 48, 64])
@pytest.mark.parametrize("family", ["ltc", "node"])
def test_substep_unroll_changes_no_bit(dev, unrolled_libs, family, H, n_substeps):
    """mr_step_ltc and mr_step_node with their substep loop unrolled 2 and 6
    times equal the loop at 1 bit for bit, also where the substeps are no
    multiple of the factor (the remainder runs one at a time)."""
    from repro_torch.launch import kernel_phases as kp

    kernel = f"mr_step_{family}"
    ops = kp.operands(kernel, 16, 13, 3, H, 40, 7, dev)
    base = kp.launcher(unrolled_libs["unroll 1"], kernel, ops, 2, n_substeps)()[0]
    for tag in kp.UNROLLS:
        assert torch.equal(kp.launcher(unrolled_libs[tag], kernel, ops, 2, n_substeps)()[0], base)


def test_an_uninstantiated_unroll_is_refused(dev, monkeypatch):
    ops = _substep_operands("ltc", 8, 5, 2, 32, 40, 7, dev)
    kw = dict(sub_dt=ltc_sub_dt(0.05, 6), n_substeps=6, unroll=2)
    with pytest.raises(ValueError, match=r"substep_unroll=2 has no instantiation .*\(1,\)"):
        mr_step_ltc_cuda(*ops, **kw)
    monkeypatch.setattr(tiling, "check_unroll", lambda unroll, family: None)
    with pytest.raises(RuntimeError, match="cudaError"):  # the launcher's own guard
        mr_step_ltc_cuda(*ops, **kw)


# (label, D, H, Dh, K): the quickstart, the generic width, H = 64, serve_mr's width
CARVE_SHAPES = [("quickstart", 2, 32, 64, 12), ("H=48", 3, 48, 64, 12),
                ("H=64", 2, 64, 128, 12), ("serve", 4, 32, 64, 45)]  # fmt: skip
CARVE_TICKS = [("test", 8, 3), ("serve", 32, 17), ("wide", 32, 72)]  # (label, T, N)


@pytest.mark.parametrize("label,D,H,Dh,K", CARVE_SHAPES, ids=[s[0] for s in CARVE_SHAPES])
def test_exported_carves_equal_the_model(dev, label, D, H, Dh, K):
    """Every kernel's launcher requests exactly the shared memory
    kernels/mr_step/tiling.py models (the two sides of rule R2)."""
    from repro_torch.core.quant import N_SEG

    carve = rt.kernel_smem_bytes
    for bb in (1, 2, 4, 8, 16):
        assert carve("mr_step", D, H, Dh, K, bb) == tiling.mr_step_smem_bytes(D, H, Dh, K, bb)
        assert carve("gru_scan", D, H, bb) == tiling.gru_scan_smem_bytes(D, H, bb)
        assert carve("mr_step_ltc", D, H, Dh, K, bb) == tiling.ltc_smem_bytes(D, H, Dh, K, bb)
        assert carve("mr_step_node", D, H, Dh, K, bb) == tiling.node_smem_bytes(D, H, Dh, K, bb)
        assert carve("mr_step_int8", D, H, Dh, K, bb, N_SEG) == tiling.int8_smem_bytes(
            D, H, Dh, K, bb)  # fmt: skip
        assert carve("gru_scan_int8", D, H, bb, N_SEG) == tiling.gru_scan_int8_smem_bytes(D, H, bb)
        assert carve("mr_step_ltc_int8", D, H, Dh, K, bb, N_SEG) == tiling.ltc_int8_smem_bytes(
            D, H, Dh, K, bb)  # fmt: skip
    for wide_h in (H + 256, 300, 512):  # the wide scan's, at its widths (512: merinda-gru)
        assert carve("gru_scan_wide", wide_h) == tiling.gru_scan_wide_smem_bytes(wide_h)
    for _, T, N in CARVE_TICKS:
        assert carve("mr_tick", D, H, Dh, K, T, N) == tiling.tick_smem_bytes(D, H, Dh, K, N, T)
        assert carve("mr_tick_int8", D, H, Dh, K, T, N, N_SEG) == tiling.tick_smem_bytes(
            D, H, Dh, K, N, T, int8=True)  # fmt: skip


AUDIT_CELLS = [  # (id, tick kernel, control plane, K, precision, the verdict)
    ("host_composite", "composite", "host", 2, "fp32", "pass:R1,R2,R3"),
    ("host_banked", "banked", "host", 2, "fp32", "pass:R1,R2,R3"),
    ("device_banked", "banked", "device", 2, "fp32", "pass:R1,R2,R3"),
    ("monitor_int8", "banked", "host", 0, "int8_pwl", "pass:R1,R2,R3,R4"),
]


@pytest.mark.parametrize("tick_kernel,control,K,precision,verdict",
                         [c[1:] for c in AUDIT_CELLS], ids=[c[0] for c in AUDIT_CELLS])  # fmt: skip
def test_audit_on_the_card_is_clean(dev, tick_kernel, control, K, precision, verdict):
    """A fused service plan at serve_mr's width audits clean on the card: R2
    against the launcher's carve, R3 traced and again under sync-debug mode
    "error" (the host-plane and device-plane ticks), R4 on the int8 tick."""
    scfg = StreamConfig(steps_per_tick=K)
    spec = api.RecoverySpec(**SERVE, encoder="gru", mode="stream", n_slots=4, fused=True,
                            block_b="auto", precision=precision, stream=scfg,
                            tick=api.TickSpec(steps_per_tick=K, tick_kernel=tick_kernel,
                                              control=control))  # fmt: skip
    plan = api.compile_plan(spec, device=dev, audit="error")
    assert plan.lowering.audit == verdict
    assert plan.lowering.smem_budget_source == "device"


@pytest.mark.parametrize("encoder", ["gru_flow", "ltc", "node"])
def test_offline_audit_on_the_card_is_clean(dev, encoder):
    """Each fused family's quickstart-width offline plan audits clean on the
    card: the epoch (R1; R3 traced and under sync-debug mode "error") and the
    fused stage (R2, R3)."""
    spec = api.RecoverySpec(state_dim=2, hidden=32, dense_hidden=64, encoder=encoder, fused=True,
                            block_b="auto", mode="offline", batch_size=64, steps=4)  # fmt: skip
    assert api.compile_plan(spec, device=dev, audit="error").lowering.audit == "pass:R1,R2,R3"


def test_r3_sees_host_to_device_copies_on_the_card(dev):
    """The trace finds each copy to the card that makes the host wait: a
    tensor made on the card from a list, a blocking copy, a non-blocking copy
    from pageable memory; a non-blocking copy from pinned memory is clean."""
    from repro_torch.analysis import trace

    lrs = [1e-3, 2e-3]
    cases = {
        "factory": lambda: torch.tensor(lrs, dtype=torch.float32, device=dev),
        "blocking": lambda: torch.tensor(lrs).to(dev),
        "pageable": lambda: torch.tensor(lrs).to(dev, non_blocking=True),
        "pinned": lambda: torch.tensor(lrs).pin_memory().to(dev, non_blocking=True),
    }
    waits = {k: len(trace.observe(k, fn, []).waits) for k, fn in cases.items()}
    assert waits == {"factory": 1, "blocking": 1, "pageable": 1, "pinned": 0}


def test_measured_tune_on_the_card(dev, tmp_path, monkeypatch):
    """Every candidate timed with CUDA events, its carve equal to the model;
    the tuned plan audits clean (R2: the model and the recorded measured
    bytes against the launch's carve); a warm recompile times nothing."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    from repro_torch.analysis import tuner

    spec = api.RecoverySpec(state_dim=2, hidden=32, dense_hidden=64, encoder="ltc", fused=True,
                            block_b="auto", mode="offline", batch_size=64, steps=4)  # fmt: skip
    report = tuner.tune(spec, device=dev)
    fused = [s for s in report.candidates if s.candidate.fused and s.t_step_us is not None]
    assert fused and all(s.measured_us > 0 and s.parsed_bytes == s.predicted_bytes for s in fused)
    plan = api.compile_plan(spec, device=dev, tune="measured", audit="error")
    low = plan.lowering
    assert low.tuned == "measured:cached" and low.audit == "pass:R1,R2,R3"
    assert low.measured_bytes == report.chosen.parsed_bytes
    assert low.substep_unroll == report.chosen.candidate.substep_unroll
    assert tuner.tune(spec, device=dev).n_lowered == 0


# --- LM training through the kernels ------------------------------------------------
def _train_calls(cfg) -> dict[str, int]:
    """Op calls of one training step under remat="full"."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"ssd_scan": 2 * L}
    if cfg.family == "hybrid":
        return {"ssd_scan": 2 * L, "flash_attention": lm.shared_applications(cfg)}
    if cfg.family == "gru":
        return {"gru_scan_wide" if cfg.gru_hidden > tiling.MAX_HIDDEN else "gru_scan": 2 * L}
    if cfg.family == "audio":
        return {"flash_attention": 2 * cfg.encoder_layers + 4 * L}
    return {"flash_attention": 2 * L}


def _train_loss_and_grads(params, batch, cfg, force_reference):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm.train_loss(tree_unflatten(params, leaves), batch, cfg, force_reference)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", sorted(lm_archs()))
def test_training_through_the_kernels_matches_the_reference(dev, arch):
    from repro_torch.data.pipeline import to_device_batch

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(11), cfg)
    rng = np.random.default_rng(12)
    T = 32 - cfg.num_patches if cfg.family == "vlm" else 32
    batch = {k: rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32) for k in ("tokens", "labels")}
    batch["labels"][0, :3] = -1
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal((2, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((2, lm.AUDIO_SRC_LEN, lm.AUDIO_FEAT)).astype(np.float32)
    batch = to_device_batch(batch, dev)
    counters = {"ssd_scan": ssd_scan_cuda, "flash_attention": flash_attention_cuda,
                "gru_scan": gru_scan_cuda, "gru_scan_wide": gru_scan_wide_cuda}  # fmt: skip
    for fn in counters.values():
        fn.launches = 0
    loss, grads = _train_loss_and_grads(params, batch, cfg, False)
    torch.cuda.synchronize()
    calls = {k: fn.launches for k, fn in counters.items() if fn.launches}
    want, want_grads = _train_loss_and_grads(params, batch, cfg, True)
    assert calls == _train_calls(cfg)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    for g, w in zip(grads, want_grads):
        assert (g - w).abs().max().item() <= 1e-3 * w.abs().max().item()
