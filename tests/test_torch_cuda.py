"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is False: a hand-written CUDA kernel has no CPU mode. The file imports no JAX,
so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: <= 1e-4 in float32, the JAX package's bound for its fused kernels;
the kernel sums the gate products in another order than the plain version.
The head's activation step is checked at the coarse format Q2.3, which moves
the output by ~1e-2 (at the QAT run's Q4.10 the whole step is within the
tolerance). There a window whose normalized summary lies within 1e-5 of a
rounding threshold may round the other way in the kernel; such windows are
left out of that comparison, and at least three quarters must remain.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.core import merinda
from repro_torch.core.ltc import LTCParams, ltc_scan, ltc_sub_dt
from repro_torch.core.node_mr import NodeEncoderParams, node_scan, node_sub_dt
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.gru_scan.ops import gru_scan, gru_scan_cuda
from repro_torch.kernels.gru_scan.ref import gru_scan_reference
from repro_torch.kernels.mr_step.ops import (
    mr_step,
    mr_step_cuda,
    mr_step_ltc_cuda,
    mr_step_node_cuda,
)
from repro_torch.kernels.mr_step.ref import (
    mr_step_ltc_reference,
    mr_step_node_reference,
    mr_step_reference,
)
from repro_torch.tree import tree_leaves, tree_unflatten

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
    [(64, 32, 2, 32, 64, 1), (193, 32, 2, 32, 64, 1), (8, 33, 3, 64, 128, 2), (6, 5, 2, 8, 16, 3)],
)
def test_kernels_match_plain(dev, flow, B, T, D, H, Dh, block_b):
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
@pytest.mark.parametrize("B,T,D,H,Dh,block_b", [(64, 32, 2, 32, 64, 1), (8, 9, 3, 64, 128, 2)])
@pytest.mark.parametrize("family", ["ltc", "node"])
def test_substep_kernels_match_plain(dev, family, B, T, D, H, Dh, block_b, n_substeps, act_bits):
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


def test_variable_dts_match_plain(dev):
    ops = list(_operands(4, 6, 2, 16, 32, 12, dev))
    ops[6] = torch.tensor([1.0, 0.0, 0.5, 2.0, 0.0, 1.0], device=dev)
    hs = gru_scan_cuda(*ops[:7], flow=True, block_b=1)
    torch.testing.assert_close(hs, gru_scan_reference(*ops[:7], flow=True), **TOL)


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
        ("gru_flow", True, QuantConfig(4, 10, 2, 12)),
        ("ltc", True, None),
        ("node", True, None),
        ("ltc", True, QuantConfig(4, 10, 2, 12)),
    ],
)
def test_gradients_through_the_kernels_match_plain(dev, encoder, fused, quant):
    """The autograd Functions' backward (plain recompute) against plain autograd."""
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
        results.append([loss, *torch.autograd.grad(loss, leaves)])
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
