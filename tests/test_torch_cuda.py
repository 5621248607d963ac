"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is False: a hand-written CUDA kernel has no CPU mode. The file imports no JAX,
so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: <= 1e-4 in float32, the JAX package's bound for its fused kernels;
the kernel sums the gate products in another order than the plain version.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.core import merinda
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.gru_scan.ops import gru_scan, gru_scan_cuda
from repro_torch.kernels.gru_scan.ref import gru_scan_reference
from repro_torch.kernels.mr_step.ops import mr_step, mr_step_cuda
from repro_torch.kernels.mr_step.ref import mr_step_reference

TOL = dict(atol=1e-4, rtol=1e-4)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    rt.pin_fp32_matmul()
    return torch.device("cuda")


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
    hs = gru_scan_cuda(*ops[:7], flow=flow, block_b=block_b)
    torch.cuda.synchronize()
    assert (mr_step_cuda.launches, gru_scan_cuda.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, mr_step_reference(*ops, flow=flow), **TOL)
    torch.testing.assert_close(hs, gru_scan_reference(*ops[:7], flow=flow), **TOL)


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


@pytest.mark.parametrize("encoder,fused", [("gru_flow", True), ("gru_flow_kernel", False)])
def test_gradients_through_the_kernels_match_plain(dev, encoder, fused):
    """The autograd Functions' backward (plain recompute) against plain autograd."""
    cfg = merinda.MRConfig(state_dim=2, hidden=32, dense_hidden=64, encoder=encoder, fused=fused)
    params = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    ys = torch.randn(16, 12, 2, generator=torch.Generator().manual_seed(1)).to(dev)
    results = []
    for force in (False, True):
        leaves = [p.detach().requires_grad_(True) for p in (params.encoder.w, params.head_w1)]
        p = params._replace(encoder=params.encoder._replace(w=leaves[0]), head_w1=leaves[1])
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
