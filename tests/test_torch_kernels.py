"""repro_torch's mr_step and gru_scan against the JAX package's kernels.

The port's plain versions run on the CPU here and are held against the JAX
ops run as the JAX package's own tests run them on the CPU: the Pallas kernel
body under the interpreter (``interpret=True``) and the pure-JAX reference
(``force_reference=True``). Inputs are made with numpy from a seed; JAX
parameters reach the port through ``repro_torch.convert``.

Tolerance: <= 1e-4 in float32, the JAX package's own bound for its fused
kernels (tests/test_kernels_mr_step.py:7-11); the two frameworks sum the gate
products in different orders.

The CUDA kernels against their plain versions are in ``test_torch_cuda.py``,
which imports no JAX so that it runs on the card too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.merinda import MRConfig as JMRConfig
from repro.core.merinda import init_mr as jinit_mr
from repro.core.neural_flow import init_gru as jinit_gru
from repro.kernels.gru_scan.ops import gru_scan as jgru_scan
from repro.kernels.mr_step.ops import mr_step as jmr_step
from repro_torch.convert import params_from_numpy
from repro_torch.core.merinda import MRConfig
from repro_torch.core.neural_flow import GRUParams
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.gru_scan.ops import gru_scan, gru_scan_cuda
from repro_torch.kernels.gru_scan.ref import gru_scan_reference
from repro_torch.kernels.mr_step.ops import mr_step, mr_step_cuda
from repro_torch.kernels.mr_step.ref import mr_step_reference

TOL = dict(atol=1e-4, rtol=1e-4)

# (B, T, n_state, hidden, dense_hidden): tests/test_kernels_mr_step.py:26-32
SHAPES = [
    (1, 4, 2, 8, 16),
    (2, 16, 3, 32, 64),
    (4, 33, 3, 16, 32),  # odd T
    (8, 7, 2, 64, 128),  # hardware-aligned H
]
QUICKSTART = (64, 32, 2, 32, 64)


def _np(x):
    return np.asarray(x)


def _setup(B, T, n, H, Dh, encoder, seed=0):
    jcfg = JMRConfig(state_dim=n, order=2, hidden=H, dense_hidden=Dh, dt=0.01, encoder=encoder)
    cfg = MRConfig(state_dim=n, order=2, hidden=H, dense_hidden=Dh, dt=0.01, encoder=encoder)
    jparams = jinit_mr(jax.random.key(seed), jcfg)
    xs = np.random.default_rng(seed + 1).standard_normal((B, T, n)).astype(np.float32)
    return jcfg, cfg, jparams, params_from_numpy(jax.tree.map(_np, jparams)), xs


def _port_mr_step(cfg, params, xs, **kw):
    with torch.no_grad():
        theta, shifts = mr_step(params, cfg, torch.from_numpy(xs), **kw)
    return theta.numpy(), shifts.numpy()


@pytest.mark.parametrize("B,T,n,H,Dh", SHAPES)
@pytest.mark.parametrize("encoder", ["gru_flow", "gru"])
def test_mr_step_plain_matches_jax_kernel(B, T, n, H, Dh, encoder):
    """The plain version against the Pallas kernel body and the JAX reference."""
    jcfg, cfg, jparams, params, xs = _setup(B, T, n, H, Dh, encoder)
    theta, shifts = _port_mr_step(cfg, params, xs)
    for kw in (dict(interpret=True), dict(force_reference=True)):
        jt, js = jmr_step(jparams, jcfg, jnp.asarray(xs), **kw)
        np.testing.assert_allclose(theta, _np(jt), **TOL)
        np.testing.assert_allclose(shifts, _np(js), **TOL)


@pytest.mark.parametrize("block_b", [1, 2])
@pytest.mark.parametrize("encoder", ["gru_flow", "gru"])
def test_mr_step_block_b_matches_jax_kernel(block_b, encoder):
    """The Pallas kernel tiled by block_b still agrees with the plain version."""
    jcfg, cfg, jparams, params, xs = _setup(8, 10, 3, 16, 32, encoder, seed=3)
    theta, _ = _port_mr_step(cfg, params, xs, block_b=block_b)
    jt, _ = jmr_step(jparams, jcfg, jnp.asarray(xs), block_b=block_b, interpret=True)
    np.testing.assert_allclose(theta, _np(jt), **TOL)


@pytest.mark.parametrize("encoder", ["gru_flow", "gru"])
def test_mr_step_quickstart_shape_matches_jax_reference(encoder):
    jcfg, cfg, jparams, params, xs = _setup(*QUICKSTART, encoder, seed=5)
    theta, _ = _port_mr_step(cfg, params, xs)
    jt, _ = jmr_step(jparams, jcfg, jnp.asarray(xs), force_reference=True)
    np.testing.assert_allclose(theta, _np(jt), **TOL)


def _gru_setup(B, T, D, H, seed):
    jp = jinit_gru(jax.random.key(seed), D, H)
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B, H))).astype(np.float32)
    ts = (0.5 * rng.standard_normal(H)).astype(np.float32)  # a non-zero time gate
    jp = jp._replace(time_scale=jnp.asarray(ts))
    p = GRUParams(*(torch.from_numpy(_np(x).copy()) for x in jp))
    return jp, p, xs, h0


@pytest.mark.parametrize("B,T,D,H,_Dh", SHAPES)
@pytest.mark.parametrize("flow", [True, False])
def test_gru_scan_plain_matches_jax_kernel(B, T, D, H, _Dh, flow):
    jp, p, xs, h0 = _gru_setup(B, T, D, H, seed=B * 100 + T)
    hT, hs = gru_scan(p, torch.from_numpy(xs), torch.from_numpy(h0), flow=flow)
    for kw in (dict(interpret=True), dict(force_reference=True)):
        jhT, jhs = jgru_scan(jp, jnp.asarray(xs), jnp.asarray(h0), flow=flow, **kw)
        np.testing.assert_allclose(hs.numpy(), _np(jhs), **TOL)
        np.testing.assert_allclose(hT.numpy(), _np(jhT), **TOL)


def test_gru_scan_variable_dt_matches_jax_kernel():
    """Per-step dts, a zero step included (phi(0) = 0 leaves h unchanged)."""
    jp, p, xs, h0 = _gru_setup(2, 6, 3, 16, seed=9)
    dts = np.array([1.0, 0.0, 0.5, 2.0, 0.0, 1.0], np.float32)
    _, hs = gru_scan(p, torch.from_numpy(xs), torch.from_numpy(h0), dts=torch.from_numpy(dts))
    _, jhs = jgru_scan(jp, jnp.asarray(xs), jnp.asarray(h0), dts=jnp.asarray(dts), interpret=True)
    np.testing.assert_allclose(hs.numpy(), _np(jhs), **TOL)
    np.testing.assert_allclose(hs[:, 1].numpy(), hs[:, 0].numpy(), atol=0)


def test_gru_scan_quickstart_shape_matches_jax_reference():
    jp, p, xs, h0 = _gru_setup(64, 32, 2, 32, seed=11)
    _, hs = gru_scan(p, torch.from_numpy(xs), torch.from_numpy(h0))
    _, jhs = jgru_scan(jp, jnp.asarray(xs), jnp.asarray(h0), force_reference=True)
    np.testing.assert_allclose(hs.numpy(), _np(jhs), **TOL)


# ---------------------------------------------------------------------------
# the wrappers' contract, checked off the card
# ---------------------------------------------------------------------------
def _mr_operands(B=4, T=5, D=2, H=8, Dh=16, K=12, device="cpu"):
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g).to(device)
    return (
        mk(B, T, D),
        torch.zeros(B, H, device=device),
        mk(D, 3 * H),
        mk(H, 3 * H),
        mk(3 * H),
        mk(H),
        torch.ones(T, device=device),
        mk(H, Dh),
        mk(Dh),
        mk(Dh, K),
        mk(K),
    )


def test_dispatch_follows_the_tensor_device():
    x = torch.zeros(2)
    assert rt.resolve_dispatch(x) is rt.Dispatch.REFERENCE
    assert rt.resolve_dispatch(x, force_reference=True) is rt.Dispatch.REFERENCE
    assert {d.name for d in rt.Dispatch} == {"KERNEL", "REFERENCE"}


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    ops = _mr_operands()
    before = (mr_step_cuda.launches, gru_scan_cuda.launches)
    with pytest.raises(ValueError, match="must be on"):
        mr_step_cuda(*ops, flow=True, block_b=1)
    with pytest.raises(ValueError, match="must be on"):
        gru_scan_cuda(*ops[:7], flow=True, block_b=1)
    assert (mr_step_cuda.launches, gru_scan_cuda.launches) == before


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(rt.shutil, "which", lambda name: None)
    monkeypatch.setattr(rt.os.path, "exists", lambda path: False)
    monkeypatch.setattr(rt, "BUILD_DIR", rt.REPO_ROOT / "build" / "no-such-dir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rt.build_library()
