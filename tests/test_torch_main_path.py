"""The port's main path against the JAX package: MERINDA offline recovery.

From the same converted initial parameters, on the quickstart's windows
(Lotka-Volterra, window 32, stride 4: 193 windows), at ``batch_size=None``
because ``jax.random`` minibatches cannot be reproduced in torch:

- one ``mr_train_step``: loss, recon_mse, sparsity_l1, grad_norm and every
  gradient leaf within 1e-4 relative (atol 1e-6), with and without the
  physical-unit sparsity term;
- a 10-step ``run_epoch``: the metric trajectories within 1e-3 relative.
  Metrics, not parameters: AdamW's first steps are sign-like, so a gradient
  leaf near 0 can flip sign between frameworks and move a parameter by 2 lr.

Then the whole quickstart spec through ``compile_plan(device="cpu")``, cut
to 30 steps, and the device rule of ``compile_plan``. The same holds for the
paper's LTC and NODE baselines (``encoder="ltc"``/``"node"``, fused) and for
fixed-point QAT on the GRU flow (``qat=QuantConfig(4, 10, 2, 12)``); QAT on
the substep families raises, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import merinda as jmerinda
from repro.core import quant as jquant
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.data.windows import make_windows as jmake_windows
from repro.optim import adamw_init as jadamw_init
from repro_torch import api, convert
from repro_torch.core import encoders, engine, merinda, quant
from repro_torch.data.dynamics import generate_trajectory, get_system
from repro_torch.data.windows import make_windows
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ops import mr_step
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map

DT = 0.05  # lotka_volterra sampling interval
STEP = dict(rtol=1e-4, atol=1e-6)
QAT = (4, 10, 2, 12)  # act int/frac bits, weight int/frac bits


@functools.lru_cache(maxsize=1)
def _windows():
    _, ys, us = jgenerate("lotka_volterra")
    return jmake_windows(ys, us, window=32, stride=4)


def _configs(encoder="gru_flow", fused=True):
    kw = dict(state_dim=2, order=2, hidden=32, dense_hidden=64, dt=DT, encoder=encoder)
    return jmerinda.MRConfig(**kw), merinda.MRConfig(fused=fused, **kw)


def _start(jcfg, seed=0):
    jp = jmerinda.init_mr(jax.random.key(seed), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def _phys(jcfg, cfg, norm, use):
    if not use:
        return None, None
    return jengine.make_phys(jcfg, norm), engine.make_phys(cfg, norm, "cpu")


@pytest.mark.parametrize("use_phys", [False, True])
def test_train_step_loss_and_gradients_match_jax(use_phys):
    yw, _, norm = _windows()
    jcfg, cfg = _configs()
    jp, p = _start(jcfg)
    jphys, phys = _phys(jcfg, cfg, norm, use_phys)
    ys = torch.from_numpy(yw)

    (jloss, jaux), jgrads = jax.value_and_grad(jmerinda.mr_loss, has_aux=True)(
        jp, jcfg, jnp.asarray(yw), None, jphys
    )
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    loss, aux = merinda.mr_loss(leaves, cfg, ys, None, phys)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-6)
    for got, want in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)

    _, _, jm = jmerinda.mr_train_step(
        jp, jadamw_init(jp), jcfg, jnp.asarray(yw), None, 3e-3, jphys
    )
    _, _, m = merinda.mr_train_step(p, adamw_init(p), cfg, ys, None, 3e-3, phys)
    for k in ("loss", "recon_mse", "sparsity_l1", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_ten_step_epoch_metrics_match_jax():
    yw, _, norm = _windows()
    jcfg, cfg = _configs()
    jp, p = _start(jcfg, seed=1)
    jphys, phys = _phys(jcfg, cfg, norm, True)
    _, _, jm = jengine.run_epoch(
        jp, jadamw_init(jp), jnp.asarray(yw), None, jax.random.key(1), 3e-3, jphys,
        cfg=jcfg, steps=10, batch_size=None,
    )  # fmt: skip
    gen = torch.Generator().manual_seed(1)
    _, _, m = engine.run_epoch(
        p, adamw_init(p), torch.from_numpy(yw), None, gen, 3e-3, phys,
        cfg=cfg, steps=10, batch_size=None,
    )  # fmt: skip
    assert set(m) == set(jm)
    for k in jm:
        assert m[k].shape == (10,)
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-3, atol=1e-7, err_msg=k)


def _quickstart_spec(**kw):
    base = dict(
        state_dim=2, order=2, hidden=32, dense_hidden=64, dt=DT, encoder="gru_flow",
        fused=True, block_b="auto", mode="offline", steps=300, lr=3e-3, batch_size=64,
    )  # fmt: skip
    return api.RecoverySpec(**(base | kw))


def test_quickstart_runs_end_to_end_on_the_cpu():
    _, ys, us = generate_trajectory("lotka_volterra")
    yw, uw, norm = make_windows(ys, us, window=32, stride=4)
    plan = api.compile_plan(_quickstart_spec(steps=30), device="cpu")
    assert plan.lowering.dispatch == "reference"
    assert plan.lowering.block_b == 1
    params, metrics = plan.run_offline(yw, uw, norm=norm)
    assert metrics["recon_mse"].shape == (30,)
    assert torch.isfinite(metrics["loss"]).all()
    theta = plan.readout(params, yw, uw, norm=norm, n_active=4)
    assert theta.shape == get_system("lotka_volterra").true_coef().shape == (6, 2)
    assert np.isfinite(theta).all() and np.count_nonzero(theta) <= 4
    assert len(api.history_from_metrics(metrics, log_every=10)) == 3


def test_unfused_kernel_row_takes_the_same_first_step():
    """gru_flow_kernel, fused=False is the same math as the fused stage."""
    yw, _, _ = _windows()
    losses = []
    for spec in (
        _quickstart_spec(steps=1),
        _quickstart_spec(steps=1, encoder="gru_flow_kernel", fused=False, block_b=None),
    ):
        plan = api.compile_plan(spec, device="cpu")
        _, metrics = plan.run_offline(yw)
        losses.append(metrics["loss"][0].item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


def test_compile_plan_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compile_plan(_quickstart_spec())
    assert api.compile_plan(_quickstart_spec(), device="cpu").lowering.device == "cpu"


# ---------------------------------------------------------------------------
# the LTC and NODE baselines and QAT on the main path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "encoder,qat", [("ltc", None), ("node", None), ("gru_flow", QAT)], ids=["ltc", "node", "qat"]
)
def test_baseline_and_qat_train_step_matches_jax(encoder, qat):
    """One fused mr_train_step at batch_size=None from converted params, with phys."""
    yw, _, norm = _windows()
    kw = dict(state_dim=2, order=2, hidden=32, dense_hidden=64, dt=DT, encoder=encoder, fused=True)
    jcfg = jmerinda.MRConfig(**kw, quant=qat and jquant.QuantConfig(*qat))
    cfg = merinda.MRConfig(**kw, quant=qat and quant.QuantConfig(*qat))
    jp = jmerinda.init_mr(jax.random.key(2), jcfg)
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    jphys, phys = jengine.make_phys(jcfg, norm), engine.make_phys(cfg, norm, "cpu")
    ys = torch.from_numpy(yw)

    (jloss, _), jgrads = jax.value_and_grad(jmerinda.mr_loss, has_aux=True)(
        jp, jcfg, jnp.asarray(yw), None, jphys
    )
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    loss, _ = merinda.mr_loss(leaves, cfg, ys, None, phys)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(loss.item(), float(jloss), **STEP)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for got, want in zip(grads, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)

    _, _, jm = jmerinda.mr_train_step(
        jp, jadamw_init(jp), jcfg, jnp.asarray(yw), None, 3e-3, jphys
    )
    _, _, m = merinda.mr_train_step(p, adamw_init(p), cfg, ys, None, 3e-3, phys)
    for k in ("loss", "recon_mse", "sparsity_l1", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), err_msg=k, **STEP)


@pytest.mark.parametrize("encoder", ["ltc", "node"])
def test_baseline_quickstart_runs_end_to_end_on_the_cpu(encoder):
    _, ys, us = generate_trajectory("lotka_volterra")
    yw, uw, norm = make_windows(ys, us, window=32, stride=4)
    plan = api.compile_plan(_quickstart_spec(encoder=encoder, steps=30), device="cpu")
    low = plan.lowering
    assert low.dispatch == "reference" and low.block_b == 1 and not low.qat
    D, H, Dh, K = 2, 32, 64, 12
    assert low.smem_bytes == tiling.family_smem_bytes(encoder, D, H, Dh, K, 1)
    params, metrics = plan.run_offline(yw, uw, norm=norm)
    assert metrics["recon_mse"].shape == (30,)
    assert torch.isfinite(metrics["loss"]).all()
    theta = plan.readout(params, yw, uw, norm=norm, n_active=4)
    assert theta.shape == get_system("lotka_volterra").true_coef().shape == (6, 2)
    assert np.isfinite(theta).all() and np.count_nonzero(theta) <= 4


def test_qat_quickstart_compiles_and_refuses_the_substep_families():
    spec = _quickstart_spec(qat=quant.QuantConfig(*QAT), steps=2)
    plan = api.compile_plan(spec, device="cpu")
    assert plan.lowering.qat and plan.cfg.quant == quant.QuantConfig(*QAT)
    _, metrics = plan.run_offline(*_windows()[:1])
    assert torch.isfinite(metrics["loss"]).all()
    for encoder in ("ltc", "node"):
        with pytest.raises(ValueError, match="implemented for the GRU families"):
            api.compile_plan(dataclasses.replace(spec, encoder=encoder), device="cpu")


def test_compile_plan_refuses_fused_on_a_non_fusable_row(monkeypatch):
    row = encoders.get_encoder("gru")._replace(name="gru_nofuse", fusable=False)
    monkeypatch.setitem(encoders._REGISTRY, "gru_nofuse", row)
    with pytest.raises(ValueError, match="fusable"):
        api.compile_plan(_quickstart_spec(encoder="gru_nofuse"), device="cpu")
    cfg = merinda.MRConfig(state_dim=2, hidden=8, dense_hidden=16, encoder="gru_nofuse")
    params = merinda.init_mr(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="fusable"):
        mr_step(params, cfg, torch.zeros(2, 3, 2))
    plan = api.compile_plan(_quickstart_spec(encoder="gru_nofuse", fused=False), device="cpu")
    assert plan.lowering.smem_bytes is None
