"""The port's batch mode and stacked train step against the JAX package.

- The standard GRU rows train: one ``mr_train_step`` on ``gru`` (unfused and
  fused) and ``gru_kernel`` matches ``jax.value_and_grad`` from converted
  parameters (1e-4 relative, atol 1e-6), and the ``time_scale`` gradient,
  which the standard GRU never reads, is exactly 0.
- ``engine.stacked_train_step`` (the counterpart of ``jax.vmap`` of the train
  step) against a per-slot loop of ``mr_train_step`` (<= 1e-6) and against
  JAX's vmapped ``mr_train_step`` on carried parameters and AdamW state
  (1e-4 relative).
- ``recover_many`` against ``recover_one`` system by system, ``stack_systems``
  against JAX's, and ``run_batch`` learning each system (as
  ``tests/test_engine.py:102``), at JAX's own test sizes.
- What batch mode builds (the fused and ``*_kernel`` rows) and refuses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import merinda as jmerinda
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.data.windows import make_windows as jmake_windows
from repro.optim import adamw_init as jadamw_init
from repro_torch import api, convert
from repro_torch.core import engine, merinda, ode
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_index, tree_leaves, tree_map, tree_stack

STEP = dict(rtol=1e-4, atol=1e-6)
SYSTEM_SET = ["lorenz", "damped_oscillator", "controlled_pendulum"]
SMALL = dict(state_dim=3, input_dim=1, order=2, hidden=8, dense_hidden=16, dt=0.01)


@functools.lru_cache(maxsize=1)
def _lotka_windows():
    _, ys, us = jgenerate("lotka_volterra")
    return jmake_windows(ys, us, window=32, stride=4)


@pytest.mark.parametrize(
    "encoder,fused", [("gru", False), ("gru", True), ("gru_kernel", False)],
    ids=["gru", "gru-fused", "gru_kernel"],
)  # fmt: skip
def test_standard_gru_train_step_matches_jax(encoder, fused):
    yw, _, norm = _lotka_windows()
    kw = dict(state_dim=2, order=2, hidden=32, dense_hidden=64, dt=0.05)
    jcfg = jmerinda.MRConfig(encoder="gru", **kw)
    cfg = merinda.MRConfig(encoder=encoder, fused=fused, **kw)
    jp = jmerinda.init_mr(jax.random.key(3), jcfg)
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    jphys, phys = jengine.make_phys(jcfg, norm), engine.make_phys(cfg, norm, "cpu")
    ys = torch.from_numpy(yw)

    (jloss, _), jgrads = jax.value_and_grad(jmerinda.mr_loss, has_aux=True)(
        jp, jcfg, jnp.asarray(yw), None, jphys
    )
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    loss, _ = merinda.mr_loss(leaves, cfg, ys, None, phys)
    grads = torch.autograd.grad(
        loss, tree_leaves(leaves), allow_unused=True, materialize_grads=True
    )
    np.testing.assert_allclose(loss.item(), float(jloss), **STEP)
    for got, want in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    assert not np.asarray(jgrads.encoder.time_scale).any()

    jp2, _, jm = jmerinda.mr_train_step(jp, jadamw_init(jp), jcfg, jnp.asarray(yw), None, 3e-3,
                                        jphys)  # fmt: skip
    p2, opt2, m = merinda.mr_train_step(p, adamw_init(p), cfg, ys, None, 3e-3, phys)
    for k in ("loss", "recon_mse", "sparsity_l1", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), err_msg=k, **STEP)
    # a zero gradient: the moments stay 0 and only weight decay moves time_scale
    assert not opt2.m.encoder.time_scale.any() and not opt2.v.encoder.time_scale.any()
    assert torch.equal(p2.encoder.time_scale, p.encoder.time_scale)


def _stacked_inputs(S=3, B=5, T=8, seed=0):
    rng = np.random.default_rng(seed)
    ys = rng.standard_normal((S, B, T, 3)).astype(np.float32)
    us = rng.standard_normal((S, B, T, 1)).astype(np.float32)
    return ys, us


@pytest.mark.parametrize("encoder", ["gru_flow", "gru"])
def test_stacked_step_matches_a_per_slot_loop(encoder):
    """Two stacked steps against a loop of ``mr_train_step``, each slot with
    its own learning rate and AdamW state."""
    cfg = merinda.MRConfig(encoder=encoder, **SMALL)
    per_slot = [merinda.init_mr(g, cfg, "cpu") for g in engine.system_generators(0, 3, "cpu")]
    params, opt = tree_stack(per_slot), tree_stack([adamw_init(p) for p in per_slot])
    loop_o = [adamw_init(p) for p in per_slot]
    ys, us = map(torch.from_numpy, _stacked_inputs())
    lr = torch.tensor([1e-3, 2e-3, 3e-3])
    for _ in range(2):
        params, opt, m = engine.stacked_train_step(params, opt, cfg, ys, us, lr)
        for i in range(3):
            per_slot[i], loop_o[i], mi = merinda.mr_train_step(
                per_slot[i], loop_o[i], cfg, ys[i], us[i], lr[i]
            )
            for k in mi:
                np.testing.assert_allclose(m[k][i].item(), mi[k].item(), rtol=0, atol=1e-6)
    assert opt.step.tolist() == [2, 2, 2]
    for i in range(3):
        pairs = zip(tree_leaves((tree_index(params, i), tree_index(opt, i))),
                    tree_leaves((per_slot[i], loop_o[i])))  # fmt: skip
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_stacked_step_matches_jax_vmap_on_carried_state():
    """JAX's vmapped train step and the port's stacked step from the same
    (params, AdamW state) after one JAX step: the metrics of the second step
    and the updated AdamW moments agree to 1e-4 relative."""
    jcfg = jmerinda.MRConfig(encoder="gru_flow", **SMALL)
    cfg = merinda.MRConfig(encoder="gru_flow", **SMALL)
    ys, us = _stacked_inputs(seed=1)
    keys = jax.random.split(jax.random.key(5), 3)
    jp = jax.vmap(lambda k: jmerinda.init_mr(k, jcfg))(keys)
    jo = jax.vmap(jadamw_init)(jp)
    lr = jnp.asarray([1e-3, 2e-3, 3e-3])

    def jstep(p, o):
        return jax.vmap(lambda p, o, y, u, r: jmerinda.mr_train_step(p, o, jcfg, y, u, r))(
            p, o, jnp.asarray(ys), jnp.asarray(us), lr
        )

    jp, jo, _ = jstep(jp, jo)  # carry a state with non-zero moments across
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    o = convert.opt_from_numpy(jax.tree.map(np.asarray, jo))
    jp2, jo2, jm = jstep(jp, jo)
    _, o2, m = engine.stacked_train_step(
        p, o, cfg, torch.from_numpy(ys), torch.from_numpy(us), torch.tensor(np.asarray(lr))
    )
    for k in ("loss", "recon_mse", "sparsity_l1", "grad_norm"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), err_msg=k, **STEP)
    got, want = convert.opt_to_numpy(o2), jax.tree.map(np.asarray, jo2)
    np.testing.assert_array_equal(got.step, want.step)
    for a, b in zip(jax.tree.leaves(got.m), jax.tree.leaves(want.m)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_opt_state_crosses_the_bridge():
    jcfg = jmerinda.MRConfig(encoder="gru", **SMALL)
    jp = jmerinda.init_mr(jax.random.key(0), jcfg)
    jo = jadamw_init(jp)
    o = convert.opt_from_numpy(jax.tree.map(np.asarray, jo))
    assert o.step.dtype == torch.int32 and o.step.shape == ()
    back = convert.opt_to_numpy(o)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jo))):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=1)
def _stacked_systems():
    return engine.stack_systems(SYSTEM_SET, n_samples=400)


def test_stack_systems_matches_jax():
    ys, us, norms, cfg = _stacked_systems()
    jys, jus, jnorms, jcfg = jengine.stack_systems(SYSTEM_SET, n_samples=400)
    assert ys.shape == jys.shape and us.shape == jus.shape
    # z-scored windows: the float32 RK4 trajectories agree to ~1e-4 relative,
    # and 400 samples of chaotic Lorenz carry that to ~2e-4 here
    np.testing.assert_allclose(ys, np.asarray(jys), rtol=0, atol=1e-3)
    np.testing.assert_allclose(us, np.asarray(jus), rtol=1e-4, atol=1e-5)
    for f in ("state_dim", "input_dim", "order", "hidden", "dense_hidden", "dt"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for a, b in zip(norms, jnorms):
        np.testing.assert_allclose(a["mean"], b["mean"], rtol=1e-4, atol=1e-4)


def test_recover_many_matches_recover_one_per_system():
    ys, us, _, cfg = _stacked_systems()
    ys, us = torch.from_numpy(ys[:, :12]), torch.from_numpy(us[:, :12])
    gens = engine.system_generators(7, 3, "cpu")
    thetas = engine.recover_many(cfg, ys, us, gens, torch.Generator(), steps=6, n_active=5)
    assert thetas.shape == (3, cfg.n_terms, cfg.state_dim)
    for i, g in enumerate(engine.system_generators(7, 3, "cpu")):
        theta = engine.recover_one(cfg, ys[i], us[i], g, steps=6, n_active=5)
        np.testing.assert_allclose(thetas[i].numpy(), theta.numpy(), rtol=0, atol=1e-6)
        assert int((theta != 0).sum()) <= 5


def _recon_mse(theta: torch.Tensor, cfg, ys: torch.Tensor, us: torch.Tensor) -> float:
    """Windows re-simulated from one Theta [n_terms, n] against the data."""
    y_est = ode.odeint(
        merinda._recovered_dynamics(cfg), ys[:, 0], torch.arange(ys.shape[1]) * cfg.dt,
        us=us.transpose(0, 1), args=theta.expand(ys.shape[0], *theta.shape), method="rk4",
    )  # fmt: skip
    return ((y_est.transpose(0, 1) - ys) ** 2).mean().item()


def test_run_batch_learns_each_system():
    """As ``tests/test_engine.py:102`` (training at batch 64 must more than
    halve each system's loss), with the three systems trained as one stacked
    run through ``compile_plan(mode="batch").run_batch``: each system's
    windows, re-simulated from its recovered Theta, fit at least twice as well
    as from the Theta of its initial weights. 60 steps, half of the JAX
    test's 120, keep the file inside its time budget; they already halve the
    error of every system (0.35 against 1.20, 0.039 against 0.092 and 0.044
    against 0.120 on the CPU)."""
    ys, us, _, cfg = _stacked_systems()
    spec = api.RecoverySpec(
        state_dim=cfg.state_dim, input_dim=cfg.input_dim, order=cfg.order, hidden=cfg.hidden,
        dense_hidden=cfg.dense_hidden, dt=cfg.dt, mode="batch", steps=60, batch_size=64, seed=7,
    )  # fmt: skip
    plan = api.compile_plan(spec, device="cpu")
    assert plan.lowering.tick_kernel is None and plan.lowering.dispatch == "reference"
    theta = plan.run_batch(ys, us)
    assert theta.shape == (3, cfg.n_terms, cfg.state_dim) and torch.isfinite(theta).all()
    ys, us = torch.from_numpy(ys), torch.from_numpy(us)
    for i, g in enumerate(engine.system_generators(7, 3, "cpu")):
        p0 = merinda.init_mr(g, cfg, "cpu")
        theta0 = merinda.recover_coefficients(p0, cfg, ys[i], us[i])
        final, first = _recon_mse(theta[i], cfg, ys[i], us[i]), _recon_mse(theta0, cfg, ys[i], us[i])
        assert final < 0.5 * first, (SYSTEM_SET[i], final, first)


def test_batch_mode_refuses_what_is_not_ported():
    """The fused and ``*_kernel`` rows build (their slot-axis kernels are
    ported); what is not ported, or has no int8 stage, still raises."""
    base = dict(state_dim=3, mode="batch")
    for kw in (dict(fused=True), dict(fused=True, encoder="gru"), dict(fused=True, encoder="ltc"),
               dict(fused=True, encoder="node"), dict(encoder="gru_kernel"),
               dict(encoder="gru_flow_kernel")):  # fmt: skip
        low = api.compile_plan(api.RecoverySpec(**base, **kw), device="cpu").lowering
        assert (low.fused, low.kernel) == (kw.get("fused", False), "kernel" in low.encoder), kw
    # int8 serving is ported, but the default gru_flow row has no int8 stage
    with pytest.raises(ValueError, match="int8_pwl"):
        api.compile_plan(api.RecoverySpec(**base, precision="int8_pwl"), device="cpu")
    with pytest.raises(ValueError, match="requires mode='stream'"):
        api.RecoverySpec(**base, tick=api.TickSpec())
    plan = api.compile_plan(api.RecoverySpec(**base), device="cpu")
    with pytest.raises(ValueError, match="mode='batch'"):
        plan.run_offline(np.zeros((4, 8, 3), np.float32))


def test_system_generators_are_reproducible():
    a = [torch.randn(3, generator=g) for g in engine.system_generators(4, 3, "cpu")]
    b = [torch.randn(3, generator=g) for g in engine.system_generators(4, 3, "cpu")]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
