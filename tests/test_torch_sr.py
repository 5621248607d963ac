"""The port's SINDy and PINN-SR baselines and LR schedules against the JAX package.

- schedules: ``cosine_schedule`` and ``linear_warmup_cosine`` at int and
  tensor steps, to 1e-7;
- SINDy on the systems of ``tests/test_mr.py:97-125`` (the JAX package's
  trajectories): the same active set, and coefficients within 1e-4 of the
  fit's scale (the largest coefficient's magnitude, at least 1). Lorenz's
  full-library gram has a float32 condition number near 1e8, so two LAPACK
  builds part by 9.4e-4 on its 27.8 coefficient (3.4e-5 of it); the
  Lotka-Volterra and pathogen fits agree to 2.3e-6;
- PINN-SR from JAX parameters carried over: ``mlp_x`` and dx_hat/dt (the
  tangent carried by hand) against ``jax.jvp`` to 1e-5; ``pinn_sr_loss`` and
  its gradient to 1e-5 relative; 250 training steps across one thresholding
  with the recovered Xi within 1e-3. That run is the z-scored damped
  oscillator: Adam steps amplify last-bit differences on raw Lorenz (the JAX
  package against itself with weights perturbed by 1e-7 relative parts by
  2.8e-2 in Xi after 250 steps), not on it (3e-7);
- ``launch/recover_aid`` end to end on the CPU at a few steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pinn_sr as jpinn
from repro.core import sindy as jsindy
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.data.dynamics import get_system as jget_system
from repro.optim import schedules as jschedules
from repro_torch import convert
from repro_torch.core import pinn_sr, sindy
from repro_torch.launch import recover_aid
from repro_torch.optim import cosine_schedule, linear_warmup_cosine
from repro_torch.tree import tree_leaves, tree_unflatten


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def test_schedules_match_jax():
    steps = np.arange(0, 130, 7, dtype=np.int32)
    pairs = ((cosine_schedule(3e-3, 100), jschedules.cosine_schedule(3e-3, 100)),
             (cosine_schedule(1e-2, 0, final_frac=0.0), jschedules.cosine_schedule(1e-2, 0, 0.0)),
             (linear_warmup_cosine(3e-3, 10, 100), jschedules.linear_warmup_cosine(3e-3, 10, 100)),
             (linear_warmup_cosine(1e-3, 0, 50, 0.2),
              jschedules.linear_warmup_cosine(1e-3, 0, 50, 0.2)))  # fmt: skip
    for got_fn, want_fn in pairs:
        want = np.asarray(want_fn(jnp.asarray(steps)))
        np.testing.assert_allclose(got_fn(_t(steps)).numpy(), want, rtol=0, atol=1e-7)
        assert abs(float(got_fn(37)) - float(want_fn(jnp.int32(37)))) <= 1e-7
        assert got_fn(_t(steps)).dtype == torch.float32


# ---------------------------------------------------------------------------
# SINDy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("system,threshold", [("lorenz", 0.1), ("lotka_volterra", 0.02),
                                              ("pathogen", 0.02)])  # fmt: skip
def test_sindy_matches_jax(system, threshold):
    spec = jget_system(system)
    _, ys, _ = jgenerate(system)
    want = jsindy.fit_sindy(jnp.asarray(ys), dt=spec.dt, order=2, threshold=threshold)
    got = sindy.fit_sindy(_t(ys), dt=spec.dt, order=2, threshold=threshold)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    coef = np.asarray(want.coef)
    scale = max(1.0, float(np.abs(coef).max()))
    assert float(np.abs(got.coef.numpy() - coef).max()) <= 1e-4 * scale
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=1e-3)
    # the recovered sparsity is the true one (tests/test_mr.py:97)
    if system == "lorenz":
        assert ((np.abs(spec.true_coef()) > 0) == got.mask.numpy()).all()


def test_sindy_pieces_match_jax():
    """Derivatives exactly; one masked ridge solve (Lotka-Volterra, a random
    active set) within 1e-4 of its scale; and the recovered model's
    right-hand side."""
    spec = jget_system("lotka_volterra")
    _, ys, _ = jgenerate("lotka_volterra")
    np.testing.assert_array_equal(
        sindy.finite_difference(_t(ys), spec.dt).numpy(),
        np.asarray(jsindy.finite_difference(jnp.asarray(ys), spec.dt)),
    )
    from repro.core.library import polynomial_features as jfeatures

    theta = np.asarray(jfeatures(jnp.asarray(ys), 2, 2))
    dx = np.asarray(jsindy.finite_difference(jnp.asarray(ys), spec.dt))
    mask = (np.random.default_rng(0).uniform(size=(theta.shape[1], 2)) > 0.3).astype(np.float32)
    want = np.asarray(jsindy._masked_ridge(jnp.asarray(theta), jnp.asarray(dx), jnp.asarray(mask),
                                           1e-5))  # fmt: skip
    got = sindy._masked_ridge(_t(theta), _t(dx), _t(mask), 1e-5).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4 * max(1.0, float(np.abs(want).max()))
    coef = np.asarray(jsindy.fit_sindy(jnp.asarray(ys), dt=spec.dt, order=2, threshold=0.02).coef)
    f, jf = sindy.sindy_dynamics(2), jsindy.sindy_dynamics(2)
    np.testing.assert_allclose(f(_t(ys[:5]), None, 0.0, _t(coef)).numpy(),
                               np.asarray(jf(jnp.asarray(ys[:5]), None, 0.0, jnp.asarray(coef))),
                               rtol=1e-6, atol=1e-6)  # fmt: skip


# ---------------------------------------------------------------------------
# PINN-SR
# ---------------------------------------------------------------------------
def _pinn_case(system="lorenz", zscore=False, width=32, fourier_k=8, input_dim=0):
    jcfg = jpinn.PinnSRConfig(state_dim=jget_system(system).state_dim, input_dim=input_dim,
                              width=width, fourier_k=fourier_k)  # fmt: skip
    cfg = pinn_sr.PinnSRConfig(state_dim=jcfg.state_dim, input_dim=input_dim, width=width,
                               fourier_k=fourier_k)  # fmt: skip
    ts, ys, _ = jgenerate(system, n_samples=200)
    ys = np.asarray(ys, np.float32)
    if zscore:
        ys = (ys - ys.mean(0)) / ys.std(0)
    return jcfg, cfg, np.asarray(ts, np.float32), ys.astype(np.float32)


def test_mlp_and_its_time_derivative_match_jax_jvp():
    jcfg, _, ts, _ = _pinn_case()
    jp = jpinn.init_pinn_sr(jax.random.key(0), jcfg)
    p = convert.pinn_params_from_numpy(jax.tree.map(np.asarray, jp))
    tn = ((ts - ts.mean()) / ts.std()).astype(np.float32)
    want_x = np.asarray(jpinn.mlp_x(jp, jnp.asarray(tn)))
    _, want_dx = jax.jvp(lambda t: jpinn.mlp_x(jp, t), (jnp.asarray(tn),),
                         (jnp.ones_like(jnp.asarray(tn)),))  # fmt: skip
    got_x, got_dx = pinn_sr.mlp_x(p, _t(tn), tangent=True)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=0, atol=1e-5)
    assert torch.equal(pinn_sr.mlp_x(p, _t(tn)), got_x)


@pytest.mark.parametrize("input_dim", [0, 1])
def test_pinn_loss_and_gradient_match_jax(input_dim):
    jcfg, cfg, ts, ys = _pinn_case(input_dim=input_dim)
    jp = jpinn.init_pinn_sr(jax.random.key(1), jcfg)
    jp = jp._replace(xi=0.1 * jax.random.normal(jax.random.key(2), jp.xi.shape))
    p = convert.pinn_params_from_numpy(jax.tree.map(np.asarray, jp))
    tn = ((ts - ts.mean()) / ts.std()).astype(np.float32)
    us = np.sin(ts)[:, None].astype(np.float32) if input_dim else None
    (jloss, jaux), jgrad = jax.value_and_grad(jpinn.pinn_sr_loss, has_aux=True)(
        jp, jcfg, jnp.asarray(tn), jnp.asarray(ys), None if us is None else jnp.asarray(us)
    )
    leaves = [leaf.clone().requires_grad_(True) for leaf in tree_leaves(p)]
    loss, aux = pinn_sr.pinn_sr_loss(tree_unflatten(p, leaves), cfg, _t(tn), _t(ys),
                                     None if us is None else _t(us))  # fmt: skip
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in ("data_mse", "phys_mse", "l1"):
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k
    for g, w in zip(grads, jax.tree.leaves(jgrad)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * max(float(np.abs(w).max()), 1e-30)


def test_pinn_training_across_a_thresholding_matches_jax():
    """250 steps (lr 1e-2, thresholding at step 200) from the same initial
    parameters on both packages: recovered Xi and the mask leaf within 1e-3,
    the same terms pruned."""
    jcfg, cfg, ts, ys = _pinn_case("damped_oscillator", zscore=True)
    jparams, jhist = jpinn.train_pinn_sr(jcfg, jnp.asarray(ts), jnp.asarray(ys), steps=250,
                                         lr=1e-2, seed=0)  # fmt: skip
    start = convert.pinn_params_from_numpy(
        jax.tree.map(np.asarray, jpinn.init_pinn_sr(jax.random.key(0), jcfg))
    )
    params, hist = pinn_sr.train_pinn_sr(cfg, _t(ts), _t(ys), steps=250, lr=1e-2, params=start)
    want = np.asarray(jpinn.recovered_xi(jparams))
    assert float(np.abs(pinn_sr.recovered_xi(params).numpy() - want).max()) <= 1e-3
    # the mask is a trained leaf: thresholding zeroes it, AdamW moves it on
    jmask = np.asarray(jparams.xi_mask)
    np.testing.assert_allclose(params.xi_mask.numpy(), jmask, rtol=0, atol=1e-3)
    pruned = np.abs(jmask) < 0.5
    assert 0 < pruned.sum() < pruned.size
    np.testing.assert_array_equal(params.xi_mask.abs().numpy() < 0.5, pruned)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 100, 200]
    for h, jh in zip(hist, jhist):
        assert abs(h["loss"] - jh["loss"]) <= 1e-3 * abs(jh["loss"])


def test_pinn_init_draws_from_the_generator():
    cfg = pinn_sr.PinnSRConfig(state_dim=2, width=16, depth=3, fourier_k=4)
    a = pinn_sr.init_pinn_sr(torch.Generator().manual_seed(0), cfg, "cpu")
    b = pinn_sr.init_pinn_sr(torch.Generator().manual_seed(0), cfg, "cpu")
    assert [w.shape for w, _ in a.mlp] == [(9, 16), (16, 16), (16, 2)]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert a.xi.shape == (cfg.n_terms, 2) and bool((a.xi_mask == 1).all())


# ---------------------------------------------------------------------------
# the AID case study
# ---------------------------------------------------------------------------
def test_recover_aid_runs_on_the_cpu():
    results = recover_aid.run(steps=3, device="cpu", verbose=False)
    assert list(results) == [name for name, *_ in recover_aid.PLANS] + ["SINDy (STLSQ)"]
    assert all(np.isfinite(err) and err > 0 for err, _ in results.values())
