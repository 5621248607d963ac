"""repro_torch's train step (``parallel/steps.py`` ``make_train_step``)
against the JAX package's ``train_loss`` -> ``jax.grad`` ->
``clip_by_global_norm(., 1.0)`` -> ``adamw_update(lr=3e-4,
weight_decay=0.1)``: three steps of the port's step, each beside JAX's step
from the same state (the port's parameters, m, v and step count, so the
second and third steps run Adam from non-zero moments) on the same batch,
for mamba2-130m, zamba2-1.2b, qwen2.5-3b, moonshot-v1-16b-a3b (the capacity
MoE) and merinda-gru at SMOKE in float32; microbatching; bf16 gradients
through the clip; a ``TrainState`` through the checkpoint manager.

Tolerances: each step's loss and gradient norm within 1e-4 absolute plus
1e-4 relative (the gradients' tolerance). The updated parameters within
1e-5 absolute plus 1e-5 relative, plus 2 * lr where the element's JAX
gradient lies within the gradient tolerance (1e-4) of 0: Adam moves an
element by about lr * sign(g) (exactly so at the first step), so an element
whose gradient is within the tolerance of 0 may step the other way in the
port, 2 * lr apart. m within 2e-5 plus 1e-4 relative (0.1 of two gradient
tolerances), v within 1e-8 plus 1e-4 relative. Each step starts from the
port's own state because a flipped element, 6e-4 away, moves the next
gradients past their tolerance (zamba2 SMOKE's gradient norm, ~29, by 2e-4
of it after one step).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.optim import AdamWState
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeConfig
from repro_torch.optim import clip_by_global_norm
from repro_torch.parallel import TrainState, init_train_state, make_train_step
from repro_torch.tree import tree_leaves
from test_torch_train_lm import (
    F32_TOL,
    close,
    configs,
    flat,
    make_batch,
    models,
    port_loss_and_grads,
    torch_batch,
)

LR, WD, STEPS, G_TOL = 3e-4, 0.1, 3, 1e-4
ARCHS = ["mamba2-130m", "zamba2-1.2b", "qwen2.5-3b", "moonshot-v1-16b-a3b", "merinda-gru"]


@functools.lru_cache(maxsize=None)
def jax_step(arch: str):
    """JAX's step: (params, opt, batch) -> (params, opt, loss, grad_norm, raw grads)."""
    jcfg, _ = configs(arch, "float32")

    def step(params, opt, batch):
        (loss, _), g = jax.value_and_grad(lambda p: JM.train_loss(p, batch, jcfg), has_aux=True)(params)
        clipped, gnorm = jclip(g, 1.0)
        params, opt = jadamw_update(clipped, opt, params, lr=LR, weight_decay=WD)
        return params, opt, loss, gnorm, g

    return jax.jit(step)


def _state(params) -> TrainState:
    zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)
    return TrainState(params=params, m=_map(zeros, params), v=_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32))  # fmt: skip


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _numpy(tree):
    return _map(lambda t: t.detach().numpy().copy(), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_jax(arch):
    _, cfg, _, params = models(arch, "float32", seed=1)
    B, S = 2, 32
    step_fn = make_train_step(cfg, ShapeConfig("t", S, B, "train"), "cpu", lr=LR, weight_decay=WD)
    state = _state(params)
    for i in range(STEPS):
        batch = make_batch(cfg, B, S, seed=10 + i)
        jopt = AdamWState(step=jnp.asarray(state.step.numpy()), m=_numpy(state.m), v=_numpy(state.v))
        jparams, jopt, jloss, jgnorm, jg = jax_step(arch)(_numpy(state.params), jopt, batch)
        state, metrics = step_fn(state, torch_batch(batch))
        close(metrics["loss"], jloss, F32_TOL, f"loss at step {i}")
        close(metrics["grad_norm"], jgnorm, F32_TOL, f"grad norm at step {i}")
        assert int(state.step) == int(jopt.step) == i + 1
        loose = flat(jax.tree.map(lambda g: np.abs(np.asarray(g)) <= G_TOL, jg))
        want = {f: flat(jax.tree.map(np.asarray, t)) for f, t in
                (("params", jparams), ("m", jopt.m), ("v", jopt.v))}  # fmt: skip
        got = {"params": flat(state.params), "m": flat(state.m), "v": flat(state.v)}
        assert sorted(got["params"]) == sorted(want["params"])
        for path, p in got["params"].items():
            err = np.abs(p.numpy() - want["params"][path])
            bound = 1e-5 + 1e-5 * np.abs(want["params"][path]) + 2 * LR * loose[path]
            assert np.all(err <= bound), (i, path, float(err.max()), int(loose[path].sum()))
            close(got["m"][path], want["m"][path], dict(atol=2e-5, rtol=1e-4), f"m {path}")
            close(got["v"][path], want["v"][path], dict(atol=1e-8, rtol=1e-4), f"v {path}")
    for leaf in tree_leaves((state.params, state.m, state.v)):
        assert leaf.dtype == torch.float32


def test_microbatches_match_one_batch():
    """mamba2-130m SMOKE, a batch of 4 with every label set: microbatch=2
    (two slices of 2, their gradients summed in float32 and halved) against
    microbatch=1: the loss (the mean of the slices' CE, equal to the batch's
    when every slice has as many labels), the gradient norm and the updated
    parameters within the step tolerances."""
    _, cfg, _, params = models("mamba2-130m", "float32", seed=2)
    shape = ShapeConfig("t", 32, 4, "train")
    batch = make_batch(cfg, 4, 32, seed=20)
    batch["labels"][0, :3] = 7
    tb = torch_batch(batch)
    _, _, grads = port_loss_and_grads(params, tb, cfg)
    one, m1 = make_train_step(cfg, shape, "cpu", lr=LR, weight_decay=WD)(_state(params), tb)
    two, m2 = make_train_step(cfg, shape, "cpu", lr=LR, weight_decay=WD, microbatch=2)(_state(params), tb)
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        close(m2[k], m1[k].numpy(), F32_TOL, k)
    for path, p in flat(two.params).items():
        err = (p - flat(one.params)[path]).abs().numpy()
        bound = 1e-5 + 2 * LR * (grads[path].abs().numpy() <= G_TOL)
        assert np.all(err <= bound), path
    with pytest.raises(ValueError, match="microbatch 3 must divide batch 4"):
        make_train_step(cfg, shape, "cpu", microbatch=3)


def test_bf16_gradients_clip_through_float32():
    """bf16 gradients: the clip scales each in float32 and rounds back, as
    JAX's ``clip_by_global_norm``; the result within one bf16 rounding of
    JAX's (the two norms are summed in other orders)."""
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((64, 32)), "b": {"c": rng.standard_normal(300) * 4}}
    bf = _map(lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), grads)
    clipped, norm = clip_by_global_norm(bf, 1.0)
    jclipped, jnorm = jclip(_map(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), bf), 1.0)
    close(norm, jnorm, dict(atol=0, rtol=1e-6))
    for path, g in flat(clipped).items():
        assert g.dtype == torch.bfloat16
        want = np.asarray(flat(jclipped)[path], np.float32)
        close(g, want, dict(atol=0, rtol=2**-8), path)


def test_a_bf16_step_keeps_the_dtypes():
    """zamba2 SMOKE in bf16: params stay bf16, m and v float32, the loss
    finite, the embedding moved (a step of lr = 3e-4 is below a bf16 norm
    scale's rounding at 1.0, 2^-8, so those stay, as in the JAX package)."""
    _, cfg = configs("zamba2-1.2b", "bfloat16")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    step_fn = make_train_step(cfg, ShapeConfig("t", 32, 2, "train"), "cpu")
    new, metrics = step_fn(state, torch_batch(make_batch(cfg, 2, 32)))
    assert np.isfinite(metrics["loss"].item()) and int(new.step) == 1
    for old, p in zip(tree_leaves(state.params), tree_leaves(new.params)):
        assert p.dtype == old.dtype
    assert {leaf.dtype for leaf in tree_leaves((new.m, new.v))} == {torch.float32}
    assert not torch.equal(new.params["embed"]["tokens"], state.params["embed"]["tokens"])
    assert torch.equal(new.params["final_norm"]["scale"], state.params["final_norm"]["scale"])


def test_train_state_round_trips_through_the_checkpoint_manager(tmp_path):
    """A bf16 ``TrainState`` saved at step 0 and 2 (``save_every=2``) and
    restored bit for bit, its leaves' dtypes kept; ``save_every=0`` writes
    nothing, step 0 included."""
    _, cfg = configs("mamba2-130m", "bfloat16")
    state = init_train_state(torch.Generator().manual_seed(4), cfg, "cpu")
    step_fn = make_train_step(cfg, ShapeConfig("t", 16, 2, "train"), "cpu")
    state, _ = step_fn(state, torch_batch(make_batch(cfg, 2, 16)))
    mgr = CheckpointManager(tmp_path / "ck", save_every=2)
    for step in range(3):
        mgr.maybe_save(step, state)
    mgr.wait()
    assert mgr.latest() == 2
    like = init_train_state(torch.Generator().manual_seed(5), cfg, "cpu")
    restored, manifest = mgr.restore_latest(like)
    assert manifest["leaves"]["params/embed/tokens"]["dtype"] == "bfloat16"
    assert isinstance(restored, TrainState)
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    none = CheckpointManager(tmp_path / "none", save_every=0)
    none.maybe_save(0, state)
    none.wait()
    assert none.latest() is None and not (tmp_path / "none").exists()


def test_an_inference_shape_is_refused():
    _, cfg = configs("mamba2-130m", "float32")
    with pytest.raises(ValueError, match="prefill shape"):
        make_train_step(cfg, ShapeConfig("p", 32, 2, "prefill"), "cpu")
