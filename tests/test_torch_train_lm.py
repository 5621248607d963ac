"""repro_torch's LM training forward (``models/model.py`` ``train_loss``)
against the JAX package's, for the ``ssm``, ``hybrid`` and ``gru`` families
at SMOKE: the loss, its metrics and every gradient leaf; the remat policies
and the kernels' calls a step. The ``dense`` family is in
``test_torch_train_dense.py``, the ``moe``, ``vlm`` and ``audio`` families in
``test_torch_train_zoo.py``, the train step in ``test_torch_train_step.py``
and the launcher in ``test_torch_train_launch.py``; they share this file's
helpers (split so that ``--dist loadfile`` spreads the JAX compiles).

The JAX package builds the parameters (``init_params``) and they cross to the
port through ``repro_torch.convert.lm_params_from_numpy``; tokens and labels
are numpy draws from a seed, some labels -1 (no label). JAX's gradients are
``jax.value_and_grad(train_loss)``, compiled once an architecture and dtype;
the port's are ``torch.autograd.grad`` of its ``train_loss``. On the CPU the
port's scans and attention take their plain versions (``ssd_chunked``, the
flash op's dense oracle, ``gru_scan_reference``), JAX's its own references.

Tolerances: float32 (``dataclasses.replace(cfg, dtype="float32")``) loss,
metrics and gradients within 1e-4 absolute plus 1e-4 relative; the bf16
loss within 0.12 (``tests/test_models.py:99``).

On the card a layer's kernel runs twice a step under ``remat="full"`` (the
forward, then the backward's recompute) and the hybrid's shared block's
once; here that dispatch is held with plain functions in the kernels'
place, counted, inside the ops' autograd Functions as on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gru_scan import ops as gru_ops
from repro_torch.kernels.gru_scan.ref import gru_scan_reference
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import model as M

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.12, rtol=0.12)
ARCHS = ["mamba2-130m", "zamba2-1.2b", "merinda-gru"]


# --- helpers shared by the training tests ------------------------------------
def flat(tree, prefix=""):
    """A nested dict's leaves by path ("/layers/attn/wq")."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def configs(arch: str, dtype: str, **changes):
    """(JAX cfg, port cfg) of the SMOKE model in ``dtype`` with ``changes``."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, **changes)
    return jcfg, cfg


def models(arch: str, dtype: str, seed: int = 0, **changes):
    """(JAX cfg, port cfg, JAX params, port params) of the SMOKE model."""
    jcfg, cfg = configs(arch, dtype, **changes)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    return jcfg, cfg, jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams))


def make_batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    """A numpy training batch of S positions: tokens and labels (the first
    three labels of row 0 are -1), ``patches`` [B, num_patches, d] for
    ``vlm`` (S counts them), ``frames`` [B, 4096, 80] for ``audio``."""
    rng = np.random.default_rng(seed)
    T = S - cfg.num_patches if cfg.family == "vlm" else S
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
    }
    batch["labels"][0, :3] = -1
    if cfg.family == "vlm":
        x = rng.standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.02
        batch["patches"] = x.astype(np.float32)
    elif cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, M.AUDIO_SRC_LEN, M.AUDIO_FEAT)).astype(np.float32)
    return batch


def torch_batch(batch: dict) -> dict:
    """The numpy batch as CPU tensors, integer leaves as int64."""
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: v.long() if not v.is_floating_point() else v for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def jax_loss_and_grad(arch: str, dtype: str, **changes):
    """JAX's jitted ``value_and_grad(train_loss)`` of the SMOKE config."""
    jcfg, _ = configs(arch, dtype, **changes)
    return jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(p, b, jcfg), has_aux=True))


@functools.lru_cache(maxsize=None)
def jax_loss(arch: str, dtype: str, **changes):
    """JAX's jitted ``train_loss`` of the SMOKE config."""
    jcfg, _ = configs(arch, dtype, **changes)
    return jax.jit(lambda p, b: JM.train_loss(p, b, jcfg))


def port_loss_and_grads(params, batch: dict, cfg, **kw):
    """The port's (loss, metrics, {path: gradient})."""
    leaves = flat(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss, metrics = M.train_loss(params, batch, cfg, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for leaf in leaves.values():
        leaf.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(leaves, grads))


def close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **tol)  # fmt: skip


def check_against_jax(arch: str, B: int = 2, S: int = 32, **changes) -> None:
    """The port's loss, metrics and every gradient leaf against JAX's, float32."""
    jcfg, cfg, jparams, params = models(arch, "float32", **changes)
    batch = make_batch(cfg, B, S)
    (jl, jm), jg = jax_loss_and_grad(arch, "float32", **changes)(jparams, batch)
    loss, metrics, grads = port_loss_and_grads(params, torch_batch(batch), cfg)
    close(loss, jl, F32_TOL, "loss")
    assert sorted(metrics) == sorted(jm) == ["ce", "moe_aux"]
    for k in metrics:
        close(metrics[k], jm[k], F32_TOL, k)
    jgrads = flat(jax.tree.map(np.asarray, jg))
    assert sorted(grads) == sorted(jgrads)
    for path, g in grads.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == jgrads[path].shape, path
        close(g, jgrads[path], F32_TOL, path)


def check_bf16_loss(arch: str, B: int = 2, S: int = 32) -> None:
    """The bf16 model's loss and metrics against JAX's within BF16_TOL."""
    _, cfg, jparams, params = models(arch, "bfloat16")
    batch = make_batch(cfg, B, S)
    jl, jm = jax_loss(arch, "bfloat16")(jparams, batch)
    with torch.no_grad():
        loss, metrics = M.train_loss(params, torch_batch(batch), cfg)
    close(loss, jl, BF16_TOL, "loss")
    for k in metrics:
        close(metrics[k], jm[k], BF16_TOL, k)
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())


class KernelCalls:
    """Sends the dispatch to the kernels with plain functions in their place,
    inside the ops' autograd Functions, and counts the forward calls."""

    def __init__(self, monkeypatch):
        self.calls: list[str] = []
        monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.KERNEL)

        def flash(q, k, v, *, causal, window, q_offset, block_q, block_k):
            self.calls.append("flash_attention")
            return fa_ops._reference(q, k, v, causal, window, q_offset)

        def ssd(x, dt, A, bm, cm, D, initial_state=None, *, chunk):
            self.calls.append("ssd_scan")
            return ssd_ops.ssd_chunked(x, dt, A, bm, cm, D, chunk=chunk, initial_state=initial_state)

        def scan(*args, flow, block_b=None):
            self.calls.append("gru_scan")
            return gru_scan_reference(*args, flow=flow)

        monkeypatch.setattr(fa_ops, "flash_attention_cuda", flash)
        monkeypatch.setattr(ssd_ops, "ssd_scan_cuda", ssd)
        plain_fn = rt.kernel_function("gru_scan", scan, None, gru_scan_reference)
        monkeypatch.setattr(gru_ops, "_GRUScanFn", plain_fn)
        monkeypatch.setattr(gru_ops, "_GRUScanWideFn", plain_fn)

    def counts(self) -> dict[str, int]:
        return {k: self.calls.count(k) for k in sorted(set(self.calls))}


# --- the tests -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    """float32 SMOKE: loss, ``ce``, ``moe_aux`` and every gradient leaf."""
    check_against_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_loss_matches_jax(arch):
    check_bf16_loss(arch)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_remat_policies_give_the_same_loss_and_gradients(remat):
    """zamba2 SMOKE (Mamba2 layers and the shared block) under each policy:
    the same loss and gradients as without a checkpoint, to the last bit
    (the recompute repeats the same operations)."""
    _, cfg, _, params = models("zamba2-1.2b", "float32", remat=remat)
    batch = torch_batch(make_batch(cfg, 2, 32, seed=3))
    loss, _, grads = port_loss_and_grads(params, batch, cfg)
    want, _, want_grads = port_loss_and_grads(params, batch, dataclasses.replace(cfg, remat="none"))
    assert loss.item() == want.item()
    for path, g in grads.items():
        assert torch.equal(g, want_grads[path]), path


def test_an_unknown_remat_policy_raises():
    _, cfg, _, params = models("mamba2-130m", "float32", remat="some")
    with pytest.raises(ValueError, match="unknown remat"):
        M.train_loss(params, torch_batch(make_batch(cfg, 1, 16)), cfg)


@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("dots", 2), ("none", 1)])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "merinda-gru", "qwen2.5-3b"])
def test_kernel_calls_a_step(monkeypatch, arch, remat, per_layer):
    """With the kernels' dispatch held by counted plain functions: a layer's
    scan or attention is called once forward and, under a checkpoint, once
    more in the backward's recompute; the hybrid's shared block (not
    checkpointed) once an application; the backward itself calls no kernel;
    the loss and gradients are the plain path's."""
    _, cfg, _, params = models(arch, "float32", remat=remat)
    batch = torch_batch(make_batch(cfg, 2, 32, seed=4))
    calls = KernelCalls(monkeypatch)
    loss, _, grads = port_loss_and_grads(params, batch, cfg)
    counts = calls.counts()
    monkeypatch.undo()
    want, _, want_grads = port_loss_and_grads(params, batch, cfg)
    kernel = {"hybrid": "ssd_scan", "gru": "gru_scan", "dense": "flash_attention"}[cfg.family]
    expect = {kernel: per_layer * cfg.num_layers}
    if cfg.family == "hybrid":
        expect["flash_attention"] = M.shared_applications(cfg)
    assert counts == expect
    close(loss, want.numpy(), dict(atol=1e-6, rtol=1e-6))
    for path, g in grads.items():
        close(g, want_grads[path].numpy(), dict(atol=1e-6, rtol=1e-6), path)


def test_layers_are_unbound_once_a_step():
    """The stacked leaves reach the layers through one ``unbind`` each: one
    backward node a leaf, never an index a layer."""
    _, cfg, _, params = models("zamba2-1.2b", "float32")
    layers = M._unstack(params["layers"])
    assert len(layers) == cfg.num_layers
    wx = params["layers"]["mamba"]["wx"]
    for i, lp in enumerate(layers):
        assert lp["mamba"]["wx"].data_ptr() == wx[i].data_ptr()
        assert torch.equal(lp["ln"]["scale"], params["layers"]["ln"]["scale"][i])
    wx.requires_grad_(True)
    parts = M._unstack({"wx": wx})
    names = {type(p["wx"].grad_fn).__name__ for p in parts}
    assert names == {"UnbindBackward0"} and len({id(p["wx"].grad_fn) for p in parts}) == 1
