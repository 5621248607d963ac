"""repro_torch's mixture-of-experts FFN (``models/moe.py``) against the JAX package's.

The JAX package draws the router and the experts' weights (``materialize``
of its ``moe_specs``); they cross to the port through
``repro_torch.convert.lm_params_from_numpy`` (bf16 leaves as float32, which
holds them exactly), and the inputs are numpy draws from a seed. Both
branches run at a token count that is not a group multiple, so the zero rows
padded to the group enter the load-balancing loss: their router
probabilities are all equal, and the two frameworks must break those ties
alike (the lower expert first). The real tokens' probabilities come from
random inputs and hold no ties.

Tolerances: float32 within 1e-4; bf16 within 0.12 (``tests/test_models.py:99``).
The initial-weight draw (``models/params.py``) is held here too: a stacked
leaf is drawn a layer at a time.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.params import materialize as jmaterialize
from repro_torch.configs import MoEConfig, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, materialize, spec_leaves, stack_layer

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.12, rtol=0.12)
DTYPES = [("float32", F32_TOL), ("bfloat16", BF16_TOL)]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x22b"]
# moonshot SMOKE's router (8 experts, top 3, groups of 64), and the same at a capacity
# factor that drops tokens
TIGHT = MoEConfig(num_experts=8, top_k=3, capacity_factor=0.5, group_size=64)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _jax_ffn(m, dropless: bool):
    return jax.jit(lambda p, x: jmoe.moe_ffn(p, x, m, dropless=dropless))


def _weights(m, d: int, f: int, dtype: str, seed: int):
    """(JAX params, port params) of one MoE FFN drawn by the JAX package."""
    jparams = jax.tree.map(np.asarray, jmaterialize(jax.random.key(seed), jmoe.moe_specs(m, d, f, dtype)))
    return jparams, lm_params_from_numpy(jparams)


def _x(B, S, d, seed, dtype):
    x = (np.random.default_rng(seed).standard_normal((B, S, d))).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_specs_and_capacity_match_jax(arch, smoke):
    """``moe_specs`` (shape, axes, dtype, init, scale of the router and the
    three expert weights) and ``expert_capacity`` at every group size a
    prefill or a decode step gives it, as the JAX package's."""
    cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    ours = moe.moe_specs(cfg.moe, cfg.d_model, cfg.d_ff, cfg.dtype)
    theirs = jmoe.moe_specs(jcfg.moe, jcfg.d_model, jcfg.d_ff, jcfg.dtype)
    assert sorted(ours) == sorted(theirs) == ["router", "w_down", "w_gate", "w_up"]
    for name, s in ours.items():
        t = theirs[name]
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (t.shape, t.axes, t.dtype, t.init, t.scale)
    assert ours["router"].dtype == "float32"
    for g in (1, 2, 4, 7, 64, 100, 512, 4096):
        assert moe.expert_capacity(cfg.moe, g) == jmoe.expert_capacity(jcfg.moe, g), g
    assert moe.expert_capacity(TIGHT, 64) == 12 and moe.expert_capacity(TIGHT, 2) == 4


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m", [get_config("moonshot-v1-16b-a3b", smoke=True).moe, TIGHT],
                         ids=["moonshot-smoke", "tight"])  # fmt: skip
@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
def test_moe_ffn_matches_jax(dropless, m, dtype, tol):
    """Both branches, output and aux loss, at 3 x 45 = 135 tokens: two full
    groups of 64 and one of 7 real rows and 57 padded ones."""
    d, f = 64, 96
    jparams, params = _weights(m, d, f, dtype, seed=1)
    jx, x = _x(3, 45, d, seed=2, dtype=dtype)
    out, aux = moe.moe_ffn(params, x, m, dropless=dropless)
    jout, jaux = _jax_ffn(m, dropless)(jparams, jx)
    assert out.shape == (3, 45, d) and out.dtype == x.dtype and aux.dtype == torch.float32
    _close(out, jout, tol)
    _close(aux, jaux, F32_TOL)


def test_capacity_branch_drops_and_dropless_does_not():
    """At capacity factor 0.5 an expert takes 12 of a group's 192 choices: the
    capacity branch drops some tokens' choices (their output moves off the
    dropless one), and a token's dropless output is its own alone."""
    d, f = 64, 96
    _, params = _weights(TIGHT, d, f, "float32", seed=3)
    _, x = _x(2, 64, d, seed=4, dtype="float32")
    kept, aux_c = moe.moe_ffn(params, x, TIGHT)
    full, aux_d = moe.moe_ffn(params, x, TIGHT, dropless=True)
    moved = (kept - full).abs().amax(-1) > 1e-5
    assert 0 < int(moved.sum()) < moved.numel()
    assert torch.equal(aux_c, aux_d)
    alone = torch.cat([moe.moe_ffn(params, x[:, t : t + 1], TIGHT, dropless=True)[0]
                       for t in range(0, 64, 9)], dim=1)  # fmt: skip
    _close(alone, full[:, ::9].numpy(), dict(atol=1e-5, rtol=1e-5))


def test_top_k_orders_ties_as_jax():
    """Equal probabilities (a padded row's, or any tie) go lower expert first,
    as ``jax.lax.top_k`` orders them; larger values first otherwise."""
    rows = np.array([[0.125] * 8, [0.1, 0.3, 0.1, 0.3, 0.05, 0.05, 0.05, 0.05],
                     [0.2, 0.05, 0.2, 0.05, 0.2, 0.05, 0.2, 0.05]], np.float32)  # fmt: skip
    p, e = moe._top_k(torch.from_numpy(rows), 3)
    jp, je = jax.lax.top_k(jnp.asarray(rows), 3)
    assert e.tolist() == np.asarray(je).tolist() == [[0, 1, 2], [1, 3, 0], [0, 2, 4]]
    _close(p, jp, dict(atol=0, rtol=0))


class _Float32Allocations(TorchDispatchMode):
    """The element counts of every float32 tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.sizes.append(t.numel())
        return out


def test_init_draws_stacked_leaves_a_layer_at_a_time():
    """``materialize`` draws a stacked bf16 leaf a layer at a time into the
    bf16 tensor: the largest float32 temporary is one layer's slice, not the
    leaf (moonshot's ``w_gate`` whole would be 35.4 GB of float32). Each
    layer is the scaled float32 draw of its slice, in layer order from the
    generator, rounded once to bf16."""
    spec = stack_layer(ParamSpec((8, 64, 96), ("expert", "embed", "mlp"), scale=0.125), 3)
    with _Float32Allocations() as seen:
        w = materialize(torch.Generator().manual_seed(5), {"w": spec})["w"]
    assert w.shape == (3, 8, 64, 96) and w.dtype == torch.bfloat16
    assert max(seen.sizes) == 8 * 64 * 96
    gen = torch.Generator().manual_seed(5)
    want = torch.stack([(torch.randn((8, 64, 96), generator=gen) * 0.125).to(torch.bfloat16)
                        for _ in range(3)])  # fmt: skip
    assert torch.equal(w, want)
    # a whole model: no float32 temporary beyond one layer's slice of its largest
    # stacked leaf, or an unstacked leaf (the embedding, the head) whole
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    with _Float32Allocations() as seen:
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
    leaves = spec_leaves(M.param_specs(cfg))
    slice_of = lambda s: math.prod(s.shape[1:]) if s.axes[0] == "layers" else math.prod(s.shape)
    assert max(seen.sizes) == max(slice_of(s) for s in leaves)
    assert max(seen.sizes) < max(math.prod(s.shape) for s in leaves)
    flat = _flat(params)
    assert flat["/layers/moe/w_gate"].dtype == torch.bfloat16
    assert flat["/layers/moe/router"].dtype == torch.float32
