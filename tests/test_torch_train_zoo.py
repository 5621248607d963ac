"""repro_torch's LM training forward against the JAX package's for the
``moe`` (moonshot-v1-16b-a3b, mixtral-8x22b's sliding window), ``vlm``
(phi-3-vision-4.2b: patches prepended, their positions unlabelled) and
``audio`` (seamless-m4t-medium: the encoder over 4,096 frames, the decoder's
cross-attention) families at SMOKE; the training config fields, the named
shapes, ``input_specs`` and ``train_state_specs`` against JAX's.

The MoE layers train through the capacity dispatch (``moe_ffn(...,
dropless=False)``) and their load-balancing loss enters the loss at 0.01,
so ``moe_aux`` is non-zero there. The helpers and tolerances are
``test_torch_train_lm.py``'s. The audio batch is B = 1: the CPU oracle of the
encoder's attention is [B, H, 4,096, 4,096] float32.
"""

from __future__ import annotations

import dataclasses

import jax
import pytest

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.parallel.steps import train_state_specs as jtrain_state_specs
from repro_torch.configs import SHAPES, ShapeConfig, get_config, get_shape, ported_archs
from repro_torch.models import model as M
from repro_torch.parallel.steps import train_state_specs
from test_torch_train_lm import check_against_jax, check_bf16_loss, flat

ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x22b", "phi-3-vision-4.2b", "seamless-m4t-medium"]
BATCH = {"seamless-m4t-medium": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    check_against_jax(arch, B=BATCH.get(arch, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_loss_matches_jax(arch):
    check_bf16_loss(arch, B=BATCH.get(arch, 2))


@pytest.mark.parametrize("arch", ported_archs())
def test_training_config_fields_match_jax(arch):
    """``remat`` and ``logit_chunk`` as in the JAX package, CONFIG and SMOKE."""
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
        assert (cfg.remat, cfg.logit_chunk) == (jcfg.remat, jcfg.logit_chunk) == ("full", 0)


def test_named_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()
    }
    assert get_shape("train_4k") == ShapeConfig("train_4k", 4096, 256, "train")


def _spec_fields(tree) -> dict:
    return {k: (tuple(s.shape), tuple(s.axes), s.dtype, s.init) for k, s in flat(tree).items()}


@pytest.mark.parametrize("arch", ported_archs())
def test_input_specs_match_jax(arch):
    """Every input of a train, prefill and decode step: shape, axes, dtype."""
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    for mode in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", 64, 2, mode)
        assert _spec_fields(M.input_specs(cfg, shape)) == _spec_fields(
            JM.input_specs(jcfg, JShapeConfig("t", 64, 2, mode))
        ), mode


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "moonshot-v1-16b-a3b"])
def test_train_state_specs_match_jax(arch):
    """params in the config's dtype, m and v float32 of the same shapes, an
    int32 step: JAX's TrainState without its compression buffers."""
    state, jstate = train_state_specs(get_config(arch)), jtrain_state_specs(jget_config(arch))
    for field in ("params", "m", "v"):
        assert _spec_fields(getattr(state, field)) == _spec_fields(getattr(jstate, field)), field
    assert (state.step.shape, state.step.dtype) == (jstate.step.shape, jstate.step.dtype)
    assert jax.tree.leaves(jstate.errors) == []
