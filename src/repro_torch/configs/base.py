"""Model configuration schema and registry (``repro/configs/base.py``).

The port's own copy of the JAX package's schema: ``SSMConfig``,
``AttentionConfig``, ``MoEConfig`` and ``ModelConfig`` with the same fields
the model zoo reads, their defaults and derived sizes (``vocab_padded``,
``ssm_heads``, ``d_inner``), and ``ShapeConfig`` with the JAX package's
named shapes (``SHAPES``, ``get_shape``). Every architecture of the JAX
package's zoo ships as ``repro_torch/configs/<id>.py`` exposing ``CONFIG``
(the published dimensions) and ``SMOKE`` (a reduced model of the same family
for CPU tests); ``get_config`` resolves either, and names the ported
architectures when asked for another.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

# architecture id -> family, for every architecture the port runs: the JAX package's
# ``ARCH_IDS``, all eleven
PORTED = {
    "mamba2-130m": "ssm",
    "merinda-gru": "gru",
    "zamba2-1.2b": "hybrid",
    "qwen2.5-3b": "dense",
    "yi-6b": "dense",
    "minitron-8b": "dense",
    "internlm2-20b": "dense",
    "mixtral-8x22b": "moe",
    "moonshot-v1-16b-a3b": "moe",
    "phi-3-vision-4.2b": "vlm",
    "seamless-m4t-medium": "audio",
}


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window size (SWA); None = full
    rope_theta: float = 1e6


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 512  # tokens per dispatch group (bounds dispatch memory)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int  # N
    head_dim: int = 64  # P
    num_heads: int = 0  # H (0 -> derived: expand*d_model/head_dim)
    num_groups: int = 1  # G (B/C groups)
    conv_width: int = 4
    expand: int = 2
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | gru
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0  # audio (enc-dec): encoder depth
    attn_period: int = 0  # hybrid: shared attn block after every k ssm layers
    num_patches: int = 0  # vlm: image patch embeddings prepended
    frontend_dim: int = 0  # audio: fbank feature dim (the stub frontend projects 80 to d_model)
    gru_hidden: int = 0  # gru family: mixer hidden size (0 -> d_model)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"  # the training forward's per-layer checkpoint: full | dots | none
    # the JAX package's blockwise-attention kv chunk: it sets only JAX's summation
    # order; the port's attention (flash_attention and its oracle) does not read it
    attn_chunk: int = 1024
    logit_chunk: int = 0  # cross-entropy in sequence segments of this length (0: one)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the JAX package's padding)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        if self.ssm.num_heads:
            return self.ssm.num_heads
        return self.ssm.expand * self.d_model // self.ssm.head_dim

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm_heads * self.ssm.head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def ported_archs() -> list[str]:
    return sorted(PORTED)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """``CONFIG`` (or ``SMOKE``) of a ported architecture; raises for any other."""
    if name not in PORTED:
        raise ValueError(f"unknown architecture {name!r}; the port runs {', '.join(ported_archs())}")
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE if smoke else mod.CONFIG
