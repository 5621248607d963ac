"""Parameter specs: abstract shapes and logical axes (``repro/models/params.py``).

Every model exposes ``param_specs(cfg) -> tree of ParamSpec`` (nested dicts).
From the spec tree, without allocating a full-size model, come
``spec_bytes`` and ``count_params``; ``materialize`` makes the tensors
(normal, zeros, ones or const init from a ``torch.Generator``, in the spec's
dtype). The logical axes are kept for parity with the JAX package; on one
card nothing shards by them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "normal"  # normal | zeros | ones | const
    scale: float = 1.0  # std for normal, value for const

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_specs(fn, tree):
    """``fn`` over the ParamSpec leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def spec_leaves(tree) -> list[ParamSpec]:
    """The leaves in the JAX package's order (dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in spec_leaves(tree[k])]
    return [tree]


def stack_layer(spec: ParamSpec, n_layers: int) -> ParamSpec:
    """Add the leading stacked-layers dim."""
    return dataclasses.replace(spec, shape=(n_layers, *spec.shape), axes=("layers", *spec.axes))


def _init_one(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    dt = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "const":
        return torch.full(spec.shape, spec.scale, dtype=dt, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return (x * spec.scale).to(dt)


def materialize(generator: torch.Generator, tree, device=None):
    """Tensors for every spec of ``tree`` on ``device`` (the generator's by
    default), drawn in ``spec_leaves`` order from ``generator``."""
    device = generator.device if device is None else torch.device(device)
    if isinstance(tree, dict):
        return {k: materialize(generator, tree[k], device) for k in sorted(tree)}
    return _init_one(tree, generator, device)


def spec_bytes(tree) -> int:
    return sum(math.prod(s.shape) * DTYPES[s.dtype].itemsize for s in spec_leaves(tree))


def spec_count(tree) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(tree))


def count_params(cfg) -> int:
    """Analytic parameter count from the spec tree."""
    from repro_torch.models.model import param_specs  # lazy: avoid a cycle

    return spec_count(param_specs(cfg))
