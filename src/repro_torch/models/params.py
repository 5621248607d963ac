"""Parameter specs: abstract shapes and logical axes (``repro/models/params.py``).

Every model exposes ``param_specs(cfg) -> tree of ParamSpec`` (nested dicts).
From the spec tree, without allocating a full-size model, come
``spec_bytes`` and ``count_params`` (MoE: the active subset too);
``materialize`` makes the tensors (normal, zeros, ones or const init from a
``torch.Generator``, in the spec's dtype). A normal leaf is drawn in float32
and scaled, a stacked one (leading axis ``"layers"``) a layer at a time into
the tensor of its own dtype, so the largest float32 temporary is one layer's
slice (moonshot-v1-16b-a3b's ``w_gate`` whole would be 35.4 GB of it). The
logical axes are kept for parity with the JAX package; on one card nothing
shards by them, and ``count_params`` reads the ``"expert"`` axis.
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
    out = torch.empty(spec.shape, dtype=dt, device=device)
    for part in out if spec.axes[:1] == ("layers",) else (out,):
        x = torch.randn(part.shape, generator=generator, dtype=torch.float32, device=device)
        part.copy_(x.mul_(spec.scale))
    return out


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


def count_params(cfg, active_only: bool = False) -> int:
    """Analytic parameter count from the spec tree. ``active_only``: a leaf
    with an ``"expert"`` axis (the router and the experts' weights) counts
    its top_k / num_experts share."""
    from repro_torch.models.model import param_specs  # lazy: avoid a cycle

    tree = param_specs(cfg)
    if not active_only or cfg.moe is None:
        return spec_count(tree)
    total = 0
    for s in spec_leaves(tree):
        n = math.prod(s.shape)
        if "expert" in s.axes:
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total
