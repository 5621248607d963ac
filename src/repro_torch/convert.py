"""Carry MERINDA weights between the JAX package and the port.

``params_from_numpy`` takes the JAX package's ``MRParams`` (or anything with
the same attributes) whose leaves arrive as numpy arrays, and returns the
port's ``MRParams`` on ``device``. It is duck-typed on ``.encoder.w``,
``.head_w1`` and so on, so it imports nothing of the JAX package.
``params_to_numpy`` goes the other way: the port's ``MRParams`` with numpy
leaves, field for field the JAX package's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.merinda import MRParams
from repro_torch.core.neural_flow import GRUParams
from repro_torch.tree import tree_map

_HEAD = ("head_w1", "head_b1", "head_w2", "head_b2")


def params_from_numpy(p, device: torch.device | str = "cpu") -> MRParams:
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
    enc = p.encoder
    return MRParams(
        GRUParams(w=as_t(enc.w), b=as_t(enc.b), time_scale=as_t(enc.time_scale)),
        *(as_t(getattr(p, name)) for name in _HEAD),
    )


def params_to_numpy(p: MRParams) -> MRParams:
    return tree_map(lambda t: t.detach().cpu().numpy(), p)
