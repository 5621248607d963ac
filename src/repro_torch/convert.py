"""Carry MERINDA weights between the JAX package and the port.

``params_from_numpy`` takes the JAX package's ``MRParams`` (or anything with
the same attributes) whose leaves arrive as numpy arrays, and returns the
port's ``MRParams`` on ``device``. It is duck-typed, so it imports nothing of
the JAX package: the encoder is ``GRUParams`` when it has ``.w``,
``LTCParams`` when it has ``.w_rec`` and ``NodeEncoderParams`` when it has
``.w_f1``. ``params_to_numpy`` goes the other way: the port's ``MRParams``
with numpy leaves, field for field the JAX package's layout.

``opt_from_numpy`` and ``opt_to_numpy`` carry the AdamW state (step, m, v)
the same way. Every function is shape-agnostic, so a slot-stacked tree
(leading slot or system axis on every leaf, what ``jax.vmap`` builds) crosses
as it is.

``control_from_numpy`` and ``control_to_numpy`` carry the device control
plane's ``ControlState`` (its ``q_params`` and ``w_params`` are MRParams
trees with leading shard and queue or ring axes), and
``pinn_params_from_numpy`` and ``pinn_params_to_numpy`` the PINN-SR baseline's
``PinnSRParams``, the same way.

``lm_params_from_numpy`` and ``lm_params_to_numpy`` carry a language model's nested dict
of parameters, or of its cache, the same way: a bfloat16 leaf crosses as
float32, which holds every bfloat16 value exactly, and is cast back to
bfloat16 on the far side, so both frameworks compute from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.control import ControlState
from repro_torch.core.ltc import LTCParams
from repro_torch.core.merinda import MRParams
from repro_torch.core.neural_flow import GRUParams
from repro_torch.core.node_mr import NodeEncoderParams
from repro_torch.core.pinn_sr import PinnSRParams
from repro_torch.optim import AdamWState
from repro_torch.tree import tree_map

_HEAD = ("head_w1", "head_b1", "head_w2", "head_b2")
_ENCODERS = (("w", GRUParams), ("w_rec", LTCParams), ("w_f1", NodeEncoderParams))


def _encoder_type(enc) -> type:
    for attr, cls in _ENCODERS:
        if hasattr(enc, attr):
            return cls
    raise TypeError(f"unknown encoder parameters {type(enc).__name__}")


def params_from_numpy(p, device: torch.device | str = "cpu") -> MRParams:
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
    cls = _encoder_type(p.encoder)
    enc = cls(*(as_t(getattr(p.encoder, name)) for name in cls._fields))
    return MRParams(enc, *(as_t(getattr(p, name)) for name in _HEAD))


def params_to_numpy(p: MRParams) -> MRParams:
    return tree_map(lambda t: t.detach().cpu().numpy(), p)


def opt_from_numpy(o, device: torch.device | str = "cpu") -> AdamWState:
    """The JAX package's ``AdamWState`` (numpy leaves) as the port's."""
    step = torch.from_numpy(np.array(o.step, dtype=np.int32)).to(device)
    return AdamWState(step, params_from_numpy(o.m, device), params_from_numpy(o.v, device))


def lm_params_from_numpy(tree, device: torch.device | str = "cpu"):
    """A nested dict of numpy (or numpy-convertible) leaves as tensors on
    ``device``, each in its own dtype (bfloat16 through float32)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    dtype = str(np.asarray(tree).dtype)
    if dtype == "bfloat16":
        return torch.from_numpy(np.asarray(tree, dtype=np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(tree)).to(device)


def lm_params_to_numpy(tree):
    """A nested dict of tensors as numpy arrays; bfloat16 leaves as float32."""
    if isinstance(tree, dict):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def opt_to_numpy(o: AdamWState) -> AdamWState:
    return AdamWState(o.step.cpu().numpy(), params_to_numpy(o.m), params_to_numpy(o.v))


def control_from_numpy(c, device: torch.device | str = "cpu") -> ControlState:
    """The JAX package's ``ControlState`` (numpy leaves) as the port's."""

    def as_t(name):
        x = np.asarray(getattr(c, name))
        dtype = np.int32 if x.dtype.kind in "iu" else np.float32
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    fields = {name: as_t(name) for name in ControlState._fields if not name.endswith("_params")}
    return ControlState(**fields, q_params=params_from_numpy(c.q_params, device),
                        w_params=params_from_numpy(c.w_params, device))  # fmt: skip


def control_to_numpy(c: ControlState) -> ControlState:
    return tree_map(lambda t: t.detach().cpu().numpy(), c)


def pinn_params_from_numpy(p, device: torch.device | str = "cpu") -> PinnSRParams:
    """The JAX package's ``PinnSRParams`` (numpy leaves) as the port's."""
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
    return PinnSRParams(mlp=[(as_t(w), as_t(b)) for w, b in p.mlp], xi=as_t(p.xi),
                        xi_mask=as_t(p.xi_mask))  # fmt: skip


def pinn_params_to_numpy(p: PinnSRParams) -> PinnSRParams:
    return tree_map(lambda t: t.detach().cpu().numpy(), p)
