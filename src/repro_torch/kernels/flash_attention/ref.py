"""Dense-softmax oracle for the flash-attention kernel (``repro/kernels/flash_attention/ref.py``).

GQA, causal and sliding-window masks, in the head-major layout
[B, H, S, Dh]. A masked score is -inf, as in the JAX oracle, so a row with
no unmasked key (a ``q_offset`` tail that reaches past the keys by at least
``window``) comes out NaN here; the kernels give 0 or the mean of v there
(``csrc/flash_attention.cu``).
"""

from __future__ import annotations

import torch


def attention_reference(
    q: torch.Tensor,  # [B, QH, Sq, Dh]
    k: torch.Tensor,  # [B, KH, Sk, Dh]
    v: torch.Tensor,  # [B, KH, Sk, Dh]
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q_offset: absolute position of q[0] (for decode or chunked prefill)."""
    B, QH, Sq, Dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    group = QH // KH
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale.to(q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, torch.tensor(-torch.inf, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32)).to(q.dtype)
