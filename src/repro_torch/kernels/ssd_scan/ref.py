"""Plain PyTorch versions of the Mamba2 SSD scan (``repro/kernels/ssd_scan/ref.py``).

Two formulations, as in the JAX package:

- ``ssd_recurrent``: the literal per-step recurrence (ground truth);
- ``ssd_chunked``: the chunked, state-passing formulation that the kernel
  implements, and the plain version every CPU call takes.

Semantics (SSD, Dao & Gu 2024):
    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t (outer) x_t
    y_t = C_t @ S_t + D_h * x_t
with heads H of width P and groups G of state width N for B and C.

Dtypes follow the JAX functions: an einsum of two bf16 operands gives bf16
(``C·Bᵀ`` in ``ssd_chunked``), a product with a float32 operand gives
float32, the state is float32 and ``y`` is returned in x's dtype. torch's
``einsum`` takes one dtype, so ``_einsum`` promotes its operands first, as
JAX's does.
"""

from __future__ import annotations

import torch


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    dtype = ops[0].dtype
    for t in ops[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(eq, *(t.to(dtype) for t in ops))


def _expand_groups(bm: torch.Tensor, H: int, dim: int = 2) -> torch.Tensor:
    """[B,T,G,N] -> [B,T,H,N] by repeating each group over its heads."""
    return torch.repeat_interleave(bm, H // bm.shape[dim], dim=dim)


def ssd_recurrent(x, dt, A, bm, cm, D, initial_state=None):
    """x [B,T,H,P], dt [B,T,H], A [H], bm, cm [B,T,G,N], D [H] ->
    (y [B,T,H,P], final_state [B,H,N,P])."""
    B, T, H, P = x.shape
    N = bm.shape[-1]
    bm_h, cm_h = _expand_groups(bm, H), _expand_groups(cm, H)
    S = initial_state
    if S is None:
        S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)[..., None, None]
        inject = (dt[:, t, :, None, None] * bm_h[:, t, :, :, None]) * x[:, t, :, None, :]
        S = decay * S + inject
        ys.append(_einsum("bhn,bhnp->bhp", cm_h[:, t], S))
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * x
    return y.to(x.dtype), S


def ssd_chunked(x, dt, A, bm, cm, D, chunk: int = 128, initial_state=None):
    """Chunked SSD: the quadratic intra-chunk term plus a sequential state pass."""
    B, T, H, P = x.shape
    N = bm.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    nc = T // chunk
    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    bc = _expand_groups(bm, H).reshape(B, nc, chunk, H, N)
    cc = _expand_groups(cm, H).reshape(B, nc, chunk, H, N)

    a = dtc * A[None, None, None, :]  # negative
    cum = torch.cumsum(a, dim=2)  # inclusive within the chunk
    total = cum[:, :, -1:, :]

    # intra-chunk: scores[i,j] = (c_i . b_j) * exp(cum_i - cum_j) * dt_j, j <= i
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,L,L,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    causal = causal[None, None, :, :, None]
    decay_mat = torch.where(causal, torch.exp(seg), torch.zeros((), dtype=seg.dtype, device=x.device))
    scores = _einsum("bclhn,bcmhn->bclmh", cc, bc) * decay_mat * dtc[:, :, None, :, :]
    y_intra = _einsum("bclmh,bcmhp->bclhp", scores, xc)

    # each chunk's state contribution: sum_j exp(total - cum_j) dt_j b_j (x) x_j
    w = torch.exp(total - cum) * dtc
    S_chunk = _einsum("bclh,bclhn,bclhp->bchnp", w, bc, xc)
    chunk_decay = torch.exp(total[:, :, 0, :])

    S = initial_state
    if S is None:
        S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    S_enter = []
    for c in range(nc):
        S_enter.append(S)
        S = chunk_decay[:, c, :, None, None] * S + S_chunk[:, c]
    S_enter = torch.stack(S_enter, dim=1)  # [B,nc,H,N,P]

    # inter-chunk: y_i += exp(cum_i) * (c_i @ S_enter)
    y_inter = _einsum("bclhn,bchnp->bclhp", cc * torch.exp(cum)[..., None], S_enter)

    y = (y_intra + y_inter).reshape(B, T, H, P) + D[None, None, :, None] * x
    return y.to(x.dtype), S


def ssd_decode_step(x, dt, A, b, c, D, state):
    """One token: x [B,H,P], dt [B,H], b, c [B,G,N], state [B,H,N,P] ->
    (y [B,H,P], new state)."""
    H = x.shape[1]
    b_h, c_h = _expand_groups(b, H, dim=1), _expand_groups(c, H, dim=1)
    decay = torch.exp(dt * A)[..., None, None]
    state = decay * state + (dt[..., None, None] * b_h[..., :, None]) * x[..., None, :]
    y = _einsum("bhn,bhnp->bhp", c_h, state) + D[None, :, None] * x
    return y.to(x.dtype), state
