"""Flash attention: the CUDA kernel's wrapper, its dispatch and gradient.

Counterpart of ``repro/kernels/flash_attention/ops.py``, with its signature
and its model layout [B, S, H, Dh]. ``flash_attention`` dispatches through
``kernels/runtime.resolve_dispatch``: a CUDA tensor launches the hand-written
kernel (``csrc/flash_attention.cu``, which replaces
``repro/kernels/flash_attention/kernel.py:104 flash_attention_pallas``) on the
model layout as it is, a CPU tensor or ``force_reference`` takes the dense
oracle (``ref.attention_reference``, head-major). The gradient recomputes
the oracle (``ops.py:42-54``).

bf16 operands run on the tensor cores (Hopper's ``wgmma``, 128 query rows by
64-key tiles, P split into two bf16 halves against V), float32 operands on
the FMA units (64 by 64 tiles), as ``csrc/flash_attention.cu`` describes. ``block_q`` and
``block_k`` are the Pallas kernel's logical blocks: they set which key
blocks a query block skips (``kernel.py:60-66``). The kernels' own tiles are
independent of them, so every legal block gives the same result; a block
that does not divide its sequence raises, as the Pallas kernel asserts.

The model path calls it in prefill (``models/attention.py``: zamba2's shared
block, every dense layer), where the JAX package runs its own blockwise loop
(``repro/models/attention.py``), at a block that divides the prompt.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ref import attention_reference

MAX_DH = 128
DTYPES = (torch.float32, torch.bfloat16)


def _scale(Dh: int) -> float:
    """1/sqrt(Dh) rounded as the JAX kernel and oracle round it (float32)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=torch.float32)))


def flash_attention_cuda(q, k, v, *, causal: bool, window: int | None, q_offset: int,
                         block_q: int, block_k: int) -> torch.Tensor:  # fmt: skip
    """Launch the CUDA kernel on the current stream: o [B, Sq, QH, Dh] in q's
    dtype from q [B, Sq, QH, Dh], k and v [B, Sk, KH, Dh].

    Counts its launches in ``flash_attention_cuda.launches``.
    """
    B, Sq, QH, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    rt.check_operands(
        "flash_attention",
        q.device,
        q=(q, (B, Sq, QH, Dh), q.dtype),
        k=(k, (B, Sk, KH, Dh), q.dtype),
        v=(v, (B, Sk, KH, Dh), q.dtype),
    )
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq < 1 or bk < 1 or Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: blocks ({bq}, {bk}) must divide (Sq={Sq}, Sk={Sk})")
    if QH % KH or not 1 <= Dh <= MAX_DH or window is not None and window < 0:
        raise ValueError(f"flash_attention: QH={QH} must be a multiple of KH={KH}, Dh={Dh} <= "
                         f"{MAX_DH}, window={window} >= 0")  # fmt: skip
    o = torch.empty_like(q)
    err = rt.load_library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Sk, QH, KH, Dh, bq, bk, int(causal), -1 if window is None else window,
        q_offset, _scale(Dh), int(q.dtype == torch.bfloat16), rt.current_stream(q.device),
    )  # fmt: skip
    rt.check_launch("flash_attention", err)
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def _reference(q, k, v, causal, window, q_offset):
    """The oracle in the model layout."""
    t = lambda x: x.transpose(1, 2)
    return t(attention_reference(t(q), t(k), t(v), causal=causal, window=window, q_offset=q_offset))


class _FlashFn(torch.autograd.Function):
    """The CUDA forward; the backward recomputes the oracle."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_k):
        ctx.mask = (causal, window, q_offset)
        ctx.save_for_backward(q, k, v)
        return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                    block_q=block_q, block_k=block_k)  # fmt: skip

    @staticmethod
    def backward(ctx, grad_o):
        grads = rt.reference_vjp(
            lambda q, k, v: _reference(q, k, v, *ctx.mask),
            ctx.saved_tensors,
            ctx.needs_input_grad[:3],
            grad_o,
        )
        return (*grads, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,  # [B, S, QH, Dh]: the model layout
    k: torch.Tensor,  # [B, S, KH, Dh]
    v: torch.Tensor,  # [B, S, KH, Dh]
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    block_q: int = 128,
    block_k: int = 128,
    force_reference: bool = False,
) -> torch.Tensor:
    """Attention in the model layout: o [B, Sq, QH, Dh] in q's dtype."""
    if rt.resolve_dispatch(q, force_reference) is rt.Dispatch.REFERENCE:
        return _reference(q, k, v, causal, window, q_offset)
    c = lambda t: t.contiguous()
    return _FlashFn.apply(c(q), c(k), c(v), causal, window, q_offset, block_q, block_k)
