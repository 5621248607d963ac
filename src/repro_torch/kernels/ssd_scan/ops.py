"""Mamba2 chunked SSD scan: the CUDA kernels' wrapper, its dispatch and gradient.

Counterpart of ``repro/kernels/ssd_scan/ops.py``. ``ssd_scan`` pads T to a
chunk multiple with dt = 0 (decay exp(0) = 1, injection 0: the carried state
is exact) and dispatches through ``kernels/runtime.resolve_dispatch``: a CUDA
tensor launches the hand-written kernels (``csrc/ssd_scan.cu``, which
replaces ``repro/kernels/ssd_scan/kernel.py:91 ssd_scan_pallas``), a CPU
tensor or ``force_reference`` takes the plain ``ssd_chunked``. One op call
launches three CUDA kernels on the current stream: the chunk states, the
state pass and the outputs. The state pass starts from ``initial_state``
where one is given (a prefill that continues a sequence), as the JAX op's
reference path does. The gradient recomputes ``ssd_chunked``
(``ops.py:33-37``).

The kernels compute in float32 whatever x's dtype, as the Pallas kernel
does (``kernel.py:49-52``): on bf16 inputs the products run on the tensor
cores with every float32 factor split into two bf16 halves.
``ssd_chunked`` keeps the JAX reference's bf16 ``C·Bᵀ`` product, so on bf16
inputs the two differ by that rounding; the card's checks hold the kernel
against ``ssd_chunked`` run on float32 copies, which is what the TPU kernel
computed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.mr_step.tiling import SMEM_BUDGET_BYTES
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

CHUNKS = (16, 32, 64, 128)  # SMOKE, the JAX tests (32, 64) and CONFIG
MAX_P, MAX_N = 64, 128  # the kernels' tiles: 4 column and 8 row groups of 16
MAX_ROWS = 64  # float32 score rows built at once (4 row groups of 16)
DTYPES = (torch.float32, torch.bfloat16)


def smem_bytes(L: int, N: int, P: int, rows: int) -> int:
    """The float32 output kernel's carve (``csrc/ssd_scan.cu``): S_enter [N,P],
    the chunk's x [L,P], B and C transposed ([N,L+1] and [N,L]), dt and its
    prefix sum [L], and ``rows`` rows of the score tile [rows, L+1]."""
    return 4 * (N * P + L * P + N * (L + 1) + N * L + 2 * L + rows * (L + 1))


def tc_smem_bytes(L: int, N: int, P: int) -> int:
    """The bf16 output kernel's carve: one bf16 region that holds first C
    [L, N16+8] and S_enter's two halves [N16, P16+8], then B [L, N16+8] and x
    [L, P16+8] (N16, P16: N and P padded to 16, rows padded by 16 bytes), and
    dt and its prefix sum [L] in float32."""
    n16, p16 = -(-N // 16) * 16, -(-P // 16) * 16
    region = L * (n16 + 8) + max(2 * n16 * (p16 + 8), L * (p16 + 8))
    return 2 * region + 4 * 2 * L


def score_rows(L: int, N: int, P: int) -> int:
    """Rows of the float32 [L, L] score tile built at once: up to 64 (a power
    of two dividing L), halved until the carve fits a block's shared memory.
    At L=128, N=128, P=64 that is 64."""
    rows = min(L, MAX_ROWS)
    while rows > 16 and smem_bytes(L, N, P, rows) > SMEM_BUDGET_BYTES:
        rows //= 2
    return rows


def ssd_scan_cuda(x, dt, A, bm, cm, D, initial_state=None, *, chunk: int):
    """Launch the CUDA scan on the current stream: (y [B,T,H,P] in x's dtype,
    final state [B,H,N,P] float32), from ``initial_state`` [B,H,N,P] float32
    or zeros. T must be a multiple of ``chunk``.

    Counts its op calls (three kernels each) in ``ssd_scan_cuda.launches``.
    """
    B, T, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan: x must be float32 or bfloat16, got {x.dtype}")
    carried = {} if initial_state is None else {"initial_state": (initial_state, (B, H, N, P))}
    rt.check_operands(
        "ssd_scan",
        x.device,
        x=(x, (B, T, H, P), x.dtype),
        dt=(dt, (B, T, H)),
        A=(A, (H,)),
        bm=(bm, (B, T, G, N), x.dtype),
        cm=(cm, (B, T, G, N), x.dtype),
        D=(D, (H,)),
        **carried,
    )
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan: chunk={chunk} is not one of {CHUNKS}")
    if T < chunk or T % chunk or H % G:
        raise ValueError(f"ssd_scan: T={T} must be a multiple of chunk={chunk}, H={H} of G={G}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_scan: P={P} and N={N} must be <= {MAX_P} and {MAX_N}")
    rows = score_rows(chunk, N, P)
    smem = tc_smem_bytes(chunk, N, P) if x.dtype == torch.bfloat16 else smem_bytes(chunk, N, P, rows)
    if smem > SMEM_BUDGET_BYTES:
        raise ValueError(f"ssd_scan: {smem} bytes of shared memory exceed one block's budget")
    nc = T // chunk
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    # scratch: S_c of every chunk (float32: then the state entering it, in place),
    # each chunk's total decay exponent, and (bf16) the entering states split into
    # bf16 halves
    chunk_states = torch.empty((B, H, nc, N, P), dtype=torch.float32, device=x.device)
    totals = torch.empty((B, H, nc), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    split = torch.empty((B, H, nc, 2, N, P), dtype=x.dtype, device=x.device) if bf16 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    err = rt.load_library().ssd_scan_launch(
        *map(ptr, (x, dt, A, bm, cm, D, initial_state, y, state, chunk_states, totals, split)),
        B, T, H, P, G, N, chunk, rows, int(bf16),
        rt.current_stream(x.device),
    )  # fmt: skip
    rt.check_launch("ssd_scan", err)
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0


class _SSDScanFn(torch.autograd.Function):
    """The CUDA forward; the backward recomputes the plain ``ssd_chunked``."""

    @staticmethod
    def forward(ctx, x, dt, A, bm, cm, D, chunk, initial_state=None):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, bm, cm, D, initial_state)
        carried = () if initial_state is None else (initial_state,)
        return ssd_scan_cuda(x, dt, A, bm, cm, D, *carried, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        *ops, s0 = ctx.saved_tensors
        needs = list(ctx.needs_input_grad[:6])
        if s0 is not None:
            ops.append(s0)
            needs.append(ctx.needs_input_grad[7])
        plain = lambda x, dt, A, bm, cm, D, s0=None: ssd_chunked(
            x, dt, A, bm, cm, D, chunk=ctx.chunk, initial_state=s0
        )
        grads = rt.reference_vjp(plain, ops, needs, (grad_y, grad_state))
        return (*grads[:6], None, grads[6] if s0 is not None else None)


def ssd_scan(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] positive
    A: torch.Tensor,  # [H] negative
    bm: torch.Tensor,  # [B, T, G, N]
    cm: torch.Tensor,  # [B, T, G, N]
    D: torch.Tensor,  # [H]
    chunk: int = 128,
    force_reference: bool = False,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,T,H,P], final_state [B,H,N,P])."""
    T = x.shape[1]
    pad = (-T) % chunk
    if pad:  # padded steps carry dt = 0: decay 1, injection 0
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    if rt.resolve_dispatch(x, force_reference) is rt.Dispatch.REFERENCE:
        y, s = ssd_chunked(x, dt, A, bm, cm, D, chunk=chunk, initial_state=initial_state)
    else:
        c = lambda t: t.contiguous()
        s0 = None if initial_state is None else c(initial_state.float())
        y, s = _SSDScanFn.apply(c(x), c(dt), c(A), c(bm), c(cm), c(D), chunk, s0)
    return (y[:, :T] if pad else y), s
