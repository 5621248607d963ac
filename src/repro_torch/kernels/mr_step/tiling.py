"""Shared-memory model of the GRU kernels and the batch tile (``block_b``).

H100 counterpart of ``repro/kernels/mr_step/tiling.py`` (``vmem_bytes``,
``config_vmem_bytes``, ``auto_block_b``). On the TPU the tile was fitted to
VMEM; on Hopper a block stages the gate weights, the head weights and the
tile's state in its own shared memory (``csrc/gru_step.cuh``,
``csrc/mr_step.cu``), at most 227 KB a block. Blocks also run in parallel on
132 SMs, so the tile is kept small enough that the grid has at least
``min(B, 132)`` blocks: one large tile would put the whole batch's scan on one
SM.
"""

from __future__ import annotations

SMEM_BUDGET_BYTES = 232_448  # 227 KB: the most dynamic shared memory a block can use
N_SMS = 132  # streaming multiprocessors of an H100 SXM


def smem_bytes(D: int, H: int, Dh: int, K: int, block_b: int, *, fused: bool = True) -> int:
    """Dynamic shared memory of one block, exactly as the kernels carve it.

    ``fused=False`` is the bare ``gru_scan`` kernel (no head).
    """
    bb = block_b
    floats = (D + H) * 3 * H + 3 * H + H + 4 * bb * H  # gate weights, rates, tile state
    if fused:
        floats += H * Dh + Dh + Dh * K + K + bb * Dh  # head weights + hidden layer
    return 4 * floats


def config_smem_bytes(cfg, block_b: int, *, fused: bool = True) -> int:
    """``smem_bytes`` for one ``MRConfig``."""
    D = cfg.state_dim + cfg.input_dim
    K = cfg.n_coef + cfg.n_shifts
    return smem_bytes(D, cfg.hidden, cfg.dense_hidden, K, block_b, fused=fused)


def block_b_candidates(batch: int) -> list[int]:
    """Every tile that divides ``batch``, largest first."""
    return [d for d in range(batch, 0, -1) if batch % d == 0]


def fit_block_b(
    batch: int,
    D: int,
    H: int,
    Dh: int = 0,
    K: int = 0,
    *,
    fused: bool = True,
    smem_budget_bytes: int | None = None,
) -> int:
    """Largest tile that divides ``batch``, fits the shared-memory budget and
    leaves at least ``min(batch, N_SMS)`` blocks in the grid.

    Raises when not even one window fits the budget: the weights alone
    overflow a block.
    """
    budget = SMEM_BUDGET_BYTES if smem_budget_bytes is None else smem_budget_bytes
    min_blocks = min(batch, N_SMS)
    for bb in block_b_candidates(batch):
        if batch // bb >= min_blocks and smem_bytes(D, H, Dh, K, bb, fused=fused) <= budget:
            return bb
    raise ValueError(
        f"no batch tile fits {budget} bytes of shared memory: one window needs "
        f"{smem_bytes(D, H, Dh, K, 1, fused=fused)} (D={D}, H={H}, Dh={Dh}, K={K})"
    )


def auto_block_b(
    cfg, batch: int | None, smem_budget_bytes: int | None = None, *, fused: bool = True
) -> int | None:
    """``fit_block_b`` for one ``MRConfig``; ``None`` when the batch is unknown
    at compile time (the kernel wrapper then fits the batch it is given)."""
    if batch is None:
        return None
    D = cfg.state_dim + cfg.input_dim
    K = cfg.n_coef + cfg.n_shifts
    return fit_block_b(
        batch, D, cfg.hidden, cfg.dense_hidden, K, fused=fused, smem_budget_bytes=smem_budget_bytes
    )


def legal_block_b(block_b: int | None, batch: int) -> int | None:
    """Drop a tile the batch cannot take.

    A plan resolves ``block_b`` against its compile-time batch (the training
    minibatch), but the same config also serves the full-window readout,
    whose batch differs (193 at the quickstart, a prime). A tile that does
    not divide the batch is dropped here and the wrapper fits a new one, as
    ``repro/kernels/mr_step/ops.py:197-203`` does.
    """
    return block_b if block_b and batch % block_b == 0 else None
