"""Shared-memory model of the fused kernels and the batch tile (``block_b``).

H100 counterpart of ``repro/kernels/mr_step/tiling.py`` (``vmem_bytes``,
``ltc_vmem_bytes``, ``node_vmem_bytes``, ``config_vmem_bytes``,
``auto_block_b``). On the TPU the tile was fitted to VMEM; on Hopper a block
stages the cell's weights, the head weights and the tile's state in its own
shared memory, at most 227 KB a block. Blocks also run in parallel on 132
SMs, so the tile is kept small enough that the grid has at least
``min(B, 132)`` blocks: one large tile would put the whole batch's scan on one
SM. The slot-axis forms (S calls in one launch, grid (B / tile, S)) keep
``min(S * B, 132)`` (``slots=S``).

``mr_step``, ``mr_step_ltc``, ``mr_step_node`` and the bare scan
``gru_scan`` are warp-per-window recurrences (``csrc/warp_cell.cuh``): a block
of ``block_b`` windows runs one warp a window (at most ``CELL_WARPS`` warps; a
larger tile takes its windows in turn), so their carve is the block's weights
once plus one area a warp (``mr_step_smem_bytes``, ``gru_scan_smem_bytes``,
``ltc_smem_bytes``, ``node_smem_bytes``). Their tile
follows the same rule as the other kernels': more windows a block share one
staging of the weights, fewer spread the chains over more SMs, and on the
card the two balance. At the quickstart (B=64) 1, 2 and 4 windows a block
take the same time within a few percent; at bench_cycles 4 is slower than 1
and 2 (``repro_torch.launch.kernel_phases``; the times are in ``PERF.md``).

Each ``*_smem_bytes`` function counts exactly what its kernel carves. The
callers name the kernel by its family: the encoder row's ``family`` (the
field ``kernels/mr_step/ops.py`` dispatches the fused kernels on), or
``"gru_scan"`` for the bare scan (``csrc/gru_scan.cu``: ``mr_step``'s carve
with no head).

Past the warp cell's ``MAX_HIDDEN`` the bare scan takes its wide form
(``csrc/gru_scan_wide.cu``, the merinda-gru LM at H = 512): a batch row a
thread-block cluster of ``WIDE_CLUSTER`` blocks, each block holding its
units' recurrent columns in registers and the row's h and r*h, double-buffered,
in shared memory (``gru_scan_wide_smem_bytes``, one block's carve); its x.Wx + b
takes a skinny GEMM at ``B * T <= WIDE_SKINNY_ROWS`` (decode).

The int8 serving stages ``csrc/mr_step_int8.cu`` and ``mr_step_ltc_int8.cu``
and the int8 scan ``csrc/gru_scan_int8.cu`` are the same warp-per-window
recurrences on the warp cell's int8/PWL policy: their carves
(``int8_smem_bytes``, ``ltc_int8_smem_bytes``, and ``gru_scan_int8_smem_bytes``,
``mr_step_int8``'s carve with no head) hold the input and head weights as int8
(rounded up to whole floats), the recurrent columns dequantized once (as the
fp32 twin's, or the int8 rows at H <= 32, which each lane dequantizes into its
registers), one float scale per output channel and the packed PWL tables
(``core/quant.py`` ``PWL_FLOATS`` floats each), and their tile follows the same
rule. The functions below that serve both kinds take ``int8=True`` for the
int8 kernels.

The banked service ticks (``csrc/mr_tick.cu``, and its int8/PWL twin
``mr_tick_int8.cu`` on the warp cell's int8 policy) spread one slot's N
windows over a thread-block cluster of ``tick_cluster(N)`` blocks of
``tick_warps(N)`` warps, one warp a window, and a cluster takes its bank's
slots in turn; their carve (``tick_smem_bytes``) is one block's and does not
grow with the bank. The bank size (``auto_slots_per_bank``) only decides how
many clusters share the slots. On the TPU the whole slot set was one bank,
so nothing streamed; here the grid keeps ``min(S, 132)`` clusters, one slot
each for S <= 132.

Each function here is the predicted side of a carve. The measured side is the
launcher's own: every kernel source exports the bytes its launch requests
(``runtime.kernel_smem_bytes``), and the launch wrappers check those against
the budget; the plan auditor's rule R2 holds the two sides equal
(``analysis/audit.py``). ``resolve_smem_budget`` is the budget an ``"auto"``
tile fits into, and names where it came from.

``SUBSTEP_UNROLLS`` are the unroll factors of the LTC and NODE kernels'
substep loop (``csrc/warp_cell.cuh`` ``substeps``): the launchers refuse any
other, and ``check_unroll`` raises before a plan would ask for one.
"""

from __future__ import annotations

from repro_torch.core.quant import PWL_FLOATS

SMEM_BUDGET_BYTES = 232_448  # 227 KB: the most dynamic shared memory a block can use
N_SMS = 132  # streaming multiprocessors of an H100 SXM
FAMILIES = ("gru", "ltc", "node", "gru_scan")
# the LTC and NODE kernels' instantiated substep unrolls: 2 and 6 gave the same
# bits and no faster kernel on an H100 (launch/kernel_phases.py times them)
SUBSTEP_UNROLLS = (1,)
UNROLLED_FAMILIES = ("ltc", "node")  # the families whose kernels take the factor


def check_unroll(unroll: int, family: str) -> None:
    """Raise unless ``family``'s kernel is instantiated for the substep
    unroll ``unroll`` (any factor passes a family whose kernel has none)."""
    if family in UNROLLED_FAMILIES and unroll not in SUBSTEP_UNROLLS:
        raise ValueError(
            f"substep_unroll={unroll} has no instantiation in the {family} kernel; it is built "
            f"for {SUBSTEP_UNROLLS} (csrc/warp_cell.cuh substeps)"
        )


def resolve_smem_budget(device=None, explicit: int | None = None) -> tuple[int, str]:
    """The shared memory an ``"auto"`` tile fits into, and its source:
    ``"explicit"`` (``explicit``, the spec's ``smem_budget_bytes``),
    ``"device"`` (the card's opt-in shared memory a block, from
    ``torch.cuda.get_device_properties``) or ``"default"``
    (``SMEM_BUDGET_BYTES``; on the CPU). ``repro/kernels/mr_step/tiling.py:51``
    ``resolve_vmem_budget`` is the TPU's."""
    if explicit is not None:
        return int(explicit), "explicit"
    import torch

    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        optin = getattr(props, "shared_memory_per_block_optin", 0)
        if optin:
            return int(optin), "device"
    return SMEM_BUDGET_BYTES, "default"


# csrc/warp_cell.cuh: every region of a carve starts 16-byte aligned (whole
# float4s); a warp computes the h-independent terms of CELL_CHUNK steps at once
CELL_WARPS = 8  # kWarps
CELL_CHUNK = 16  # kChunk
CELL_MAX_UNITS = 8  # kMaxUnits: hidden units a lane at most
MAX_HIDDEN = 32 * CELL_MAX_UNITS  # the widest H a warp-cell kernel takes


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def cell_warps(block_b: int) -> int:
    """Warps a block of the warp-cell kernels runs: one a window, at most
    ``CELL_WARPS``."""
    return min(block_b, CELL_WARPS)


def col_stride(H: int) -> int:
    """``warp_cell.cuh`` ``col_stride``: floats between two columns of a
    recurrent weight matrix stored column-major (a multiple of 4, 4 mod 8)."""
    return (H + 7) // 8 * 8 + 4


def _cell_head_floats(H: int, Dh: int, K: int) -> int:
    """``warp_cell.cuh`` ``HeadLayout``: w1, b1, w2, b2."""
    return sum(map(_pad4, (H * Dh, Dh, Dh * K, K)))


def mr_step_smem_bytes(D: int, H: int, Dh: int, K: int, block_b: int) -> int:
    """``mr_step`` (``warp_cell.cuh`` ``GruLayout``): wx, wh's 3H columns,
    b, time_scale and the head's weights once; a warp: two rows, two x and dts
    chunks, the gates' x.Wx + b and the flow gate's phi * alpha for a chunk."""
    nu, C, R, S = -(-H // 32), CELL_CHUNK, max(H, Dh), col_stride(H)
    block = sum(map(_pad4, (D * 3 * H, 3 * H * S, 3 * H, H))) + _cell_head_floats(H, Dh, K)
    warp = (2 * _pad4(R) + 2 * (_pad4(C * D) + _pad4(C)) + _pad4(C * 3 * 32 * nu)
            + _pad4(C * 32 * nu))  # fmt: skip
    return 4 * (block + cell_warps(block_b) * warp)


def gru_scan_smem_bytes(D: int, H: int, block_b: int) -> int:
    """``gru_scan`` (``GruLayout`` with no head): ``mr_step``'s carve at
    Dh = K = 0."""
    return mr_step_smem_bytes(D, H, 0, 0, block_b)


# csrc/gru_scan_wide.cu: the wide form of gru_scan (MAX_HIDDEN < H <= WIDE_MAX_HIDDEN),
# a batch row a thread-block cluster of WIDE_CLUSTER blocks, WIDE_UNITS hidden units a
# block; its rows in shared memory are WIDE_MAX_HIDDEN long at every H
WIDE_CLUSTER = 16  # kCluster
WIDE_UNITS = 32  # kUnits
WIDE_MAX_HIDDEN = WIDE_CLUSTER * WIDE_UNITS  # kMaxHidden
WIDE_SKINNY_ROWS = 16  # kSkinnyRows: x.Wx + b through gru_wide_gx_skinny_kernel at B * T <= it


def gru_scan_wide_smem_bytes(H: int) -> int:
    """``gru_scan_wide`` (``gru_scan_wide.cu`` ``wide::Layout``), one block of a
    cluster, the same at every H: the row's h and r*h, each at two step
    parities, then four 8-byte mbarriers (the weights are in registers)."""
    return 4 * (2 * 2 * WIDE_MAX_HIDDEN + 2 * 4)


def ltc_smem_bytes(D: int, H: int, Dh: int, K: int, block_b: int) -> int:
    """``mr_step_ltc`` (``warp_cell.cuh`` ``LtcLayout``): w_rec's columns,
    w_in, bias, a, inv_tau and the head's weights once; a warp: two rows, two
    x chunks, the drive x.W_in + bias for a chunk."""
    nu, C, R, S = -(-H // 32), CELL_CHUNK, max(H, Dh), col_stride(H)
    block = sum(map(_pad4, (H * S, D * H, H, H, H))) + _cell_head_floats(H, Dh, K)
    warp = 2 * _pad4(R) + 2 * _pad4(C * D) + _pad4(C * 32 * nu)
    return 4 * (block + cell_warps(block_b) * warp)


def node_smem_bytes(D: int, H: int, Dh: int, K: int, block_b: int) -> int:
    """``mr_step_node`` (``warp_cell.cuh`` ``NodeLayout``): w_f1's and
    w_f2's columns, w_in, three biases and the head's weights once; a warp:
    two rows, two x chunks, the injection x.W_in + b_in for a chunk."""
    nu, C, R, S = -(-H // 32), CELL_CHUNK, max(H, Dh), col_stride(H)
    block = sum(map(_pad4, (H * S, H * S, D * H, H, H, H))) + _cell_head_floats(H, Dh, K)
    warp = 2 * _pad4(R) + 2 * _pad4(C * D) + _pad4(C * 32 * nu)
    return 4 * (block + cell_warps(block_b) * warp)


def q_floats(n: int) -> int:
    """Floats that ``n`` int8 values occupy in a carve (``csrc/common.cuh``)."""
    return (n + 3) // 4


def _cell_head_q_floats(H: int, Dh: int, K: int) -> int:
    """``warp_cell.cuh`` ``HeadQLayout``: int8 w1, its scales, b1, int8 w2,
    its scales, b2."""
    return sum(map(_pad4, (q_floats(H * Dh), Dh, Dh, q_floats(Dh * K), K, K)))


def int8_smem_bytes(D: int, H: int, Dh: int, K: int, block_b: int) -> int:
    """``mr_step_int8`` (``warp_cell.cuh`` ``GruQLayout``): int8 wx in whole
    floats, wh's 3H columns dequantized (at H <= 32 the int8 rows in their
    place), the scales of both, b, the two PWL tables and the int8 head once; a
    warp: two rows, two x chunks, the gates' x.Wx for a chunk."""
    nu, C, R, S = -(-H // 32), CELL_CHUNK, max(H, Dh), col_stride(H)
    block = (sum(map(_pad4, (q_floats(D * 3 * H), 3 * H * S, 3 * H, 3 * H, 3 * H, PWL_FLOATS,
                             PWL_FLOATS))) + _cell_head_q_floats(H, Dh, K))  # fmt: skip
    warp = 2 * _pad4(R) + 2 * _pad4(C * D) + _pad4(C * 3 * 32 * nu)
    return 4 * (block + cell_warps(block_b) * warp)


def gru_scan_int8_smem_bytes(D: int, H: int, block_b: int) -> int:
    """``gru_scan_int8`` (``GruQLayout`` with no head): ``mr_step_int8``'s
    carve at Dh = K = 0."""
    return int8_smem_bytes(D, H, 0, 0, block_b)


def ltc_int8_smem_bytes(D: int, H: int, Dh: int, K: int, block_b: int) -> int:
    """``mr_step_ltc_int8`` (``warp_cell.cuh`` ``LtcQLayout``): w_rec's columns
    dequantized (at H <= 32 the int8 rows in their place), int8 w_in in whole
    floats, the scales of both, bias, a, inv_tau, the sigmoid table and the
    int8 head once; a warp as ``mr_step_ltc``'s."""
    nu, C, R, S = -(-H // 32), CELL_CHUNK, max(H, Dh), col_stride(H)
    block = (sum(map(_pad4, (H * S, q_floats(D * H), H, H, H, H, H, PWL_FLOATS)))
             + _cell_head_q_floats(H, Dh, K))  # fmt: skip
    warp = 2 * _pad4(R) + 2 * _pad4(C * D) + _pad4(C * 32 * nu)
    return 4 * (block + cell_warps(block_b) * warp)


def family_smem_bytes(
    family: str, D: int, H: int, Dh: int, K: int, block_b: int, int8: bool = False
) -> int:
    """Shared memory of one block of the kernel of ``family`` (its int8
    serving twin with ``int8=True``; the NODE family has none)."""
    if int8:
        if family == "gru":
            return int8_smem_bytes(D, H, Dh, K, block_b)
        if family == "ltc":
            return ltc_int8_smem_bytes(D, H, Dh, K, block_b)
        if family == "gru_scan":
            return gru_scan_int8_smem_bytes(D, H, block_b)
        raise ValueError(f"no int8 kernel for family {family!r}; int8 families: gru, ltc, gru_scan")
    if family == "ltc":
        return ltc_smem_bytes(D, H, Dh, K, block_b)
    if family == "node":
        return node_smem_bytes(D, H, Dh, K, block_b)
    if family == "gru_scan":
        return gru_scan_smem_bytes(D, H, block_b)
    if family != "gru":
        raise ValueError(f"unknown mr_step family {family!r}; known: {FAMILIES}")
    return mr_step_smem_bytes(D, H, Dh, K, block_b)


def _shape(cfg) -> tuple[int, int, int, int]:
    return cfg.state_dim + cfg.input_dim, cfg.hidden, cfg.dense_hidden, cfg.n_coef + cfg.n_shifts


def config_smem_bytes(cfg, family: str, block_b: int) -> int:
    """Shared memory per block of the fused kernel of one ``MRConfig`` whose
    encoder row is of ``family``."""
    return family_smem_bytes(family, *_shape(cfg), block_b)


def block_b_candidates(batch: int) -> list[int]:
    """Every tile that divides ``batch``, largest first."""
    return [d for d in range(batch, 0, -1) if batch % d == 0]


def fit_block_b(
    family: str,
    batch: int,
    D: int,
    H: int,
    Dh: int = 0,
    K: int = 0,
    *,
    smem_budget_bytes: int | None = None,
    int8: bool = False,
    slots: int = 1,
) -> int:
    """Largest tile that divides ``batch``, fits the shared-memory budget and
    leaves at least ``min(slots * batch, N_SMS)`` blocks in the grid. ``int8``
    fits the family's int8 serving kernel; ``slots`` the slot-axis form, whose
    grid holds ``slots * batch / tile`` blocks (a block stages one slot's
    weights, so its carve is the unbatched kernel's).

    Raises when not even one window fits the budget: the weights alone
    overflow a block.
    """
    budget = SMEM_BUDGET_BYTES if smem_budget_bytes is None else smem_budget_bytes

    def nbytes(bb: int) -> int:
        return family_smem_bytes(family, D, H, Dh, K, bb, int8=int8)

    min_blocks = min(slots * batch, N_SMS)
    for bb in block_b_candidates(batch):
        if slots * batch // bb >= min_blocks and nbytes(bb) <= budget:
            return bb
    raise ValueError(
        f"no batch tile fits {budget} bytes of shared memory: one window needs "
        f"{nbytes(1)} ({family}, D={D}, H={H}, Dh={Dh}, K={K}, int8={int8})"
    )


def auto_block_b(
    cfg,
    family: str,
    batch: int | None,
    smem_budget_bytes: int | None = None,
    int8: bool = False,
    slots: int = 1,
) -> int | None:
    """``fit_block_b`` of the fused kernel of one ``MRConfig`` whose encoder
    row is of ``family`` (over ``slots`` slots); ``None`` when the batch is
    unknown at compile time (the kernel wrapper then fits the batch it is
    given)."""
    if batch is None:
        return None
    return fit_block_b(
        family, batch, *_shape(cfg), smem_budget_bytes=smem_budget_bytes, int8=int8, slots=slots
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


# ---------------------------------------------------------------------------
# the banked service tick (csrc/mr_tick.cu, csrc/mr_tick_int8.cu)
# ---------------------------------------------------------------------------
MAX_CLUSTER = 8  # warp_cell.cuh kMaxCluster: the portable cluster size


def tick_cluster(N: int) -> int:
    """``warp_cell.cuh`` ``tick_cluster``: blocks of a slot's cluster,
    ceil(N / CELL_WARPS) and at most ``MAX_CLUSTER``."""
    return min(-(-N // CELL_WARPS), MAX_CLUSTER)


def tick_warps(N: int) -> int:
    """``warp_cell.cuh`` ``tick_warps``: warps a block of the cluster, the N
    windows spread evenly, at most ``CELL_WARPS`` (past that they take the
    windows in turn)."""
    return min(-(-N // tick_cluster(N)), CELL_WARPS)


def tick_smem_bytes(D: int, H: int, Dh: int, Ko: int, N: int, T: int, int8: bool = False) -> int:
    """``mr_tick`` (``warp_cell.cuh`` ``TickLayout``), one block of a slot's
    cluster: wx, wh's 3H columns, b, time_scale, the head's weights and the
    slot's head outputs [N, Ko] once; a warp: two rows, its window's
    normalized x [T, D] (T rounded up to whole chunks), the gates' x.Wx + b
    for a chunk. ``int8``: ``mr_tick_int8`` (``TickQLayout``): int8 wx and
    wh's 3H columns in whole floats, the scales of both and b, the two PWL
    tables, the int8 head (``HeadQLayout``) and the head outputs once; a warp
    as ``mr_tick``'s."""
    nu, C, R, S = -(-H // 32), CELL_CHUNK, max(H, Dh), col_stride(H)
    Tc = -(-T // C) * C
    if int8:
        block = (sum(map(_pad4, (q_floats(D * 3 * H), q_floats(3 * H * S), 3 * H, 3 * H, 3 * H,
                                 PWL_FLOATS, PWL_FLOATS))) + _cell_head_q_floats(H, Dh, Ko)
                 + _pad4(N * Ko))  # fmt: skip
    else:
        block = (sum(map(_pad4, (D * 3 * H, 3 * H * S, 3 * H, H))) + _cell_head_floats(H, Dh, Ko)
                 + _pad4(N * Ko))  # fmt: skip
    warp = 2 * _pad4(R) + _pad4(Tc * D) + _pad4(C * 3 * 32 * nu)
    return 4 * (block + tick_warps(N) * warp)


def config_tick_smem_bytes(cfg, scfg, int8: bool = False) -> int:
    """``tick_smem_bytes`` of one ``MRConfig`` under one ``StreamConfig``."""
    return tick_smem_bytes(*_shape(cfg), scfg.n_windows, scfg.window, int8=int8)


def slots_per_bank_candidates(n_slots: int) -> list[int]:
    """Every bank size that divides ``n_slots``, largest first."""
    if n_slots < 1:
        return []
    return [d for d in range(n_slots, 0, -1) if n_slots % d == 0]


def auto_slots_per_bank(
    cfg, scfg, n_slots: int, smem_budget_bytes: int | None = None, int8: bool = False
) -> int:
    """Largest divisor of ``n_slots`` that leaves at least ``min(n_slots,
    N_SMS)`` banks (a cluster each, for both ticks), when one slot fits: a
    block of its cluster within the budget; 0 when it does not (``compile_plan`` then keeps
    ``tick_kernel="auto"`` on the composite tick)."""
    budget = SMEM_BUDGET_BYTES if smem_budget_bytes is None else smem_budget_bytes
    if n_slots < 1 or config_tick_smem_bytes(cfg, scfg, int8=int8) > budget:
        return 0
    min_blocks = min(n_slots, N_SMS)
    return next(d for d in slots_per_bank_candidates(n_slots) if n_slots // d >= min_blocks)
