"""Roofline counts of the recovery kernels: operations and bytes, and the bound.

One copy of the counts the kernel table's bounds are computed from: the
on-chip smoke run (``chip_smoke.py``) imports it for every ``bound_ms`` it
prints, and the tuner (``analysis/tuner.py``) for each candidate's roofline
time. ``work`` and ``work_int8`` count one fused call (``mr_step``,
``mr_step_ltc``, ``mr_step_node``, their int8/PWL twins; ``head=False`` the bare
scans), ``tick_work`` and ``tick_work_int8`` one banked tick: each input read
once, each output written once, and the operations these inputs need.
``bound_ms`` is the least time the card could take for them: the larger of
the operations over the peak rate of their type and the bytes over the memory
rate.
"""

from __future__ import annotations

from repro_torch.core.quant import PWL_FLOATS

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, bf16 on
# the tensor cores (dense), HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# elementwise operations per hidden unit and step besides the products:
# GRU: bias adds, two sigmoids, r*h, tanh, the (flow) update;
# LTC substep: the sigmoid, sub_dt*f*a + h, 1 + sub_dt*(inv_tau + f), the division;
# NODE substep: two bias adds, tanh, the Euler update
ELEMENTWISE = {"gru": 16, "ltc": 12, "node": 8}
# elementwise operations per hidden unit and step of the int8 cells besides the
# products and their per-column scale multiplies: GRU: 3 PWL evaluations (~8
# each), bias adds, r*h, the update; LTC substep: 1 PWL evaluation and the
# semi-implicit update
ELEMENTWISE_INT8 = {"gru": 34, "ltc": 14}
SUBSTEPS = 6  # MRConfig.ltc_substeps


def work(family, B, T, D, H, Dh, K, n_sub=SUBSTEPS, head=True) -> tuple[float, float]:
    """(operations, bytes) of one fused call (``head=False``: the bare
    ``gru_scan``, which writes hs [B, T, H]): each input read once, the output
    written once, and the operations these inputs need."""
    e = ELEMENTWISE[family]
    if family == "gru":
        flops = B * T * (2 * (D + H) * 3 * H + e * H)
        weights = (D + H) * 3 * H + 3 * H + H + T  # wx, wh, b, time_scale, dts
    elif family == "ltc":
        flops = B * T * (2 * D * H + H) + B * T * n_sub * (2 * H * H + e * H)
        weights = D * H + H * H + 3 * H
    else:
        flops = B * T * (2 * D * H + 2 * H) + B * T * n_sub * (4 * H * H + e * H)
        weights = 2 * H * H + D * H + 3 * H
    if not head:
        return flops, 4 * (B * T * D + B * H + weights + B * T * H)
    head_flops = B * (2 * H * Dh + 2 * Dh * K + 3 * H + 2 * Dh + K)
    head_weights = H * Dh + Dh + Dh * K + K
    return flops + head_flops, 4 * (B * T * D + B * H + weights + head_weights + B * K)


def work_int8(family, B, T, D, H, Dh, K, n_sub=SUBSTEPS, head=True) -> tuple[float, float]:
    """(operations, bytes) of one int8/PWL call: a multiply-add for every
    weight use and one scale multiply for every output column of a product
    (the scale factors out of the sum); int8 weights are read as one byte
    each, their scales, the biases and the PWL tables as floats."""
    e = ELEMENTWISE_INT8[family]
    tables = 2 * PWL_FLOATS
    if family == "gru":  # x·Wx and h·Wh, each scaled per column of 3H
        flops = B * T * (2 * (D + H) * 3 * H + 2 * 3 * H + e * H)
        wbytes = (D + H) * 3 * H + 4 * (3 * 3 * H + tables)
    else:  # x·W_in once a step, h·W_rec every substep, each scaled per column of H
        flops = B * T * (2 * D * H + H + H) + B * T * n_sub * (2 * H * H + H + e * H)
        wbytes = D * H + H * H + 4 * (5 * H + PWL_FLOATS)
    if not head:
        return flops, 4 * (B * T * D + B * H + B * T * H) + wbytes
    head_flops = B * (2 * H * Dh + Dh + 2 * Dh * K + K + 3 * H + 2 * Dh + K)
    head_bytes = H * Dh + Dh * K + 4 * (2 * Dh + 2 * K)
    return flops + head_flops, 4 * (B * T * D + B * H + B * K) + wbytes + head_bytes


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over the
    peak for their type (float32 unless named) and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tick_work(S, L, C, n, m, N, T, H, Dh, Ko, Kc) -> tuple[float, float]:
    """(operations, bytes) of one ``mr_tick`` call: the GRU scan and head of
    every slot's N windows, the window mean, EMA and delta; every input read
    once (buffers, chunks, stats, the previous readout, the flags, each
    slot's weights) and every output written once (rolled buffers, theta,
    delta)."""
    D = n + m
    flops = S * N * T * (2 * D * 3 * H + 2 * H * 3 * H + ELEMENTWISE["gru"] * H)
    flops += S * N * (2 * H * Dh + 2 * Dh * Ko + 3 * H + 2 * Dh + Ko)  # the head
    flops += S * (N * T * D * 2 + Kc * (N + 8))  # normalization; mean, EMA, delta
    weights = (D + H) * 3 * H + 3 * H + H + H * Dh + Dh + Dh * Ko + Ko
    reads = L * D + C * D + 2 * n + Kc + 2 + weights
    writes = L * D + Kc + 1
    return flops, 4 * S * (reads + writes)


def tick_work_int8(S, L, C, n, m, N, T, H, Dh, Ko, Kc) -> tuple[float, float]:
    """``tick_work`` of ``mr_tick_int8``: the int8 cell and head (a
    multiply-add a weight use, a scale multiply an output column), one-byte
    weights beside float scales and biases, the two PWL tables read once."""
    D = n + m
    flops = S * N * T * (2 * D * 3 * H + 2 * H * 3 * H + 2 * 3 * H + ELEMENTWISE_INT8["gru"] * H)
    flops += S * N * (2 * H * Dh + Dh + 2 * Dh * Ko + Ko + 3 * H + 2 * Dh + Ko)
    flops += S * (N * T * D * 2 + Kc * (N + 8))
    weights = (D + H) * 3 * H + H * Dh + Dh * Ko + 4 * (3 * 3 * H + 2 * Dh + 2 * Ko)
    reads = 4 * (L * D + C * D + 2 * n + Kc + 2) + weights
    writes = 4 * (L * D + Kc + 1)
    return flops, S * (reads + writes) + 4 * 2 * PWL_FLOATS
