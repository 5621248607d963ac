#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and runs, each phase checking its results (a failure exits non-zero and
prints no result):

1. environment: the card, ``nvidia-smi``'s name and power limit, build time;
2. kernel parity: each kernel against its plain PyTorch version on the card,
   at the quickstart shapes (B = 64 and 193), the MRConfig defaults
   (H=64, Dh=128) and the bench_cycles shape (B=64, T=200, D=8, H=64):
   ``mr_step`` and ``gru_scan`` with and without the flow gate and
   ``mr_step`` with the QAT activation step (``act_bits=(4, 10)``);
   ``mr_step_ltc`` and ``mr_step_node`` at 6 substeps, and at 1 substep and
   with ``act_bits=(4, 10)`` at the quickstart shape; max abs error <= 1e-4.
   The three fused kernels also run the coarse step ``act_bits=(2, 3)`` at
   every shape: it must move their output by at least 10x the tolerance, and
   the output must match the plain version's on every window whose
   normalized summary lies clear of the grid's rounding thresholds;
3. gradient parity: one training step through each fused kernel (GRU flow,
   GRU flow with QAT, LTC, NODE) against the same step with
   ``force_reference``; loss, gradients and step metrics within 1e-4;
4. the main paths: the quickstart's MERINDA offline recovery
   (``compile_plan`` -> ``run_offline`` -> ``readout``) on Lotka-Volterra,
   300 steps at batch 64, with ``encoder="gru_flow"``, then the same spec
   with the paper's LTC and NODE baselines and with fixed-point QAT
   (``qat=QuantConfig(4, 10, 2, 12)``). The launch counts are set to 0 just
   before each run and read just after: each run must launch its own kernel
   at least 301 times and the other kernels never, and end at
   recon_mse <= 1e-3 with max |Theta - true| <= 0.5;
5. the unfused kernel row (``encoder="gru_flow_kernel"``, ``fused=False``),
   20 steps from the same initial parameters: it must launch ``gru_scan`` and
   take the same first step as the fused run (loss within 1e-4);
6. timings with CUDA events (warm-up, then the median of 25 runs) of each
   kernel and its plain version at the quickstart shapes, and of ``mr_step``
   and ``mr_step_ltc`` at the bench_cycles shape, beside the least time the
   card could take for the same work;
7. where a training step's time goes: ``torch.profiler`` over 3 steps of
   each main path counts the device kernels a step launches and their busy
   time.

Each phase prints its seconds. The last lines are the card's name and power
limit, one JSON line listing every kernel, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

TOL = 1e-4
ACT_BITS = (4, 10)  # the QAT run's activation format, Q4.10
# A Q2.3 step moves the head's output by ~1e-2, so a kernel that skipped or
# misplaced it would fail; at Q4.10 the whole step is within TOL. Windows whose
# normalized summary lies within MARGIN of a rounding threshold are left out of
# its comparison: there the kernel's float32 sums (~1e-7 off the plain ones)
# may round the other way, which moves the output by ~1e-3.
COARSE_BITS = (2, 3)
MARGIN = 1e-5
QAT = (4, 10, 2, 12)  # QuantConfig of the QAT main path
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# elementwise operations per hidden unit and step besides the products:
# GRU: bias adds, two sigmoids, r*h, tanh, the (flow) update;
# LTC substep: the sigmoid, sub_dt*f*a + h, 1 + sub_dt*(inv_tau + f), the division;
# NODE substep: two bias adds, tanh, the Euler update
ELEMENTWISE = {"gru": 16, "ltc": 12, "node": 8}
# (label, B, T, D, H, Dh, K); K = 12 is the quickstart head (6 terms x 2 states)
KERNEL_SHAPES = [
    ("quickstart training batch", 64, 32, 2, 32, 64, 12),
    ("quickstart readout batch", 193, 32, 2, 32, 64, 12),
    ("MRConfig defaults", 64, 32, 2, 64, 128, 12),
    ("bench_cycles", 64, 200, 8, 64, 128, 12),
]
DT = 0.05  # lotka_volterra sampling interval: the substep kernels' dt
SUBSTEPS = 6  # MRConfig.ltc_substeps
REPO_PATH = "src/repro_torch/kernels/csrc"
PALLAS = "src/repro/kernels"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) when a phase's check fails."""
    if not ok:
        sys.exit(f"chip_smoke: FAILED: {what}")


class Phase:
    """Prints a phase's seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[{self.name}] phase took {time.perf_counter() - self.t0:.1f} s")


def operands(B, T, D, H, Dh, K, seed, device):
    """mr_step operands at initialization scale, made with numpy from a seed."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).to(device)

    return (
        mk(B, T, D),
        mk(B, H, scale=0.1),
        mk(D, 3 * H, scale=(D + H) ** -0.5),
        mk(H, 3 * H, scale=(D + H) ** -0.5),
        mk(3 * H, scale=0.1),
        mk(H, scale=0.5),
        torch.ones(T, device=device),
        mk(H, Dh, scale=H**-0.5),
        mk(Dh, scale=0.1),
        mk(Dh, K, scale=0.1 * Dh**-0.5),
        mk(K, scale=0.1),
    )


def substep_operands(family, B, T, D, H, Dh, K, seed, device):
    """mr_step_ltc or mr_step_node operands at initialization scale."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0, shift=0.0):
        x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        return torch.from_numpy(x).to(device)

    xs, h0 = mk(B, T, D), mk(B, H, scale=0.1)
    if family == "ltc":  # w_in, w_rec, bias, a, inv_tau
        cell = (mk(D, H, scale=D**-0.5), mk(H, H, scale=H**-0.5), mk(H, scale=0.1),
                mk(H, scale=0.5), mk(H, scale=0.05, shift=0.5))  # fmt: skip
    else:  # w_f1, b_f1, w_f2, b_f2, w_in, b_in
        cell = (mk(H, H, scale=H**-0.5), mk(H, scale=0.1), mk(H, H, scale=0.1 * H**-0.5),
                mk(H, scale=0.1), mk(D, H, scale=D**-0.5), mk(H, scale=0.1))  # fmt: skip
    head = (mk(H, Dh, scale=H**-0.5), mk(Dh, scale=0.1), mk(Dh, K, scale=0.1 * Dh**-0.5),
            mk(K, scale=0.1))  # fmt: skip
    return (xs, h0, *cell, *head)


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, runs: int = 25, per_run: int = 10) -> float:
    """Median over ``runs`` of the mean time of ``per_run`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible")
    from repro_torch import api
    from repro_torch.core import merinda
    from repro_torch.core.engine import make_phys
    from repro_torch.core.library import term_names
    from repro_torch.core.ltc import LTCParams, ltc_scan, ltc_sub_dt
    from repro_torch.core.node_mr import NodeEncoderParams, node_scan, node_sub_dt
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.dynamics import generate_trajectory, get_system
    from repro_torch.data.windows import make_windows
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.gru_scan.ops import gru_scan_cuda
    from repro_torch.kernels.gru_scan.ref import gru_scan_reference
    from repro_torch.kernels.mr_step import tiling
    from repro_torch.kernels.mr_step.ops import mr_step_cuda, mr_step_ltc_cuda, mr_step_node_cuda
    from repro_torch.kernels.mr_step.ref import (
        mr_step_ltc_reference,
        mr_step_node_reference,
        mr_step_reference,
    )
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rt.pin_fp32_matmul()
    counters = {
        "mr_step": mr_step_cuda,
        "mr_step_ltc": mr_step_ltc_cuda,
        "mr_step_node": mr_step_node_cuda,
        "gru_scan": gru_scan_cuda,
    }
    substep = {  # family -> (kernel, plain version, sub_dt)
        "ltc": (mr_step_ltc_cuda, mr_step_ltc_reference, ltc_sub_dt),
        "node": (mr_step_node_cuda, mr_step_node_reference, node_sub_dt),
    }

    def zero_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict[str, int]:
        return {k: fn.launches for k, fn in counters.items()}

    def launch_substep(family, ops, n_sub=SUBSTEPS, act_bits=None):
        """One LTC or NODE kernel launch on ``ops`` at the fitted tile."""
        kernel, _, sub_dt = substep[family]
        D, H, Dh, K = ops[0].shape[2], ops[1].shape[1], ops[-2].shape[0], ops[-1].shape[0]
        bb = tiling.fit_block_b(family, ops[0].shape[0], D, H, Dh, K)
        return kernel(*ops, sub_dt=sub_dt(DT, n_sub), n_substeps=n_sub, block_b=bb,
                      act_bits=act_bits)  # fmt: skip

    def plain_substep(family, ops, n_sub=SUBSTEPS, act_bits=None):
        return substep[family][1](*ops, dt=DT, n_substeps=n_sub, act_bits=act_bits)

    def plain_summary(family, ops):
        """The plain encoder's final state [B, H]: what the head normalizes."""
        if family == "gru":
            return gru_scan_reference(*ops[:7], flow=True)[:, -1]
        if family == "ltc":
            return ltc_scan(LTCParams(*ops[2:7]), ops[0], ops[1], dt=DT, n_substeps=SUBSTEPS)[0]
        enc = NodeEncoderParams(*ops[2:8])
        return node_scan(enc, ops[0], ops[1], dt=DT, n_substeps=SUBSTEPS)[0]

    def settled(h):
        """Windows [B] whose RMS-normed summary lies at least MARGIN from every
        rounding threshold inside the COARSE_BITS grid's range."""
        i, f = COARSE_BITS
        h = h.double()
        y = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + merinda.RMS_EPS) * 2.0**f
        lo, hi = -(2.0 ** (i + f - 1)), 2.0 ** (i + f - 1) - 1
        near = ((y - y.floor() - 0.5).abs() < MARGIN * 2.0**f) & (y > lo) & (y < hi)
        return ~near.any(dim=-1)

    # -- 1. environment --------------------------------------------------------
    with Phase("env"):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
            timeout=60,
        ).stdout.strip()
        log(f"[env] {name}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        lib_path = rt.build_library()
        rt.load_library()
        log(f"[env] kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")

    # -- 2. kernel parity ------------------------------------------------------
    err = dict.fromkeys(counters, 0.0)

    def record(kernel: str, label: str, e: float) -> None:
        log(f"[parity] {label}: {kernel} {e:.3e}")
        check(e <= TOL, f"{kernel} parity at {label}")
        err[kernel] = max(err[kernel], e)

    def record_coarse(kernel, label, out_q, out, want_q, h) -> None:
        keep = settled(h)
        e = (out_q - want_q)[keep].abs().max().item()
        moved = (out_q - out).abs().max().item()
        log(
            f"[parity] {label} act_bits={COARSE_BITS}: {kernel} {e:.3e} on {int(keep.sum())} of "
            f"{len(keep)} windows clear of a rounding threshold; the step moves the output "
            f"by {moved:.3e}"
        )
        check(moved >= 10 * TOL, f"{kernel} act_bits={COARSE_BITS} moves its output at {label}")
        check(4 * int(keep.sum()) >= 3 * len(keep), f"{kernel} settled windows at {label}")
        record(kernel, f"{label} act_bits={COARSE_BITS}", e)

    with Phase("parity"):
        for i, (label, B, T, D, H, Dh, K) in enumerate(KERNEL_SHAPES):
            shape = f"{label} (B={B} T={T} D={D} H={H} Dh={Dh} K={K})"
            bb_mr = tiling.fit_block_b("gru", B, D, H, Dh, K)
            bb_gru = tiling.fit_block_b("gru_scan", B, D, H)
            for flow in (True, False):
                ops = operands(B, T, D, H, Dh, K, seed=i, device=dev)
                out = mr_step_cuda(*ops, flow=flow, block_b=bb_mr)
                hs = gru_scan_cuda(*ops[:7], flow=flow, block_b=bb_gru)
                torch.cuda.synchronize()
                want = mr_step_reference(*ops, flow=flow)
                record("mr_step", f"{shape} flow={flow}", (out - want).abs().max().item())
                want = gru_scan_reference(*ops[:7], flow=flow)
                record("gru_scan", f"{shape} flow={flow}", (hs - want).abs().max().item())
            out_fp = mr_step_cuda(*ops, flow=True, block_b=bb_mr)
            out = mr_step_cuda(*ops, flow=True, block_b=bb_mr, act_bits=ACT_BITS)
            want = mr_step_reference(*ops, flow=True, act_bits=ACT_BITS)
            moved = (out - out_fp).abs().max().item()
            what = f"{shape} act_bits={ACT_BITS} (the step moves the output by {moved:.3e})"
            record("mr_step", what, (out - want).abs().max().item())
            record_coarse(
                "mr_step",
                shape,
                mr_step_cuda(*ops, flow=True, block_b=bb_mr, act_bits=COARSE_BITS),
                out_fp,
                mr_step_reference(*ops, flow=True, act_bits=COARSE_BITS),
                plain_summary("gru", ops),
            )
            for family in substep:
                ops = substep_operands(family, B, T, D, H, Dh, K, seed=10 + i, device=dev)
                variants = [(SUBSTEPS, None)]
                if i == 0:
                    variants += [(1, None), (SUBSTEPS, ACT_BITS)]
                for n_sub, act_bits in variants:
                    out = launch_substep(family, ops, n_sub, act_bits)
                    want = plain_substep(family, ops, n_sub, act_bits)
                    what = f"{shape} substeps={n_sub} act_bits={act_bits}"
                    record(f"mr_step_{family}", what, (out - want).abs().max().item())
                record_coarse(
                    f"mr_step_{family}",
                    shape,
                    launch_substep(family, ops, act_bits=COARSE_BITS),
                    launch_substep(family, ops),
                    plain_substep(family, ops, act_bits=COARSE_BITS),
                    plain_summary(family, ops),
                )

    # -- 3. gradient parity ----------------------------------------------------
    system = get_system("lotka_volterra")
    _, ys, us = generate_trajectory("lotka_volterra")
    yw, uw, norm = make_windows(ys, us, window=32, stride=4)
    spec = api.RecoverySpec(
        state_dim=2,
        order=2,
        hidden=32,
        dense_hidden=64,
        dt=system.dt,
        encoder="gru_flow",
        fused=True,
        block_b="auto",
        mode="offline",
        steps=300,
        lr=3e-3,
        batch_size=64,
    )
    qat = QuantConfig(*QAT)
    runs = {  # the main paths: label -> (spec, the kernel it must launch)
        "gru_flow": (spec, "mr_step"),
        "ltc": (dataclasses.replace(spec, encoder="ltc"), "mr_step_ltc"),
        "node": (dataclasses.replace(spec, encoder="node"), "mr_step_node"),
        "gru_flow+qat": (dataclasses.replace(spec, qat=qat), "mr_step"),
    }
    plans = {label: api.compile_plan(s) for label, (s, _) in runs.items()}
    for label, plan in plans.items():
        check(plan.lowering.dispatch == "cuda", f"{label} dispatch: {plan.lowering}")
    batch = torch.from_numpy(yw[:64]).to(dev)
    with Phase("grad"):
        for label, plan in plans.items():
            cfg = plan.cfg
            gen = torch.Generator(device=dev).manual_seed(0)
            params = merinda.init_mr(gen, cfg, dev)
            phys = make_phys(cfg, norm, dev)
            grads, metrics = [], []
            for force in (False, True):
                leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
                loss, _ = merinda.mr_loss(leaves, cfg, batch, None, phys, force_reference=force)
                grads.append([loss] + list(torch.autograd.grad(loss, tree_leaves(leaves))))
                _, _, m = merinda.mr_train_step(
                    params, adamw_init(params), cfg, batch, None, 3e-3, phys, force_reference=force
                )
                metrics.append(m)
            g_err = max((a - b).abs().max().item() for a, b in zip(*grads))
            m_err = max(abs(metrics[0][k].item() - metrics[1][k].item()) for k in metrics[0])
            log(
                f"[grad] {label}: loss and {len(grads[0]) - 1} gradient leaves: max abs "
                f"{g_err:.3e}; step metrics {m_err:.3e}"
            )
            check(g_err <= TOL and m_err <= TOL, f"gradient parity of {label}")

    # -- 4. the main paths -------------------------------------------------------
    true = system.true_coef()
    results = {}
    for label, (run_spec, own) in runs.items():
        plan = plans[label]
        with Phase(f"main {label}"):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, metrics = plan.run_offline(yw, uw, norm=norm)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            theta = plan.readout(params, yw, uw, norm=norm, n_active=4)
            counts = read_counts()
            recon = metrics["recon_mse"][-1].item()
            max_err = float(np.abs(theta - true).max())
            ms_step = t_train / run_spec.steps * 1e3
            log(f"[main {label}] {plan.lowering}")
            for h in api.history_from_metrics(metrics, log_every=50):
                log(
                    f"[main {label}]   step {h['step']:4d}  loss {h['loss']:.6f}  "
                    f"recon_mse {h['recon_mse']:.6f}"
                )
            log(f"[main {label}] {'term':>6s} {'rec dh/dt':>10s} {'true':>8s} "
                f"{'rec dl/dt':>10s} {'true':>8s}")  # fmt: skip
            for i, term in enumerate(term_names(2, 2, ["h", "l"])):
                log(
                    f"[main {label}] {term:>6s} {theta[i, 0]:10.4f} {true[i, 0]:8.4f} "
                    f"{theta[i, 1]:10.4f} {true[i, 1]:8.4f}"
                )
            log(
                f"[main {label}] {run_spec.steps} steps in {t_train:.2f} s = {ms_step:.2f} "
                f"ms/step; launches {counts}; final recon_mse {recon:.3e}; "
                f"max |theta - true| {max_err:.4f}"
            )
            check(counts[own] >= run_spec.steps + 1, f"{label}: {own} launched {counts[own]} times")
            others = {k: n for k, n in counts.items() if k != own}
            check(not any(others.values()), f"{label} launched other kernels: {others}")
            check(
                np.isfinite(theta).all() and recon <= 1e-3 and max_err <= 0.5,
                f"{label} outcome: recon_mse {recon:.3e}, max |theta - true| {max_err:.4f}",
            )
            results[label] = dict(
                launches=counts[own],
                ms_per_step=ms_step,
                recon_mse=recon,
                max_err=max_err,
                first_loss=metrics["loss"][0].item(),
            )

    # -- 5. the unfused kernel row ---------------------------------------------
    with Phase("row"):
        row_spec = dataclasses.replace(
            spec, encoder="gru_flow_kernel", fused=False, block_b=None, steps=20
        )
        row_plan = api.compile_plan(row_spec)
        check(row_plan.lowering.dispatch == "cuda", f"kernel row dispatch: {row_plan.lowering}")
        zero_counts()
        _, row_metrics = row_plan.run_offline(yw, uw, norm=norm)
        torch.cuda.synchronize()
        counts = read_counts()
        step0 = abs(row_metrics["loss"][0].item() - results["gru_flow"]["first_loss"])
        log(
            f"[row] gru_flow_kernel, fused=False, 20 steps: launches {counts}; step-0 loss "
            f"differs from the fused run's by {step0:.3e}"
        )
        others = {k: n for k, n in counts.items() if k != "gru_scan"}
        check(counts["gru_scan"] > 0 and not any(others.values()), "kernel row launches")
        check(step0 <= TOL, "kernel row step-0 loss")
        results["gru_flow_kernel"] = dict(launches=counts["gru_scan"])

    # -- 6. timings ----------------------------------------------------------------
    timed = {}  # (kernel, shape label) -> (kernel ms, plain ms, bound ms, bound by)
    with Phase("time"):
        for label, B, T, D, H, Dh, K in (KERNEL_SHAPES[0], KERNEL_SHAPES[3]):
            ops = operands(B, T, D, H, Dh, K, seed=0, device=dev)
            bb_mr = tiling.fit_block_b("gru", B, D, H, Dh, K)
            bb_gru = tiling.fit_block_b("gru_scan", B, D, H)
            calls = {
                "mr_step": (
                    lambda: mr_step_cuda(*ops, flow=True, block_b=bb_mr),
                    lambda: mr_step_reference(*ops, flow=True),
                    work("gru", B, T, D, H, Dh, K),
                )
            }
            ltc_ops = substep_operands("ltc", B, T, D, H, Dh, K, seed=20, device=dev)
            calls["mr_step_ltc"] = (
                lambda: launch_substep("ltc", ltc_ops),
                lambda: plain_substep("ltc", ltc_ops),
                work("ltc", B, T, D, H, Dh, K),
            )
            if label == KERNEL_SHAPES[0][0]:
                node_ops = substep_operands("node", B, T, D, H, Dh, K, seed=21, device=dev)
                calls["mr_step_node"] = (
                    lambda: launch_substep("node", node_ops),
                    lambda: plain_substep("node", node_ops),
                    work("node", B, T, D, H, Dh, K),
                )
                calls["gru_scan"] = (
                    lambda: gru_scan_cuda(*ops[:7], flow=True, block_b=bb_gru),
                    lambda: gru_scan_reference(*ops[:7], flow=True),
                    work("gru", B, T, D, H, Dh, K, head=False),
                )
            for kernel, (k_fn, p_fn, (flops, nbytes)) in calls.items():
                k_ms = time_ms(k_fn)
                p_ms = time_ms(p_fn, per_run=1)
                b_ms, b_by = bound_ms(flops, nbytes)
                timed[kernel, label] = (k_ms, p_ms, b_ms, b_by)
                log(
                    f"[time] {kernel} at {label} (B={B} T={T} D={D} H={H}): kernel "
                    f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: "
                    f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e3:.1f} KB)"
                )
        quick, cycles = KERNEL_SHAPES[0][0], KERNEL_SHAPES[3][0]
        log(
            f"[time] MERINDA against LTC at {cycles}: mr_step {timed['mr_step', cycles][0]:.4f} "
            f"ms, mr_step_ltc {timed['mr_step_ltc', cycles][0]:.4f} ms "
            f"({timed['mr_step_ltc', cycles][0] / timed['mr_step', cycles][0]:.2f}x)"
        )

    # -- 7. where a training step's time goes ------------------------------------
    with Phase("profile"):
        for label, plan in plans.items():
            cfg = plan.cfg
            phys = make_phys(cfg, norm, dev)
            p = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), cfg, dev)
            opt = adamw_init(p)
            for _ in range(3):
                p, opt, _ = merinda.mr_train_step(p, opt, cfg, batch, None, 3e-3, phys)
            torch.cuda.synchronize()
            n_prof = 3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_prof):
                    p, opt, _ = merinda.mr_train_step(p, opt, cfg, batch, None, 3e-3, phys)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) / n_prof * 1e3
            by_name: dict[str, list[float]] = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
            n_dev = sum(len(v) for v in by_name.values()) / n_prof
            busy_ms = sum(sum(v) for v in by_name.values()) / n_prof
            log(
                f"[profile {label}] {n_prof} training steps under the profiler: {wall_ms:.2f} "
                f"ms/step wall, {n_dev:.0f} device activities/step, device busy {busy_ms:.3f} "
                f"ms/step ({100 * busy_ms / wall_ms:.2f}% of the step)"
            )
            top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]
            for k, v in top:
                log(
                    f"[profile {label}]   {sum(v) / n_prof:8.4f} ms/step  "
                    f"{len(v) / n_prof:6.0f}/step  {k[:80]}"
                )

    gru_note = (
        "no single PyTorch call computes it: torch.nn.GRU's candidate gate is "
        "tanh(x.Wx_c + r*(h.Wh_c)), this system's is tanh(x.Wx_c + (r*h).Wh_c)"
    )
    substep_note = (
        "no single PyTorch call computes it: PyTorch has no LTC or ODE-RNN cell, "
        "and a loop of its operators is the plain version"
    )
    table = [  # name, source, replaces, the main path whose launches it reports, note
        ("mr_step", "mr_step.cu", "mr_step/kernel.py:129", "gru_flow", gru_note),
        ("gru_scan", "gru_scan.cu", "gru_scan/kernel.py:107", "gru_flow_kernel", gru_note),
        ("mr_step_ltc", "mr_step_ltc.cu", "mr_step/kernel.py:404", "ltc", substep_note),
        ("mr_step_node", "mr_step_node.cu", "mr_step/kernel.py:541", "node", substep_note),
    ]
    kernels = []
    for kernel, src, replaces, path, note in table:
        k_ms, p_ms, b_ms, b_by = timed[kernel, quick]
        row = {
            "name": kernel,
            "route": "cuda",
            "source": f"{REPO_PATH}/{src}",
            "replaces": f"{PALLAS}/{replaces}",
            "launches": results[path]["launches"],
            "main_path": path,
            "max_abs_err": err[kernel],
            "ms": k_ms,
            "kernel_ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "library_note": note,
            "shape": quick,
        }
        if (kernel, cycles) in timed:
            k2, p2, b2, by2 = timed[kernel, cycles]
            row[cycles.replace(" ", "_")] = dict(ms=k2, plain_ms=p2, bound_ms=b2, bound_by=by2)
        kernels.append(row)
    for label in runs:
        r = results[label]
        log(
            f"[summary] {label}: {r['ms_per_step']:.2f} ms/step, {r['launches']} launches, "
            f"recon_mse {r['recon_mse']:.3e}, max |theta - true| {r['max_err']:.4f}"
        )
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
