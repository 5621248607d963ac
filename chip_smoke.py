#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and runs, each phase checking its results (a failure exits non-zero and
prints no result):

1. environment: the card, ``nvidia-smi``'s name and power limit, build time;
2. kernel parity: each kernel against its plain PyTorch version on the card,
   at the quickstart shapes (B = 64 and 193), the MRConfig defaults
   (H=64, Dh=128) and the bench_cycles shape (B=64, T=200, D=8, H=64), with
   and without the flow gate; max abs error <= 1e-4;
3. gradient parity: one training step through the kernel against the same
   step with ``force_reference``; loss and gradients within 1e-4;
4. the main path: the quickstart's MERINDA offline recovery
   (``compile_plan`` -> ``run_offline`` -> ``readout``) on Lotka-Volterra,
   300 steps at batch 64; it must launch ``mr_step`` at least 301 times and
   end at recon_mse <= 1e-3 with max |Theta - true| <= 0.5;
5. the unfused kernel row (``encoder="gru_flow_kernel"``, ``fused=False``),
   20 steps from the same initial parameters: it must launch ``gru_scan`` and
   take the same first step as the fused run (loss within 1e-4);
6. timings with CUDA events (warm-up, then the median of 25 runs) of each
   kernel and its plain version at the quickstart shapes, beside the least
   time the card could take for the same work;
7. where a training step's time goes: ``torch.profiler`` over 5 main-path
   steps counts the device kernels a step launches and their busy time.

The last lines are the card's name and power limit, one JSON line listing
every kernel, and ``{"ok": true, "device": {...}}``.
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
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# elementwise operations per hidden unit and step besides the gate products:
# bias adds, two sigmoids, r*h, tanh, the (flow) update
ELEMENTWISE_PER_UNIT_STEP = 16
# (label, B, T, D, H, Dh, K); K = 12 is the quickstart head (6 terms x 2 states)
KERNEL_SHAPES = [
    ("quickstart training batch", 64, 32, 2, 32, 64, 12),
    ("quickstart readout batch", 193, 32, 2, 32, 64, 12),
    ("MRConfig defaults", 64, 32, 2, 64, 128, 12),
    ("bench_cycles", 64, 200, 8, 64, 128, 12),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) when a phase's check fails."""
    if not ok:
        sys.exit(f"chip_smoke: FAILED: {what}")


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


def gru_work(B, T, D, H):
    return B * T * (2 * (D + H) * 3 * H + ELEMENTWISE_PER_UNIT_STEP * H)


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
    from repro_torch.data.dynamics import generate_trajectory, get_system
    from repro_torch.data.windows import make_windows
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.gru_scan.ops import gru_scan_cuda
    from repro_torch.kernels.gru_scan.ref import gru_scan_reference
    from repro_torch.kernels.mr_step import tiling
    from repro_torch.kernels.mr_step.ops import mr_step_cuda
    from repro_torch.kernels.mr_step.ref import mr_step_reference
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rt.pin_fp32_matmul()

    # -- 1. environment --------------------------------------------------------
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
    err = {"mr_step": 0.0, "gru_scan": 0.0}
    for i, (label, B, T, D, H, Dh, K) in enumerate(KERNEL_SHAPES):
        for flow in (True, False):
            ops = operands(B, T, D, H, Dh, K, seed=i, device=dev)
            out = mr_step_cuda(*ops, flow=flow, block_b=tiling.fit_block_b(B, D, H, Dh, K))
            bb = tiling.fit_block_b(B, D, H, fused=False)
            hs = gru_scan_cuda(*ops[:7], flow=flow, block_b=bb)
            torch.cuda.synchronize()
            e_mr = (out - mr_step_reference(*ops, flow=flow)).abs().max().item()
            e_gru = (hs - gru_scan_reference(*ops[:7], flow=flow)).abs().max().item()
            log(
                f"[parity] {label}: B={B} T={T} D={D} H={H} Dh={Dh} K={K} flow={flow} "
                f"mr_step {e_mr:.3e} gru_scan {e_gru:.3e}"
            )
            check(e_mr <= TOL and e_gru <= TOL, f"kernel parity at {label}, flow={flow}")
            err["mr_step"] = max(err["mr_step"], e_mr)
            err["gru_scan"] = max(err["gru_scan"], e_gru)

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
    plan = api.compile_plan(spec)
    check(plan.lowering.dispatch == "cuda", f"main path dispatch: {plan.lowering}")
    cfg = plan.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = merinda.init_mr(gen, cfg, dev)
    batch = torch.from_numpy(yw[:64]).to(dev)
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
    log(f"[grad] loss and 7 gradient leaves: max abs {g_err:.3e}; step metrics {m_err:.3e}")
    check(g_err <= TOL and m_err <= TOL, "gradient parity")

    # -- 4. the main path --------------------------------------------------------
    mr_step_cuda.launches = 0
    gru_scan_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, metrics = plan.run_offline(yw, uw, norm=norm)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    theta = plan.readout(params, yw, uw, norm=norm, n_active=4)
    mr_launches = mr_step_cuda.launches
    check(gru_scan_cuda.launches == 0, "the fused main path launched gru_scan")
    true = system.true_coef()
    recon = metrics["recon_mse"][-1].item()
    max_err = float(np.abs(theta - true).max())
    log(f"[main] {plan.lowering}")
    for h in api.history_from_metrics(metrics, log_every=50):
        log(f"[main]   step {h['step']:4d}  loss {h['loss']:.6f}  recon_mse {h['recon_mse']:.6f}")
    log(f"[main] {'term':>6s} {'rec dh/dt':>10s} {'true':>8s} {'rec dl/dt':>10s} {'true':>8s}")
    for i, term in enumerate(term_names(2, 2, ["h", "l"])):
        log(
            f"[main] {term:>6s} {theta[i, 0]:10.4f} {true[i, 0]:8.4f} "
            f"{theta[i, 1]:10.4f} {true[i, 1]:8.4f}"
        )
    ms_step = t_train / spec.steps * 1e3
    log(
        f"[main] {spec.steps} steps in {t_train:.2f} s = {ms_step:.2f} ms/step; "
        f"mr_step launches {mr_launches}; final recon_mse {recon:.3e}; "
        f"max |theta - true| {max_err:.4f}"
    )
    check(mr_launches >= spec.steps + 1, f"mr_step launched {mr_launches} times")
    check(np.isfinite(theta).all() and recon <= 1e-3 and max_err <= 0.5, "quickstart outcome")

    # -- 5. the unfused kernel row ---------------------------------------------
    row_spec = dataclasses.replace(
        spec, encoder="gru_flow_kernel", fused=False, block_b=None, steps=20
    )
    row_plan = api.compile_plan(row_spec)
    check(row_plan.lowering.dispatch == "cuda", f"kernel row dispatch: {row_plan.lowering}")
    mr_step_cuda.launches = 0
    gru_scan_cuda.launches = 0
    _, row_metrics = row_plan.run_offline(yw, uw, norm=norm)
    torch.cuda.synchronize()
    gru_launches = gru_scan_cuda.launches
    step0 = abs(row_metrics["loss"][0].item() - metrics["loss"][0].item())
    log(
        f"[row] gru_flow_kernel, fused=False, 20 steps: gru_scan launches {gru_launches}, "
        f"mr_step launches {mr_step_cuda.launches}; step-0 loss differs from the fused "
        f"run's by {step0:.3e}"
    )
    check(gru_launches > 0 and mr_step_cuda.launches == 0, "kernel row launches")
    check(step0 <= TOL, "kernel row step-0 loss")

    # -- 6. timings ----------------------------------------------------------------
    _, B, T, D, H, Dh, K = KERNEL_SHAPES[0]
    ops = operands(B, T, D, H, Dh, K, seed=0, device=dev)
    bb_mr, bb_gru = tiling.fit_block_b(B, D, H, Dh, K), tiling.fit_block_b(B, D, H, fused=False)
    weights = ((D + H) * 3 * H + 3 * H + H + T) * 4
    head = (H * Dh + Dh + Dh * K + K) * 4
    xs_h0 = (B * T * D + B * H) * 4
    mr_flops = gru_work(B, T, D, H) + B * (2 * H * Dh + 2 * Dh * K + 3 * H + 2 * Dh + K)
    mr_bound, mr_by = bound_ms(mr_flops, xs_h0 + weights + head + B * K * 4)
    gru_bound, gru_by = bound_ms(gru_work(B, T, D, H), xs_h0 + weights + B * T * H * 4)
    timed = {
        "mr_step": (
            time_ms(lambda: mr_step_cuda(*ops, flow=True, block_b=bb_mr)),
            time_ms(lambda: mr_step_reference(*ops, flow=True), per_run=1),
        ),
        "gru_scan": (
            time_ms(lambda: gru_scan_cuda(*ops[:7], flow=True, block_b=bb_gru)),
            time_ms(lambda: gru_scan_reference(*ops[:7], flow=True), per_run=1),
        ),
    }
    for k, (k_ms, p_ms) in timed.items():
        log(f"[time] {k} at B={B} T={T} D={D} H={H}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    # -- 7. where a training step's time goes ------------------------------------
    p = merinda.init_mr(gen, cfg, dev)
    opt = adamw_init(p)
    for _ in range(3):
        p, opt, _ = merinda.mr_train_step(p, opt, cfg, batch, None, 3e-3, phys)
    torch.cuda.synchronize()
    n_prof = 5
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
        f"[profile] {n_prof} training steps under the profiler: {wall_ms:.2f} ms/step wall, "
        f"{n_dev:.0f} device activities/step, device busy {busy_ms:.3f} ms/step "
        f"({100 * busy_ms / wall_ms:.2f}% of the step)"
    )
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for k, v in top:
        log(f"[profile]   {sum(v) / n_prof:8.4f} ms/step  {len(v) / n_prof:6.0f}/step  {k[:90]}")

    no_library = (
        "no single PyTorch call computes it: torch.nn.GRU's candidate gate is "
        "tanh(x.Wx_c + r*(h.Wh_c)), this system's is tanh(x.Wx_c + (r*h).Wh_c)"
    )
    kernels = [
        {
            "name": "mr_step",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mr_step.cu",
            "replaces": "src/repro/kernels/mr_step/kernel.py:129",
            "launches": mr_launches,
            "max_abs_err": err["mr_step"],
            "ms": timed["mr_step"][0],
            "kernel_ms": timed["mr_step"][0],
            "plain_ms": timed["mr_step"][1],
            "bound_ms": mr_bound,
            "bound_by": mr_by,
            "library_ms": None,
            "library_note": no_library,
        },
        {
            "name": "gru_scan",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gru_scan.cu",
            "replaces": "src/repro/kernels/gru_scan/kernel.py:107",
            "launches": gru_launches,
            "max_abs_err": err["gru_scan"],
            "ms": timed["gru_scan"][0],
            "kernel_ms": timed["gru_scan"][0],
            "plain_ms": timed["gru_scan"][1],
            "bound_ms": gru_bound,
            "bound_by": gru_by,
            "library_ms": None,
            "library_note": no_library,
        },
    ]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
