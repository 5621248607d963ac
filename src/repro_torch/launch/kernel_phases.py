"""Where a warp-cell kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_phases [--baseline CSRC_DIR]

Builds the nine warp-cell kernels (``csrc/warp_cell.cuh``): ``mr_step.cu``,
``mr_step_ltc.cu``, ``mr_step_node.cu``, the bare scan ``gru_scan.cu``, the
int8/PWL stages ``mr_step_int8.cu`` and ``mr_step_ltc_int8.cu``, the int8/PWL
scan ``gru_scan_int8.cu`` and the banked ticks ``mr_tick.cu`` and
``mr_tick_int8.cu``, as they are and in
copies with one phase switched off -- the chain of steps, the h-independent
terms computed ahead of it, the head (the scan: its hs write), and for the
ticks the ingest (the ring roll and each warp's window build) and the
readout -- each with ``nvcc`` into a shared library of its own (the builds
run in parallel), and times every build's kernels with ``torch.profiler``
(the mean device time of 25 launches). The fused kernels and the scan run at
the quickstart shape (B=64, T=32, D=2, H=32, Dh=64, K=12; 6 LTC and NODE
substeps; the GRU flow gate on) and at bench_cycles' (B=64, T=200, D=8, H=64,
Dh=128), the int8 stages and scan on the same weights quantized per column
with the serving PWL tables (the standard cell); the ticks at the
serve shape (S=4 slots of N=17 windows, T=32, D=4, H=32, Dh=64, Ko=45, the
standard GRU; the int8 tick on the same weights
quantized per slot and per column, with the serving PWL tables). The time a
variant saves is its phase's cost (a variant computes on values its
switched-off phase left unset, so it checks nothing). ``mr_step_ltc`` and
``mr_step_node`` are also built with their substep loop unrolled 2 and 6
times (the kernels instantiate an unroll of 1 only), each timed and held to
the unmodified build's bits. The unmodified build
is also held against the plain versions, timed at 1, 2 and 4 windows a
block (the tiles ``kernels/mr_step/tiling.py`` chooses between; for the tick
1, 2 and 4 slots a bank) and, with ``--baseline`` (the ``csrc`` directory of
another tree with the same launchers, such as the parent commit unpacked with
``git archive``; ``mr_step``, ``mr_step_ltc``, ``mr_step_node`` and
``gru_scan`` take a slot axis since the fused and ``*_kernel`` rows' batch and
stream slice, and ``mr_step_ltc`` and ``mr_step_node`` the substep unroll since
plan analysis, so a tree from before those cannot serve for them),
timed in turns with the same kernels built from there: baseline, current,
current, baseline, and the largest difference between the two builds'
outputs on the same operands printed (0 where a change keeps the arithmetic).
``ptxas`` registers and spills of every build go to
``--out``. It needs a card and ``nvcc``, and prints the card's name and power
limit first.

The wide GRU scan (``csrc/gru_scan_wide.cu``, one batch row a cluster of 16
blocks) is also built alone with 2 and 4 rows a cluster (``WIDE_ROWS``, its
``kRows`` patched), and each build's recurrence is timed at merinda-gru's
bootstrap prefill (B=4, T=1,024, D=H=512) and at B=16 and 32, past the
clusters one card holds at once, each held to the plain version. With
``--baseline``, both of its kernels (the x.Wx + b GEMM and the recurrence)
are timed beside the baseline tree's in turns at merinda-gru's three serve
shapes (the bootstrap and admission prefills, a decode step) and at B=16 and
32, beside ``torch.addmm`` on the GEMM's operands (a yardstick the port never
calls); and the step of the baseline's recurrence as built before the
redesign (two cluster barriers and 4-byte distributed shared-memory stores a
step, its weights read from shared memory) is split by patched builds (``PARENT_SPLIT``:
the remote stores made local, the cluster barriers made block barriers, every
weight load pointed at one address), as is this tree's (``WIDE_SPLIT``: the
products, the shuffle reductions, the sigmoid and tanh each taken away, the
exchange kept), timed in cycles a step at the bootstrap prefill, beside
``cluster_probe.cu``'s latencies of a cluster barrier and of an all-to-all
16-byte ``st.async`` exchange on a cluster of 16 blocks.
``--wide-only`` skips the warp-cell kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.ltc import ltc_sub_dt
from repro_torch.core.node_mr import node_sub_dt
from repro_torch.core.quant import N_SEG, quantize_int8, serving_packs, serving_tables
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.gru_scan.ref import gru_scan_int8_reference, gru_scan_reference

SOURCES = ("mr_step.cu", "mr_step_ltc.cu", "mr_step_node.cu", "gru_scan.cu", "mr_step_int8.cu",
           "mr_step_ltc_int8.cu", "gru_scan_int8.cu", "mr_tick.cu", "mr_tick_int8.cu")
KERNELS = ("mr_step", "mr_step_ltc", "mr_step_node", "gru_scan", "mr_step_int8",
           "mr_step_ltc_int8", "gru_scan_int8")  # then the ticks
SCANS = ("gru_scan", "gru_scan_int8")  # no head: each step's h written
# launchers that take a slot axis (the operands' slot strides, then S): one call is S = 1
SLOTTED = ("mr_step", "mr_step_ltc", "mr_step_node", "gru_scan")
TICKS = ("mr_tick", "mr_tick_int8")
# (label, B, T, D, H, Dh, K)
SHAPES = [("quickstart", 64, 32, 2, 32, 64, 12), ("bench_cycles", 64, 200, 8, 64, 128, 12)]
# the tick's serve shape: S slots, buffer L, n + m inputs, chunk C, windows of T at stride
TICK = dict(S=4, L=160, n=3, m=1, C=16, T=32, stride=8, H=32, Dh=64, Ko=45, Kc=45, ema=0.9)
SUBSTEPS, DT = 6, 0.05
LAUNCHES = 25
TILES = (1, 2, 4)
TICK_SOURCES = ("mr_tick.cu", "mr_tick_int8.cu")
# a phase switched off: (source, its text, the replacement), each found exactly once
VARIANTS = {
    "no steps": [
        ("warp_cell.cuh", "for (int c = 0; c < nc; ++c) {\n    float a[2][U];",
         "for (int c = 0; c < 0; ++c) {\n    float a[2][U];"),
        ("warp_cell.cuh", "for (int c = 0; c < nc; ++c) {\n        float drive[U];",
         "for (int c = 0; c < 0; ++c) {\n        float drive[U];"),
        ("mr_step_node.cu", "for (int c = 0; c < nc; ++c) {\n        wc::substeps<UNROLL>(",
         "for (int c = 0; c < 0; ++c) {\n        wc::substeps<UNROLL>("),
    ],
    "no terms ahead": [
        ("warp_cell.cuh", "if (u >= nu) continue;\n    float a[kChunk][3];",
         "if (u >= nu || D > 0) continue;\n    float a[kChunk][3];"),
        ("warp_cell.cuh", "if (u >= nu) continue;\n        float acc[kChunk];",
         "if (u >= nu || T > 0) continue;\n        float acc[kChunk];"),
        ("mr_step_node.cu", "if (u >= nu) continue;\n        float a[kC];",
         "if (u >= nu || T > 0) continue;\n        float a[kC];"),
    ],
    "no head": [
        (src, "    wc::warp_head<N, U>(", "    if (T < 0) wc::warp_head<N, U>(")
        for src in ("mr_step_node.cu", "mr_tick.cu", "mr_tick_int8.cu")
    ] + [("warp_cell.cuh", "      warp_head<N, U>(", "      if (T < 0) warp_head<N, U>("),  # gru_windows
         ("warp_cell.cuh", "\n    warp_head<N, U>(", "\n    if (T < 0) warp_head<N, U>(")],  # ltc_windows
    "no hs write": [
        ("warp_cell.cuh", "if constexpr (HS) hs_c[", "if constexpr (HS) if (T < 0) hs_c["),
    ],
    "no ingest": [
        patch for src in TICK_SOURCES for patch in (
            (src, "if (rank == 0)\n      tick_roll(", "if (rank < 0)\n      tick_roll("),
            (src, "for (int i = lane; i < T * D; i += 32) {", "for (int i = lane; i < 0; i += 32) {"),
        )
    ],
    "no readout": [
        (src, "if (rank == 0 && threadIdx.x < 32)", "if (rank < 0 && threadIdx.x < 32)")
        for src in TICK_SOURCES
    ],
}  # fmt: skip
# the substep loop unrolled 2 or 6 times (csrc/warp_cell.cuh substeps): builds
# whose launch at unroll 1 runs the other factor, timed beside the unmodified
# build and held to its bits (the kernels instantiate 1 only, tiling.SUBSTEP_UNROLLS)
UNROLLED = ("mr_step_ltc", "mr_step_node")
UNROLL_SOURCES = ("mr_step_ltc.cu", "mr_step_node.cu")
UNROLLS = {
    f"unroll {u}": [(f"mr_step_{fam}.cu", f"case 1: return launch_{fam}<N, 1>(args...);",
                     f"case 1: return launch_{fam}<N, {u}>(args...);") for fam in ("ltc", "node")]
    for u in (2, 6)
}  # fmt: skip
# the wide scan at more batch rows a cluster than the one it is built at
WIDE_SOURCES = ("gru_scan_wide.cu",)
WIDE_ROWS = {"wide rows 1": []} | {
    f"wide rows {r}": [("gru_scan_wide.cu", "kRows = 1;", f"kRows = {r};")] for r in (2, 4)
}  # fmt: skip
WIDE_SHAPES = [(4, 1024, 512), (16, 1024, 512), (32, 1024, 512)]  # (B, T, D = H)
# merinda-gru's serve shapes: the bootstrap and admission prefills, a decode step
WIDE_SERVE = [(4, 1024, 512), (1, 1024, 512), (4, 1, 512)]
# the recurrence before the redesign (a baseline tree's csrc/gru_scan_wide.cu) with one
# cost of its step taken away, for timing only (each computes on values the change left
# wrong)
PARENT_SPLIT = {
    "parent as built": [],
    "parent local stores": [
        ("gru_scan_wide.cu", "cluster.map_shared_rank(rhrow, d)[ra * Hp + ua] = rh;",
         "rhrow[ra * Hp + ua] = rh;"),
        ("gru_scan_wide.cu", "cluster.map_shared_rank(hrow, d)[rb * Hp + ub] = h_new;",
         "hrow[rb * Hp + ub] = h_new;"),
    ],
    "parent block barriers": [
        ("gru_scan_wide.cu", "    cluster.sync();  // every r*h has arrived; every block is done "
         "reading h\n", "    __syncthreads();\n"),
        ("gru_scan_wide.cu", "    cluster.sync();  // the new h is in every block; every block is "
         "done reading r*h\n  }\n", "    __syncthreads();\n  }\n  cluster.sync();\n"),
    ],
    "parent one weight address": [
        ("gru_scan_wide.cu", "(w + cols[c] * S + p * kPass + 4 * lane)", "(w)"),
    ],
}  # fmt: skip
# the redesigned recurrence (this tree's) with one cost of its step taken away, for timing
# only; the exchange and its barriers stay as built
WIDE_SPLIT = {
    "wide no products": [
        ("gru_scan_wide.cu", "for (int p = 0; p < kPasses; ++p) {",
         "for (int p = 0; p < 0; ++p) {"),
    ],
    "wide no shuffle reductions": [  # every sum kept alive by a local add in its place
        ("gru_scan_wide.cu", "float reduce_scatter(float (&v)[NV]) {\n",
         "float reduce_scatter(float (&v)[NV]) {\n  if (NV > 0) {\n    float s = v[0];\n"
         "    for (int i = 1; i < NV; ++i) s += v[i];\n    return s;\n  }\n"),
    ],
    "wide no sigmoid or tanh": [
        ("gru_scan_wide.cu", "sigmoid(gxa + ", "(gxa + "),
        ("gru_scan_wide.cu", "tanhf(gxb + ", "(gxb + "),
    ],
}  # fmt: skip
PROBE = Path(__file__).resolve().parent / "cluster_probe.cu"
PROBE_ITERS = 20_000
# the phases each kernel has
PHASES = {k: ("no steps", "no terms ahead", "no head") for k in KERNELS}
for _scan in SCANS:
    PHASES[_scan] = ("no steps", "no terms ahead", "no hs write")
for _tick in TICKS:
    PHASES[_tick] = ("no steps", "no terms ahead", "no head", "no ingest", "no readout")


def build(
    csrc: Path, work: Path, tag: str, patches=(), sources=SOURCES
) -> tuple[ctypes.CDLL, str]:
    """``sources`` of ``csrc`` (patched) as one library; (library, ptxas log)."""
    src = work / tag
    shutil.copytree(csrc, src)
    for name, old, new in patches:
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {tag!r}: the phase is not where {name} had it")
        (src / name).write_text(text.replace(old, new))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = [subprocess.Popen([nvcc, *rt.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src / n), "-o",
                               str(src / f"{n}.o")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for n in sources]  # fmt: skip
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed on {tag}:\n" + "\n".join(logs))
    so = src / "lib.so"
    subprocess.run([nvcc, *rt.NVCC_FLAGS, "-shared", *(str(src / f"{n}.o") for n in sources),
                    "-o", str(so)], check=True, capture_output=True)  # fmt: skip
    lib = ctypes.CDLL(str(so))
    for name in (f"{Path(n).stem}_launch" for n in sources):
        getattr(lib, name).argtypes = rt.LAUNCHERS[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib, "\n".join(logs)


def _maker(device, seed):
    rng = np.random.default_rng(seed)
    return lambda *s, scale=1.0, shift=0.0: torch.from_numpy(
        (rng.standard_normal(s) * scale + shift).astype(np.float32)).to(device)  # fmt: skip


def operands(kernel, B, T, D, H, Dh, K, device, seed=0) -> list[torch.Tensor]:
    """``kernel``'s operands at initialization scale, made with numpy from a seed."""
    mk = _maker(device, seed)
    head = [mk(H, Dh, scale=H**-0.5), mk(Dh, scale=0.1), mk(Dh, K, scale=0.1 * Dh**-0.5),
            mk(K, scale=0.1)]  # fmt: skip
    if kernel == "mr_step_node":  # w_f1, b_f1, w_f2, b_f2, w_in, b_in
        cell = [mk(H, H, scale=H**-0.5), mk(H, scale=0.1), mk(H, H, scale=0.1 * H**-0.5),
                mk(H, scale=0.1), mk(D, H, scale=D**-0.5), mk(H, scale=0.1)]  # fmt: skip
    elif kernel.startswith("mr_step_ltc"):  # w_in, w_rec, bias, a, inv_tau
        cell = [mk(D, H, scale=D**-0.5), mk(H, H, scale=H**-0.5), mk(H, scale=0.1),
                mk(H, scale=0.5), mk(H, scale=0.05, shift=0.5)]  # fmt: skip
    else:  # wx, wh, b, time_scale, dts
        cell = [mk(D, 3 * H, scale=(D + H) ** -0.5), mk(H, 3 * H, scale=(D + H) ** -0.5),
                mk(3 * H, scale=0.1), mk(H, scale=0.5), torch.ones(T, device=device)]  # fmt: skip
    ops = [mk(B, T, D), mk(B, H, scale=0.1), *cell, *head]
    return int8_operands(kernel, ops) if kernel.endswith("int8") else ops


def int8_operands(kernel, ops) -> list[torch.Tensor]:
    """The int8 stage's operands of the fp32 ones: each weight matrix quantized
    per column (its int8 codes, then its scales), the vectors as they are, the
    serving PWL tables; the standard GRU reads no time_scale and no dts, the
    scan ``gru_scan_int8`` no head."""
    def q(w):
        z = quantize_int8(w)
        return z.values, z.scale.reshape(-1)

    sig, tanh = serving_packs(ops[0].device)
    if kernel == "mr_step_ltc_int8":
        xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2 = ops
        return [xs, h0, *q(w_in), *q(w_rec), bias, a, inv_tau, sig, *q(w1), b1, *q(w2), b2]
    xs, h0, wx, wh, b, _, _, w1, b1, w2, b2 = ops
    (wxq, sx), (whq, sh) = q(wx), q(wh)
    return [xs, h0, wxq, whq, sx, sh, b, sig, tanh, *q(w1), b1, *q(w2), b2]


def tick_operands(device, seed=0, int8=False) -> list[torch.Tensor]:
    """The tick's operands at the serve shape: buffers, chunks, statistics,
    the previous readout, the flags (slot S-1 inactive, every other slot
    seeding), each slot's weights, h0, then u's buffer and chunk. ``int8``:
    ``mr_tick_int8``'s, the same weights quantized per slot and per column
    (int8 codes beside their [S, cols] scales) and the serving PWL tables."""
    mk = _maker(device, seed)
    S, L, n, m, C, T, H, Dh, Ko, Kc = (TICK[k] for k in "S L n m C T H Dh Ko Kc".split())
    D, N = n + m, (L - T) // TICK["stride"] + 1
    flags = lambda xs: torch.tensor(xs, dtype=torch.float32, device=device)
    ops = [mk(S, L, n), mk(S, C, n), mk(S, n, scale=0.1), mk(S, n, scale=0.25, shift=1.0).abs(),
            mk(S, Kc, scale=0.3), flags([1.0, 0.0] * (S // 2)), flags([1.0] * (S - 1) + [0.0]),
            mk(S, D, 3 * H, scale=(D + H) ** -0.5), mk(S, H, 3 * H, scale=(D + H) ** -0.5),
            mk(S, 3 * H, scale=0.1), mk(S, H, scale=0.5), mk(S, H, Dh, scale=H**-0.5),
            mk(S, Dh, scale=0.1), mk(S, Dh, Ko, scale=0.1 * Dh**-0.5), mk(S, Ko, scale=0.1),
            torch.zeros(N, H, device=device), mk(S, L, m), mk(S, C, m)]  # fmt: skip
    if not int8:
        return ops
    wx, wh, w1, w2 = (quantize_int8(w, batch_dims=1) for w in (ops[7], ops[8], ops[11], ops[13]))
    flat = lambda q: q.scale.reshape(S, -1).contiguous()
    return [*ops[:7], wx.values, wh.values, flat(wx), flat(wh), ops[9], *serving_packs(device),
            w1.values, flat(w1), ops[12], w2.values, flat(w2), ops[14], *ops[15:]]  # fmt: skip


def launcher(lib, kernel, ops, tile: int, n_substeps: int = SUBSTEPS):
    """A launch of ``lib``'s ``kernel`` on ``ops`` into fresh outputs, as a
    closure; ``tile`` is the fused kernels' and the scan's block_b or the
    ticks' bank; ``n_substeps`` the fp32 LTC and NODE kernels' substeps."""
    if kernel in TICKS:
        S, L, n, m, C, T, H, Dh, Ko, Kc = (TICK[k] for k in "S L n m C T H Dh Ko Kc".split())
        outs = [torch.empty_like(ops[0]), torch.empty(S, Kc, device=ops[0].device),
                torch.empty(S, device=ops[0].device), torch.empty_like(ops[-2])]  # fmt: skip
        ptrs = [t.data_ptr() for t in (*ops, *outs)]
        args = (S, L, n, m, C, T, TICK["stride"], H, Dh, Ko, Kc, tile,
                N_SEG if kernel == "mr_tick_int8" else 0, TICK["ema"], 1.0 - TICK["ema"])  # fmt: skip
    elif kernel in SCANS:  # xs, h0, wx, wh, b, time_scale, dts (int8: xs, h0, wxq, whq, sx,
        # sh, b, sig, tanh) -> hs
        B, T, _ = ops[0].shape
        outs = [torch.empty(B, T, ops[1].shape[1], device=ops[0].device)]
        n_in, last = (7, 1) if kernel == "gru_scan" else (9, N_SEG)  # flow on; n_seg
        ptrs = [t.data_ptr() for t in (*ops[:n_in], *outs)]
        args = (B, T, ops[0].shape[2], ops[1].shape[1], tile, last)
    else:
        B, T, D = ops[0].shape
        H, (Dh, K) = ops[1].shape[1], ops[-3 if kernel.endswith("int8") else -2].shape
        outs = [torch.empty(B, K, device=ops[0].device)]
        ptrs = [t.data_ptr() for t in (*ops, *outs)]
        args = (B, T, D, H, Dh, K, tile)
        if kernel == "mr_step":
            args += (1, 0, -1)
        elif kernel == "mr_step_int8":
            args += (N_SEG,)
        elif kernel == "mr_step_ltc_int8":
            args += (SUBSTEPS, N_SEG, ltc_sub_dt(DT, SUBSTEPS))
        else:
            sub_dt = (ltc_sub_dt if kernel == "mr_step_ltc" else node_sub_dt)(DT, n_substeps)
            args += (n_substeps, 1, 0, -1, sub_dt)  # the substep loop not unrolled
    fn = getattr(lib, f"{kernel}_launch")
    slot = (0,) * (len(ptrs) - len(outs)) + (1,) if kernel in SLOTTED else ()

    def launch():
        err = fn(*ptrs, *slot, *args, torch.cuda.current_stream().cuda_stream)
        rt.check_launch(kernel, err)
        return outs

    return launch


def device_ms_by(launch, parts: dict[str, str], traces: int = 3) -> dict[str, float]:
    """Mean device time of LAUNCHES launches of each part (a label and a
    substring of its kernel's name, one such kernel a launch), from the
    profiler's kernel records: one launch inside the trace first (the tracer
    may miss it while it starts), then the timed ones, the last LAUNCHES of
    each part kept. The profiler can drop records: a trace that kept fewer is
    taken again with twice the launches, ``traces`` times at most."""
    launch()
    torch.cuda.synchronize()
    n = LAUNCHES
    for _ in range(traces):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            launch()
            torch.cuda.synchronize()
            for _ in range(n):
                launch()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        found = {label: sorted((e for e in kernels if pattern in e.name),
                               key=lambda e: e.time_range.start)
                 for label, pattern in parts.items()}  # fmt: skip
        kept = min(len(events) for events in found.values())
        if kept >= LAUNCHES:
            mean = lambda events: sum(e.time_range.elapsed_us() for e in events) / 1e3 / LAUNCHES
            return {label: mean(events[-LAUNCHES:]) for label, events in found.items()}
        print(f"[profile] {', '.join(parts)}: the profiler kept {kept} of {n + 1} launches; "
              f"tracing again with {2 * n}", flush=True)
        n *= 2
    raise RuntimeError(f"the profiler recorded {kept} {', '.join(parts)} kernels of {n // 2 + 1}")


def device_ms(launch, kernel: str, traces: int = 3) -> float:
    """Mean device time of ``kernel``'s LAUNCHES launches (``device_ms_by``)."""
    return device_ms_by(launch, {kernel: f"{kernel}_kernel"}, traces)[kernel]


def call_device_ms(call) -> float:
    """Mean device time of one ``call`` over LAUNCHES calls: every kernel it
    launches, whatever its name (a library call's)."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            call()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no kernel of the call")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / LAUNCHES


def ptxas_summary(log: str) -> list[str]:
    """One line a kernel: its template arguments, registers and spills."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"((?:mr|gru)_\w*?_kernel)(?:ILi(\d+)E)?(?:I?Lb([01])E)?", line)
            if m is None:
                name = line
                continue
            width = "any" if m[2] == "0" else m[2]  # 0: the generic instantiation
            args = ", ".join([f"H={width}"] * bool(width) + ["flow"] * (m[3] == "1"))
            name = f"{m[1]}<{args}>" if args else m[1]
        elif name and ("spill" in line or "registers" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def plain(kernel, ops):
    """The plain version's output on ``ops`` (the tick: theta)."""
    from repro_torch.kernels.mr_step import ref

    if kernel == "mr_step":
        return ref.mr_step_reference(*ops, flow=True)
    if kernel == "mr_step_ltc":
        return ref.mr_step_ltc_reference(*ops, dt=DT, n_substeps=SUBSTEPS)
    if kernel == "mr_step_node":
        return ref.mr_step_node_reference(*ops, dt=DT, n_substeps=SUBSTEPS)
    if kernel == "gru_scan":
        return gru_scan_reference(*ops[:7], flow=True)
    if kernel == "gru_scan_int8":
        xs, h0, wxq, whq, sx, sh, b = ops[:7]
        dts = torch.ones(xs.shape[1], device=xs.device)  # unread: the standard cell
        return gru_scan_int8_reference(xs, h0, wxq, whq, sx, sh, b, dts, *serving_tables())
    if kernel == "mr_step_int8":
        xs, h0, wxq, whq, sx, sh, b, _, _, w1q, s1, b1, w2q, s2, b2 = ops
        dts = torch.ones(xs.shape[1], device=xs.device)  # unread: the standard cell
        return ref.mr_step_int8_reference(xs, h0, wxq, whq, sx, sh, b, dts, w1q, s1, b1, w2q, s2,
                                          b2, *serving_tables())  # fmt: skip
    if kernel == "mr_step_ltc_int8":
        xs, h0, w_inq, s_in, w_recq, s_rec, bias, a, inv_tau, _, *head = ops
        return ref.mr_step_ltc_int8_reference(xs, h0, w_inq, s_in, w_recq, s_rec, bias, a, inv_tau,
                                              *head, serving_tables()[0], dt=DT,
                                              n_substeps=SUBSTEPS)  # fmt: skip
    kw = dict(window=TICK["T"], stride=TICK["stride"], ema=TICK["ema"])
    if kernel == "mr_tick_int8":
        sc = lambda s: s.reshape(TICK["S"], 1, -1)
        return ref.mr_tick_int8_reference(
            *ops[:5], ops[5] > 0, ops[6] > 0, ops[7], ops[8], sc(ops[9]), sc(ops[10]), ops[11],
            ops[14], sc(ops[15]), ops[16], ops[17], sc(ops[18]), ops[19], *serving_tables(),
            ops[21], ops[22], **kw,
        )[1]  # fmt: skip
    return ref.mr_tick_reference(
        *ops[:5], ops[5] > 0, ops[6] > 0, *ops[7:15], ops[16], ops[17], flow=False, **kw
    )[1]


def wide_operands(B, T, H, device) -> list[torch.Tensor]:
    """The wide scan's operands at D = H (flow on), made with numpy from B."""
    mk = _maker(device, B)
    w = (2 * H) ** -0.5
    return [mk(B, T, H), mk(B, H, scale=0.5), mk(H, 3 * H, scale=w), mk(H, 3 * H, scale=w),
            mk(3 * H, scale=0.1), mk(H, scale=0.3), torch.ones(T, device=device)]  # fmt: skip


def wide_launcher(lib, ops):
    """A launch of ``lib``'s wide scan on ``ops`` (flow on) into fresh outputs."""
    B, T, D = ops[0].shape
    H = ops[1].shape[1]
    dev = ops[0].device
    gx, hs = torch.empty(B, T, 3 * H, device=dev), torch.empty(B, T, H, device=dev)
    ptrs = [t.data_ptr() for t in (*ops, gx, hs)]

    def launch(fn=lib.gru_scan_wide_launch):
        stream = torch.cuda.current_stream().cuda_stream
        rt.check_launch("gru_scan_wide", fn(*ptrs, B, T, D, H, 1, stream))
        return [hs]

    return launch


WIDE_PARTS = {"gx": "gru_wide_gx", "recurrence": "gru_wide_kernel"}


def wide_report(libs, device, clock_mhz: float) -> None:
    """The wide scan built at 1, 2 and 4 rows a cluster (flow on): each build's
    distance from the plain version and its recurrence's device ms; with a
    baseline, both kernels beside the baseline's in turns at the serve shapes
    and at B = 16 and 32, and ``torch.addmm`` on the GEMM's operands."""
    for B, T, H in WIDE_SHAPES:
        ops = wide_operands(B, T, H, device)
        want = gru_scan_reference(*ops, flow=True)
        times = []
        for tag in WIDE_ROWS:
            launch = wide_launcher(libs[tag], ops)
            err = (launch()[0] - want).abs().max().item()
            times.append(f"{tag.split()[-1]}: {device_ms(launch, 'gru_wide'):.4f} ms "
                         f"(max abs {err:.3e})")  # fmt: skip
        print(f"[wide rows] gru_scan_wide at B={B} T={T} D=H={H}, the recurrence's device ms "
              f"by rows a cluster: {', '.join(times)}", flush=True)  # fmt: skip
    if "parent as built" not in libs:
        return
    for B, T, H in WIDE_SERVE + WIDE_SHAPES[1:]:
        ops = wide_operands(B, T, H, device)
        want = gru_scan_reference(*ops, flow=True)
        runs = {tag: wide_launcher(libs[lib], ops)
                for tag, lib in (("baseline", "parent as built"), ("current", "wide rows 1"))}
        errs = {tag: (run()[0] - want).abs().max().item() for tag, run in runs.items()}
        turns = [(tag, device_ms_by(runs[tag], WIDE_PARTS))
                 for tag in ("baseline", "current", "current", "baseline")]  # fmt: skip
        print(f"[wide baseline] gru_scan_wide at B={B} T={T} D=H={H} (device ms, gx + recurrence; "
              f"cycles a step at {clock_mhz:.0f} MHz): "
              + ", ".join(f"{tag} {ms['gx']:.4f} + {ms['recurrence']:.4f} "
                          f"({ms['recurrence'] * 1e3 * clock_mhz / T:.0f})" for tag, ms in turns)
              + f"; max abs from the plain version: current {errs['current']:.3e}, baseline "
              f"{errs['baseline']:.3e}", flush=True)  # fmt: skip
        if (B, T, H) in WIDE_SERVE:
            xs2d, wx, b = ops[0].reshape(B * T, H), ops[2], ops[4]
            lib_ms = call_device_ms(lambda: torch.addmm(b, xs2d, wx))
            print(f"[wide gemm] torch.addmm(b, xs, wx) at M={B * T} K={H} N={3 * H}: device "
                  f"{lib_ms:.4f} ms (a yardstick for the gx kernel; the port never calls it)",
                  flush=True)  # fmt: skip


def split_report(libs, device, clock_mhz: float, probe) -> None:
    """The baseline's recurrence (``PARENT_SPLIT``) and this tree's
    (``WIDE_SPLIT``) with each cost of its step taken away, in cycles a step at
    the bootstrap prefill, and the probes' cycles an iteration on a cluster of
    16 blocks."""
    B, T, H = WIDE_SERVE[0]
    ops = wide_operands(B, T, H, device)
    for base_tag, split in (("parent as built", PARENT_SPLIT), ("wide rows 1", WIDE_SPLIT)):
        steps = {}
        for tag in (base_tag, *split):
            if tag in steps:
                continue
            ms = device_ms(wide_launcher(libs[tag], ops), "gru_wide")
            steps[tag] = ms * 1e3 * clock_mhz / T
            print(f"[wide split] {tag} at B={B} T={T} D=H={H}: recurrence {ms:.4f} ms device, "
                  f"{steps[tag]:.0f} cycles a step at {clock_mhz:.0f} MHz", flush=True)  # fmt: skip
        print(f"[wide split] cycles a step each cost of {base_tag} takes: "
              + ", ".join(f"{tag} {steps[base_tag] - c:.0f}" for tag, c in steps.items()
                          if tag != base_tag), flush=True)  # fmt: skip
    cycles = torch.zeros(16, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    for kind, what in enumerate(("cluster.sync()", "16-byte st.async exchange, 1 warp a block",
                                 "16-byte st.async exchange, 8 warps a block",
                                 "128-byte cp.async.bulk exchange of 8 warps' values")):  # fmt: skip
        for n in (PROBE_ITERS // 10, PROBE_ITERS):  # the first a warm-up
            rt.check_launch("cluster_probe", probe.cluster_probe_launch(kind, n, cycles.data_ptr(),
                                                                        stream))  # fmt: skip
            torch.cuda.synchronize()
        per = cycles.double() / PROBE_ITERS
        print(f"[wide probe] {what} on a cluster of 16 blocks: {per.mean().item():.1f} cycles an "
              f"iteration (blocks {per.min().item():.1f}-{per.max().item():.1f}), "
              f"{PROBE_ITERS} iterations", flush=True)  # fmt: skip


def build_probe(work: Path) -> ctypes.CDLL:
    """``cluster_probe.cu`` as a library of its own."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    so = work / "cluster_probe.so"
    subprocess.run([nvcc, *rt.NVCC_FLAGS, "-shared", str(PROBE), "-o", str(so)], check=True,
                   capture_output=True)  # fmt: skip
    lib = ctypes.CDLL(str(so))
    lib.cluster_probe_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p]  # fmt: skip
    lib.cluster_probe_launch.restype = ctypes.c_int
    return lib


def report(libs, kernel, label, ops) -> None:
    """Parity, the phases, the tiles and the baseline of one kernel at one shape."""
    out = launcher(libs["current"], kernel, ops, 1)()
    got = out[1] if kernel in TICKS else out[0]
    err = (got - plain(kernel, ops)).abs().max().item()
    print(f"[parity] {kernel} at {label}: {err:.3e}", flush=True)
    tags = ("current", *PHASES[kernel])
    times = {tag: device_ms(launcher(libs[tag], kernel, ops, 1), kernel) for tag in tags}
    whole = times["current"]
    for tag, ms in times.items():
        saved = "" if tag == "current" else f", {whole - ms:+.4f} ms saved"
        print(f"[phase] {kernel} at {label}, {tag}: {ms:.4f} ms{saved}", flush=True)
    for tag in UNROLLS if kernel in UNROLLED else ():
        run = launcher(libs[tag], kernel, ops, 1)
        diff = (run()[0] - out[0]).abs().max().item()
        print(f"[unroll] {kernel} at {label}, {tag}: {device_ms(run, kernel):.4f} ms (unroll 1 "
              f"{whole:.4f} ms), max |unrolled - unroll 1| {diff:.3e}", flush=True)  # fmt: skip
    tiles = {t: device_ms(launcher(libs["current"], kernel, ops, t), kernel) for t in TILES}
    what = "slots a bank" if kernel in TICKS else "block_b"
    print(f"[tile] {kernel} at {label}: "
          + ", ".join(f"{what}={t} {ms:.4f} ms" for t, ms in tiles.items()), flush=True)
    if "baseline" in libs:
        base = launcher(libs["baseline"], kernel, ops, 1)()
        # equal infinities (the tick's inactive delta) differ by nothing
        diff = max((a - b).abs().nan_to_num(nan=0.0, posinf=float("inf")).max().item()
                   for a, b in zip(out, base))  # fmt: skip
        print(f"[baseline] {kernel} at {label}: max |current - baseline| {diff:.3e}", flush=True)
        turns = ("baseline", "current", "current", "baseline")
        ms = [(tag, device_ms(launcher(libs[tag], kernel, ops, 1), kernel)) for tag in turns]
        print(f"[baseline] {kernel} at {label}: "
              + ", ".join(f"{tag} {t:.4f} ms" for tag, t in ms), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None, help="csrc directory of another tree")
    ap.add_argument("--out", type=Path, default=rt.BUILD_DIR.parent / "kernel_phases",
                    help="ptxas logs go here")  # fmt: skip
    ap.add_argument("--wide-only", action="store_true", help="the wide scan alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: no CUDA device is visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()  # fmt: skip
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])  # fmt: skip
    print(f"[card] {smi}; max SM clock {clock_mhz:.0f} MHz; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)  # fmt: skip
    rt.pin_fp32_matmul()
    dev = torch.device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    rt.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=rt.BUILD_DIR) as tmp:
        work = Path(tmp)
        jobs = {tag: (rt.CSRC, patches, WIDE_SOURCES)
                for tag, patches in {**WIDE_ROWS, **WIDE_SPLIT}.items()}  # fmt: skip
        if not args.wide_only:
            jobs["current"] = (rt.CSRC, (), SOURCES)
            jobs.update({tag: (rt.CSRC, patches, SOURCES)
                         for tag, patches in {**VARIANTS, **UNROLLS}.items()})  # fmt: skip
        if args.baseline is not None:
            if not args.wide_only:
                jobs["baseline"] = (args.baseline, (), SOURCES)
            jobs.update({tag: (args.baseline, patches, WIDE_SOURCES)
                         for tag, patches in PARENT_SPLIT.items()})  # fmt: skip
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = {tag: pool.submit(build, csrc, work, tag.replace(" ", "_"), patches, sources)
                       for tag, (csrc, patches, sources) in jobs.items()}  # fmt: skip
            builds = {tag: f.result() for tag, f in futures.items()}
        for tag, (_, log) in builds.items():
            (args.out / f"ptxas_{tag.replace(' ', '_')}.log").write_text(log)
            for line in ptxas_summary(log):
                print(f"[ptxas {tag}] {line}", flush=True)
        libs = {tag: lib for tag, (lib, _) in builds.items()}
        if args.baseline is not None:
            split_report(libs, dev, clock_mhz, build_probe(work))
        wide_report(libs, dev, clock_mhz)
        if args.wide_only:
            return
        for label, B, T, D, H, Dh, K in SHAPES:
            shape = f"{label} (B={B} T={T} D={D} H={H} Dh={Dh} K={K})"
            for kernel in KERNELS:
                report(libs, kernel, shape, operands(kernel, B, T, D, H, Dh, K, dev))
        shape = "the serve shape (S={S} N=17 T={T} D=4 H={H} Dh={Dh} Ko={Ko})".format(**TICK)
        for kernel in TICKS:
            report(libs, kernel, shape, tick_operands(dev, int8=kernel == "mr_tick_int8"))


if __name__ == "__main__":
    main()
