"""Where a warp-cell kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_phases [--baseline CSRC_DIR]

Builds ``csrc/mr_step.cu`` and ``csrc/mr_step_node.cu`` (``csrc/warp_cell.cuh``)
as they are and in copies with one phase switched off -- the chain of steps,
the h-independent terms computed ahead of it, the head -- each with ``nvcc``
into a shared library of its own, and times every build's two kernels with
``torch.profiler`` (the mean device time of 25 launches) at the quickstart
shape (B=64, T=32, D=2, H=32, Dh=64, K=12; 6 NODE substeps) and at
bench_cycles' (B=64, T=200, D=8, H=64, Dh=128). The time a variant saves is
its phase's cost (a variant computes on values its switched-off phase left
unset, so it checks nothing). The unmodified build is also held against the
plain versions, timed at 1, 2 and 4 windows a block (the tiles
``kernels/mr_step/tiling.py`` chooses between) and, with ``--baseline`` (the
``csrc`` directory of another tree, such as the parent commit unpacked with
``git archive``), timed in turns with the same kernels built from there:
baseline, current, current, baseline. ``ptxas`` registers and spills of every
build go to ``--out``. It needs a card and ``nvcc``, and prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.node_mr import node_sub_dt
from repro_torch.kernels import runtime as rt

SOURCES = ("mr_step.cu", "mr_step_node.cu")
# (label, B, T, D, H, Dh, K)
SHAPES = [("quickstart", 64, 32, 2, 32, 64, 12), ("bench_cycles", 64, 200, 8, 64, 128, 12)]
SUBSTEPS, DT = 6, 0.05
LAUNCHES = 25
TILES = (1, 2, 4)
# a phase switched off: (source text, its replacement), each found exactly once
VARIANTS = {
    "no steps": [
        ("for (int c = 0; c < nc; ++c) {\n        float a[2][U];",
         "for (int c = 0; c < 0; ++c) {\n        float a[2][U];"),
        ("for (int c = 0; c < nc; ++c) {\n        for (int s = 0;",
         "for (int c = 0; c < 0; ++c) {\n        for (int s = 0;"),
    ],
    "no terms ahead": [
        ("if (u >= nu) continue;\n        float a[kC][3];",
         "if (u >= nu || T > 0) continue;\n        float a[kC][3];"),
        ("if (u >= nu) continue;\n        float a[kC];",
         "if (u >= nu || T > 0) continue;\n        float a[kC];"),
    ],
    "no head": [("    wc::warp_head<N, U>(", "    if (T < 0) wc::warp_head<N, U>(")] * 2,
}  # fmt: skip


def build(csrc: Path, work: Path, tag: str, patches=()) -> tuple[ctypes.CDLL, str]:
    """The two sources of ``csrc`` (patched) as one library; (library, ptxas log)."""
    src = work / tag
    shutil.copytree(csrc, src)
    for (old, new), name in zip(patches, SOURCES):
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {tag!r}: the phase is not where {name} was")
        (src / name).write_text(text.replace(old, new))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = [subprocess.Popen([nvcc, *rt.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src / n), "-o",
                               str(src / f"{n}.o")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for n in SOURCES]  # fmt: skip
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed on {tag}:\n" + "\n".join(logs))
    so = src / "lib.so"
    subprocess.run([nvcc, *rt.NVCC_FLAGS, "-shared", *(str(src / f"{n}.o") for n in SOURCES),
                    "-o", str(so)], check=True, capture_output=True)  # fmt: skip
    lib = ctypes.CDLL(str(so))
    for name in ("mr_step_launch", "mr_step_node_launch"):
        getattr(lib, name).argtypes = rt.LAUNCHERS[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib, "\n".join(logs)


def operands(B, T, D, H, Dh, K, node: bool, device, seed=0) -> list[torch.Tensor]:
    """mr_step (or, ``node``, mr_step_node) operands at initialization scale."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(device)  # fmt: skip
    head = [mk(H, Dh, scale=H**-0.5), mk(Dh, scale=0.1), mk(Dh, K, scale=0.1 * Dh**-0.5),
            mk(K, scale=0.1)]  # fmt: skip
    if node:  # w_f1, b_f1, w_f2, b_f2, w_in, b_in
        cell = [mk(H, H, scale=H**-0.5), mk(H, scale=0.1), mk(H, H, scale=0.1 * H**-0.5),
                mk(H, scale=0.1), mk(D, H, scale=D**-0.5), mk(H, scale=0.1)]  # fmt: skip
    else:  # wx, wh, b, time_scale, dts
        cell = [mk(D, 3 * H, scale=(D + H) ** -0.5), mk(H, 3 * H, scale=(D + H) ** -0.5),
                mk(3 * H, scale=0.1), mk(H, scale=0.5), torch.ones(T, device=device)]  # fmt: skip
    return [mk(B, T, D), mk(B, H, scale=0.1), *cell, *head]


def launcher(lib, ops, node: bool, block_b: int):
    """A launch of ``lib``'s kernel on ``ops`` into a fresh output, as a closure."""
    B, T, D = ops[0].shape
    H, (Dh, K) = ops[1].shape[1], ops[-2].shape
    out = torch.empty(B, K, device=ops[0].device)
    ptrs = [t.data_ptr() for t in (*ops, out)]

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        if node:
            err = lib.mr_step_node_launch(*ptrs, B, T, D, H, Dh, K, block_b, SUBSTEPS, 0, -1,
                                          node_sub_dt(DT, SUBSTEPS), stream)  # fmt: skip
        else:
            err = lib.mr_step_launch(*ptrs, B, T, D, H, Dh, K, block_b, 1, 0, -1, stream)
        rt.check_launch("mr_step_node" if node else "mr_step", err)
        return out

    return launch


def device_ms(launch) -> float:
    """Mean device time of LAUNCHES launches, from the profiler's kernel records."""
    launch()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            launch()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "mr_step" in e.name]  # fmt: skip
    if not times:
        raise RuntimeError("the profiler recorded no kernel")
    return sum(times) / len(times)


def ptxas_summary(log: str) -> list[str]:
    """One line a kernel: its template arguments, registers and spills."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(mr_step\w*?_kernel)ILi(\d+)E(?:Lb([01])E)?", line)
            width = "any" if m and m[2] == "0" else m and m[2]  # 0: the generic instantiation
            name = f"{m[1]}<H={width}{', flow' if m[3] == '1' else ''}>" if m else line
        elif name and ("spill" in line or "registers" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None, help="csrc directory of another tree")
    ap.add_argument("--out", type=Path, default=rt.BUILD_DIR.parent / "kernel_phases",
                    help="ptxas logs go here")  # fmt: skip
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: no CUDA device is visible")
    from repro_torch.kernels.mr_step.ref import mr_step_node_reference, mr_step_reference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()  # fmt: skip
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    rt.pin_fp32_matmul()
    dev = torch.device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    rt.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=rt.BUILD_DIR) as tmp:
        work = Path(tmp)
        builds = {"current": build(rt.CSRC, work, "current")}
        for tag, patches in VARIANTS.items():
            builds[tag] = build(rt.CSRC, work, tag.replace(" ", "_"), patches)
        if args.baseline is not None:
            builds["baseline"] = build(args.baseline, work, "baseline")
        for tag, (_, log) in builds.items():
            (args.out / f"ptxas_{tag.replace(' ', '_')}.log").write_text(log)
            for line in ptxas_summary(log):
                print(f"[ptxas {tag}] {line}", flush=True)
        libs = {tag: lib for tag, (lib, _) in builds.items()}
        for label, B, T, D, H, Dh, K in SHAPES:
            shape = f"{label} (B={B} T={T} D={D} H={H} Dh={Dh} K={K})"
            for node in (False, True):
                kernel = "mr_step_node" if node else "mr_step"
                ops = operands(B, T, D, H, Dh, K, node, dev)
                out = launcher(libs["current"], ops, node, 1)()
                if node:
                    want = mr_step_node_reference(*ops, dt=DT, n_substeps=SUBSTEPS)
                else:
                    want = mr_step_reference(*ops, flow=True)
                print(f"[parity] {kernel} at {shape}: {(out - want).abs().max().item():.3e}")
                times = {tag: device_ms(launcher(lib, ops, node, 1))
                         for tag, lib in libs.items() if tag != "baseline"}  # fmt: skip
                whole = times["current"]
                for tag, ms in times.items():
                    saved = "" if tag == "current" else f", {whole - ms:+.4f} ms saved"
                    print(f"[phase] {kernel} at {label}, {tag}: {ms:.4f} ms{saved}", flush=True)
                tiles = {bb: device_ms(launcher(libs["current"], ops, node, bb)) for bb in TILES}
                print(f"[tile] {kernel} at {label}: "
                      + ", ".join(f"block_b={bb} {ms:.4f} ms" for bb, ms in tiles.items()))
                if "baseline" in libs:
                    turns = [("baseline", libs["baseline"]), ("current", libs["current"]),
                             ("current", libs["current"]), ("baseline", libs["baseline"])]  # fmt: skip
                    ms = [(tag, device_ms(launcher(lib, ops, node, 1))) for tag, lib in turns]
                    print(f"[baseline] {kernel} at {label}: "
                          + ", ".join(f"{tag} {t:.4f} ms" for tag, t in ms), flush=True)


if __name__ == "__main__":
    main()
