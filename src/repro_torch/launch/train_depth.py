"""How far a float32 training step carries a rounding-sized difference, by depth, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train_depth [--depths 6,12,24,38]
        [--batch 4] [--seq 1024] [--out FILE]

zamba2-1.2b at its published widths in float32: the training launcher's
random weights (seed 0, drawn in bf16 and cast, as ``chip_smoke.py``'s
``[train f32]`` phase takes them), cut to the first L Mamba2 layers for each L
of ``--depths`` (the hybrid's shared block applied after every
``attn_period`` of them), and the launcher's first batch (``SyntheticLM``,
step 0). At each depth, one forward and backward of ``train_loss`` three
times:

- through the kernels (``ssd_scan`` and ``flash_attention`` forwards; every
  backward is the plain version's);
- through the plain versions (``force_reference``);
- through the plain versions again, every parameter multiplied by
  (1 + e·u), u uniform in [-1, 1] (seed 1), e = 2^-24: a change the size of
  one float32 rounding, made by no kernel.

It prints, at each depth, the loss's relative gap and each gradient leaf's
max |difference| over the plain run's largest |g| (the worst leaf, the
median leaf), kernels against plain and perturbed plain against plain, and
writes every leaf's gaps to ``--out`` (JSON). Where the second column is as
large as the first, the plain path itself carries a rounding-sized change of
its inputs as far as it carries the kernels' rounding: the step's
conditioning at that depth, not a kernel's error. It needs a card and
``nvcc``, prints the card's name and power limit first, and checks that each
kernel run launched ``ssd_scan`` twice a layer and ``flash_attention`` once a
shared-block application (remat "full").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import runtime as rt

PERTURB = 2.0**-24  # one float32 rounding, relative


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The paths of a nested dict's leaves in ``tree_leaves`` order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over b's largest magnitude."""
    scale, gap = b.abs().max().item(), (a - b).abs().max().item()
    return gap / scale if scale else (0.0 if gap == 0 else float("inf"))


def loss_and_grads(params, batch, cfg, force_reference: bool):
    """(loss, gradients in ``tree_leaves`` order) of ``train_loss``."""
    from repro_torch.models import model as lm
    from repro_torch.tree import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm.train_loss(tree_unflatten(params, leaves), batch, cfg, force_reference)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), [g.detach() for g in grads]


def perturbed(params, seed: int = 1):
    """Every leaf times (1 + PERTURB * u), u uniform in [-1, 1]."""
    from repro_torch.tree import tree_map

    gen = None

    def one(t):
        nonlocal gen
        gen = gen or torch.Generator(device=t.device).manual_seed(seed)
        u = torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype) * 2 - 1
        return t * (1 + PERTURB * u)

    return tree_map(one, params)


def depth_gaps(params, batch, cfg) -> dict:
    """The three runs at ``cfg.num_layers``: the gaps, the op calls."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.models import model as lm

    counters = {"ssd_scan": ssd_scan_cuda, "flash_attention": flash_attention_cuda}
    for fn in counters.values():
        fn.launches = 0
    loss_k, g_k = loss_and_grads(params, batch, cfg, False)
    calls = {k: fn.launches for k, fn in counters.items()}
    want = {"ssd_scan": 2 * cfg.num_layers, "flash_attention": lm.shared_applications(cfg)}
    if calls != want:
        raise RuntimeError(f"{cfg.num_layers} layers launched {calls}, expected {want}")
    loss_r, g_r = loss_and_grads(params, batch, cfg, True)
    kernels = [rel_gap(a, b) for a, b in zip(g_k, g_r)]
    del g_k
    loss_p, g_p = loss_and_grads(perturbed(params), batch, cfg, True)
    perturb = [rel_gap(a, b) for a, b in zip(g_p, g_r)]
    paths = leaf_paths(params)
    return dict(
        layers=cfg.num_layers, calls=calls, loss=loss_r,
        loss_gap_kernels=abs(loss_k - loss_r) / abs(loss_r),
        loss_gap_perturbed=abs(loss_p - loss_r) / abs(loss_r),
        grad_max={p: g.abs().max().item() for p, g in zip(paths, g_r)},
        kernels=dict(zip(paths, kernels)), perturbed=dict(zip(paths, perturb)),
    )  # fmt: skip


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--depths", default="6,12,24,38")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", default="chiprun_out/train_depth.json")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM, to_device_batch
    from repro_torch.models import model as lm
    from repro_torch.tree import tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()  # fmt: skip
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    rt.build_library()
    rt.load_library()
    rt.pin_fp32_matmul()
    print(f"[env] kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    cfg = get_config("zamba2-1.2b")
    full = tree_map(lambda t: t.float(), lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pipe = SyntheticLM(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))  # fmt: skip
    batch = to_device_batch(pipe.batch_at(0), dev)
    rows = []
    for n in (int(d) for d in args.depths.split(",")):
        t0 = time.perf_counter()
        params = {k: tree_map(lambda t: t[:n], v) if k == "layers" else v for k, v in full.items()}
        cut = dataclasses.replace(cfg32, num_layers=n)
        r = depth_gaps(params, batch, cut)
        torch.cuda.empty_cache()
        wk, wp = (max(r[c], key=r[c].get) for c in ("kernels", "perturbed"))
        print(
            f"[depth] {n} layers ({lm.shared_applications(cut)} shared-block applications), "
            f"B={args.batch} S={args.seq}, {time.perf_counter() - t0:.1f} s: "
            f"loss {r['loss']:.6f}, gap kernels {r['loss_gap_kernels']:.3e}, perturbed "
            f"{r['loss_gap_perturbed']:.3e}; gradient leaves, max |difference| over the leaf's "
            f"largest: kernels worst {r['kernels'][wk]:.3e} ({wk}), median "
            f"{statistics.median(r['kernels'].values()):.3e}; perturbed worst "
            f"{r['perturbed'][wp]:.3e} ({wp}), median {statistics.median(r['perturbed'].values()):.3e}",
            flush=True,
        )  # fmt: skip
        for p in sorted(r["kernels"], key=lambda p: -r["kernels"][p]):
            print(f"[depth]   {n:2d} {p:32s} kernels {r['kernels'][p]:.3e}  perturbed "
                  f"{r['perturbed'][p]:.3e}  max|g| {r['grad_max'][p]:.3e}", flush=True)  # fmt: skip
        rows.append(r)
    out = dict(device=smi, batch=args.batch, seq=args.seq, perturb=PERTURB, depths=rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[done] {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
