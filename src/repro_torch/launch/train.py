"""LM training driver (``repro/launch/train.py``).

Wires together: the config registry -> the train step
(``parallel/steps.py``) -> the step-addressable token pipeline
(``data/pipeline.py``, ``SyntheticLM``) -> the ``Supervisor``
(``runtime/supervisor.py``: checkpoints every ``--save-every`` steps,
restart from the latest one on a failure).

On the card (the default ``--device cuda``) every Mamba2 layer's scan runs
``ssd_scan``, every attention ``flash_attention`` and every ``gru`` layer's
scan ``gru_scan``, each launched twice a step under the default remat
(``"full"``: once forward, once in the backward's recompute); the hybrid's
shared block runs once. zamba2-1.2b at its published widths and depth,
random weights from seed 0:

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --full \\
        --batch 4 --seq 1024 --steps 6 --save-every 0

and a SMOKE model with the kernels' plain versions on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 20 \\
        --batch 4 --seq 64 --device cpu

Failure drill (a failure injected before step 5; the supervisor restores the
checkpoint of step 4 and goes on):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 8 \\
        --chaos-step 5 --save-every 2 --device cpu

The supervisor resumes from any checkpoint it finds in ``--ckpt-dir``. Without
one a run checkpoints into a fresh temporary directory, removed when it ends
(a restart inside the run reads it; nothing carries to the next run); give
``--ckpt-dir`` to keep the checkpoints and resume from them. ``--save-every 0``
writes none.

One device: ``--data`` and ``--model`` above 1 are refused until the
sharded steps are ported. The ``vlm`` and ``audio`` families are refused,
as ``launch/serve.py`` refuses them: the pipeline feeds no patches or
frames (as in the JAX package).

Model-recovery mode (the paper's workload): the systems' windows recovered
as one stacked program (``core/engine.recover_many``), then each system's
largest coefficient and active terms in physical units:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --recover lorenz,damped_oscillator,controlled_pendulum --steps 300
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import tempfile
import time

import numpy as np
import torch

from repro_torch.kernels import runtime as rt


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--recover", default=None, metavar="SYS[,SYS...]",
                    help="model-recovery mode: comma-separated systems from "
                         "data/dynamics.SYSTEMS (no LM training)")  # fmt: skip
    ap.add_argument("--full", action="store_true", help="the published widths (else SMOKE)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--lr", type=float, default=None,
                    help="default 3e-4 (LM training) / 3e-3 (--recover mode)")  # fmt: skip
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints, kept and resumed from (default: a temporary "
                         "directory of this run only)")  # fmt: skip
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--chaos-step", type=int, default=0, help="simulate a failure at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def run_recover(systems: list[str], steps: int, lr: float, device: torch.device) -> int:
    """Recover every system's coefficients in one stacked program and print them."""
    from repro_torch.core import engine
    from repro_torch.core.library import denormalize_theta

    t0 = time.time()
    ys_b, us_b, norms, cfg = engine.stack_systems(systems)
    ys = torch.as_tensor(ys_b, device=device)
    us = None if us_b is None else torch.as_tensor(us_b, device=device)
    generators = engine.system_generators(0, len(systems), device)
    sampler = torch.Generator(device=device).manual_seed(0)
    thetas = engine.recover_many(cfg, ys, us, generators, sampler, steps=steps, lr=lr,
                                 batch_size=64).cpu().numpy()  # fmt: skip
    dt = time.time() - t0
    print(
        f"[recover] {len(systems)} systems x {steps} steps in {dt:.1f}s "
        f"(one stacked program; library order {cfg.order}, {cfg.n_terms} terms)"
    )
    for name, th, norm in zip(systems, thetas, norms):
        # in PHYSICAL units: spurious terms can hide in z-scored coordinates
        th_phys = denormalize_theta(th, norm["mean"], norm["scale"],
                                    n_vars=cfg.state_dim + cfg.input_dim, order=cfg.order,
                                    n_state=cfg.state_dim)  # fmt: skip
        nz = int((np.abs(th_phys) > 0.05).sum())
        print(f"  {name:22s} |theta|_max={np.abs(th_phys).max():.3f} active_terms~{nz}")
    return 0


def check_trainable(args: argparse.Namespace, cfg) -> None:
    """Raise for what this driver cannot train yet: more than one device, or a
    family whose batch needs more than the pipeline's tokens."""
    if args.data > 1 or args.model > 1:
        raise ValueError(f"train: --data {args.data} --model {args.model} needs the sharded "
                         f"steps, which are not ported yet; the port trains on one device")  # fmt: skip
    if cfg.family in ("vlm", "audio"):
        extra = "patches" if cfg.family == "vlm" else "frames"
        raise ValueError(
            f"train: {cfg.name} ({cfg.family}) needs batch[{extra!r}] beside the tokens, and the "
            f"pipeline feeds only the tokens, as the JAX launcher's does"
        )


def run(args: argparse.Namespace) -> dict:
    """Train ``args.arch`` under the supervisor: its ``run`` result
    (``history``, ``final_step``, ``restarts``, ``final_mesh``) with the
    config and the seconds beside it."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM, to_device_batch
    from repro_torch.parallel.steps import init_train_state, make_train_step
    from repro_torch.runtime import SimulatedFailure, Supervisor
    from repro_torch.runtime.elastic import plan_mesh, visible_devices
    from repro_torch.runtime.supervisor import SupervisorConfig

    device = rt.resolve_device(args.device, "train")
    cfg = get_config(args.arch, smoke=not args.full)
    check_trainable(args, cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    pipe = SyntheticLM(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))  # fmt: skip
    lr = args.lr if args.lr is not None else 3e-4

    def build_step(mesh):
        where = mesh.devices[0]
        step_fn = make_train_step(cfg, shape, where, lr=lr)

        def init_state():
            return init_train_state(torch.Generator(device=where).manual_seed(0), cfg, where)

        def run_step(state, batch):
            state, metrics = step_fn(state, to_device_batch(batch, where))
            # the step's time ends with its metrics read back
            return state, {k: float(v) for k, v in metrics.items()}

        return run_step, where, init_state  # a restore puts every leaf on the device

    def next_batch(step, mesh):
        return pipe.batch_at(step)

    chaos = None
    if args.chaos_step:
        fired = {"done": False}

        def chaos(step):
            if step == args.chaos_step and not fired["done"]:
                fired["done"] = True
                raise SimulatedFailure(n_lost=len(visible_devices()) // 2)

    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_"))
        sup = Supervisor(build_step, next_batch, ckpt_dir,
                         SupervisorConfig(max_steps=args.steps, save_every=args.save_every),
                         chaos=chaos, devices=[device])  # fmt: skip
        t0 = time.time()
        result = sup.run(plan_mesh(1, model=args.model, max_data=args.data))
    return dict(result, cfg=cfg, seconds=time.time() - t0)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.recover:
        systems = [s.strip() for s in args.recover.split(",") if s.strip()]
        device = rt.resolve_device(args.device, "train")
        return run_recover(systems, args.steps, args.lr if args.lr is not None else 3e-3, device)

    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    result = run(args)
    losses = [h["loss"] for h in result["history"] if np.isfinite(h["loss"])]
    print(
        f"[train] arch={args.arch} steps={result['final_step']} "
        f"restarts={result['restarts']} mesh={result['final_mesh']} "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f} ({result['seconds']:.0f}s)"
    )
    for h in result["history"][:: max(1, args.log_every)]:
        print(f"  step {h['step']:4d} mesh={h['mesh']} loss={h['loss']:.4f} {h['t']*1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
