"""Training supervisor: checkpoint/restart and elastic re-mesh on failure (``repro/runtime/supervisor.py``).

The supervisor owns the train loop. Each step it:
  1. runs the step function on the current mesh,
  2. beats the heartbeat registry and polls the straggler detector,
  3. checkpoints every ``save_every`` steps (async, atomic:
     ``checkpoint/checkpoint.py``).

On a failure (a ``SimulatedFailure`` injected by a chaos hook) it
  a. waits for any in-flight checkpoint write, then
  b. re-plans the mesh on the surviving devices (``runtime/elastic.py``, the
     data axis shrinks first),
  c. rebuilds the step function for the new mesh,
  d. restores the latest checkpoint onto the new mesh's devices,
  e. resumes from the restored step.

``SimulatedFailure`` is the only exception it absorbs; any other propagates.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import MeshPlan, build_mesh, plan_mesh, visible_devices
from repro_torch.runtime.heartbeat import HeartbeatRegistry, StragglerDetector

log = logging.getLogger("repro_torch.supervisor")


class SimulatedFailure(Exception):
    """Raised by chaos hooks to emulate a device or host loss."""

    def __init__(self, n_lost: int = 1):
        self.n_lost = n_lost
        super().__init__(f"simulated loss of {n_lost} device(s)")


@dataclasses.dataclass
class SupervisorConfig:
    max_steps: int = 1000
    save_every: int = 50
    keep: int = 3
    max_restarts: int = 8


class Supervisor:
    """Drives (build_step, init_state) through failures.

    build_step(mesh) -> (step_fn, state_shardings, init_state_fn)
        step_fn(state, batch) -> (state, metrics); built for the mesh (a
        :class:`~repro_torch.runtime.elastic.SlotMesh`). ``state_shardings``
        is where a restore puts the leaves (a device; None: each leaf's
        ``init_state`` device).
    next_batch(step, mesh) -> batch (step-addressable, so a restart re-reads
        the right batch).
    chaos(step) -> None or raises SimulatedFailure.
    ``devices`` defaults to every visible CUDA device.
    """

    def __init__(
        self,
        build_step: Callable,
        next_batch: Callable,
        ckpt_dir: str,
        cfg: SupervisorConfig | None = None,
        chaos: Callable[[int], None] | None = None,
        devices: list | None = None,
    ):
        self.build_step = build_step
        self.next_batch = next_batch
        self.cfg = cfg = cfg if cfg is not None else SupervisorConfig()
        self.chaos = chaos
        devices = visible_devices() if devices is None else devices
        self.devices = [torch.device(d) for d in devices]
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep, save_every=cfg.save_every)
        self.registry = HeartbeatRegistry()
        self.stragglers = StragglerDetector(self.registry)
        self.restarts = 0
        self.history: list[dict] = []

    def _make(self, plan: MeshPlan):
        mesh = build_mesh(plan, self.devices)
        step_fn, shardings, init_state = self.build_step(mesh)
        return mesh, step_fn, shardings, init_state

    def run(self, initial_plan: MeshPlan | None = None) -> dict:
        plan = initial_plan or plan_mesh(len(self.devices))
        mesh, step_fn, shardings, init_state = self._make(plan)
        state = init_state()
        step = 0

        # resume if a checkpoint exists (a restart from scratch)
        restored, manifest = self.ckpt.restore_latest(state, shardings)
        if restored is not None:
            state, step = restored, manifest["step"] + 1
            log.info("resumed from step %d", manifest["step"])

        while step < self.cfg.max_steps:
            try:
                if self.chaos is not None:
                    self.chaos(step)
                t0 = time.time()
                batch = self.next_batch(step, mesh)
                state, metrics = step_fn(state, batch)
                dt = time.time() - t0
                self.registry.beat("host0", step, dt)
                flagged = self.stragglers.check()
                if flagged:
                    log.warning("stragglers at step %d: %s", step, flagged)
                self.ckpt.maybe_save(step, state, mesh)
                self.history.append(
                    {"step": step, "mesh": plan.shape, "t": dt,
                     "loss": float(metrics.get("loss", float("nan")))}
                )  # fmt: skip
                step += 1
            except SimulatedFailure as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                log.warning("failure at step %d (%s); re-meshing", step, e)
                self.ckpt.wait()
                # surviving devices: drop from the tail (a lost host's devices)
                self.devices = self.devices[: len(self.devices) - e.n_lost]
                plan = plan_mesh(
                    len(self.devices),
                    model=plan.shape[-1],
                    max_data=plan.shape[-2] if len(plan.shape) >= 2 else 1,
                    pods=plan.shape[0] if len(plan.shape) == 3 else 1,
                )
                mesh, step_fn, shardings, init_state = self._make(plan)
                state = init_state()
                restored, manifest = self.ckpt.restore_latest(state, shardings)
                if restored is not None:
                    state, step = restored, manifest["step"] + 1
                else:  # failed before the first checkpoint
                    state, step = init_state(), 0

        self.ckpt.wait()
        return {
            "final_step": step,
            "restarts": self.restarts,
            "final_mesh": plan.shape,
            "history": self.history,
        }
