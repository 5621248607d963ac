"""Serving resilience: service snapshots and the supervised restart (``repro/runtime/resilience.py``).

- :class:`ServiceCheckpointer`: every ``period`` ticks, stage the whole
  service image (the SlotState, the device-resident ControlState, the
  warm-start LRU, the tick counter, the tick's random generator and any
  caller extras, in the JAX package's [S, ...] and [M, ...] layouts) and
  hand it to ``CheckpointManager`` for an async, atomic, CRC-checked write.
  Restore splits every slot leaf over the restoring service's shards, each
  part on its shard's device, so a snapshot written on a slot mesh of 2
  restores onto the shrunken mesh of 1 (reshard-on-restore); it rewinds
  ``service.ticks`` and the generator, so a restore onto the same mesh
  replays the snapshot's trajectory exactly (``tests/test_torch_checkpoint.py``
  and ``tests/test_torch_resilience.py`` pin it bit for bit).
- :class:`ServiceSupervisor`: owns the serve loop. On a shard failure (a
  :class:`~repro_torch.runtime.supervisor.SimulatedFailure` from a chaos
  hook, the only exception it absorbs) it waits out the in-flight snapshot
  write, drops the lost devices, re-plans the slot mesh on the survivors
  (``plan_mesh_slots``), compiles the plan again, restores the latest
  snapshot onto the new mesh and re-submits every stream the restored image
  does not hold: no stream is lost, at worst one replays the ticks since
  the snapshot.

The ControlState is restored only when the shard count is unchanged (its
leaves are [shards, ...]); on a re-mesh the queues restart empty and the
supervisor re-submits the queued streams. The layout is the JAX package's:
a snapshot either one writes, the other restores (a JAX snapshot has no
generator leaf; the service then keeps its own).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import _flatten, _logical_view, restore_checkpoint
from repro_torch.runtime.elastic import plan_mesh_slots, visible_devices
from repro_torch.runtime.supervisor import SimulatedFailure
from repro_torch.tree import tree_leaves, tree_unflatten

log = logging.getLogger("repro_torch.resilience")


class ServiceCheckpointer:
    """Periodic async snapshots of a RecoveryService, and their restore.

    Attached by ``RecoveryPlan.make_service`` when the TickSpec carries
    ``checkpoint_period`` and ``checkpoint_dir``; ``RecoveryService.tick_once``
    calls :meth:`after_tick` every tick (nothing happens off the period).

    ``extra`` is a host-side dict of arrays snapshotted with the service
    image (a driver's stream cursors, say).
    """

    def __init__(self, root: str, period: int, keep: int = 3):
        self.period = int(period)
        self.manager = CheckpointManager(root, keep=keep, save_every=self.period)
        self.extra: dict[str, np.ndarray] = {}

    # -- save ---------------------------------------------------------------
    def _stage(self, service) -> dict:
        tree: dict[str, Any] = {"slots": service.state, "ticks": np.int64(service.ticks)}
        control = service.control  # a concatenation of the shards' rows at M > 1
        if control is not None:
            tree["control"] = control
        # the warm-start LRU: one params subtree an entry and the LRU order, so
        # a restored service serves the same warm hits
        tree["warm"] = {str(sid): params for sid, params in service.warm.items()}
        tree["warm_order"] = np.asarray(list(service.warm.keys()), np.int64)
        tree["generator"] = service.generator.get_state().numpy()
        for k, v in self.extra.items():
            tree[f"extra/{k}"] = np.asarray(v)
        return tree

    def after_tick(self, service):
        """Snapshot when the tick counter reaches the period, else nothing:
        a steady tick pays nothing, keeping the zero-readback ticks."""
        if self.period <= 0 or service.ticks % self.period:
            return
        self.save(service)

    def save(self, service):
        """Stage device -> host now (one counted sync), write async."""
        tree = self._stage(service)
        service.counters["host_syncs"] += 1
        self.manager.maybe_save(service.ticks, tree, mesh=service.mesh, force=True)

    def wait(self):
        self.manager.wait()

    # -- restore ------------------------------------------------------------
    def restore_into(self, service) -> dict | None:
        """Restore the latest snapshot into a FRESH service, every slot (and
        control) leaf split over the service's shards, each part on its
        shard's device; counted in ``service.counters["reshards"]``.

        Returns ``{"step", "resident", "queued", "extra"}`` (None when no
        snapshot exists). The ControlState is taken only when every leaf's
        shape matches the service's (the same shards and capacities);
        otherwise the queues restart empty and ``queued`` is what the caller
        must submit again.
        """
        self.manager.wait()
        step = self.manager.latest()
        if step is None:
            return None
        d = pathlib.Path(self.manager.root) / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = manifest["leaves"]

        like: dict[str, Any] = {"slots": service.state}
        take_control = False
        control = service.control  # a concatenation of the shards' rows at M > 1
        if control is not None:
            take_control = all(
                f"control/{k}" in leaves and leaves[f"control/{k}"]["shape"] == list(v.shape)
                for k, v in _flatten(control)
            )
            if take_control:
                like["control"] = control
        expect_axes = ("slots",) if service.mesh is not None else None
        restored, _ = restore_checkpoint(self.manager.root, step, like, service.devices,
                                         expect_axes=expect_axes)  # fmt: skip
        parts = restored if isinstance(restored, list) else [restored]
        service.shards = [part["slots"] for part in parts]
        if take_control:
            service.controls = [part["control"] for part in parts]
        service.counters["reshards"] += 1
        service.ticks = int(np.load(d / leaves["ticks"]["file"]))
        if "generator" in leaves:
            service.generator.set_state(torch.from_numpy(np.load(d / leaves["generator"]["file"])))

        self._restore_warm(service, d, leaves)
        extra = {
            k[len("extra/") :]: np.load(d / meta["file"])
            for k, meta in leaves.items()
            if k.startswith("extra/")
        }
        resident, queued = self._rebuild_views(service, take_control)
        log.info(
            "restored service snapshot step=%d (%d resident, %d queued, control=%s)",
            step, len(resident), len(queued), "restored" if take_control else "reset",
        )  # fmt: skip
        return {"step": step, "resident": resident, "queued": queued, "extra": extra}

    def _restore_warm(self, service, d: pathlib.Path, leaves: dict):
        from repro_torch.core.stream import cold_start

        order_meta = leaves.get("warm_order")
        if order_meta is None:
            return
        warm_order = [int(s) for s in np.load(d / order_meta["file"])]
        if not warm_order:
            return
        template, _ = cold_start(service.seed, 0, service.cfg, service.device)
        tpaths = _flatten(template)
        for sid in warm_order:
            vals = []
            for pkey, _leaf in tpaths:
                meta = leaves.get(f"warm/{sid}/{pkey}")
                if meta is None:
                    vals = None
                    break
                arr = np.load(d / meta["file"])
                vals.append(_logical_view(arr, meta["dtype"]).to(service.device))
            if vals is not None:
                service.warm[sid] = tree_unflatten(template, vals)
        while len(service.warm) > service.warm_capacity:
            service.warm.popitem(last=False)

    @staticmethod
    def _rebuild_views(service, take_control: bool) -> tuple[set[int], set[int]]:
        """Refresh the host-side views from the restored image (counted
        readbacks at restore time; the running service never repeats them)."""
        read = lambda field: service._host_gather([getattr(st, field) for st in service.shards])
        sid_view = read("stream_id")
        service._active_view = read("active").astype(bool)
        service._slot_view = sid_view.astype(np.int64)
        service._delta_view = read("delta")
        service._loss_view = read("loss")
        service._steps_view = read("steps").astype(np.int64)
        resident = {int(i) for i in sid_view if i >= 0}
        queued: set[int] = set()
        if service.control_plane is not None:
            service._inflight = [set() for _ in range(service.control_plane.shards)]
            if take_control:
                q_ids = service._host_gather([ctl.q_ids for ctl in service.controls])
                for row, ids in enumerate(q_ids):
                    for sid in ids:
                        if sid >= 0:
                            service._inflight[row].add(int(sid))
                            queued.add(int(sid))
            service._pending = resident | queued
            service._seen_done = set()
            service._ticks_since_snapshot = 0
        return resident, queued


def replan_spec(spec, n_available: int):
    """Shrink a stream RecoverySpec's slot mesh onto ``n_available`` devices
    (the largest divisor of n_slots that fits, ``plan_mesh_slots``)."""
    plan = plan_mesh_slots(n_available, spec.n_slots)
    return dataclasses.replace(spec, mesh_slots=plan.shape[0])


def kill_shard_once(at_tick: int, n_lost: int = 1) -> Callable[[int], None]:
    """Chaos hook: lose ``n_lost`` device(s) at the first tick >= at_tick
    (fires exactly once; the supervisor's restart must absorb it)."""
    state = {"fired": False}

    def chaos(tick: int):
        if not state["fired"] and tick >= at_tick:
            state["fired"] = True
            raise SimulatedFailure(n_lost)

    return chaos


class ServiceSupervisor:
    """Drives a streaming RecoverySpec through shard failures.

    Owns the serve loop (the chunk routing of ``launch/serve_mr.run_service``)
    and the restart path: on a :class:`SimulatedFailure` it re-plans the slot
    mesh on the surviving devices, compiles the plan again, restores the
    latest service snapshot onto the new mesh and re-submits any stream the
    restored image dropped. ``chaos(tick)`` may raise SimulatedFailure.

    ``devices`` is the mesh's device list (default: every visible card); a
    device may repeat (``["cpu", "cpu"]``: a mesh of 2 on the CPU), and the
    lost devices drop from its tail. ``audit`` and ``tune`` go to every
    ``compile_plan`` (the restored plan is audited and tuned as the first).
    """

    def __init__(
        self,
        spec,
        ckpt_dir: str,
        checkpoint_period: int = 4,
        max_restarts: int = 4,
        chaos: Callable[[int], None] | None = None,
        devices: list | None = None,
        keep: int = 3,
        audit: str = "off",
        tune: str = "off",
    ):
        if spec.mode != "stream":
            raise ValueError(f"ServiceSupervisor serves stream plans, got mode={spec.mode!r}")
        self.base_spec = spec
        self.ckpt_dir = str(ckpt_dir)
        self.checkpoint_period = int(checkpoint_period)
        self.max_restarts = int(max_restarts)
        self.chaos = chaos
        devices = visible_devices() if devices is None else devices
        self.devices = [torch.device(d) for d in devices]
        self.keep = keep
        self.plan_kw = dict(audit=audit, tune=tune)
        self.restarts = 0
        self.history: list[dict] = []  # per-incarnation stats
        self.restore_ms: list[float] = []  # wall ms of each restart (re-plan to re-submit)
        self.spec = self.plan = self.service = None
        self._compile(len(self.devices))

    def _compile(self, n_available: int):
        from repro_torch.api.plan import compile_plan

        spec = replan_spec(self.base_spec, n_available)
        tspec = dataclasses.replace(
            spec.tick_spec(),
            checkpoint_period=self.checkpoint_period,
            checkpoint_dir=self.ckpt_dir,
        )
        self.spec = spec = dataclasses.replace(spec, tick=tspec)
        self.plan = compile_plan(spec, devices=self.devices, **self.plan_kw)
        self.service = self.plan.make_service()
        if self.service.checkpointer is not None:
            self.service.checkpointer.manager.keep = self.keep  # snapshots retained
        return self.service

    def _incarnation_stats(self) -> dict:
        """An incarnation's counters, taken while its service is alive.
        ``service_bytes`` is what its shards and control rows hold; a restart
        adds ``device_bytes_freed`` on the card, what its allocator gave back
        when the failed incarnation was dropped, so a lost shard whose tensors
        stayed alive would show."""
        svc = self.service
        return {
            "ticks": svc.ticks,
            "tick_ms": list(svc.tick_ms),
            "counters": dict(svc.counters),
            "sync_log": list(svc.sync_log),
            "mesh_shape": tuple(self.plan.lowering.mesh_shape),
            "service_bytes": sum(t.numel() * t.element_size()
                                 for t in tree_leaves((svc.shards, svc.controls))),
        }  # fmt: skip

    def serve(self, ys: np.ndarray, us: np.ndarray | None = None, max_ticks: int = 400) -> dict:
        """Feed every stream through the service until all recover (or the
        tick budget runs out), absorbing injected shard failures.

        ys [R, T_total, n] / us [R, T_total, m]; cursors wrap modulo T_total
        (a slow or replayed stream never starves). Returns the summary dict
        (results, recovered_streams_fraction, restarts, tick latencies).
        """
        svc = self.service
        n_streams, t_total = ys.shape[:2]
        if us is None:
            us = np.zeros(ys.shape[:2] + (svc.cfg.input_dim,), np.float32)
        L = svc.scfg.buf_len
        results: dict[int, Any] = {}
        cursors = {i: L for i in range(n_streams)}
        for i in range(n_streams):
            svc.submit(i, ys[i, :L], us[i, :L])
        svc.fill_slots()
        total_ticks = 0
        while len(results) < n_streams and total_ticks < max_ticks:
            try:
                if self.chaos is not None:
                    self.chaos(total_ticks)
                svc = self.service
                slots, chunk = svc.n_slots, svc.scfg.chunk
                chunks_y = np.zeros((slots, chunk, svc.cfg.state_dim), np.float32)
                chunks_u = np.zeros((slots, chunk, svc.cfg.input_dim), np.float32)
                for s, sid in enumerate(svc.slot_streams()):
                    if sid < 0:
                        continue
                    idx = (cursors[sid] + np.arange(chunk)) % t_total
                    chunks_y[s] = ys[sid, idx]
                    chunks_u[s] = us[sid, idx]
                    cursors[sid] += chunk
                if svc.checkpointer is not None:
                    # stamp the cursors BEFORE the tick: a snapshot taken inside
                    # tick_once then restores a consistent (state, cursor) pair
                    svc.checkpointer.extra["cursors"] = np.asarray(
                        [cursors[i] for i in range(n_streams)], np.int64
                    )
                svc.tick_once(chunks_y, chunks_u)
                total_ticks += 1
                results.update(svc.results)
            except SimulatedFailure as e:
                results.update(self.service.results)
                svc = None  # the failed incarnation goes in _recover, with its shards
                self._recover(e, ys, us, cursors, results, t_total)
        if self.service.checkpointer is not None:
            self.service.checkpointer.wait()  # no write outlives the call
        self.history.append(self._incarnation_stats())
        results.update(self.service.results)
        all_ms = [t for h in self.history for t in h["tick_ms"]]
        return {
            "results": results,
            "ticks": total_ticks,
            "restarts": self.restarts,
            "recovered_streams_fraction": len(results) / max(n_streams, 1),
            "p50_tick_ms": float(np.percentile(all_ms, 50)) if all_ms else 0.0,
            "p99_tick_ms": float(np.percentile(all_ms, 99)) if all_ms else 0.0,
            "straggler_flags": list(self.service.straggler_flags),
            "final_mesh": tuple(self.plan.lowering.mesh_shape),
            "restore_ms": list(self.restore_ms),
            "counters": {
                k: sum(h["counters"][k] for h in self.history) for k in ("host_syncs", "reshards")
            },
        }

    def _recover(self, e: SimulatedFailure, ys, us, cursors, results, t_total: int):
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError("restart budget exhausted") from e
        if e.n_lost >= len(self.devices):
            raise RuntimeError("no surviving devices") from e
        t0 = time.perf_counter()
        old = self.service
        if old.checkpointer is not None:
            old.checkpointer.wait()  # never restore a torn in-flight write
        stats = self._incarnation_stats()
        self.history.append(stats)
        log.warning("shard failure (%s); re-meshing on survivors", e)
        # surviving devices: drop from the tail (the lost shard's devices); the
        # failed incarnation goes with its shards, so their memory is freed
        self.devices = self.devices[: len(self.devices) - e.n_lost]
        device, on_card = old.device, old.device.type == "cuda"
        before = torch.cuda.memory_allocated(device) if on_card else 0
        self.service = old = None
        if on_card:
            stats["device_bytes_freed"] = before - torch.cuda.memory_allocated(device)
        svc = self._compile(len(self.devices))
        info = svc.checkpointer.restore_into(svc) if svc.checkpointer is not None else None
        safe: set[int] = set()
        if info is not None:
            safe = info["resident"] | info["queued"]
            saved = info["extra"].get("cursors")
            if saved is not None:
                for i in range(min(len(cursors), len(saved))):
                    cursors[i] = int(saved[i])
        else:
            # failed before the first snapshot: every stream restarts from its
            # initial history
            for i in cursors:
                cursors[i] = svc.scfg.buf_len
        L = svc.scfg.buf_len
        for sid in sorted(cursors):
            if sid in results or sid in svc.results or sid in safe:
                continue
            idx = (cursors[sid] - L + np.arange(L)) % t_total
            svc.submit(sid, ys[sid, idx], us[sid, idx])
        svc.fill_slots()
        self.restore_ms.append((time.perf_counter() - t0) * 1e3)
