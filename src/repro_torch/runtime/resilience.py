"""Serving resilience: periodic service snapshots (``repro/runtime/resilience.py``).

:class:`ServiceCheckpointer`: every ``period`` ticks, stage the whole
service image (the SlotState, the device-resident ControlState, the
warm-start LRU, the tick counter, the tick's random generator and any caller
extras) and hand it to ``CheckpointManager`` for an async, atomic,
CRC-checked write. Restore puts every leaf back on the service's device, and
rewinds ``service.ticks`` and the generator, so a restored service replays
the snapshot's trajectory exactly (``tests/test_torch_checkpoint.py`` pins
the SlotState and ControlState bit for bit and the continuation ticks).

The layout is the JAX package's: a snapshot either one writes, the other
restores (a JAX snapshot has no generator leaf; the service then keeps its
own). The supervised restart loop (``ServiceSupervisor``) is not ported.
"""

from __future__ import annotations

import json
import logging
import pathlib
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import _flatten, _logical_view, restore_checkpoint
from repro_torch.tree import tree_unflatten

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
        if service.control is not None:
            tree["control"] = service.control
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
        self.manager.maybe_save(service.ticks, tree, force=True)

    def wait(self):
        self.manager.wait()

    # -- restore ------------------------------------------------------------
    def restore_into(self, service) -> dict | None:
        """Restore the latest snapshot into a FRESH service on its device.

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
        if service.control is not None:
            take_control = all(
                f"control/{k}" in leaves and leaves[f"control/{k}"]["shape"] == list(v.shape)
                for k, v in _flatten(service.control)
            )
            if take_control:
                like["control"] = service.control
        restored, _ = restore_checkpoint(self.manager.root, step, like, device=service.device)
        service.state = restored["slots"]
        if take_control:
            service.control = restored["control"]
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
        st = service.state
        sid_view = service._host_read(st.stream_id)
        service._active_view = service._host_read(st.active).astype(bool)
        service._slot_view = sid_view.astype(np.int64)
        service._delta_view = service._host_read(st.delta)
        service._loss_view = service._host_read(st.loss)
        service._steps_view = service._host_read(st.steps).astype(np.int64)
        resident = {int(i) for i in sid_view if i >= 0}
        queued: set[int] = set()
        if service.control_plane is not None:
            service._inflight = [set() for _ in range(service.control_plane.shards)]
            if take_control:
                for row, ids in enumerate(service._host_read(service.control.q_ids)):
                    for sid in ids:
                        if sid >= 0:
                            service._inflight[row].add(int(sid))
                            queued.add(int(sid))
            service._pending = resident | queued
            service._seen_done = set()
            service._ticks_since_snapshot = 0
        return resident, queued
