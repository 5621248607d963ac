"""Elastic mesh planning: the largest healthy mesh after failures (``repro/runtime/elastic.py``).

Policy: shrink the DATA axis first. The model (tensor-parallel) degree is
dictated by the per-layer weight shapes, and changing it reshapes every
program, while the data-parallel width only rescales throughput. Pods drop
next (a whole pod lost); the model axis is kept unless fewer than ``model``
devices survive.

``plan_mesh``, ``plan_mesh_slots`` and ``shrink_plan`` are pure;
``build_mesh`` materializes a plan over a list of ``torch.device``s as a
:class:`SlotMesh`. The port places every tensor explicitly, so a mesh is the
devices and their axis names, nothing more: the service keeps shard ``i``'s
slots on ``mesh.devices[i]``. Devices may repeat (``serve_mr
--virtual-devices N`` lists the one card N times), which is how a mesh of 2
runs on one card or on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """Devices laid out over named axes: the slot mesh (``("slots",)``, shard
    ``i`` on ``devices[i]``), or a training plan's ``(data, model)`` mesh.
    ``devices`` is flat, in row-major order over ``shape``."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...] = ("slots",)

    @property
    def size(self) -> int:
        return len(self.devices)


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_mesh(
    n_available: int,
    model: int = 16,
    max_data: int = 16,
    pods: int = 1,
) -> MeshPlan:
    """Largest (pod, data, model) mesh fitting n_available devices.

    data is kept a power of two (the global batch stays divisible and the
    collectives ring-friendly); model is kept if at all possible.
    """
    if n_available < 1:
        raise ValueError("no devices")
    model_eff = model
    while model_eff > n_available:
        model_eff //= 2
    per_pod_target = max_data * model_eff
    pods_eff = max(1, min(pods, n_available // per_pod_target))
    data = _pow2_floor(max(1, n_available // (pods_eff * model_eff)))
    data = min(data, max_data)
    if pods_eff > 1:
        return MeshPlan((pods_eff, data, model_eff), ("pod", "data", "model"))
    return MeshPlan((data, model_eff), ("data", "model"))


def plan_mesh_slots(n_available: int, n_slots: int) -> MeshPlan:
    """Largest 1-D ``("slots",)`` mesh fitting n_available devices.

    The serving mesh shards the slot axis, so the device count must divide
    ``n_slots`` (every shard holds the same number of slots). Picks the
    largest divisor of n_slots that fits; after a shard failure the service
    restores onto this plan (``runtime/resilience.py``).
    """
    if n_available < 1:
        raise ValueError("no devices")
    if n_slots < 1:
        raise ValueError("no slots")
    d = min(n_available, n_slots)
    while n_slots % d:
        d -= 1
    return MeshPlan((d,), ("slots",))


def shrink_plan(current: MeshPlan, n_failed: int) -> MeshPlan:
    """Re-plan after n_failed devices drop out of the current mesh."""
    return plan_mesh(
        current.n_devices - n_failed,
        model=current.shape[-1],
        max_data=current.shape[-2],
        pods=current.shape[0] if len(current.shape) == 3 else 1,
    )


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device (empty when none is)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(plan: MeshPlan, devices=None) -> SlotMesh:
    """The first ``plan.n_devices`` of ``devices`` (default: every visible
    CUDA device) laid out as ``plan``; raises when the plan needs more."""
    devices = visible_devices() if devices is None else [torch.device(d) for d in devices]
    n = plan.n_devices
    if n > len(devices):
        raise ValueError(f"plan needs {n} devices, have {len(devices)}")
    return SlotMesh(tuple(devices[:n]), tuple(plan.shape), tuple(plan.axes))
