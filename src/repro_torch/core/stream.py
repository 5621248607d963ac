"""Slot-based streaming recovery service (counterpart of ``repro/core/stream.py``).

A fleet of dynamical-system streams shares S service slots:

- every slot holds one stream's ring buffer, its MERINDA parameters and its
  optimizer state, all in ONE ``SlotState`` whose every leaf has a leading
  slot axis;
- every tick rolls a fresh observation chunk into each slot's buffer,
  re-windows it with the normalization frozen at admission, runs K
  optimizer steps of every slot at once (``engine.stacked_train_step``; a
  fused or ``*_kernel`` row launches its kernel's slot-axis form once a
  step for all slots),
  and reads out each slot's coefficients (EMA-smoothed) with their
  tick-over-tick relative delta;
- a slot whose delta falls below ``delta_tol`` (after ``min_steps``), or
  that reaches ``max_steps``, is evicted and refilled from the queue; its
  parameters go to a bounded warm-start registry.

Two tick structures, as in the JAX package: ``tick`` (composite: the readout
is plain PyTorch ops) and ``tick_banked`` (the readout, ring ingest included,
is one launch of the ``mr_tick`` kernel, and the per-slot status comes back
packed in one [S, 4] array). Their training segments are the same code, so
their parameters agree bit for bit.

``RecoveryService`` runs one of two control planes, counting every
device-to-host readback (``counters``, ``sync_log``):

- the host plane (the JAX package's reference plane): a priority queue,
  admission, eviction, preemption of cold slots and the warm LRU, moving
  O(slots) scalars across the host boundary a tick;
- the device plane (``control=``, a ``core/control.ControlPlane``): the
  queues, the eviction mask, the refill and the warm-start lookup run on the
  card inside ``control.tick_device``, and the host reads the packed status
  and the event log back only every ``snapshot_period`` ticks.

With a slot mesh (``mesh=``, a ``runtime/elastic.SlotMesh`` of M devices
built by ``compile_plan`` from ``RecoverySpec.mesh_slots``), the service holds
one ``SlotState`` a shard (leaves [S/M, ...]) on that shard's device, and on
the device plane the shard's ``ControlState`` row ([1, ...]); slot ``s``
belongs to shard ``s // (S/M)``. Every tick runs the tick program once a
shard on that shard's rows, and no operation reads across shards (the JAX
package's rule R5, which XLA keeps there by sharding; here the placement is
explicit). ``state`` and ``control`` show the JAX package's [S, ...] and
[M, ...] layouts. At M = 1 the service is the one-device path, bit for bit.

A ``ServiceCheckpointer`` (``runtime/resilience.py``), when attached,
snapshots the service every ``checkpoint_period`` ticks.

Under ``precision="int8_pwl"`` (``quant=True``) every eviction reads the
stream's coefficients out through the fixed-point fused stage
(``readout_theta(..., quant=True)``: ``mr_step_int8``) on the slot's current
windows, and a pure serve tick (K = 0) of ``tick_banked`` runs the int8 twin
of ``mr_tick``.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import functools
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import encoders
from repro_torch.core.engine import (
    WARMUP_STEPS,
    gather_windows,
    seeded_generator,
    stacked_theta,
    stacked_train_step,
)
from repro_torch.core.merinda import MRConfig, MRParams, init_mr, mr_forward
from repro_torch.data.windows import buffer_stats, n_buffer_windows, roll_buffer, window_views
from repro_torch.kernels.mr_step.tick import mr_tick
from repro_torch.kernels.runtime import resolve_device
from repro_torch.optim import adamw_init
from repro_torch.runtime.heartbeat import HeartbeatRegistry, StragglerDetector
from repro_torch.tree import (
    tree_index,
    tree_leaves,
    tree_map,
    tree_stack,
    tree_unflatten,
    tree_write_slot,
)

PRIORITY_LIMIT = 1 << 16  # admission tiers are [0, PRIORITY_LIMIT), as in core/control.py


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static service configuration."""

    buf_len: int = 160  # ring-buffer length L (observations per slot)
    window: int = 32  # T: window length fed to the encoder
    stride: int = 8  # window stride over the buffer
    chunk: int = 16  # C: new observations ingested per tick
    steps_per_tick: int = 8  # K: optimizer steps per slot per tick (0 = serve-only)
    lr: float = 3e-3
    batch_size: int | None = None  # windows per step (None = all N windows)
    ema: float = 0.9  # smoothing for the per-tick Theta readout
    delta_tol: float = 0.015  # relative coefficient-delta eviction threshold
    min_steps: int = 128  # no eviction before this many optimizer steps
    max_steps: int = 400  # unconditional eviction budget per stream

    def __post_init__(self):
        if self.window > self.buf_len:
            raise ValueError(f"window {self.window} exceeds buf_len {self.buf_len}")
        if self.chunk > self.buf_len:
            # the roll would grow the buffer past buf_len
            raise ValueError(f"chunk {self.chunk} exceeds buf_len {self.buf_len}")
        if self.stride < 1 or self.chunk < 1:
            raise ValueError("stride and chunk must be >= 1")
        if self.steps_per_tick < 0:
            raise ValueError("steps_per_tick must be >= 0")

    @property
    def n_windows(self) -> int:
        return n_buffer_windows(self.buf_len, self.window, self.stride)


class SlotState(NamedTuple):
    """One tree for all S slots (every leaf has leading axis S)."""

    params: Any  # MRParams, leaves [S, ...]
    opt: Any  # AdamWState, leaves [S, ...] (step [S])
    buf_y: torch.Tensor  # [S, L, n] raw observations (ring buffer)
    buf_u: torch.Tensor  # [S, L, m] exogenous inputs (m may be 0)
    theta: torch.Tensor  # [S, n_terms, n] last readout (normalized coords)
    delta: torch.Tensor  # [S] relative theta change at the last tick
    loss: torch.Tensor  # [S] last-step reconstruction MSE
    mean: torch.Tensor  # [S, n] normalization stats FROZEN at admission
    scale: torch.Tensor  # [S, n]
    steps: torch.Tensor  # [S] int32 optimizer steps since admission
    active: torch.Tensor  # [S] bool
    stream_id: torch.Tensor  # [S] int32 (-1 = empty slot)


def shard_slots(state: Any, mesh) -> list:
    """Split every leaf's leading axis (a SlotState's slot axis, a
    ControlState's shard axis) over ``mesh`` (``("slots",)``, M devices): part
    ``i`` (rows [i * S/M, (i + 1) * S/M)) on ``mesh.devices[i]``, each its own
    copy, so a dropped shard frees its memory. Without a mesh the one part
    is ``state`` itself."""
    if mesh is None:
        return [state]
    P = tree_leaves(state)[0].shape[0] // mesh.size
    return [tree_map(lambda leaf: leaf[i * P : (i + 1) * P].to(d, copy=True), state)
            for i, d in enumerate(mesh.devices)]  # fmt: skip


def gather_slots(shards: list, device) -> Any:
    """The shards' trees concatenated along the slot axis on ``device`` (the
    JAX package's [S, ...] layout); one shard is returned as it is."""
    if len(shards) == 1:
        return shards[0]
    columns = zip(*(tree_leaves(t) for t in shards))
    return tree_unflatten(shards[0], [torch.cat([x.to(device) for x in col]) for col in columns])


def cold_start(seed: int, stream_id: int, cfg: MRConfig, device) -> tuple[MRParams, Any]:
    """Fresh (params, opt_state) for one admission, drawn from the generator of
    (seed, 1000 + stream_id), as the JAX service folds its key."""
    params = init_mr(seeded_generator(seed, 1000 + stream_id, device=device), cfg, device)
    return params, adamw_init(params)


def init_slots(seed: int, cfg: MRConfig, scfg: StreamConfig, n_slots: int, device) -> SlotState:
    """All-empty service state: per-slot fresh params, inactive slots."""
    per_slot = [init_mr(seeded_generator(seed, i, device=device), cfg, device)
                for i in range(n_slots)]  # fmt: skip
    n, m = cfg.state_dim, cfg.input_dim
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return SlotState(
        params=tree_stack(per_slot),
        opt=tree_stack([adamw_init(p) for p in per_slot]),
        buf_y=torch.zeros((n_slots, scfg.buf_len, n), **f32),
        buf_u=torch.zeros((n_slots, scfg.buf_len, m), **f32),
        theta=torch.zeros((n_slots, cfg.n_terms, n), **f32),
        delta=torch.full((n_slots,), float("inf"), **f32),
        loss=torch.full((n_slots,), float("inf"), **f32),
        mean=torch.zeros((n_slots, n), **f32),
        scale=torch.ones((n_slots, n), **f32),
        steps=torch.zeros((n_slots,), **i32),
        active=torch.zeros((n_slots,), dtype=torch.bool, device=device),
        stream_id=torch.full((n_slots,), -1, **i32),
    )


@torch.no_grad()
def admit(state: SlotState, slot: int, stream_id: int, buf_y, buf_u, params, opt) -> SlotState:
    """Admit one stream into ``slot``, in place.

    The normalization stats come from the admission history and stay FROZEN
    for the stream's lifetime: re-estimating them as the buffer slides would
    move the coefficient basis under the optimizer every tick.
    """
    dev = state.buf_y.device
    buf_y = torch.as_tensor(buf_y, dtype=torch.float32, device=dev)
    mean, scale = buffer_stats(buf_y)
    tree_write_slot(state.params, slot, params)
    tree_write_slot(state.opt, slot, opt)
    state.buf_y[slot] = buf_y
    state.buf_u[slot] = torch.as_tensor(buf_u, dtype=torch.float32, device=dev)
    state.theta[slot] = 0.0
    state.delta[slot] = float("inf")
    state.loss[slot] = float("inf")
    state.mean[slot] = mean[0]
    state.scale[slot] = scale[0]
    state.steps[slot] = 0
    state.active[slot] = True
    state.stream_id[slot] = stream_id
    return state


@torch.no_grad()
def deactivate(state: SlotState, slot: int) -> SlotState:
    """Mark a slot empty (no queued stream to admit), in place."""
    state.active[slot] = False
    state.stream_id[slot] = -1
    return state


def _slot_windows(buf_y, buf_u, mean, scale, scfg: StreamConfig):
    """Normalize buffers [..., L, n] with their frozen stats [..., n] and
    window them: ([..., N, T, n], [..., N, T, m])."""
    yw = window_views((buf_y - mean.unsqueeze(-2)) / scale.unsqueeze(-2), scfg.window, scfg.stride)
    return yw, window_views(buf_u, scfg.window, scfg.stride)


def _recover_steps(params, opt, yw, uw, batch_idx, steps0, *, cfg: MRConfig, scfg: StreamConfig):
    """K optimizer steps of every slot on its windows yw [S, N, T, n].

    The learning rate warms up linearly, then decays as the inverse square
    root of each slot's own step count: the decay lets the readout settle so
    the delta can fall below ``delta_tol``. Returns (params, opt, recon [S])
    with recon the last step's reconstruction MSE.

    ``batch_idx`` holds step j's minibatch window indices [S, bs] at
    ``batch_idx[j]`` (``scfg.batch_size``; ``RecoveryService._tick_batch_idx``
    draws them), or is None: every step trains on all windows.
    """
    uw = uw if cfg.input_dim else None
    recon = None
    for j in range(scfg.steps_per_tick):
        yb, ub = yw, uw
        if batch_idx is not None:
            yb, ub = gather_windows(yw, batch_idx[j]), gather_windows(uw, batch_idx[j])
        frac = ((steps0 + j).to(torch.float32) + 1.0) / WARMUP_STEPS
        lr_t = scfg.lr * torch.minimum(frac, torch.rsqrt(frac))
        params, opt, aux = stacked_train_step(params, opt, cfg, yb, ub, lr_t)
        recon = aux["recon_mse"]
    return params, opt, recon


def _ema_delta(state: SlotState, theta: torch.Tensor, ema: float):
    """EMA-smoothed readout and its relative delta (``inf`` for an inactive
    slot). A fresh slot (step 0, delta still inf) seeds the EMA directly."""
    seed = (state.steps == 0) & torch.isinf(state.delta)
    theta = torch.where(seed[:, None, None], theta, ema * state.theta + (1.0 - ema) * theta)
    change = (theta - state.theta).abs().amax(dim=(1, 2))
    delta = change / (theta.abs().amax(dim=(1, 2)) + 1e-3)
    return theta, torch.where(state.active, delta, torch.full_like(delta, float("inf")))


def _masked_loss(state: SlotState, recon: torch.Tensor) -> torch.Tensor:
    return torch.where(state.active, recon, torch.full_like(recon, float("inf")))


def tick(
    state: SlotState,
    new_y: torch.Tensor,  # [S, C, n] fresh observations (zeros for idle slots)
    new_u: torch.Tensor,  # [S, C, m]
    batch_idx: torch.Tensor | None,  # [K, S, bs] minibatch windows, or None: all
    *,
    cfg: MRConfig,
    scfg: StreamConfig,
) -> SlotState:
    """Composite tick: ingest, K recovery steps and the readout, for ALL slots."""
    buf_y = roll_buffer(state.buf_y, new_y)
    buf_u = roll_buffer(state.buf_u, new_u)
    yw, uw = _slot_windows(buf_y, buf_u, state.mean, state.scale, scfg)
    uw_in = uw if cfg.input_dim else None
    if scfg.steps_per_tick:
        params, opt, recon = _recover_steps(
            state.params, state.opt, yw, uw, batch_idx, state.steps, cfg=cfg, scfg=scfg
        )
        loss = _masked_loss(state, recon)
    else:
        # serve/monitor tick: no optimizer steps, readout only
        params, opt, loss = state.params, state.opt, state.loss
    theta, delta = _ema_delta(state, stacked_theta(params, cfg, yw, uw_in), scfg.ema)
    return state._replace(
        params=params,
        opt=opt,
        buf_y=buf_y,
        buf_u=buf_u,
        theta=theta,
        delta=delta,
        loss=loss,
        steps=state.steps + scfg.steps_per_tick,
    )


def pack_status(state: SlotState) -> torch.Tensor:
    """The per-slot eviction scalars ``[delta, loss, steps, active]`` packed
    into ONE [S, 4] array, so a whole status costs one host readback."""
    return torch.stack(
        [state.delta, state.loss, state.steps.to(torch.float32), state.active.to(torch.float32)],
        dim=-1,
    )


def tick_banked(
    state: SlotState,
    new_y: torch.Tensor,  # [S, C, n]
    new_u: torch.Tensor,  # [S, C, m]
    batch_idx: torch.Tensor | None,  # [K, S, bs] minibatch windows, or None: all
    *,
    cfg: MRConfig,
    scfg: StreamConfig,
    quant: bool = False,
    slots_per_bank: int = 1,
) -> tuple[SlotState, torch.Tensor]:
    """Banked tick: ``tick``'s contract, plus the packed status [S, 4].

    The training segment (K > 0) is the composite tick's code; the serving
    segment (ring ingest, window scan, head, EMA readout, delta) is one
    ``mr_tick`` launch on the card (its plain version on the CPU). ``quant``
    serves it through the int8/PWL twin (the K = 0 monitor tick).
    """
    if scfg.steps_per_tick:
        buf_y = roll_buffer(state.buf_y, new_y)
        buf_u = roll_buffer(state.buf_u, new_u)
        yw, uw = _slot_windows(buf_y, buf_u, state.mean, state.scale, scfg)
        params, opt, recon = _recover_steps(
            state.params, state.opt, yw, uw, batch_idx, state.steps, cfg=cfg, scfg=scfg
        )
        loss = _masked_loss(state, recon)
    else:
        params, opt, loss = state.params, state.opt, state.loss
    seed = (state.steps == 0) & torch.isinf(state.delta)
    buf_y, buf_u, theta, delta = mr_tick(
        params, cfg, scfg, state.buf_y, state.buf_u, new_y, new_u, state.mean, state.scale,
        state.theta, seed, state.active, quant=quant, slots_per_bank=slots_per_bank,
    )  # fmt: skip
    state = state._replace(
        params=params,
        opt=opt,
        buf_y=buf_y,
        buf_u=buf_u,
        theta=theta,
        delta=delta,
        loss=loss,
        steps=state.steps + scfg.steps_per_tick,
    )
    return state, pack_status(state)


@torch.no_grad()
def readout_theta(
    params: MRParams,
    cfg: MRConfig,
    yw: torch.Tensor,  # [N, T, n] normalized windows
    uw: torch.Tensor | None = None,
    quant: bool = False,
) -> torch.Tensor:
    """Serving readout: the mean over windows of Theta (normalized coords).

    fp32 runs ``mr_forward``; ``quant=True`` the fixed-point fused stage
    (``mr_step_int8``: int8 cell and head weights, PWL activations), which
    needs an int8-capable encoder ('gru', 'gru_kernel' or 'ltc').
    """
    if not quant:
        theta, _ = mr_forward(params, cfg, yw, uw)
        return theta.mean(dim=0)
    from repro_torch.kernels.mr_step.ops import mr_step_int8

    xs = yw if uw is None or uw.shape[-1] == 0 else torch.cat([yw, uw], dim=-1)
    theta, _ = mr_step_int8(params, cfg, xs)
    return theta.mean(dim=0)


class StreamResult(NamedTuple):
    """Host-side record for one completed stream."""

    stream_id: int
    theta: np.ndarray  # [n_terms, n] normalized coordinates
    mean: np.ndarray  # [n] buffer stats for denormalization
    scale: np.ndarray  # [n]
    steps: int
    reason: str  # "converged" | "budget"


class SubmitStatus(enum.Enum):
    """What ``submit`` did, a typed backpressure signal.

    ENQUEUED: queued (the host deque, or a device queue) and admitted as
    capacity frees. OVERFLOW: every device queue was full; the stream waits
    in the bounded host overflow queue and moves into a device queue at the
    next snapshot or fill with room. REJECTED: the overflow queue is full as
    well; nothing was kept and the caller must retry. ``submit`` never raises
    on pressure.
    """

    ENQUEUED = "enqueued"
    OVERFLOW = "overflow"
    REJECTED = "rejected"


class SubmitResult(NamedTuple):
    """What ``submit`` did with one stream (see :class:`SubmitStatus`)."""

    status: SubmitStatus
    stream_id: int
    shard: int | None = None  # device ring the stream landed in (device plane)

    @property
    def accepted(self) -> bool:
        return self.status is not SubmitStatus.REJECTED


class RecoveryService:
    """The service: admission queue, eviction policy, warm-start registry.

    All numerics run in the tick program (``tick`` or ``tick_banked``, bound
    by the plan). ``counters["host_syncs"]`` counts every device-to-host
    readback and ``sync_log`` holds each tick's count;
    ``counters["reshards"]`` counts the restores that placed a snapshot onto
    the service's shards (``ServiceCheckpointer.restore_into``).

    Two control planes (``control=``, a ``core/control.ControlPlane`` built by
    the plan, selects the device one):

    - **host**: admission pops a deque, the eviction scan reads the per-slot
      status back each tick (the banked tick's packed status once; the
      composite tick delta, steps, active and loss separately) and each
      eviction reads the evicted slot's record.
    - **device**: the queue, the eviction mask, the refill and the warm-start
      lookup run on the card (``control.tick_device``); the host only
      enqueues arrivals and drains the packed status and the event log every
      ``snapshot_period`` ticks (two readbacks). A tick between arrivals and
      snapshots reads nothing back: host-to-device copies are made from
      pinned memory without waiting, so no tick waits for the card.

    ``mesh`` (a ``runtime/elastic.SlotMesh``) shards the slots over its
    devices: the tick program runs once a shard, and a readback of a leaf of
    every shard copies each into one pinned host buffer without waiting,
    then waits once (one sync, as the JAX package counts a sharded
    readback). The device plane's ``control.shards`` must equal the mesh's
    size.

    ``device=None`` is the card (raising when none is visible); the CPU runs
    only when the caller passes ``device="cpu"`` (or a mesh of CPU devices).
    ``quant`` reads every evicted stream out through ``mr_step_int8``
    (``precision="int8_pwl"``).
    """

    def __init__(
        self,
        cfg: MRConfig,
        scfg: StreamConfig,
        n_slots: int,
        seed: int = 0,
        device: torch.device | str | None = None,
        tick_program=None,
        warm_capacity: int = 32,
        quant: bool = False,
        control=None,
        overflow_capacity: int = 16,
        mesh=None,
    ):
        encoders.validate_config(cfg)
        self.cfg, self.scfg, self.n_slots = cfg, scfg, n_slots
        self.seed = seed
        self.quant = quant
        self.mesh = mesh
        where = mesh.devices if mesh is not None else (device,)
        self.devices = [resolve_device(d, "RecoveryService") for d in where]
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        if n_slots % self.n_shards:
            raise ValueError(f"n_slots ({n_slots}) must divide over {self.n_shards} shard(s)")
        self.slots_per_shard = n_slots // self.n_shards
        self.counters = {"host_syncs": 0, "reshards": 0}
        self.sync_log: list[int] = []
        self._tick = tick_program or functools.partial(tick, cfg=cfg, scfg=scfg)
        # minibatch indices of every tick (scfg.batch_size); a spawn path of
        # its own, apart from the slots' (i,) and the cold starts' (1000 + id,)
        self.generator = seeded_generator(seed, 0, 0, device=self.device)
        self.shards = shard_slots(init_slots(seed, cfg, scfg, n_slots, self.device), mesh)
        # host admission queue: (stream_id, buf_y, buf_u, priority) entries;
        # pops take the highest tier first, FIFO within a tier (_queue_pop)
        self.queue: collections.deque = collections.deque()
        # bounded LRU warm-start registry (stream_id -> evicted params)
        self.warm: collections.OrderedDict[int, MRParams] = collections.OrderedDict()
        self.warm_capacity = int(warm_capacity)
        self.results: dict[int, StreamResult] = {}
        self.ticks = 0
        # host-side view of the per-slot status, refreshed wherever the status
        # is read anyway, so `done` and `drain()` never force a readback
        self._active_view = np.zeros((n_slots,), bool)
        self._slot_view = np.full((n_slots,), -1, np.int64)
        self._delta_view = np.full((n_slots,), np.inf, np.float32)
        self._loss_view = np.full((n_slots,), np.inf, np.float32)
        self._steps_view = np.zeros((n_slots,), np.int64)
        self._prio_view = np.zeros((n_slots,), np.int64)  # tier per slot
        self._prio_of: dict[int, int] = {}  # stream_id -> submitted tier
        self._undrained: list[StreamResult] = []
        # per-tick wall latency (ms) and one heartbeat a shard and tick for
        # the straggler detector; serve_mr reports p50/p99
        self.tick_ms: list[float] = []
        self.registry = HeartbeatRegistry()
        self.stragglers = StragglerDetector(self.registry)
        self.straggler_flags: list[str] = []
        # attached by RecoveryPlan.make_service when the TickSpec asks for
        # periodic snapshots (runtime/resilience.py)
        self.checkpointer = None
        # bounded host-side spill of device-plane arrivals when every device
        # queue is full; drains into the queues as room frees (fill_slots,
        # snapshots). Beyond it, submit() REJECTs.
        self.overflow: collections.deque = collections.deque()
        self.overflow_capacity = int(overflow_capacity)
        # -- device-resident control plane (core/control.py) ---------------
        self.control_plane = control
        self.controls: list = []  # one [1, ...] ControlState row a shard
        self._pending: set[int] = set()  # submitted, no result yet
        self._seen_done: set[int] = set()  # completed since the last resubmission
        self._inflight: list[set[int]] = []  # per shard: enqueued, not yet admitted
        self._ticks_since_snapshot = 0
        if control is not None:
            from repro_torch.core import control as control_mod

            if control.shards != self.n_shards:
                raise ValueError(f"the control plane has {control.shards} shard(s), the service "
                                 f"{self.n_shards}")  # fmt: skip
            control0 = control_mod.init_control(
                cfg, scfg, n_slots, shards=control.shards, queue_capacity=control.queue_capacity,
                warm_capacity=control.warm_capacity, snapshot_period=control.snapshot_period,
                device=self.device,
            )  # fmt: skip
            self.controls = control_mod.shard_control(control0, mesh)
            self._inflight = [set() for _ in range(control.shards)]

    # -- the JAX package's layouts over the shards ---------------------------
    @property
    def state(self) -> SlotState:
        """The SlotState in the [S, ...] layout: the one shard itself, or the
        shards concatenated on the first device (a copy: write ``shards``)."""
        return gather_slots(self.shards, self.device)

    @property
    def control(self):
        """The ControlState in the [M, ...] layout (None on the host plane):
        the one shard's row itself, or the rows concatenated (a copy: write
        ``controls``)."""
        return gather_slots(self.controls, self.device) if self.controls else None

    def _locate(self, slot: int) -> tuple[SlotState, int]:
        """The shard holding global ``slot``, and the slot's row in it."""
        return self.shards[slot // self.slots_per_shard], slot % self.slots_per_shard

    def _rows(self, shard: int) -> slice:
        return slice(shard * self.slots_per_shard, (shard + 1) * self.slots_per_shard)

    def _host_read(self, leaf: torch.Tensor) -> np.ndarray:
        """Counted device-to-host readback (one host-sync point), as a copy: a
        CPU tensor's numpy view would follow the slot's later in-place writes."""
        self.counters["host_syncs"] += 1
        return leaf.detach().cpu().numpy().copy()

    def _host_gather(self, leaves: list[torch.Tensor]) -> np.ndarray:
        """Counted readback of one leaf of every shard, concatenated along the
        leading axis: on the card each shard's leaf is copied into one pinned
        host buffer without waiting, then one wait (one host-sync point)."""
        if len(leaves) == 1:
            return self._host_read(leaves[0])
        self.counters["host_syncs"] += 1
        if self.device.type != "cuda":
            return torch.cat([leaf.detach().cpu() for leaf in leaves]).numpy().copy()
        host = torch.empty((sum(leaf.shape[0] for leaf in leaves), *leaves[0].shape[1:]),
                           dtype=leaves[0].dtype, pin_memory=True)  # fmt: skip
        at = 0
        for leaf in leaves:
            host[at : at + leaf.shape[0]].copy_(leaf.detach(), non_blocking=True)
            at += leaf.shape[0]
        for device in {leaf.device for leaf in leaves}:
            torch.cuda.synchronize(device)
        return host.numpy().copy()

    def _to_device(self, x, shard: int = 0) -> torch.Tensor:
        """Host data as float32 on a shard's device. On the card the copy goes
        through pinned memory without waiting (the caching host allocator
        keeps the pinned block until the copy has run), so it never stalls a
        tick."""
        device = self.devices[shard]
        t = torch.as_tensor(np.asarray(x), dtype=torch.float32)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def _tick_batch_idx(self) -> list:
        """Each shard's minibatch window indices for this tick: None when
        every step trains on all windows, else the tick's K draws of [S, bs]
        from the service's one generator, each shard handed its rows, so the
        indices do not depend on the mesh."""
        scfg, K = self.scfg, self.scfg.steps_per_tick
        n_win = scfg.n_windows
        if not K or (scfg.batch_size or n_win) >= n_win:
            return [None] * self.n_shards
        draws = torch.stack([
            torch.randint(0, n_win, (self.n_slots, scfg.batch_size), generator=self.generator,
                          device=self.device)
            for _ in range(K)
        ])  # fmt: skip
        return [draws[:, self._rows(i)].to(d) for i, d in enumerate(self.devices)]

    # -- warm-start registry (bounded LRU) ----------------------------------
    def _warm_put(self, stream_id: int, params: MRParams):
        self.warm[stream_id] = params
        self.warm.move_to_end(stream_id)
        while len(self.warm) > self.warm_capacity:
            self.warm.popitem(last=False)

    def _warm_get(self, stream_id: int) -> MRParams | None:
        params = self.warm.get(stream_id)
        if params is not None:
            self.warm.move_to_end(stream_id)
        return params

    def _slot_params(self, slot: int) -> MRParams:
        """A copy of one slot's params (admission overwrites the slot in place)."""
        st, row = self._locate(slot)
        return tree_map(lambda a: a.clone(), tree_index(st.params, row))

    # -- admission ----------------------------------------------------------
    def submit(
        self,
        stream_id: int,
        history_y: np.ndarray,
        history_u: np.ndarray | None = None,
        priority: int = 0,
    ) -> SubmitResult:
        """Enqueue a stream with its initial buf_len-observation history.

        ``priority`` is the admission tier (0 = default; higher pops first and
        may preempt a cold lower-tier slot under pressure).

        On the device plane the history and a cold-start params tree (the
        warm ring overrides it on a hit) go straight into the least-loaded
        shard's device queue; a full queue spills into the bounded overflow
        queue (OVERFLOW), and a full overflow queue REJECTs.
        """
        L, m = self.scfg.buf_len, self.cfg.input_dim
        if history_y.shape != (L, self.cfg.state_dim):
            raise ValueError(f"history must be [{L}, {self.cfg.state_dim}], got {history_y.shape}")
        if not 0 <= priority < PRIORITY_LIMIT:
            raise ValueError(f"priority must be in [0, {PRIORITY_LIMIT}), got {priority}")
        if history_u is None:
            history_u = np.zeros((L, m), np.float32)
        sid = int(stream_id)
        self._prio_of[sid] = int(priority)
        entry = (sid, np.asarray(history_y), np.asarray(history_u), int(priority))
        if self.control_plane is None:
            self.queue.append(entry)
            return SubmitResult(SubmitStatus.ENQUEUED, sid)
        shard = self._enqueue_device(*entry)
        if shard is not None:
            return SubmitResult(SubmitStatus.ENQUEUED, sid, shard)
        if len(self.overflow) >= self.overflow_capacity:
            self._prio_of.pop(sid, None)
            return SubmitResult(SubmitStatus.REJECTED, sid)
        self.overflow.append(entry)
        self._pending.add(sid)
        self._seen_done.discard(sid)
        return SubmitResult(SubmitStatus.OVERFLOW, sid)

    def _enqueue_device(self, sid, history_y, history_u, priority) -> int | None:
        """Append one arrival into the least-loaded shard's queue (the lowest
        index on a tie); None when all are full. ``_inflight`` counts ids
        enqueued and not yet admitted, and victims preempted back into a
        queue (re-added at snapshots), so the device queue never overflows."""
        cp = self.control_plane
        shard = min(range(cp.shards), key=lambda i: (len(self._inflight[i]), i))
        if len(self._inflight[shard]) >= cp.queue_capacity:
            return None
        device = self.devices[shard]
        params, _ = cold_start(self.seed, sid, self.cfg, device)
        self.controls[shard] = cp.enqueue(
            self.controls[shard], 0, sid, self._to_device(history_y, shard),
            self._to_device(history_u, shard), params, priority,
        )  # fmt: skip
        self._inflight[shard].add(sid)
        self._pending.add(sid)
        self._seen_done.discard(sid)
        return shard

    def _drain_overflow(self) -> None:
        """Move overflowed arrivals into the device queues while room lasts."""
        while self.overflow and self._enqueue_device(*self.overflow[0]) is not None:
            self.overflow.popleft()

    def _queue_pop(self) -> tuple[int, np.ndarray, np.ndarray, int]:
        """Pop the entry with the highest tier, FIFO within a tier (``max``
        keeps the first index on ties)."""
        best = max(range(len(self.queue)), key=lambda i: self.queue[i][3])
        entry = self.queue[best]
        del self.queue[best]
        return entry

    def _admit_into(self, slot: int):
        st, row = self._locate(slot)
        if not self.queue:
            deactivate(st, row)
            self._active_view[slot] = False
            self._slot_view[slot] = -1
            self._prio_view[slot] = 0
            return None
        stream_id, buf_y, buf_u, prio = self._queue_pop()
        device = st.active.device
        warm_params = self._warm_get(stream_id)
        if warm_params is not None:
            params = tree_map(lambda a: a.to(device), warm_params)
            opt = adamw_init(params)
        else:
            params, opt = cold_start(self.seed, stream_id, self.cfg, device)
        admit(st, row, stream_id, buf_y, buf_u, params, opt)
        self._active_view[slot] = True
        self._slot_view[slot] = int(stream_id)
        self._delta_view[slot] = np.inf
        self._loss_view[slot] = np.inf
        self._steps_view[slot] = 0
        self._prio_view[slot] = int(prio)
        return stream_id

    def _preempt_host(self):
        """While a waiting arrival's tier exceeds the lowest-tier COLD active
        slot (``steps < min_steps``), the victim's params go to the warm
        registry, the victim re-enters the queue with its LIVE buffers at its
        own tier, and the arrival takes the slot. Warm slots are never
        preempted. Terminates: each displacement raises the resident tiers."""
        while self.queue:
            prio = max(e[3] for e in self.queue)
            cold = [
                s
                for s in range(self.n_slots)
                if self._active_view[s] and self._steps_view[s] < self.scfg.min_steps
            ]
            if not cold:
                return
            victim = min(cold, key=lambda s: (self._prio_view[s], s))
            if prio <= self._prio_view[victim]:
                return
            vid = int(self._slot_view[victim])
            st, row = self._locate(victim)
            self._warm_put(vid, self._slot_params(victim))
            self.queue.append(
                (
                    vid,
                    self._host_read(st.buf_y[row]),
                    self._host_read(st.buf_u[row]),
                    int(self._prio_view[victim]),
                )
            )
            # _admit_into pops by tier: the arrival, not the re-queued victim
            self._admit_into(victim)

    def fill_slots(self) -> list[int]:
        """Admit queued streams into every empty slot.

        Device plane: one ``pump`` a shard drains the device queues into
        every idle slot, then a snapshot refreshes the host views.
        """
        if self.control_plane is not None:
            self._drain_overflow()
            before = {int(i) for i in self._slot_view if i >= 0}
            statuses = []
            for i in range(self.n_shards):
                self.shards[i], self.controls[i], status = self.control_plane.pump(
                    self.shards[i], self.controls[i]
                )
                statuses.append(status)
            self._snapshot(statuses)
            return [int(i) for i in self._slot_view if i >= 0 and int(i) not in before]
        admitted = []
        active = self._host_gather([st.active for st in self.shards])
        self._active_view = np.asarray(active, bool).copy()
        for s in range(self.n_slots):
            if not active[s] and self.queue:
                sid = self._admit_into(s)
                if sid is not None:
                    admitted.append(sid)
        return admitted

    # -- the tick loop ------------------------------------------------------
    def slot_streams(self) -> list[int]:
        """stream_id per slot (-1 = empty); the caller routes chunks by this.

        Host plane: a readback. Device plane: the last snapshot's view, no
        readback (as fresh as the last snapshot tick).
        """
        if self.control_plane is not None:
            return [int(i) for i in self._slot_view]
        return [int(i) for i in self._host_gather([st.stream_id for st in self.shards])]

    def _evict(self, slot: int, reason: str) -> StreamResult:
        st, row = self._locate(slot)
        sid = int(self._host_read(st.stream_id[row]))
        theta = st.theta[row]
        if self.quant:
            yw, uw = _slot_windows(st.buf_y[row], st.buf_u[row], st.mean[row], st.scale[row],
                                   self.scfg)  # fmt: skip
            theta = readout_theta(tree_index(st.params, row), self.cfg, yw, uw, quant=True)
        res = StreamResult(
            stream_id=sid,
            theta=self._host_read(theta),
            mean=self._host_read(st.mean[row]),
            scale=self._host_read(st.scale[row]),
            steps=int(self._host_read(st.steps[row])),
            reason=reason,
        )
        self.results[sid] = res
        self._undrained.append(res)
        self._warm_put(sid, self._slot_params(slot))
        return res

    def _snapshot(self, statuses: list[torch.Tensor]) -> list[StreamResult]:
        """Device plane: refresh the host views from every shard's packed
        [S/M, 5] status and drain the event logs into StreamResults: the
        device plane's only readbacks, two a snapshot."""
        from repro_torch.core import control as control_mod

        cp = self.control_plane
        prev_slots = self._slot_view.copy()
        snap = self._host_gather(statuses)
        self._delta_view = snap[:, 0].copy()
        self._loss_view = snap[:, 1].copy()
        self._steps_view = snap[:, 2].astype(np.int64)
        self._active_view = snap[:, 3] > 0
        self._slot_view = snap[:, 4].astype(np.int64)
        for s in range(self.n_slots):
            sid = int(self._slot_view[s])
            self._prio_view[s] = self._prio_of.get(sid, 0) if sid >= 0 else 0
        events = []
        for i in range(self.n_shards):
            self.controls[i], ev = cp.drain(self.controls[i])
            events.append(ev)
        new_results = []
        for sid, steps, code, theta, mean, scale in control_mod.decode_events(
            self._host_gather(events), self.cfg
        ):
            res = StreamResult(stream_id=sid, theta=theta, mean=mean, scale=scale, steps=steps,
                               reason="converged" if code == 1 else "budget")  # fmt: skip
            self.results[sid] = res
            self._undrained.append(res)
            self._pending.discard(sid)
            self._seen_done.add(sid)
            new_results.append(res)
        # an enqueued id leaves its shard's in-flight set once a snapshot shows
        # it admitted (slot view) or completed (event log); an id that WAS
        # resident and is neither now was preempted back into its shard's
        # queue, so it counts as in flight again
        resident = {int(i) for i in self._slot_view if i >= 0}
        for s in range(self.n_slots):
            sid = int(prev_slots[s])
            if sid >= 0 and sid not in resident and sid not in self._seen_done:
                self._inflight[s // self.slots_per_shard].add(sid)
        settled = resident | self._seen_done
        for shard_ids in self._inflight:
            shard_ids.difference_update(settled)
        self._ticks_since_snapshot = 0
        self._drain_overflow()
        return new_results

    def tick_once(self, chunks_y: np.ndarray, chunks_u: np.ndarray | None = None) -> dict:
        """Advance the service one tick; returns an info dict of host scalars.

        The tick program runs once a shard, on the shard's rows of the chunks.
        Device plane: ``tick_device`` runs the tick, the eviction mask, the
        refill and the warm-start gather; the host reads nothing back except
        at snapshot ticks (every ``snapshot_period``), so ``sync_log`` records
        0 for a steady tick, and the info dict serves the last snapshot's
        views between them.
        """
        t0 = time.perf_counter()
        syncs0 = self.counters["host_syncs"]
        S, C, m = self.n_slots, self.scfg.chunk, self.cfg.input_dim
        if chunks_u is None:
            chunks_u = np.zeros((S, C, m), np.float32)
        batch_idx = self._tick_batch_idx()
        new = [(self._to_device(chunks_y[self._rows(i)], i), self._to_device(chunks_u[self._rows(i)], i))
               for i in range(self.n_shards)]  # fmt: skip
        if self.control_plane is not None:
            cp = self.control_plane
            statuses = []
            for i, (new_y, new_u) in enumerate(new):
                self.shards[i], self.controls[i], status = cp.tick(
                    self.shards[i], self.controls[i], new_y, new_u, batch_idx[i]
                )
                statuses.append(status)
            self.ticks += 1
            self._ticks_since_snapshot += 1
            evicted: list[StreamResult] = []
            if self._ticks_since_snapshot >= cp.snapshot_period:
                evicted = self._snapshot(statuses)
            info = {
                "tick": self.ticks,
                "evicted": evicted,
                "active": int(self._active_view.sum()),
                "delta": self._delta_view,
                "loss": self._loss_view,
                "steps": self._steps_view,
            }
            # checkpoint before closing the tick's sync count, so a snapshot
            # tick's staging readback lands in this tick's sync_log entry
            if self.checkpointer is not None:
                self.checkpointer.after_tick(self)
            self._finish_tick(t0)
            self.sync_log.append(self.counters["host_syncs"] - syncs0)
            return info
        outs = [self._tick(st, new_y, new_u, idx)
                for st, (new_y, new_u), idx in zip(self.shards, new, batch_idx)]  # fmt: skip
        self.ticks += 1
        # the banked tick returns (state, status[S/M, 4]): one readback for the
        # whole eviction scan; the composite tick reads each leaf separately
        banked = not isinstance(outs[0], SlotState)
        loss = None
        if banked:
            self.shards = [st for st, _ in outs]
            snap = self._host_gather([status for _, status in outs])
            delta, loss = snap[:, 0], snap[:, 1]
            steps, active = snap[:, 2].astype(np.int64), snap[:, 3] > 0
        else:
            self.shards = outs
            delta = self._host_gather([st.delta for st in self.shards])
            steps = self._host_gather([st.steps for st in self.shards])
            active = self._host_gather([st.active for st in self.shards])
        self._active_view = np.asarray(active, bool).copy()
        self._delta_view = np.asarray(delta).copy()
        if banked:
            self._loss_view = np.asarray(loss).copy()
        self._steps_view = np.asarray(steps, np.int64)
        evicted = []
        for s in range(S):
            if not active[s]:
                continue
            converged = steps[s] >= self.scfg.min_steps and delta[s] <= self.scfg.delta_tol
            budget = steps[s] >= self.scfg.max_steps
            if converged or budget:
                evicted.append(self._evict(s, "converged" if converged else "budget"))
                self._admit_into(s)
        # under pressure a higher-tier waiting arrival may displace a cold slot
        self._preempt_host()
        if not banked:
            self._loss_view = np.array(self._host_gather([st.loss for st in self.shards]))
        info = {
            "tick": self.ticks,
            "evicted": evicted,
            "active": int(self._active_view.sum()),
            "delta": delta,
            "loss": self._loss_view,
            "steps": steps,
        }
        if self.checkpointer is not None:
            self.checkpointer.after_tick(self)
        self._finish_tick(t0)
        self.sync_log.append(self.counters["host_syncs"] - syncs0)
        return info

    def _finish_tick(self, t0: float):
        """Latency accounting: the tick's wall ms, one heartbeat a shard,
        straggler check."""
        dt = time.perf_counter() - t0
        self.tick_ms.append(dt * 1e3)
        for i in range(self.n_shards):
            self.registry.beat(f"shard{i}", self.ticks, dt)
        self.straggler_flags = self.stragglers.check()

    def drain(self) -> list[StreamResult]:
        """Completed-stream results accumulated since the last drain."""
        out, self._undrained = self._undrained, []
        return out

    @property
    def done(self) -> bool:
        """True when no stream is queued, running or awaiting its result:
        from the host views (host plane) or the pending set (device plane),
        never a readback."""
        if self.control_plane is not None:
            return not self._pending
        return not self.queue and not bool(self._active_view.any())
