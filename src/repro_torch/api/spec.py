"""RecoverySpec: one declarative record of what to recover and how to run it.

Counterpart of ``repro/api/spec.py``: the offline, batch and stream modes, QAT
and int8/PWL serving (``precision="int8_pwl"``) included, and the service
tick's ``TickSpec`` with both control planes (``control="device"``: the
device-resident one, ``core/control.py``) and periodic service checkpoints
(``checkpoint_period > 0``, ``runtime/resilience.py``), and the slot mesh
(``mesh_slots > 1``: the stream service's slots sharded over that many
devices, ``compile_plan(spec, devices=...)``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.merinda import MRConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.core.stream import StreamConfig

MODES = ("offline", "batch", "stream")
PRECISIONS = ("fp32", "int8_pwl")
TICK_KERNELS = ("banked", "composite", "auto")
CONTROL_PLANES = ("host", "device")


@dataclasses.dataclass(frozen=True)
class TickSpec:
    """The service tick (stream mode).

    ``tick_kernel``: ``"composite"`` reads out with plain PyTorch ops,
    ``"banked"`` through one launch of the ``mr_tick`` kernel with the status
    packed for one readback, ``"auto"`` takes banked where the encoder row and
    the kernel's shared memory allow (``compile_plan`` records the choice in
    ``plan.lowering``). ``steps_per_tick=0`` is a pure serve tick.
    ``warm_capacity`` bounds the warm-start LRU (and the device plane's warm
    ring).

    ``control="device"`` keeps the admission queues, the eviction mask, slot
    refill and warm-start lookup on the card (``core/control.py``), so a
    steady tick reads nothing back. Its capacities, the per-shard
    ``queue_capacity`` and the host's ``snapshot_period`` (drain the status
    and the eviction events every N ticks), are baked into the control
    state's shapes and recorded in ``plan.lowering``. ``checkpoint_period >
    0`` snapshots the service (SlotState, ControlState, warm LRU) every N
    ticks into ``checkpoint_dir``, async and atomic; 0 (the default) turns
    snapshots off, since staging one reads the state back.
    """

    steps_per_tick: int = 8  # K optimizer steps per slot per tick (0 = serve-only)
    ema_decay: float = 0.9  # smoothing for the per-tick Theta readout
    tick_kernel: str = "composite"  # "banked" | "composite" | "auto"
    control: str = "host"  # "host" | "device" (device-resident control plane)
    queue_capacity: int = 8  # pending admissions a shard (device plane)
    snapshot_period: int = 1  # ticks between host status/event drains (device plane)
    warm_capacity: int = 32  # warm-start entries (a shard's warm ring on the device plane)
    checkpoint_period: int = 0  # ticks between service snapshots (0 = off)
    checkpoint_dir: str | None = None  # where the snapshots go
    # the device plane's bounded host overflow queue behind submit()'s typed
    # backpressure: OVERFLOW up to this many streams, REJECTED beyond
    overflow_capacity: int = 16

    def __post_init__(self):
        if self.tick_kernel not in TICK_KERNELS:
            raise ValueError(f"tick_kernel must be one of {TICK_KERNELS}, got {self.tick_kernel!r}")
        if self.steps_per_tick < 0:
            raise ValueError(f"steps_per_tick must be >= 0, got {self.steps_per_tick}")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.control not in CONTROL_PLANES:
            raise ValueError(f"control must be one of {CONTROL_PLANES}, got {self.control!r}")
        if self.queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, got {self.queue_capacity}")
        if self.snapshot_period < 1:
            raise ValueError(f"snapshot_period must be >= 1, got {self.snapshot_period}")
        if self.warm_capacity < 1:
            raise ValueError(f"warm_capacity must be >= 1, got {self.warm_capacity}")
        if self.checkpoint_period < 0:
            raise ValueError(f"checkpoint_period must be >= 0, got {self.checkpoint_period}")
        if self.checkpoint_period > 0 and not self.checkpoint_dir:
            raise ValueError("checkpoint_period > 0 requires checkpoint_dir")
        if self.overflow_capacity < 0:
            raise ValueError(f"overflow_capacity must be >= 0, got {self.overflow_capacity}")


@dataclasses.dataclass(frozen=True)
class RecoverySpec:
    # -- model / library shape ---------------------------------------------
    state_dim: int  # n = |Y|
    input_dim: int = 0  # m = |U|
    order: int = 2  # library polynomial order
    hidden: int = 32  # encoder width V
    dense_hidden: int | None = None  # head width (None = 2 * hidden)
    n_shifts: int = 0  # q input-shift outputs
    dt: float = 0.05
    solver: str = "rk4"
    ltc_substeps: int = 6  # solver substeps per input step of the ltc/node encoders
    lambda_sparse: float = 1e-3
    recon_weight: float = 1.0

    # -- numerics / lowering -----------------------------------------------
    encoder: str = "gru_flow"  # any name registered in core/encoders.py
    precision: str = "fp32"  # serving readout: "fp32" | "int8_pwl" (int8 weights, PWL activations)
    qat: QuantConfig | None = None  # fixed-point fake-quant during training
    fused: bool = False  # stage-fused per-window step (kernels/mr_step)
    block_b: int | str | None = None  # fused batch tile: int, None, or "auto"
    # shared memory the "auto" tile fits into; None = the card's opt-in shared
    # memory a block (kernels/mr_step/tiling.resolve_smem_budget; 227 KB on an
    # H100, and on the CPU); plan.lowering.smem_budget_source records which
    smem_budget_bytes: int | None = None
    # the LTC and NODE kernels' substep-loop unroll (MRConfig.substep_unroll):
    # 1 = none. compile_plan(tune="static"|"measured") may resolve another;
    # the resolved factor lands in plan.lowering.substep_unroll
    substep_unroll: int = 1

    # -- execution ----------------------------------------------------------
    mode: str = "offline"  # "offline" | "batch" | "stream"
    steps: int = 500  # optimizer steps (offline/batch)
    lr: float = 3e-3
    batch_size: int | None = None  # windows per optimizer step (None = all)
    seed: int = 0
    n_active: int | None = None  # magnitude-prune readout to this many terms

    # -- stream mode ---------------------------------------------------------
    n_slots: int = 4
    stream: StreamConfig | None = None  # None = StreamConfig() defaults
    tick: TickSpec | None = None  # None = TickSpec() defaults (composite)

    # -- placement -----------------------------------------------------------
    mesh_slots: int = 1  # devices sharding the slot axis (stream mode; 1 = one device)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")
        if self.state_dim < 1 or self.input_dim < 0 or self.order < 1:
            raise ValueError(
                f"bad library shape: state_dim={self.state_dim} "
                f"input_dim={self.input_dim} order={self.order}"
            )
        if isinstance(self.block_b, str):
            if self.block_b != "auto":
                raise ValueError(f'block_b must be an int, None or "auto", got {self.block_b!r}')
        elif self.block_b is not None and self.block_b < 1:
            raise ValueError(f"block_b must be >= 1, got {self.block_b}")
        if self.smem_budget_bytes is not None and self.block_b != "auto":
            raise ValueError(
                'smem_budget_bytes requires block_b="auto" (a fixed tile ignores the budget)'
            )
        if self.substep_unroll < 1:
            raise ValueError(f"substep_unroll must be >= 1, got {self.substep_unroll}")
        if self.mesh_slots < 1:
            raise ValueError(f"mesh_slots must be >= 1, got {self.mesh_slots}")
        if self.mode == "stream":
            if self.n_slots < 1:
                raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
            if self.n_slots % self.mesh_slots != 0:
                raise ValueError(
                    f"n_slots ({self.n_slots}) must divide evenly over the mesh "
                    f"({self.mesh_slots} devices) for a balanced slot shard"
                )
            if self.stream is not None and (
                self.stream.lr != self.lr or self.stream.batch_size != self.batch_size
            ):
                # the tick trains with StreamConfig's copies: one source of truth
                raise ValueError(
                    f"stream-mode lr/batch_size conflict: spec has "
                    f"(lr={self.lr}, batch_size={self.batch_size}) but stream= has "
                    f"(lr={self.stream.lr}, batch_size={self.stream.batch_size}); "
                    f"set them equal (the StreamConfig governs the tick)"
                )
            if (
                self.tick is not None
                and self.stream is not None
                and (
                    self.stream.steps_per_tick != self.tick.steps_per_tick
                    or self.stream.ema != self.tick.ema_decay
                )
            ):
                raise ValueError(
                    f"stream-mode tick conflict: tick= has (steps_per_tick="
                    f"{self.tick.steps_per_tick}, ema_decay={self.tick.ema_decay}) but "
                    f"stream= has (steps_per_tick={self.stream.steps_per_tick}, "
                    f"ema={self.stream.ema}); set them equal"
                )
        else:
            if self.mesh_slots != 1:
                raise ValueError(f"mesh_slots > 1 requires mode='stream', got mode={self.mode!r}")
            if self.tick is not None:
                raise ValueError(f"tick= requires mode='stream', got mode={self.mode!r}")

    def to_mr_config(
        self, block_b: int | None = None, substep_unroll: int | None = None
    ) -> MRConfig:
        """The MRConfig this spec lowers to; ``block_b`` is the resolved tile and
        ``substep_unroll`` overrides the spec's factor (the tuner's choice)."""
        if block_b is None and isinstance(self.block_b, int):
            block_b = self.block_b
        return MRConfig(
            state_dim=self.state_dim,
            input_dim=self.input_dim,
            order=self.order,
            hidden=self.hidden,
            dense_hidden=self.dense_hidden or 2 * self.hidden,
            encoder=self.encoder,
            n_shifts=self.n_shifts,
            dt=self.dt,
            solver=self.solver,
            ltc_substeps=self.ltc_substeps,
            lambda_sparse=self.lambda_sparse,
            recon_weight=self.recon_weight,
            quant=self.qat,
            fused=self.fused,
            block_b=block_b,
            substep_unroll=self.substep_unroll if substep_unroll is None else substep_unroll,
        )

    def stream_config(self) -> StreamConfig:
        if self.stream is not None:
            return self.stream  # __post_init__ pinned lr/batch_size/tick agreement
        kw = dict(lr=self.lr, batch_size=self.batch_size)
        if self.tick is not None:
            kw.update(steps_per_tick=self.tick.steps_per_tick, ema=self.tick.ema_decay)
        return StreamConfig(**kw)

    def tick_spec(self) -> TickSpec:
        """The resolved TickSpec (mirrors ``stream_config`` when ``tick`` is None)."""
        if self.tick is not None:
            return self.tick
        scfg = self.stream_config()
        return TickSpec(steps_per_tick=scfg.steps_per_tick, ema_decay=scfg.ema)
