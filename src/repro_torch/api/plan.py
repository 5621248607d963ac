"""compile_plan: lower a RecoverySpec into a RecoveryPlan (``repro/api/plan.py``).

Every execution decision (encoder backend, fusion, QAT, int8/PWL serving,
the ``block_b`` tile, the service tick's kernel and bank size, where the
kernels run, the slot mesh) is resolved once, into one :class:`Lowering`
record. Plans run on the card: ``compile_plan(spec)`` resolves the device to
``"cuda"`` and raises when no card is visible. ``device="cpu"`` runs every
kernel's plain version on the CPU, as the tests do.

A stream spec with ``mesh_slots > 1`` shards its service's slots over the
first ``mesh_slots`` of ``devices`` (default: every visible card, or the CPU
under ``device="cpu"``); a device may repeat, so ``devices=["cpu", "cpu"]``
(or one card listed twice) holds a mesh of 2 (``runtime/elastic.py``).

Modes: ``offline`` trains one system (``run_offline``, ``readout``);
``batch`` recovers a fleet of systems as one stacked program (``run_batch``);
``stream`` builds the online service (``make_service``) on the host or the
device-resident control plane (``TickSpec.control``; the device plane's tick
is ``control.tick_device`` around the same tick body), its tick composite or
banked (the ``mr_tick`` kernel), with a ``ServiceCheckpointer`` attached when
the TickSpec asks for periodic snapshots. Batch and
stream train every system or slot at once through ``torch.func.vmap`` of
the loss (``engine.stacked_train_step``), as JAX maps the Pallas stages with
``jax.vmap``: ``fused=True`` and the ``*_kernel`` rows launch the slot-axis
form of their kernel (``mr_step``, ``mr_step_ltc``, ``mr_step_node`` or
``gru_scan``) once a step for all slots, and the plain versions on the CPU.
The fused tile is resolved against the compile-time batch, as
``repro/api/plan.py`` ``_compile_time_batch``: a stream's windows a slot,
else ``batch_size``; in stream mode over the ``n_slots`` slots.

``compile_plan(spec, audit=..., tune=...)`` runs plan analysis
(``analysis/``): ``tune="static"|"measured"`` picks the fused tile, fused
against unfused, the LTC and NODE kernels' substep unroll and the tick's bank
size (measured: timed on the card with CUDA events, the decision cached on
disk), and ``audit="warn"|"error"`` holds the plan's programs to the rules
R1-R5 and stamps the verdict into ``plan.lowering.audit``.

``precision="int8_pwl"`` (``Lowering.quant_serving``) serves through the
fixed-point fused stage: ``readout`` and every eviction of the service read
out through ``mr_step_int8`` (``mr_step_ltc_int8`` on the ltc row), and a
pure serve tick (``steps_per_tick=0``) of the banked tick launches
``mr_tick_int8``; training ticks and the composite tick read out in fp32,
and batch mode's ``run_batch`` too, as in the JAX package. It is refused on
a row without an int8 stage (the flow rows, ``node``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.api.spec import RecoverySpec
from repro_torch.core import encoders, engine
from repro_torch.core import stream as stream_mod
from repro_torch.core.library import denormalize_theta
from repro_torch.core.merinda import MRConfig, init_mr, prune_theta
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.mr_step import tiling
from repro_torch.optim import adamw_init


@dataclasses.dataclass(frozen=True)
class Lowering:
    """Every resolved execution decision, in one record.

    ``dispatch`` is ``"cuda"`` when the recovery stage runs through a
    hand-written kernel on the card, ``"reference"`` when it runs the plain
    PyTorch version (on the CPU, or an encoder that routes through no kernel).
    """

    encoder: str
    fused: bool
    kernel: bool  # encoder row routes through the gru_scan kernel
    qat: bool  # fixed-point fake-quant during training (spec.qat)
    quant_serving: bool  # int8/PWL fused readout at serving time (precision="int8_pwl")
    dispatch: str  # "cuda" | "reference"
    block_b: int | None  # resolved fused-stage batch tile (None = fitted per call)
    smem_bytes: int | None  # the row family's fused kernel's shared memory per block
    smem_budget_bytes: int | None  # the budget the "auto" tile fit into
    device: str
    mesh_shape: tuple[int, ...] = ()  # device mesh over the slot axis (stream mode)
    # which source resolved smem_budget_bytes: "explicit" (the spec's),
    # "device" (the card's opt-in shared memory a block) or "default"
    # (tiling.resolve_smem_budget)
    smem_budget_source: str | None = None
    # plan analysis (analysis/): the LTC and NODE kernels' substep unroll; how
    # the lowering was chosen ("static" | "measured" | "measured:cached", None =
    # untuned); the cache key the measured decision persists under; the chosen
    # candidate's shared-memory model and the launcher's carve for it (the
    # figure R2 holds a measured-tuned plan to); the audit verdict
    substep_unroll: int = 1
    tuned: str | None = None
    tune_cache_key: str | None = None
    predicted_bytes: int | None = None
    measured_bytes: float | None = None
    audit: str | None = None  # "pass:R1,R3,..." | "fail:R2"
    # -- stream mode (None elsewhere) ------------------------------------------
    tick_kernel: str | None = None  # "banked" | "composite"
    tick_slots_per_bank: int | None = None  # mr_tick's slots per block (banked)
    # the control plane ("host" | "device") and the capacities baked into the
    # control state's shapes (queue and snapshot fields None on the host plane)
    control_plane: str | None = None
    tick_queue_capacity: int | None = None
    tick_snapshot_period: int | None = None
    warm_capacity: int | None = None  # warm-start LRU entries (a shard's warm ring)
    # service snapshots (0 / None: off) and the device plane's overflow bound
    checkpoint_period: int | None = None
    checkpoint_dir: str | None = None
    overflow_capacity: int | None = None


class RecoveryPlan:
    """A compiled recovery: spec + lowering, and the entry points of its mode."""

    def __init__(self, spec: RecoverySpec, cfg: MRConfig, lowering: Lowering, mesh=None):
        self.spec = spec
        self.cfg = cfg
        self.scfg = spec.stream_config() if spec.mode == "stream" else None
        self.lowering = lowering
        self.device = torch.device(lowering.device)
        self.mesh = mesh  # runtime/elastic.SlotMesh over ("slots",), or None (one device)

    def _require_mode(self, mode: str) -> None:
        if self.spec.mode != mode:
            raise ValueError(f"this plan was compiled for mode={self.spec.mode!r}, not {mode!r}")

    def _tensor(self, x) -> torch.Tensor | None:
        if x is None:
            return None
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def run_offline(self, ys, us=None, norm: dict | None = None) -> tuple:
        """Train one system's recovery model: ys [N, T, n] -> (params, metrics).

        Initial weights and minibatches come from one ``torch.Generator`` on
        the plan's device, seeded with ``spec.seed``; ``norm`` applies the L1
        penalty in physical units.
        """
        self._require_mode("offline")
        ys, us = self._tensor(ys), self._tensor(us)
        generator = torch.Generator(device=self.device).manual_seed(self.spec.seed)
        params = init_mr(generator, self.cfg, self.device)
        opt_state = adamw_init(params)
        phys = engine.make_phys(self.cfg, norm, self.device)
        params, _, metrics = engine.run_epoch(
            params,
            opt_state,
            ys,
            us,
            generator,
            self.spec.lr,
            phys,
            cfg=self.cfg,
            steps=self.spec.steps,
            batch_size=self.spec.batch_size,
        )
        return params, metrics

    def run_batch(self, ys_batch, us_batch=None) -> torch.Tensor:
        """Recover S systems as one stacked program: ys_batch [S, N, T, n] ->
        theta [S, n_terms, n] on the plan's device (normalized coordinates,
        pruned to ``spec.n_active`` when set). System i's initial weights come
        from ``engine.system_generators(spec.seed, S)[i]``; minibatches (when
        ``spec.batch_size`` is set) from one generator seeded with
        ``spec.seed``."""
        self._require_mode("batch")
        ys, us = self._tensor(ys_batch), self._tensor(us_batch)
        generators = engine.system_generators(self.spec.seed, ys.shape[0], self.device)
        sampler = torch.Generator(device=self.device).manual_seed(self.spec.seed)
        return engine.recover_many(
            self.cfg, ys, us, generators, sampler,
            steps=self.spec.steps, lr=self.spec.lr, batch_size=self.spec.batch_size,
            n_active=self.spec.n_active,
        )  # fmt: skip

    @property
    def tick(self):
        """The tick program (stream mode), cfg/scfg/kernel bound:
        ``(state, new_y, new_u, batch_idx)``. Composite returns the next
        SlotState; banked returns ``(state, status [S, 4])``."""
        self._require_mode("stream")
        if self.lowering.tick_kernel == "banked":
            return functools.partial(
                stream_mod.tick_banked,
                cfg=self.cfg,
                scfg=self.scfg,
                quant=_quant_tick(self.lowering.quant_serving, self.scfg),
                slots_per_bank=self.lowering.tick_slots_per_bank,
            )
        return functools.partial(stream_mod.tick, cfg=self.cfg, scfg=self.scfg)

    @property
    def control_plane(self):
        """The device control plane's programs and capacities
        (``control.ControlPlane``), or None on the host plane."""
        self._require_mode("stream")
        low = self.lowering
        if low.control_plane != "device":
            return None
        from repro_torch.core import control as control_mod

        # one ControlState row a shard of the mesh; the service runs tick and
        # pump once a shard, on that shard's rows
        return control_mod.ControlPlane(
            queue_capacity=low.tick_queue_capacity,
            snapshot_period=low.tick_snapshot_period,
            warm_capacity=low.warm_capacity,
            shards=self.spec.mesh_slots,
            tick=functools.partial(
                control_mod.tick_device,
                cfg=self.cfg,
                scfg=self.scfg,
                kernel=low.tick_kernel,
                quant=_quant_tick(low.quant_serving, self.scfg),
                slots_per_bank=low.tick_slots_per_bank or 1,
            ),
            enqueue=control_mod.enqueue,
            pump=control_mod.pump,
            drain=control_mod.drain_events,
        )

    def make_service(self) -> stream_mod.RecoveryService:
        """The online multi-tenant service on the spec's control plane, with
        a ``ServiceCheckpointer`` attached when the TickSpec asks for
        periodic snapshots."""
        self._require_mode("stream")
        low = self.lowering
        service = stream_mod.RecoveryService(
            self.cfg,
            self.scfg,
            self.spec.n_slots,
            seed=self.spec.seed,
            device=self.device,
            tick_program=self.tick,
            warm_capacity=low.warm_capacity,
            quant=low.quant_serving,
            control=self.control_plane,
            overflow_capacity=low.overflow_capacity,
            mesh=self.mesh,
        )
        if low.checkpoint_period and low.checkpoint_dir:
            from repro_torch.runtime.resilience import ServiceCheckpointer

            service.checkpointer = ServiceCheckpointer(low.checkpoint_dir,
                                                       period=low.checkpoint_period)  # fmt: skip
        return service

    @torch.no_grad()
    def readout(
        self, params, yw, uw=None, norm: dict | None = None, n_active: int | None = None
    ) -> np.ndarray:
        """Theta [n_terms, n] through the spec's serving precision: the mean
        over windows of ``mr_forward``'s Theta (fp32) or of ``mr_step_int8``'s
        (int8_pwl), then denormalized (``norm``), then pruned (``n_active``,
        by default the spec's)."""
        theta = stream_mod.readout_theta(
            params, self.cfg, self._tensor(yw), self._tensor(uw),
            quant=self.lowering.quant_serving,
        )  # fmt: skip
        theta = theta.cpu().numpy()
        if norm is not None:
            theta = denormalize_theta(
                theta,
                norm["mean"],
                norm["scale"],
                n_vars=self.cfg.state_dim + self.cfg.input_dim,
                order=self.cfg.order,
                n_state=self.cfg.state_dim,
            )
        n_active = self.spec.n_active if n_active is None else n_active
        if n_active is not None:
            theta = prune_theta(theta, n_active)
        return theta


def _compile_time_batch(spec: RecoverySpec) -> int | None:
    """The fused stage's batch knowable at compile time
    (``repro/api/plan.py:385-395``): a stream's windows a slot (the tick's
    readout batch), else the optimizer minibatch (None: all windows, unknown
    until the call)."""
    if spec.mode == "stream":
        return spec.stream_config().n_windows
    return spec.batch_size


def _quant_tick(quant_serving: bool, scfg) -> bool:
    """The int8 tick is engaged only for pure serve ticks (K = 0) under
    int8_pwl serving, as ``repro/api/plan.py:353-363``."""
    return quant_serving and scfg.steps_per_tick == 0


def _resolve_tick_kernel(
    spec: RecoverySpec, cfg: MRConfig, quant_tick: bool = False
) -> tuple[str, int | None]:
    """``TickSpec.tick_kernel`` -> ("banked" | "composite", slots_per_bank).

    ``"banked"`` on a row the kernel does not implement (ltc, node; for the
    int8 tick every row but the standard GRU) raises; ``"auto"`` takes banked
    when the row is supported and one slot fits (``tiling.tick_smem_bytes``:
    a block of the slot's cluster, for both ticks), else composite. The bank size is ``tiling.auto_slots_per_bank``
    (1 when an explicit request does not fit: the launch then raises, as the
    JAX package runs an explicit request at bank 1)."""
    from repro_torch.kernels.mr_step.tick import tick_supported

    requested = spec.tick_spec().tick_kernel
    if requested == "composite":
        return "composite", None
    if not tick_supported(cfg, int8=quant_tick):
        if requested == "banked":
            raise ValueError(
                f"tick_kernel='banked' requires a GRU-family encoder (csrc/mr_tick.cu banks "
                f"the gru cell; its int8 twin the standard 'gru' cell); got "
                f"encoder={spec.encoder!r} int8={quant_tick} — use 'composite' or 'auto'"
            )
        return "composite", None
    # a divisor of a shard's slots: each tick launch banks one shard's S/M slots
    local_slots = spec.n_slots // spec.mesh_slots
    spb = tiling.auto_slots_per_bank(cfg, spec.stream_config(), local_slots, int8=quant_tick)
    if spb < 1:
        return ("banked", 1) if requested == "banked" else ("composite", None)
    return "banked", spb


def _slot_mesh(spec: RecoverySpec, device: torch.device, devices):
    """The stream plan's slot mesh over ``devices`` (None at ``mesh_slots=1``);
    more shards than devices raises, as ``repro/api/plan.py:457-466``."""
    from repro_torch.runtime.elastic import MeshPlan, build_mesh, visible_devices

    if spec.mode != "stream" or spec.mesh_slots == 1:
        return None
    if devices is None:
        devices = visible_devices() if device.type == "cuda" else [device]
    if spec.mesh_slots > len(devices):
        raise ValueError(
            f"mesh_slots={spec.mesh_slots} exceeds the {len(devices)} given device(s); pass "
            f"devices= with one entry a shard (a device may repeat: serve_mr --virtual-devices)"
        )
    return build_mesh(MeshPlan((spec.mesh_slots,), ("slots",)), devices)


AUDIT_MODES = ("off", "warn", "error")
TUNE_MODES = ("off", "static", "measured")


def compile_plan(
    spec: RecoverySpec,
    device: str | torch.device | None = None,
    devices=None,
    audit: str = "off",
    tune: str = "off",
) -> RecoveryPlan:
    """Validate and lower a RecoverySpec; see the module docstring. ``devices``
    lists the devices a slot mesh may take (its first one is the plan's
    device when ``device`` is not given).

    ``audit`` runs the plan auditor (``analysis/audit.py``) over the plan's
    programs: ``"warn"`` warns once a finding, ``"error"`` raises
    ``AuditError`` on any; both stamp the verdict into ``lowering.audit``.
    ``tune`` (``analysis/tuner.py``): ``"static"`` records the candidate table
    through the shared-memory model and chooses what the static policy
    chooses; ``"measured"`` times every candidate's stage on the card (the
    model and the roofline rank them on the CPU) and caches the decision, so
    a warm recompile times nothing. The choice and its evidence land in
    ``lowering`` (``block_b``, ``fused``, ``substep_unroll``,
    ``tick_slots_per_bank``, ``tuned``, ``tune_cache_key``,
    ``predicted_bytes``, ``measured_bytes``).
    """
    if audit not in AUDIT_MODES:
        raise ValueError(f"audit must be one of {AUDIT_MODES}, got {audit!r}")
    if tune not in TUNE_MODES:
        raise ValueError(f"tune must be one of {TUNE_MODES}, got {tune!r}")
    if devices is not None:
        devices = [rt.resolve_device(d, "compile_plan") for d in devices]
        device = devices[0] if device is None else device
    device = rt.resolve_device(device, "compile_plan")
    mesh = _slot_mesh(spec, device, devices)
    if mesh is not None:
        device = mesh.devices[0]
    row = encoders.validate_config(spec.to_mr_config())  # unknown name, unfusable row
    quant_serving = spec.precision == "int8_pwl"
    if quant_serving and not row.int8:
        raise ValueError(
            f"precision='int8_pwl' serves through a fixed-point fused stage, implemented for "
            f"the families with a PWL activation mapping ({encoders.int8_names()}); got "
            f"{spec.encoder!r}"
        )
    if spec.qat is not None and row.flow is None:
        raise ValueError(
            f"qat (fixed-point fake-quant) is implemented for the GRU families, "
            f"got encoder={spec.encoder!r}"
        )
    tiling.check_unroll(spec.substep_unroll, row.family)
    rt.pin_fp32_matmul()
    report = None
    if tune != "off":
        from repro_torch.analysis import tuner as tuner_mod

        report = tuner_mod.tune(spec, mode=tune, device=device)
    chosen = report.chosen.candidate if report is not None else None
    fused = chosen.fused if chosen is not None else spec.fused
    unroll = chosen.substep_unroll if chosen is not None else spec.substep_unroll
    block_b, smem, budget, budget_src = None, None, None, None
    if chosen is not None and fused:
        block_b = chosen.block_b
        budget, budget_src = report.budget_bytes, report.budget_source
    elif spec.fused:
        batch = _compile_time_batch(spec)
        if spec.block_b == "auto":
            budget, budget_src = tiling.resolve_smem_budget(device, spec.smem_budget_bytes)
            slots = spec.n_slots // spec.mesh_slots if spec.mode == "stream" else 1
            block_b = tiling.auto_block_b(spec.to_mr_config(), row.family, batch, budget,
                                          slots=slots)  # fmt: skip
        elif isinstance(spec.block_b, int):
            if batch is not None and batch % spec.block_b:
                raise ValueError(
                    f"block_b={spec.block_b} does not divide the compile-time batch ({batch})"
                )
            block_b = spec.block_b
    if fused and block_b is not None:
        smem = tiling.config_smem_bytes(spec.to_mr_config(), row.family, block_b)
    cfg = spec.to_mr_config(block_b, substep_unroll=unroll)
    if cfg.fused != fused:  # the tuner may flip the dispatch (the same math)
        cfg = dataclasses.replace(cfg, fused=fused)
    routes_kernel = fused or row.kernel or quant_serving
    stream_fields = {}
    if spec.mode == "stream":
        quant_tick = _quant_tick(quant_serving, spec.stream_config())
        tick_kernel, spb = _resolve_tick_kernel(spec, spec.to_mr_config(), quant_tick)
        if tick_kernel == "banked" and report is not None and report.chosen_tick is not None:
            spb = report.chosen_tick.candidate.slots_per_bank  # the tuner's bank
        tspec = spec.tick_spec()
        device_plane = tspec.control == "device"
        stream_fields = dict(
            tick_kernel=tick_kernel,
            tick_slots_per_bank=spb,
            control_plane=tspec.control,
            tick_queue_capacity=tspec.queue_capacity if device_plane else None,
            tick_snapshot_period=tspec.snapshot_period if device_plane else None,
            warm_capacity=tspec.warm_capacity,
            checkpoint_period=tspec.checkpoint_period,
            checkpoint_dir=tspec.checkpoint_dir,
            overflow_capacity=tspec.overflow_capacity,
        )
    tuned = None
    if report is not None:
        tuned = "measured:cached" if report.cache_hit else report.mode
    lowering = Lowering(
        encoder=spec.encoder,
        fused=fused,
        kernel=row.kernel,
        qat=spec.qat is not None,
        quant_serving=quant_serving,
        dispatch="cuda" if routes_kernel and device.type == "cuda" else "reference",
        block_b=block_b,
        smem_bytes=smem,
        smem_budget_bytes=budget,
        device=str(device),
        mesh_shape=(spec.mesh_slots,) if spec.mode == "stream" else (),
        smem_budget_source=budget_src,
        substep_unroll=unroll,
        tuned=tuned,
        tune_cache_key=report and report.cache_key,
        predicted_bytes=report and report.chosen.predicted_bytes,
        measured_bytes=report and report.chosen.parsed_bytes,
        **stream_fields,
    )
    plan = RecoveryPlan(spec, cfg, lowering, mesh)
    if audit != "off":
        from repro_torch.analysis import audit as audit_mod

        verdict = audit_mod.audit_plan(plan)
        plan.lowering = dataclasses.replace(lowering, audit=verdict.verdict)
        if verdict.findings:
            if audit == "error":
                raise audit_mod.AuditError(verdict)
            import warnings

            for f in verdict.findings:
                warnings.warn(f"plan audit: {f}", stacklevel=2)
    return plan
