"""Plan auditor: hold a compiled RecoveryPlan's programs to the hardware contract.

Counterpart of ``repro/analysis/audit.py``. ``audit_plan`` runs each program
of a plan once under ``analysis/trace.observe`` (the eager counterpart of
lowering it to HLO) and holds what it saw to the rules of
``analysis/rules.py``:

    R1 no copy kept, R2 shared-memory residency, R3 host-transfer hygiene,
    R4 int8 weight transport, R5 sharded-tick crossing census.

The programs and their rules per mode follow the JAX auditor
(``repro/analysis/audit.py:220-391``):

- stream: the tick (``tick`` or the banked ``tick_banked``; R1 on the slot
  state, R3, R5 on a mesh), run once a shard as the service runs it, with the
  other shards' storages marked foreign; on the device plane also
  ``tick_device`` (R1 on the state and the control row, R3, R5); R2 on the
  banked tick at K = 0 (the ``mr_tick`` carve), and R4 on the int8 tick;
- offline: two steps of the epoch (``engine.run_epoch``; R1 on the params and
  optimizer state, R3); every step is the same program;
- fused plans: the fused stage (``mr_step``; R2, R3);
- int8 serving: the readout (``readout_theta`` through ``mr_step_int8`` or
  ``mr_step_ltc_int8``; R4, R3).

R2 compares the tiling model with the launcher's exported carve, so it runs
only where the kernel library is loaded: a plan on the card. On the CPU it is
absent from ``checked``, as the JAX auditor leaves out a rule that does not
apply. On the card each program first runs once untraced, which makes its
once-a-device constants (a compiled program holds its constants; their one
upload is no wait of a steady call), and every program that R3 holds also runs
after the traced call under ``torch.cuda.set_sync_debug_mode("error")``, the
second witness of R3.

``compile_plan(spec, audit="warn"|"error")`` runs this at plan-compile time and
stamps the verdict into ``plan.lowering.audit``; violations raise
:class:`AuditError` under ``"error"`` and warn under ``"warn"``.

CLI::

    python -m repro_torch.analysis.audit --matrix --device cpu \\
        --error-rules R1,R3,R4 --warn-rules R2,R5 --json findings.json

audits the encoder x fused x int8 spec matrix at tiny stream shapes, the
banked and device-plane cells, the slot-mesh cells (a mesh of 2 on the device
listed twice, in process) and a restored cell (the plan the supervisor
compiles after a shard is lost), and exits nonzero on any error-rule finding.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.analysis import rules as R
from repro_torch.analysis import tuner
from repro_torch.analysis.trace import named_leaves, observe
from repro_torch.kernels import runtime as rt
from repro_torch.tree import tree_map

DEFAULT_RULES = ("R1", "R2", "R3", "R4", "R5")

#: device waits the tick program may contain: NONE. Every host read of the
#: service lives in RecoveryService.tick_once (counted in sync_log); the
#: program itself stays on the device.
DEFAULT_TICK_ALLOWLIST: tuple[str, ...] = ()

EPOCH_STEPS = 2  # steps of the epoch the audit runs (each the same program)
INT8 = "int8"
INT8_WEIGHTS = {  # the contracted int8 operands of each serving kernel
    "mr_step_int8": ("wxq", "whq", "w1q", "w2q"),
    "mr_step_ltc_int8": ("w_inq", "w_recq", "w1q", "w2q"),
    "mr_tick_int8": ("wxq", "whq", "w1q", "w2q"),
}


class AuditError(ValueError):
    """A compiled plan violated its hardware contract (audit="error")."""

    def __init__(self, report: "AuditReport"):
        self.report = report
        lines = "\n".join(f"  {f}" for f in report.findings)
        super().__init__(f"plan audit failed with {len(report.findings)} finding(s):\n{lines}")


@dataclasses.dataclass
class AuditReport:
    """Outcome of one ``audit_plan`` run: findings and what was checked."""

    findings: list[R.Finding]
    checked: dict[str, list[str]]  # rule id -> programs it ran over

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def verdict(self) -> str:
        """Compact stamp for plan.lowering.audit: "pass:R1,R3" / "fail:R2"."""
        if self.ok:
            return "pass:" + ",".join(sorted(self.checked))
        return "fail:" + ",".join(sorted({f.rule for f in self.findings}))

    def to_json(self) -> dict:
        return {
            "verdict": self.verdict,
            "checked": self.checked,
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }


def _family(plan) -> str:
    from repro_torch.core import encoders

    return encoders.get_encoder(plan.cfg.encoder).family


def _carve_available(plan) -> bool:
    """R2 needs the kernel library: a plan on the card."""
    return plan.device.type == "cuda"


class _Audit:
    """The findings and checked programs of one audit."""

    def __init__(self, rules, allowlist, device):
        self.rules, self.allowlist, self.device = rules, allowlist, device
        self.findings: list[R.Finding] = []
        self.checked: dict[str, list[str]] = {}

    def run(self, rule: str, program: str, fn, *args) -> None:
        if rule not in self.rules:
            return
        programs = self.checked.setdefault(rule, [])
        if program not in programs:
            programs.append(program)
        self.findings.extend(fn(program, *args))

    def program(self, name, fn, make_args, *, donated=None, foreign=(), mesh=None,
                int8_kernels=()) -> None:  # fmt: skip
        """Observe one call of ``fn(*make_args())`` and hold it to R1 (when it
        replaces ``donated`` trees), R3, R4 (``int8_kernels``) and R5 (``mesh``)."""
        if self.device.type == "cuda":
            # a first call makes the once-a-device constants (the window index,
            # the exponent table), as a compiled program holds its constants
            fn(*make_args())
            torch.cuda.synchronize(self.device)
        trace = observe(name, fn, make_args(), donated=donated, foreign=foreign)
        if donated:
            self.run("R1", name, R.check_no_copy_kept, trace, tuple(donated))
        self.run("R3", name, R.check_host_transfers, trace, self.allowlist)
        if "R3" in self.rules and self.device.type == "cuda":
            self._sync_debug(name, fn, make_args)
        if int8_kernels:
            weights = {k: dict.fromkeys(INT8_WEIGHTS[k], INT8) for k in int8_kernels}
            self.run("R4", name, R.check_weight_dtypes, trace, weights)
        if mesh is not None:
            self.run("R5", name, R.check_collectives, trace, R.predict_tick_collectives(mesh))

    def _sync_debug(self, name, fn, make_args) -> None:
        """R3's second witness: the same program under sync-debug mode "error"
        (its arguments made before the mode is set)."""
        args = make_args()
        torch.cuda.synchronize(self.device)
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args)
        except RuntimeError as e:
            self.findings.append(R.sync_debug_finding(name, str(e)))
        finally:
            torch.cuda.set_sync_debug_mode(previous)


def _audit_stream(plan, audit: _Audit) -> None:
    from repro_torch.core import stream as stream_mod

    spec, cfg, scfg, low = plan.spec, plan.cfg, plan.scfg, plan.lowering
    dev = plan.device
    quant_tick = low.quant_serving and scfg.steps_per_tick == 0
    banked = low.tick_kernel == "banked"
    S, M = spec.n_slots, spec.mesh_slots
    n, m, C = cfg.state_dim, cfg.input_dim, scfg.chunk
    shards = stream_mod.shard_slots(stream_mod.init_slots(spec.seed, cfg, scfg, S, dev), plan.mesh)
    devices = plan.mesh.devices if plan.mesh is not None else [dev]
    controls = [None] * len(shards)
    plane = plan.control_plane
    if plane is not None:
        from repro_torch.core import control as control_mod

        control = control_mod.init_control(
            cfg, scfg, S, shards=M, queue_capacity=low.tick_queue_capacity,
            warm_capacity=low.warm_capacity, snapshot_period=low.tick_snapshot_period, device=dev,
        )  # fmt: skip
        controls = control_mod.shard_control(control, plan.mesh)
    gen = torch.Generator(device="cpu").manual_seed(spec.seed)
    chunks_y = torch.randn((S, C, n), generator=gen)
    chunks_u = torch.randn((S, C, m), generator=gen)
    P = S // M
    tick = plan.tick
    int8_tick = ("mr_tick_int8",) if banked and quant_tick else ()
    tick_name = "tick"
    for i, (shard, ctl, d) in enumerate(zip(shards, controls, devices)):
        others = [t for j, (sh, ct) in enumerate(zip(shards, controls)) if j != i
                  for _, t in named_leaves((sh, ct), "")]  # fmt: skip
        new_y, new_u = chunks_y[i * P : (i + 1) * P].to(d), chunks_u[i * P : (i + 1) * P].to(d)
        # each call takes a fresh copy of the shard's state, so the traced call
        # holds the only reference to what it replaces
        fresh = lambda tree: tree_map(lambda t: t.clone(), tree)  # noqa: E731
        audit.program(
            tick_name, tick, lambda: [fresh(shard), new_y, new_u, None], donated={"state": 0},
            foreign=others, mesh=plan.mesh, int8_kernels=int8_tick,
        )  # fmt: skip
        if plane is not None:
            audit.program(
                "tick_device", plane.tick, lambda: [fresh(shard), fresh(ctl), new_y, new_u, None],
                donated={"state": 0, "control": 1}, foreign=others, mesh=plan.mesh,
                int8_kernels=int8_tick,
            )  # fmt: skip
    if banked and not scfg.steps_per_tick and _carve_available(plan):
        # K = 0 serve tick: the program is mr_tick's serving segment, so its
        # shared memory is held to the tick-level model directly
        from repro_torch.core.quant import N_SEG
        from repro_torch.kernels.mr_step import tiling

        D, H, Dh, Ko = n + m, cfg.hidden, cfg.dense_hidden, cfg.n_coef + cfg.n_shifts
        T, N = scfg.window, scfg.n_windows
        predicted = tiling.tick_smem_bytes(D, H, Dh, Ko, N, T, int8=quant_tick)
        dims = (D, H, Dh, Ko, T, N, *((N_SEG,) if quant_tick else ()))
        carved = rt.kernel_smem_bytes("mr_tick_int8" if quant_tick else "mr_tick", *dims)
        audit.run("R2", "tick_banked", R.check_residency, predicted, carved, _family(plan))


def _audit_epoch(plan, audit: _Audit) -> None:
    from repro_torch.core import engine
    from repro_torch.core.merinda import init_mr
    from repro_torch.optim import adamw_init

    spec, cfg, dev = plan.spec, plan.cfg, plan.device
    N, T = max(spec.batch_size or 8, 4), tuner.T_OFFLINE
    gen = torch.Generator(device="cpu").manual_seed(spec.seed)
    ys = (0.1 * torch.randn((N, T, cfg.state_dim), generator=gen)).to(dev)
    us = torch.randn((N, T, cfg.input_dim), generator=gen).to(dev) if cfg.input_dim else None

    def make_args():
        params = init_mr(torch.Generator(device=dev).manual_seed(spec.seed), cfg, dev)
        return [params, adamw_init(params), ys, us, torch.Generator(device=dev).manual_seed(0),
                spec.lr, None]  # fmt: skip

    def epoch(params, opt, ys, us, generator, lr, phys):
        return engine.run_epoch(params, opt, ys, us, generator, lr, phys, cfg=cfg,
                                steps=min(spec.steps, EPOCH_STEPS), batch_size=spec.batch_size)  # fmt: skip

    audit.program("epoch", epoch, make_args, donated={"params": 0, "opt_state": 1})


def _stage_inputs(plan):
    """(params, xs [B, T, n + m]) of the fused stage, from the plan's seed."""
    from repro_torch.core.merinda import init_mr

    cfg, dev = plan.cfg, plan.device
    params = init_mr(torch.Generator(device=dev).manual_seed(plan.spec.seed), cfg, dev)
    gen = torch.Generator(device="cpu").manual_seed(plan.spec.seed)
    B, T = tuner.step_batch(plan.spec) or 16, tuner.step_window(plan.spec)
    D = cfg.state_dim + cfg.input_dim
    return params, torch.randn((B, T, D), generator=gen).to(dev)


def _audit_fused(plan, audit: _Audit) -> None:
    from repro_torch.kernels.mr_step import ops as mr_ops
    from repro_torch.kernels.mr_step import tiling

    cfg, low = plan.cfg, plan.lowering
    params, xs = _stage_inputs(plan)
    audit.program("fused_step", lambda p, x: mr_ops.mr_step(p, cfg, x, block_b=low.block_b),
                  lambda: [params, xs])  # fmt: skip
    if not _carve_available(plan):
        return
    family = _family(plan)
    dims = (cfg.state_dim + cfg.input_dim, cfg.hidden, cfg.dense_hidden, cfg.n_coef + cfg.n_shifts)
    bb = tuner.step_tile(plan.spec, low.block_b)
    predicted = tiling.family_smem_bytes(family, *dims, bb)
    carved = rt.kernel_smem_bytes(tuner.FUSED_KERNEL[family], *dims, bb)
    audit.run("R2", "fused_step", R.check_residency, predicted, carved, family)
    if low.measured_bytes is not None:
        # a measured-tuned plan also records the carve the tuner read for its
        # choice: that record must be the launch's carve as well
        audit.run("R2", "fused_step", R.check_recorded_carve, int(low.measured_bytes), carved)


def _audit_serving(plan, audit: _Audit) -> None:
    from repro_torch.core import stream as stream_mod

    cfg = plan.cfg
    params, xs = _stage_inputs(plan)
    yw, uw = xs[..., : cfg.state_dim], xs[..., cfg.state_dim :]
    kernel = "mr_step_ltc_int8" if _family(plan) == "ltc" else "mr_step_int8"
    audit.program(
        "serving_int8", lambda p, y, u: stream_mod.readout_theta(p, cfg, y, u, quant=True),
        lambda: [params, yw, uw if cfg.input_dim else None], int8_kernels=(kernel,),
    )  # fmt: skip


def audit_plan(
    plan,
    *,
    rules: tuple[str, ...] = DEFAULT_RULES,
    host_allowlist: tuple[str, ...] = DEFAULT_TICK_ALLOWLIST,
) -> AuditReport:
    """Audit every program of a compiled RecoveryPlan; see the module docstring."""
    audit = _Audit(rules, host_allowlist, plan.device)
    if plan.spec.mode == "stream":
        _audit_stream(plan, audit)
    elif plan.spec.mode == "offline":
        _audit_epoch(plan, audit)
    if plan.lowering.fused:
        _audit_fused(plan, audit)
    if plan.lowering.quant_serving:
        _audit_serving(plan, audit)
    return AuditReport(findings=audit.findings, checked=audit.checked)


# ---------------------------------------------------------------------------
# --matrix CLI
# ---------------------------------------------------------------------------

# tiny stream shapes (repro/analysis/audit.py:390-391): 2 windows of 8 a tick,
# 2 slots; enough structure to exercise every contract
_TINY = dict(state_dim=2, order=2, hidden=8, dense_hidden=16, mode="stream", n_slots=2)
_TINY_STREAM = dict(buf_len=16, window=8, stride=8, chunk=8, steps_per_tick=2)


def _matrix_specs():
    """Every encoder x fused x int8 cell, the banked and device-plane cells, as
    (label, RecoverySpec) pairs (``repro/analysis/audit.py:394`` ``_matrix_specs``)."""
    from repro_torch.api.spec import RecoverySpec, TickSpec
    from repro_torch.core import encoders
    from repro_torch.core.stream import StreamConfig

    cells = []
    for name in encoders.encoder_names():
        row = encoders.get_encoder(name)
        for fused in (False, True):
            if fused and not row.fusable:
                continue
            for quant in (False, True) if row.int8 else (False,):
                label = f"{name}:fused={int(fused)}:int8={int(quant)}"
                spec = RecoverySpec(
                    encoder=name,
                    precision="int8_pwl" if quant else "fp32",
                    fused=fused,
                    stream=StreamConfig(**_TINY_STREAM),
                    **_TINY,
                )
                cells.append((label, spec))
    banked = [
        ("gru:tick=banked", "gru", 2, "fp32"),
        ("gru_flow:tick=banked", "gru_flow", 2, "fp32"),
        ("gru:tick=banked:K=0", "gru", 0, "fp32"),
        ("gru:tick=banked:K=0:int8=1", "gru", 0, "int8_pwl"),
    ]
    for label, name, k, precision in banked:
        spec = RecoverySpec(
            encoder=name,
            precision=precision,
            stream=StreamConfig(**{**_TINY_STREAM, "steps_per_tick": k}),
            tick=TickSpec(steps_per_tick=k, tick_kernel="banked"),
            **_TINY,
        )
        cells.append((label, spec))
    for label, tick_kernel in (("gru:control=device", "composite"),
                               ("gru:tick=banked:control=device", "banked")):  # fmt: skip
        cells.append((label, _device_spec("gru", tick_kernel, mesh=1, n_slots=2)))
    return cells


def _device_spec(encoder, tick_kernel, *, mesh, n_slots, control="device", fused=False):
    from repro_torch.api.spec import RecoverySpec, TickSpec
    from repro_torch.core.stream import StreamConfig

    tiny = {**_TINY, "n_slots": n_slots}
    return RecoverySpec(
        encoder=encoder,
        fused=fused,
        mesh_slots=mesh,
        stream=StreamConfig(**_TINY_STREAM),
        tick=TickSpec(
            steps_per_tick=_TINY_STREAM["steps_per_tick"],
            tick_kernel=tick_kernel,
            control=control,
            queue_capacity=2,
            snapshot_period=2,
            warm_capacity=4,
        ),
        **tiny,
    )


def _mesh_cells(n_devices: int):
    """The slot-mesh cells (R5 binds on them), each a (label, spec) pair and
    the restored cell: the plan the supervisor compiles after it loses half of
    a mesh of ``2 * n_devices`` (``runtime.replan_spec``)."""
    from repro_torch.runtime import replan_spec

    cells = [
        (f"gru:fused=1:mesh={n_devices}",
         _device_spec("gru", "composite", mesh=n_devices, n_slots=2, control="host", fused=True)),
        (f"gru:tick=banked:mesh={n_devices}",
         _device_spec("gru", "banked", mesh=n_devices, n_slots=2, control="host", fused=True)),
        (f"gru:control=device:mesh={n_devices}",
         _device_spec("gru", "composite", mesh=n_devices, n_slots=2, fused=True)),
    ]  # fmt: skip
    big = 2 * n_devices
    spec = _device_spec("gru", "composite", mesh=big, n_slots=big, fused=True)
    respec = replan_spec(spec, n_devices)
    assert respec.mesh_slots == n_devices, respec.mesh_slots
    cells.append((f"gru:control=device:restored:mesh={big}->{n_devices}", respec))
    return cells


def _parse_rules(arg: str) -> tuple[str, ...]:
    out = tuple(r.strip() for r in arg.split(",") if r.strip())
    unknown = [r for r in out if r not in R.RULES]
    if unknown:
        raise SystemExit(f"unknown rule id(s) {unknown}; known: {sorted(R.RULES)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Hardware-contract audit of compiled RecoveryPlans.",
    )
    ap.add_argument("--matrix", action="store_true", help="audit the spec matrix")
    ap.add_argument("--error-rules", default="R1,R2,R3,R4,R5", type=_parse_rules,
                    help="comma-separated rules whose findings fail the run (exit 1)")  # fmt: skip
    ap.add_argument("--warn-rules", default="", type=_parse_rules,
                    help="comma-separated rules whose findings only warn")  # fmt: skip
    ap.add_argument("--json", default=None, help="write all cells and findings here")
    ap.add_argument("--mesh-devices", type=int, default=2,
                    help="slots shards of the mesh cells, the device listed that many times "
                         "(0 = skip the mesh cells)")  # fmt: skip
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    if not args.matrix:
        ap.error("nothing to do: pass --matrix")
    active = tuple(dict.fromkeys(args.error_rules + args.warn_rules))
    device = rt.resolve_device(args.device, "audit")

    from repro_torch.api.plan import compile_plan

    cells = list(_matrix_specs())
    if args.mesh_devices and "R5" in active:
        cells += _mesh_cells(args.mesh_devices)
    out, n_err, n_warn = [], 0, 0
    for label, spec in cells:
        devices = [device] * spec.mesh_slots if spec.mesh_slots > 1 else None
        report = audit_plan(compile_plan(spec, device=device, devices=devices), rules=active)
        out.append({"cell": label, **report.to_json()})
        for f in report.findings:
            if f.rule in args.error_rules:
                n_err += 1
                print(f"ERROR {label} {f}")
            else:
                n_warn += 1
                print(f"WARN  {label} {f}")
        print(f"{label}: {report.verdict}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"rules": R.RULES, "cells": out}, fh, indent=2)
        print(f"wrote {args.json} ({len(out)} cells)")
    print(f"audit matrix: {len(out)} cells, {n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
