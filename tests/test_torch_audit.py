"""The port's plan auditor (``repro_torch.analysis``) against the JAX package's.

- each rule R1-R5 finds a violation planted in a program and gives its
  vacuity finding where it has one: a replaced state kept alive (R1), a
  carve off the model by one float (R2), an ``.item()`` and a ``nonzero`` in a
  tick (R3), int8 weights widened to float32 on their way to the kernel
  (R4), a tick reading another shard's storage (R5);
- every cell of the ``--matrix`` audits clean on the CPU (R2, which needs the
  kernel library, is absent from ``checked`` there), the CLI exits 0;
- on three cells (offline ``gru_flow`` fused, the K = 0 int8 banked monitor,
  the device plane) the rules and programs checked are JAX's
  ``audit_plan(...).checked`` minus R2 (the port's int8 monitor also holds
  the tick's ``mr_tick_int8`` operands to R4);
- ``compile_plan``'s ``audit`` modes stamp the verdict, warn once a finding
  or raise ``AuditError``, and refuse an unknown mode with JAX's message.

Shapes are JAX's ``_TINY`` (``repro/analysis/audit.py:390-391``).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.analysis import audit, rules, trace
from repro_torch.api import RecoverySpec, TickSpec, compile_plan
from repro_torch.core import quant, stream
from repro_torch.core.stream import StreamConfig
from repro_torch.kernels.mr_step import ops as mr_ops
from repro_torch.kernels.mr_step import tiling

TINY = audit._TINY
TINY_STREAM = audit._TINY_STREAM
OFFLINE = dict(TINY, mode="offline", steps=4, batch_size=8)
del OFFLINE["n_slots"]


def cell(label: str) -> RecoverySpec:
    return dict(audit._matrix_specs())[label]


# -- R1 ------------------------------------------------------------------------
KEPT: list = []


def test_r1_finds_a_replaced_state_kept_alive(monkeypatch):
    real = stream.tick

    def hoarding_tick(state, *args, **kw):
        KEPT.append(state)  # the old state outlives its replacement
        return real(state, *args, **kw)

    monkeypatch.setattr(stream, "tick", hoarding_tick)
    try:
        report = audit.audit_plan(compile_plan(cell("gru:fused=0:int8=0"), device="cpu"))
    finally:
        KEPT.clear()
    kept = [f for f in report.findings if f.rule == "R1"]
    assert kept and all(f.program == "tick" for f in kept)
    assert {"state.buf_y", "state.theta"} <= {f.op for f in kept}
    assert "state.mean" not in {f.op for f in kept}  # passed through: an output's storage
    assert report.verdict == "fail:R1"


def test_r1_vacuity_when_nothing_is_replaced():
    t = trace.observe("tick", lambda state: state, [None], donated={"state": 0})
    (f,) = rules.check_no_copy_kept("tick", t, ("state",))
    assert f.rule == "R1" and "vacuous" in f.message


def test_r1_passes_state_reused_in_place():
    def in_place(state):
        state.add_(1.0)
        return state

    t = trace.observe("tick", in_place, [torch.zeros(3)], donated={"state": 0})
    assert t.donated == ["state"] and not rules.check_no_copy_kept("tick", t, ("state",))


# -- R2 ------------------------------------------------------------------------
def test_r2_finds_a_carve_off_by_one_float():
    cfg = cell("ltc:fused=1:int8=0").to_mr_config()
    model = tiling.config_smem_bytes(cfg, "ltc", 2)
    assert not rules.check_residency("fused_step", model, model, "ltc")
    (f,) = rules.check_residency("fused_step", model, model + 4, "ltc")
    assert f.rule == "R2" and f.expected.startswith(f"{model} B")
    (f,) = rules.check_residency("fused_step", 0, 0)
    assert "nonpositive" in f.message
    assert not rules.check_recorded_carve("fused_step", model, model)
    (f,) = rules.check_recorded_carve("fused_step", model, model + 4)
    assert f.rule == "R2" and "measured_bytes" in f.message


def test_r2_holds_a_tuned_plan_to_the_model(monkeypatch):
    # a launcher whose carve drifted one float from the model, and a measured
    # tune that recorded the drifted carve: the model still finds it
    from repro_torch.analysis import tuner
    from repro_torch.kernels import runtime as rt

    plan = compile_plan(cell("ltc:fused=1:int8=0"), device="cpu")
    cfg = plan.cfg
    dims = (cfg.state_dim + cfg.input_dim, cfg.hidden, cfg.dense_hidden, cfg.n_coef + cfg.n_shifts)
    bb = tuner.step_tile(plan.spec, plan.lowering.block_b)
    model = tiling.family_smem_bytes("ltc", *dims, bb)
    plan.lowering = dataclasses.replace(plan.lowering, tuned="measured", measured_bytes=model + 4)
    monkeypatch.setattr(audit, "_carve_available", lambda plan: True)
    monkeypatch.setattr(rt, "kernel_smem_bytes", lambda kernel, *dims: model + 4)
    report = audit.audit_plan(plan, rules=("R2",))
    assert [(f.rule, f.expected) for f in report.findings] == [("R2", f"{model} B (the ltc model)")]
    assert report.verdict == "fail:R2"


def test_r2_is_absent_on_the_cpu():
    report = audit.audit_plan(compile_plan(cell("gru:tick=banked:K=0"), device="cpu"))
    assert report.ok and "R2" not in report.checked


# -- R3 ------------------------------------------------------------------------
def test_r3_finds_item_and_nonzero_in_a_tick(monkeypatch):
    real = stream.tick

    def waiting_tick(state, *args, **kw):
        out = real(state, *args, **kw)
        if out.loss.sum().item() > 0:  # a Python branch on a device value
            torch.nonzero(out.active)
        return out

    monkeypatch.setattr(stream, "tick", waiting_tick)
    report = audit.audit_plan(compile_plan(cell("gru:fused=0:int8=0"), device="cpu"))
    ops = {f.op for f in report.findings if f.rule == "R3"}
    assert ops == {"_local_scalar_dense", "nonzero"}
    assert report.verdict == "fail:R3"


@pytest.mark.parametrize(
    "form, op, what",
    [("factory", "tensor", "a blocking copy to the device"),
     ("blocking", "_to_copy", "a blocking copy to the device"),
     ("pageable", "_to_copy", "from pageable memory")],
)  # fmt: skip
def test_r3_finds_a_blocking_copy_to_the_device(monkeypatch, form, op, what):
    # the epoch's lr metric made on the device from a host list (its old form,
    # "factory"), copied there blocking, or non-blocking from pageable memory;
    # the meta device stands in for the card
    from repro_torch.core import engine

    real = engine.run_epoch

    def epoch(*args, **kw):
        params, opt_state, metrics = real(*args, **kw)
        lrs = [1e-3] * len(metrics["lr"])
        if form == "factory":
            metrics["lr"] = torch.tensor(lrs, dtype=torch.float32, device="meta")
        else:
            metrics["lr"] = torch.tensor(lrs).to("meta", non_blocking=form == "pageable")
        return params, opt_state, metrics

    monkeypatch.setattr(engine, "run_epoch", epoch)
    report = audit.audit_plan(compile_plan(RecoverySpec(**OFFLINE), device="cpu"))
    (f,) = [f for f in report.findings if f.rule == "R3"]
    assert (f.program, f.op) == ("epoch", op) and what in f.actual
    assert report.verdict == "fail:R3"


def test_r3_allowlist_and_boolean_mask():
    t = trace.observe("tick", lambda x: x[x > 0], [torch.arange(-2.0, 3.0)])
    assert [w.detail for w in t.waits] == ["indexing with a boolean mask"]
    assert rules.check_host_transfers("tick", t)
    assert not rules.check_host_transfers("tick", t, allowlist=("boolean mask",))


# -- R4 ------------------------------------------------------------------------
def test_r4_finds_int8_weights_widened(monkeypatch):
    real = mr_ops.int8_weights

    def widened(params, cfg, batch_dims=0):
        return tuple(quant.Int8Quantized(q.values.to(torch.float32), q.scale)
                     for q in real(params, cfg, batch_dims))  # fmt: skip

    monkeypatch.setattr(mr_ops, "int8_weights", widened)
    report = audit.audit_plan(compile_plan(cell("gru:fused=0:int8=1"), device="cpu"))
    r4 = [f for f in report.findings if f.rule == "R4"]
    assert {f.op for f in r4} == {f"mr_step_int8.{w}" for w in ("wxq", "whq", "w1q", "w2q")}
    assert all(f.actual == "float32" and f.expected == "int8" for f in r4)


def test_r4_vacuity_when_the_kernel_is_never_reached():
    t = trace.observe("serving_int8", lambda x: x + 1, [torch.zeros(2)])
    found = rules.check_weight_dtypes("serving_int8", t, {"mr_step_int8": {"wxq": "int8"}})
    assert [f.actual for f in found] == ["not seen in any call"]


# -- R5 ------------------------------------------------------------------------
def test_r5_finds_a_cross_shard_read():
    spec = cell("gru:fused=0:int8=0")
    cfg, scfg = spec.to_mr_config(), spec.stream_config()
    mine, theirs = (stream.init_slots(s, cfg, scfg, 1, "cpu") for s in (0, 1))
    new = torch.zeros(1, scfg.chunk, cfg.state_dim), torch.zeros(1, scfg.chunk, 0)

    def nosy_tick(state, new_y, new_u):
        out = stream.tick(state, new_y, new_u, None, cfg=cfg, scfg=scfg)
        return out._replace(theta=out.theta + theirs.theta)  # another shard's readout

    foreign = [t for _, t in trace.named_leaves(theirs, "shard1")]
    t = trace.observe("tick", nosy_tick, [mine, *new], foreign=foreign)
    (f,) = rules.check_collectives("tick", t, rules.predict_tick_collectives(None))
    assert f.rule == "R5" and f.op == "foreign_read" and f.expected == "0 x foreign_read"
    clean = trace.observe("tick", lambda s, y, u: stream.tick(s, y, u, None, cfg=cfg, scfg=scfg),
                          [mine, *new], foreign=foreign)  # fmt: skip
    assert not rules.check_collectives("tick", clean, {})


# -- the matrix ----------------------------------------------------------------
def test_matrix_cli_every_cell_clean_on_the_cpu(tmp_path, capsys):
    dest = tmp_path / "findings.json"
    assert audit.main(["--matrix", "--device", "cpu", "--json", str(dest)]) == 0
    out = capsys.readouterr().out
    assert "0 error(s), 0 warning(s)" in out
    import json

    cells = json.loads(dest.read_text())["cells"]
    assert len(cells) == len(audit._matrix_specs()) + 4  # three mesh cells, one restored
    assert all(c["verdict"].startswith("pass:") and "R2" not in c["checked"] for c in cells)
    mesh = [c for c in cells if "mesh=" in c["cell"]]
    assert mesh and all("R5" in c["checked"] for c in mesh)


@pytest.mark.parametrize("label", ["offline:gru_flow:fused=1", "gru:tick=banked:K=0:int8=1",
                                   "gru:control=device"])
def test_checked_equals_jax_minus_r2(label):
    from repro.analysis import audit as jaudit
    from repro.api import RecoverySpec as JSpec
    from repro.api.plan import compile_plan as jcompile

    if label.startswith("offline"):
        spec = RecoverySpec(encoder="gru_flow", fused=True, **OFFLINE)
        jspec = JSpec(encoder="gru_flow", fused=True, **OFFLINE)
    else:
        spec, jspec = cell(label), dict(jaudit._matrix_specs())[label]
    mine = audit.audit_plan(compile_plan(spec, device="cpu"))
    theirs = jaudit.audit_plan(jcompile(jspec))
    want = {r: p for r, p in theirs.checked.items() if r != "R2"}
    assert mine.ok and theirs.ok
    assert set(mine.checked) == set(want), (mine.checked, want)
    for r, programs in want.items():
        extra = set(mine.checked[r]) - set(programs)
        assert set(programs) <= set(mine.checked[r])
        assert extra <= ({"tick"} if r == "R4" else set()), (r, extra)


# -- compile_plan(audit=) --------------------------------------------------------
def test_compile_plan_audit_modes(monkeypatch):
    spec = cell("gru:tick=banked:K=0:int8=1")
    assert compile_plan(spec, device="cpu").lowering.audit is None
    plan = compile_plan(spec, device="cpu", audit="error")
    assert plan.lowering.audit == "pass:R1,R3,R4"
    with pytest.raises(ValueError, match=r"audit must be one of \('off', 'warn', 'error'\)"):
        compile_plan(spec, device="cpu", audit="strict")

    real = stream.tick_banked

    def waiting(state, *args, **kw):
        out = real(state, *args, **kw)
        out[0].delta.max().item()
        return out

    monkeypatch.setattr(stream, "tick_banked", waiting)
    with pytest.raises(audit.AuditError, match=r"\[R3\] tick @ _local_scalar_dense"):
        compile_plan(spec, device="cpu", audit="error")
    with pytest.warns(UserWarning, match="plan audit: .R3."):
        plan = compile_plan(spec, device="cpu", audit="warn")
    assert plan.lowering.audit == "fail:R3"
    assert dataclasses.replace(plan.lowering, audit=None) == compile_plan(spec, device="cpu").lowering


def test_spec_fields_of_the_audit_cells():
    # the matrix's device-plane cells carry JAX's tick geometry
    spec = cell("gru:tick=banked:control=device")
    assert spec.tick == TickSpec(steps_per_tick=2, tick_kernel="banked", control="device",
                                 queue_capacity=2, snapshot_period=2, warm_capacity=4)  # fmt: skip
    assert spec.stream == StreamConfig(**TINY_STREAM)
