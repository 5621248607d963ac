"""The port's measured tuner (``repro_torch.analysis.tuner``) and
``compile_plan(tune=)`` against the JAX package's.

- the design space: the fused-against-unfused axis, the substep-unroll axis
  and the tick's bank sizes equal JAX's ``enumerate_candidates`` /
  ``enumerate_tick_candidates`` for the same spec (no JAX lowering needed);
  the static point leads the port's table;
- ``"static"`` chooses what ``auto_block_b`` / ``auto_slots_per_bank``
  choose; on the CPU ``"measured"`` ranks by the model and the roofline and
  times nothing (``measured_us`` None), and an unroll without an
  instantiation stays in the table unchosen;
- the cache: the key moves with the spec and the device kind, a warm tune
  times nothing (``n_lowered == 0``), a corrupted file warns and searches
  afresh;
- ``compile_plan``'s ``tune`` modes stamp ``Lowering``; a tuned plan's first
  training step equals the untuned one's, and so does one at
  ``substep_unroll=2`` (``tests/test_tuner.py:216``; the plain versions ignore
  the factor, and a plan refuses 2 for the LTC and NODE kernels, built for 1
  only); ``substep_unroll=0`` raises with JAX's message, an uninstantiated
  factor names the ones there are;
- ``--what-if`` replays the table; ``--smoke`` passes on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.analysis import tuner
from repro_torch.api import RecoverySpec, TickSpec, compile_plan
from repro_torch.core.stream import StreamConfig
from repro_torch.kernels.mr_step import tiling


def small_spec(**overrides) -> RecoverySpec:
    base = dict(state_dim=2, hidden=8, dense_hidden=16, encoder="gru_flow", fused=True,
                block_b="auto", mode="batch", batch_size=16, steps=4)  # fmt: skip
    base.update(overrides)
    return RecoverySpec(**base)


def stream_spec(**overrides) -> RecoverySpec:
    k = overrides.pop("steps_per_tick", 2)
    base = dict(state_dim=2, hidden=8, dense_hidden=16, encoder="gru", mode="stream", n_slots=4,
                stream=StreamConfig(buf_len=16, window=8, stride=8, chunk=8, steps_per_tick=k),
                tick=TickSpec(steps_per_tick=k, tick_kernel="banked"))  # fmt: skip
    base.update(overrides)
    return RecoverySpec(**base)


@pytest.fixture(autouse=True)
def cache_root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    return tmp_path / "tune"


def _jax_twin(spec):
    from repro import api as japi
    from repro.core.stream import StreamConfig as JStream

    kw = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    smem = kw.pop("smem_budget_bytes")
    if smem is not None:
        kw["vmem_budget_bytes"] = smem
    if spec.stream is not None:
        kw["stream"] = JStream(**dataclasses.asdict(spec.stream))
    if spec.tick is not None:
        kw["tick"] = japi.TickSpec(**dataclasses.asdict(spec.tick))
    return japi.RecoverySpec(**kw)


@pytest.mark.parametrize(
    "spec",
    [
        small_spec(),
        small_spec(encoder="ltc", ltc_substeps=4),
        small_spec(encoder="node", fused=False),
        small_spec(encoder="ltc", substep_unroll=2),
        small_spec(encoder="gru", precision="int8_pwl"),
        stream_spec(),
        stream_spec(steps_per_tick=0, precision="int8_pwl"),
        stream_spec(encoder="ltc", tick=TickSpec(steps_per_tick=2, tick_kernel="auto")),
    ],
    ids=["gru_flow", "ltc4", "node_unfused", "ltc_u2", "gru_int8", "stream_banked",
         "stream_int8_monitor", "stream_ltc_auto"],  # fmt: skip
)
def test_design_space_equals_jax(spec):
    from repro.analysis import tuner as jtuner

    mine, theirs = tuner.enumerate_candidates(spec), jtuner.enumerate_candidates(_jax_twin(spec))
    axes = lambda cs: ({c.fused for c in cs}, {c.substep_unroll for c in cs})  # noqa: E731
    assert axes(mine) == axes(theirs)
    assert {(c.fused, c.substep_unroll) for c in mine} == {
        (c.fused, c.substep_unroll) for c in theirs}  # fmt: skip
    banks = lambda cs: [c.slots_per_bank for c in cs]  # noqa: E731
    assert banks(tuner.enumerate_tick_candidates(spec)) == banks(
        jtuner.enumerate_tick_candidates(_jax_twin(spec)))  # fmt: skip
    assert mine[0] == tuner.static_candidate(spec)
    assert len(set(mine)) == len(mine)


def test_static_chooses_the_static_policy():
    spec = stream_spec(n_slots=8, fused=True, block_b="auto")
    report = tuner.tune(spec, mode="static")
    cfg, scfg = spec.to_mr_config(), spec.stream_config()
    bb = tiling.auto_block_b(cfg, "gru", scfg.n_windows, slots=8)
    assert report.chosen.candidate == tuner.Candidate(block_b=bb, fused=True)
    assert report.chosen_tick.candidate.slots_per_bank == tiling.auto_slots_per_bank(cfg, scfg, 8)
    assert report.budget_source == "default" and report.n_lowered == 0
    assert all(s.measured_us is None and s.t_step_us is None for s in report.candidates)


def test_measured_on_the_cpu_ranks_by_the_model(cache_root):
    spec = small_spec(encoder="ltc", ltc_substeps=4)
    report = tuner.tune(spec, mode="measured")
    assert report.device_kind == "cpu" and not report.cache_hit
    assert all(s.measured_us is None and s.parsed_bytes is None for s in report.candidates)
    ranked = [s for s in report.candidates if s.t_step_us is not None]
    assert ranked == report.candidates[: len(ranked)]
    # unrolls 2 and 4 have no instantiation: scored, never lowered nor chosen
    built = tiling.SUBSTEP_UNROLLS
    unbuilt = [s for s in report.candidates if s.candidate.substep_unroll not in built]
    assert {s.candidate.substep_unroll for s in unbuilt} == {2, 4}
    assert all(s.t_step_us is None for s in unbuilt)
    assert report.chosen.candidate.substep_unroll in tiling.SUBSTEP_UNROLLS
    lowerable = len(report.candidates) - len(unbuilt)
    assert report.n_lowered == min(lowerable, tuner.MAX_LOWERED)
    assert report.n_dropped == len(report.candidates) - report.n_lowered
    # at equal roofline the largest tile that keeps every window's block busy wins
    assert report.chosen.candidate.block_b == tiling.auto_block_b(
        spec.to_mr_config(), "ltc", 16)  # fmt: skip
    assert (cache_root / f"{report.cache_key}.json").exists()


def test_cache_key_moves_with_the_spec():
    a = small_spec()
    assert tuner.tune_cache_key(a, "cpu") == tuner.tune_cache_key(small_spec(), "cpu")
    for other in (small_spec(hidden=16), small_spec(batch_size=12), small_spec(substep_unroll=2)):
        assert tuner.tune_cache_key(other, "cpu") != tuner.tune_cache_key(a, "cpu")
    assert tuner.tune_cache_key(a, "NVIDIA H100 80GB HBM3") != tuner.tune_cache_key(a, "cpu")
    s = stream_spec()
    assert tuner.tune_cache_key(s, "cpu", (1,)) != tuner.tune_cache_key(s, "cpu", (2,))


def test_warm_tune_times_nothing_and_a_corrupted_cache_searches_afresh(cache_root):
    spec = stream_spec()
    cold = tuner.tune(spec)
    assert cold.n_lowered == len(cold.candidates) + len(cold.tick_candidates) > 0
    warm = tuner.tune(spec)
    assert warm.cache_hit and warm.n_lowered == 0
    assert warm.chosen == cold.chosen and warm.chosen_tick == cold.chosen_tick
    (cache_root / f"{cold.cache_key}.json").write_text("{not json")
    with pytest.warns(UserWarning, match="corrupted"):
        again = tuner.tune(spec)
    assert not again.cache_hit and again.n_lowered == cold.n_lowered
    doc = json.loads((cache_root / f"{cold.cache_key}.json").read_text())
    doc.pop("chosen")
    (cache_root / f"{cold.cache_key}.json").write_text(json.dumps(doc))
    with pytest.warns(UserWarning, match="unreadable payload"):
        assert not tuner.tune(spec).cache_hit


def test_compile_plan_tune_modes_stamp_lowering():
    spec = stream_spec(fused=True, block_b="auto")
    off = compile_plan(spec, device="cpu").lowering
    assert off.tuned is None and off.tune_cache_key is None and off.substep_unroll == 1
    assert off.smem_budget_source == "default"
    static = compile_plan(spec, device="cpu", tune="static").lowering
    assert static.tuned == "static" and static.block_b == off.block_b
    assert static.tick_slots_per_bank == off.tick_slots_per_bank
    assert static.predicted_bytes == tiling.config_smem_bytes(spec.to_mr_config(), "gru",
                                                              off.block_b)  # fmt: skip
    cold = compile_plan(spec, device="cpu", tune="measured").lowering
    warm = compile_plan(spec, device="cpu", tune="measured").lowering
    assert (cold.tuned, warm.tuned) == ("measured", "measured:cached")
    assert cold.tune_cache_key == warm.tune_cache_key == tuner.tune_cache_key(spec, "cpu")
    assert cold.measured_bytes is None  # no carve without the kernel library
    with pytest.raises(ValueError, match=r"tune must be one of \('off', 'static', 'measured'\)"):
        compile_plan(spec, device="cpu", tune="fast")


def _first_step(plan, seed=0):
    from repro_torch.core import engine
    from repro_torch.core.merinda import init_mr
    from repro_torch.optim import adamw_init

    rng = np.random.default_rng(seed)
    ys = torch.from_numpy(rng.standard_normal((8, 12, 2)).astype(np.float32) * 0.3)
    params = init_mr(torch.Generator().manual_seed(seed), plan.cfg, "cpu")
    params, _, aux = engine.mr_train_step(params, adamw_init(params), plan.cfg, ys, None, 1e-3,
                                          None)  # fmt: skip
    return params, aux


@pytest.mark.parametrize("encoder", ["gru_flow", "ltc", "node"])
def test_tuned_first_step_equals_untuned(encoder):
    spec = small_spec(encoder=encoder, ltc_substeps=6, mode="offline", batch_size=8)
    untuned = compile_plan(spec, device="cpu")
    base = _first_step(untuned)
    # the plain versions take the unroll and ignore it; the LTC and NODE
    # kernels are built for an unroll of 1 only, so a plan refuses 2 there
    unrolled = SimpleNamespace(cfg=dataclasses.replace(untuned.cfg, substep_unroll=2))
    for plan in (compile_plan(spec, device="cpu", tune="measured"), unrolled):
        got = _first_step(plan)
        for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(base)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    at_two = dataclasses.replace(spec, substep_unroll=2)
    if encoder in tiling.UNROLLED_FAMILIES:
        with pytest.raises(ValueError, match=r"substep_unroll=2 has no instantiation"):
            compile_plan(at_two, device="cpu")
    else:
        assert compile_plan(at_two, device="cpu").cfg.substep_unroll == 2


def test_substep_unroll_refusals():
    from repro.api import RecoverySpec as JSpec

    with pytest.raises(ValueError) as mine:
        small_spec(substep_unroll=0)
    with pytest.raises(ValueError) as theirs:
        JSpec(state_dim=2, substep_unroll=0)
    assert str(mine.value) == str(theirs.value) == "substep_unroll must be >= 1, got 0"
    with pytest.raises(ValueError, match=r"substep_unroll=3 has no instantiation .* \(1,\)"):
        compile_plan(small_spec(encoder="ltc", substep_unroll=3), device="cpu")
    # a family whose kernel takes no factor accepts any
    assert compile_plan(small_spec(substep_unroll=3), device="cpu").lowering.substep_unroll == 3


def test_what_if_replays_the_table(tmp_path, capsys):
    dest = tmp_path / "report.json"
    rc = tuner.main(["--what-if", "--tune", "measured", "--encoder", "ltc", "--fused",
                     "--batch", "12", "--device", "cpu", "--json", str(dest)])  # fmt: skip
    assert rc == 0
    out = capsys.readouterr().out
    assert "tune[measured]" in out and "block_b" in out and "unroll=2" in out
    doc = json.loads(dest.read_text())
    assert doc["mode"] == "measured" and doc["candidates"] and doc["device_kind"] == "cpu"
    assert tuner.main(["--what-if", "--tune", "static", "--batch", "16", "--device", "cpu",
                       "--no-cache"]) == 0  # fmt: skip
    assert "tune[static]" in capsys.readouterr().out


def test_smoke_cli_on_the_cpu(capsys):
    assert tuner.main(["--smoke", "--device", "cpu"]) == 0
    assert "warm compiles hit the cache" in capsys.readouterr().out
