"""The port's supervised restarts against the JAX package.

- the ``ServiceSupervisor`` drill of ``tests/test_runtime.py:143`` (a
  2-shard device-plane service loses one shard at tick 3 and restores onto
  the surviving mesh of 1) beside JAX's drill, run in-process (JAX sees one
  CPU device twice, ``jax.devices`` patched, and places nothing; the port's
  cold starts carried from JAX's keys): restarts, final mesh, every
  incarnation's ticks and mesh, the result set and the eviction records
  equal, ``recovered_streams_fraction`` 1.0, Theta within 1e-3;
- a same-mesh restore (``kill_shard_once(t, n_lost=0)``) at mesh 1 and at
  mesh 2: every result bit for bit the same run's without chaos;
- a kill before the first snapshot: every stream resubmitted from its first
  ``buf_len`` samples onto the mesh of 1, bit for bit a mesh-1 run;
- ``keep`` reaches the supervisor's checkpointer;
- a snapshot written by JAX's 2-shard service restored into the port's
  mesh-2 service with its control state taken: every leaf equal, each
  shard's part on its device;
- the training ``Supervisor`` against JAX's on a toy least-squares step
  (``SimulatedFailure(0)`` at step 5, ``save_every=2``): ``final_step`` and
  ``restarts`` equal, the history's losses within 1e-6;
- ``serve_mr --device cpu --control device --mesh 2 --virtual-devices 2
  --chaos-kill-shard 3`` end to end at tiny widths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import stream as jstream
from repro.core.merinda import MRConfig as JMRConfig
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.runtime import ServiceSupervisor as JServiceSupervisor
from repro.runtime import Supervisor as JSupervisor
from repro.runtime import kill_shard_once as jkill_shard_once
from repro.runtime.supervisor import SimulatedFailure as JSimulatedFailure
from repro.runtime.supervisor import SupervisorConfig as JSupervisorConfig
from repro_torch import api, convert
from repro_torch.core import stream
from repro_torch.core.stream import StreamConfig
from repro_torch.launch import serve_mr
from repro_torch.runtime import ServiceSupervisor, SimulatedFailure, Supervisor, kill_shard_once
from repro_torch.runtime.supervisor import SupervisorConfig
from repro_torch.tree import tree_leaves

BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
# tests/test_runtime.py:143's drill: budget-only eviction after 4 ticks of K = 8
DRILL = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=32,
             delta_tol=0.0)  # fmt: skip
DRILL_TICK = dict(steps_per_tick=8, control="device", queue_capacity=8, snapshot_period=1,
                  warm_capacity=8)  # fmt: skip
N_STREAMS = 6


@pytest.fixture(scope="module")
def fleet() -> np.ndarray:
    return np.stack([jgenerate("lorenz", n_samples=400, noise_std=0.01, seed=i)[1]
                     for i in range(N_STREAMS)]).astype(np.float32)  # fmt: skip


@pytest.fixture
def two_jax_devices(monkeypatch):
    """JAX sees its one CPU device twice and builds no mesh: its 2-shard
    service then runs every shard's numerics on that device."""
    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev, dev])
    monkeypatch.setattr(jax, "make_mesh", lambda *a, **k: None)


def _carry_jax_cold_starts(monkeypatch):
    jcfg = JMRConfig(encoder="gru", **BASE)
    jkey = jax.random.key(0)

    def jax_cold_start(seed, stream_id, cfg, device):
        p, o = jstream.cold_start(jax.random.fold_in(jkey, 1000 + stream_id), jcfg)
        return (convert.params_from_numpy(jax.tree.map(np.asarray, p), device),
                convert.opt_from_numpy(jax.tree.map(np.asarray, o), device))  # fmt: skip

    monkeypatch.setattr(stream, "cold_start", jax_cold_start)


def _spec(mesh_slots, **tick_kw):
    return api.RecoverySpec(mode="stream", n_slots=4, stream=StreamConfig(**DRILL), seed=0,
                            mesh_slots=mesh_slots, tick=api.TickSpec(**DRILL_TICK, **tick_kw),
                            **BASE)  # fmt: skip


def _records(out) -> dict:
    return {sid: (r.steps, r.reason) for sid, r in out["results"].items()}


# ---------------------------------------------------------------------------
# the service drill against JAX's
# ---------------------------------------------------------------------------
def test_service_supervisor_drill_matches_jax(tmp_path, fleet, monkeypatch, two_jax_devices):
    """A 2-shard device-plane service loses one shard at tick 3; both
    supervisors restore the tick-2 snapshot onto the mesh of 1 and finish
    every stream."""
    _carry_jax_cold_starts(monkeypatch)
    jspec = japi.RecoverySpec(mode="stream", n_slots=4, stream=jstream.StreamConfig(**DRILL), seed=0,
                              mesh_slots=2, tick=japi.TickSpec(**DRILL_TICK), **BASE)  # fmt: skip
    jsup = JServiceSupervisor(jspec, str(tmp_path / "jax"), checkpoint_period=2,
                              chaos=jkill_shard_once(3, n_lost=1))  # fmt: skip
    jout = jsup.serve(fleet, max_ticks=60)
    sup = ServiceSupervisor(_spec(2), str(tmp_path / "port"), checkpoint_period=2,
                            chaos=kill_shard_once(3, n_lost=1), devices=["cpu", "cpu"])  # fmt: skip
    out = sup.serve(fleet, max_ticks=60)
    for o in (out, jout):
        assert o["restarts"] == 1 and o["final_mesh"] == (1,), o
        assert o["recovered_streams_fraction"] == 1.0
        assert set(o["results"]) == set(range(N_STREAMS))
    assert out["ticks"] == jout["ticks"]
    assert _records(out) == _records(jout)
    incarnations = lambda s: [(h["ticks"], h["mesh_shape"], h["sync_log"]) for h in s.history]
    assert incarnations(sup) == incarnations(jsup)
    assert out["counters"]["reshards"] == 1 and sup.devices == [torch.device("cpu")]
    for sid in range(N_STREAMS):
        np.testing.assert_allclose(out["results"][sid].theta, jout["results"][sid].theta,
                                   rtol=1e-3, atol=1e-3)  # fmt: skip


# ---------------------------------------------------------------------------
# restores that must replay exactly
# ---------------------------------------------------------------------------
def _drill(tmp_path, fleet, mesh_slots, chaos=None):
    sup = ServiceSupervisor(_spec(mesh_slots), str(tmp_path), checkpoint_period=2, chaos=chaos,
                            devices=["cpu"] * mesh_slots)  # fmt: skip
    return sup, sup.serve(fleet, max_ticks=60)


@pytest.mark.parametrize("mesh_slots", [1, 2])
def test_same_mesh_restore_is_bit_for_bit(tmp_path, fleet, mesh_slots):
    """A failure that loses no device at tick 5 restores the tick-4 snapshot
    onto the same mesh: the replay gives every stream the result of the run
    without chaos, bit for bit."""
    _, plain = _drill(tmp_path / "plain", fleet, mesh_slots)
    sup, out = _drill(tmp_path / "chaos", fleet, mesh_slots, kill_shard_once(5, n_lost=0))
    assert out["restarts"] == 1 and out["final_mesh"] == plain["final_mesh"] == (mesh_slots,)
    assert out["ticks"] == plain["ticks"] + 1  # the tick since the snapshot, replayed
    assert _records(out) == _records(plain)
    for sid, res in plain["results"].items():
        for field in ("theta", "mean", "scale"):
            np.testing.assert_array_equal(getattr(out["results"][sid], field), getattr(res, field))


def test_kill_before_the_first_snapshot_resubmits_every_history(tmp_path, fleet):
    """A shard lost before the first tick leaves no snapshot: every stream
    restarts from its first ``buf_len`` samples on the mesh of 1, as a mesh-1
    run from the start, bit for bit."""
    _, plain = _drill(tmp_path / "plain", fleet, 1)
    sup, out = _drill(tmp_path / "chaos", fleet, 2, kill_shard_once(0, n_lost=1))
    assert out["restarts"] == 1 and out["final_mesh"] == (1,) and sup.history[0]["ticks"] == 0
    assert out["ticks"] == plain["ticks"] and _records(out) == _records(plain)
    for sid, res in plain["results"].items():
        np.testing.assert_array_equal(out["results"][sid].theta, res.theta)


def test_service_supervisor_passes_keep_to_its_checkpointer(tmp_path, fleet):
    """``keep`` bounds the snapshots on disk: every 2 ticks over 6 ticks
    writes 3, and ``keep=1`` leaves the last."""
    sup = ServiceSupervisor(_spec(1), str(tmp_path), checkpoint_period=2, keep=1, devices=["cpu"])
    out = sup.serve(fleet, max_ticks=6)
    sup.service.checkpointer.wait()
    assert out["ticks"] == 6 and sup.service.checkpointer.manager.keep == 1
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000006"]


def test_budget_exhausted_and_no_survivors_raise(tmp_path, fleet):
    sup = ServiceSupervisor(_spec(2), str(tmp_path / "a"), max_restarts=0,
                            chaos=kill_shard_once(0), devices=["cpu", "cpu"])  # fmt: skip
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        sup.serve(fleet, max_ticks=4)
    sup = ServiceSupervisor(_spec(2), str(tmp_path / "b"), chaos=kill_shard_once(0, n_lost=2),
                            devices=["cpu", "cpu"])  # fmt: skip
    with pytest.raises(RuntimeError, match="no surviving devices"):
        sup.serve(fleet, max_ticks=4)
    with pytest.raises(ValueError, match="stream plans"):
        ServiceSupervisor(api.RecoverySpec(**BASE), str(tmp_path / "c"), devices=["cpu"])


# ---------------------------------------------------------------------------
# a JAX 2-shard snapshot restored into the port's mesh-2 service
# ---------------------------------------------------------------------------
def test_a_jax_mesh2_snapshot_restores_into_the_port_mesh2_service(tmp_path, fleet, two_jax_devices):
    jdir = tmp_path / "jax"
    jspec = japi.RecoverySpec(mode="stream", n_slots=4, stream=jstream.StreamConfig(**DRILL), seed=0,
                              mesh_slots=2, **BASE,
                              tick=japi.TickSpec(**DRILL_TICK, checkpoint_period=2,
                                                 checkpoint_dir=str(jdir)))  # fmt: skip
    jsvc = japi.compile_plan(jspec).make_service()
    for sid in range(N_STREAMS):
        jsvc.submit(sid, fleet[sid, :32])
    jsvc.fill_slots()
    for t in range(2):
        jsvc.tick_once(np.stack([fleet[s % N_STREAMS, 32 + 8 * t : 40 + 8 * t] for s in range(4)]))
    jsvc.checkpointer.wait()
    assert jsvc.control.q_ids.shape == (2, 8)
    spec = _spec(2, checkpoint_period=2, checkpoint_dir=str(jdir))
    svc = api.compile_plan(spec, devices=["cpu", "cpu"]).make_service()
    info = svc.checkpointer.restore_into(svc)
    assert info["step"] == 2 and svc.ticks == 2 and svc.counters["reshards"] == 1
    assert info["resident"] == {int(i) for i in np.asarray(jsvc.state.stream_id) if i >= 0}
    assert info["queued"] == {int(i) for i in np.asarray(jsvc.control.q_ids).ravel() if i >= 0}
    assert len(info["queued"]) == 2  # the control state was taken
    for a, b in zip(tree_leaves(svc.state), jax.tree.leaves(jsvc.state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(svc.control), jax.tree.leaves(jsvc.control)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for shard, ctl in zip(svc.shards, svc.controls):
        assert all(leaf.shape[0] == 2 for leaf in tree_leaves(shard))
        assert all(leaf.shape[0] == 1 for leaf in tree_leaves(ctl))


# ---------------------------------------------------------------------------
# the training supervisor against JAX's
# ---------------------------------------------------------------------------
W_TRUE = np.array([1.0, -2.0, 0.5, 3.0], np.float32)


def _batch(step):
    rng = np.random.default_rng(step)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    return x, x @ W_TRUE + np.float32(0.01) * rng.normal(size=16).astype(np.float32)


def _fail_once(at, exc):
    fired = []

    def chaos(step):
        if step == at and not fired:
            fired.append(step)
            raise exc(0)

    return chaos


def test_training_supervisor_matches_jax(tmp_path):
    """A least-squares step under both supervisors, a failure that loses no
    device at step 5, checkpoints every 2 steps: the same final step and
    restarts, the history's losses within 1e-6."""
    lr = 0.05

    def jbuild(mesh):
        def step_fn(state, batch):
            x, y = (jnp.asarray(a) for a in batch)
            r = x @ state["w"] - y
            return {"w": state["w"] - lr * (2.0 / len(y)) * (x.T @ r)}, {"loss": jnp.mean(r * r)}

        return step_fn, None, lambda: {"w": jnp.zeros(4, jnp.float32)}

    def build(mesh):
        def step_fn(state, batch):
            x, y = (torch.from_numpy(a) for a in batch)
            r = x @ state["w"] - y
            return {"w": state["w"] - lr * (2.0 / len(y)) * (x.T @ r)}, {"loss": torch.mean(r * r)}

        return step_fn, None, lambda: {"w": torch.zeros(4)}

    jcfg = JSupervisorConfig(max_steps=10, save_every=2)
    jout = JSupervisor(jbuild, lambda s, m: _batch(s), str(tmp_path / "jax"), jcfg,
                       chaos=_fail_once(5, JSimulatedFailure)).run()  # fmt: skip
    out = Supervisor(build, lambda s, m: _batch(s), str(tmp_path / "port"),
                     SupervisorConfig(max_steps=10, save_every=2),
                     chaos=_fail_once(5, SimulatedFailure), devices=["cpu"]).run()  # fmt: skip
    assert (out["final_step"], out["restarts"]) == (jout["final_step"], jout["restarts"]) == (10, 1)
    assert out["final_mesh"] == jout["final_mesh"]
    assert [h["step"] for h in out["history"]] == [h["step"] for h in jout["history"]]
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in jout["history"]], rtol=1e-6, atol=1e-6)  # fmt: skip


# ---------------------------------------------------------------------------
# serve_mr's chaos path end to end
# ---------------------------------------------------------------------------
def test_serve_mr_mesh_chaos_runs_end_to_end_on_the_cpu(capsys):
    args = serve_mr.build_parser().parse_args(
        "--device cpu --control device --mesh 2 --virtual-devices 2 --chaos-kill-shard 3 "
        "--tick-kernel banked --streams 4 --slots 2 --hidden 8 --buf-len 48 --window 12 "
        "--stride 6 --chunk 8 --steps-per-tick 4 --min-steps 8 --max-steps 16".split()
    )
    out = serve_mr.serve(args)
    summary = out["supervisor"]
    assert summary["restarts"] == 1 and summary["final_mesh"] == (1,)
    assert summary["recovered_streams_fraction"] == 1.0 and len(out["rows"]) == 4
    assert out["plan"].lowering.mesh_shape == (1,) and out["service"].n_shards == 1
    printed = capsys.readouterr().out
    assert ("[serve_mr] chaos: 1 restart(s), final mesh (1,), recovered_streams_fraction=1.00"
            in printed)  # fmt: skip
