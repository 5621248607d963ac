"""The port's slot mesh (``mesh_slots > 1``) and elastic planning against the
JAX package.

- ``plan_mesh``, ``plan_mesh_slots`` and ``shrink_plan`` equal JAX's on a
  grid of device counts, model and data sizes and slot counts, errors
  included; ``build_mesh`` refuses a plan beyond its devices;
- the spec's and the plan's refusals carry JAX's messages
  (``tests/test_api.py:61-63``, ``:118``);
- the host plane at mesh 2 (two CPU entries) against mesh 1 on
  ``tests/test_api.py:422``'s scenario: Theta within 1e-5 (it is 0: the
  plain versions are per slot), each shard's leaves on its mesh device with
  S/M slots, one heartbeat a shard, the same sync counts;
- a minibatch (``batch_size``) tick at mesh 2 equal to mesh 1 bit for bit:
  the indices come from the service's one generator;
- ``fused`` (the slot-axis ``mr_step`` a shard) and ``int8_pwl`` (each
  eviction read out through ``mr_step_int8`` on its shard's row) services
  at mesh 2 against mesh 1: the same results, Theta within 1e-5; the fused
  tile fitted to a shard's S/M slots;
- the device plane at mesh 2 in lockstep with JAX's 2-shard device plane
  (JAX sees one CPU device twice, ``jax.devices`` patched, and places
  nothing: "numerics are identical either way", ``repro/core/stream.py``):
  slot maps, eviction records and ``sync_log`` equal, Theta within 1e-3;
  and on ``tests/test_tick.py:360``'s arrivals, where JAX's least-loaded
  queue admits otherwise than mesh 1, the port's slot maps JAX's and every
  stream's result mesh 1's.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import stream as jstream
from repro.core.merinda import MRConfig as JMRConfig
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.runtime import elastic as jelastic
from repro_torch import api, convert
from repro_torch.core import stream
from repro_torch.core.stream import StreamConfig
from repro_torch.runtime import elastic
from repro_torch.tree import tree_leaves

BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
CCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=16,
            delta_tol=0.0)  # fmt: skip


@functools.lru_cache(maxsize=1)
def _lorenz() -> np.ndarray:
    _, ys, _ = jgenerate("lorenz", n_samples=400)
    return np.asarray(ys, np.float32)


@pytest.fixture
def two_jax_devices(monkeypatch):
    """JAX sees its one CPU device twice and builds no mesh: its 2-shard
    service then runs every shard's numerics on that device."""
    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev, dev])
    monkeypatch.setattr(jax, "make_mesh", lambda *a, **k: None)


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", str(e))


# ---------------------------------------------------------------------------
# elastic planning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 3, 7, 16, 48, 512])
@pytest.mark.parametrize("model,max_data,pods", [(16, 16, 1), (16, 16, 2), (4, 8, 1), (2, 2, 3)])
def test_plan_mesh_matches_jax(n, model, max_data, pods):
    got = _outcome(elastic.plan_mesh, n, model=model, max_data=max_data, pods=pods)
    want = _outcome(jelastic.plan_mesh, n, model=model, max_data=max_data, pods=pods)
    if got[0] == "ok":
        got = ("ok", (got[1].shape, got[1].axes, got[1].n_devices))
        want = ("ok", (want[1].shape, want[1].axes, want[1].n_devices))
    assert got == want


@pytest.mark.parametrize("n_available", [0, 1, 2, 3, 5, 8])
@pytest.mark.parametrize("n_slots", [0, 1, 4, 6, 7])
def test_plan_mesh_slots_matches_jax(n_available, n_slots):
    got = _outcome(elastic.plan_mesh_slots, n_available, n_slots)
    want = _outcome(jelastic.plan_mesh_slots, n_available, n_slots)
    if got[0] == "ok":
        got, want = ("ok", (got[1].shape, got[1].axes)), ("ok", (want[1].shape, want[1].axes))
    assert got == want


@pytest.mark.parametrize("shape,n_failed", [((2, 16, 16), 16), ((16, 16), 8), ((4, 2), 3), ((2, 2), 3)])
def test_shrink_plan_matches_jax(shape, n_failed):
    axes = ("pod", "data", "model")[-len(shape) :]
    got = _outcome(elastic.shrink_plan, elastic.MeshPlan(shape, axes), n_failed)
    want = _outcome(jelastic.shrink_plan, jelastic.MeshPlan(shape, axes), n_failed)
    if got[0] == "ok":
        got, want = ("ok", got[1].shape), ("ok", want[1].shape)
    assert got == want


def test_build_mesh_lays_out_the_plan_and_refuses_too_few_devices():
    mesh = elastic.build_mesh(elastic.MeshPlan((2,), ("slots",)), ["cpu", "cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.shape == (2,) and mesh.size == 2
    train = elastic.build_mesh(elastic.plan_mesh(4, model=2), ["cpu"] * 4)
    assert (train.shape, train.axis_names) == ((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="plan needs 2 devices, have 1"):
        elastic.build_mesh(elastic.MeshPlan((2,), ("slots",)), ["cpu"])


# ---------------------------------------------------------------------------
# spec and plan refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(mode="stream", n_slots=3, mesh_slots=2),
                                dict(mode="offline", mesh_slots=2),
                                dict(mode="batch", mesh_slots=3),
                                dict(mode="stream", n_slots=4, mesh_slots=0)])  # fmt: skip
def test_spec_refusals_carry_jax_messages(kw):
    got = _outcome(api.RecoverySpec, state_dim=3, **kw)
    want = _outcome(japi.RecoverySpec, state_dim=3, **kw)
    assert got[0] == want[0] == "error" and got[1] == want[1]


def test_plan_refuses_more_shards_than_devices():
    """As ``tests/test_api.py:118``: a mesh of 4 on the devices given (one,
    then three) raises; two entries of one device hold a mesh of 2."""
    spec = api.RecoverySpec(mode="stream", n_slots=4, mesh_slots=4, **BASE)
    with pytest.raises(ValueError, match="device"):
        api.compile_plan(spec, device="cpu")
    with pytest.raises(ValueError, match="device"):
        api.compile_plan(spec, devices=["cpu"] * 3)
    plan = api.compile_plan(api.RecoverySpec(mode="stream", n_slots=4, mesh_slots=2, **BASE),
                            devices=["cpu", "cpu"])  # fmt: skip
    assert plan.lowering.mesh_shape == (2,) and plan.lowering.device == "cpu"
    assert plan.mesh.axis_names == ("slots",)
    assert api.compile_plan(api.RecoverySpec(mode="offline", **BASE), device="cpu").lowering.mesh_shape == ()
    assert api.compile_plan(api.RecoverySpec(mode="stream", **BASE), device="cpu").mesh is None


def test_banked_plan_sizes_its_bank_by_the_shard():
    """The banked tick launches once a shard, so its bank divides S/M."""
    spec = api.RecoverySpec(mode="stream", n_slots=8, mesh_slots=2, encoder="gru",
                            tick=api.TickSpec(tick_kernel="banked"), **BASE)  # fmt: skip
    low = api.compile_plan(spec, devices=["cpu", "cpu"]).lowering
    assert low.tick_kernel == "banked" and 4 % low.tick_slots_per_bank == 0


def test_fused_plan_fits_its_tile_to_the_shard():
    """``block_b="auto"`` fits the slot-axis tile to a shard's S/M slots: at
    132 windows a slot (one block a window fills the card's 132 SMs), 2
    slots take a tile of 2 on one shard and of 1 on each of 2, the tile of a
    plan of one slot."""
    scfg = StreamConfig(buf_len=8 + 131 * 8, window=8, stride=8, chunk=8, steps_per_tick=4)

    def block_b(n_slots, mesh_slots):
        spec = api.RecoverySpec(mode="stream", n_slots=n_slots, stream=scfg, encoder="gru",
                                mesh_slots=mesh_slots, fused=True, block_b="auto", **BASE)  # fmt: skip
        return api.compile_plan(spec, devices=["cpu"] * mesh_slots).lowering.block_b

    assert scfg.n_windows == 132
    assert (block_b(2, 1), block_b(2, 2), block_b(1, 1)) == (2, 1, 1)


# ---------------------------------------------------------------------------
# the host plane at mesh 2 against mesh 1
# ---------------------------------------------------------------------------
def _host_run(mesh_slots, tick_kernel, batch_size=None, ticks=3):
    ys = _lorenz()
    scfg = StreamConfig(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=4,
                        min_steps=10**9, max_steps=10**9, batch_size=batch_size)  # fmt: skip
    spec = api.RecoverySpec(mode="stream", n_slots=2, stream=scfg, encoder="gru",
                            mesh_slots=mesh_slots, batch_size=batch_size,
                            tick=api.TickSpec(steps_per_tick=4, tick_kernel=tick_kernel), **BASE)  # fmt: skip
    svc = api.compile_plan(spec, devices=["cpu"] * mesh_slots).make_service()
    for i in range(2):
        svc.submit(i, ys[i : i + 32])
    svc.fill_slots()
    for t in range(ticks):
        idx = 32 + t * 8 + np.arange(8)
        svc.tick_once(np.repeat(ys[idx][None], 2, axis=0))
    return svc


@pytest.mark.parametrize("tick_kernel", ["composite", "banked"])
def test_host_plane_mesh2_matches_mesh1(tick_kernel):
    """``tests/test_api.py:422``'s scenario at mesh 2 and mesh 1: Theta within
    1e-5, every shard's leaves on its mesh device with S/M slots."""
    svc1, svc2 = _host_run(1, tick_kernel), _host_run(2, tick_kernel)
    d = (svc2.state.theta - svc1.state.theta).abs().max().item()
    assert d < 1e-5, d
    assert torch.isfinite(svc2.state.loss).all()
    assert len(svc2.shards) == 2 and svc2.mesh.devices == (torch.device("cpu"),) * 2
    for shard, device in zip(svc2.shards, svc2.mesh.devices):
        leaves = tree_leaves(shard)
        assert all(leaf.shape[0] == 1 and leaf.device == device for leaf in leaves)
    assert svc2.sync_log == svc1.sync_log
    assert sorted(svc2.registry.workers()) == ["shard0", "shard1"]
    assert svc1.registry.workers() == ["shard0"]


def test_minibatch_indices_do_not_depend_on_the_mesh():
    """With ``batch_size`` below the windows, mesh 2 draws the tick's [K, S,
    bs] indices from the service's one generator and hands each shard its
    rows: every leaf equals mesh 1's bit for bit."""
    svc1, svc2 = _host_run(1, "composite", batch_size=2), _host_run(2, "composite", batch_size=2)
    for a, b in zip(tree_leaves(svc1.state), tree_leaves(svc2.state)):
        assert torch.equal(a, b)
    assert torch.equal(svc1.generator.get_state(), svc2.generator.get_state())


def _served(mesh_slots, **spec_kw):
    """Four streams through the host plane's slots, each evicted at its
    8-step budget (2 ticks of K = 4), until every one is served."""
    ys = _lorenz()
    scfg = StreamConfig(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=4, min_steps=8,
                        max_steps=8)  # fmt: skip
    spec = api.RecoverySpec(mode="stream", n_slots=2, stream=scfg, encoder="gru",
                            mesh_slots=mesh_slots, tick=api.TickSpec(steps_per_tick=4),
                            **BASE, **spec_kw)  # fmt: skip
    plan = api.compile_plan(spec, devices=["cpu"] * mesh_slots)
    svc = plan.make_service()
    cursors = {sid: 10 * sid + 32 for sid in range(4)}
    for sid in cursors:
        svc.submit(sid, ys[10 * sid : 10 * sid + 32])
    svc.fill_slots()
    while not svc.done and svc.ticks < 12:
        chunk = np.zeros((2, 8, 3), np.float32)
        for s, sid in enumerate(svc.slot_streams()):
            if sid >= 0:
                chunk[s] = ys[cursors[sid] : cursors[sid] + 8]
                cursors[sid] += 8
        svc.tick_once(chunk)
    return plan, svc


@pytest.mark.parametrize("spec_kw", [dict(fused=True, block_b="auto"), dict(precision="int8_pwl")],
                         ids=["fused", "int8_pwl"])  # fmt: skip
def test_fused_and_int8_services_at_mesh2_match_mesh1(spec_kw):
    """``fused`` (the slot-axis ``mr_step`` once a shard a step, its tile
    fitted to S/M slots) and ``int8_pwl`` (each eviction read out through
    ``mr_step_int8`` on its shard's row) at mesh 2 against mesh 1: every
    stream served with the same steps and reason, Theta within 1e-5."""
    plan1, svc1 = _served(1, **spec_kw)
    plan2, svc2 = _served(2, **spec_kw)
    assert svc1.done and svc2.done and set(svc2.results) == set(svc1.results) == set(range(4))
    assert svc2.slot_streams() == svc1.slot_streams() and svc2.ticks == svc1.ticks
    for sid, r1 in svc1.results.items():
        r2 = svc2.results[sid]
        assert (r2.steps, r2.reason) == (r1.steps, r1.reason) == (8, "budget")
        np.testing.assert_allclose(r2.theta, r1.theta, atol=1e-5, rtol=0)
    assert plan2.lowering.block_b == plan1.lowering.block_b == (1 if spec_kw.get("fused") else None)


# ---------------------------------------------------------------------------
# the device plane at mesh 2 against JAX's 2-shard device plane
# ---------------------------------------------------------------------------
def _carry_jax_cold_starts(monkeypatch):
    jcfg = JMRConfig(encoder="gru", **BASE)
    jkey = jax.random.key(0)

    def jax_cold_start(seed, stream_id, cfg, device):
        p, o = jstream.cold_start(jax.random.fold_in(jkey, 1000 + stream_id), jcfg)
        return (convert.params_from_numpy(jax.tree.map(np.asarray, p), device),
                convert.opt_from_numpy(jax.tree.map(np.asarray, o), device))  # fmt: skip

    monkeypatch.setattr(stream, "cold_start", jax_cold_start)


def test_device_plane_mesh2_in_lockstep_with_jax(monkeypatch, two_jax_devices):
    """Six streams through 4 slots on 2 shards, both packages' device planes
    (``delta_tol=0``: every eviction at ``max_steps``): the same shards for
    each arrival, slot maps, eviction records and syncs a tick, Theta within
    1e-3."""
    _carry_jax_cold_starts(monkeypatch)
    lor = _lorenz()
    data = np.stack([lor[16 * i : 16 * i + 96] for i in range(6)])
    tick = dict(steps_per_tick=8, control="device", tick_kernel="banked", queue_capacity=8,
                warm_capacity=8)  # fmt: skip
    jspec = japi.RecoverySpec(mode="stream", n_slots=4, stream=jstream.StreamConfig(**CCFG),
                              encoder="gru", seed=0, mesh_slots=2, tick=japi.TickSpec(**tick),
                              **BASE)  # fmt: skip
    jsvc = japi.compile_plan(jspec).make_service()
    spec = api.RecoverySpec(mode="stream", n_slots=4, stream=StreamConfig(**CCFG), encoder="gru",
                            seed=0, mesh_slots=2, tick=api.TickSpec(**tick), **BASE)  # fmt: skip
    svc = api.compile_plan(spec, devices=["cpu", "cpu"]).make_service()
    assert jsvc.control.q_ids.shape == (2, 8) and svc.control.q_ids.shape == (2, 8)

    def traffic(s):
        shards = [s.submit(sid, data[sid, :32]).shard for sid in range(6)]
        s.fill_slots()
        cursors = dict.fromkeys(range(6), 32)
        maps, records = [], []
        for _ in range(16):
            if s.done:
                break
            chunk = np.zeros((4, 8, 3), np.float32)
            for slot, sid in enumerate(s.slot_streams()):
                if sid >= 0:
                    chunk[slot] = data[sid, cursors[sid] : cursors[sid] + 8]
                    cursors[sid] += 8
            info = s.tick_once(chunk)
            maps.append(tuple(s.slot_streams()))
            records.extend((r.stream_id, r.steps, r.reason) for r in info["evicted"])
        return shards, maps, records

    jtrace, trace = traffic(jsvc), traffic(svc)
    assert trace == jtrace and len(trace[2]) == 6 and svc.done and jsvc.done
    assert trace[0] == [0, 1, 0, 1, 0, 1]
    assert svc.sync_log == jsvc.sync_log
    for sid in range(6):
        np.testing.assert_allclose(svc.results[sid].theta, jsvc.results[sid].theta, rtol=1e-3,
                                   atol=1e-3)  # fmt: skip
        np.testing.assert_allclose(svc.results[sid].mean, jsvc.results[sid].mean, rtol=1e-6)


def test_device_plane_mesh2_admits_arrivals_as_jax_does(two_jax_devices):
    """``tests/test_tick.py:360``'s arrivals (fills between them) into 2
    slots on 2 shards: an arrival joins the least-loaded shard's queue (the
    lowest index on a tie), so the second arrival waits in shard 0 while
    shard 1's slot takes the third. The JAX package's 2-shard device plane
    admits the same way, so its slot maps part from mesh 1's; the port's
    equal JAX's, tick for tick, and every stream's result is mesh 1's."""
    rng = np.random.default_rng(3)
    data = np.cumsum(rng.standard_normal((6, 200, 3)).astype(np.float32) * 0.1, axis=1)
    arrivals = {0: [0, 1, 2], 2: [3], 3: [4], 5: [5]}
    scfg = dict(CCFG, steps_per_tick=2, min_steps=4, max_steps=4)
    tick = dict(steps_per_tick=2, control="device", tick_kernel="banked", queue_capacity=8,
                warm_capacity=8)  # fmt: skip

    def traffic(s):
        cursors, trace = dict.fromkeys(range(6), 32), []
        s.fill_slots()
        t = 0
        while (not s.done or t in arrivals) and t < 30:
            for sid in arrivals.get(t, ()):
                s.submit(sid, data[sid, :32])
                s.fill_slots()
            chunk = np.zeros((2, 8, 3), np.float32)
            for slot, sid in enumerate(s.slot_streams()):
                if sid >= 0:
                    chunk[slot] = data[sid, cursors[sid] : cursors[sid] + 8]
                    cursors[sid] += 8
            info = s.tick_once(chunk)
            trace.append((tuple(s.slot_streams()), [(r.stream_id, r.steps) for r in info["evicted"]]))
            t += 1
        return trace

    def port(mesh_slots):
        spec = api.RecoverySpec(mode="stream", n_slots=2, stream=StreamConfig(**scfg), encoder="gru",
                                seed=0, mesh_slots=mesh_slots, tick=api.TickSpec(**tick), **BASE)  # fmt: skip
        return api.compile_plan(spec, devices=["cpu"] * mesh_slots).make_service()

    jspec = japi.RecoverySpec(mode="stream", n_slots=2, stream=jstream.StreamConfig(**scfg),
                              encoder="gru", seed=0, mesh_slots=2, tick=japi.TickSpec(**tick),
                              **BASE)  # fmt: skip
    jtrace = traffic(japi.compile_plan(jspec).make_service())
    svc1, svc2 = port(1), port(2)
    trace1, trace2 = traffic(svc1), traffic(svc2)
    assert trace2 == jtrace and trace2[0][0] == (0, 2) and trace1[0][0] == (0, 1)
    for sid in range(6):
        r1, r2 = svc1.results[sid], svc2.results[sid]
        assert (r2.steps, r2.reason) == (r1.steps, r1.reason)
        np.testing.assert_allclose(r2.theta, r1.theta, atol=1e-5, rtol=0)
