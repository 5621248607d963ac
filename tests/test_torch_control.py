"""The port's device-resident control plane against the JAX package and the
port's host plane.

At the JAX tests' sizes (H=8; ``tests/test_tick.py``'s CCFG: budget-only
eviction, ``delta_tol=0``):

- ``_control_apply`` from a carried JAX ``SlotState`` and ``ControlState``
  with the same eviction mask, through refills, a warm hit and a preemption:
  integer leaves equal and float leaves bit for bit (every float leaf is a
  copy, a blend or the admission statistics);
- ``tick_device`` at K=0 (composite and banked) from a carried state: buffers
  and control equal, theta and delta within 1e-5;
- the port twins of ``tests/test_tick.py:360-549``: the device plane in
  lockstep with the port's host plane (slot maps and evictions equal, theta
  within 1e-5), typed backpressure, priority preemption, a queue that wraps
  its capacity, and a median of 0 host syncs a tick at ``snapshot_period=4``;
- a device-plane service in lockstep with JAX's device-plane service (cold
  starts carried from JAX's keys): slot maps and eviction records equal,
  theta within 1e-3, the bound of ``tests/test_torch_stream.py``'s host-plane
  lockstep (float32 training steps in another order);
- the plan's control-plane lowering, TickSpec's validation, the converters,
  and ``serve_mr --control device`` end to end on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import control as jcontrol
from repro.core import stream as jstream
from repro.core.merinda import MRConfig as JMRConfig
from repro.data.dynamics import generate_trajectory as jgenerate
from repro_torch import api, convert
from repro_torch.core import control, merinda, stream
from repro_torch.core.stream import StreamConfig, SubmitStatus
from repro_torch.launch import serve_mr
from repro_torch.tree import tree_leaves

BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
CCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=16,
            delta_tol=0.0)  # fmt: skip


@functools.lru_cache(maxsize=1)
def _lorenz() -> np.ndarray:
    _, ys, _ = jgenerate("lorenz", n_samples=400)
    return np.asarray(ys)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def slot_state_from_jax(st) -> stream.SlotState:
    host = jax.tree.map(np.asarray, st)
    return stream.SlotState(
        params=convert.params_from_numpy(host.params),
        opt=convert.opt_from_numpy(host.opt),
        buf_y=_t(host.buf_y),
        buf_u=_t(host.buf_u),
        theta=_t(host.theta),
        delta=_t(host.delta),
        loss=_t(host.loss),
        mean=_t(host.mean),
        scale=_t(host.scale),
        steps=_t(host.steps).to(torch.int32),
        active=_t(host.active),
        stream_id=_t(host.stream_id).to(torch.int32),
    )


def _assert_trees_equal(got, want, what):
    """Integer and bool leaves equal, float leaves bit for bit."""
    got_leaves, want_leaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(w).dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# the control step against JAX's, from carried state
# ---------------------------------------------------------------------------
def _carried(n_slots=4, queue=6, warm=3, period=2):
    """A JAX slot state with every slot admitted at mixed step counts, and an
    empty JAX control state; the port's copies of both."""
    jcfg = JMRConfig(encoder="gru", **BASE)
    jscfg = jstream.StreamConfig(**CCFG)
    ys = _lorenz()
    st = jstream.init_slots(jax.random.key(0), jcfg, jscfg, n_slots)
    for s in range(n_slots):
        params, opt = jstream.cold_start(jax.random.key(10 + s), jcfg)
        st = jstream.admit(st, jnp.int32(s), jnp.int32(s), jnp.asarray(ys[3 * s : 3 * s + 32]),
                           jnp.zeros((32, 0)), params, opt)  # fmt: skip
    st = st._replace(steps=jnp.asarray([20, 5, 3, 16], jnp.int32)[:n_slots],
                     theta=jax.random.normal(jax.random.key(5), st.theta.shape),
                     delta=jnp.linspace(0.1, 0.4, n_slots), loss=jnp.linspace(1.0, 2.0, n_slots))  # fmt: skip
    ctl = jcontrol.init_control(jax.random.key(0), jcfg, jscfg, n_slots, shards=1,
                                queue_capacity=queue, warm_capacity=warm, snapshot_period=period)  # fmt: skip
    pctl = convert.control_from_numpy(jax.tree.map(np.asarray, ctl))
    return jcfg, st, ctl, slot_state_from_jax(st), pctl


def _enqueue_both(ctl, pctl, jcfg, sid, prio, ys):
    params, _ = jstream.cold_start(jax.random.key(100 + sid), jcfg)
    hist = jnp.asarray(ys[sid : sid + 32])
    ctl = jcontrol.enqueue(ctl, jnp.int32(0), jnp.int32(sid), hist, jnp.zeros((32, 0)), params,
                           jnp.int32(prio))  # fmt: skip
    control.enqueue(pctl, 0, sid, _t(hist), torch.zeros(32, 0),
                    convert.params_from_numpy(jax.tree.map(np.asarray, params)), prio)  # fmt: skip
    return ctl


def test_enqueue_matches_jax():
    jcfg, _, ctl, _, pctl = _carried()
    for sid, prio in ((10, 0), (11, 2), (12, 1)):
        ctl = _enqueue_both(ctl, pctl, jcfg, sid, prio, _lorenz())
    _assert_trees_equal(pctl, ctl, "control after three enqueues")
    assert pctl.q_len.tolist() == [3] and pctl.q_ids[0, :4].tolist() == [10, 11, 12, -1]


def test_control_apply_matches_jax_bit_for_bit():
    """Three control steps from the same carried state on both packages:
    (1) evict slots 0 and 3 (converged, budget) and refill them from a
    queue of mixed tiers; (2) a second wave where a re-submitted stream 0
    hits the warm ring; (3) a tier-5 arrival preempting a cold slot. After
    each, every SlotState and ControlState leaf is the JAX package's bits."""
    jcfg, jst, jctl, st, ctl = _carried()
    ys = _lorenz()
    for sid, prio in ((10, 0), (11, 2), (12, 1), (13, 2)):
        jctl = _enqueue_both(jctl, ctl, jcfg, sid, prio, ys)
    waves = [
        ([True, False, False, True], [1.0, 0.0, 0.0, 2.0], 0, ()),
        ([False, True, False, False], [0.0, 2.0, 0.0, 0.0], 0, ((0, 3),)),
        ([False, False, False, False], [0.0] * 4, 10, ((20, 5),)),
    ]
    evicted_w1 = st.params.head_w1[0].clone()
    for i, (evict, reason, min_steps, arrivals) in enumerate(waves):
        for sid, prio in arrivals:
            jctl = _enqueue_both(jctl, ctl, jcfg, sid, prio, ys)
        jst, jctl = jcontrol._control_apply(jst, jctl, jnp.asarray(evict), jnp.asarray(reason),
                                            shards=1, min_steps=min_steps)  # fmt: skip
        st, ctl = control._control_apply(st, ctl, torch.tensor(evict), torch.tensor(reason),
                                         min_steps=min_steps)  # fmt: skip
        _assert_trees_equal(st, jst, f"slots after wave {i}")
        _assert_trees_equal(ctl, jctl, f"control after wave {i}")
    # the waves did what they say: tier-2 arrivals first, stream 0 back warm
    # (its evicted parameters), stream 2 (tier 0, cold) preempted by the
    # tier-5 arrival and queued again, three events logged
    assert st.stream_id.tolist() == [11, 0, 20, 13] and ctl.ev_len.tolist() == [3]
    assert torch.equal(st.params.head_w1[1], evicted_w1)
    assert ctl.q_ids[0, :4].tolist() == [12, 10, 2, -1]


@pytest.mark.parametrize("kernel", ["composite", "banked"])
def test_tick_device_k0_matches_jax(kernel):
    """One zero-readback serve tick (K=0) from carried state: the eviction
    mask, event records and refill equal, theta and delta within 1e-5."""
    jcfg, jst, jctl, st, ctl = _carried()
    ys = _lorenz()
    for sid, prio in ((10, 0), (11, 1)):
        jctl = _enqueue_both(jctl, ctl, jcfg, sid, prio, ys)
    kw = dict(CCFG, steps_per_tick=0, min_steps=4, max_steps=18, delta_tol=0.25)
    jscfg, scfg = jstream.StreamConfig(**kw), StreamConfig(**kw)
    new_y = np.stack([ys[40 + s : 48 + s] for s in range(4)]).astype(np.float32)
    new_u = np.zeros((4, 8, 0), np.float32)
    jst2, jctl2, jstatus = jcontrol.tick_device(jst, jctl, jnp.asarray(new_y), jnp.asarray(new_u),
                                                jax.random.key(1), cfg=jcfg, scfg=jscfg,
                                                kernel=kernel)  # fmt: skip
    cfg = merinda.MRConfig(encoder="gru", **BASE)
    st2, ctl2, status = control.tick_device(st, ctl, _t(new_y), _t(new_u), None,
                                            cfg=cfg, scfg=scfg, kernel=kernel)  # fmt: skip
    bound = dict(atol=1e-5, rtol=0)
    np.testing.assert_allclose(status.numpy(), np.asarray(jstatus), **bound)
    for name in ("buf_y", "steps", "active", "stream_id", "mean", "scale"):
        np.testing.assert_array_equal(getattr(st2, name).numpy(), np.asarray(getattr(jst2, name)))
    for name in ("theta", "delta"):
        np.testing.assert_allclose(getattr(st2, name).numpy(), np.asarray(getattr(jst2, name)),
                                   **bound)  # fmt: skip
    for name in ("q_ids", "q_len", "w_ids", "ev_len", "s_prio"):
        np.testing.assert_array_equal(getattr(ctl2, name).numpy(), np.asarray(getattr(jctl2, name)))
    np.testing.assert_allclose(ctl2.ev_log.numpy(), np.asarray(jctl2.ev_log), **bound)
    assert ctl2.ev_len.tolist() == [int(jctl2.ev_len[0])] and int(jctl2.ev_len[0]) >= 1


# ---------------------------------------------------------------------------
# services: the port's device plane against its host plane (tests/test_tick.py)
# ---------------------------------------------------------------------------
def _spec(control_name, scfg=None, **tick_kw):
    scfg = scfg or StreamConfig(**CCFG)
    tick = dict(steps_per_tick=scfg.steps_per_tick, control=control_name, queue_capacity=8,
                snapshot_period=1, warm_capacity=8)  # fmt: skip
    tick.update(tick_kw)
    return api.RecoverySpec(mode="stream", n_slots=2, stream=scfg, encoder="gru", seed=0,
                            tick=api.TickSpec(**tick), **BASE)  # fmt: skip


def _traffic_data():
    rng = np.random.default_rng(7)
    lor = _lorenz()
    return np.stack(
        [np.roll(lor, -int(rng.integers(0, 64)), axis=0) + rng.normal(0.0, 0.01, lor.shape)
         for _ in range(6)]
    ).astype(np.float32)  # fmt: skip


ARRIVALS = {0: [0, 1, 2], 2: [3], 3: [4], 5: [5]}


def run_traffic(svc, data, resubmit=()):
    """``tests/test_tick.py:371``'s traffic: arrivals over the first ticks,
    chunks routed by the slot map; returns (slot maps, evictions)."""
    L, C = CCFG["buf_len"], CCFG["chunk"]
    t_total = data.shape[1]
    cursors = dict.fromkeys(range(len(data)), L)
    slot_maps, evictions = [], []
    for sid in resubmit:
        svc.submit(sid, data[sid, :L])
    svc.fill_slots()
    t = 0
    while (not svc.done or t in ARRIVALS) and t < 40:
        if not resubmit:
            for sid in ARRIVALS.get(t, ()):
                svc.submit(sid, data[sid, :L])
                svc.fill_slots()
        chunk = np.zeros((2, C, 3), np.float32)
        for s, sid in enumerate(svc.slot_streams()):
            if sid >= 0:
                chunk[s] = data[sid, (cursors[sid] + np.arange(C)) % t_total]
                cursors[sid] += C
        info = svc.tick_once(chunk)
        slot_maps.append(tuple(svc.slot_streams()))
        evictions.extend((t, r.stream_id, r.steps, r.reason) for r in info["evicted"])
        t += 1
    return slot_maps, evictions


def test_device_plane_in_lockstep_with_host_plane():
    """As ``tests/test_tick.py:360``, on the banked tick (the other tests here
    run the composite one): the same slot occupancy and evictions (tick, id,
    steps, reason) on both planes, theta within 1e-5, including a warm-start
    wave of resubmissions; the device plane reads the status and the event
    log back once each a tick (snapshot_period=1)."""
    data = _traffic_data()
    services, traces = {}, {}
    for name in ("host", "device"):
        svc = api.compile_plan(_spec(name, tick_kernel="banked"), device="cpu").make_service()
        traces[name] = run_traffic(svc, data)
        services[name] = svc
    assert traces["device"] == traces["host"]
    assert [e[1] for e in traces["host"][1]] == list(range(6))
    host, dev = services["host"], services["device"]
    assert host.done and dev.done and set(dev.results) == set(host.results) == set(range(6))
    for sid in range(6):
        assert (dev.results[sid].steps, dev.results[sid].reason) == (host.results[sid].steps,
                                                                     host.results[sid].reason)  # fmt: skip
        np.testing.assert_allclose(dev.results[sid].theta, host.results[sid].theta, atol=1e-5)
        np.testing.assert_allclose(dev.results[sid].mean, host.results[sid].mean, atol=1e-6)
    assert set(dev.sync_log) == {2}
    for name in ("host", "device"):
        traces[name] = run_traffic(services[name], data, resubmit=(0, 1))
    assert traces["device"] == traces["host"]
    for sid in (0, 1):
        np.testing.assert_allclose(dev.results[sid].theta, host.results[sid].theta, atol=1e-5)


def test_device_queue_backpressure_typed():
    """As ``tests/test_tick.py:427``: a full device queue spills to the
    bounded overflow queue (OVERFLOW), a full overflow REJECTs, and the
    overflowed stream drains back into the queue and completes."""
    plan = api.compile_plan(_spec("device", queue_capacity=2, overflow_capacity=1), device="cpu")
    assert plan.lowering.overflow_capacity == 1
    svc = plan.make_service()
    hist = _lorenz()[:32]
    assert svc.submit(0, hist).status is SubmitStatus.ENQUEUED
    assert svc.submit(1, hist).status is SubmitStatus.ENQUEUED
    r2 = svc.submit(2, hist)
    assert r2.status is SubmitStatus.OVERFLOW and r2.accepted
    r3 = svc.submit(3, hist)
    assert r3.status is SubmitStatus.REJECTED and not r3.accepted
    assert 3 not in svc._pending
    chunk = np.repeat(_lorenz()[32:40][None], 2, axis=0)
    svc.fill_slots()
    for _ in range(12):
        if svc.done:
            break
        svc.tick_once(chunk)
    assert set(svc.results) == {0, 1, 2}


@pytest.mark.parametrize("control_name", ["host", "device"])
def test_priority_preempts_a_cold_slot(control_name):
    """As ``tests/test_tick.py:457``, on both planes: a tier-3 arrival
    displaces the lowest (tier, slot) cold slot; the victim re-enters the
    queue with its live buffers and still completes."""
    svc = api.compile_plan(_spec(control_name), device="cpu").make_service()
    lor = _lorenz()
    hist = lor[:32]
    for sid in (0, 1):
        svc.submit(sid, hist)
    svc.fill_slots()
    assert sorted(svc.slot_streams()) == [0, 1]
    assert svc.submit(2, hist, priority=3).accepted
    chunk = np.repeat(lor[32:40][None], 2, axis=0)
    svc.tick_once(chunk)
    assert svc.slot_streams() == [2, 1]
    for _ in range(12):
        if svc.done:
            break
        svc.tick_once(chunk)
    assert set(svc.results) == {0, 1, 2}
    assert all(r.reason == "budget" for r in svc.results.values())


def test_device_queue_wraps_its_capacity():
    """As ``tests/test_tick.py:482``: a capacity-2 queue admits two waves of
    two; the second wave reuses the queue's rows and completes."""
    svc = api.compile_plan(_spec("device", queue_capacity=2), device="cpu").make_service()
    lor = _lorenz()
    for sid in (0, 1):
        svc.submit(sid, lor[:32])
    svc.fill_slots()
    for sid in (2, 3):
        assert svc.submit(sid, lor[sid : sid + 32]).status is SubmitStatus.ENQUEUED
    chunk = np.repeat(lor[32:40][None], 2, axis=0)
    for _ in range(8):
        if svc.done:
            break
        svc.tick_once(chunk)
    assert set(svc.results) == {0, 1, 2, 3}
    assert all(r.steps == CCFG["max_steps"] for r in svc.results.values())


def test_snapshot_period_steady_ticks_read_nothing_back():
    """As ``tests/test_tick.py:521``: at snapshot_period=4 with no evictions
    only every 4th tick reads back (status and event log); the median tick
    is 0 syncs and the service answers from its cached views."""
    scfg = StreamConfig(**dict(CCFG, min_steps=10**9, max_steps=10**9))
    svc = api.compile_plan(_spec("device", scfg=scfg, snapshot_period=4), device="cpu").make_service()
    lor = _lorenz()
    for sid in (0, 1):
        svc.submit(sid, lor[:32])
    svc.fill_slots()
    chunk = np.repeat(lor[32:40][None], 2, axis=0)
    for _ in range(8):
        svc.tick_once(chunk)
    syncs0 = svc.counters["host_syncs"]
    assert svc.slot_streams() == [0, 1] and svc.done is False
    assert svc.counters["host_syncs"] == syncs0
    assert svc.sync_log == [0, 0, 0, 2, 0, 0, 0, 2]
    assert float(np.median(svc.sync_log)) == 0.0


# ---------------------------------------------------------------------------
# a device-plane service against JAX's device-plane service
# ---------------------------------------------------------------------------
def test_device_plane_service_in_lockstep_with_jax(monkeypatch):
    """Four streams through two slots on both packages' device planes
    (``delta_tol=0``: every eviction at ``max_steps``): the same slot maps and
    eviction records, theta within 1e-3."""
    jcfg = JMRConfig(encoder="gru", **BASE)
    jkey = jax.random.key(0)

    def jax_cold_start(seed, stream_id, cfg, device):
        p, o = jstream.cold_start(jax.random.fold_in(jkey, 1000 + stream_id), jcfg)
        return (convert.params_from_numpy(jax.tree.map(np.asarray, p), device),
                convert.opt_from_numpy(jax.tree.map(np.asarray, o), device))  # fmt: skip

    monkeypatch.setattr(stream, "cold_start", jax_cold_start)
    lor = _lorenz()
    data = np.stack([lor[16 * i : 16 * i + 96] for i in range(4)]).astype(np.float32)
    jscfg = jstream.StreamConfig(**CCFG)
    jspec = japi.RecoverySpec(mode="stream", n_slots=2, stream=jscfg, encoder="gru", seed=0,
                              tick=japi.TickSpec(steps_per_tick=8, control="device",
                                                 tick_kernel="banked"), **BASE)  # fmt: skip
    jsvc = japi.compile_plan(jspec).make_service()
    svc = api.compile_plan(_spec("device", tick_kernel="banked"), device="cpu").make_service()

    def traffic(s):
        for sid in range(4):
            s.submit(sid, data[sid, :32])
        s.fill_slots()
        cursors = dict.fromkeys(range(4), 32)
        maps, records = [], []
        for _ in range(12):
            if s.done:
                break
            chunk = np.zeros((2, 8, 3), np.float32)
            for slot, sid in enumerate(s.slot_streams()):
                if sid >= 0:
                    chunk[slot] = data[sid, cursors[sid] : cursors[sid] + 8]
                    cursors[sid] += 8
            info = s.tick_once(chunk)
            maps.append(tuple(s.slot_streams()))
            records.extend((r.stream_id, r.steps, r.reason) for r in info["evicted"])
        return maps, records

    jtrace, trace = traffic(jsvc), traffic(svc)
    assert trace == jtrace and len(trace[1]) == 4 and svc.done and jsvc.done
    assert svc.sync_log == jsvc.sync_log == [2] * len(trace[0])
    for sid in range(4):
        np.testing.assert_allclose(svc.results[sid].theta, jsvc.results[sid].theta, rtol=1e-3,
                                   atol=1e-3)  # fmt: skip
        np.testing.assert_allclose(svc.results[sid].mean, jsvc.results[sid].mean, rtol=1e-6)


# ---------------------------------------------------------------------------
# plan, spec, converters, serve_mr
# ---------------------------------------------------------------------------
def test_plan_records_the_control_plane_lowering():
    low = api.compile_plan(_spec("device"), device="cpu").lowering
    assert (low.control_plane, low.tick_queue_capacity, low.tick_snapshot_period) == ("device", 8, 1)
    assert (low.warm_capacity, low.checkpoint_period, low.checkpoint_dir) == (8, 0, None)
    low = api.compile_plan(_spec("host"), device="cpu").lowering
    assert (low.control_plane, low.tick_queue_capacity, low.tick_snapshot_period) == ("host", None,
                                                                                      None)  # fmt: skip
    plan = api.compile_plan(_spec("device", tick_kernel="banked"), device="cpu")
    cp = plan.control_plane
    assert (cp.queue_capacity, cp.snapshot_period, cp.warm_capacity, cp.shards) == (8, 1, 8, 1)
    assert cp.tick.keywords["kernel"] == "banked" and plan.make_service().control is not None
    assert api.compile_plan(_spec("host"), device="cpu").control_plane is None


def test_tick_spec_validates_the_control_plane_fields():
    for kw, match in ((dict(control="fpga"), "control"), (dict(queue_capacity=0), "queue_capacity"),
                      (dict(snapshot_period=0), "snapshot_period"),
                      (dict(warm_capacity=0), "warm_capacity"),
                      (dict(checkpoint_period=-1), "checkpoint_period"),
                      (dict(checkpoint_period=2), "checkpoint_dir"),
                      (dict(overflow_capacity=-1), "overflow_capacity")):  # fmt: skip
        with pytest.raises(ValueError, match=match):
            api.TickSpec(**kw)
    assert api.TickSpec(checkpoint_period=2, checkpoint_dir="x").checkpoint_period == 2


def test_converters_round_trip_the_control_state_and_pinn_params():
    jcfg = JMRConfig(encoder="gru", **BASE)
    ctl = jcontrol.init_control(jax.random.key(0), jcfg, jstream.StreamConfig(**CCFG), 4,
                                shards=2, queue_capacity=3, warm_capacity=2, snapshot_period=1)  # fmt: skip
    ctl = ctl._replace(q_ids=ctl.q_ids.at[1, 0].set(7), q_len=ctl.q_len.at[1].set(1))
    host = jax.tree.map(np.asarray, ctl)
    got = convert.control_from_numpy(host)
    assert got.q_ids.dtype == torch.int32 and got.q_params.head_w1.shape == (2, 3, 8, 16)
    _assert_trees_equal(got, host, "control_from_numpy")
    back = convert.control_to_numpy(got)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, b)
    from repro.core import pinn_sr as jpinn

    jp = jpinn.init_pinn_sr(jax.random.key(0), jpinn.PinnSRConfig(state_dim=2, width=8, fourier_k=2))
    p = convert.pinn_params_from_numpy(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(convert.pinn_params_to_numpy(p)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_serve_mr_device_control_runs_end_to_end_on_the_cpu():
    args = serve_mr.build_parser().parse_args(
        "--device cpu --tick-kernel banked --control device --snapshot-period 4 --streams 3 "
        "--slots 2 --hidden 8 --buf-len 48 --window 12 --stride 6 --chunk 8 --steps-per-tick 4 "
        "--min-steps 8 --max-steps 8".split()
    )
    out = serve_mr.serve(args, verbose=False)
    low = out["plan"].lowering
    assert (low.control_plane, low.tick_snapshot_period, low.tick_queue_capacity) == ("device", 4, 3)
    svc = out["service"]
    assert len(svc.results) == 3 and len(out["rows"]) == 3 and out["failures"] == 0
    assert float(np.median(svc.sync_log)) == 0.0 and max(svc.sync_log) == 2
