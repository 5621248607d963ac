"""The port's streaming recovery service against the JAX package.

At the JAX tests' own sizes (H=8; ``tests/test_tick.py`` TCFG and CCFG,
``tests/test_stream.py`` SCFG):

- ``roll_buffer``, ``window_views`` and ``buffer_stats`` against JAX's;
- the plain ``mr_tick`` against JAX ``mr_tick`` in interpret mode and with
  ``force_reference`` over JAX's sweep, buffers exact, theta and delta to 1e-5;
- one composite tick from a JAX ``SlotState`` carried across: a serve tick
  (K=0) to 1e-5; a training tick (K=2) with loss, theta and delta within 1e-3
  relative (the bound a 10-step run is held to in
  ``tests/test_torch_main_path.py``);
- the banked tick against the composite tick: parameters bit for bit, theta
  and delta to 1e-5, one host sync a banked tick;
- a service run in lockstep with the JAX service (``delta_tol=0``, so every
  eviction falls at ``max_steps``; cold starts carried over from JAX's keys):
  slot maps, steps and eviction reasons equal, theta within 1e-3;
- host-plane priority preemption and the bounded warm LRU;
- every refusal of what is not yet ported (and of int8 serving on a flow
  row), the fused and ``*_kernel`` plans that now build, the tick's
  shared-memory model, and ``serve_mr`` end to end at a small size on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import stream as jstream
from repro.core.merinda import MRConfig as JMRConfig
from repro.core.merinda import init_mr as jinit_mr
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.data import windows as jwindows
from repro.kernels.mr_step.tick import mr_tick as jmr_tick
from repro_torch import api, convert
from repro_torch.core import merinda
from repro_torch.core import stream
from repro_torch.core.stream import StreamConfig
from repro_torch.data import windows
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.tick import mr_tick
from repro_torch.launch import serve_mr
from repro_torch.tree import tree_leaves

BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
TCFG = dict(buf_len=16, window=8, stride=4, chunk=4, steps_per_tick=0, min_steps=10**9,
            max_steps=10**9)  # fmt: skip
SCFG = dict(buf_len=48, window=12, stride=6, chunk=8, steps_per_tick=8, min_steps=16, max_steps=64)
CCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=16,
            delta_tol=0.0)  # fmt: skip


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=1)
def _lorenz():
    _, ys, _ = jgenerate("lorenz", n_samples=400)
    return np.asarray(ys)


def slot_state_from_jax(st) -> stream.SlotState:
    """A JAX ``SlotState`` as the port's, leaf for leaf."""
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


# ---------------------------------------------------------------------------
# streaming window helpers
# ---------------------------------------------------------------------------
def test_window_helpers_match_jax():
    rng = np.random.default_rng(0)
    buf = rng.standard_normal((2, 48, 3)).astype(np.float32)
    buf[:, :, 2] = 0.5  # a constant channel keeps scale 1
    new = rng.standard_normal((2, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        windows.roll_buffer(_t(buf), _t(new)).numpy(),
        np.asarray(jwindows.roll_buffer(jnp.asarray(buf), jnp.asarray(new))),
    )
    np.testing.assert_array_equal(
        windows.window_views(_t(buf), 12, 6).numpy(),
        np.asarray(jwindows.window_views(jnp.asarray(buf), 12, 6)),
    )
    assert windows.n_buffer_windows(48, 12, 6) == jwindows.n_buffer_windows(48, 12, 6) == 7
    for got, want in zip(windows.buffer_stats(_t(buf)), jwindows.buffer_stats(jnp.asarray(buf))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert (windows.buffer_stats(_t(buf))[1][:, :, 2] == 1.0).all()


# ---------------------------------------------------------------------------
# the plain mr_tick against JAX's kernel (interpret) and oracle
# ---------------------------------------------------------------------------
def _tick_operands(encoder, m, S=4):
    jcfg = JMRConfig(input_dim=m, encoder=encoder, **BASE)
    keys = jax.random.split(jax.random.key(0), S)
    jp = jax.vmap(lambda k: jinit_mr(k, jcfg))(keys)
    rng = np.random.default_rng(1)
    n, L, C, n_terms = 3, TCFG["buf_len"], TCFG["chunk"], jcfg.n_terms
    mk = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    ops = (mk(S, L, n), mk(S, L, m), mk(S, C, n), mk(S, C, m), mk(S, n, s=0.1),
           rng.uniform(0.5, 1.5, (S, n)).astype(np.float32), mk(S, n_terms, n, s=0.3),
           np.array([True, False] * (S // 2)), np.array([True] * (S - 1) + [False]))  # fmt: skip
    return jcfg, jp, ops


@pytest.mark.parametrize(
    "encoder,m,spb",
    [("gru", 0, 1), ("gru", 2, 2), ("gru", 0, 4), ("gru_flow", 0, 2), ("gru_flow", 2, 1)],
)
def test_plain_mr_tick_matches_jax(encoder, m, spb):
    jcfg, jp, ops = _tick_operands(encoder, m)
    cfg = merinda.MRConfig(input_dim=m, encoder=encoder, **BASE)
    got = mr_tick(convert.params_from_numpy(jax.tree.map(np.asarray, jp)), cfg,
                  StreamConfig(**TCFG), *map(_t, ops), slots_per_bank=spb)  # fmt: skip
    jargs = (jp, jcfg, jstream.StreamConfig(**TCFG), *map(jnp.asarray, ops))
    for dispatch in (dict(interpret=True), dict(force_reference=True)):
        want = jmr_tick(*jargs, slots_per_bank=spb, **dispatch)
        for name, g, w in zip(("buf_y", "buf_u", "theta", "delta"), got, want):
            if name.startswith("buf"):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    assert torch.isinf(got[3][-1]) and torch.isfinite(got[3][:-1]).all()


def test_mr_tick_refuses_the_substep_families():
    cfg = merinda.MRConfig(encoder="ltc", **BASE)
    with pytest.raises(ValueError, match="GRU"):
        mr_tick(None, cfg, StreamConfig(**TCFG), *([None] * 9))


# ---------------------------------------------------------------------------
# one composite tick from a JAX SlotState
# ---------------------------------------------------------------------------
def _jax_state(scfg, cfg, n_slots=2):
    ys = _lorenz()
    st = jstream.init_slots(jax.random.key(0), cfg, scfg, n_slots)
    for s in range(n_slots):
        params, opt = jstream.cold_start(jax.random.key(10 + s), cfg)
        hist = jnp.asarray(ys[s : s + scfg.buf_len])
        st = jstream.admit(st, jnp.int32(s), jnp.int32(s), hist, jnp.zeros((scfg.buf_len, 0)),
                           params, opt)  # fmt: skip
    C = scfg.chunk
    new_y = np.stack([ys[scfg.buf_len + s : scfg.buf_len + s + C] for s in range(n_slots)])
    return st, new_y.astype(np.float32), np.zeros((n_slots, C, 0), np.float32)


@pytest.mark.parametrize("k", [0, 2])
def test_composite_tick_matches_jax_from_a_carried_state(k):
    jcfg = JMRConfig(encoder="gru", **BASE)
    cfg = merinda.MRConfig(encoder="gru", **BASE)
    jscfg = jstream.StreamConfig(**dict(SCFG, steps_per_tick=k))
    scfg = StreamConfig(**dict(SCFG, steps_per_tick=k))
    jst, new_y, new_u = _jax_state(jscfg, jcfg)
    st = slot_state_from_jax(jst)  # before the JAX tick donates its state
    # carry one JAX tick across first, so the EMA blends instead of seeding
    jst = jstream.tick(jst, jnp.asarray(new_y), jnp.asarray(new_u), jax.random.key(1),
                       cfg=jcfg, scfg=jscfg)  # fmt: skip
    st = slot_state_from_jax(jst)
    want = jstream.tick(jst, jnp.asarray(new_y), jnp.asarray(new_u), jax.random.key(2),
                        cfg=jcfg, scfg=jscfg)  # fmt: skip
    got = stream.tick(st, _t(new_y), _t(new_u), None, cfg=cfg, scfg=scfg)
    bound = dict(atol=1e-5) if k == 0 else dict(rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(got.buf_y.numpy(), np.asarray(want.buf_y))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), **bound)
    np.testing.assert_allclose(got.delta.numpy(), np.asarray(want.delta), **bound)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), **bound)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))


def test_banked_tick_matches_composite_tick():
    cfg = merinda.MRConfig(input_dim=1, encoder="gru_flow", **BASE)
    scfg = StreamConfig(**dict(SCFG, steps_per_tick=2))
    rng = np.random.default_rng(3)
    st = stream.init_slots(0, cfg, scfg, 3, "cpu")
    for s in range(2):  # the third slot stays inactive
        params, opt = stream.cold_start(0, s, cfg, "cpu")
        st = stream.admit(st, s, s, _lorenz()[s : s + 48], rng.standard_normal((48, 1)),
                          params, opt)  # fmt: skip
    st_b = stream.SlotState(*(x for x in st))  # same tensors: each tick returns new ones
    for t in range(3):
        new_y = _t(rng.standard_normal((3, 8, 3)).astype(np.float32))
        new_u = _t(rng.standard_normal((3, 8, 1)).astype(np.float32))
        st = stream.tick(st, new_y, new_u, None, cfg=cfg, scfg=scfg)
        st_b, status = stream.tick_banked(st_b, new_y, new_u, None, cfg=cfg,
                                          scfg=scfg)  # fmt: skip
        for a, b in zip(tree_leaves(st.params), tree_leaves(st_b.params)):
            assert torch.equal(a, b)
        torch.testing.assert_close(st_b.theta, st.theta, atol=1e-5, rtol=0)
        torch.testing.assert_close(st_b.delta, st.delta, atol=1e-5, rtol=0)
        assert torch.equal(st_b.buf_y, st.buf_y) and torch.equal(st_b.buf_u, st.buf_u)
        assert status.shape == (3, 4) and status[2, 3] == 0 and torch.isinf(status[2, 0])


# ---------------------------------------------------------------------------
# services
# ---------------------------------------------------------------------------
def _spec(control_kw=None, **overrides):
    scfg = StreamConfig(**CCFG)
    base = dict(mode="stream", n_slots=2, stream=scfg, encoder="gru", seed=0, **BASE,
                tick=api.TickSpec(steps_per_tick=scfg.steps_per_tick, **(control_kw or {})))  # fmt: skip
    base.update(overrides)
    return api.RecoverySpec(**base)


def _jspec():
    scfg = jstream.StreamConfig(**CCFG)
    return japi.RecoverySpec(
        mode="stream", n_slots=2, stream=scfg, encoder="gru", seed=0, **BASE,
        tick=japi.TickSpec(steps_per_tick=scfg.steps_per_tick, control="host"),
    )  # fmt: skip


def _traffic(svc, data, n_ticks=12):
    for sid in range(len(data)):
        svc.submit(sid, data[sid, : CCFG["buf_len"]])
    svc.fill_slots()
    cursors = dict.fromkeys(range(len(data)), CCFG["buf_len"])
    slot_maps, evictions = [], []
    for _ in range(n_ticks):
        if svc.done:
            break
        chunk = np.zeros((2, CCFG["chunk"], 3), np.float32)
        for s, sid in enumerate(svc.slot_streams()):
            if sid >= 0:
                chunk[s] = data[sid, cursors[sid] : cursors[sid] + CCFG["chunk"]]
                cursors[sid] += CCFG["chunk"]
        info = svc.tick_once(chunk)
        slot_maps.append(tuple(svc.slot_streams()))
        evictions.extend((r.stream_id, r.steps, r.reason) for r in info["evicted"])
    return slot_maps, evictions


def test_service_runs_in_lockstep_with_jax(monkeypatch):
    """Four streams through two slots on both packages: the same slot maps
    and evictions, recovered theta within 1e-3, and the banked port service
    one host sync a tick where the composite JAX tick reads four (each
    eviction adds five on both)."""
    jcfg = JMRConfig(encoder="gru", **BASE)
    jkey = jax.random.key(0)

    def jax_cold_start(seed, stream_id, cfg, device):
        p, o = jstream.cold_start(jax.random.fold_in(jkey, 1000 + stream_id), jcfg)
        return (convert.params_from_numpy(jax.tree.map(np.asarray, p), device),
                convert.opt_from_numpy(jax.tree.map(np.asarray, o), device))  # fmt: skip

    monkeypatch.setattr(stream, "cold_start", jax_cold_start)
    lor = _lorenz()
    data = np.stack([lor[16 * i : 16 * i + 96] for i in range(4)]).astype(np.float32)
    jsvc = japi.compile_plan(_jspec()).make_service()
    svc = api.compile_plan(_spec({"tick_kernel": "banked"}), device="cpu").make_service()
    jtrace, trace = _traffic(jsvc, data), _traffic(svc, data)
    assert trace == jtrace
    assert [e[2] for e in trace[1]] == ["budget"] * 4 and jsvc.done and svc.done
    for sid in range(4):
        np.testing.assert_allclose(
            svc.results[sid].theta, jsvc.results[sid].theta, rtol=1e-3, atol=1e-3
        )
        np.testing.assert_allclose(svc.results[sid].mean, jsvc.results[sid].mean, rtol=1e-6)
    # the packed status, plus five reads for each eviction
    assert svc.sync_log == [1, 11, 1, 11] and jsvc.sync_log == [4, 14, 4, 14]


def test_priority_preempts_a_cold_slot():
    """As ``tests/test_tick.py:457`` on the host plane: a tier-3 arrival
    displaces the lowest (tier, slot) cold slot; the victim re-enters the
    queue with its live buffers and still completes."""
    lor = _lorenz()
    svc = api.compile_plan(_spec(), device="cpu").make_service()
    hist = lor[: CCFG["buf_len"]]
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
    with pytest.raises(ValueError, match="priority"):
        svc.submit(3, hist, priority=-1)


def test_host_warm_registry_is_a_bounded_lru():
    """As ``tests/test_tick.py:501``: capacity 2, three streams through one slot."""
    lor = _lorenz()
    plan = api.compile_plan(_spec({"warm_capacity": 2}, n_slots=1), device="cpu")
    assert plan.lowering.warm_capacity == 2
    svc = plan.make_service()
    for sid in range(3):
        svc.submit(sid, lor[sid : sid + CCFG["buf_len"]])
    svc.fill_slots()
    chunk = lor[32:40][None]
    for _ in range(8):
        if svc.done:
            break
        svc.tick_once(chunk)
    assert set(svc.results) == {0, 1, 2}
    assert list(svc.warm) == [1, 2]
    # the registry holds copies: later admissions into the slot leave them be
    before = [t.clone() for t in tree_leaves(svc.warm[2])]
    svc.submit(7, lor[:32])
    svc.fill_slots()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(svc.warm[2])))


def test_stream_plans_resolve_the_tick_kernel():
    plan = api.compile_plan(_spec(), device="cpu")
    low = plan.lowering
    assert (low.tick_kernel, low.tick_slots_per_bank, low.control_plane) == ("composite", None, "host")
    plan = api.compile_plan(_spec({"tick_kernel": "banked"}), device="cpu")
    assert plan.lowering.tick_kernel == "banked" and plan.lowering.tick_slots_per_bank == 1
    assert plan.lowering.overflow_capacity == 16
    assert api.compile_plan(_spec({"tick_kernel": "auto"}), device="cpu").lowering.tick_kernel == "banked"
    auto_ltc = api.compile_plan(_spec({"tick_kernel": "auto"}, encoder="ltc"), device="cpu")
    assert auto_ltc.lowering.tick_kernel == "composite"
    with pytest.raises(ValueError, match="GRU-family"):
        api.compile_plan(_spec({"tick_kernel": "banked"}, encoder="ltc"), device="cpu")
    with pytest.raises(ValueError, match="not 'stream'"):
        api.compile_plan(_spec(mode="offline", tick=None), device="cpu").tick


def test_stream_mode_refuses_what_is_not_ported(tmp_path):
    """The fused and ``*_kernel`` rows build (their slot-axis kernels are
    ported), and so do the device control plane, service checkpoints and a
    slot mesh of 2 (given two devices); int8 on a flow row still raises."""
    for kw in (dict(fused=True), dict(fused=True, encoder="gru_flow"),
               dict(fused=True, encoder="ltc"), dict(fused=True, encoder="node"),
               dict(encoder="gru_kernel"), dict(encoder="gru_flow_kernel")):  # fmt: skip
        low = api.compile_plan(_spec(**kw), device="cpu").lowering
        assert (low.fused, low.kernel) == (kw.get("fused", False), "kernel" in low.encoder), kw
    # int8 serving is ported, but not on a flow row (no int8 stage)
    with pytest.raises(ValueError, match="int8_pwl"):
        api.compile_plan(_spec(precision="int8_pwl", encoder="gru_flow"), device="cpu")
    mesh_plan = api.compile_plan(_spec(mesh_slots=2), device="cpu", devices=["cpu", "cpu"])
    assert mesh_plan.lowering.mesh_shape == (2,) and mesh_plan.make_service().n_shards == 2
    tick = dict(control="device", checkpoint_period=2, checkpoint_dir=str(tmp_path))
    plan = api.compile_plan(_spec(tick), device="cpu")
    assert (plan.lowering.control_plane, plan.lowering.checkpoint_period) == ("device", 2)
    svc = plan.make_service()
    assert svc.control is not None and svc.checkpointer.period == 2
    with pytest.raises(ValueError, match="conflict"):
        _spec(tick=api.TickSpec(steps_per_tick=3))
    with pytest.raises(ValueError, match="chunk"):
        StreamConfig(buf_len=8, window=4, chunk=9)


def test_tick_shared_memory_model():
    cfg = merinda.MRConfig(input_dim=1, encoder="gru", **dict(BASE, hidden=32, dense_hidden=64))
    scfg = StreamConfig()
    # the serve shape: N=17 windows, D=4, H=32, Dh=64, Ko=45; one block of the
    # slot's cluster of 3, 6 warps a block (about 82 KB)
    assert tiling.config_tick_smem_bytes(cfg, scfg) == tiling.tick_smem_bytes(4, 32, 64, 45, 17, 32)
    assert (tiling.tick_cluster(17), tiling.tick_warps(17)) == (3, 6)
    assert 75_000 < tiling.config_tick_smem_bytes(cfg, scfg) < 90_000
    # the int8 tick's block of the same cluster: int8 weights, about 57 KB
    assert 50_000 < tiling.config_tick_smem_bytes(cfg, scfg, int8=True) < 65_000
    assert tiling.auto_slots_per_bank(cfg, scfg, 264, int8=True) == 2
    assert tiling.auto_slots_per_bank(cfg, scfg, 4) == 1
    assert tiling.auto_slots_per_bank(cfg, scfg, 264) == 2  # 132 blocks of two slots
    assert tiling.auto_slots_per_bank(cfg, scfg, 4, smem_budget_bytes=1024) == 0
    assert tiling.slots_per_bank_candidates(6) == [6, 3, 2, 1]


def test_serve_mr_runs_end_to_end_on_the_cpu():
    args = serve_mr.build_parser().parse_args(
        "--device cpu --tick-kernel banked --streams 3 --slots 2 --hidden 8 --buf-len 48 "
        "--window 12 --stride 6 --chunk 8 --min-steps 16 --max-steps 32".split()
    )
    out = serve_mr.serve(args, verbose=False)
    assert out["plan"].lowering.tick_kernel == "banked"
    assert len(out["service"].results) == 3 and len(out["rows"]) == 3
    assert all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in out["rows"])
    assert out["stats"]["ticks"] == 8  # two waves of 32 steps at K=8
    assert float(np.median(out["service"].sync_log)) <= 1


def test_serve_mr_reuses_an_earlier_fleet_baseline():
    """A run over the first streams of an earlier run's fleet may take that
    run's baseline: the rows equal the ones its own baseline would train."""
    argv = ("--device cpu --tick-kernel banked --slots 2 --hidden 8 --buf-len 48 --window 12 "
            "--stride 6 --chunk 8 --min-steps 16 --max-steps 32").split()  # fmt: skip
    parse = serve_mr.build_parser().parse_args
    first = serve_mr.serve(parse([*argv, "--streams", "3"]), verbose=False)
    own = serve_mr.serve(parse([*argv, "--streams", "2"]), verbose=False)
    shared = serve_mr.serve(parse([*argv, "--streams", "2"]), verbose=False,
                            baseline=first["theta_base"])  # fmt: skip
    assert first["theta_base"].shape[0] == 3 and shared["baseline_s"] == 0.0
    np.testing.assert_allclose(own["theta_base"], first["theta_base"][:2], atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(shared["theta_base"], first["theta_base"][:2])
    for a, b in zip(shared["rows"], own["rows"]):
        assert a[0] == b[0] and abs(a[2] - b[2]) <= 1e-6 * (1 + abs(b[2]))
