"""The int8/PWL serving slice of the port against the JAX package, end to end.

``compile_plan(precision="int8_pwl", device="cpu")`` (every kernel's plain
version):

- offline on ``gru`` and ``ltc``, the quickstart spec cut to 30 steps: the
  plan trains and reads out, and its ``readout`` of JAX-trained parameters
  matches JAX's ``plan.readout`` (the Pallas int8 kernels in interpret mode)
  within 1e-6, the JAX int8 kernel tests' bound;
- a ``quant`` service in lockstep with JAX's (``delta_tol=0``): slot maps and
  evictions equal, each eviction read out through the int8 stage, theta
  within 1e-3;
- one K=0 banked int8 monitor tick from a JAX ``SlotState`` against JAX's
  ``tick_banked(quant=True)``: buffers exact, theta and status within 1e-5;
- ``serve_mr --quant`` at a small size, and ``RecoveryService()`` resolving
  to the card (raising where none is visible).

The int8 modules one by one are ``tests/test_torch_int8.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import stream as jstream
from repro.core.library import denormalize_theta
from repro.core.merinda import prune_theta
from repro.core.merinda import MRConfig as JMRConfig
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.data.windows import make_windows as jmake_windows
from repro_torch import api, convert
from repro_torch.core import merinda, stream
from repro_torch.core.stream import StreamConfig
from repro_torch.launch import serve_mr

KERNEL_TOL = 1e-6  # tests/test_kernels_mr_step.py:9, the JAX int8 kernels' bound
TICK_TOL = 1e-5  # tests/test_tick.py:111
BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
TCFG = dict(buf_len=16, window=8, stride=4, chunk=4, steps_per_tick=0, min_steps=10**9,
            max_steps=10**9)  # fmt: skip
CCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=16,
            delta_tol=0.0)  # fmt: skip


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _port_params(jp):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp))


@functools.lru_cache(maxsize=1)
def _windows():
    _, ys, us = jgenerate("lotka_volterra")
    return jmake_windows(ys, us, window=32, stride=4)


QUICKSTART = dict(state_dim=2, order=2, hidden=32, dense_hidden=64, dt=0.05, fused=True,
                  mode="offline", steps=30, lr=3e-3, batch_size=64, precision="int8_pwl")  # fmt: skip


@pytest.mark.parametrize("encoder", ["gru", "ltc"])
def test_offline_int8_readout_matches_jax(encoder):
    """The quickstart spec at int8_pwl, cut to 30 steps: the port's plan
    trains and reads out on the CPU, and its ``readout`` of the JAX plan's
    trained parameters matches JAX's ``plan.readout`` (the Pallas int8
    kernel in interpret mode) in normalized and in physical units."""
    yw, uw, norm = _windows()
    spec = api.RecoverySpec(encoder=encoder, block_b="auto", **QUICKSTART)
    plan = api.compile_plan(spec, device="cpu")
    low = plan.lowering
    assert low.quant_serving and low.dispatch == "reference" and low.block_b == 1
    params, metrics = plan.run_offline(yw, uw, norm=norm)
    assert torch.isfinite(metrics["loss"]).all() and metrics["loss"].shape == (30,)
    assert np.isfinite(plan.readout(params, yw, uw, norm=norm, n_active=4)).all()

    jplan = japi.compile_plan(japi.RecoverySpec(encoder=encoder, **QUICKSTART))
    jparams, _ = jplan.run_offline(yw, uw, norm=norm)
    want = _np(jplan.readout(jparams, yw, uw))
    np.testing.assert_allclose(plan.readout(_port_params(jparams), yw, uw), want,
                               atol=KERNEL_TOL, rtol=0)  # fmt: skip
    # physical units, pruned: the same helpers on both sides of the readout
    n_vars = plan.cfg.state_dim + plan.cfg.input_dim
    phys = denormalize_theta(want, norm["mean"], norm["scale"], n_vars=n_vars,
                             order=plan.cfg.order, n_state=plan.cfg.state_dim)  # fmt: skip
    got = plan.readout(_port_params(jparams), yw, uw, norm=norm, n_active=4)
    np.testing.assert_allclose(got, prune_theta(phys, 4), rtol=1e-5, atol=1e-6)


def _service_spec(port: bool, **tick_kw):
    a = api if port else japi
    scfg = (StreamConfig if port else jstream.StreamConfig)(**CCFG)
    tick = a.TickSpec(steps_per_tick=scfg.steps_per_tick, **tick_kw)
    return a.RecoverySpec(mode="stream", n_slots=2, stream=scfg, encoder="gru", seed=0,
                          precision="int8_pwl", tick=tick, **BASE)  # fmt: skip


def _traffic(svc, data, n_ticks=12):
    for sid in range(len(data)):
        svc.submit(sid, data[sid, : CCFG["buf_len"]])
    svc.fill_slots()
    cursors = dict.fromkeys(range(len(data)), CCFG["buf_len"])
    trace = []
    for _ in range(n_ticks):
        if svc.done:
            break
        chunk = np.zeros((2, CCFG["chunk"], 3), np.float32)
        for s, sid in enumerate(svc.slot_streams()):
            if sid >= 0:
                chunk[s] = data[sid, cursors[sid] : cursors[sid] + CCFG["chunk"]]
                cursors[sid] += CCFG["chunk"]
        info = svc.tick_once(chunk)
        trace.append((tuple(svc.slot_streams()), [(r.stream_id, r.steps) for r in info["evicted"]]))
    return trace


@functools.lru_cache(maxsize=1)
def _lorenz():
    _, ys, _ = jgenerate("lorenz", n_samples=400)
    return np.asarray(ys)


def test_int8_service_evictions_match_jax_in_lockstep(monkeypatch):
    """Four streams through two slots at int8_pwl on both packages
    (``delta_tol=0``: every eviction at ``max_steps``), cold starts carried
    over from JAX's keys: the same slot maps and evictions, and each evicted
    stream's int8 readout within 1e-3 (the training ticks' bound in
    ``tests/test_torch_stream.py``), each eviction launching the int8 stage
    on the slot's current windows."""
    jcfg = JMRConfig(encoder="gru", **BASE)
    jkey = jax.random.key(0)

    def jax_cold_start(seed, stream_id, cfg, device):
        p, o = jstream.cold_start(jax.random.fold_in(jkey, 1000 + stream_id), jcfg)
        return (convert.params_from_numpy(jax.tree.map(np.asarray, p), device),
                convert.opt_from_numpy(jax.tree.map(np.asarray, o), device))  # fmt: skip

    monkeypatch.setattr(stream, "cold_start", jax_cold_start)
    readouts = []
    real_readout = stream.readout_theta

    def counted(*a, **kw):
        readouts.append(kw.get("quant"))
        return real_readout(*a, **kw)

    monkeypatch.setattr(stream, "readout_theta", counted)
    lor = _lorenz()
    data = np.stack([lor[16 * i : 16 * i + 96] for i in range(4)]).astype(np.float32)
    jsvc = japi.compile_plan(_service_spec(False, control="host")).make_service()
    plan = api.compile_plan(_service_spec(True, tick_kernel="banked"), device="cpu")
    assert plan.lowering.quant_serving and plan.lowering.tick_kernel == "banked"
    svc = plan.make_service()
    assert svc.quant and jsvc.quant
    assert _traffic(svc, data) == _traffic(jsvc, data)
    assert readouts == [True] * 4 and svc.done and jsvc.done
    for sid in range(4):
        np.testing.assert_allclose(
            svc.results[sid].theta, jsvc.results[sid].theta, rtol=1e-3, atol=1e-3
        )
    assert svc.sync_log == [1, 11, 1, 11]  # the packed status, five reads an eviction


def test_int8_monitor_tick_matches_jax():
    """One K=0 banked tick of an int8 monitor plan (``mr_tick_int8``) from a
    JAX ``SlotState`` carried across, against JAX's ``tick_banked``."""
    mcfg = dict(CCFG, steps_per_tick=0, min_steps=10**9, max_steps=10**9)
    jcfg = JMRConfig(encoder="gru", **BASE)
    jscfg = jstream.StreamConfig(**mcfg)
    ys = _lorenz()
    jst = jstream.init_slots(jax.random.key(0), jcfg, jscfg, 2)
    for s in range(2):
        params, opt = jstream.cold_start(jax.random.key(10 + s), jcfg)
        jst = jstream.admit(jst, jnp.int32(s), jnp.int32(s), jnp.asarray(ys[s : s + 32]),
                            jnp.zeros((32, 0)), params, opt)  # fmt: skip
    new_y = np.stack([ys[32 + s : 40 + s] for s in range(2)]).astype(np.float32)
    new_u = np.zeros((2, 8, 0), np.float32)
    host = jax.tree.map(np.asarray, jst)
    st = stream.SlotState(
        params=convert.params_from_numpy(host.params), opt=convert.opt_from_numpy(host.opt),
        buf_y=_t(host.buf_y), buf_u=_t(host.buf_u), theta=_t(host.theta), delta=_t(host.delta),
        loss=_t(host.loss), mean=_t(host.mean), scale=_t(host.scale),
        steps=_t(host.steps).to(torch.int32), active=_t(host.active),
        stream_id=_t(host.stream_id).to(torch.int32),
    )  # fmt: skip
    spec = dataclasses.replace(
        _service_spec(True, tick_kernel="banked"), stream=StreamConfig(**mcfg),
        tick=api.TickSpec(steps_per_tick=0, tick_kernel="banked"),
    )  # fmt: skip
    plan = api.compile_plan(spec, device="cpu")
    assert plan.tick.keywords["quant"] is True
    got, status = plan.tick(st, _t(new_y), _t(new_u), None)
    want, jstatus = jstream.tick_banked(jst, jnp.asarray(new_y), jnp.asarray(new_u),
                                        jax.random.key(1), cfg=jcfg, scfg=jscfg, quant=True)  # fmt: skip
    np.testing.assert_array_equal(got.buf_y.numpy(), _np(want.buf_y))
    np.testing.assert_allclose(got.theta.numpy(), _np(want.theta), atol=TICK_TOL, rtol=0)
    np.testing.assert_allclose(status.numpy(), _np(jstatus), atol=TICK_TOL, rtol=0)


def test_recovery_service_runs_on_the_card_unless_told(monkeypatch):
    cfg = merinda.MRConfig(encoder="gru", **BASE)
    scfg = StreamConfig(**TCFG)
    assert stream.RecoveryService(cfg, scfg, 2, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.RecoveryService(cfg, scfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compile_plan(api.RecoverySpec(state_dim=3, encoder="gru", precision="int8_pwl"))



def test_serve_mr_quant_runs_end_to_end_on_the_cpu():
    args = serve_mr.build_parser().parse_args(
        "--device cpu --quant --tick-kernel banked --streams 2 --slots 2 --hidden 8 "
        "--buf-len 48 --window 12 --stride 6 --chunk 8 --min-steps 16 --max-steps 32".split()
    )
    out = serve_mr.serve(args, verbose=False)
    low = out["plan"].lowering
    assert low.quant_serving and low.tick_kernel == "banked"
    assert out["service"].quant and len(out["service"].results) == 2 and len(out["rows"]) == 2
    assert all(np.isfinite(r[1]) for r in out["rows"])
