"""The slot-axis forms of the fused stage and the scan, on the CPU, against the JAX package.

Batch and stream mode run the loss under ``torch.func.vmap`` (JAX maps the
Pallas stages with ``jax.vmap``). On the card each kernel's autograd Function
(``kernels/runtime.kernel_function``) has a vmap rule that launches the
slot-axis kernel once for all slots, with a stacked plain recompute as its
backward. Here, at small widths:

- (a) the vmap rule and the stacked backward, on the Functions built with the
  plain versions as both the per-call and the slot-axis kernel (the rule is
  the same code the card runs): forward and gradients equal
  ``torch.func.vmap`` of the plain path within 1e-6 for all four families,
  with operands shared by every slot (stride 0 on the card) and a batched dim
  that is not 0; a nested vmap raises;
- (b) one ``engine.stacked_train_step`` of the fused ``gru_flow``, ``gru``,
  ``gru_flow`` + QAT, ``ltc`` and ``node`` rows and of ``gru_kernel`` and
  ``gru_flow_kernel`` against ``jax.vmap(mr_train_step)`` from converted
  parameters at ``batch_size=None``, within 1e-4 relative: through the plain
  versions (what the CPU runs) and through the vmap rule (the dispatch forced
  to the Functions, whose kernels are the plain versions), which must call
  the slot-axis kernel once and the per-call kernel never;
- (c) a fused composite-tick service (``gru``) and a fused ``ltc`` service in
  lockstep with JAX's (as ``tests/test_torch_stream.py``'s service test);
- (d) ``run_batch`` with ``fused=True`` against JAX's on the same converted
  initial weights;
- (e) the stream ``block_b`` that does not divide a slot's windows, the slot
  counts and ``in_dims`` the slot-axis wrappers refuse, the tile's slot
  count, and ``serve_mr --fused`` end to end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import merinda as jmerinda
from repro.core import quant as jquant
from repro.core import stream as jstream
from repro.data.dynamics import generate_trajectory as jgenerate
from repro.optim import adamw_init as jadamw_init
from repro_torch import api, convert
from repro_torch.core import engine, merinda, quant, stream
from repro_torch.core.stream import StreamConfig
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.gru_scan import ops as gru_ops
from repro_torch.kernels.gru_scan.ref import gru_scan_reference
from repro_torch.kernels.mr_step import ops as mr_ops
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ref import (
    mr_step_ltc_reference,
    mr_step_node_reference,
    mr_step_reference,
)
from repro_torch.launch import serve_mr

SMALL = dict(state_dim=3, input_dim=1, order=2, hidden=8, dense_hidden=16, dt=0.01)
STEP = dict(rtol=1e-4, atol=1e-7)
RULE = dict(rtol=0, atol=1e-6)
QAT = (4, 10, 2, 12)


def _plain_function(name, reference, **fixed):
    """``runtime.kernel_function`` with the plain version as both kernels;
    ``calls`` counts the per-call and the slot-axis calls."""
    calls = {"one": 0, "slots": 0}
    keep = lambda kw: {k: v for k, v in kw.items() if k in ("flow", "act_bits", "n_substeps")}

    def kernel(*tensors, **kw):
        calls["one"] += 1
        return reference(*tensors, **keep(kw), **fixed)

    def slot_kernel(*tensors, in_dims, **kw):
        calls["slots"] += 1
        return rt.over_slots(reference, in_dims, **keep(kw), **fixed)(*tensors)

    return rt.kernel_function(name, kernel, slot_kernel, reference), calls


def _operands(family, S, B, T, D, H, Dh, K, seed):
    """S slots' operands of one family, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal((S, *shape)) * scale).astype(np.float32)
    )
    head = (mk(H, Dh, scale=H**-0.5), mk(Dh, scale=0.1), mk(Dh, K, scale=0.1), mk(K, scale=0.1))
    xs, h0 = mk(B, T, D), mk(B, H, scale=0.1)
    if family in ("gru", "gru_scan"):
        cell = (mk(D, 3 * H, scale=0.4), mk(H, 3 * H, scale=0.4), mk(3 * H, scale=0.1),
                mk(H, scale=0.5), 1.0 + mk(T, scale=0.2))  # fmt: skip
        return (xs, h0, *cell) if family == "gru_scan" else (xs, h0, *cell, *head)
    if family == "ltc":
        cell = (mk(D, H, scale=0.5), mk(H, H, scale=H**-0.5), mk(H, scale=0.1), mk(H, scale=0.5),
                0.5 + mk(H, scale=0.1).abs())  # fmt: skip
    else:
        cell = (mk(H, H, scale=H**-0.5), mk(H, scale=0.1), mk(H, H, scale=0.1), mk(H, scale=0.1),
                mk(D, H, scale=0.5), mk(H, scale=0.1))  # fmt: skip
    return (xs, h0, *cell, *head)


FAMILIES = {  # family -> (plain version, kernel kw, plain kw, operands shared by every slot)
    "gru": (mr_step_reference, dict(flow=True, act_bits=None), dict(flow=True, act_bits=None),
            (1, 6, 10)),  # h0, dts, b2
    "gru_scan": (gru_scan_reference, dict(flow=False), dict(flow=False), (1, 6, 2)),  # h0, dts, wx
    "ltc": (mr_step_ltc_reference, dict(n_substeps=3, act_bits=(4, 10)),
            dict(dt=0.05, n_substeps=3, act_bits=(4, 10)), (1, 5)),  # h0, a
    "node": (mr_step_node_reference, dict(n_substeps=2, act_bits=None),
             dict(dt=0.05, n_substeps=2, act_bits=None), (1, 6)),  # h0, w_in
}  # fmt: skip


# ---------------------------------------------------------------------------
# (a) the vmap rule and the stacked backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_vmap_rule_matches_the_vmapped_plain_path(family):
    """Forward and every operand's gradient through the rule against
    ``torch.func.vmap`` of the plain version, within 1e-6: each operand but the
    shared ones batched (xs along dim 1), the shared ones given once."""
    reference, kernel_kw, ref_kw, shared = FAMILIES[family]
    fixed = {k: v for k, v in ref_kw.items() if k == "dt"}
    fn, calls = _plain_function("_Rule", reference, **fixed)
    ops = _operands(family, 3, 5, 7, 3, 8, 12, 6, seed=1)
    ops = tuple(t[0] if i in shared else t for i, t in enumerate(ops))
    ops = (ops[0].transpose(0, 1).contiguous(), *ops[1:])  # xs [B, S, T, D]: slots along dim 1
    in_dims = (1, *(None if i in shared else 0 for i in range(1, len(ops))))
    results = []
    for route in ("rule", "plain"):
        leaves = [t.detach().requires_grad_(True) for t in ops]
        if route == "rule":
            run = lambda *t: fn.apply(dict(kernel_kw, block_b=None), ref_kw, *t)
            out = torch.func.vmap(run, in_dims=in_dims)(*leaves)
        else:
            out = rt.over_slots(reference, in_dims, **ref_kw)(*leaves)
        weights = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
        grads = torch.autograd.grad((out * weights).sum(), leaves, allow_unused=True,
                                    materialize_grads=True)  # fmt: skip
        results.append([out, *grads])
    assert calls == {"one": 0, "slots": 1}
    assert results[0][0].shape[0] == 3
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, **RULE)


def test_a_nested_vmap_raises():
    reference, kernel_kw, ref_kw, _ = FAMILIES["gru"]
    fn, calls = _plain_function("_Nested", reference)
    ops = _operands("gru", 2, 4, 5, 3, 8, 12, 6, seed=2)
    run = lambda *t: fn.apply(dict(kernel_kw, block_b=None), ref_kw, *t)
    with pytest.raises(ValueError, match="nested vmap"):
        torch.func.vmap(torch.func.vmap(run))(*(t[None] for t in ops))
    assert calls == {"one": 0, "slots": 0}


def test_the_per_call_form_runs_outside_vmap():
    """Without vmap the Function calls the per-call kernel, and its backward
    recomputes the plain version."""
    reference, kernel_kw, ref_kw, _ = FAMILIES["ltc"]
    fn, calls = _plain_function("_One", reference, dt=0.05)
    ops = [t[0].requires_grad_(True) for t in _operands("ltc", 1, 4, 5, 3, 8, 12, 6, seed=3)]
    out = fn.apply(dict(kernel_kw, block_b=None), ref_kw, *ops)
    got = torch.autograd.grad(out.square().sum(), ops)
    want = torch.autograd.grad(reference(*ops, **ref_kw).square().sum(), ops)
    assert calls == {"one": 1, "slots": 0}
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **RULE)


# ---------------------------------------------------------------------------
# (b) one stacked train step against jax.vmap(mr_train_step)
# ---------------------------------------------------------------------------
ROWS = {  # label -> (encoder, fused, qat)
    "gru_flow": ("gru_flow", True, None),
    "gru": ("gru", True, None),
    "gru_flow+qat": ("gru_flow", True, QAT),
    "ltc": ("ltc", True, None),
    "node": ("node", True, None),
    "gru_kernel": ("gru_kernel", False, None),
    "gru_flow_kernel": ("gru_flow_kernel", False, None),
}
LR = np.asarray([1e-3, 2e-3, 3e-3], np.float32)


def _stacked_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 5, 8, 3)).astype(np.float32),
            rng.standard_normal((3, 5, 8, 1)).astype(np.float32))  # fmt: skip


@functools.lru_cache(maxsize=None)
def _jax_step(label):
    """jax.vmap(mr_train_step) of three slots from JAX's initial weights:
    (the initial params and AdamW state, host-side, and the step's metrics and
    first moments)."""
    encoder, fused, qat = ROWS[label]
    jcfg = jmerinda.MRConfig(encoder=encoder, fused=fused, quant=qat and jquant.QuantConfig(*qat),
                             **SMALL)  # fmt: skip
    keys = jax.random.split(jax.random.key(5), 3)
    jp = jax.vmap(lambda k: jmerinda.init_mr(k, jcfg))(keys)
    jo = jax.vmap(jadamw_init)(jp)
    ys, us = _stacked_inputs()
    step = jax.vmap(lambda p, o, y, u, r: jmerinda.mr_train_step(p, o, jcfg, y, u, r))
    _, jo2, jm = step(jp, jo, jnp.asarray(ys), jnp.asarray(us), jnp.asarray(LR))
    host = lambda t: jax.tree.map(np.asarray, t)
    return host(jp), host(jo), host(jm), host(jo2.m)


def _rule_functions(monkeypatch, dt):
    """Force the dispatch to the kernel Functions and build them with the
    plain versions as kernels; returns every Function's call counts."""
    monkeypatch.setattr(rt, "resolve_dispatch", lambda t, force=False: rt.Dispatch.KERNEL)
    counts = {}
    for module, name, reference, fixed in (
        (mr_ops, "_MRStepFn", mr_step_reference, {}),
        (mr_ops, "_MRStepLTCFn", mr_step_ltc_reference, dict(dt=dt)),
        (mr_ops, "_MRStepNodeFn", mr_step_node_reference, dict(dt=dt)),
        (gru_ops, "_GRUScanFn", gru_scan_reference, {}),
    ):
        fn, counts[name] = _plain_function(name, reference, **fixed)
        monkeypatch.setattr(module, name, fn)
    return counts


@pytest.mark.parametrize("route", ["plain", "rule"])
@pytest.mark.parametrize("label", list(ROWS))
def test_stacked_step_matches_jax_vmap(label, route, monkeypatch):
    encoder, fused, qat = ROWS[label]
    cfg = merinda.MRConfig(encoder=encoder, fused=fused, quant=qat and quant.QuantConfig(*qat),
                           **SMALL)  # fmt: skip
    jp, jo, jm, jmoments = _jax_step(label)
    p, o = convert.params_from_numpy(jp), convert.opt_from_numpy(jo)
    ys, us = map(torch.from_numpy, _stacked_inputs())
    counts = _rule_functions(monkeypatch, cfg.dt) if route == "rule" else None
    _, o2, m = engine.stacked_train_step(p, o, cfg, ys, us, torch.from_numpy(LR))
    for k in ("loss", "recon_mse", "sparsity_l1", "grad_norm"):
        np.testing.assert_allclose(m[k].numpy(), jm[k], err_msg=k, **STEP)
    for a, b in zip(jax.tree.leaves(convert.opt_to_numpy(o2).m), jax.tree.leaves(jmoments)):
        np.testing.assert_allclose(a, b, **STEP)
    if counts is not None:
        used = {"gru_flow": "_MRStepFn", "gru": "_MRStepFn", "ltc": "_MRStepLTCFn",
                "node": "_MRStepNodeFn"}.get(encoder, "_GRUScanFn")  # fmt: skip
        for name, c in counts.items():
            assert c == ({"one": 0, "slots": 1} if name == used else {"one": 0, "slots": 0}), name


# ---------------------------------------------------------------------------
# (c) fused services in lockstep with JAX's
# ---------------------------------------------------------------------------
BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
CCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=16,
            delta_tol=0.0)  # fmt: skip


@functools.lru_cache(maxsize=1)
def _lorenz():
    _, ys, _ = jgenerate("lorenz", n_samples=400)
    return np.asarray(ys)


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


@pytest.mark.parametrize("encoder", ["gru", "ltc"])
def test_fused_service_runs_in_lockstep_with_jax(encoder, monkeypatch):
    """Four streams through two slots on both packages, fused composite ticks:
    the same slot maps and evictions (every one at max_steps), recovered theta
    within 1e-3; cold starts carried over from JAX's keys."""
    jcfg = jmerinda.MRConfig(encoder=encoder, fused=True, **BASE)
    jkey = jax.random.key(0)

    def jax_cold_start(seed, stream_id, cfg, device):
        p, o = jstream.cold_start(jax.random.fold_in(jkey, 1000 + stream_id), jcfg)
        return (convert.params_from_numpy(jax.tree.map(np.asarray, p), device),
                convert.opt_from_numpy(jax.tree.map(np.asarray, o), device))  # fmt: skip

    monkeypatch.setattr(stream, "cold_start", jax_cold_start)
    lor = _lorenz()
    data = np.stack([lor[16 * i : 16 * i + 96] for i in range(4)]).astype(np.float32)
    common = dict(mode="stream", n_slots=2, encoder=encoder, fused=True, seed=0, **BASE)
    jspec = japi.RecoverySpec(stream=jstream.StreamConfig(**CCFG), **common,
                              tick=japi.TickSpec(steps_per_tick=8, control="host"))  # fmt: skip
    spec = api.RecoverySpec(stream=StreamConfig(**CCFG), **common,
                            tick=api.TickSpec(steps_per_tick=8, tick_kernel="composite"))  # fmt: skip
    plan = api.compile_plan(spec, device="cpu")
    assert plan.lowering.fused and plan.lowering.tick_kernel == "composite"
    jsvc, svc = japi.compile_plan(jspec).make_service(), plan.make_service()
    jtrace, trace = _traffic(jsvc, data), _traffic(svc, data)
    assert trace == jtrace
    assert [e[2] for e in trace[1]] == ["budget"] * 4 and jsvc.done and svc.done
    for sid in range(4):
        np.testing.assert_allclose(
            svc.results[sid].theta, jsvc.results[sid].theta, rtol=1e-3, atol=1e-3
        )


# ---------------------------------------------------------------------------
# (d) batch mode against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("encoder", ["gru_flow", "ltc"])
def test_fused_run_batch_matches_jax(encoder, monkeypatch):
    """10 steps of three systems from JAX's initial weights (``system_keys``)
    at batch_size=None: Theta within 1e-3 relative (the bound a 10-step run
    is held to in ``tests/test_torch_main_path.py``), 1e-5 absolute."""
    ys, us = _stacked_inputs()
    common = dict(mode="batch", encoder=encoder, fused=True, steps=10, seed=3, **SMALL)
    jplan = japi.compile_plan(japi.RecoverySpec(**common))
    want = np.asarray(jplan.run_batch(jnp.asarray(ys), jnp.asarray(us)))
    jcfg = jmerinda.MRConfig(encoder=encoder, fused=True, **SMALL)
    starts = iter([convert.params_from_numpy(jax.tree.map(np.asarray, jmerinda.init_mr(k, jcfg)))
                   for k in japi.plan.engine.system_keys(3, 3)])  # fmt: skip
    monkeypatch.setattr(engine, "init_mr", lambda g, cfg, device: next(starts))
    plan = api.compile_plan(api.RecoverySpec(**common), device="cpu")
    assert plan.lowering.fused and plan.lowering.block_b is None
    got = plan.run_batch(ys, us).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) what the plan and the slot-axis wrappers refuse; serve_mr --fused
# ---------------------------------------------------------------------------
def test_stream_block_b_must_divide_a_slots_windows():
    """As ``tests/test_api.py:279``: a stream's compile-time batch is its
    windows a slot (4 here); block_b=2 divides it, 3 does not."""
    scfg = StreamConfig(buf_len=32, window=8, stride=8, chunk=8)
    spec = lambda bb: api.RecoverySpec(mode="stream", n_slots=2, stream=scfg, fused=True,
                                       block_b=bb, **BASE)  # fmt: skip
    with pytest.raises(ValueError, match="divide"):
        api.compile_plan(spec(3), device="cpu")
    assert api.compile_plan(spec(2), device="cpu").lowering.block_b == 2
    # "auto" fits the slot form: 2 slots x 4 windows, at least 8 blocks
    assert api.compile_plan(spec("auto"), device="cpu").lowering.block_b == 1


def test_tile_counts_the_slots():
    """The slot form's grid holds S * B / block_b blocks against min(S * B, 132)."""
    args = ("gru", 64, 4, 32, 64, 45)
    assert tiling.fit_block_b(*args) == 1  # 64 windows: one a block
    assert tiling.fit_block_b(*args, slots=4) == 1  # 256 windows: still under 132 blocks at 2
    assert tiling.fit_block_b("ltc", 16, 4, 32, 64, 45, slots=33) == 4  # 528 windows, 132 blocks
    assert tiling.fit_block_b("gru_scan", 8, 4, 32, slots=66) == 4


def test_slot_wrappers_refuse_what_the_grid_does_not_take():
    ops = [t[0] for t in _operands("gru", 1, 2, 3, 3, 8, 12, 6, seed=4)]
    kw = dict(flow=True)
    many = ops[0].expand(rt.MAX_SLOTS + 1, *ops[0].shape)
    in_dims = (0,) + (None,) * 10
    with pytest.raises(ValueError, match="slots"):
        mr_ops.mr_step_slots_cuda(many, *ops[1:], in_dims=in_dims, **kw)
    with pytest.raises(ValueError, match="no operand has a slot axis"):
        mr_ops.mr_step_slots_cuda(*ops, in_dims=(None,) * 11, **kw)
    with pytest.raises(ValueError, match="in_dims"):
        mr_ops.mr_step_slots_cuda(*ops, in_dims=(1,) + (None,) * 10, **kw)
    with pytest.raises(ValueError, match="must be on"):  # a CPU tensor: no kernel runs here
        mr_ops.mr_step_slots_cuda(ops[0][None], *ops[1:], in_dims=in_dims, **kw)


@pytest.mark.parametrize("encoder", ["gru", "ltc"])
def test_serve_mr_fused_runs_end_to_end_on_the_cpu(encoder):
    args = serve_mr.build_parser().parse_args(
        f"--device cpu --fused --encoder {encoder} --streams 3 --slots 2 --hidden 8 --buf-len 48 "
        "--window 12 --stride 6 --chunk 8 --min-steps 16 --max-steps 32".split()
    )
    out = serve_mr.serve(args, verbose=False)
    assert out["plan"].lowering.fused and out["plan"].spec.fused
    assert len(out["service"].results) == 3 and len(out["rows"]) == 3
    assert all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in out["rows"])
    assert out["stats"]["ticks"] == 8  # two waves of 32 steps at K=8
