"""The port's int8/PWL serving against the JAX package.

``precision="int8_pwl"`` serves through int8 weights (one float scale per
output channel) and piecewise-linear sigmoid and tanh tables. At the JAX
tests' own sizes, inputs made with numpy, the JAX int8 paths in interpret
mode (the Pallas kernel bodies) and with ``force_reference``:

- ``quantize_int8``: codes and scales equal to JAX's, on 2-D and
  slot-stacked weights, ties included; the PWL tables equal to JAX's and
  ``pwl_apply`` within 1e-7 of JAX's over [-10, 10];
- ``gru_scan_int8`` (B=4, T=20, D=8, H=32) and ``mr_step_int8`` on ``gru``
  (4, 20, 3, 32, 64) and on ``ltc`` (4, 12, 3, 32, 64) within 1e-6, the JAX
  kernel tests' bound (``tests/test_kernels_mr_step.py:9``);
- ``mr_tick(quant=True)`` over ``tests/test_tick.py:107``'s sweep: buffers
  exact, theta and delta within 1e-5 (against JAX's Pallas kernel with the
  kernel's saturation values: see ``test_mr_tick_int8_matches_jax``);
- the int8 output differs from the fp32 output by more than 1e-7 and less
  than 0.1 (0.25 for the tick), JAX's budget tests;
- every refusal and the int8 shared-memory models.

The slice as a whole (plans, the service, ``serve_mr --quant``) is
``tests/test_torch_int8_slice.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import stream as jstream
from repro.core.merinda import MRConfig as JMRConfig
from repro.core.merinda import init_mr as jinit_mr
from repro.core.neural_flow import init_gru as jinit_gru
from repro.kernels.gru_scan.ops import gru_scan_int8 as jgru_scan_int8
from repro.kernels.mr_step.ops import mr_step_int8 as jmr_step_int8
from repro.kernels.mr_step.tick import mr_tick as jmr_tick
from repro_torch import api, convert
from repro_torch.api import plan as plan_mod
from repro_torch.core import merinda, quant, stream
from repro_torch.core.neural_flow import GRUParams
from repro_torch.core.stream import StreamConfig
from repro_torch.kernels.gru_scan.ops import gru_scan_int8
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ops import mr_step_int8
from repro_torch.kernels.mr_step import tick as tick_mod
from repro_torch.kernels.mr_step.tick import mr_tick, tick_supported
from repro_torch.tree import tree_stack

KERNEL_TOL = 1e-6  # tests/test_kernels_mr_step.py:9, the JAX int8 kernels' bound
TICK_TOL = 1e-5  # tests/test_tick.py:111
BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
TCFG = dict(buf_len=16, window=8, stride=4, chunk=4, steps_per_tick=0, min_steps=10**9,
            max_steps=10**9)  # fmt: skip
CCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=16,
            delta_tol=0.0)  # fmt: skip
DISPATCH = [dict(interpret=True), dict(force_reference=True)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _port_params(jp):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------------------
# core/quant.py: int8 codes and the PWL tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(34, 96), (4, 34, 96)], ids=["2d", "slot-stacked"])
def test_quantize_int8_codes_and_scales_match_jax(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    # exact ties: w / scale lands on k + 0.5 for the first columns of slot 0
    flat = w.reshape(-1, *shape[-2:])
    amax = np.abs(flat[0]).max(axis=0)
    flat[0, 1, :4] = np.float32([0.5, -1.5, 2.5, 126.5]) * (amax[:4] / np.float32(127.0))
    w = flat.reshape(shape)
    batch = len(shape) - 2
    got = quant.quantize_int8(_t(w), batch_dims=batch)
    jq = jquant.quantize_int8 if batch == 0 else jax.vmap(jquant.quantize_int8)
    want = jq(jnp.asarray(w))
    assert got.values.dtype == torch.int8 and got.scale.shape == _np(want.scale).shape
    np.testing.assert_array_equal(got.values.numpy(), _np(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), _np(want.scale))
    np.testing.assert_array_equal(
        quant.dequantize_int8(got).numpy(), _np(jquant.dequantize_int8(want))
    )


@pytest.mark.parametrize("n_seg", [16, 64])
@pytest.mark.parametrize("name", ["sigmoid", "tanh"])
def test_pwl_tables_match_jax(name, n_seg):
    table = getattr(quant, f"make_{name}_table")(n_seg)
    jtable = getattr(jquant, f"make_{name}_table")(n_seg)
    np.testing.assert_array_equal(table.slopes.numpy(), _np(jtable.slopes))
    np.testing.assert_array_equal(table.intercepts.numpy(), _np(jtable.intercepts))
    assert (table.x_min, table.x_max, table.left, table.right) == (
        jtable.x_min, jtable.x_max, jtable.left, jtable.right,
    )  # fmt: skip
    x = np.linspace(-10.0, 10.0, 40001).astype(np.float32)
    got = quant.pwl_apply(table, _t(x)).numpy()
    np.testing.assert_allclose(got, _np(jquant.pwl_apply(jtable, jnp.asarray(x))), atol=1e-7, rtol=0)
    fn = np.tanh if name == "tanh" else (lambda v: 1.0 / (1.0 + np.exp(-v)))
    assert quant.pwl_max_error(table, fn) == pytest.approx(jquant.pwl_max_error(jtable, fn))
    # outside the table: the function's values at its ends, as JAX's pwl_apply
    ends = quant.pwl_apply(table, torch.tensor([-100.0, 100.0])).tolist()
    assert ends == [np.float32(fn(table.x_min)), np.float32(fn(table.x_max))]
    # the packed form the kernels read: slopes, intercepts, x_min, x_max, width, left, right
    pack = quant.pwl_pack(table).numpy()
    assert pack.shape == (quant.pwl_floats(n_seg),)
    np.testing.assert_array_equal(pack[-5:-3], [table.x_min, table.x_max])
    assert pack[-3] == np.float32((table.x_max - table.x_min) / n_seg)


def test_serving_tables_are_the_jax_wrappers():
    """The int8 path's fixed segment count is the JAX wrappers' default, and
    the packed tables the kernels read are those tables."""
    import inspect

    for fn in (jgru_scan_int8, jmr_step_int8, jmr_tick):
        default = inspect.signature(fn).parameters["n_seg"].default
        assert default == quant.N_SEG, fn.__name__
    assert quant.PWL_FLOATS == quant.pwl_floats(quant.N_SEG)
    for table, pack, name in zip(quant.serving_tables(), quant.serving_packs("cpu"),
                                 ("sigmoid", "tanh")):  # fmt: skip
        jtable = getattr(jquant, f"make_{name}_table")(quant.N_SEG)
        np.testing.assert_array_equal(table.slopes.numpy(), _np(jtable.slopes))
        np.testing.assert_array_equal(pack.numpy(), quant.pwl_pack(table).numpy())


# ---------------------------------------------------------------------------
# the int8 stages against JAX's kernels (interpret) and oracles
# ---------------------------------------------------------------------------
def test_gru_scan_int8_matches_jax():
    B, T, D, H = 4, 20, 8, 32
    jp = jinit_gru(jax.random.key(1), D, H)
    params = GRUParams(*(_t(x) for x in jp))
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.1).astype(np.float32)
    h_T, hs = gru_scan_int8(params, _t(xs), _t(h0))
    assert hs.shape == (B, T, H) and torch.equal(h_T, hs[:, -1])
    for dispatch in DISPATCH:
        _, jhs = jgru_scan_int8(jp, jnp.asarray(xs), jnp.asarray(h0), **dispatch)
        np.testing.assert_allclose(hs.numpy(), _np(jhs), atol=KERNEL_TOL, rtol=0)


def _stage_setup(B, T, n, H, Dh, encoder, seed=0):
    kw = dict(state_dim=n, order=2, hidden=H, dense_hidden=Dh, dt=0.01, encoder=encoder)
    jcfg, cfg = JMRConfig(**kw), merinda.MRConfig(**kw)
    jp = jinit_mr(jax.random.key(seed), jcfg)
    xs = np.random.default_rng(seed + 1).standard_normal((B, T, n)).astype(np.float32)
    return jcfg, cfg, jp, _port_params(jp), xs


@pytest.mark.parametrize("encoder,T", [("gru", 20), ("ltc", 12)])
def test_mr_step_int8_matches_jax(encoder, T):
    jcfg, cfg, jp, params, xs = _stage_setup(4, T, 3, 32, 64, encoder)
    theta, shifts = mr_step_int8(params, cfg, _t(xs))
    assert theta.shape == (4, cfg.n_terms, 3)
    for dispatch in DISPATCH:
        jtheta, jshifts = jmr_step_int8(jp, jcfg, jnp.asarray(xs), **dispatch)
        np.testing.assert_allclose(theta.numpy(), _np(jtheta), atol=KERNEL_TOL, rtol=0)
        np.testing.assert_allclose(shifts.numpy(), _np(jshifts), atol=KERNEL_TOL, rtol=0)


@pytest.mark.parametrize("encoder,T", [("gru", 30), ("ltc", 20)])
def test_int8_stage_is_quantized_and_within_budget(encoder, T):
    """As ``tests/test_kernels_mr_step.py:239, 267``: the int8 stage within
    0.1 of the float path, and actually quantized."""
    _, cfg, _, params, xs = _stage_setup(4, T, 3, 32, 64, encoder)
    theta_f, _ = merinda.mr_forward(params, cfg, _t(xs), None)
    theta_q, _ = mr_step_int8(params, cfg, _t(xs))
    err = (theta_f - theta_q).abs().max().item()
    assert 1e-7 < err < 0.1, err


def _tick_operands(m, S=4):
    """Slot-stacked weights (the port's init, carried to JAX's layout as
    numpy) and tick operands made with numpy; slot S-1 is inactive and every
    other slot seeds its EMA."""
    cfg = merinda.MRConfig(input_dim=m, encoder="gru", **BASE)
    params = tree_stack([merinda.init_mr(torch.Generator().manual_seed(i), cfg, "cpu")
                         for i in range(S)])  # fmt: skip
    rng = np.random.default_rng(1)
    n, L, C = 3, TCFG["buf_len"], TCFG["chunk"]
    mk = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    ops = (mk(S, L, n), mk(S, L, m), mk(S, C, n), mk(S, C, m), mk(S, n, s=0.1),
           rng.uniform(0.5, 1.5, (S, n)).astype(np.float32), mk(S, cfg.n_terms, n, s=0.3),
           np.array([True, False] * (S // 2)), np.array([True] * (S - 1) + [False]))  # fmt: skip
    return cfg, params, ops


def _asymptote_tables():
    """The tables with JAX's Pallas kernels' saturation values: 0 and 1 for
    the sigmoid, -1 and 1 for the tanh (``_pwl_eval``'s call sites,
    ``repro/kernels/gru_scan/kernel.py:190-193``), where ``pwl_apply`` and
    every JAX oracle take the function's values at the table's ends."""
    sig, tanh = quant.serving_tables()
    return sig._replace(left=0.0, right=1.0), tanh._replace(left=-1.0, right=1.0)


@pytest.mark.parametrize("m,spb", [(0, 1), (2, 2)])
def test_mr_tick_int8_matches_jax(m, spb, monkeypatch):
    """``tests/test_tick.py:107``'s sweep. Against JAX's oracle: buffers
    exact, theta and delta within 1e-5. Against JAX's Pallas kernel
    (interpret) the same, once the port's tables saturate where that kernel
    does: at m=0 a pre-activation leaves the tanh table's range, and the two
    JAX paths themselves differ there (theta by 2.4e-6, delta by 2.9e-5)."""
    cfg, params, ops = _tick_operands(m)
    jcfg = JMRConfig(input_dim=m, encoder="gru", **BASE)
    jp = convert.params_to_numpy(params)
    scfg, jargs = StreamConfig(**TCFG), (jp, jcfg, jstream.StreamConfig(**TCFG))
    jops = tuple(map(jnp.asarray, ops))

    def check(got, want):
        for name, g, w in zip(("buf_y", "buf_u", "theta", "delta"), got, want):
            if name.startswith("buf"):
                np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)
            else:
                np.testing.assert_allclose(g.numpy(), _np(w), atol=TICK_TOL, rtol=0, err_msg=name)

    got = mr_tick(params, cfg, scfg, *map(_t, ops), quant=True, slots_per_bank=spb)
    check(got, jmr_tick(*jargs, *jops, quant=True, slots_per_bank=spb, force_reference=True))
    assert torch.isinf(got[3][-1]) and torch.isfinite(got[3][:-1]).all()
    monkeypatch.setattr(tick_mod, "serving_tables", _asymptote_tables)
    asym = mr_tick(params, cfg, scfg, *map(_t, ops), quant=True, slots_per_bank=spb)
    check(asym, jmr_tick(*jargs, *jops, quant=True, slots_per_bank=spb, interpret=True))
    # as tests/test_tick.py:115: the int8 readout tracks the fp32 one, and differs
    theta_f = mr_tick(params, cfg, scfg, *map(_t, ops), slots_per_bank=spb)[2]
    assert 1e-7 < (got[2] - theta_f).abs().max().item() < 0.25


# ---------------------------------------------------------------------------
# refusals, models, entry points
# ---------------------------------------------------------------------------
def test_int8_refusals():
    base = dict(state_dim=3, mode="offline", precision="int8_pwl")
    for encoder in ("gru_flow", "node", "gru_flow_kernel"):
        with pytest.raises(ValueError, match="int8_pwl"):
            api.compile_plan(api.RecoverySpec(encoder=encoder, **base), device="cpu")
    for encoder in ("gru_flow", "node"):
        _, cfg, _, params, xs = _stage_setup(2, 6, 3, 8, 16, encoder)
        with pytest.raises(ValueError, match="int8-capable"):
            mr_step_int8(params, cfg, _t(xs))
    flow = merinda.MRConfig(encoder="gru_flow", **BASE)
    assert tick_supported(flow) and not tick_supported(flow, int8=True)
    assert tick_supported(merinda.MRConfig(encoder="gru", **BASE), int8=True)
    with pytest.raises(ValueError, match="GRU"):
        mr_tick(None, flow, StreamConfig(**TCFG), *([None] * 9), quant=True)
    # the int8 tick on a flow row: banked raises, auto falls back to composite
    monitor = dict(mode="stream", encoder="gru_flow", stream=StreamConfig(**TCFG), **BASE)
    for kernel, want in (("banked", None), ("auto", ("composite", None))):
        spec = api.RecoverySpec(tick=api.TickSpec(steps_per_tick=0, tick_kernel=kernel), **monitor)
        if want is None:
            with pytest.raises(ValueError, match="GRU-family"):
                plan_mod._resolve_tick_kernel(spec, spec.to_mr_config(), True)
        else:
            assert plan_mod._resolve_tick_kernel(spec, spec.to_mr_config(), True) == want
    # training ticks and the composite tick read out in fp32 under int8_pwl
    service = dict(mode="stream", encoder="gru", precision="int8_pwl", stream=StreamConfig(**CCFG),
                   **BASE)  # fmt: skip
    training = api.compile_plan(
        api.RecoverySpec(tick=api.TickSpec(tick_kernel="banked"), **service), device="cpu"
    )
    assert training.tick.keywords["quant"] is False
    composite = api.compile_plan(api.RecoverySpec(**service), device="cpu")
    assert composite.lowering.tick_kernel == "composite" and composite.tick.func is stream.tick
    assert composite.make_service().quant


def test_int8_shared_memory_models():
    """Every int8 carve is smaller than its fp32 twin's; the readout batch of
    193 windows (a prime) takes one window a block, as in fp32; the int8 LTC,
    a warp a window, takes a tile past 1024 (window, unit) pairs."""
    D, H, Dh, K = 2, 32, 64, 12
    fp32 = dict(gru=tiling.mr_step_smem_bytes, ltc=tiling.ltc_smem_bytes,
                gru_scan=lambda D, H, Dh, K, bb: tiling.gru_scan_smem_bytes(D, H, bb))  # fmt: skip
    for family in ("gru", "ltc", "gru_scan"):
        for bb in (1, 4):
            q = tiling.family_smem_bytes(family, D, H, Dh, K, bb, int8=True)
            assert 0 < q < fp32[family](D, H, Dh, K, bb)
        assert tiling.fit_block_b(family, 193, D, H, Dh, K, int8=True) == 1
    assert tiling.fit_block_b("gru", 1024, D, H, Dh, K, int8=True) == 4
    assert tiling.fit_block_b("ltc", 4096, D, H, Dh, K, int8=True) == 16  # 256 blocks
    # H = 64, 132 blocks of 32 windows: 2,048 (window, unit) pairs a block
    assert tiling.fit_block_b("ltc", 132 * 32, D, 64, 128, K, int8=True) == 32
    with pytest.raises(ValueError, match="int8 kernel"):
        tiling.family_smem_bytes("node", D, H, Dh, K, 1, int8=True)
    # the gru kernel's carve (warp_cell.cuh GruQLayout), float for float at one
    # window: int8 wx, wh's 96 columns of 36 floats (at H = 32 its int8 rows),
    # two scale rows, b, two tables (37 floats, padded to 40), the int8 head;
    # then one warp's two rows of 64, two x chunks [16, 2] and 16 steps of the
    # gates' x.Wx
    block = (2 * 96 // 4 + 96 * 36 + 3 * 96 + 2 * 40 + 32 * 64 // 4 + 2 * 64 + 64 * 12 // 4
             + 2 * 12)  # fmt: skip
    assert tiling.int8_smem_bytes(D, H, Dh, K, 1) == 4 * (block + 2 * 64 + 2 * 32 + 16 * 3 * 32)
    # the LTC's (LtcQLayout): w_rec's 32 columns of 36 floats, int8 w_in, five
    # rows of H, the sigmoid table, the int8 head; a warp's rows, x chunks and drives
    block = (32 * 36 + 2 * 32 // 4 + 5 * 32 + 40 + 32 * 64 // 4 + 2 * 64 + 64 * 12 // 4
             + 2 * 12)  # fmt: skip
    assert tiling.ltc_int8_smem_bytes(D, H, Dh, K, 1) == 4 * (block + 2 * 64 + 2 * 32 + 16 * 32)
    cfg = merinda.MRConfig(input_dim=1, encoder="gru", **dict(BASE, hidden=32, dense_hidden=64))
    scfg = StreamConfig()
    q = tiling.config_tick_smem_bytes(cfg, scfg, int8=True)
    assert q == tiling.tick_smem_bytes(4, 32, 64, 45, 17, 32, int8=True)
    assert q < tiling.config_tick_smem_bytes(cfg, scfg)
    # the int8 tick's block of a slot's cluster, float for float at the serve
    # shape: int8 wx and wh's 96 columns of 36 bytes, two scale rows, b, two
    # tables (37 floats, padded to 40), the int8 head, the [17, 45] outputs;
    # then 6 warps of two rows, the window's x [32, 4] and 16 steps of slots
    block = (4 * 96 // 4 + 96 * 36 // 4 + 3 * 96 + 2 * 40 + 32 * 64 // 4 + 2 * 64
             + 64 * 45 // 4 + 2 * 48 + 17 * 45 + 3)  # fmt: skip
    assert q == 4 * (block + 6 * (2 * 64 + 32 * 4 + 16 * 3 * 32))
    assert tiling.auto_slots_per_bank(cfg, scfg, 4, int8=True) == 1
    assert tiling.auto_slots_per_bank(cfg, scfg, 4, smem_budget_bytes=1024, int8=True) == 0
