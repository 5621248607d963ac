"""repro_torch's LTC and NODE baselines and fixed-point QAT against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port; JAX parameters reach the port through
``repro_torch.convert``. The Pallas kernels run under the interpreter
(``interpret=True``) and through their pure-JAX reference
(``force_reference=True``), as ``tests/test_kernels_mr_step.py`` runs them.

Tolerances:
- ``quantize_fixed``: exact (the same float32 arithmetic, round half to even);
- the LTC and NODE scans and ``multi_step_solver_cell``: <= 1e-5 relative
  (float32 sums in another order over up to 54 dependent substeps);
- the fused stages' plain versions against the JAX kernels: <= 1e-4, the JAX
  package's own fp32 bound (``tests/test_kernels_mr_step.py:7-11``);
The main path of the two baselines and of QAT is in
``tests/test_torch_main_path.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoders as jencoders
from repro.core import merinda as jmerinda
from repro.core import ode as jode
from repro.core import quant as jquant
from repro.core.ltc import init_ltc as jinit_ltc
from repro.core.ltc import ltc_op_counts as jltc_op_counts
from repro.core.ltc import ltc_scan as jltc_scan
from repro.core.node_mr import init_node_encoder as jinit_node
from repro.core.node_mr import node_scan as jnode_scan
from repro.kernels.mr_step.ops import mr_step as jmr_step
from repro_torch import convert
from repro_torch.core import encoders, merinda, ode, quant
from repro_torch.core.ltc import LTCParams, ltc_op_counts, ltc_scan
from repro_torch.core.node_mr import NodeEncoderParams, init_node_encoder, node_scan
from repro_torch.kernels.mr_step import tiling
from repro_torch.kernels.mr_step.ops import (
    mr_step,
    mr_step_cuda,
    mr_step_ltc_cuda,
    mr_step_node_cuda,
)

SCAN = dict(rtol=1e-5, atol=1e-6)
KERNEL = dict(rtol=1e-4, atol=1e-4)
QAT = (4, 10, 2, 12)  # act int/frac bits, weight int/frac bits
COARSE_QAT = (2, 3, 2, 12)  # an activation step coarse enough to move the head by ~1e-2
# (B, T, n_state, hidden, dense_hidden): tests/test_kernels_mr_step.py:148-153
SUBSTEP_SHAPES = [(1, 4, 2, 8, 16), (2, 12, 3, 32, 64), (4, 9, 3, 16, 32)]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("int_bits,frac_bits", [(4, 10), (3, 13), (2, 12), (1, 3)])
def test_quantize_fixed_is_exactly_jax(int_bits, frac_bits):
    """Random values, saturating ones and every half-grid point x*2^f = k + 0.5."""
    rng = np.random.default_rng(int_bits * 100 + frac_bits)
    top = 2.0 ** (int_bits - 1)
    half = (np.arange(-64, 64) + 0.5) / 2.0**frac_bits
    x = np.concatenate([rng.uniform(-2 * top, 2 * top, 4096), half, [top, -top, 3 * top]])
    x = x.astype(np.float32)
    got = quant.quantize_fixed(torch.from_numpy(x), int_bits, frac_bits).numpy()
    want = _np(jquant.quantize_fixed(jnp.asarray(x), int_bits, frac_bits))
    np.testing.assert_array_equal(got, want)
    # half to even: 0.5 and 1.5 grid steps go to 0 and 2
    step = 2.0**-frac_bits
    pair = torch.tensor([0.5 * step, 1.5 * step])
    assert quant.quantize_fixed(pair, int_bits, frac_bits).tolist() == [0.0, 2 * step]


def test_fake_quant_ste_gradient_is_the_identity():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    (g,) = torch.autograd.grad((quant.fake_quant_ste(x, 2, 4) * torch.arange(101.0)).sum(), x)
    torch.testing.assert_close(g, torch.arange(101.0), rtol=0, atol=0)
    q = quant.QuantConfig(4, 10, 2, 12)
    assert quant.qat_act(x, None) is x and quant.qat_weight(x, None) is x
    assert quant.act_bits(q) == (4, 10) and quant.act_bits(None) is None
    assert (q.act_bits, q.weight_bits) == (jquant.QuantConfig(*q).act_bits, 14)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_multi_step_solver_cell_matches_jax(method):
    rng = np.random.default_rng(7)
    y, u = rng.standard_normal((5, 3)).astype(np.float32), rng.standard_normal((5, 2))
    u = u.astype(np.float32)
    w = rng.standard_normal((3, 3)).astype(np.float32) * 0.5

    def jf(y, u, t, args):
        return jnp.tanh(y @ args) + jnp.sin(t) + u.sum(-1, keepdims=True)

    def f(y, u, t, args):
        return torch.tanh(y @ args) + torch.sin(torch.as_tensor(t)) + u.sum(-1, keepdim=True)

    got = ode.multi_step_solver_cell(
        f, _t(y), _t(u), torch.tensor(0.3), _t(w), method=method, n_substeps=6
    )
    want = jode.multi_step_solver_cell(
        jf, jnp.asarray(y), jnp.asarray(u), jnp.float32(0.3), jnp.asarray(w), method, 6
    )
    np.testing.assert_allclose(got.numpy(), _np(want), **SCAN)


def _ltc(seed, d_in, H):
    jp = jinit_ltc(jax.random.key(seed), d_in, H)
    rng = np.random.default_rng(seed)
    jp = jp._replace(bias=jnp.asarray(0.1 * rng.standard_normal(H), jnp.float32))
    return jp, LTCParams(*(_t(x) for x in jp))


def _node(seed, d_in, H):
    jp = jinit_node(jax.random.key(seed), d_in, H)
    rng = np.random.default_rng(seed)
    jp = jp._replace(b_f1=jnp.asarray(0.1 * rng.standard_normal(H), jnp.float32))
    return jp, NodeEncoderParams(*(_t(x) for x in jp))


@pytest.mark.parametrize("dt,n_substeps", [(1.0, 6), (0.05, 6), (0.1, 1), (0.05, 9)])
@pytest.mark.parametrize("family", ["ltc", "node"])
def test_substep_scans_match_jax(family, dt, n_substeps):
    B, T, D, H = 3, 6, 3, 16
    jp, p = (_ltc if family == "ltc" else _node)(11, D, H)
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B, H))).astype(np.float32)
    scan, jscan = (ltc_scan, jltc_scan) if family == "ltc" else (node_scan, jnode_scan)
    hT, hs = scan(p, _t(xs), _t(h0), dt=dt, n_substeps=n_substeps)
    jhT, jhs = jscan(jp, jnp.asarray(xs), jnp.asarray(h0), dt=dt, n_substeps=n_substeps)
    np.testing.assert_allclose(hs.numpy(), _np(jhs), **SCAN)
    np.testing.assert_allclose(hT.numpy(), _np(jhT), **SCAN)


def test_ltc_op_counts_and_inits_match_jax():
    assert ltc_op_counts(3, 32, 6, batch=4) == jltc_op_counts(3, 32, 6, batch=4)
    g = torch.Generator().manual_seed(0)
    p = init_node_encoder(g, 2, 256, "cpu")
    # w_f2 is drawn at a tenth of w_f1's scale, as in the JAX init
    ratio = (p.w_f2.std() / p.w_f1.std()).item()
    assert 0.09 < ratio < 0.11
    for name in ("ltc", "node"):
        row = encoders.get_encoder(name)
        params = row.init(torch.Generator().manual_seed(1), 3, 8, "cpu")
        jparams = jencoders.get_encoder(name).init(jax.random.key(1), 3, 8)
        assert type(params)._fields == type(jparams)._fields
        for got, want in zip(params, jparams):
            assert tuple(got.shape) == tuple(want.shape)


# ---------------------------------------------------------------------------
# the fused stages' plain versions against the JAX kernels
# ---------------------------------------------------------------------------
def _setup(B, T, n, H, Dh, encoder, seed=0, **kw):
    common = dict(state_dim=n, order=2, hidden=H, dense_hidden=Dh, dt=0.05, encoder=encoder)
    jq = kw.pop("quant", None)
    jcfg = jmerinda.MRConfig(**common, quant=jq and jquant.QuantConfig(*jq), **kw)
    cfg = merinda.MRConfig(**common, quant=jq and quant.QuantConfig(*jq), fused=True, **kw)
    jparams = jmerinda.init_mr(jax.random.key(seed), jcfg)
    xs = np.random.default_rng(seed + 1).standard_normal((B, T, n)).astype(np.float32)
    return jcfg, cfg, jparams, convert.params_from_numpy(jax.tree.map(_np, jparams)), xs


def _port(cfg, params, xs, **kw):
    with torch.no_grad():
        theta, shifts = mr_step(params, cfg, torch.from_numpy(xs), **kw)
    return theta.numpy(), shifts.numpy()


@pytest.mark.parametrize("B,T,n,H,Dh", SUBSTEP_SHAPES)
@pytest.mark.parametrize("encoder", ["ltc", "node"])
def test_substep_mr_step_plain_matches_jax_kernel(B, T, n, H, Dh, encoder):
    jcfg, cfg, jparams, params, xs = _setup(B, T, n, H, Dh, encoder)
    theta, shifts = _port(cfg, params, xs)
    for kw in (dict(interpret=True), dict(force_reference=True)):
        jt, js = jmr_step(jparams, jcfg, jnp.asarray(xs), **kw)
        np.testing.assert_allclose(theta, _np(jt), **KERNEL)
        np.testing.assert_allclose(shifts, _np(js), **KERNEL)
    # the unfused stage sequence is the same math
    with torch.no_grad():
        unfused, _ = merinda.mr_forward(
            params, dataclasses.replace(cfg, fused=False), torch.from_numpy(xs), None
        )
    np.testing.assert_allclose(theta, unfused.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("block_b", [1, 2])
@pytest.mark.parametrize("encoder", ["ltc", "node"])
def test_substep_mr_step_block_b_matches_jax_kernel(block_b, encoder):
    jcfg, cfg, jparams, params, xs = _setup(8, 7, 3, 16, 32, encoder, seed=3)
    theta, _ = _port(cfg, params, xs, block_b=block_b)
    jt, _ = jmr_step(jparams, jcfg, jnp.asarray(xs), block_b=block_b, interpret=True)
    np.testing.assert_allclose(theta, _np(jt), **KERNEL)


@pytest.mark.parametrize("encoder", ["ltc", "node"])
def test_substep_count_changes_the_result_as_in_jax(encoder):
    jcfg, cfg, jparams, params, xs = _setup(2, 6, 3, 16, 32, encoder)
    th6, _ = _port(cfg, params, xs)
    th2, _ = _port(dataclasses.replace(cfg, ltc_substeps=2), params, xs)
    jt2, _ = jmr_step(jparams, dataclasses.replace(jcfg, ltc_substeps=2), jnp.asarray(xs),
                      interpret=True)  # fmt: skip
    assert np.abs(th6 - th2).max() > 0.0
    np.testing.assert_allclose(th2, _np(jt2), **KERNEL)


@pytest.mark.parametrize("qat", [QAT, COARSE_QAT], ids=["q4.10", "q2.3"])
@pytest.mark.parametrize("encoder", ["gru_flow", "gru", "ltc", "node"])
def test_mr_step_with_act_bits_matches_jax_kernel(encoder, qat):
    """cfg.quant: QAT head weights (and GRU encoder weights), the head's Qm.n step."""
    jcfg, cfg, jparams, params, xs = _setup(4, 9, 2, 16, 32, encoder, seed=4, quant=qat)
    theta, shifts = _port(cfg, params, xs)
    for kw in (dict(interpret=True), dict(force_reference=True)):
        jt, js = jmr_step(jparams, jcfg, jnp.asarray(xs), **kw)
        np.testing.assert_allclose(theta, _np(jt), **KERNEL)
        np.testing.assert_allclose(shifts, _np(js), **KERNEL)
    # the activation step is on: without it the result moves, at Q2.3 by far
    # more than the tolerance (at Q4.10 the whole step is within it)
    plain, _ = _port(dataclasses.replace(cfg, quant=None), params, xs)
    moved = np.abs(theta - plain).max()
    assert moved >= 10 * KERNEL["atol"] if qat == COARSE_QAT else moved > 0.0


# ---------------------------------------------------------------------------
# tiling, conversion and the wrappers' contract, off the card
# ---------------------------------------------------------------------------
def test_tiling_follows_the_family():
    D, H, Dh, K = 2, 32, 64, 12
    # the warp cells (csrc/warp_cell.cuh): the block's weights once (every region
    # whole float4s, as these widths already are), then a warp's two rows of
    # max(H, Dh), two x chunks of 16 steps and 16 steps of its lanes' slots; the
    # recurrent weights column-major, H + 4 floats a column
    weights = H * Dh + Dh + Dh * K + K
    warp = 2 * Dh + 2 * 16 * D
    S = H + 4
    assert tiling.ltc_smem_bytes(D, H, Dh, K, 1) == 4 * (
        H * S + D * H + 3 * H + weights + warp + 16 * 32
    )
    assert tiling.node_smem_bytes(D, H, Dh, K, 1) == 4 * (
        2 * H * S + D * H + 3 * H + weights + warp + 16 * 32
    )
    assert tiling.family_smem_bytes("gru", D, H, Dh, K, 1) == 4 * (
        D * 3 * H + 3 * H * S + 3 * H + H + weights + warp + 2 * 16 + 16 * 3 * 32 + 16 * 32
    )
    # one area a warp, at most 8 warps a block: a tile of 9 carves 8 areas
    per_warp = tiling.node_smem_bytes(D, H, Dh, K, 2) - tiling.node_smem_bytes(D, H, Dh, K, 1)
    assert tiling.node_smem_bytes(D, H, Dh, K, 9) == tiling.node_smem_bytes(D, H, Dh, K, 1) + 7 * per_warp
    for family, encoder in (("gru", "gru_flow"), ("ltc", "ltc"), ("node", "node")):
        cfg = merinda.MRConfig(state_dim=2, hidden=H, dense_hidden=Dh, encoder=encoder)
        assert encoders.get_encoder(encoder).family == family
        smem = tiling.family_smem_bytes(family, D, H, Dh, K, 2)
        assert tiling.config_smem_bytes(cfg, family, 2) == smem
        assert tiling.auto_block_b(cfg, family, 64) == 1
    # the bare scan (csrc/gru_scan.cu) is mr_step's warp cell with no head: the
    # gate weights, b and the rates once, then a warp's two rows of H, two x and
    # dts chunks and 16 steps of its lanes' gate and phi slots
    scan = tiling.family_smem_bytes("gru_scan", D, H, Dh, K, 1)
    assert scan == 4 * (
        D * 3 * H + 3 * H * S + 3 * H + H + 2 * H + 2 * 16 * D + 2 * 16 + 16 * 3 * 32 + 16 * 32
    )
    assert tiling.fit_block_b("gru_scan", 1024, D, H) == 4
    # at H = 64 the LTC tile is the warp cells' (at least 132 blocks), for the
    # int8 twin as well: both run a warp a window
    ltc = merinda.MRConfig(state_dim=2, hidden=64, dense_hidden=128, encoder="ltc")
    assert tiling.auto_block_b(ltc, "ltc", 132 * 32) == 32
    assert tiling.auto_block_b(ltc, "ltc", 132 * 32, int8=True) == 32
    with pytest.raises(ValueError, match="unknown mr_step family"):
        tiling.family_smem_bytes("lstm", D, H, Dh, K, 1)


@pytest.mark.parametrize("encoder", ["ltc", "node"])
def test_params_round_trip_through_numpy(encoder):
    jcfg = jmerinda.MRConfig(state_dim=2, hidden=8, dense_hidden=16, encoder=encoder)
    jp = jax.tree.map(np.asarray, jmerinda.init_mr(jax.random.key(0), jcfg))
    p = convert.params_from_numpy(jp)
    assert type(p.encoder)._fields == type(jp.encoder)._fields
    back = convert.params_to_numpy(p)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError, match="unknown encoder"):
        convert.params_from_numpy(p._replace(encoder=object()))


def test_substep_wrappers_refuse_cpu_tensors_and_count_nothing():
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g)
    xs, h0, head = mk(4, 5, 2), mk(4, 8), (mk(8, 16), mk(16), mk(16, 12), mk(12))
    counters = (mr_step_cuda, mr_step_ltc_cuda, mr_step_node_cuda)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="must be on"):
        mr_step_ltc_cuda(xs, h0, mk(2, 8), mk(8, 8), mk(8), mk(8), mk(8), *head,
                         sub_dt=0.01, n_substeps=6, block_b=1)  # fmt: skip
    with pytest.raises(ValueError, match="must be on"):
        mr_step_node_cuda(xs, h0, mk(8, 8), mk(8), mk(8, 8), mk(8), mk(2, 8), mk(8), *head,
                          sub_dt=0.01, n_substeps=6, block_b=1)  # fmt: skip
    assert [f.launches for f in counters] == before
