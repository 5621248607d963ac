"""repro_torch's leaf modules against the JAX package, and the port's boundaries.

Same inputs, made with numpy from a seed, go through the JAX function and its
counterpart in the port. Tolerances: <= 1e-6 relative for the library, the
ODE steppers, AdamW and clipping (float32 rounding of the same arithmetic);
<= 1e-4 relative for ``generate_trajectory``, whose float32 RK4 over 3,200
fine steps accumulates the two frameworks' different orderings; exact for
``make_windows`` (the same numpy code).
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoders as jencoders
from repro.core import library as jlib
from repro.core import ode as jode
from repro.core.merinda import MRConfig as JMRConfig
from repro.core.merinda import init_mr as jinit_mr
from repro.core.neural_flow import gru_scan_ref as jgru_scan_ref
from repro.core.neural_flow import init_gru as jinit_gru
from repro.data import dynamics as jdyn
from repro.data.windows import make_windows as jmake_windows
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro_torch import convert
from repro_torch.api import RecoverySpec, TickSpec
from repro_torch.core import encoders, library, ode
from repro_torch.core.merinda import MRConfig
from repro_torch.core.neural_flow import GRUParams, gru_scan_ref
from repro_torch.core.quant import QuantConfig
from repro_torch.data import dynamics
from repro_torch.data.windows import make_windows
from repro_torch.kernels.mr_step import tiling
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

REPO = pathlib.Path(__file__).resolve().parents[1]
LEAF = dict(rtol=1e-6, atol=1e-7)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n_vars,order", [(2, 2), (3, 2), (3, 3), (4, 2)])
def test_polynomial_features_matches_jax(n_vars, order):
    x = _rng(n_vars * 10 + order).standard_normal((5, 7, n_vars)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the double-where guard's case
    got = library.polynomial_features(torch.from_numpy(x), n_vars, order).numpy()
    want = np.asarray(jlib.polynomial_features(jnp.asarray(x), n_vars, order))
    np.testing.assert_allclose(got, want, **LEAF)
    assert library.term_names(n_vars, order) == jlib.term_names(n_vars, order)


def test_polynomial_features_gradient_is_finite_at_zero_and_matches_jax():
    x = np.array([[0.0, 1.5], [-2.0, 0.0]], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(library.polynomial_features(xt, 2, 2).sum(), xt)
    jg = jax.grad(lambda v: jlib.polynomial_features(v, 2, 2).sum())(jnp.asarray(x))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **LEAF)


def test_denormalize_theta_matches_jax():
    rng = _rng(1)
    theta = rng.standard_normal((6, 2))
    mean, scale = rng.standard_normal(2), rng.uniform(0.5, 3.0, 2)
    got = library.denormalize_theta(theta, mean, scale, n_vars=2, order=2)
    want = jlib.denormalize_theta(theta, mean, scale, n_vars=2, order=2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def _field(lib):
    A = np.array([[-0.3, 1.0], [-1.2, -0.1]], np.float32)

    def f(y, u, t, args):
        return y @ lib.asarray(A) + 0.1 * y * y

    return f


class _T:
    asarray = staticmethod(torch.as_tensor)


@pytest.mark.parametrize("method", ["rk4", "euler", "heun"])
def test_odeint_matches_jax(method):
    y0 = np.array([[1.0, -0.5], [0.2, 0.7]], np.float32)
    ts = (np.arange(40, dtype=np.float32) * np.float32(0.05)).astype(np.float32)
    got = ode.odeint(_field(_T), torch.from_numpy(y0), torch.from_numpy(ts), method=method)
    want = jode.odeint(_field(jnp), jnp.asarray(y0), jnp.asarray(ts), method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LEAF)


def _tree(seed):
    rng = _rng(seed)
    return {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float32),
    }


def test_adamw_matches_jax():
    params, jparams = _tree(0), None
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tstate, jstate = adamw_init(tparams), jadamw.adamw_init(jparams)
    for step in range(3):
        grads = _tree(10 + step)
        tparams, tstate = adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate,
            tparams,
            lr=1e-2,
            weight_decay=1e-4,
        )
        jparams, jstate = jadamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams, lr=1e-2, weight_decay=1e-4
        )
    for k in params:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), **LEAF)
        np.testing.assert_allclose(tstate.m[k].numpy(), np.asarray(jstate.m[k]), **LEAF)
        np.testing.assert_allclose(tstate.v[k].numpy(), np.asarray(jstate.v[k]), **LEAF)
    assert int(tstate.step) == int(jstate.step) == 3


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(3)
    got, norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
    want, jnorm = jclip.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), **LEAF)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **LEAF)


@pytest.mark.parametrize("name", ["lotka_volterra", "damped_oscillator"])
def test_generate_trajectory_matches_jax(name):
    ts, ys, us = dynamics.generate_trajectory(name)
    jts, jys, jus = jdyn.generate_trajectory(name)
    np.testing.assert_allclose(ts, jts, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ys, jys, rtol=1e-4, atol=1e-4 * np.abs(jys).max())
    assert us.shape == jus.shape
    np.testing.assert_array_equal(dynamics.true_coef(name), jdyn.get_system(name).true_coef())


def test_registry_matches_jax():
    assert sorted(dynamics.SYSTEMS) == sorted(jdyn.SYSTEMS)
    for name, spec in dynamics.SYSTEMS.items():
        jspec = jdyn.SYSTEMS[name]
        assert (spec.state_dim, spec.input_dim, spec.order, spec.y0, spec.dt, spec.t_end) == (
            jspec.state_dim,
            jspec.input_dim,
            jspec.order,
            jspec.y0,
            jspec.dt,
            jspec.t_end,
        )
        np.testing.assert_array_equal(spec.true_coef(), jspec.true_coef())


def test_make_windows_matches_jax_exactly():
    _, ys, us = jdyn.generate_trajectory("controlled_pendulum", n_samples=300)
    for stride in (1, 4):
        yw, uw, norm = make_windows(ys, us, window=32, stride=stride)
        jyw, juw, jnorm = jmake_windows(ys, us, window=32, stride=stride)
        np.testing.assert_array_equal(yw, jyw)
        np.testing.assert_array_equal(uw, juw)
        for k in ("mean", "scale"):
            np.testing.assert_array_equal(norm[k], jnorm[k])


@pytest.mark.parametrize("flow", [True, False])
def test_gru_scan_ref_matches_jax(flow):
    jp = jinit_gru(jax.random.key(4), 3, 16)
    jp = jp._replace(time_scale=jnp.asarray(_rng(4).standard_normal(16), jnp.float32))
    p = GRUParams(*(torch.from_numpy(np.array(x)) for x in jp))
    xs = _rng(5).standard_normal((3, 9, 3)).astype(np.float32)
    h0 = np.zeros((3, 16), np.float32)
    hT, hs = gru_scan_ref(p, torch.from_numpy(xs), torch.from_numpy(h0), flow=flow)
    jhT, jhs = jgru_scan_ref(jp, jnp.asarray(xs), jnp.asarray(h0), flow=flow)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), rtol=1e-5, atol=1e-6)


def test_encoder_registry_has_the_gru_rows_and_refuses_the_rest():
    """Every row of the JAX registry, field for field; unknown names raise."""
    assert encoders.encoder_names() == jencoders.encoder_names()
    for name in encoders.encoder_names():
        row, jrow = encoders.get_encoder(name), jencoders.get_encoder(name)
        fields = ("flow", "fusable", "kernel", "int8", "family")
        assert [getattr(row, f) for f in fields] == [getattr(jrow, f) for f in fields], name
    assert encoders.get_encoder("ltc").family == "ltc"
    assert encoders.get_encoder("node").flow is None
    with pytest.raises(ValueError, match="unknown encoder"):
        encoders.get_encoder("lstm")


def test_unported_options_raise():
    """QAT, the ltc/node encoders, the batch and stream modes, int8 serving,
    the device control plane, service checkpoints and the slot mesh are
    ported; a mesh outside stream mode raises, as in the JAX package."""
    cfg = MRConfig(state_dim=2, encoder="ltc", quant=QuantConfig(4, 10, 2, 12))
    assert cfg.quant.act_bits == 14 and cfg.ltc_substeps == 6
    assert RecoverySpec(state_dim=2, encoder="node", qat=QuantConfig()).to_mr_config().quant
    assert RecoverySpec(state_dim=2, mode="batch").mode == "batch"
    assert RecoverySpec(state_dim=2, mode="stream").stream_config().n_windows == 17
    assert RecoverySpec(state_dim=2, encoder="gru", precision="int8_pwl").precision == "int8_pwl"
    assert RecoverySpec(state_dim=2, mode="stream", mesh_slots=2).mesh_slots == 2
    with pytest.raises(ValueError, match="mesh_slots"):
        RecoverySpec(state_dim=2, mode="batch", mesh_slots=2)
    assert TickSpec(control="device").control == "device"
    assert TickSpec(checkpoint_period=1, checkpoint_dir="snapshots").checkpoint_period == 1


def test_tiling_fits_shared_memory_and_fills_the_card():
    cfg = MRConfig(state_dim=2, hidden=32, dense_hidden=64)
    assert tiling.auto_block_b(cfg, "gru", 64) == 1  # 64 blocks: fewer windows than SMs
    assert tiling.auto_block_b(cfg, "gru", 1024) == 4  # largest divisor leaving >= 132 blocks
    assert tiling.auto_block_b(cfg, "gru", None) is None
    # MRConfig defaults (H=64, Dh=128): about 109 KB staged (the weights, 86 KB, and
    # one warp's area), above the 48 KB static limit
    big = MRConfig(state_dim=2)
    assert 100_000 < tiling.config_smem_bytes(big, "gru", 1) < 120_000
    with pytest.raises(ValueError, match="no batch tile fits"):
        tiling.auto_block_b(big, "gru", 64, smem_budget_bytes=50_000)
    # the readout batch of the quickstart is prime: a training tile of 2 is dropped
    assert tiling.legal_block_b(1, 193) == 1
    assert tiling.legal_block_b(2, 193) is None
    assert tiling.fit_block_b("gru", 193, 2, 32, 64, 12) == 1


def test_params_round_trip_through_numpy():
    jcfg = JMRConfig(state_dim=2, hidden=8, dense_hidden=16)
    jp = jax.tree.map(np.asarray, jinit_mr(jax.random.key(0), jcfg))
    p = convert.params_from_numpy(jp)
    back = convert.params_to_numpy(p)
    np.testing.assert_array_equal(back.encoder.w, jp.encoder.w)
    np.testing.assert_array_equal(back.head_w2, jp.head_w2)
    assert p.encoder.w.dtype == torch.float32


# ---------------------------------------------------------------------------
# independence: the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_nothing_of_repro():
    prog = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('PASS', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True, env=env, timeout=300
    )
    assert p.returncode == 0 and "PASS" in p.stdout, p.stderr[-3000:]


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s))", re.M)


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"
