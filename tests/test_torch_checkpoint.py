"""The port's checkpoints and service snapshots against the JAX package's.

- twins of ``tests/test_checkpoint.py:31-96``: a round trip with a bfloat16
  leaf, a torn ``.tmp`` ignored, retention, corruption caught by the CRC, a
  shape mismatch, mesh axes that disagree, the async manager; and the
  refusal of more than one device;
- a directory that JAX's ``save_checkpoint`` wrote restores through the
  port's ``restore_checkpoint`` to equal arrays, and the reverse, for a tree
  with a bfloat16 leaf and for a service's SlotState and ControlState;
- the bitwise service round trip of ``tests/test_runtime.py:66`` on the port:
  every SlotState and ControlState leaf restored bit for bit, the tick
  counter rewound, and the restored service in lockstep with the original to
  completion; a JAX service's snapshot restores into a port service.
"""

from __future__ import annotations

import json
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.core import stream as jstream
from repro.data.dynamics import generate_trajectory as jgenerate
from repro_torch import api
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.stream import StreamConfig
from repro_torch.tree import tree_leaves

Mesh = namedtuple("Mesh", "devices axis_names")
BASE = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
SCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=8, min_steps=16, max_steps=32,
            delta_tol=0.0)  # fmt: skip


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn(8, 16, generator=g).to(torch.bfloat16),
            "b": torch.arange(16, dtype=torch.float32),
        },
        "opt": {"m": torch.zeros(8, 16), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _like(s):
    return {k: {kk: torch.empty(v.shape, dtype=v.dtype) for kk, v in d.items()} for k, d in s.items()}


def test_roundtrip_including_bf16(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, 10, s)
    r, manifest = restore_checkpoint(tmp_path, 10, _like(s))
    assert manifest["step"] == 10
    assert manifest["leaves"]["params/w"]["dtype"] == "bfloat16"
    for a, b in zip(tree_leaves(s), tree_leaves(r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_latest_ignores_torn_tmp(tmp_path):
    save_checkpoint(tmp_path, 5, _state())
    (tmp_path / "step_00000009.tmp").mkdir()  # a crash mid-write
    (tmp_path / "step_00000009.tmp" / "x.npy").write_bytes(b"garbage")
    assert latest_step(tmp_path) == 5


def test_retention_keeps_newest(tmp_path):
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, step, _state(), keep=2)
    steps = sorted(int(p.name[5:]) for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert steps == [4, 5]


def test_corruption_detected(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, 3, s)
    d = tmp_path / "step_00000003"
    fn = json.loads((d / "manifest.json").read_text())["leaves"]["params/w"]["file"]
    raw = bytearray((d / fn).read_bytes())
    raw[-1] ^= 0xFF
    (d / fn).write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(tmp_path, 3, _like(s))


def test_shape_mismatch_rejected(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, 1, s)
    bad = {k: {kk: torch.empty((1,) + tuple(v.shape)) for kk, v in d.items()} for k, d in s.items()}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 1, bad)


def test_mesh_axes_mismatch_rejected_and_one_device_only(tmp_path):
    """As ``tests/test_checkpoint.py:72``: axes recorded at save that differ
    from the restoring caller's fail up front; matching or absent axes pass.
    A mesh of more than one device is recorded, and a restore sharding of
    more than one device splits the leading axis (one tree a device); a
    leading axis it does not divide raises."""
    s = _state()
    save_checkpoint(tmp_path, 2, s, mesh=Mesh(np.empty((1,), object), ("data",)))
    with pytest.raises(ValueError, match="mesh axes .* shards over"):
        restore_checkpoint(tmp_path, 2, _like(s), expect_axes=("slots",))
    r, _ = restore_checkpoint(tmp_path, 2, _like(s), expect_axes=("data",))
    assert r is not None
    save_checkpoint(tmp_path, 3, s)
    r, _ = restore_checkpoint(tmp_path, 3, _like(s), expect_axes=("slots",))
    assert r is not None
    save_checkpoint(tmp_path, 4, s, mesh=Mesh(np.empty((2,), object), ("slots",)))
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["mesh"] == {"shape": [2], "axes": ["slots"]}
    even = {k: {kk: v for kk, v in d.items() if v.ndim and v.shape[0] % 2 == 0}
            for k, d in s.items()}  # fmt: skip
    save_checkpoint(tmp_path, 5, even)
    parts, _ = restore_checkpoint(tmp_path, 5, _like(even), shardings=["cpu", "cpu"])
    assert len(parts) == 2
    for k, d in even.items():
        for kk, v in d.items():
            assert torch.equal(torch.cat([parts[0][k][kk], parts[1][k][kk]]), v)
    with pytest.raises(ValueError, match="split"):  # the scalar step has no leading axis
        restore_checkpoint(tmp_path, 3, _like(s), shardings=["cpu", "cpu"])


def test_async_manager(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, save_every=2)
    s = _state()
    for step in range(6):
        mgr.maybe_save(step, s)
    mgr.wait()
    assert mgr.latest() == 4
    r, manifest = mgr.restore_latest(_like(s))
    assert manifest["step"] == 4 and torch.equal(r["params"]["b"], s["params"]["b"])


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------
def _jax_state():
    k = jax.random.key(0)
    return {
        "params": {
            "w": jax.random.normal(k, (8, 16)).astype(jnp.bfloat16),
            "b": jnp.arange(16, dtype=jnp.float32),
        },
        "opt": {"m": jnp.ones((8, 16)), "step": jnp.asarray(7, jnp.int32)},
    }


def test_a_jax_checkpoint_restores_in_the_port_and_the_reverse(tmp_path):
    js = _jax_state()
    jsave(tmp_path, 1, js)
    like = {"params": {"w": torch.empty(8, 16, dtype=torch.bfloat16), "b": torch.empty(16)},
            "opt": {"m": torch.empty(8, 16), "step": torch.empty((), dtype=torch.int32)}}  # fmt: skip
    r, _ = restore_checkpoint(tmp_path, 1, like)
    assert r["params"]["w"].dtype == torch.bfloat16 and r["opt"]["step"].shape == ()
    for a, b in zip(jax.tree.leaves(js), tree_leaves(r)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    save_checkpoint(tmp_path, 2, r)
    jlike = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), js)
    back, manifest = jrestore(tmp_path, 2, jlike)
    assert manifest["step"] == 2
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# service snapshots
# ---------------------------------------------------------------------------
def _spec(tmp_path, checkpoint_period=2):
    scfg = StreamConfig(**SCFG)
    return api.RecoverySpec(
        mode="stream", n_slots=2, stream=scfg, seed=0, encoder="gru", **BASE,
        tick=api.TickSpec(steps_per_tick=8, control="device", queue_capacity=8, snapshot_period=1,
                          warm_capacity=8, checkpoint_period=checkpoint_period,
                          checkpoint_dir=str(tmp_path)),
    )  # fmt: skip


def _ys():
    _, ys, _ = jgenerate("lorenz", n_samples=400, noise_std=0.01, seed=0)
    return np.asarray(ys, np.float32)


def test_service_checkpoint_roundtrip_bitwise(tmp_path):
    """As ``tests/test_runtime.py:66``: a restored service replays the
    original's trajectory exactly."""
    ys = _ys()
    svc = api.compile_plan(_spec(tmp_path), device="cpu").make_service()
    for sid in range(4):
        svc.submit(sid, ys[sid : sid + 32])
    svc.fill_slots()
    chunk = np.repeat(ys[32:40][None], 2, axis=0)
    for _ in range(2):
        svc.tick_once(chunk)
    svc.checkpointer.wait()
    assert svc.checkpointer.manager.latest() == 2
    svc.checkpointer.period = 0  # one writer from here on

    svc2 = api.compile_plan(_spec(tmp_path), device="cpu").make_service()
    info = svc2.checkpointer.restore_into(svc2)
    assert info["step"] == 2
    assert info["resident"] == {0, 1} and info["queued"] == {2, 3}
    assert svc2.ticks == svc.ticks == 2
    for a, b in zip(tree_leaves(svc.state), tree_leaves(svc2.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(svc.control), tree_leaves(svc2.control)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for _ in range(8):
        i1, i2 = svc.tick_once(chunk), svc2.tick_once(chunk)
        np.testing.assert_array_equal(i1["steps"], i2["steps"])
        if svc.done and svc2.done:
            break
    assert svc.results.keys() == svc2.results.keys() == {0, 1, 2, 3}
    for sid in svc.results:
        np.testing.assert_array_equal(svc.results[sid].theta, svc2.results[sid].theta)


def test_a_jax_service_snapshot_restores_into_a_port_service(tmp_path):
    """JAX's device-plane service snapshots after two ticks; a fresh port
    service restores it: every SlotState and ControlState leaf equals JAX's,
    and the queued streams are the JAX service's."""
    ys = _ys()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jspec = japi.RecoverySpec(
        mode="stream", n_slots=2, stream=jstream.StreamConfig(**SCFG), seed=0, encoder="gru",
        **BASE, tick=japi.TickSpec(steps_per_tick=8, control="device", queue_capacity=8,
                                   snapshot_period=1, warm_capacity=8, checkpoint_period=2,
                                   checkpoint_dir=str(jdir)),
    )  # fmt: skip
    jsvc = japi.compile_plan(jspec).make_service()
    for sid in range(4):
        jsvc.submit(sid, ys[sid : sid + 32])
    jsvc.fill_slots()
    chunk = np.repeat(ys[32:40][None], 2, axis=0)
    for _ in range(2):
        jsvc.tick_once(chunk)
    jsvc.checkpointer.wait()
    svc = api.compile_plan(_spec(pdir), device="cpu").make_service()
    svc.checkpointer.manager.root = jdir
    info = svc.checkpointer.restore_into(svc)
    assert info["step"] == 2 and svc.ticks == 2
    assert info["resident"] == {0, 1} and info["queued"] == {2, 3}
    for a, b in zip(tree_leaves(svc.state), jax.tree.leaves(jsvc.state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(svc.control), jax.tree.leaves(jsvc.control)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and the port's snapshot of the restored state restores in the JAX package
    svc.checkpointer.manager.root = pdir
    svc.checkpointer.save(svc)
    svc.checkpointer.wait()
    like = {"slots": jsvc.state, "control": jsvc.control}
    back, _ = jrestore(pdir, 2, jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                             like))  # fmt: skip
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(like)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
