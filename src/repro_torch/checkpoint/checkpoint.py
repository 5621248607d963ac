"""Async, atomic checkpoints of a tree of tensors (``repro/checkpoint/checkpoint.py``).

The on-disk layout is the JAX package's, so a directory either one writes
the other restores:

    <root>/step_00001000.tmp/        # staged writes
    <root>/step_00001000/            # atomic rename when complete
        manifest.json                # step, leaf paths, shapes, dtypes,
                                     # mesh shape/axes, wall time, leaf digests
        <leaf-path>.npy              # one file per leaf

- leaf paths: a NamedTuple field by name, a list or tuple entry by index, a
  dict entry by key (keys sorted), joined with "/" (``a/b`` is stored as
  ``a__b.npy``); ``None`` holds no leaf. This is ``jax.tree_util``'s key path
  of the same structure.
- async: ``save_checkpoint(..., block=False)`` stages device -> host first
  (every leaf copied into pinned host memory, then one wait for the card) and
  writes the files on a background thread; ``CheckpointManager.wait()`` joins
  before the next save.
- atomic: writes land in ``step_N.tmp``, renamed to ``step_N`` only after the
  manifest (written last) is fsynced; restore ignores a torn ``.tmp``.
- retention: the ``keep`` newest checkpoints stay, older ones are deleted.
- integrity: per-leaf CRC32 digests, checked on restore.
- a bfloat16 (or float8) leaf is stored as its same-width unsigned bits, with
  its logical dtype in the manifest.

- meshes: the manifest records the mesh's shape and axis names (the slot
  mesh's ``("slots",)``, ``runtime/elastic.SlotMesh``); a restore given one
  device per shard splits every leaf's leading axis over them, so a snapshot
  written on a mesh of any size restores onto a mesh of another
  (reshard-on-restore).
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")

# dtypes numpy cannot np.save natively, stored as same-width unsigned bits:
# name -> (torch dtype, stored numpy dtype, the bits as torch reads them)
_EXOTIC_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8),
}
_NUMPY_BITS = {torch.int16: np.int16, torch.uint8: np.uint8}
_EXOTIC_BY_TORCH = {v[0]: k for k, v in _EXOTIC_DTYPES.items()}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a container node; None for a leaf."""
    if _is_namedtuple(tree):
        return [(name, getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), sub) for i, sub in enumerate(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return None


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out += _flatten(sub, f"{prefix}/{key}" if prefix else key)
    return out


def _unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in ``_flatten`` order."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(sub, leaves) for sub in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    if isinstance(like, dict):
        rebuilt = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: rebuilt[k] for k in like}
    return next(leaves)


def _logical_view(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype (bfloat16 and
    float8 from their stored bits)."""
    if logical_dtype in _EXOTIC_DTYPES:
        dtype, _, bits = _EXOTIC_DTYPES[logical_dtype]
        return torch.from_numpy(arr.copy().view(_NUMPY_BITS[bits])).view(dtype)
    return torch.from_numpy(arr.copy())


def _stage(leaves: list[tuple[str, Any]]) -> list[tuple[str, np.ndarray, str]]:
    """Device -> host: (path, stored array, logical dtype) for every leaf.

    Tensors on the card are copied into pinned host memory without waiting,
    then the card is waited for once. Every array is a copy, so later
    in-place updates of the tree cannot reach a write in flight.
    """
    hosts, cards = [], set()
    for key, leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                cards.add(leaf.device)
            else:
                host = leaf.clone()
            hosts.append((key, host))
        else:
            hosts.append((key, np.array(leaf)))
    for device in cards:
        torch.cuda.synchronize(device)
    out = []
    for key, host in hosts:
        if isinstance(host, np.ndarray):
            out.append((key, host, str(host.dtype)))
        elif host.dtype in _EXOTIC_BY_TORCH:
            name = _EXOTIC_BY_TORCH[host.dtype]
            _, store, bits = _EXOTIC_DTYPES[name]
            out.append((key, host.view(bits).numpy().view(store), name))
        else:
            arr = host.numpy()
            out.append((key, arr, str(arr.dtype)))
    return out


def _mesh_record(mesh) -> dict:
    """The manifest's mesh entry: its shape and axis names (None without one)."""
    if mesh is None:
        return {"shape": None, "axes": None}
    shape = getattr(mesh, "shape", None) or np.shape(mesh.devices)
    return {"shape": [int(s) for s in shape], "axes": list(mesh.axis_names)}


def save_checkpoint(
    root: str | os.PathLike,
    step: int,
    state,
    mesh=None,
    keep: int = 3,
    block: bool = True,
) -> threading.Thread | None:
    """Write ``state`` under root/step_{step}. See the module doc."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"step_{step:08d}.tmp"
    final = root / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    manifest = {"step": int(step), "time": time.time(), "mesh": _mesh_record(mesh), "leaves": {}}
    # synchronous part: device -> host, before the caller's next update
    leaves = _stage(_flatten(state))

    def _write():
        for key, store, logical_dtype in leaves:
            fn = key.replace("/", "__") + ".npy"
            with open(tmp / fn, "wb") as f:
                np.save(f, store)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = {
                "file": fn,
                "shape": list(store.shape),
                "dtype": logical_dtype,
                "crc32": zlib.crc32(store.tobytes()) & 0xFFFFFFFF,
            }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _apply_retention(root, keep)

    if block:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _apply_retention(root: pathlib.Path, keep: int):
    steps = sorted(
        (int(m.group(1)), p) for p in root.iterdir() if p.is_dir() and (m := _STEP_RE.match(p.name))
    )
    for _, p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str | os.PathLike) -> int | None:
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = [
        int(m.group(1))
        for p in root.iterdir()
        if p.is_dir() and (m := _STEP_RE.match(p.name))
        and (p / "manifest.json").exists()  # ignore torn .tmp and unpublished
    ]
    return max(steps) if steps else None


def _placement(ref, device) -> torch.device:
    """Where a restored leaf goes: the device of its ``like`` tensor, else
    ``device``."""
    if isinstance(ref, torch.Tensor) and ref.device.type != "meta":
        return ref.device
    return torch.device(device)


def restore_checkpoint(
    root: str | os.PathLike,
    step: int,
    like,
    shardings=None,
    verify: bool = True,
    expect_axes: tuple[str, ...] | None = None,
    device: str | torch.device = "cpu",
):
    """Restore into the structure of ``like`` (a tree of tensors, arrays, or
    anything with a ``shape``). Each leaf goes to ``shardings`` (one device,
    or a list of one), else to its ``like`` tensor's device, else to
    ``device``.

    ``shardings`` a list of M > 1 devices, one a shard, splits every leaf's
    leading axis into M equal parts and returns M trees, part ``i`` on
    ``shardings[i]`` (reshard-on-restore); a leading axis that M does not
    divide raises.

    ``expect_axes`` names the mesh axes the restoring caller shards over;
    when both it and the manifest's recorded axes are present and disagree,
    the restore fails up front. ``None`` on either side is compatible with
    anything. Returns (tree, manifest).
    """
    root = pathlib.Path(root)
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    saved_axes = (manifest.get("mesh") or {}).get("axes")
    if expect_axes is not None and saved_axes is not None:
        if tuple(saved_axes) != tuple(expect_axes):
            raise ValueError(
                f"checkpoint {d} was written on mesh axes {tuple(saved_axes)} "
                f"but the restoring caller shards over {tuple(expect_axes)}; "
                "snapshots only reshard within the same logical axes "
                "(size may change, names may not)"
            )

    shard_devices = None
    if isinstance(shardings, (list, tuple)):
        if len(shardings) > 1:
            shard_devices = [torch.device(d) for d in shardings]
        shardings = shardings[0] if shardings else None
    out_leaves = []
    for key, ref in _flatten(like):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint {d} missing leaf {key!r}")
        arr = np.load(d / meta["file"])
        if verify and (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != meta["crc32"]:
            raise IOError(f"checkpoint corruption in {key!r} ({meta['file']})")
        expect = tuple(getattr(ref, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"{key!r}: checkpoint shape {arr.shape} != expected {expect}")
        leaf = _logical_view(arr, meta["dtype"])
        if shard_devices is not None:
            M = len(shard_devices)
            if leaf.ndim == 0 or leaf.shape[0] % M:
                raise ValueError(
                    f"{key!r}: leading axis of {tuple(leaf.shape)} does not split over {M} shards"
                )
            parts = leaf.chunk(M)
            out_leaves.append([part.to(d, copy=True) for part, d in zip(parts, shard_devices)])
            continue
        where = torch.device(shardings) if shardings is not None else _placement(ref, device)
        out_leaves.append(leaf.to(where))
    if shard_devices is not None:
        return [_unflatten(like, iter([parts[i] for parts in out_leaves]))
                for i in range(len(shard_devices))], manifest  # fmt: skip
    return _unflatten(like, iter(out_leaves)), manifest


class CheckpointManager:
    """Owns a checkpoint directory: async saves, retention, restart logic."""

    def __init__(self, root: str | os.PathLike, keep: int = 3, save_every: int = 100):
        self.root = pathlib.Path(root)
        self.keep = keep
        self.save_every = save_every
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, state, mesh=None, force: bool = False):
        if not force and (self.save_every <= 0 or step % self.save_every != 0):
            return
        self.wait()  # at most one async save in flight
        self._pending = save_checkpoint(self.root, step, state, mesh=mesh, keep=self.keep,
                                        block=False)  # fmt: skip

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest(self) -> int | None:
        return latest_step(self.root)

    def restore_latest(self, like, shardings=None, expect_axes=None, device="cpu"):
        step = self.latest()
        if step is None:
            return None, None
        return restore_checkpoint(self.root, step, like, shardings, expect_axes=expect_axes,
                                  device=device)  # fmt: skip
