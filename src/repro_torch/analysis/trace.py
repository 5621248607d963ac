"""Observe one call of an eager program: what the plan rules read.

Stands in for ``repro/analysis/hlo.py``. The JAX package's rules read the
optimized HLO text of a compiled program: its donation aliases, entry
parameters, host-transfer ops and collectives. An eager PyTorch program has no
such text, so this module runs the program once and records what it does:

- **device waits** (rule R3): every op that makes the host wait for the device
  (``_local_scalar_dense``, which ``.item()``, ``bool()``, ``int()`` and
  ``float()`` of a tensor reach; ``nonzero``, ``masked_select``,
  ``is_nonzero``, ``equal``, the ``unique`` ops; indexing with a boolean mask)
  and every copy from a CUDA tensor to the CPU, or to the device from the CPU
  that is not non-blocking from pinned memory, including a tensor made on the
  device from host data (``torch.tensor(data, device=...)``,
  ``torch.as_tensor``, ``torch.asarray``);
- **kernel operands** (R4): the name and dtype of each operand handed to a
  kernel, through ``kernels/runtime.observe_operands`` (every launch's
  ``check_operands``, and the plain versions of the int8 serving kernels);
- **crossings** (R5): every copy between two devices (a host-to-device copy
  is the host's input, not a shard's traffic; R3 reads it), and every read or
  write of a *foreign* storage, one the caller marks as another shard's (counting
  storages, not devices, is what lets R5 bind on a mesh that lists one device
  twice);
- **copies kept alive** (R1): after the call, each leaf of the trees the call
  replaces (``donated``) must share its storage with a leaf of the output, or
  its storage must be unreachable (``torch.multiprocessing.reductions.StorageWeakRef``).

The ops are seen through a ``TorchDispatchMode``, so the trace runs on the CPU
as on the card; the factories that take host data, whose copy to the device
runs below the dispatcher's Python key, through a ``TorchFunctionMode``. What
it cannot see: other work that bypasses the dispatcher. A
kernel's ctypes launch is seen only through ``observe_operands``; a host read
that does not dispatch an op is not seen at all: ``.numpy()`` and ``.tolist()``
of a CPU tensor, ``data_ptr()``, ``torch.cuda.synchronize()``, an event's or a
stream's ``synchronize()``. On the card the plan auditor runs each program a
second time under ``torch.cuda.set_sync_debug_mode("error")``, which sees the
waits the CUDA runtime makes, whatever made them.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Mapping, Sequence

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import runtime as rt

#: aten ops that make the host wait for the device's result (the op's name
#: -> what reaches it)
SYNC_OPS: dict[str, str] = {
    "_local_scalar_dense": "a tensor read as a Python number (.item(), bool(), int(), float())",
    "nonzero": "nonzero: an output whose size depends on the data",
    "masked_select": "masked_select: an output whose size depends on the data",
    "is_nonzero": "a tensor read as a Python bool",
    "equal": "torch.equal: a Python bool",
    "_unique2": "unique: an output whose size depends on the data",
    "unique_dim": "unique: an output whose size depends on the data",
    "unique_consecutive": "unique_consecutive: an output whose size depends on the data",
}
INDEX_OPS = ("index", "index_put", "index_put_", "_index_put_impl_")
#: factories that copy host data (a list, a number, an array) to their device
FACTORIES = (torch.tensor, torch.as_tensor, torch.asarray)
COPY_OPS = ("_to_copy", "copy_", "_copy_from")


@dataclasses.dataclass(frozen=True)
class Event:
    """One observation: ``kind`` names it (``"wait"``, ``"cross_device_copy"``,
    ``"foreign_read"``, ``"foreign_write"``), ``op`` is the aten op."""

    kind: str
    op: str
    detail: str


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One call of a kernel (or of its plain version): operand name -> dtype."""

    kernel: str
    dtypes: tuple[tuple[str, str], ...]


@dataclasses.dataclass
class Trace:
    """What one call of a program did."""

    program: str
    waits: list[Event] = dataclasses.field(default_factory=list)
    crossings: list[Event] = dataclasses.field(default_factory=list)
    kernel_calls: list[KernelCall] = dataclasses.field(default_factory=list)
    donated: list[str] = dataclasses.field(default_factory=list)  # replaced leaves checked
    kept_alive: list[str] = dataclasses.field(default_factory=list)  # ... reachable, not output


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def named_leaves(tree: Any, prefix: str) -> list[tuple[str, torch.Tensor]]:
    """The tensors of a nested NamedTuple, tuple, list or dict, each named by
    its path (``state.params.encoder.w``); None and Python numbers hold none."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = ((f"[{i}]", sub) for i, sub in enumerate(tree))
    elif isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    else:
        return []
    out = []
    for key, sub in items:
        sep = "" if key.startswith("[") else "."
        out += named_leaves(sub, f"{prefix}{sep}{key}")
    return out


def storage_key(t: torch.Tensor) -> int:
    """Identity of a tensor's storage (a view shares its base's)."""
    return t.untyped_storage()._cdata


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's index, so two names of one card compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _tensors(x: Any) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for sub in x for t in _tensors(sub)]
    return []


class _Observer(TorchDispatchMode):
    def __init__(self, trace: Trace, foreign: set[int]):
        super().__init__()
        self.trace = trace
        self.foreign = foreign

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in SYNC_OPS:
            self.trace.waits.append(Event("wait", name, SYNC_OPS[name]))
        elif name in INDEX_OPS and any(
            t.dtype == torch.bool for idx in args[1:2] for t in _tensors(idx)
        ):
            self.trace.waits.append(Event("wait", name, "indexing with a boolean mask"))
        if name in COPY_OPS:
            self._copy(name, args, kwargs)
        if self.foreign:
            self._foreign(func, name, args, kwargs)
        return func(*args, **kwargs)

    def _copy(self, name, args, kwargs) -> None:
        if not all(isinstance(a, torch.Tensor) for a in args[: 1 if name == "_to_copy" else 2]):
            return  # a Python number wrapped on the way: no device to cross
        if name == "_to_copy":
            source, dst, rest = args[0], torch.device(kwargs.get("device") or args[0].device), ()
        elif name == "copy_":  # copy_(self, src, non_blocking)
            source, dst, rest = args[1], args[0].device, args[2:]
        else:  # _copy_from(self, dst, non_blocking)
            source, dst, rest = args[0], args[1].device, args[2:]
        src, dst = _indexed(source.device), _indexed(dst)
        if src == dst:
            return
        detail = f"{src} -> {dst}"
        if src.type == "cuda" and dst.type == "cpu":
            self.trace.waits.append(Event("wait", name, f"a copy to the CPU ({detail})"))
        elif src.type == "cpu":
            # the host's input: the host waits unless the copy is non-blocking
            # from pinned memory (from pageable memory the runtime stages it
            # through a bounce buffer, and may wait for the device to do so)
            non_blocking = bool(rest[0] if rest else kwargs.get("non_blocking", False))
            if not non_blocking:
                what = f"a blocking copy to the device ({detail})"
            elif not source.is_pinned():
                what = f"a copy to the device from pageable memory ({detail})"
            else:
                return
            self.trace.waits.append(Event("wait", name, what))
        else:  # device to device: traffic between shards
            self.trace.crossings.append(Event("cross_device_copy", name, detail))

    def _foreign(self, func, name, args, kwargs) -> None:
        schema = func._schema.arguments
        for i, arg in enumerate(schema):
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in _tensors(value):
                if t.numel() and storage_key(t) in self.foreign:
                    write = arg.alias_info is not None and arg.alias_info.is_write
                    kind = "foreign_write" if write else "foreign_read"
                    self.trace.crossings.append(Event(kind, name, f"argument {arg.name!r}"))


class _Factories(TorchFunctionMode):
    """A tensor made on a device from host data: a blocking copy that the
    dispatcher's Python key never sees."""

    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in FACTORIES and kwargs.get("device") is not None:
            data = args[0] if args else kwargs.get("data", kwargs.get("obj"))
            device = torch.device(kwargs["device"])
            if device.type != "cpu" and not isinstance(data, torch.Tensor):
                what = f"a blocking copy to the device (host data -> {device})"
                self.trace.waits.append(Event("wait", func.__name__, what))
        return func(*args, **kwargs)


def _watch(args: list, donated: Mapping[str, int]) -> list[tuple[str, int, StorageWeakRef]]:
    """(name, storage key, weak reference to the storage) of each non-empty
    leaf of the donated arguments."""
    return [(leaf_name, storage_key(t), StorageWeakRef(t.untyped_storage()))
            for root, i in donated.items() for leaf_name, t in named_leaves(args[i], root)
            if t.numel()]  # fmt: skip


def observe(
    program: str,
    fn,
    args: list,
    *,
    donated: Mapping[str, int] | None = None,
    foreign: Sequence[torch.Tensor] = (),
) -> Trace:
    """Run ``fn(*args)`` once and return what it did (see the module docstring).

    ``args`` is emptied: after the call nothing here holds an argument, so a
    replaced tree's leaves stay reachable only through what the call kept.
    ``donated`` names the arguments the call replaces (name -> position in
    ``args``), ``foreign`` the tensors of other shards.
    """
    trace = Trace(program)
    watched = _watch(args, donated or {})  # holds no reference to a leaf
    trace.donated = [leaf_name for leaf_name, _, _ in watched]
    foreign_keys = {storage_key(t) for t in foreign if t.numel()}

    def note(kernel: str, operands: dict) -> None:
        dtypes = tuple((k, dtype_name(t.dtype)) for k, t in operands.items() if t is not None)
        trace.kernel_calls.append(KernelCall(kernel, dtypes))

    call_args = list(args)
    args.clear()
    rt.OPERAND_OBSERVERS.append(note)
    try:
        with _Factories(trace), _Observer(trace, foreign_keys):
            out = fn(*call_args)
    finally:
        rt.OPERAND_OBSERVERS.remove(note)
    del call_args
    out_keys = {storage_key(t) for _, t in named_leaves(out, "out") if t.numel()}

    def kept() -> list[str]:
        return [leaf_name for leaf_name, key, ref in watched
                if not ref.expired() and key not in out_keys]  # fmt: skip

    # a leaf that only a reference cycle still holds is not kept: collect
    # the cycles before naming any (only then, a collection costs ~0.1 s)
    if kept():
        gc.collect()
    trace.kept_alive = kept()
    return trace
