"""Kernel runtime: the dispatch decision and the CUDA library build.

Counterpart of ``repro/kernels/runtime.py:99-132``. Three things live here:

- ``resolve_dispatch``: where a kernel-family call executes. A CUDA tensor
  takes the hand-written kernel, a CPU tensor takes the plain PyTorch
  version, and ``force_reference`` always wins (callers use it to hold a
  kernel against its plain version). There is no interpreter mode: a CUDA
  kernel cannot run off the card.
- ``load_library``: builds ``csrc/*.cu`` with ``nvcc`` into one shared
  library with a plain C interface (one ``nvcc`` per source, all started
  together, then one link), keyed by a hash of the sources and flags, under
  ``build/repro_torch/`` at the repository root, and loads it with
  ``ctypes``. A missing ``nvcc`` or a failed build raises; nothing falls
  back to the plain version.
- ``kernel_function``: the autograd Function around a kernel (backward: the
  plain version recomputed) with the vmap rule that sends a
  ``torch.func.vmap`` call to the kernel's slot-axis form, one launch for
  all slots (``slot_strides`` checks its operands; ``over_slots`` is the
  plain slot-axis version).
"""

from __future__ import annotations

import ctypes
import enum
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)

# every extern "C" launcher: name -> argument types (pointers and the stream
# as c_void_p so ctypes never truncates them to 32 bits)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
LAUNCHERS = {
    # the fused stages and the scan take a slot axis (S calls in one launch; one
    # call is S = 1): the operands, then one int64 slot stride in elements per
    # input operand (0: shared by every slot), then S and the ints
    # xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, 11 strides,
    # S, B, T, D, H, Dh, K, block_b, flow, act_int, act_frac, stream
    "mr_step_launch": [_P] * 12 + [_L] * 11 + [_I] * 11 + [_P],
    # xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, out, 11 strides,
    # S, B, T, D, H, Dh, K, block_b, n_substeps, unroll, act_int, act_frac, sub_dt, stream
    "mr_step_ltc_launch": [_P] * 12 + [_L] * 11 + [_I] * 12 + [_F, _P],
    # xs, h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2, out, 12 strides,
    # S, B, T, D, H, Dh, K, block_b, n_substeps, unroll, act_int, act_frac, sub_dt, stream
    "mr_step_node_launch": [_P] * 13 + [_L] * 12 + [_I] * 12 + [_F, _P],
    # xs, h0, wx, wh, b, time_scale, dts, hs, 7 strides, S, B, T, D, H, block_b, flow,
    # stream
    "gru_scan_launch": [_P] * 8 + [_L] * 7 + [_I] * 7 + [_P],
    # the wide form (256 < H <= 512; no slot axis): xs, h0, wx, wh, b, time_scale, dts,
    # gx (scratch [B, T, 3H]), hs, B, T, D, H, flow, stream
    "gru_scan_wide_launch": [_P] * 9 + [_I] * 5 + [_P],
    # buf_y, new_y, mean, scale, theta0, seed, active, wx, wh, b, time_scale, w1, b1,
    # w2, b2, h0, buf_u, new_u, buf_y_out, theta_out, delta_out, buf_u_out,
    # S, L, n, m, C, T, stride, H, Dh, Ko, Kc, bank, flow, ema, one_minus_ema, stream
    "mr_tick_launch": [_P] * 22 + [_I] * 13 + [_F, _F, _P],
    # the int8/PWL serving kernels: int8 weights, float scales per output
    # channel, PWL tables packed by core/quant.py serving_packs (N_SEG segments)
    # xs, h0, wxq, whq, sx, sh, b, sig, tanh, hs, B, T, D, H, block_b, n_seg, stream
    "gru_scan_int8_launch": [_P] * 10 + [_I] * 6 + [_P],
    # xs, h0, wxq, whq, sx, sh, b, sig, tanh, w1q, s1, b1, w2q, s2, b2, out,
    # B, T, D, H, Dh, K, block_b, n_seg, stream
    "mr_step_int8_launch": [_P] * 16 + [_I] * 8 + [_P],
    # xs, h0, w_inq, s_in, w_recq, s_rec, bias, a, inv_tau, sig, w1q, s1, b1, w2q, s2, b2,
    # out, B, T, D, H, Dh, K, block_b, n_substeps, n_seg, sub_dt, stream
    "mr_step_ltc_int8_launch": [_P] * 17 + [_I] * 9 + [_F, _P],
    # buf_y, new_y, mean, scale, theta0, seed, active, wxq, whq, sx, sh, b, sig, tanh,
    # w1q, s1, b1, w2q, s2, b2, h0, buf_u, new_u, buf_y_out, theta_out, delta_out,
    # buf_u_out, S, L, n, m, C, T, stride, H, Dh, Ko, Kc, bank, n_seg, ema,
    # one_minus_ema, stream
    "mr_tick_int8_launch": [_P] * 27 + [_I] * 13 + [_F, _F, _P],
    # the LM zoo's kernels, float32 or bf16 operands (the last int flags bf16)
    # x, dt, A, bm, cm, D, initial_state (or NULL), y, state, chunk_states, totals,
    # split (bf16; NULL for float32), B, T, H, P, G, N, chunk, rows, bf16, stream
    "ssd_scan_launch": [_P] * 12 + [_I] * 9 + [_P],
    # q, k, v, o, B, Sq, Sk, QH, KH, Dh, block_q, block_k, causal, window, q_offset,
    # scale, bf16, stream
    "flash_attention_launch": [_P] * 4 + [_I] * 11 + [_F, _I, _P],
}

# every kernel's exported carve: the dynamic shared memory its launcher
# requests, in bytes, for the given dims (``kernel_smem_bytes``), computed by
# the layout the launch uses
CARVES = {
    "mr_step": 5,  # D, H, Dh, K, block_b
    "gru_scan": 3,  # D, H, block_b
    "gru_scan_wide": 1,  # H (one block of a batch row's cluster)
    "mr_step_ltc": 5,
    "mr_step_node": 5,
    "mr_step_int8": 6,  # D, H, Dh, K, block_b, n_seg
    "gru_scan_int8": 4,  # D, H, block_b, n_seg
    "mr_step_ltc_int8": 6,
    "mr_tick": 6,  # D, H, Dh, Ko, T, N (one block of a slot's cluster)
    "mr_tick_int8": 7,  # D, H, Dh, Ko, T, N, n_seg
}


class Dispatch(enum.Enum):
    """Where a kernel-family call executes."""

    KERNEL = "kernel"  # hand-written CUDA kernel (a CUDA tensor)
    REFERENCE = "reference"  # plain PyTorch version (a CPU tensor, or forced)


def resolve_dispatch(tensor: torch.Tensor, force_reference: bool = False) -> Dispatch:
    """The shared dispatch policy for all kernel families."""
    if force_reference or not tensor.is_cuda:
        return Dispatch.REFERENCE
    return Dispatch.KERNEL


def pin_fp32_matmul() -> None:
    """Plain paths compute in full float32: no TF32 in products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source, header and build flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")
    return nvcc


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one shared library."""
    target = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            procs.append(
                (src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            )
            objs.append(obj)
        # wait for every compiler before judging any, so none outlives a failure
        outs = [(src, proc.communicate()[0].decode(errors="replace"), proc.returncode)
                for src, proc in procs]  # fmt: skip
        for src, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        logs = [f"== {src.name}\n{out}" for src, out, _ in outs]
        so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(so)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        (BUILD_DIR / f"{target.stem}.log").write_text("\n".join(logs))
        os.replace(so, target)
    return target


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every launcher's signature declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in LAUNCHERS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for kernel, n_dims in CARVES.items():
        fn = getattr(lib, f"{kernel}_smem_bytes")
        fn.argtypes = [_I] * n_dims
        fn.restype = ctypes.c_longlong
    return lib


def kernel_smem_bytes(kernel: str, *dims: int) -> int:
    """The dynamic shared memory a launch of ``kernel`` requests for ``dims``
    (``CARVES``), from the library's own layout code: the measured side of the
    shared-memory model in ``kernels/mr_step/tiling.py``. Builds and loads the
    library."""
    if len(dims) != CARVES[kernel]:
        raise ValueError(f"{kernel}: its carve takes {CARVES[kernel]} dims, got {len(dims)}")
    return int(getattr(load_library(), f"{kernel}_smem_bytes")(*map(int, dims)))


def check_smem(kernel: str, smem: int) -> None:
    """Raise when a launch would request more shared memory than a block has."""
    from repro_torch.kernels.mr_step.tiling import SMEM_BUDGET_BYTES

    if smem > SMEM_BUDGET_BYTES:
        raise ValueError(f"{kernel}: {smem} bytes of shared memory exceed one block's budget")


# callables ``fn(kernel, operands)`` told of every kernel call's named operands
# (``observe_operands``): the plan auditor's view of what reaches a kernel
OPERAND_OBSERVERS: list = []


def observe_operands(kernel: str, operands: dict) -> None:
    """Tell every observer of one call of ``kernel``: ``operands`` maps a name
    to the tensor handed to it. ``check_operands`` calls it for every launch;
    the plain versions of the int8 serving kernels call it too."""
    for fn in OPERAND_OBSERVERS:
        fn(kernel, operands)


def check_operands(kernel: str, device: torch.device, **operands) -> None:
    """Raise on any operand the kernel does not take.

    ``operands`` maps a name to ``(tensor, expected_shape)`` or ``(tensor,
    expected_shape, dtype)``: every tensor must be a contiguous CUDA tensor on
    ``device`` of that shape and dtype (float32 unless named).
    """
    observe_operands(kernel, {name: t for name, (t, *_) in operands.items()})
    for name, (t, shape, *dtype) in operands.items():
        dtype = dtype[0] if dtype else torch.float32
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{kernel}: {name} must be on {device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


MAX_SLOTS = 65535  # csrc/warp_cell.cuh kMaxSlots: the slot axis is the grid's y


def slot_strides(kernel: str, device: torch.device, in_dims, **operands) -> tuple[int, list[int]]:
    """Check a slot-axis launch's operands: (S, each operand's slot stride).

    ``operands`` maps a name to ``(tensor, one slot's shape[, dtype])`` as in
    ``check_operands``. Operand i with ``in_dims[i] == 0`` is [S, *shape], its
    slot stride the elements of one slot; with ``None`` it is one operand of
    ``shape`` shared by every slot, slot stride 0. Raises on anything else and
    on a slot count the grid cannot hold.
    """
    dims = tuple(in_dims)
    if len(dims) != len(operands) or any(d not in (0, None) for d in dims):
        raise ValueError(f"{kernel}: in_dims {dims} must give 0 or None for each of "
                         f"{len(operands)} operands")  # fmt: skip
    batched = [t.shape[0] for (t, *_), d in zip(operands.values(), dims) if d == 0 and t.dim()]
    if not batched:
        raise ValueError(f"{kernel}: no operand has a slot axis")
    S = batched[0]
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"{kernel}: {S} slots; the slot axis takes 1 to {MAX_SLOTS}")
    checked, strides = {}, []
    for (name, (t, shape, *dtype)), d in zip(operands.items(), dims):
        checked[name] = (t, (S, *shape) if d == 0 else shape, *dtype)
        strides.append(math.prod(shape) if d == 0 else 0)
    check_operands(kernel, device, **checked)
    return S, strides


def check_launch(name: str, err: int) -> None:
    """Raise when a launcher returned a CUDA error (refused or failed launch)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def resolve_device(device, who: str) -> torch.device:
    """``None`` -> the card; raises when a CUDA device is asked for and none
    is visible. The CPU runs only when the caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is visible; pass device='cpu' to run the plain "
            f"PyTorch versions on the CPU"
        )
    return device


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def over_slots(fn, in_dims, **kw):
    """``fn`` over a slot axis: ``torch.func.vmap`` with operand i batched
    along ``in_dims[i]`` (``None``: one operand shared by every slot) and the
    keyword arguments ``kw``. The plain slot-axis version of every kernel."""
    return torch.func.vmap(functools.partial(fn, **kw), in_dims=tuple(in_dims))


def kernel_function(name: str, kernel, slot_kernel, reference) -> type:
    """A ``torch.autograd.Function`` around a kernel, with a vmap rule.

    ``apply(kernel_kw, ref_kw, *tensors)``: forward ``kernel(*tensors,
    **kernel_kw)``; backward ``reference(*tensors, **ref_kw)`` recomputed
    (``reference_vjp``). Under ``torch.func.vmap`` (the stacked train step of
    batch and stream mode) the rule moves each batched operand's slot dim to 0
    and calls a second Function, whose forward is ONE launch of
    ``slot_kernel(*tensors, in_dims=..., **kernel_kw)`` (``in_dims`` 0 for a
    batched operand, ``None`` for one shared by every slot, slot stride 0)
    and whose backward recomputes ``reference`` vmapped over the slots
    (``over_slots``). A second vmap level raises: there is one slot axis.
    The kernels are arguments so a test can build the same Function with
    plain versions in both places.
    """

    def slot_forward(kernel_kw, ref_kw, in_dims, *tensors):
        return slot_kernel(*tensors, in_dims=in_dims, **kernel_kw)

    def slot_setup_context(ctx, inputs, output):
        ctx.ref_kw, ctx.in_dims = inputs[1], inputs[2]
        ctx.save_for_backward(*inputs[3:])

    def slot_backward(ctx, grad_out):
        grads = reference_vjp(
            over_slots(reference, ctx.in_dims, **ctx.ref_kw),
            ctx.saved_tensors,
            ctx.needs_input_grad[3:],
            grad_out,
        )
        return (None, None, None, *grads)

    def slot_vmap(info, in_dims, *args):
        raise ValueError(f"{name}: the kernels take one slot axis; a nested vmap has two")

    slot_fn = type(f"{name}Slots", (torch.autograd.Function,), dict(
        forward=staticmethod(slot_forward), setup_context=staticmethod(slot_setup_context),
        backward=staticmethod(slot_backward), vmap=staticmethod(slot_vmap),
    ))  # fmt: skip

    def forward(kernel_kw, ref_kw, *tensors):
        return kernel(*tensors, **kernel_kw)

    def setup_context(ctx, inputs, output):
        ctx.ref_kw = inputs[1]
        ctx.save_for_backward(*inputs[2:])

    def backward(ctx, grad_out):
        grads = reference_vjp(
            functools.partial(reference, **ctx.ref_kw),
            ctx.saved_tensors,
            ctx.needs_input_grad[2:],
            grad_out,
        )
        return (None, None, *grads)

    def vmap(info, in_dims, kernel_kw, ref_kw, *tensors):
        dims = in_dims[2:]
        moved = [t if d is None else t.movedim(d, 0) for t, d in zip(tensors, dims)]
        slot_dims = tuple(None if d is None else 0 for d in dims)
        out = slot_fn.apply(kernel_kw, ref_kw, slot_dims, *(t.contiguous() for t in moved))
        return out, 0

    return type(name, (torch.autograd.Function,), dict(
        forward=staticmethod(forward), setup_context=staticmethod(setup_context),
        backward=staticmethod(backward), vmap=staticmethod(vmap),
    ))  # fmt: skip


def reference_vjp(fn, inputs, needs_grad, grad_out) -> tuple:
    """Gradients of ``fn(*inputs)`` by recomputing the plain version.

    The backward of every kernel here: the JAX package differentiates its
    reference program (``repro/kernels/mr_step/ops.py:60-62``), so the port
    runs the plain version under ``torch.enable_grad()`` and pulls
    ``grad_out`` back through it. ``None`` for inputs that need no gradient,
    zeros for one the plain version does not read (the standard GRU's
    ``time_scale``), as ``jax.vjp`` gives.
    """
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(bool(n)) for x, n in zip(inputs, needs_grad)]
        wrt = [x for x, n in zip(leaves, needs_grad) if n]
        if not wrt:
            return (None,) * len(inputs)
        grads = iter(
            torch.autograd.grad(
                fn(*leaves), wrt, grad_out, allow_unused=True, materialize_grads=True
            )
        )
    return tuple(next(grads) if n else None for n in needs_grad)
