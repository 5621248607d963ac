"""Batched LM serving: a continuous-batching decode loop (``repro/launch/serve.py``).

A fixed decode batch of ``--slots`` sequences shares one cache tree. The
first ``--slots`` prompts are prefilled as one batch; then a greedy decode
loop runs over the slots, and when a slot finishes (``--eos`` or
``--max-new`` tokens) the next queued prompt is prefilled alone and written
into that slot's rows of every cache group (in place: the port updates the
cache tensors where the JAX package rebuilds them). Every slot decodes at
the JAX launcher's common position, the largest of the slots' positions.

Prompts are drawn with numpy from ``--seed``, exactly as the JAX launcher
draws them; initial weights come from a ``torch.Generator`` seeded with it
(random weights at the published widths with ``--full``). On the card (the
default ``--device cuda``) every Mamba2 prefill runs the SSD scan through the
``ssd_scan`` CUDA kernel, one launch a layer; every prefill attention (a
dense or MoE layer, zamba2's shared block) runs ``flash_attention``, one
launch an application; the MoE layers (moonshot-v1-16b-a3b, mixtral-8x22b)
run every expert on every token (the dropless form) as plain products;
every merinda-gru prefill and decode step runs its GRU-flow scan through
``gru_scan``, one call a layer (at the published H = 512 the wide form,
``csrc/gru_scan_wide.cu``; at SMOKE's H = 64 the warp cell,
``csrc/gru_scan.cu``). A prompt longer than
``--cache-len`` raises (the KV cache holds ``--cache-len`` positions; under
mixtral's sliding window it holds the last ``min(cache_len, window)``), so a
1,024-token prompt needs more than the default:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --full \\
        --requests 8 --slots 4 --prompt-len 1024 --max-new 32 --cache-len 1088
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --full \\
        --requests 8 --slots 4 --prompt-len 1024 --max-new 32 --cache-len 1088
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --full \\
        --requests 8 --slots 4 --prompt-len 1024 --max-new 32 --cache-len 1088
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --full \\
        --requests 8 --slots 4 --prompt-len 1024 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch merinda-gru --full \\
        --requests 8 --slots 4 --prompt-len 1024 --max-new 32

and the smoke configurations with the plain versions on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 8 --slots 4 --prompt-len 64 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --device cpu \\
        --requests 8 --slots 4 --prompt-len 64 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch merinda-gru --device cpu \\
        --requests 8 --slots 4 --prompt-len 64 --max-new 16

The architectures are ``configs/base.py`` ``PORTED``; the default ``--arch``
is ``qwen2.5-3b``, as the JAX launcher's; an unknown architecture raises and
names the ported ones. The ``vlm`` and ``audio`` families (phi-3-vision-4.2b,
seamless-m4t-medium) raise too: the loop feeds a prefill only
``{"tokens"}``, as the JAX launcher does, and their prefill reads
``batch["patches"]`` or ``batch["frames"]`` as well (``models/model.py``
``prefill`` serves them to a caller that passes them).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.kernels import runtime as rt
from repro_torch.models import model as M


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true", help="the published widths (else SMOKE)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4, help="decode batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--eos", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def check_servable(cfg: ModelConfig) -> None:
    """Raise for a family whose prefill needs more than the prompt's tokens."""
    if cfg.family in ("vlm", "audio"):
        extra = "patches" if cfg.family == "vlm" else "frames"
        raise ValueError(
            f"serve: {cfg.name} ({cfg.family}) needs batch[{extra!r}] beside the tokens, and the "
            f"serve loop passes only the tokens, as the JAX launcher does"
        )


def make_prompts(cfg: ModelConfig, requests: int, prompt_len: int, seed: int) -> np.ndarray:
    """The synthetic request queue [requests, prompt_len] int32, as the JAX launcher draws it."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, min(cfg.vocab_size, 1000), size=(requests, prompt_len)).astype(np.int32)


def _slot_update(cache: dict, slot_cache: dict, slot: int) -> None:
    """Write one request's prefilled cache rows into batch slot ``slot`` of
    every cache group (batch is axis 1, under the layer-stack axis, in
    ``layers`` and in the hybrid's ``shared_attn``)."""
    for group, leaves in cache.items():
        for name, full in leaves.items():
            full[:, slot : slot + 1] = slot_cache[group][name]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(torch.int32)


@torch.no_grad()
def serve_lm(cfg: ModelConfig, params, prompts: np.ndarray, *, slots: int, max_new: int,
             cache_len: int, eos: int, force_reference: bool = False) -> dict:  # fmt: skip
    """Serve every prompt through ``slots`` decode slots.

    Returns ``outputs`` (request -> its generated tokens), ``steps`` (decode
    steps), and host-clock timings, each ending in a device synchronize:
    ``prefill_ms`` (the bootstrap prefill of ``slots`` prompts), ``admit_ms``
    (each single-prompt admission prefill), ``decode_ms`` (each decode step,
    the next tokens' readback included) and ``wall_s`` (everything after the
    bootstrap, as the JAX launcher times it).
    """
    check_servable(cfg)
    requests, prompt_len = prompts.shape
    if requests < slots:
        raise ValueError(f"serve: {requests} requests cannot fill {slots} slots")
    device = params["embed"]["tokens"].device
    B = slots
    to_dev = lambda a: torch.as_tensor(a, device=device).to(torch.long)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, {"tokens": to_dev(prompts[:B])}, cfg, cache_len,
                              force_reference)  # fmt: skip
    next_tok = _greedy(logits, cfg)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3

    slot_req = list(range(B))  # which request occupies each slot
    slot_pos = np.full(B, prompt_len, dtype=np.int64)
    slot_new = np.zeros(B, dtype=np.int64)
    outputs: dict[int, list[int]] = {i: [] for i in range(requests)}
    next_req, done, steps = B, 0, 0
    active = np.ones(B, dtype=bool)
    admit_ms, decode_ms = [], []
    t_start = time.perf_counter()
    while done < requests:
        t1 = time.perf_counter()
        pos = int(slot_pos.max())  # the JAX launcher's common position (read by the attention)
        logits, cache = M.decode_step(params, cache, next_tok[:, None].to(torch.long), pos, cfg,
                                      force_reference)  # fmt: skip
        steps += 1
        next_tok = _greedy(logits, cfg)
        toks = next_tok.cpu().numpy()
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        slot_pos += 1
        slot_new += 1
        for s in range(B):
            if not active[s]:
                continue
            r = slot_req[s]
            outputs[r].append(int(toks[s]))
            if int(toks[s]) == eos or slot_new[s] >= max_new:
                done += 1
                if next_req < requests:  # admit the next request into this slot
                    t2 = time.perf_counter()
                    lg1, c1 = M.prefill(params, {"tokens": to_dev(prompts[next_req : next_req + 1])},
                                        cfg, cache_len, force_reference)  # fmt: skip
                    _slot_update(cache, c1, s)
                    next_tok[s] = _greedy(lg1, cfg)[0]
                    _sync(device)
                    admit_ms.append((time.perf_counter() - t2) * 1e3)
                    slot_req[s] = next_req
                    slot_pos[s] = prompt_len
                    slot_new[s] = 0
                    next_req += 1
                else:
                    active[s] = False
    wall_s = time.perf_counter() - t_start
    return dict(outputs=outputs, steps=steps, prefill_ms=prefill_ms, admit_ms=admit_ms,
                decode_ms=decode_ms, wall_s=wall_s)  # fmt: skip


def run(args: argparse.Namespace) -> dict:
    """Build the model and the queue of ``args`` and serve it: ``serve_lm``'s
    result with the config, the parameters and the prompts beside it."""
    device = rt.resolve_device(args.device, "serve")
    cfg = get_config(args.arch, smoke=not args.full)
    check_servable(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(gen, cfg, device)
    prompts = make_prompts(cfg, args.requests, args.prompt_len, args.seed)
    out = serve_lm(cfg, params, prompts, slots=args.slots, max_new=args.max_new,
                   cache_len=args.cache_len, eos=args.eos)  # fmt: skip
    return dict(out, cfg=cfg, params=params, prompts=prompts)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args)
    outputs, dt = out["outputs"], out["wall_s"]
    total_new = sum(len(v) for v in outputs.values())
    print(
        f"[serve] arch={args.arch} requests={args.requests} slots={args.slots} "
        f"decode_steps={out['steps']} new_tokens={total_new} "
        f"throughput={total_new / dt:.1f} tok/s wall={dt:.1f}s"
    )
    for r in list(outputs)[:3]:
        print(f"  req{r}: {outputs[r][:12]}{'...' if len(outputs[r]) > 12 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
