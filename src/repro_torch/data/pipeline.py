"""Deterministic, step-addressable token pipeline (``repro/data/pipeline.py``).

- step-addressable: ``batch_at(step)`` is a pure function of (seed, step), so
  a restarted job re-reads exactly the batch it failed on; no iterator state
  is checkpointed (the ``Supervisor`` resumes by step).
- host-sharded: each host draws only its rows of the global batch
  (``host_id`` of ``n_hosts``).
- reproducible across restarts and host counts: each (seed, step, host) has
  its own ``numpy.random.SeedSequence``.

The sources are numpy, the JAX package's code as it is, so the port's batches
equal the JAX package's bit for bit:

- ``SyntheticLM``: Zipf-distributed tokens with a Markov structure, so CE is
  learnable (the loss falls);
- ``DocPackLM``: documents (synthetic "sentences" ending in EOS) packed into
  fixed windows.

``to_device_batch`` takes the place of the JAX package's ``device_put_batch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: int = 1


class SyntheticLM:
    """Zipf marginals + learnable first-order structure.

    token_{t+1} ~ 0.7 * P(next | prev) + 0.3 * Zipf, where the conditional is
    a deterministic permutation chain (prev -> (a*prev + c) mod V): a model
    can reach well-below-unigram CE by learning the chain.
    """

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = 1.0 / ranks**cfg.zipf_a
        self.zipf = (p / p.sum()).astype(np.float32)
        self.a, self.c = 6364136223846793005 % V or 1, 1442695040888963407 % V

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        V = self.cfg.vocab_size
        out = np.empty(n, dtype=np.int32)
        out[0] = rng.choice(V, p=self.zipf)
        chain = rng.random(n) < 0.7
        zipf_draws = rng.choice(V, size=n, p=self.zipf)
        for i in range(1, n):
            out[i] = (self.a * out[i - 1] + self.c) % V if chain[i] else zipf_draws[i]
        return out

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        """This host's rows of the global batch of ``step`` (pure in step):
        ``tokens`` and ``labels`` (the tokens shifted by one) [rows, seq_len]
        int32."""
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over {n_hosts} hosts")
        rows_per_host = cfg.global_batch // n_hosts
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, host_id]))
        toks = np.stack([self._tokens(rng, cfg.seq_len + 1) for _ in range(rows_per_host)])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class DocPackLM(SyntheticLM):
    """Document packing: EOS-delimited variable-length docs packed greedily."""

    EOS = 0

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(0, dtype=np.int32)
        while out.size < n:
            doc_len = int(rng.integers(8, 64))
            doc = super()._tokens(rng, doc_len)
            doc[-1] = self.EOS
            out = np.concatenate([out, doc])
        return out[:n]


def to_device_batch(batch: dict, device: torch.device | str) -> dict:
    """A host numpy batch as tensors on ``device``: integer leaves (tokens,
    labels) as int64, the index type of PyTorch's gathers; the rest as they
    are. Copies from the host are non-blocking from pinned memory on the card."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        pinned = device.type == "cuda"
        out[k] = (t.pin_memory() if pinned else t).to(device, non_blocking=pinned)
    return out
