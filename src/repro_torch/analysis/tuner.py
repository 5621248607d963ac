"""Measured-cost tuner: the lowering a plan runs, chosen by timing it on the card.

Counterpart of ``repro/analysis/tuner.py``. The static lowering policy
(``tiling.auto_block_b`` / ``auto_slots_per_bank``) trusts the shared-memory
model and the rule that the grid should reach every SM. Given a
:class:`~repro_torch.api.spec.RecoverySpec` this module

1. enumerates candidate lowerings from the same generators the static path
   walks (``tiling.block_b_candidates`` batch tiles, fused against unfused
   where the encoder family has both, the substep unroll of the LTC and NODE
   kernels, ``tiling.slots_per_bank_candidates`` bank sizes for a banked
   stream tick), the static choice first;
2. scores each: the shared-memory model's bytes (``predicted_bytes``) against
   the budget, the bytes the launcher really requests (``parsed_bytes``: the
   kernel's exported carve, ``runtime.kernel_smem_bytes``; the JAX tuner parses
   them from the HLO), and the roofline time of one input step
   (``t_step_us``: ``analysis/roofline.py``'s operations and bytes, the
   operations at the float32 peak times the share of the SMs the candidate's
   grid reaches);
3. under ``"measured"`` on the card, times every candidate's stage with CUDA
   events (a warm-up, then runs of back-to-back calls queued behind a spin
   kernel, so the events see device time, not the host's enqueue rate:
   ``measured_us``, ``time_stage``) and ranks by that time; on the CPU it
   ranks by the model and the roofline and leaves ``measured_us`` as None;
4. persists the decision in an on-disk cache keyed by (spec fingerprint,
   device kind, mesh shape, the kernel sources' hash), so a warm
   ``compile_plan(spec, tune="measured")`` times nothing (``n_lowered == 0``).

The stages timed: a step candidate's ``mr_forward`` at the plan's fused-stage
batch (the fused kernel, or the unfused encoder and head), a tick candidate's
serving segment (``kernels/mr_step/tick.mr_tick``, the launch the bank size
changes). A substep unroll with no instantiation in the kernel
(``tiling.SUBSTEP_UNROLLS``) stays in the table, scored but neither timed nor
chosen.

``compile_plan(spec, tune="off"|"static"|"measured")`` is the integration point
(``api/plan.py``). CLI::

    python -m repro_torch.analysis.tuner --what-if --encoder ltc --fused \\
        --batch 48 --device cpu            # replay the candidate table
    python -m repro_torch.analysis.tuner --smoke --json TUNE_report.json

The cache lives under ``$REPRO_TORCH_TUNE_CACHE``, else ``build/repro_torch/tune``
in the checkout (git-ignored, beside the kernel library).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

import torch

from repro_torch.analysis import roofline
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.mr_step import tiling

TUNER_VERSION = 1  # bump to invalidate every cached decision

TUNE_MODES = ("off", "static", "measured")

#: cap on the candidates one tune() call scores in full (timed on the card);
#: the rest keep their static scores, counted in TuneReport.n_dropped. A
#: candidate costs a few launches of its stage here, not a compile as in the
#: JAX tuner (12 there), so the cap holds a whole LTC table (7 tiles x 3
#: unrolls and the unfused rows at the quickstart)
MAX_LOWERED = 32
WARMUP, TIMED, RUNS = 2, 5, 3  # calls of a candidate's stage: warm-up; TIMED a run, RUNS runs
SPIN_CYCLES_PER_S = 2e9  # above an H100's SM clock: a spin of host_s * this outlasts host_s
T_OFFLINE = 32  # the window of an offline or batch fused stage (JAX's _step_window)
FUSED_KERNEL = {"gru": "mr_step", "ltc": "mr_step_ltc", "node": "mr_step_node"}


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in the lowering design space.

    ``stage="step"`` tunes the fused per-window stage (block_b x fused x
    substep_unroll); ``stage="tick"`` tunes the banked service tick's bank
    size (``slots_per_bank``).
    """

    block_b: int | None = None
    fused: bool = False
    substep_unroll: int = 1
    stage: str = "step"  # "step" | "tick"
    slots_per_bank: int | None = None

    def label(self) -> str:
        if self.stage == "tick":
            return f"tick:spb={self.slots_per_bank}"
        bits = [f"block_b={self.block_b}", "fused" if self.fused else "unfused"]
        if self.substep_unroll != 1:
            bits.append(f"unroll={self.substep_unroll}")
        return ":".join(bits)


@dataclasses.dataclass
class ScoredCandidate:
    """One candidate with its cost evidence (predicted against measured)."""

    candidate: Candidate
    predicted_bytes: int  # the tiling.py shared-memory model
    fits_budget: bool
    parsed_bytes: float | None = None  # the launcher's exported carve (on the card)
    roofline_flops: float | None = None  # operations an input step (analysis/roofline.py)
    roofline_bytes: float | None = None  # device-memory bytes an input step
    t_step_us: float | None = None  # roofline time an input step
    in_band: bool = True  # the carve equals the model (R2's band)
    measured_us: float | None = None  # CUDA-event median of the stage, a call

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["candidate"] = dataclasses.asdict(self.candidate)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ScoredCandidate":
        d = dict(d)
        d["candidate"] = Candidate(**d["candidate"])
        return cls(**d)


@dataclasses.dataclass
class TuneReport:
    """Outcome of one tune() call: the ranked table and the decision."""

    cache_key: str
    spec_fingerprint: str
    device_kind: str
    mesh_shape: tuple[int, ...]
    mode: str  # "static" | "measured"
    candidates: list[ScoredCandidate]  # ranked, best first (step stage)
    chosen: ScoredCandidate
    tick_candidates: list[ScoredCandidate] = dataclasses.field(default_factory=list)
    chosen_tick: ScoredCandidate | None = None
    cache_hit: bool = False
    n_lowered: int = 0  # candidates scored in full THIS call (0 on a warm call)
    n_dropped: int = 0  # candidates past MAX_LOWERED, or with no instantiation
    budget_bytes: int | None = None
    budget_source: str | None = None

    def to_json(self) -> dict:
        return {
            "version": TUNER_VERSION,
            "cache_key": self.cache_key,
            "spec_fingerprint": self.spec_fingerprint,
            "device_kind": self.device_kind,
            "mesh_shape": list(self.mesh_shape),
            "mode": self.mode,
            "candidates": [s.to_json() for s in self.candidates],
            "chosen": self.chosen.to_json(),
            "tick_candidates": [s.to_json() for s in self.tick_candidates],
            "chosen_tick": self.chosen_tick.to_json() if self.chosen_tick else None,
            "cache_hit": self.cache_hit,
            "n_lowered": self.n_lowered,
            "n_dropped": self.n_dropped,
            "budget_bytes": self.budget_bytes,
            "budget_source": self.budget_source,
        }


# ---------------------------------------------------------------------------
# fingerprint + cache
# ---------------------------------------------------------------------------
def spec_fingerprint(spec) -> str:
    """Deterministic digest of every spec field (nested configs included)."""
    blob = json.dumps(dataclasses.asdict(spec), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    device = torch.device("cpu" if device is None else device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def tune_cache_key(spec, kind: str | None = None, mesh_shape: tuple[int, ...] | None = None) -> str:
    """Cache key = (spec fingerprint, device kind, mesh shape, kernel build,
    tuner version): any spec field, another kind of card, another mesh or a
    change to a kernel source or its flags (``runtime.source_hash``) misses
    the cache."""
    kind = device_kind() if kind is None else kind
    if mesh_shape is None:
        mesh_shape = (spec.mesh_slots,) if spec.mode == "stream" else ()
    blob = (f"{spec_fingerprint(spec)}|{kind}|{','.join(map(str, mesh_shape))}|"
            f"{rt.source_hash()}|v{TUNER_VERSION}")  # fmt: skip
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def cache_dir() -> Path:
    """The tuning cache's root: $REPRO_TORCH_TUNE_CACHE, else
    ``build/repro_torch/tune`` in the checkout."""
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    return Path(env) if env else rt.BUILD_DIR / "tune"


def _cache_load(path: Path, key: str) -> dict | None:
    """A cached decision, or None (missing, corrupted or of another version)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        warnings.warn(
            f"tuning cache {path} is corrupted ({e}); falling back to a fresh search",
            stacklevel=3,
        )
        return None
    if (
        not isinstance(doc, dict)
        or doc.get("version") != TUNER_VERSION
        or doc.get("cache_key") != key
    ):
        return None
    try:
        # validate the payload eagerly: a truncated but valid JSON file
        # degrades to a fresh search, not a crash downstream
        ScoredCandidate.from_json(doc["chosen"])
        [ScoredCandidate.from_json(d) for d in doc["candidates"]]
    except (KeyError, TypeError) as e:
        warnings.warn(
            f"tuning cache {path} has an unreadable payload ({e}); "
            f"falling back to a fresh search",
            stacklevel=3,
        )
        return None
    return doc


def _cache_store(path: Path, doc: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)  # atomic on POSIX: a reader never sees a torn file


# ---------------------------------------------------------------------------
# enumeration
# ---------------------------------------------------------------------------
def _family(spec) -> str:
    from repro_torch.core import encoders

    return encoders.get_encoder(spec.encoder).family


def step_batch(spec) -> int | None:
    """The fused-stage batch knowable at compile time (``api/plan.py``)."""
    if spec.mode == "stream":
        return spec.stream_config().n_windows
    return spec.batch_size


def step_window(spec) -> int:
    """The window of the fused stage a tuner or an audit runs."""
    return spec.stream_config().window if spec.mode == "stream" else T_OFFLINE


def _step_slots(spec) -> int:
    """Slots a fused launch spans: a stream shard's (the slot-axis form), else 1."""
    return spec.n_slots // spec.mesh_slots if spec.mode == "stream" else 1


def _quant_tick(spec) -> bool:
    return spec.precision == "int8_pwl" and spec.stream_config().steps_per_tick == 0


def enumerate_candidates(spec) -> list[Candidate]:
    """The step-stage design space of one spec, the static-policy point first.

    Axes: the batch tile (``tiling.block_b_candidates``; pinned when the spec
    gives an int), fused against unfused (both only when the family is
    fusable and the spec float: int8 serving and QAT pin the kernel path),
    and the substep unroll (the LTC and NODE families only). Deterministic
    and without duplicates; the spec's own static lowering leads, so the
    scored set (capped at MAX_LOWERED) never loses the baseline it must beat.
    """
    from repro_torch.core import encoders

    row = encoders.get_encoder(spec.encoder)
    batch = step_batch(spec)

    if isinstance(spec.block_b, int):
        tiles: list[int | None] = [spec.block_b]
    elif spec.block_b == "auto" and batch is not None:
        tiles = tiling.block_b_candidates(batch)
    else:
        tiles = [None]  # batch unknown at compile time: the launch fits its own

    if row.fusable and spec.precision == "fp32" and spec.qat is None:
        fused_opts = [spec.fused, not spec.fused]
    else:
        fused_opts = [spec.fused]

    if row.family in tiling.UNROLLED_FAMILIES:
        unrolls = sorted({1, 2, spec.ltc_substeps})
    else:
        unrolls = [1]
    if spec.substep_unroll not in unrolls:
        unrolls = sorted({spec.substep_unroll, *unrolls})

    out: list[Candidate] = []
    for fused in fused_opts:
        for bb in tiles if fused else [None]:  # block_b tiles the FUSED stage only
            for u in unrolls:
                out.append(Candidate(block_b=bb, fused=fused, substep_unroll=u))
    static = static_candidate(spec)
    return [static] + [c for c in out if c != static]


def static_candidate(spec, budget: int | None = None) -> Candidate:
    """The candidate the static policy (``auto_block_b`` and the spec) picks."""
    bb: int | None
    if isinstance(spec.block_b, int):
        bb = spec.block_b
    elif spec.block_b == "auto" and spec.fused:
        if budget is None:
            budget, _ = tiling.resolve_smem_budget(explicit=spec.smem_budget_bytes)
        bb = tiling.auto_block_b(spec.to_mr_config(), _family(spec), step_batch(spec), budget,
                                 slots=_step_slots(spec))  # fmt: skip
    else:
        bb = None
    return Candidate(block_b=bb, fused=spec.fused, substep_unroll=spec.substep_unroll)


def enumerate_tick_candidates(spec) -> list[Candidate]:
    """Bank sizes for the banked stream tick (empty off-stream or unsupported)."""
    if spec.mode != "stream":
        return []
    if spec.tick_spec().tick_kernel not in ("banked", "auto"):
        return []
    from repro_torch.kernels.mr_step.tick import tick_supported

    if not tick_supported(spec.to_mr_config(), int8=_quant_tick(spec)):
        return []
    local_slots = spec.n_slots // spec.mesh_slots
    return [
        Candidate(stage="tick", slots_per_bank=spb)
        for spb in tiling.slots_per_bank_candidates(local_slots)
    ]


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------
def _candidate_cfg(spec, cand: Candidate):
    cfg = spec.to_mr_config(block_b=cand.block_b, substep_unroll=cand.substep_unroll)
    if cfg.fused != cand.fused:
        cfg = dataclasses.replace(cfg, fused=cand.fused)
    return cfg


def _shape(spec) -> tuple[int, int, int, int]:
    cfg = spec.to_mr_config()
    return cfg.state_dim + cfg.input_dim, cfg.hidden, cfg.dense_hidden, cfg.n_coef + cfg.n_shifts


def step_tile(spec, block_b: int | None) -> int:
    """The tile the fused stage's launch takes at the compile-time batch: the
    given one, else the one fitted to the batch, as the launch fits it (over a
    stream shard's slots). The tile both sides of R2 are read at."""
    B = step_batch(spec) or 16
    return tiling.legal_block_b(block_b, B) or tiling.fit_block_b(
        _family(spec), B, *_shape(spec), slots=_step_slots(spec))  # fmt: skip


def _tile(spec, cand: Candidate) -> int:
    return step_tile(spec, cand.block_b)


def _tick_dims(spec) -> tuple:
    cfg, scfg = spec.to_mr_config(), spec.stream_config()
    return (cfg.state_dim + cfg.input_dim, cfg.hidden, cfg.dense_hidden,
            cfg.n_coef + cfg.n_shifts, scfg.window, scfg.n_windows)  # fmt: skip


def _predicted_bytes(spec, cand: Candidate) -> int:
    if cand.stage == "tick":
        D, H, Dh, Ko, T, N = _tick_dims(spec)
        return tiling.tick_smem_bytes(D, H, Dh, Ko, N, T, int8=_quant_tick(spec))
    return tiling.config_smem_bytes(_candidate_cfg(spec, cand), _family(spec), _tile(spec, cand))


def carved_bytes(spec, cand: Candidate) -> int:
    """The bytes the candidate's launch requests: its kernel's exported carve
    (``runtime.kernel_smem_bytes``; builds the library)."""
    from repro_torch.core.quant import N_SEG

    if cand.stage == "tick":
        D, H, Dh, Ko, T, N = _tick_dims(spec)
        if _quant_tick(spec):
            return rt.kernel_smem_bytes("mr_tick_int8", D, H, Dh, Ko, T, N, N_SEG)
        return rt.kernel_smem_bytes("mr_tick", D, H, Dh, Ko, T, N)
    D, H, Dh, K = _shape(spec)
    return rt.kernel_smem_bytes(FUSED_KERNEL[_family(spec)], D, H, Dh, K, _tile(spec, cand))


def _roofline(spec, cand: Candidate) -> tuple[float, float, float]:
    """(operations, bytes, microseconds) of one input step of the candidate's
    stage: ``roofline.work`` / ``tick_work`` of a call over its input steps,
    the operations at the float32 peak times the share of the SMs its grid
    reaches (the tile sets how many blocks share the windows)."""
    cfg = spec.to_mr_config()
    if cand.stage == "tick":
        D, H, Dh, Ko, T, N = _tick_dims(spec)
        scfg, S = spec.stream_config(), spec.n_slots // spec.mesh_slots
        work = roofline.tick_work_int8 if _quant_tick(spec) else roofline.tick_work
        flops, nbytes = work(S, scfg.buf_len, scfg.chunk, cfg.state_dim, cfg.input_dim, N, T, H,
                             Dh, Ko, cfg.n_coef)  # fmt: skip
        blocks = S // cand.slots_per_bank * tiling.tick_cluster(N)
    else:
        B, T, S = step_batch(spec) or 16, step_window(spec), _step_slots(spec)
        family = _family(spec)
        flops, nbytes = roofline.work(family, S * B, T, *_shape(spec), n_sub=cfg.ltc_substeps)
        blocks = S * B // _tile(spec, cand)
    share = min(blocks, tiling.N_SMS) / tiling.N_SMS
    t_us = max(flops / (roofline.PEAK_FP32_FLOPS * share), nbytes / roofline.PEAK_BYTES_PER_S)
    return flops / T, nbytes / T, t_us * 1e6 / T


def _lowerable(cand: Candidate, family: str) -> bool:
    """False for a substep unroll the kernel has no instantiation of."""
    return cand.substep_unroll in tiling.SUBSTEP_UNROLLS or family not in tiling.UNROLLED_FAMILIES


def score_candidate(
    spec, cand: Candidate, budget: int | None, *, lower: bool = True, device=None
) -> ScoredCandidate:
    """The model's bytes always; with ``lower``, the roofline, and on the card
    the exported carve and the stage's CUDA-event time."""
    predicted = _predicted_bytes(spec, cand)
    fits = budget is None or predicted <= budget
    sc = ScoredCandidate(candidate=cand, predicted_bytes=predicted, fits_budget=fits)
    if not lower:
        return sc
    device = torch.device("cpu" if device is None else device)
    # an unfused step runs no one kernel: no carve, and no roofline of a grid
    kernel = cand.stage == "tick" or cand.fused
    if kernel:
        sc.roofline_flops, sc.roofline_bytes, sc.t_step_us = _roofline(spec, cand)
    if device.type == "cuda":
        if kernel:
            sc.parsed_bytes = carved_bytes(spec, cand)
            sc.in_band = sc.parsed_bytes == predicted
        sc.measured_us = time_stage(spec, cand, device)
    return sc


def _rank_key(sc: ScoredCandidate):
    """Deterministic ranking: budget-fitting candidates whose carve matches the
    model first, then the measured time (the roofline where none was
    measured), with a fixed structural tie-break."""
    c = sc.candidate
    t = sc.measured_us if sc.measured_us is not None else sc.t_step_us
    return (
        not sc.fits_budget,
        not sc.in_band,
        round(t, 4) if t is not None else float("inf"),
        -(c.block_b or 1 << 30),  # larger tile preferred at equal cost
        c.substep_unroll,  # least unrolling at equal cost
        not c.fused,
        -(c.slots_per_bank or 0),
    )


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------
def _stage(spec, cand: Candidate, device):
    """A closure running the candidate's stage once on ``device``, on inputs
    made from a seed (the stage's values are not read). A stream's step stage
    is the slot-axis form over a shard's slots (``engine.stacked_theta``), as
    the service's ticks run it."""
    from repro_torch.core.engine import stacked_theta
    from repro_torch.core.merinda import init_mr, mr_forward
    from repro_torch.tree import tree_stack

    gen = torch.Generator(device=device).manual_seed(0)
    cfg = _candidate_cfg(spec, cand)
    params = init_mr(gen, cfg, device)
    S = spec.n_slots // spec.mesh_slots if spec.mode == "stream" else 1
    stacked = tree_stack([params] * S)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    if cand.stage == "tick":
        from repro_torch.core import stream as stream_mod
        from repro_torch.kernels.mr_step.tick import mr_tick

        scfg = spec.stream_config()
        state = stream_mod.init_slots(spec.seed, cfg, scfg, S, device)
        new_y, new_u = randn(S, scfg.chunk, cfg.state_dim), randn(S, scfg.chunk, cfg.input_dim)
        on = torch.ones(S, dtype=torch.bool, device=device)  # every slot active and seeding
        return lambda: mr_tick(stacked, cfg, scfg, state.buf_y, state.buf_u, new_y, new_u,
                               state.mean, state.scale, state.theta, on, on,
                               quant=_quant_tick(spec), slots_per_bank=cand.slots_per_bank)  # fmt: skip
    B, T = step_batch(spec) or 16, step_window(spec)
    ys = randn(S, B, T, cfg.state_dim)
    us = randn(S, B, T, cfg.input_dim) if cfg.input_dim else None
    if spec.mode == "stream":
        return lambda: stacked_theta(stacked, cfg, ys, us)
    return torch.no_grad()(lambda: mr_forward(params, cfg, ys[0], None if us is None else us[0]))


def time_stage(spec, cand: Candidate, device) -> float:
    """Microseconds of one call of the candidate's stage on the card: WARMUP
    calls, then the median over RUNS of the mean of TIMED back-to-back calls
    between two CUDA events.

    A fused stage is a few tens of microseconds of device work, less than the
    host takes to enqueue it, so events around calls as the host issues them
    would time the host's enqueue rate and rank the candidates by noise. Each
    run is queued behind a spin kernel (``torch.cuda._sleep``) that holds the
    stream for twice the host's enqueue time of the run, so the calls wait on
    the card and the events bracket their device time. A stage of more
    launches than the card's queue holds (an unfused encoder) still waits on
    the host part of the way.
    """
    run = _stage(spec, cand, device)
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run()  # the host's enqueue time of one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * TIMED * host_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(TIMED):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / TIMED)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------
def tune(
    spec,
    mode: str = "measured",
    *,
    device=None,
    cache: bool = True,
    cache_root: Path | str | None = None,
) -> TuneReport:
    """Pick the lowering for ``spec`` on ``device`` (default: the CPU); see the
    module docstring.

    ``mode="static"`` scores the candidate table with the model only (no
    timing, no cache) and chooses exactly what the static policy chooses
    (``auto_block_b``, ``auto_slots_per_bank``): the table is the what-if
    evidence. ``mode="measured"`` scores every candidate in full (up to
    MAX_LOWERED), times it on the card, and caches the decision; a warm call
    returns the cached report with ``cache_hit=True`` and ``n_lowered=0``.
    """
    if mode not in ("static", "measured"):
        raise ValueError(f"tune mode must be 'static' or 'measured', got {mode!r}")
    device = torch.device("cpu" if device is None else device)
    kind = device_kind(device)
    mesh_shape = (spec.mesh_slots,) if spec.mode == "stream" else ()
    fingerprint = spec_fingerprint(spec)
    key = tune_cache_key(spec, kind, mesh_shape)
    budget, budget_src = tiling.resolve_smem_budget(device, spec.smem_budget_bytes)
    family = _family(spec)
    common = dict(
        cache_key=key, spec_fingerprint=fingerprint, device_kind=kind, mesh_shape=mesh_shape,
        budget_bytes=budget, budget_source=budget_src,
    )  # fmt: skip

    cands = enumerate_candidates(spec)
    tick_cands = enumerate_tick_candidates(spec)

    if mode == "static":
        scored = [score_candidate(spec, c, budget, lower=False) for c in cands]
        tick_scored = [score_candidate(spec, c, budget, lower=False) for c in tick_cands]
        chosen_c = static_candidate(spec, budget)
        chosen = next((s for s in scored if s.candidate == chosen_c), None)
        if chosen is None:  # a device budget that moves the static tile off the table's lead
            chosen = score_candidate(spec, chosen_c, budget, lower=False)
            scored.insert(0, chosen)
        chosen_tick = None
        if tick_cands:
            spb = tiling.auto_slots_per_bank(
                spec.to_mr_config(), spec.stream_config(), spec.n_slots // spec.mesh_slots,
                budget, int8=_quant_tick(spec),
            )  # fmt: skip
            chosen_tick = next((s for s in tick_scored if s.candidate.slots_per_bank == spb), None)
        return TuneReport(mode=mode, candidates=scored, chosen=chosen, tick_candidates=tick_scored,
                          chosen_tick=chosen_tick, **common)  # fmt: skip

    cpath = (Path(cache_root) if cache_root is not None else cache_dir()) / f"{key}.json"
    if cache:
        doc = _cache_load(cpath, key)
        if doc is not None:
            return TuneReport(
                mode="measured",
                candidates=[ScoredCandidate.from_json(d) for d in doc["candidates"]],
                chosen=ScoredCandidate.from_json(doc["chosen"]),
                tick_candidates=[ScoredCandidate.from_json(d) for d in doc["tick_candidates"]],
                chosen_tick=ScoredCandidate.from_json(doc["chosen_tick"])
                if doc.get("chosen_tick")
                else None,
                cache_hit=True,
                n_lowered=0,
                n_dropped=doc.get("n_dropped", 0),
                **common,
            )

    lowerable = [c for c in cands if _lowerable(c, family)]
    lowered_set = lowerable[:MAX_LOWERED]
    dropped = [c for c in cands if c not in lowered_set]
    scored = [score_candidate(spec, c, budget, device=device) for c in lowered_set]
    scored += [score_candidate(spec, c, budget, lower=False) for c in dropped]
    scored.sort(key=_rank_key)
    tick_scored = [score_candidate(spec, c, budget, device=device) for c in tick_cands]
    tick_scored.sort(key=_rank_key)
    out = TuneReport(
        mode="measured",
        candidates=scored,
        chosen=scored[0],
        tick_candidates=tick_scored,
        chosen_tick=tick_scored[0] if tick_scored else None,
        n_lowered=len(lowered_set) + len(tick_cands),
        n_dropped=len(dropped),
        **common,
    )
    if cache:
        _cache_store(cpath, out.to_json())
    return out


# ---------------------------------------------------------------------------
# what-if / smoke CLI
# ---------------------------------------------------------------------------
def _fmt_bytes(x: float | None) -> str:
    if x is None:
        return "-"
    return f"{x / 1024:.1f}K" if x >= 1024 else f"{x:.0f}"


def _fmt_us(x: float | None) -> str:
    return "-" if x is None else f"{x:.2f}"


def explain(report: TuneReport) -> str:
    """Human-readable replay of the decision (the --what-if body)."""
    lines = [
        f"tune[{report.mode}] key={report.cache_key} device={report.device_kind} "
        f"mesh={report.mesh_shape or '()'} budget={_fmt_bytes(report.budget_bytes)} "
        f"({report.budget_source}) cache_hit={report.cache_hit} "
        f"lowered={report.n_lowered} dropped={report.n_dropped}",
        f"{'rank':<4} {'candidate':<32} {'pred_B':>8} {'carve_B':>8} "
        f"{'flops/step':>10} {'B/step':>8} {'t_us':>8} {'meas_us':>9} fit band",
    ]
    winners = {report.chosen.candidate}
    if report.chosen_tick is not None:
        winners.add(report.chosen_tick.candidate)
    for i, sc in enumerate(report.candidates + report.tick_candidates):
        mark = "*" if sc.candidate in winners else " "
        lines.append(
            f"{mark}{i:<3} {sc.candidate.label():<32} {_fmt_bytes(sc.predicted_bytes):>8} "
            f"{_fmt_bytes(sc.parsed_bytes):>8} {_fmt_bytes(sc.roofline_flops):>10} "
            f"{_fmt_bytes(sc.roofline_bytes):>8} {_fmt_us(sc.t_step_us):>8} "
            f"{_fmt_us(sc.measured_us):>9} "
            f"{'y' if sc.fits_budget else 'N'}   {'y' if sc.in_band else 'N'}"
        )
    ch = report.chosen
    runners = [s for s in report.candidates if s is not ch]
    t = lambda s: s.measured_us if s.measured_us is not None else s.t_step_us  # noqa: E731
    if runners and t(ch) is not None and t(runners[0]) is not None:
        ru = runners[0]
        why = []
        if ch.fits_budget and not ru.fits_budget:
            why.append(f"it fits the budget ({_fmt_bytes(ch.predicted_bytes)} resident)")
        if ch.in_band and not ru.in_band:
            why.append("its carve matches the shared-memory model")
        what = "measured" if ch.measured_us is not None else "roofline"
        if t(ru) > t(ch):
            why.append(f"its {what} time is {t(ru) / max(t(ch), 1e-9):.2f}x lower "
                       f"({t(ch):.2f}us vs {t(ru):.2f}us)")  # fmt: skip
        if why:
            lines.append(
                f"chose {ch.candidate.label()} over {ru.candidate.label()}: " + "; ".join(why)
            )
    return "\n".join(lines)


def _spec_from_args(args):
    from repro_torch.api.spec import RecoverySpec

    kw = dict(
        state_dim=args.state_dim,
        hidden=args.hidden,
        encoder=args.encoder,
        fused=args.fused,
        block_b="auto",
        mode=args.mode,
    )
    if args.smem_budget:
        kw["smem_budget_bytes"] = args.smem_budget
    if args.mode in ("offline", "batch"):
        kw["batch_size"] = args.batch
    return RecoverySpec(**kw)


def _smoke_specs():
    from repro_torch.api.spec import RecoverySpec

    return [
        (
            "gru_flow:fused:b16",
            RecoverySpec(
                state_dim=2, hidden=8, dense_hidden=16, encoder="gru_flow",
                fused=True, block_b="auto", mode="batch", batch_size=16, steps=4,
            ),
        ),
        (
            "ltc:fused:b12",
            RecoverySpec(
                state_dim=2, hidden=8, dense_hidden=16, encoder="ltc", ltc_substeps=4,
                fused=True, block_b="auto", mode="batch", batch_size=12, steps=4,
            ),
        ),
    ]  # fmt: skip


def _run_smoke(args) -> int:
    """Tune two specs cold, then check that the warm path times nothing."""
    from repro_torch.api import plan as plan_mod

    reports = {}
    for label, spec in _smoke_specs():
        cold = plan_mod.compile_plan(spec, device=args.device, tune="measured")
        if cold.lowering.tuned not in ("measured", "measured:cached"):
            print(f"FAIL {label}: cold compile not tuned ({cold.lowering.tuned})")
            return 1
        warm = plan_mod.compile_plan(spec, device=args.device, tune="measured")
        if warm.lowering.tuned != "measured:cached":
            print(f"FAIL {label}: warm compile missed the cache ({warm.lowering.tuned})")
            return 1
        warm_report = tune(spec, mode="measured", device=warm.device)
        if not warm_report.cache_hit or warm_report.n_lowered != 0:
            print(
                f"FAIL {label}: warm tune scored {warm_report.n_lowered} candidates "
                f"(cache_hit={warm_report.cache_hit})"
            )
            return 1
        if warm.lowering.block_b != cold.lowering.block_b:
            print(f"FAIL {label}: warm choice diverged from cold")
            return 1
        reports[label] = warm_report.to_json()
        print(f"ok {label}: chosen={warm_report.chosen.candidate.label()} warm n_lowered=0")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(reports, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")
    print("tune-smoke: warm compiles hit the cache with zero scored candidates")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.tuner",
        description="Measured-cost tuner: replay and explain lowering decisions.",
    )
    ap.add_argument("--what-if", action="store_true", help="print the ranked candidate table")
    ap.add_argument("--smoke", action="store_true", help="two specs tuned cold, then warm")
    ap.add_argument("--tune", default="measured", choices=("static", "measured"))
    ap.add_argument("--encoder", default="gru_flow")
    ap.add_argument("--state-dim", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--mode", default="batch", choices=("offline", "batch", "stream"))
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--smem-budget", type=int, default=0, help="explicit shared-memory budget")
    ap.add_argument("--no-cache", action="store_true", help="ignore and do not write the cache")
    ap.add_argument("--cache-dir", default=None, help="the tuning cache's root")
    ap.add_argument("--device", default="cuda", help="cuda (timed) or cpu (the model only)")
    ap.add_argument("--json", default=None, help="write the TuneReport here")
    args = ap.parse_args(argv)
    if args.cache_dir:
        os.environ["REPRO_TORCH_TUNE_CACHE"] = args.cache_dir
    if args.smoke:
        return _run_smoke(args)
    if not args.what_if:
        ap.error("nothing to do: pass --what-if or --smoke")
    device = rt.resolve_device(args.device, "tuner")
    report = tune(_spec_from_args(args), mode=args.tune, device=device, cache=not args.no_cache)
    print(explain(report))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
