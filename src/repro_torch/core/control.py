"""Device-resident control plane: zero-readback service ticks (``repro/core/control.py``).

The host control plane (``RecoveryService`` without ``control=``) reads the
per-slot status back every tick and admits each stream with host-driven
writes. This module moves the control plane onto the card, so a steady
service tick reads nothing back:

- **admission queues**: a fixed-capacity compact queue of pending stream
  histories and cold-start parameters a shard, held in the
  :class:`ControlState` (every leaf leads with the shard axis M, one row a
  shard of the slot mesh; ``shard_control`` gives each shard its row on its
  device). ``enqueue`` writes one arrival at the queue's device-side
  length. Each entry carries a PRIORITY TIER: admission pops the highest
  tier first (FIFO within a tier), and an arrival still waiting after every
  idle slot fills may preempt a cold (``steps < min_steps``) strictly
  lower-tier slot; the victim re-enters the queue with its live buffers and
  parameters, so pressure reorders work but never drops a stream.
- **eviction on the card**: ``tick_device`` runs the composite or banked
  tick body (``mr_tick`` once a tick, ``mr_tick_int8`` for a K = 0 monitor
  with ``quant``), derives the eviction mask from the post-tick
  ``[delta, loss, steps, active]`` scalars and appends one fixed-width event
  record per evicted stream to a log on the card.
- **refill in the same launch sequence**: freed slots pop the queue in slot
  order; a cumsum prefix-rank turns the pops and pushes into one gather and
  one scatter each, with no per-slot control flow.
- **warm start on the card**: evicted parameters go to a bounded ring keyed
  by stream id; admission gathers from it and falls back to the enqueued
  cold-start tree on a miss.
- **periodic snapshot**: the host drains the packed status and the event log
  every ``snapshot_period`` ticks (``drain_events``); between arrivals and
  snapshots ``RecoveryService.sync_log`` records 0.

Everything a shard does is shard-local: the service runs ``tick_device``,
``pump`` and ``drain_events`` once a shard, on the shard's slot rows and its
control row, and no operation reads across shards.

Every step is fixed-shape: no boolean-mask indexing, ``nonzero``, ``.item()``,
slicing by a device length or data-dependent Python branch, each of which
would make PyTorch wait for the card. A write that the mask drops goes to a
dump row past the end of a padded copy (JAX's ``mode="drop"``); the argsort
keys are unique int32 composites, so the sort order is exact. The
``ControlState`` buffers are updated in place.

Parity with the host plane: the single shard queue pops as the host deque
does, admission reproduces ``stream.admit`` with a re-initialized optimizer,
and eviction uses the same converged/budget predicate. Within a tick the
device plane publishes ALL evictions before ANY admission (the host
interleaves them per slot), which differs only if a stream is both running
and queued.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import stream as stream_mod
from repro_torch.core.merinda import MRConfig, init_mr
from repro_torch.core.stream import SlotState, StreamConfig, pack_status
from repro_torch.data.windows import buffer_stats
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

#: exclusive upper bound on admission priorities (the int32 sort keys compose
#: the tier with a queue position or slot index)
PRIORITY_LIMIT = stream_mod.PRIORITY_LIMIT

_I32, _F32 = torch.int32, torch.float32


class ControlState(NamedTuple):
    """The control plane of all shards (every leaf leads with M).

    M = shards, Q = queue capacity, W = warm-ring capacity, E = event-log
    capacity (slots_per_shard * (snapshot_period + 1): at most one eviction a
    slot a tick, drained every snapshot_period ticks, so the log never
    overflows between drains).

    The queue is COMPACT: pending entries occupy ``[0, q_len)``; enqueue
    appends at ``q_len`` and the control step packs the survivors to the
    front after popping (priority pops take an arbitrary subset, which a head
    cursor cannot express).
    """

    q_ids: torch.Tensor  # [M, Q] int32 pending stream ids (-1 = empty)
    q_buf_y: torch.Tensor  # [M, Q, L, n] pending admission histories
    q_buf_u: torch.Tensor  # [M, Q, L, m]
    q_params: Any  # MRParams, leaves [M, Q, ...] (cold-start fallback)
    q_prio: torch.Tensor  # [M, Q] int32 admission tier (0 = default)
    q_len: torch.Tensor  # [M] int32 pending count
    w_ids: torch.Tensor  # [M, W] int32 warm-ring keys (-1 = empty)
    w_params: Any  # MRParams, leaves [M, W, ...] evicted params
    w_pos: torch.Tensor  # [M] int32 warm-ring cursor
    ev_log: torch.Tensor  # [M, E, R] f32 eviction events (id < 0 = empty)
    ev_len: torch.Tensor  # [M] int32 events since the last drain
    s_prio: torch.Tensor  # [M, P] int32 tier of the stream in each slot


def event_record_width(cfg: MRConfig) -> int:
    """Event record: [stream_id, steps, reason, theta.flat, mean, scale], all
    float32 (ids and step counts stay below 2^24, so they are exact): one
    [E, R] log carries every eviction's result and drains in one readback."""
    n = cfg.state_dim
    return 3 + cfg.n_terms * n + 2 * n


def init_control(
    cfg: MRConfig,
    scfg: StreamConfig,
    n_slots: int,
    *,
    shards: int,
    queue_capacity: int,
    warm_capacity: int,
    snapshot_period: int,
    device,
) -> ControlState:
    """All-empty control state on ``device`` (cursors at 0, ids at -1)."""
    if n_slots % shards:
        raise ValueError(f"n_slots ({n_slots}) must divide over {shards} shard(s)")
    M, Q, W = shards, queue_capacity, warm_capacity
    E = (n_slots // shards) * (snapshot_period + 1)
    n, m, L = cfg.state_dim, cfg.input_dim, scfg.buf_len
    template = init_mr(torch.Generator(device=device), cfg, device)
    f32 = dict(dtype=_F32, device=device)
    i32 = dict(dtype=_I32, device=device)

    def zeros_like_tree(prefix):
        return tree_map(lambda leaf: torch.zeros(prefix + tuple(leaf.shape), dtype=leaf.dtype,
                                                 device=device), template)  # fmt: skip

    return ControlState(
        q_ids=torch.full((M, Q), -1, **i32),
        q_buf_y=torch.zeros((M, Q, L, n), **f32),
        q_buf_u=torch.zeros((M, Q, L, m), **f32),
        q_params=zeros_like_tree((M, Q)),
        q_prio=torch.zeros((M, Q), **i32),
        q_len=torch.zeros((M,), **i32),
        w_ids=torch.full((M, W), -1, **i32),
        w_params=zeros_like_tree((M, W)),
        w_pos=torch.zeros((M,), **i32),
        ev_log=torch.full((M, E, event_record_width(cfg)), -1.0, **f32),
        ev_len=torch.zeros((M,), **i32),
        s_prio=torch.zeros((M, n_slots // shards), **i32),
    )


def shard_control(control: ControlState, mesh) -> list[ControlState]:
    """Split every ControlState leaf's shard axis over the ``("slots",)``
    mesh: shard ``i``'s row ([1, ...], its own copy) on ``mesh.devices[i]``,
    beside that shard's slots, so enqueue, refill and the warm lookup stay on
    the shard's device. Without a mesh the one row is ``control`` itself.

    The JAX package also re-asserts this placement on every program's output
    (``_pin``): XLA might otherwise drift a leaf toward replication. Eager
    PyTorch places every tensor explicitly, so nothing here needs it.
    """
    return stream_mod.shard_slots(control, mesh)


@torch.no_grad()
def enqueue(
    control: ControlState,
    shard: int,
    stream_id: int,
    buf_y: torch.Tensor,  # [L, n] admission history, on the control's device
    buf_u: torch.Tensor,  # [L, m]
    params: Any,  # one cold-start MRParams tree
    priority: int,
) -> ControlState:
    """Append one arrival to ``shard``'s queue, in place, at the queue's
    length as the card holds it (nothing is read back). The service passes a
    shard's own row (``control`` [1, ...], ``shard`` 0).

    The host guards the capacity (``RecoveryService`` counts each shard's
    in-flight arrivals and spills to its bounded overflow queue), so the
    write never lands past the end.
    """
    tail = control.q_len[shard : shard + 1].long()
    dev = control.q_ids.device

    def write(full, new):
        full[shard].index_copy_(0, tail, new.to(full.dtype).unsqueeze(0))

    write(control.q_ids, torch.full((), stream_id, dtype=_I32, device=dev))
    write(control.q_buf_y, buf_y)
    write(control.q_buf_u, buf_u)
    for full, leaf in zip(tree_leaves(control.q_params), tree_leaves(params)):
        write(full, leaf)
    write(control.q_prio, torch.full((), priority, dtype=_I32, device=dev))
    control.q_len[shard : shard + 1].add_(1)
    return control


def _drop_set(full: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``full.at[idx].set(rows, mode="drop")`` with ``idx == len(full)`` for a
    dropped row: the writes go to a copy with a dump row past its end."""
    out = torch.cat([full, full[:1]])
    out.index_copy_(0, idx.long(), rows.to(full.dtype))
    return out[:-1]


def _broadcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _zip_map(fn: Callable, a: Any, b: Any) -> Any:
    return tree_unflatten(a, [fn(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))])


def _shard_control_step(
    st: SlotState,  # one shard's slot slice (leaves [P, ...])
    ctl: ControlState,  # one shard's control slice (no leading M)
    evict: torch.Tensor,  # [P] bool eviction mask (from the post-tick status)
    reason: torch.Tensor,  # [P] f32 (1 = converged, 2 = budget)
    *,
    min_steps: int,  # preemption cold threshold (0 disables preemption)
) -> tuple[SlotState, ControlState]:
    """One shard's eviction, refill and warm lookup, as new tensors.

    A cumsum prefix-rank gives each evicting or idle slot its event-log or
    queue position; masked-out writes go to a dump row (``_drop_set``), and
    gathers blend leaf by leaf with ``torch.where``.

    Admission pops the compact queue in PRIORITY order (FIFO within a tier).
    Arrivals still waiting after every idle slot is filled may PREEMPT: the
    highest-tier remaining arrival displaces the lowest-tier COLD slot
    (``steps < min_steps``) whose tier is strictly lower; the victim's params
    go to the warm ring and the victim re-enters the queue's tail with its
    live buffers, so no stream is lost and the queue's length does not grow.
    """
    P = evict.shape[0]
    Q = ctl.q_ids.shape[0]
    W = ctl.w_ids.shape[0]
    E = ctl.ev_log.shape[0]
    dev = evict.device

    # -- eviction: append event records, push params into the warm ring ----
    ev_i = evict.to(_I32)
    erank = torch.cumsum(ev_i, 0, dtype=_I32) - 1
    n_evict = ev_i.sum(dtype=_I32)
    record = torch.cat(
        [
            st.stream_id.to(_F32)[:, None],
            st.steps.to(_F32)[:, None],
            reason[:, None],
            st.theta.reshape(P, -1),
            st.mean,
            st.scale,
        ],
        dim=-1,
    )
    # E is sized so the log never wraps between drains (see ControlState)
    ev_pos = torch.where(evict, ctl.ev_len + erank, E)  # E: the dump row
    ev_log = _drop_set(ctl.ev_log, ev_pos, record)
    ev_len = ctl.ev_len + n_evict
    w_write = torch.where(evict, (ctl.w_pos + erank) % W, W)
    w_ids = _drop_set(ctl.w_ids, w_write, st.stream_id)
    w_params = _zip_map(lambda full, lv: _drop_set(full, w_write, lv), ctl.w_params, st.params)
    w_pos = (ctl.w_pos + n_evict) % W
    active = st.active & ~evict
    stream_id = torch.where(evict, -1, st.stream_id)

    # -- pop order: priority-descending, FIFO within a tier ----------------
    # the int32 key composes (PRIORITY_LIMIT - 1 - prio) with the queue index,
    # so argsort gives higher tiers first and insertion order inside a tier;
    # empty entries key above every filled one
    qidx = torch.arange(Q, dtype=_I32, device=dev)
    filled = qidx < ctl.q_len
    key_q = torch.where(
        filled, (PRIORITY_LIMIT - 1 - ctl.q_prio) * Q + qidx, PRIORITY_LIMIT * Q + qidx
    )
    order = torch.argsort(key_q, stable=True)  # queue positions in pop order
    qinv = torch.argsort(order, stable=True)  # pop rank of each queue position

    # -- phase 1: pop arrivals into idle slots, in slot order --------------
    idle = ~active
    arank = torch.cumsum(idle.to(_I32), 0, dtype=_I32) - 1
    take = idle & (arank < ctl.q_len)
    n_take = take.to(_I32).sum(dtype=_I32)

    # -- phase 2: waiting arrivals preempt cold lower-tier slots -----------
    # the rank-r remaining arrival (pop rank n_take + r) pairs with the rank-r
    # eligible victim (lowest tier first, slot order within a tier); the pair
    # preempts iff the arrival's tier is strictly higher. Both sequences run
    # toward each other, so the preempted set is the first n_pre pairs.
    vict_elig = active & (st.steps < min_steps)
    n_elig = vict_elig.to(_I32).sum(dtype=_I32)
    sidx = torch.arange(P, dtype=_I32, device=dev)
    vkey = torch.where(vict_elig, ctl.s_prio * P + sidx, PRIORITY_LIMIT * P + sidx)
    vorder = torch.argsort(vkey, stable=True)  # slots, lowest-tier victims first
    vinv = torch.argsort(vorder, stable=True)  # victim rank of each slot
    pair_rank = n_take + sidx  # pop rank of the r-th pairing's arrival
    a_pos = order[torch.clamp(pair_rank, 0, Q - 1).long()]
    pair_ok = (
        (pair_rank < ctl.q_len) & (sidx < n_elig) & (ctl.q_prio[a_pos] > ctl.s_prio[vorder])
    )
    n_pre = pair_ok.to(_I32).sum(dtype=_I32)
    pre = vict_elig & (vinv < n_pre)  # [P] preempted slots

    # -- one admission gather for both phases ------------------------------
    adm = take | pre
    pop_rank = torch.where(take, arank.long(), n_take + vinv)
    q_pos = order[torch.clamp(pop_rank, 0, Q - 1)]
    pop_id = torch.where(adm, ctl.q_ids[q_pos], -1)
    pop_prio = torch.where(adm, ctl.q_prio[q_pos], 0)
    pop_by = ctl.q_buf_y[q_pos]  # [P, L, n]
    pop_bu = ctl.q_buf_u[q_pos]
    cold = tree_map(lambda leaf: leaf[q_pos], ctl.q_params)

    # preempted victims: current params into the warm ring (after the
    # eviction pushes), so a later return warm-starts where it stopped
    prank = torch.cumsum(pre.to(_I32), 0, dtype=_I32) - 1
    w_write2 = torch.where(pre, (w_pos + prank) % W, W)
    w_ids = _drop_set(w_ids, w_write2, stream_id)
    w_params = _zip_map(lambda full, lv: _drop_set(full, w_write2, lv), w_params, st.params)
    w_pos = (w_pos + n_pre) % W

    # warm-start lookup over the (post-push) ring; a miss takes the cold tree
    # that rode in on the queue
    hit_mat = (pop_id[:, None] == w_ids[None, :]) & (pop_id[:, None] >= 0)
    hit = hit_mat.any(dim=1)
    w_idx = hit_mat.to(_I32).argmax(dim=1)  # the first hit
    warm = tree_map(lambda leaf: leaf[w_idx], w_params)
    params_new = _zip_map(lambda w, c: torch.where(_broadcast(hit, w), w, c), warm, cold)

    # stream.admit's math: stats frozen from the enqueued history, theta,
    # delta and loss reset, the optimizer re-initialized (step 0, zero moments)
    mean_new, scale_new = buffer_stats(pop_by)
    mean_new, scale_new = mean_new[:, 0], scale_new[:, 0]

    def blend(new, old):
        return torch.where(_broadcast(adm, old), new.to(old.dtype), old)

    st_new = SlotState(
        params=_zip_map(blend, params_new, st.params),
        opt=tree_map(lambda old: blend(torch.zeros_like(old), old), st.opt),
        buf_y=blend(pop_by, st.buf_y),
        buf_u=blend(pop_bu, st.buf_u),
        theta=blend(torch.zeros_like(st.theta), st.theta),
        delta=torch.where(adm, float("inf"), st.delta),
        loss=torch.where(adm, float("inf"), st.loss),
        mean=blend(mean_new, st.mean),
        scale=blend(scale_new, st.scale),
        steps=torch.where(adm, 0, st.steps).to(_I32),
        active=active | adm,
        stream_id=torch.where(adm, pop_id, stream_id).to(_I32),
    )

    # -- queue compaction and victim re-enqueue ----------------------------
    # survivors (pop rank >= n_take + n_pre) pack to the front in pop-rank
    # order; preempted victims append behind them with their live buffers,
    # current params and own tier (one pop per re-enqueue)
    n_pop = n_take + n_pre
    keep = filled & (qinv >= n_pop)
    dest = torch.where(keep, qinv - n_pop, Q)  # a survivor's compacted position
    q_ids_c = _drop_set(torch.full_like(ctl.q_ids, -1), dest, ctl.q_ids)
    q_prio_c = _drop_set(torch.zeros_like(ctl.q_prio), dest, ctl.q_prio)
    q_by_c = _drop_set(torch.zeros_like(ctl.q_buf_y), dest, ctl.q_buf_y)
    q_bu_c = _drop_set(torch.zeros_like(ctl.q_buf_u), dest, ctl.q_buf_u)
    q_params_c = tree_map(lambda full: _drop_set(torch.zeros_like(full), dest, full), ctl.q_params)
    rem = ctl.q_len - n_pop
    vdest = torch.where(pre, rem + prank, Q)
    q_ids_c = _drop_set(q_ids_c, vdest, stream_id)
    q_prio_c = _drop_set(q_prio_c, vdest, ctl.s_prio)
    q_by_c = _drop_set(q_by_c, vdest, st.buf_y)
    q_bu_c = _drop_set(q_bu_c, vdest, st.buf_u)
    q_params_c = _zip_map(lambda full, lv: _drop_set(full, vdest, lv), q_params_c, st.params)

    s_prio = torch.where(evict, 0, ctl.s_prio)
    ctl_new = ControlState(
        q_ids=q_ids_c,
        q_buf_y=q_by_c,
        q_buf_u=q_bu_c,
        q_params=q_params_c,
        q_prio=q_prio_c,
        q_len=(rem + n_pre).to(_I32),
        w_ids=w_ids,
        w_params=w_params,
        w_pos=w_pos.to(_I32),
        ev_log=ev_log,
        ev_len=ev_len.to(_I32),
        s_prio=torch.where(adm, pop_prio, s_prio).to(_I32),
    )
    return st_new, ctl_new


@torch.no_grad()
def _control_apply(
    state: SlotState,
    control: ControlState,
    evict: torch.Tensor,
    reason: torch.Tensor,
    *,
    min_steps: int = 0,
) -> tuple[SlotState, ControlState]:
    """Run one shard's control step on its [P] slots and its [1, ...]
    control row. The control buffers take the result in place."""
    ctl = tree_map(lambda leaf: leaf[0], control)
    state, ctl_new = _shard_control_step(state, ctl, evict, reason, min_steps=min_steps)
    for dst, src in zip(tree_leaves(ctl), tree_leaves(ctl_new)):
        dst.copy_(src)
    return state, control


def _status5(state: SlotState) -> torch.Tensor:
    """[S, 5] post-control status: [delta, loss, steps, active, stream_id]."""
    return torch.cat([pack_status(state), state.stream_id.to(_F32)[:, None]], dim=-1)


def tick_device(
    state: SlotState,
    control: ControlState,
    new_y: torch.Tensor,  # [S, C, n]
    new_u: torch.Tensor,  # [S, C, m]
    batch_idx: torch.Tensor | None,  # [K, S, bs] minibatch windows, or None: all
    *,
    cfg: MRConfig,
    scfg: StreamConfig,
    kernel: str = "composite",
    quant: bool = False,
    slots_per_bank: int = 1,
) -> tuple[SlotState, ControlState, torch.Tensor]:
    """One zero-readback service tick: the tick body, eviction and refill.

    Runs the composite or banked tick body (``kernel``; the banked one
    launches ``mr_tick``, or ``mr_tick_int8`` with ``quant`` at K = 0),
    computes the converged/budget eviction mask from the post-tick scalars on
    the card, logs the evictions, refills freed slots from the queues with the
    warm-start gather, and returns the next (state, control) with the packed
    [S, 5] status. Nothing is read back.
    """
    if kernel == "banked":
        state, _ = stream_mod.tick_banked(state, new_y, new_u, batch_idx, cfg=cfg, scfg=scfg,
                                          quant=quant, slots_per_bank=slots_per_bank)  # fmt: skip
    else:
        state = stream_mod.tick(state, new_y, new_u, batch_idx, cfg=cfg, scfg=scfg)
    converged = (state.steps >= scfg.min_steps) & (state.delta <= scfg.delta_tol)
    budget = state.steps >= scfg.max_steps
    evict = state.active & (converged | budget)
    reason = torch.where(converged, 1.0, torch.where(budget, 2.0, 0.0))
    state, control = _control_apply(state, control, evict, reason, min_steps=scfg.min_steps)
    return state, control, _status5(state)


def pump(state: SlotState, control: ControlState) -> tuple[SlotState, ControlState, torch.Tensor]:
    """Admission-only control step (bootstrap, or a refill between ticks):
    pop the queues into every idle slot without a tick. A fresh slot never
    meets the eviction predicate (delta = inf, steps = 0), so the all-False
    mask is exact; no preemption (min_steps = 0 marks no slot cold)."""
    S = state.active.shape[0]
    evict = torch.zeros((S,), dtype=torch.bool, device=state.active.device)
    reason = torch.zeros((S,), dtype=_F32, device=state.active.device)
    state, control = _control_apply(state, control, evict, reason)
    return state, control, _status5(state)


@torch.no_grad()
def drain_events(control: ControlState) -> tuple[ControlState, torch.Tensor]:
    """Snapshot drain: a copy of the event log, and the log reset in place."""
    events = control.ev_log.clone()
    control.ev_log.fill_(-1.0)
    control.ev_len.zero_()
    return control, events


def decode_events(events: np.ndarray, cfg: MRConfig) -> list[tuple]:
    """Host-side parse of one drained [M, E, R] event log (every shard's row,
    in shard order).

    Yields ``(stream_id, steps, reason_code, theta, mean, scale)`` per
    eviction, shard-major; empty rows (id < 0) are skipped.
    """
    n_terms, n = cfg.n_terms, cfg.state_dim
    k = n_terms * n
    out = []
    for shard_rows in np.asarray(events):
        for rec in shard_rows:
            sid = int(rec[0])
            if sid < 0:
                continue
            out.append(
                (
                    sid,
                    int(rec[1]),
                    int(rec[2]),
                    rec[3 : 3 + k].reshape(n_terms, n).copy(),
                    rec[3 + k : 3 + k + n].copy(),
                    rec[3 + k + n : 3 + k + 2 * n].copy(),
                )
            )
    return out


@dataclasses.dataclass(frozen=True)
class ControlPlane:
    """The device control plane a RecoveryPlan hands the service: the four
    programs and the capacities baked into the ControlState's shapes (all
    recorded in ``plan.lowering``). The service calls each program once a
    shard, on that shard's rows."""

    queue_capacity: int  # Q: pending admissions a shard
    snapshot_period: int  # the host drains status and events every N ticks
    warm_capacity: int  # W: warm-ring entries a shard
    shards: int  # M: the slot mesh's size
    tick: Callable  # tick_device with its statics bound (one shard a call)
    enqueue: Callable  # enqueue
    pump: Callable  # pump (one shard a call)
    drain: Callable  # drain_events
