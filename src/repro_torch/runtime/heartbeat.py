"""Worker heartbeats + straggler detection (copy of ``repro/runtime/heartbeat.py``).

The streaming service beats one heartbeat per worker and tick into this
in-process registry, with the tick's wall time, and re-checks the straggler
rule after every tick.

Straggler rule (robust, scale-free): a worker is a straggler when its recent
mean step time exceeds ``median + k * MAD`` across workers (k=5 by default)
for at least ``patience`` consecutive checks. MAD-based thresholds don't
false-positive when the whole fleet slows together (e.g. checkpoint write).

Dead-worker rule: no heartbeat for ``timeout`` seconds.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict, deque


@dataclasses.dataclass
class WorkerStat:
    last_seen: float
    step: int
    times: deque  # recent step durations


class HeartbeatRegistry:
    def __init__(self, window: int = 16, timeout: float = 60.0):
        self.window = window
        self.timeout = timeout
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerStat] = {}

    def beat(self, worker: str, step: int, step_time: float, now: float | None = None):
        now = time.time() if now is None else now
        with self._lock:
            st = self._workers.get(worker)
            if st is None:
                st = self._workers[worker] = WorkerStat(now, step, deque(maxlen=self.window))
            st.last_seen = now
            st.step = step
            st.times.append(step_time)

    def workers(self) -> list[str]:
        with self._lock:
            return sorted(self._workers)

    def dead(self, now: float | None = None) -> list[str]:
        now = time.time() if now is None else now
        with self._lock:
            return sorted(w for w, st in self._workers.items() if now - st.last_seen > self.timeout)

    def mean_times(self) -> dict[str, float]:
        with self._lock:
            return {
                w: (sum(st.times) / len(st.times))
                for w, st in self._workers.items()
                if st.times
            }

    def remove(self, worker: str):
        with self._lock:
            self._workers.pop(worker, None)


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class StragglerDetector:
    """median + k*MAD rule with a consecutive-hits requirement."""

    def __init__(self, registry: HeartbeatRegistry, k: float = 5.0, patience: int = 3):
        self.registry = registry
        self.k = k
        self.patience = patience
        self._hits: dict[str, int] = defaultdict(int)

    def check(self) -> list[str]:
        """Returns workers currently flagged as stragglers."""
        means = self.registry.mean_times()
        if len(means) < 3:
            return []
        vals = list(means.values())
        med = _median(vals)
        mad = _median([abs(v - med) for v in vals]) or 1e-9
        thresh = med + self.k * mad
        flagged = []
        for w, v in means.items():
            if v > thresh:
                self._hits[w] += 1
                if self._hits[w] >= self.patience:
                    flagged.append(w)
            else:
                self._hits[w] = 0
        return sorted(flagged)
