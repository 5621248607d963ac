"""The port's CPU tests share the machine's cores among pytest-xdist's workers.

PyTorch starts as many intra-op threads as the machine has cores. Under
``pytest -n N`` that is N processes of that many threads each on the same
cores, and a test whose process is one of several busy ones then runs tens of
times slower than alone (a ``serve_mr`` call: 8.2 s alone, ~895 s in each of
six processes at once at 8 threads on 8 cores, 4.4-5.9 s each at 1 thread).

So each xdist worker, when it imports this module, gives torch its share of
the cores, ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` threads and at
least 1, and sets ``OMP_NUM_THREADS`` to the same number, so that the
subprocesses the tests start inherit it. Every xdist worker collects every
test module before it runs any test, so the import sets the count in each
worker before its first test. Outside xdist (``PYTEST_XDIST_WORKER_COUNT``
unset) the import changes nothing.
"""

from __future__ import annotations

import os

import pytest
import torch


def thread_share(cores: int, workers: int) -> int:
    """One worker's share of ``cores`` among ``workers``: at least 1."""
    return max(1, cores // workers)


def _share_the_cores() -> int | None:
    """Set this worker's intra-op threads (and ``OMP_NUM_THREADS``) to its
    share; None, and nothing set, outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    share = thread_share(os.cpu_count() or 1, int(workers))
    torch.set_num_threads(share)
    os.environ["OMP_NUM_THREADS"] = str(share)
    return share


SHARE = _share_the_cores()


@pytest.mark.parametrize("cores,workers", [(8, 6), (5, 64)])
def test_the_share_is_one_thread_where_the_workers_reach_the_cores(cores, workers):
    """8 cores among 6 workers give 1 thread each, and so do fewer cores than
    workers, where the quotient would be 0."""
    assert thread_share(cores, workers) == 1


def test_an_xdist_worker_runs_its_share():
    """Inside an xdist worker torch runs the worker's share of threads and
    ``OMP_NUM_THREADS`` names it; outside xdist nothing was set."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        assert SHARE is None
        return
    share = thread_share(os.cpu_count() or 1, int(workers))
    assert SHARE == share
    assert torch.get_num_threads() == share
    assert os.environ["OMP_NUM_THREADS"] == str(share)
