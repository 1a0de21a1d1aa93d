"""One intra-op pool size for the port's tests in an xdist worker.

torch starts one intra-op thread a core in every process; pytest-xdist
runs the suite in ``PYTEST_XDIST_WORKER_COUNT`` workers on one host, so each
worker's pool oversubscribes the cores that many times (eight threads a
worker took a 300-step run from 8.5 to 128 s).  A test module that imports
:func:`pinned_threads` (``from torch_threads import pinned_threads  # noqa:
F401``) runs with ``max(1, cpu_count // workers)`` threads and exports the
same count as ``OMP_NUM_THREADS`` to the runners and ranks its tests start
(``parallel.mesh.host_threads`` splits it between the ranks); both are
restored after the module.  Outside xdist it does nothing.

A module whose parity holds only at torch's default pool is not pinned:
``tests/test_torch_engine.py`` and ``tests/test_torch_engine_options.py``
compare Bulyan's steps and worker distances with the JAX engine at rtol
1e-5, which one, three or four threads miss where two and eight hold (the
gradients' reductions split another way).
"""

import os

import pytest
import torch


def worker_threads():
    """The pool size of one xdist worker, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // max(1, int(workers)))


@pytest.fixture(autouse=True, scope="module")
def pinned_threads():
    threads = worker_threads()
    if threads is None:
        yield None
        return
    previous, previous_env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(threads)
    os.environ["OMP_NUM_THREADS"] = str(threads)
    try:
        yield threads
    finally:
        torch.set_num_threads(previous)
        if previous_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = previous_env
