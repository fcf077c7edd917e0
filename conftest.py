"""Pytest configuration for every test process of the repo, pytest-xdist's
controller and each of its workers alike (``tests/conftest.py`` sets up JAX).

Torch's intra-op pool defaults to one thread per core of the machine. Under
``-n 6`` every worker takes that pool, so six workers on eight cores run 48
threads, and the port's many small CPU ops wait on each other: a port test
then ran up to 17x slower than at one thread.
"""

import os


def torch_threads() -> int:
    """Torch intra-op threads for this test process: the CPUs it may use,
    shared evenly among the pytest-xdist workers (one worker outside xdist,
    which leaves torch's own default), and never fewer than one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


def pytest_configure(config):
    import torch    # not at module level: loading this file imports no torch

    torch.set_num_threads(torch_threads())
