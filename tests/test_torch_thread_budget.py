"""The torch thread budget of a test process: the root ``conftest.py``
shares the usable CPUs among the pytest-xdist workers. The file is loaded by
its path, since on ``sys.path`` the name ``conftest`` is ``tests/conftest.py``.
"""

import importlib.util
import os
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "root_conftest", Path(__file__).resolve().parent.parent / "conftest.py")
budget = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(budget)


@pytest.mark.parametrize("workers, cpus, threads", [
    ("6", 8, 1),        # the suite's six workers on eight cores
    ("2", 8, 4),
    (None, 8, 8),       # outside xdist: torch's own default
    ("12", 8, 1),       # more workers than CPUs still leaves one thread
])
def test_threads_share_the_usable_cpus(monkeypatch, workers, cpus, threads):
    if workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))
    assert budget.torch_threads() == threads


def test_this_process_runs_with_the_budget():
    assert torch.get_num_threads() == budget.torch_threads()
