"""Finding the benchmark's parts by name: ``BENCHMARK.json`` at the root of
the checkout, a cell's file ``workloads/<cell>.json``, its configuration
``configs/<config>.json``, its traffic driver ``traffic/<driver>.py`` and
each per-layer metric's ``metrics/<metric>.json`` with its reader
``metrics/readers/<reader>.py``. Adding a cell, a configuration or a metric
adds files; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # perfbench/
ROOT = HERE.parent                                      # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, base: Path = HERE) -> dict:
    return load_json(base / "workloads" / f"{name}.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(name: str, base: Path = HERE):
    """The traffic driver module ``traffic/<name>.py``."""
    return _module(base / "traffic" / f"{name}.py", f"perfbench_traffic_{name}")


def metric(name: str, base: Path = HERE) -> dict:
    """A per-layer metric's file, with its reader module under ``read``."""
    spec = load_json(base / "metrics" / f"{name}.json")
    spec["read"] = _module(base / "metrics" / "readers" / f"{spec['reader']}.py",
                           f"perfbench_reader_{spec['reader']}").read
    return spec


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries of ``BENCHMARK.json``
    that a cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]
