"""The benchmark's tests: plain CPU tests at tiny sizes, and card tests
(marked ``gpu``) that skip themselves where there is no CUDA device."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# the tiny sizes a CPU run takes, per configuration and per cell
TINY_CONFIG = {"num_gaussians": 400, "width": 64, "height": 48, "views": 4,
               "episode_steps": 5}
TINY_PARAMS = {
    "fit-1m-1080p": {"warmup_steps": 4},
    "nav-lockstep-8": {"agents": 2, "warmup_steps": 2, "probe_spacing_m": 3.0,
                       "route_spacing_m": 3.0},
    "nav-env-1": {"warmup_steps": 2, "probe_spacing_m": 3.0,
                  "route_spacing_m": 3.0},
    "render-8cam-1080p": {"batch": 2, "pool": 8, "draws": 16, "routes": 4,
                          "route_spacing_m": 1.0, "warmup_batches": 1},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself without one")


def make_tiny(base: Path) -> Path:
    """A copy of the benchmark's cells and configurations at tiny sizes in
    ``base``, beside links to its traffic drivers and metrics: what a later
    PR's new data files look like to the harness."""
    src = ROOT / "perfbench"
    for sub in ("configs", "workloads"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    for f in (src / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update({k: v for k, v in TINY_CONFIG.items() if k in cfg})
        (base / "configs" / f.name).write_text(json.dumps(cfg))
    for f in (src / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        w["params"].update(TINY_PARAMS.get(f.stem, {}))
        (base / "workloads" / f.name).write_text(json.dumps(w))
    for sub in ("traffic", "metrics"):
        (base / sub).symlink_to(src / sub)
    return base


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the chip")
    return torch.device("cuda")
