"""The port's public surface: ``sage3d_tpu_torch`` exports every public
top-level name of ``sage3d_tpu`` (the reference package's exports, aliases
included), and importing it loads no JAX module."""

import json
import subprocess
import sys
import types
from pathlib import Path

import sage3d_tpu
import sage3d_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _public(pkg) -> dict:
    return {name: obj for name, obj in vars(pkg).items()
            if not name.startswith("_")
            and not isinstance(obj, types.ModuleType)}


def test_every_public_name_of_the_jax_package_is_exported():
    want = _public(sage3d_tpu)
    got = _public(sage3d_tpu_torch)
    assert len(want) >= 25
    assert sorted(set(want) - set(got)) == []
    for name, obj in want.items():     # a class stays a class, a function a
        assert callable(got[name]) == callable(obj), name     # function
    assert sage3d_tpu_torch.SimpleVLNEnv is sage3d_tpu_torch.GaussianVLNEnv
    assert sage3d_tpu_torch.SemanticMap2DCollisionDetector is \
        sage3d_tpu_torch.OccupancyGrid
    assert sage3d_tpu_torch.__version__ == sage3d_tpu.__version__


def test_importing_the_port_loads_no_jax():
    code = ("import json, sys, sage3d_tpu_torch\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'sage3d_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
