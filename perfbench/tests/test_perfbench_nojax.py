"""Nothing the benchmark loads is JAX or the JAX package: after importing
every module of ``perfbench`` and a tiny run of a cell on the CPU, no
loaded module's top-level name, compared whole, is ``jax``, ``jaxlib``,
``flax`` or ``sage3d_tpu``. ``sage3d_tpu_torch`` begins with the last and
must pass."""

import subprocess
import sys
import textwrap

from conftest import ROOT


def test_no_jax_is_loaded(tmp_path):
    code = textwrap.dedent(f"""
        import importlib, pathlib, sys
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(ROOT / "perfbench" / "tests")!r})
        root = pathlib.Path({str(ROOT / "perfbench")!r})
        for f in sorted(root.rglob("*.py")):
            rel = f.relative_to(root.parent).with_suffix("")
            if "tests" in rel.parts or rel.name in ("run", "control"):
                continue
            if "traffic" in rel.parts or "readers" in rel.parts:
                from perfbench.harness import registry
                registry._module(f, "x_" + rel.name)
            else:
                importlib.import_module(".".join(rel.parts))
        from conftest import make_tiny
        from perfbench.harness import runner
        base = make_tiny(pathlib.Path({str(tmp_path)!r}))
        out = runner.run("render-8cam-1080p", 3, 0.2, False, 0.0,
                         device="cpu", base=base)
        assert out["correct"]
        assert "sage3d_tpu_torch" in sys.modules
        print(",".join(runner.jax_modules()) or "none")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "none"


def test_the_check_compares_whole_names():
    from perfbench.harness import runner
    mods = dict.fromkeys(["sage3d_tpu_torch", "sage3d_tpu_torch.ops",
                          "jaxtyping", "flaxen"])
    saved = dict(sys.modules)
    try:
        sys.modules.update(mods)
        assert runner.jax_modules() == []
        sys.modules["sage3d_tpu.ops"] = None
        assert runner.jax_modules() == ["sage3d_tpu"]
    finally:
        for k in list(sys.modules):
            if k not in saved:
                del sys.modules[k]
