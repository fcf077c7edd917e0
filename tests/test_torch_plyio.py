"""The port's compressed-PLY reader against the JAX package's.

Counterparts of tests/test_native_plyio.py on ``sage3d_tpu_torch``'s decoder
(``utils/plyio_native.py``), which builds ``native/compressed_ply.cpp`` into
``build/native/`` and never writes under ``native/``; and ``load_ply`` on a
compressed file equal to the JAX package's ``load_ply`` on it.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sage3d_tpu.utils import plyio_native as jpn
from sage3d_tpu_torch.utils import plyio_native as pn
from tests.test_native_plyio import (_canon_quat_wxyz, make_compressed_arrays,
                                     write_compressed_ply)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))


@pytest.mark.parametrize("with_color", [True, False])
def test_native_matches_python(with_color):
    if not pn.native_available():
        pytest.skip("native lib not built")
    chunk, packed = make_compressed_arrays(n=2048, with_color_range=with_color)
    d_native = pn.decode_compressed(chunk, packed, use_native=True)
    d_python = pn.decode_compressed(chunk, packed, use_native=False)
    for key in d_native:
        np.testing.assert_allclose(d_native[key], d_python[key], atol=1e-5,
                                   err_msg=key)
    norms = np.linalg.norm(d_native["quats"], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-2)


@pytest.mark.parametrize("use_native", [False, True])
def test_decoders_equal_the_jax_package(use_native):
    """The Python decoders are one numpy code: bitwise. The native ones are
    one C++ source built with one set of flags: bitwise too."""
    chunk, packed = make_compressed_arrays(n=1500, seed=3)
    got = pn.decode_compressed(chunk, packed, use_native=use_native)
    want = jpn.decode_compressed(chunk, packed, use_native=use_native)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_load_compressed_ply_file(tmp_path):
    chunk, packed = make_compressed_arrays(n=512)
    p = tmp_path / "scene_compressed.ply"
    write_compressed_ply(p, chunk, packed)
    scene = pn.load_compressed_ply(p, device="cpu")
    assert scene.num_gaussians == 512 and scene.means.device.type == "cpu"
    means = scene.means.numpy()
    assert means[:, 0].min() >= chunk[:, 0].min() - 1e-4
    assert means[:, 0].max() <= chunk[:, 3].max() + 1e-4
    from sage3d_tpu_torch.renderer.camera import make_camera
    from sage3d_tpu_torch.renderer.render import render
    cam = make_camera(position=[0, -8, 1], forward=[0, 1, 0], width=32,
                      height=32, device="cpu")
    out = render(scene, cam, backend="torch")
    assert torch.isfinite(out["rgb"]).all()


def test_extract_columns_native():
    if not pn.native_available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(0)
    n, stride = 1000, 28
    blob = rng.integers(0, 255, n * stride, dtype=np.uint8)
    ref = np.frombuffer(blob.tobytes(), dtype=np.uint8).reshape(n, stride)
    out = pn.extract_columns_native(np.ascontiguousarray(blob), n, stride,
                                    [0, 8, 20])
    assert out is not None
    for i, off in enumerate([0, 8, 20]):
        expected = ref[:, off:off + 4].copy().view(np.float32).ravel()
        np.testing.assert_array_equal(out[i], expected)


def test_decode_sh_bands_native_matches_python():
    rng = np.random.default_rng(4)
    rest = rng.integers(0, 256, (777, 45), dtype=np.uint8)
    a = pn.decode_sh_bands(rest, use_native=True)
    b = pn.decode_sh_bands(rest, use_native=False)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert a.min() >= -4.0 - 1e-5 and a.max() <= 4.0 + 1e-5
    np.testing.assert_allclose(
        pn.decode_sh_bands(np.array([[0, 255]], np.uint8))[0], [-4.0, 4.0],
        atol=1e-6)


def test_load_compressed_ply_with_sh_element(tmp_path):
    chunk, packed = make_compressed_arrays(n=512)
    rest = np.random.default_rng(7).integers(0, 256, (512, 45), dtype=np.uint8)
    p = tmp_path / "scene_sh3_compressed.ply"
    write_compressed_ply(p, chunk, packed, sh_rest=rest)
    scene = pn.load_compressed_ply(p, device="cpu")
    assert tuple(scene.sh.shape) == (512, 16, 3) and scene.sh_degree == 3
    want_red = rest[:, 0].astype(np.float32) * (8.0 / 255.0) - 4.0
    np.testing.assert_allclose(scene.sh[:, 1, 0].numpy(), want_red, atol=1e-6)
    want_green = rest[:, 15].astype(np.float32) * (8.0 / 255.0) - 4.0
    np.testing.assert_allclose(scene.sh[:, 1, 1].numpy(), want_green,
                               atol=1e-6)


@pytest.mark.parametrize("sh", [False, True])
def test_load_ply_compressed_equals_jax_load_ply(tmp_path, sh):
    """``load_ply`` recognises the compressed header and gives the JAX
    package's scene, field for field (semantic ids passed through too)."""
    from sage3d_tpu.renderer.scene import load_ply as jload
    from sage3d_tpu_torch.renderer.scene import load_ply
    chunk, packed = make_compressed_arrays(n=700, seed=9)
    rest = (np.random.default_rng(2).integers(0, 256, (700, 9), dtype=np.uint8)
            if sh else None)
    p = tmp_path / "3dgs_compressed.ply"
    write_compressed_ply(p, chunk, packed, sh_rest=rest)
    ids = np.arange(700, dtype=np.int32) % 5
    for sem in (None, ids):
        got = load_ply(p, semantic_ids=sem, device="cpu")
        want = jload(p, semantic_ids=sem)
        for field in want._fields:
            assert np.array_equal(getattr(got, field).numpy(),
                                  np.array(getattr(want, field))), field


def test_validate_compressed_ply(tmp_path):
    from sage3d_tpu_torch.utils.ply_validate import validate_compressed_ply
    chunk, packed = make_compressed_arrays(n=700)
    rest = (np.arange(700 * 9, dtype=np.int64) % 256).astype(np.uint8)
    rest = rest.reshape(700, 9)
    p = tmp_path / "3dgs_compressed.ply"
    write_compressed_ply(p, chunk, packed, sh_rest=rest)
    report = validate_compressed_ply(p, device="cpu")
    assert report["ok"], [c for c in report["checks"] if not c["ok"]]
    assert report["n_vertices"] == 700 and report["n_chunks"] == 3

    bad = chunk.copy()
    bad[:, 0:3], bad[:, 3:6] = chunk[:, 3:6], chunk[:, 0:3]
    p2 = tmp_path / "bad.ply"
    write_compressed_ply(p2, bad, packed)
    report2 = validate_compressed_ply(p2, device="cpu")
    assert not report2["ok"]
    failed = {c["check"] for c in report2["checks"] if not c["ok"]}
    assert "chunk.bounds_ordered" in failed


def test_decoder_against_splat_transform_port(tmp_path):
    """The decoder on a file written by the port of PlayCanvas
    splat-transform's writer (tests/splat_transform_port.py), with the JAX
    test's quantization tolerances, and equal to the JAX decoder on it."""
    from splat_transform_port import write_compressed_ply_splat_transform
    from sage3d_tpu_torch.renderer.scene import synthetic_room
    from sage3d_tpu_torch.utils.ply_validate import validate_compressed_ply

    scene = synthetic_room(3000, seed=11, sh_degree=3, device="cpu")
    n = scene.num_gaussians
    rng = np.random.default_rng(5)
    means = scene.means.numpy()
    quats = scene.quats.numpy() * np.where(rng.random(n) < 0.5, -1.0,
                                           1.0)[:, None]
    opac = np.clip(scene.opacity_logits.numpy(), -5.0, 5.0)
    sh = np.clip(scene.sh.numpy(), -3.9, 3.9)
    p = tmp_path / "3dgs_compressed.ply"
    order = write_compressed_ply_splat_transform(
        p, means, scene.log_scales.numpy(), quats, opac, sh)
    dec = pn.load_compressed_ply(p, device="cpu")
    assert dec.num_gaussians == n
    ci = np.arange(n) // 256
    exp_means = means[order]
    ranges = np.stack([np.ptp(exp_means[ci == c], axis=0)
                       for c in range(ci.max() + 1)])[ci]
    tol = ranges / np.array([2047.0, 1023.0, 2047.0]) + 1e-5
    assert np.all(np.abs(dec.means.numpy() - exp_means) <= tol)
    got_q = _canon_quat_wxyz(dec.quats.numpy())
    exp_q = _canon_quat_wxyz(quats[order])
    err = np.minimum(np.abs(got_q - exp_q).max(axis=1),
                     np.abs(got_q + exp_q).max(axis=1))
    assert np.max(err) < 2.5e-3
    got_alpha = 1 / (1 + np.exp(-dec.opacity_logits.numpy()))
    assert np.max(np.abs(got_alpha - 1 / (1 + np.exp(-opac[order])))) \
        <= 0.5 / 255 + 1e-6
    assert np.max(np.abs(dec.sh.numpy()[:, 1:] - sh[order][:, 1:])) \
        <= 0.5 * 8 / 255 + 1e-6
    jdec = jpn.load_compressed_ply(p)
    for field in jdec._fields:
        assert np.array_equal(getattr(dec, field).numpy(),
                              np.array(getattr(jdec, field))), field
    report = validate_compressed_ply(p, device="cpu")
    assert report["ok"], [c for c in report["checks"] if not c["ok"]]


def test_build_goes_to_build_native_not_native(tmp_path, monkeypatch):
    """A fresh build lands in the build directory, under a name with the
    source's hash; nothing under native/ is written or replaced."""
    native = REPO / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    monkeypatch.setattr(pn, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setattr(pn, "_flags", None)
    monkeypatch.setattr(pn, "_error", None)
    lib = pn.load_native()
    built = list((tmp_path / "native").iterdir())
    assert len(built) == 1 and built[0] == pn.library_path(pn.native_flags())
    assert built[0].name.startswith("libsage3d_native-")
    assert lib._name == str(built[0])
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before


def test_serial_build_without_openmp(tmp_path, monkeypatch):
    """A compiler that refuses -fopenmp (no OpenMP runtime) gets the serial
    build of the same source, whose decode is bitwise the OpenMP one's."""
    import subprocess
    real_run = subprocess.run

    def no_openmp(cmd, **kw):
        if "-fopenmp" in cmd:
            return subprocess.CompletedProcess(
                cmd, 1, "", "fatal error: cannot read spec file "
                "'libgomp.spec'")
        return real_run(cmd, **kw)

    chunk, packed = make_compressed_arrays(n=1200, seed=4)
    want = pn.decode_compressed(chunk, packed, use_native=True)
    monkeypatch.setattr(pn.subprocess, "run", no_openmp)
    monkeypatch.setattr(pn, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setattr(pn, "_flags", None)
    monkeypatch.setattr(pn, "_error", None)
    got = pn.decode_compressed(chunk, packed, use_native=True)
    assert pn.native_flags() == pn.SERIAL_CXXFLAGS
    assert "-fopenmp" not in pn.native_flags()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_use_native_contract_when_the_build_fails(tmp_path, monkeypatch):
    """use_native=True raises the build's error; None falls back to the
    Python decoder and native_available() says so."""
    bad = tmp_path / "compressed_ply.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pn, "SOURCE", bad)
    monkeypatch.setattr(pn, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setattr(pn, "_flags", None)
    monkeypatch.setattr(pn, "_error", None)
    chunk, packed = make_compressed_arrays(n=300)
    with pytest.raises(RuntimeError, match="compressed_ply.cpp failed"):
        pn.decode_compressed(chunk, packed, use_native=True)
    assert not pn.native_available()
    got = pn.decode_compressed(chunk, packed)
    want = pn.decode_compressed(chunk, packed, use_native=False)
    assert all(np.array_equal(got[k], want[k]) for k in want)
